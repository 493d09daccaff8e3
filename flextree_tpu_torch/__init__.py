"""flextree-tpu on PyTorch and CUDA: the port's package.

A second implementation of the ``flextree_tpu`` package for NVIDIA Hopper
(H100), held against it module by module: the same public functions and
data layouts, plain PyTorch where the JAX package wrote plain ``jnp``, and
a kernel written by hand in CUDA C++ (``csrc/``) wherever the JAX package
wrote a Pallas kernel for the TPU.  It imports ``torch`` and never ``jax``
nor ``flextree_tpu``: what it needs of the JAX package it keeps as its own
copy.

Ported so far (the serving path and its replica tier, the dense train
step, the FlexTree collectives and their planner):

- :mod:`.models` — the dense decoder LM's single-device forward (reference
  or flash attention), its cross-entropy loss, the contiguous KV cache,
  prefill/decode and ``generate``;
- :mod:`.ops.paged_attention` — one-token paged decode attention, the
  CUDA kernel ``csrc/paged_attention.cu`` beside its plain PyTorch twin;
- :mod:`.ops.flash_attention` — causal flash attention forward and
  backward, the CUDA kernels ``csrc/flash_fwd.cu``, ``flash_bwd_dq.cu``
  and ``flash_bwd_dkv.cu`` beside their plain versions;
- :mod:`.ops.reduce` and :mod:`.ops.reduce_stacked` — the op registry
  and the collectives' local fold (a batch of folds over W tensors where
  they lie, one launch a stage, or one stacked fold), the CUDA kernel
  ``csrc/reduce_stacked.cu`` beside its plain versions;
- :mod:`.schedule` and :mod:`.backends` — copies of the JAX package's
  topology, block, plan and validation layer, of its schedule IR
  (``schedule.ir``) and of its NumPy simulator; :mod:`.analysis` the
  IR's model checker;
- :mod:`.parallel` — the FlexTree collectives (``allreduce``, every
  schedule model-checked before it runs, the swing and generalized
  families on the pair-stage executor ``ir_lower``) over an in-process
  mesh of ranks (``mesh``) or ``torch.distributed`` (``launch``); the
  train step (``train``), the run loop (``loop``) and the local-attention
  switch (``ring_attention``);
- :mod:`.planner` — the cost model, the topology chooser (``python -m
  flextree_tpu_torch.planner``) and its calibration, fitted on the card
  by ``python -m flextree_tpu_torch.tools.calibrate_host``;
- :mod:`.bench` — the benchmark CLI (``python -m
  flextree_tpu_torch.bench``): the allreduce, the fold against the copy
  kernel ``csrc/copy.cu``, and attention (the flash kernels against
  SDPA); :mod:`.utils.timing` its timing loops, :mod:`.utils.buildstamp`
  its ``--version``;
- :mod:`.trainer` — the training CLI (``python -m
  flextree_tpu_torch.trainer``); :mod:`.data` the corpus and batching;
  :mod:`.utils.checkpoint` the JAX package's checkpoint format;
- :mod:`.serving` — the paged KV cache, the continuous batcher, the
  prefix index and the serving engine (``python -m
  flextree_tpu_torch.serving``); prefill/decode disaggregation over
  replica processes (``python -m flextree_tpu_torch.serving.replica_main
  --role prefill|decode``) behind a front door (``serving.frontdoor``),
  the KV shipped on the wire codecs over the JAX package's frames;
- :mod:`.runtime` — CRC-trailered control files and heartbeat membership;
- :mod:`.obs` — the metrics registry, its Prometheus exposition and the
  flight recorder;
- :mod:`.convert` — the JAX parameter pytree and train state (as numpy)
  to and from the port's.

Entry points run on ``cuda`` unless the caller asks for ``cpu``
(:func:`.device.resolve_device`); with no GPU and no ``cpu`` request they
raise instead of falling back.
"""

from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device"]
