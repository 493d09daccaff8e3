"""Command-line tools of the port: ``python -m
flextree_tpu_torch.tools.calibrate_host`` fits the planner's cost-model
constants on the backend it runs on; ``...tools.feedback_convergence`` and
``...tools.probe_free_feedback`` run the closed-loop planner feedback end
to end, with probes and without; ``...tools.arbiter_spike`` shares one
device between a trainer and a serving pool under the chip arbiter, and
``...tools.coord_chaos`` runs the coordinated control plane under kills,
stops, torn files and a gloo wire.  The chaos drivers run real processes
under real faults: ``...tools.multiproc_bringup`` and
``...tools.chaos_bringup`` the bring-up (retry, restart, degrade to the
survivors), ``...tools.chaos_runtime`` a supervised run under SIGKILL,
SIGSTOP and SIGTERM, ``...tools.obs_chaos`` the flight records of a
killed run merged into one timeline, ``...tools.rpc_chaos`` the front
door and its replica processes, and ``...tools.serve_elastic_chaos`` a
replica fleet leasing chips from the arbiter.  The kernel drivers time
the hand-written kernels against the JAX tools' floors:
``...tools.bench_attention`` (the flash kernels against SDPA),
``...tools.roofline_reduce`` (the fold against the card's memory rate
and the copy kernel), ``...tools.bench_paged`` (the fused paged decode
and on-demand admission) and ``...tools.measure_launch`` (the launch
constant's bracket).  The A/B drivers run the JAX tools' feature
proofs with their floors: ``...tools.bench_bucketing`` (the fused
gradient sync, JAX ``tools/bench_bucketing.py``),
``...tools.zigzag_accounting`` (zigzag ring attention's critical path,
``tools/zigzag_accounting.py``), ``...tools.bench_prefix`` (the
cross-request prefix cache, ``tools/bench_prefix.py``),
``...tools.bench_quantize`` (the wire codecs over a gloo world,
``tools/bench_quantize.py``), ``...tools.bench_sharded`` (ZeRO-1,
``tools/bench_sharded.py``), ``...tools.bench_overlap`` (the
backward/comm overlap, ``tools/bench_overlap.py``) and
``...tools.bench_disagg`` (prefill/decode disaggregation over replica
processes, ``tools/bench_disagg.py``)."""

from __future__ import annotations

import fnmatch
import os
import tempfile

#: the flagship model's widths and depth (``__graft_entry__.py``): the
#: model the tools run on a card; a tool whose JAX counterpart runs
#: another depth overrides ``n_layers`` only
FLAGSHIP = dict(vocab_size=8192, d_model=512, n_heads=8, n_layers=4,
                d_ff=2048)

#: result files the repository commits (the JAX package's measurements):
#: the port's tools never write them
COMMITTED_RESULTS = ("FEEDBACK.json", "OBS_ATTRIBUTION.json", "BENCH_*.json",
                     "CHAOS_BRINGUP.json", "MULTIPROC_BRINGUP.json",
                     "CHAOS_RUNTIME.json", "OBS_CHAOS.json",
                     "OBS_TIMELINE.json", "RPC_CHAOS.json",
                     "SERVE_ELASTIC.json", "COORD_CHAOS.json",
                     "ARBITER_SPIKE.json", "ZIGZAG_ACCOUNTING.json")


def committed(path: str) -> bool:
    """Whether ``path`` names one of :data:`COMMITTED_RESULTS`."""
    name = os.path.basename(path)
    return any(fnmatch.fnmatch(name, pat) for pat in COMMITTED_RESULTS)


def checked_out(parser, path: str) -> str:
    """``path`` as a tool's ``--out``, or ``parser.error``: never one of
    :data:`COMMITTED_RESULTS`, and only under ``tmp/`` of the working
    directory or the system's temporary directory.  Its directory is
    made."""
    if committed(path):
        parser.error(f"--out {path}: a committed result of the JAX "
                     f"package; write the port's under tmp/")
    real = os.path.realpath(path)
    roots = [os.path.realpath("tmp"), os.path.realpath(tempfile.gettempdir())]
    if not any(real.startswith(r + os.sep) for r in roots):
        parser.error(f"--out {path}: write under tmp/ (or {roots[1]})")
    os.makedirs(os.path.dirname(real), exist_ok=True)
    return real
