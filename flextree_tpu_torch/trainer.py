"""Training entry point: ``python -m flextree_tpu_torch.trainer``.

The port's counterpart of ``python -m flextree_tpu.trainer``: the dense LM
trained on the synthetic corpus, with checkpoints and resume, on one rank
or over a (dp, sp, tp) mesh of in-process ranks; the pipeline-parallel LM
over (dp, pp, sp, tp) and the mixture-of-experts LM over (dp, ep, sp,
tp).  It takes the JAX trainer's flags with their defaults, plus
``--dtype`` for the compute dtype.  Examples::

    # on the card (the default), flash attention, bf16 compute
    python -m flextree_tpu_torch.trainer --attn-impl flash --dtype bfloat16

    # 8 data-parallel ranks on the one card, the gradient on the bucketed
    # FlexTree sync (--grad-topo 4,2 picks its shape)
    python -m flextree_tpu_torch.trainer --mesh 8,1,1 --dtype bfloat16

    # on the CPU (the kernels' plain versions), 2 ranks
    python -m flextree_tpu_torch.trainer --cpu --mesh 2,1,1 --steps 3

    # 8 ranks with the int8 wire codec and error feedback (or --codec bf16)
    python -m flextree_tpu_torch.trainer --mesh 8,1,1 --codec int8

    # each gradient bucket synced as its layers' backward finishes, on a
    # side stream of the card (readiness-ordered overlap)
    python -m flextree_tpu_torch.trainer --mesh 8,1,1 --overlap

    # ZeRO-1: each bucket reduce-scattered, AdamW on each rank's block,
    # the parameters all-gathered (with --codec and --overlap too)
    python -m flextree_tpu_torch.trainer --mesh 8,1,1 --shard-optimizer

    # sequence and tensor parallelism over a (2, 2, 2) dp/sp/tp mesh: the
    # ring, zigzag or Ulysses attention over sp, the row-parallel partials
    # combined over tp by the FlexTree allreduce (--devices 8 is the same)
    python -m flextree_tpu_torch.trainer --mesh 2,2,2 --sp-impl zigzag \
        --dtype bfloat16 --attn-impl flash

    # GPipe over a (1, 2, 2, 2) dp/pp/sp/tp mesh, 2 microbatches a rank
    python -m flextree_tpu_torch.trainer --model pipeline --mesh 1,2,2,2 \
        --n-layers 4 --microbatches 2

    # mixture of experts over a (1, 2, 2, 2) dp/ep/sp/tp mesh
    python -m flextree_tpu_torch.trainer --model moe --mesh 1,2,2,2 \
        --n-experts 8 --top-k 2 --capacity-factor 2.0

    # the wide meshes take every option: ZeRO-1 with the int8 codec on
    # a (2, 2, 2) mesh, overlap on the pipeline and MoE meshes
    python -m flextree_tpu_torch.trainer --mesh 2,2,2 --shard-optimizer \
        --codec int8
    python -m flextree_tpu_torch.trainer --model moe --mesh 1,2,2,2 \
        --overlap --shard-optimizer

``--mesh`` (dp,sp,tp for the dense model; dp,pp,sp,tp or dp,ep,sp,tp for
the pipeline and MoE models) or ``--devices N`` (split as the JAX
``factor_devices`` or ``factor_devices_4d`` splits it) give the ranks, all
in this process on the one device; ``--overlap``, ``--shard-optimizer``
and a lossy ``--codec`` run on every mesh of every model, alone and
combined (the pipeline ignores ``--overlap`` under ``--shard-optimizer``,
as the JAX step does).  ``--cpu`` is a switch.  A flag whose module is
not ported yet raises ``NotImplementedError`` naming its ROADMAP item.
The last line printed is the JAX trainer's.  A run checkpoints its
replicated state, as the JAX trainer does (a pipeline run the stacked
tree); with a lossy ``--codec`` the state carries the error-feedback
residual ``"ef"``, each rank's, and the file holds slice by slice the
first rank's that holds it (``parallel.zero.checkpoint_ef``).  A
``--shard-optimizer`` run checkpoints consolidated
(``parallel.zero.make_consolidate_fn``: the replicated layout, which any
world size and the replicated step resume from) and restores through
``make_reshard_fn``.
"""

from __future__ import annotations

import argparse
import math

import torch

_ROADMAP = "ROADMAP.md, Queue 1"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="flextree_tpu_torch.trainer",
        description="Train the dense, pipeline or MoE LM on one card, on "
        "one rank or over a mesh of in-process ranks.",
        epilog="The SIGTERM checkpoint guard of the JAX trainer "
        "(runtime/preemption.py) is not ported yet: a terminated run "
        "resumes from its last --ckpt-every checkpoint.",
    )
    ap.add_argument("--model", choices=["dense", "pipeline", "moe"],
                    default="dense")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--d-ff", type=int, default=128)
    ap.add_argument("--n-experts", type=int, default=4)
    ap.add_argument("--top-k", type=int, default=2)
    ap.add_argument("--capacity-factor", type=float, default=2.0)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--sp-impl", choices=["ring", "zigzag", "ulysses"],
                    default="ring",
                    help="sequence-parallel attention over the sp axis "
                    "(with sp and tp 1 the whole sequence is local and it "
                    "has no effect)")
    ap.add_argument("--attn-impl", choices=["reference", "flash"],
                    default="reference")
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default="float32",
                    help="compute dtype (params and Adam state stay float32)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-clip", type=float, default=0.0,
                    help="global-norm gradient clipping (0 = off)")
    ap.add_argument("--schedule", choices=["constant", "warmup_cosine"],
                    default="constant",
                    help="warmup_cosine ramps over --warmup-steps then "
                    "decays to min_lr_frac*lr at --steps")
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--min-lr-frac", type=float, default=0.1,
                    help="cosine floor as a fraction of --lr")
    ap.add_argument("--grad-topo", type=str, default=None,
                    help="FT_TOPO-style widths for the gradient allreduce, "
                    "or psum (the dense fold); inert on one rank")
    ap.add_argument("--codec", choices=["f32", "bf16", "int8"], default="f32",
                    help="gradient-sync wire codec; bf16 and int8 sync with "
                    "error feedback")
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--shard-optimizer", action="store_true")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--mesh", type=str, default=None,
                    help="mesh shape of in-process ranks: dp,sp,tp (e.g. "
                    "8,1,1 or 2,2,2), or for --model pipeline|moe "
                    "dp,pp,sp,tp or dp,ep,sp,tp (e.g. 1,2,2,2)")
    ap.add_argument("--devices", type=int, default=None,
                    help="rank count, split as the JAX trainer splits it "
                    "(8 -> 2,2,2; pipeline and moe: 8 -> 1,2,2,2)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--corpus-tokens", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--step-timeout", type=float, default=None, metavar="S")
    ap.add_argument("--heartbeat-dir", type=str, default=None)
    ap.add_argument("--heartbeat-rank", type=int, default=0)
    ap.add_argument("--heartbeat-world", type=int, default=None)
    ap.add_argument("--no-preempt-checkpoint", action="store_true",
                    help="accepted for the JAX trainer's command lines; "
                    "the guard it disables is not ported")
    ap.add_argument("--feedback-every", type=int, default=0, metavar="K")
    ap.add_argument("--feedback-band", type=float, default=0.5, metavar="R")
    ap.add_argument("--feedback-calibration", type=str, default=None,
                    metavar="PATH")
    ap.add_argument("--obs-dir", type=str, default=None, metavar="DIR")
    ap.add_argument("--flight-recorder", action="store_true")
    return ap


#: each model's mesh axes
_AXES = {"dense": ("dp", "sp", "tp"), "pipeline": ("dp", "pp", "sp", "tp"),
         "moe": ("dp", "ep", "sp", "tp")}


def _mesh_shape(args) -> tuple:
    """The mesh shape from ``--mesh`` or ``--devices`` (one rank when
    neither is given): (dp, sp, tp) for the dense model, four axes for the
    pipeline and MoE models."""
    from .parallel.pipeline import factor_devices_4d
    from .parallel.train import factor_devices

    names = _AXES[args.model]
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        if len(shape) != len(names) or min(shape) < 1:
            raise ValueError(f"--mesh {args.mesh}: want {','.join(names)}")
        if args.devices is not None and args.devices != math.prod(shape):
            raise ValueError(f"--mesh {args.mesh} does not cover --devices "
                             f"{args.devices}")
        return shape
    factor = factor_devices if args.model == "dense" else factor_devices_4d
    return factor(args.devices or 1)


def _refuse_unported(args) -> None:
    """Raise for a flag whose module is not ported, naming its item."""
    refusals = (
        (args.autotune, "--autotune",
         "'Checkpoint, supervision and feedback plumbing'"),
        (args.feedback_every > 0 or args.feedback_band != 0.5
         or args.feedback_calibration is not None, "--feedback-*",
         "'Checkpoint, supervision and feedback plumbing'"),
        (args.heartbeat_dir is not None, "--heartbeat-dir",
         "'Checkpoint, supervision and feedback plumbing'"),
        (args.step_timeout is not None, "--step-timeout",
         "'Checkpoint, supervision and feedback plumbing'"),
        (args.obs_dir is not None or args.flight_recorder,
         "--obs-dir/--flight-recorder",
         "'Checkpoint, supervision and feedback plumbing'"),
    )
    for bad, what, item in refusals:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet ({_ROADMAP}: {item})"
            )


def model_specs(model: str, cfg) -> dict:
    """The parameter specs of ``--model``'s tree."""
    if model == "pipeline":
        from .parallel.pipeline import pipeline_param_specs

        return pipeline_param_specs(cfg)
    if model == "moe":
        from .models.moe import moe_param_specs

        return moe_param_specs(cfg)
    from .models.transformer import param_specs

    return param_specs(cfg)


def sharded_hooks(comm, model_cfg, params, train_cfg, model: str = "dense"):
    """``(pack, unpack)`` for ``fit``: a sharded run checkpoints
    consolidated (the replicated layout, the same for any world size) and
    restores by resharding it over ``comm`` (the JAX trainer's
    ``sharded_hooks``, with the mesh's layout for each ``model``); a
    lossy run on a mesh writes each slice's residual from the first rank
    that holds it (:func:`.parallel.zero.checkpoint_ef`); ``(None,
    None)`` otherwise."""
    from .ops.quantize import get_codec
    from .parallel.mesh import Mesh
    from .parallel.train import zero_layout_for
    from .parallel.zero import (
        checkpoint_ef,
        make_consolidate_fn,
        make_reshard_fn,
    )

    lossy = get_codec(train_cfg.codec).lossy
    pspecs = model_specs(model, model_cfg)
    if not train_cfg.shard_optimizer:
        if not (lossy and isinstance(comm, Mesh)):
            return None, None
        return (lambda state: dict(state, ef=checkpoint_ef(
            state["ef"], pspecs, comm))), None
    layout = zero_layout_for(comm, params, pspecs, _AXES[model])
    return (make_consolidate_fn(comm, pspecs, layout, train_cfg.grad_topo,
                                lossy),
            make_reshard_fn(comm, pspecs, layout, train_cfg.grad_topo,
                            lossy))


def main(argv=None, *, out: dict | None = None) -> int:
    """Run the trainer; ``out``, when given, receives the run's
    ``FitResult``, model and train configs and the ranks' mesh (None: one
    rank) under ``"result"``, ``"model_cfg"``, ``"train_cfg"`` and
    ``"comm"`` (for in-process callers that check the run, such as
    ``chip_smoke.py``)."""
    args = _parser().parse_args(argv)
    _refuse_unported(args)

    from .data import LMDataset, synthetic_tokens
    from .device import resolve_device
    from .parallel.loop import FitConfig, fit
    from .parallel.train import TrainConfig

    dev = resolve_device("cpu" if args.cpu else None)
    shape = _mesh_shape(args)
    tc = TrainConfig(
        lr=args.lr,
        grad_topo=args.grad_topo,
        grad_clip_norm=args.grad_clip,
        schedule=args.schedule,
        warmup_steps=args.warmup_steps,
        total_steps=args.steps if args.schedule == "warmup_cosine" else 0,
        min_lr_frac=args.min_lr_frac,
        codec=args.codec,
        overlap=args.overlap,
        shard_optimizer=args.shard_optimizer,
    )
    gen = torch.Generator().manual_seed(args.seed)
    cfg, state, step, comm = _build(args, tc, shape, dev, gen)
    dataset = LMDataset(
        synthetic_tokens(args.corpus_tokens, args.vocab, seed=args.seed),
        batch=args.batch, seq_len=args.seq_len, seed=args.seed,
    )
    pack, unpack = sharded_hooks(comm, cfg, state["params"], tc, args.model)
    result = fit(
        state, step, dataset,
        FitConfig(num_steps=args.steps, ckpt_dir=args.ckpt_dir,
                  ckpt_every=args.ckpt_every, log_every=args.log_every,
                  resume=not args.no_resume),
        state_pack=pack, state_unpack=unpack,
    )
    if out is not None:
        out.update(result=result, model_cfg=cfg, train_cfg=tc, comm=comm)
    first = result.losses[0][1] if result.losses else float("nan")
    last = result.losses[-1][1] if result.losses else float("nan")
    mesh = dict(zip(_AXES[args.model], shape))
    print(
        f"{args.model}: {result.steps_run} steps on mesh {mesh}; loss "
        f"{first:.4f} -> {last:.4f}"
        + (f" (resumed from {result.resumed_from})"
           if result.resumed_from else "")
    )
    return 0


def _build(args, tc, shape, dev, gen):
    """``(model config, train state, step, comm)`` for ``--model``."""
    from .models.transformer import TransformerConfig
    from .parallel.mesh import Mesh, flat_mesh

    common = dict(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, dtype=_DTYPES[args.dtype],
        sp_impl=args.sp_impl, attn_impl=args.attn_impl,
    )
    if args.model == "pipeline":
        from .parallel.pipeline import (
            init_pipeline_train_state,
            make_mesh_4d,
            make_pipeline_train_step,
        )

        cfg = TransformerConfig(**common)
        comm = make_mesh_4d(shape=shape, device=dev)
        return (cfg, init_pipeline_train_state(cfg, gen, tc, device=dev,
                                               comm=comm),
                make_pipeline_train_step(cfg, tc, args.microbatches,
                                         comm=comm), comm)
    if args.model == "moe":
        from .models.moe import MoEConfig
        from .parallel.moe_train import (
            init_moe_train_state,
            make_mesh_moe,
            make_moe_train_step,
        )

        cfg = MoEConfig(**common, n_experts=args.n_experts, top_k=args.top_k,
                        capacity_factor=args.capacity_factor)
        comm = make_mesh_moe(shape=shape, device=dev)
        return (cfg, init_moe_train_state(cfg, gen, tc, device=dev,
                                          comm=comm),
                make_moe_train_step(cfg, tc, comm=comm), comm)
    from .parallel.train import AXIS_NAMES, init_train_state, make_train_step

    cfg = TransformerConfig(**common)
    dp = shape[0]
    if math.prod(shape) > dp:
        comm = Mesh((dev,) * math.prod(shape), AXIS_NAMES, shape)
    else:
        comm = flat_mesh(dp, dev, "dp") if dp > 1 else None
    return (cfg, init_train_state(cfg, gen, tc, device=dev, comm=comm),
            make_train_step(cfg, tc, device=dev, comm=comm), comm)


if __name__ == "__main__":
    raise SystemExit(main())
