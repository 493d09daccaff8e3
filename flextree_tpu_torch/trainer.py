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

    # supervised: a checkpoint on SIGTERM within one step (on whenever
    # --ckpt-dir is set), a 30 s step watchdog, this process's heartbeat
    # in a directory its peers share (a dead peer shrinks the run to the
    # survivors), the flight recorder, and the gradient sync's topology
    # picked by timing the planner's shortlist on the card
    python -m flextree_tpu_torch.trainer --mesh 8,1,1 --ckpt-dir ck \
        --step-timeout 30 --heartbeat-dir hb --flight-recorder --autotune

    # closed-loop planner feedback: every 5 steps time a few probe
    # allreduces over the largest mesh axis; past the drift band refit the
    # cost constants into obs/CALIBRATION.feedback.json and swap in the
    # replanned step
    python -m flextree_tpu_torch.trainer --mesh 8,1,1 --obs-dir obs \
        --feedback-every 5

``--mesh`` (dp,sp,tp for the dense model; dp,pp,sp,tp or dp,ep,sp,tp for
the pipeline and MoE models) or ``--devices N`` (split as the JAX
``factor_devices`` or ``factor_devices_4d`` splits it) give the ranks, all
in this process on the one device; ``--overlap``, ``--shard-optimizer``
and a lossy ``--codec`` run on every mesh of every model, alone and
combined (the pipeline ignores ``--overlap`` under ``--shard-optimizer``,
as the JAX step does).  ``--cpu`` is a switch.  The supervision flags
are the JAX trainer's: ``--step-timeout`` and ``--heartbeat-dir/-rank/
-world`` arm ``parallel.loop.Supervision`` (``--heartbeat-dir`` through
``SupervisorConfig.from_env`` and ``MembershipView.for_config``); with
``--ckpt-dir`` a ``runtime.PreemptionGuard`` turns SIGTERM into a
checkpoint within one step and a clean exit unless
``--no-preempt-checkpoint``; ``--obs-dir``/``--flight-recorder`` install
the flight recorder (``obs.flight_recorder``, default directory
``{ckpt}/obs`` or ``ft_obs``) before the build; ``--autotune`` times the
gradient sync's candidates (``planner.autotune``, cached under
``FLEXTREE_PLAN_CACHE``).  ``--feedback-every K`` arms the closed-loop
planner feedback (``planner.feedback.FeedbackController``, the probes on
the largest mesh axis, the drift band ``--feedback-band``); it acts only
with the flight recorder on.  Refits go to ``--feedback-calibration``,
else to a run-local ``CALIBRATION.feedback.json`` under the obs directory
(or a private temporary directory) seeded as a copy of
``$FLEXTREE_CALIBRATION``, so the host's calibration file is never
written; a replan rebuilds the step with ``FLEXTREE_CALIBRATION`` (and,
when unset, ``FLEXTREE_CALIBRATION_BACKEND``) pointed at that file for
the rest of the run, and both are restored when the run ends.  The last
line printed is the JAX trainer's.  A run checkpoints its
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
import os
import shutil
import signal
import tempfile

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="flextree_tpu_torch.trainer",
        description="Train the dense, pipeline or MoE LM on one card, on "
        "one rank or over a mesh of in-process ranks.",
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
    ap.add_argument("--autotune", action="store_true",
                    help="pick the gradient sync's topology by timing the "
                    "planner's top candidates on this device; cached under "
                    "FLEXTREE_PLAN_CACHE, so the next run is a cache hit")
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
    ap.add_argument("--step-timeout", type=float, default=None, metavar="S",
                    help="per-step watchdog deadline in seconds (env "
                    "FT_STEP_TIMEOUT): a hung step raises FT_STEP_TIMEOUT")
    ap.add_argument("--heartbeat-dir", type=str, default=None,
                    help="shared heartbeat directory: this process beats "
                    "there and watches its peers (a dead peer shrinks the "
                    "run to the survivors)")
    ap.add_argument("--heartbeat-rank", type=int, default=0)
    ap.add_argument("--heartbeat-world", type=int, default=None,
                    help="configured group size for membership accounting")
    ap.add_argument("--no-preempt-checkpoint", action="store_true",
                    help="disable the SIGTERM 'checkpoint now' guard "
                    "(runtime/preemption.py), on whenever --ckpt-dir is set")
    ap.add_argument("--feedback-every", type=int, default=0, metavar="K",
                    help="arm the closed-loop planner feedback: every K "
                    "steps (with the flight recorder on: --obs-dir or "
                    "--flight-recorder) time probe allreduces over the "
                    "largest mesh axis and past the drift band refit the "
                    "cost constants, drop stale plan-cache entries and "
                    "swap in the replanned step; 0 (default) is off, and "
                    "with the recorder off the armed hook is one None "
                    "check a step")
    ap.add_argument("--feedback-band", type=float, default=0.5, metavar="R",
                    help="drift band of --feedback-every: a replan fires "
                    "when the median |predicted-measured|/measured over "
                    "the window passes R")
    ap.add_argument("--feedback-calibration", type=str, default=None,
                    metavar="PATH",
                    help="where feedback refits go (source=\"feedback\"); "
                    "default a run-local CALIBRATION.feedback.json under "
                    "the obs directory, seeded from $FLEXTREE_CALIBRATION, "
                    "so the host's file is never written")
    ap.add_argument("--obs-dir", type=str, default=None, metavar="DIR",
                    help="write this rank's flight-recorder events, failure "
                    "dumps and metrics snapshot under DIR")
    ap.add_argument("--flight-recorder", action="store_true",
                    help="--obs-dir with the default directory "
                    "({--ckpt-dir}/obs, or ft_obs without one)")
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


def _supervision(args):
    """The JAX trainer's supervision wiring: any of ``--step-timeout``,
    ``--heartbeat-dir`` or a preemption guard (on with ``--ckpt-dir``
    unless ``--no-preempt-checkpoint``) arms it; None otherwise."""
    from .parallel.loop import Supervision
    from .runtime import (
        MembershipView,
        PreemptionGuard,
        Supervisor,
        SupervisorConfig,
    )

    want_preempt = bool(args.ckpt_dir) and not args.no_preempt_checkpoint
    if not (args.step_timeout or args.heartbeat_dir or want_preempt):
        return None
    supervisor = membership = None
    if args.heartbeat_dir:
        cfg_hb = SupervisorConfig.from_env(rank=args.heartbeat_rank,
                                           dir=args.heartbeat_dir)
        supervisor = Supervisor(cfg_hb)
        membership = MembershipView.for_config(
            cfg_hb, configured=args.heartbeat_world)
    return Supervision(
        supervisor=supervisor, membership=membership,
        configured_world=args.heartbeat_world,
        step_timeout_s=args.step_timeout,
        preemption=PreemptionGuard().install() if want_preempt else None,
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

    import contextlib

    from .data import LMDataset, synthetic_tokens
    from .device import resolve_device
    from .parallel.loop import FitConfig, fit

    dev = resolve_device("cpu" if args.cpu else None)
    shape = _mesh_shape(args)
    tc = _train_config(args)
    supervision = _supervision(args)
    # the flight recorder goes in before the build, so the build's events
    # (the bucket plans) land in the record too
    obs_ctx = contextlib.nullcontext()
    obs_dir = None
    if args.obs_dir or args.flight_recorder:
        from .obs import flight_recorder

        obs_dir = args.obs_dir or (os.path.join(args.ckpt_dir, "obs")
                                   if args.ckpt_dir else "ft_obs")
        obs_ctx = flight_recorder(obs_dir, rank=args.heartbeat_rank,
                                  source="train")
    prev_term = None  # the SIGTERM handler a chained dump replaced
    # the calibration variables a feedback replan repoints, restored at
    # the end for in-process callers
    prev_cal = {k: os.environ.get(k) for k in (
        "FLEXTREE_CALIBRATION", "FLEXTREE_CALIBRATION_BACKEND")}
    try:
        with obs_ctx as obs_rec:
            if obs_rec is not None and (supervision is None
                                        or supervision.preemption is None):
                # no guard routes SIGTERM through fit's dump: chain a dump
                # onto the default handler so a bare terminate leaves one
                from .obs import install_signal_dump

                prev_term = signal.getsignal(signal.SIGTERM)
                install_signal_dump(obs_rec)
            gen = torch.Generator().manual_seed(args.seed)
            cfg, tc, state, step, comm = _build(args, tc, shape, dev, gen)
            dataset = LMDataset(
                synthetic_tokens(args.corpus_tokens, args.vocab,
                                 seed=args.seed),
                batch=args.batch, seq_len=args.seq_len, seed=args.seed,
            )
            pack, unpack = sharded_hooks(comm, cfg, state["params"], tc,
                                         args.model)
            if args.feedback_every > 0:
                supervision = _feedback(args, supervision, state, shape, dev,
                                        obs_dir)
            result = fit(
                state, step, dataset,
                FitConfig(num_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every,
                          log_every=args.log_every,
                          resume=not args.no_resume),
                supervision=supervision, state_pack=pack,
                state_unpack=unpack,
            )
    finally:
        # in-process callers get their handlers back
        if supervision is not None and supervision.preemption is not None:
            supervision.preemption.uninstall()
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
        for key, val in prev_cal.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
    if out is not None:
        out.update(result=result, model_cfg=cfg, train_cfg=tc, comm=comm)
    first = result.losses[0][1] if result.losses else float("nan")
    last = result.losses[-1][1] if result.losses else float("nan")
    mesh = dict(zip(_AXES[args.model], shape))
    preempted = result.report.preempted_at
    print(
        f"{args.model}: {result.steps_run} steps on mesh {mesh}; loss "
        f"{first:.4f} -> {last:.4f}"
        + (f" (resumed from {result.resumed_from})"
           if result.resumed_from else "")
        + (f" (preempted at step {preempted}, checkpointed)"
           if preempted is not None else ""),
        flush=True,
    )
    return 0


def _train_config(args):
    """The ``TrainConfig`` of the flags."""
    from .parallel.train import TrainConfig

    return TrainConfig(
        lr=args.lr,
        grad_topo=args.grad_topo,
        grad_clip_norm=args.grad_clip,
        schedule=args.schedule,
        warmup_steps=args.warmup_steps,
        total_steps=args.steps if args.schedule == "warmup_cosine" else 0,
        min_lr_frac=args.min_lr_frac,
        codec=args.codec,
        autotune=args.autotune,
        overlap=args.overlap,
        shard_optimizer=args.shard_optimizer,
    )


def _feedback(args, supervision, state, shape, dev, obs_dir):
    """``supervision`` (a new one when None) armed with the closed-loop
    planner feedback of ``--feedback-*`` (the JAX trainer's wiring).

    The probes run over the largest mesh axis, priced at the parameter
    bytes.  Refits go to ``--feedback-calibration``, else to a run-local
    ``CALIBRATION.feedback.json`` (under ``obs_dir``, else in a private
    temporary directory) seeded as a copy of ``$FLEXTREE_CALIBRATION``:
    a refit rewrites its backend's section, and the host's measured file
    must never be the one rewritten.  The replan hook points
    ``FLEXTREE_CALIBRATION`` (and ``FLEXTREE_CALIBRATION_BACKEND`` when
    unset, so a CPU run reads the section) at that file and rebuilds the
    step alone: the bucket plan is derived from the calibration on every
    sync call, so the variables stay pointed there for the rest of the
    run (``main`` restores them at its end), and the rebuilt step holds
    a new step cache, so no plan state of the old step survives."""
    from .parallel.loop import Supervision
    from .planner.feedback import FeedbackConfig, FeedbackController
    from .utils.tree import tree_leaves, tree_map

    leaves = tree_leaves(state["params"])
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    # the parameter shapes the rebuilt checkpoint converters lay out
    shapes = tree_map(lambda t: torch.empty_like(t, device="meta"),
                      state["params"])
    cal = args.feedback_calibration
    if not cal:
        cal = os.path.join(
            obs_dir if obs_dir is not None
            else tempfile.mkdtemp(prefix="ft-feedback-"),
            "CALIBRATION.feedback.json")
        host = os.environ.get("FLEXTREE_CALIBRATION")
        if host and os.path.exists(host):
            os.makedirs(os.path.dirname(cal), exist_ok=True)
            shutil.copyfile(host, cal)

    def rebuild(plan, params):
        os.environ["FLEXTREE_CALIBRATION"] = cal
        os.environ.setdefault("FLEXTREE_CALIBRATION_BACKEND",
                              controller._backend_name())
        cfg, tc, _, step, comm = _build(args, _train_config(args), shape,
                                        dev, None)
        pack, unpack = sharded_hooks(comm, cfg, shapes, tc, args.model)
        return (step, comm, None, pack, unpack)

    controller = FeedbackController(
        max(shape), param_bytes,
        FeedbackConfig(every_k=args.feedback_every, band=args.feedback_band,
                       calibration_path=cal, on_replan=rebuild),
        device=dev)
    if supervision is None:
        supervision = Supervision()
    supervision.feedback = controller
    return supervision


def _build(args, tc, shape, dev, gen):
    """``(model config, train config, train state, step, comm)`` for
    ``--model``; an ``autotune`` config comes back with its ``grad_topo``
    resolved, which the state, the step and the checkpoint converters all
    read.  ``gen=None`` builds the step alone (the state is None): the
    feedback replan's rebuild."""
    from .models.transformer import TransformerConfig
    from .parallel.mesh import Mesh, flat_mesh
    from .parallel.train import maybe_autotune_grad_topo

    common = dict(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, dtype=_DTYPES[args.dtype],
        sp_impl=args.sp_impl, attn_impl=args.attn_impl,
    )
    if args.model == "pipeline":
        from .parallel.pipeline import (
            autotune_pipeline_grad_topo,
            init_pipeline_train_state,
            make_mesh_4d,
            make_pipeline_train_step,
        )

        cfg = TransformerConfig(**common)
        comm = make_mesh_4d(shape=shape, device=dev)
        tc = autotune_pipeline_grad_topo(comm, cfg, tc, _AXES["pipeline"])
        state = None if gen is None else init_pipeline_train_state(
            cfg, gen, tc, device=dev, comm=comm)
        return (cfg, tc, state,
                make_pipeline_train_step(cfg, tc, args.microbatches,
                                         comm=comm), comm)
    if args.model == "moe":
        from .models.moe import MoEConfig, init_moe_params
        from .parallel.moe_train import (
            init_moe_train_state,
            make_mesh_moe,
            make_moe_train_step,
        )

        cfg = MoEConfig(**common, n_experts=args.n_experts, top_k=args.top_k,
                        capacity_factor=args.capacity_factor)
        comm = make_mesh_moe(shape=shape, device=dev)
        tc = maybe_autotune_grad_topo(comm, cfg, tc, _AXES["moe"],
                                      init_fn=init_moe_params)
        state = None if gen is None else init_moe_train_state(
            cfg, gen, tc, device=dev, comm=comm)
        return (cfg, tc, state,
                make_moe_train_step(cfg, tc, comm=comm), comm)
    from .parallel.train import AXIS_NAMES, init_train_state, make_train_step

    cfg = TransformerConfig(**common)
    dp = shape[0]
    if math.prod(shape) > dp:
        comm = Mesh((dev,) * math.prod(shape), AXIS_NAMES, shape)
    else:
        comm = flat_mesh(dp, dev, "dp") if dp > 1 else None
    tc = maybe_autotune_grad_topo(comm, cfg, tc, AXIS_NAMES, device=dev)
    state = None if gen is None else init_train_state(cfg, gen, tc,
                                                      device=dev, comm=comm)
    return (cfg, tc, state, make_train_step(cfg, tc, device=dev, comm=comm),
            comm)


if __name__ == "__main__":
    raise SystemExit(main())
