"""Training entry point on one card: ``python -m flextree_tpu_torch.trainer``.

The port's counterpart of ``python -m flextree_tpu.trainer --model dense``
on one device: the dense LM trained on the synthetic corpus, with
checkpoints and resume.  It takes the JAX trainer's flags with their
defaults, plus ``--dtype`` for the compute dtype.  Examples::

    # on the card (the default), flash attention, bf16 compute
    python -m flextree_tpu_torch.trainer --attn-impl flash --dtype bfloat16

    # on the CPU (the flash kernels' plain versions)
    python -m flextree_tpu_torch.trainer --cpu --attn-impl flash --steps 3

``--cpu`` is a switch (the port runs one rank).  A flag whose module is
not ported yet raises ``NotImplementedError`` naming its ROADMAP item.
The last line printed is the JAX trainer's.
"""

from __future__ import annotations

import argparse

import torch

_ROADMAP = "ROADMAP.md, Queue 1"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="flextree_tpu_torch.trainer",
        description="Train the dense LM on one card.",
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
                    help="sequence-parallel attention; with one device the "
                    "whole sequence is local and this has no effect")
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
                    help="FT_TOPO-style widths for the gradient allreduce "
                    "(inert on one rank)")
    ap.add_argument("--codec", choices=["f32", "bf16", "int8"], default="f32")
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--shard-optimizer", action="store_true")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--mesh", type=str, default=None,
                    help="mesh shape; only one device (1,1,1) is ported")
    ap.add_argument("--devices", type=int, default=None,
                    help="device count; only 1 is ported")
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


def _refuse_unported(args) -> None:
    """Raise for a flag whose module is not ported, naming its item."""
    mesh = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None
    refusals = (
        (args.model != "dense", f"--model {args.model}",
         "'Sequence, pipeline and expert parallelism'"),
        (args.codec != "f32", f"--codec {args.codec}",
         "'Compressed collectives and error feedback'"),
        (args.overlap, "--overlap", "'Overlap'"),
        (args.shard_optimizer, "--shard-optimizer", "'ZeRO-1'"),
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
        ((mesh is not None and any(n != 1 for n in mesh))
         or args.devices not in (None, 1), "more than one device",
         "'Bucketed data-parallel sync on the collectives'"),
    )
    for bad, what, item in refusals:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet ({_ROADMAP}: {item})"
            )


def main(argv=None, *, out: dict | None = None) -> int:
    """Run the trainer; ``out``, when given, receives the run's
    ``FitResult``, model and train configs under ``"result"``,
    ``"model_cfg"`` and ``"train_cfg"`` (for in-process callers that
    check the run, such as ``chip_smoke.py``)."""
    args = _parser().parse_args(argv)
    _refuse_unported(args)

    from .data import LMDataset, synthetic_tokens
    from .device import resolve_device
    from .models.transformer import TransformerConfig
    from .parallel.loop import FitConfig, fit
    from .parallel.train import TrainConfig, init_train_state, make_train_step

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, dtype=_DTYPES[args.dtype],
        attn_impl=args.attn_impl,
    )
    tc = TrainConfig(
        lr=args.lr,
        grad_topo=args.grad_topo,
        grad_clip_norm=args.grad_clip,
        schedule=args.schedule,
        warmup_steps=args.warmup_steps,
        total_steps=args.steps if args.schedule == "warmup_cosine" else 0,
        min_lr_frac=args.min_lr_frac,
    )
    state = init_train_state(cfg, torch.Generator().manual_seed(args.seed),
                             tc, device=dev)
    dataset = LMDataset(
        synthetic_tokens(args.corpus_tokens, args.vocab, seed=args.seed),
        batch=args.batch, seq_len=args.seq_len, seed=args.seed,
    )
    result = fit(
        state, make_train_step(cfg, tc, device=dev), dataset,
        FitConfig(num_steps=args.steps, ckpt_dir=args.ckpt_dir,
                  ckpt_every=args.ckpt_every, log_every=args.log_every,
                  resume=not args.no_resume),
    )
    if out is not None:
        out.update(result=result, model_cfg=cfg, train_cfg=tc)
    first = result.losses[0][1] if result.losses else float("nan")
    last = result.losses[-1][1] if result.losses else float("nan")
    mesh = {"dp": 1, "sp": 1, "tp": 1}
    print(
        f"{args.model}: {result.steps_run} steps on mesh {mesh}; loss "
        f"{first:.4f} -> {last:.4f}"
        + (f" (resumed from {result.resumed_from})"
           if result.resumed_from else "")
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
