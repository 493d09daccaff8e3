"""Serving entry point: ``python -m flextree_tpu_torch.serving``.

Drives one :class:`ServingEngine` over a synthetic open-batch workload,
with the same flags as ``python -m flextree_tpu.serving``; runs on the
GPU unless ``--cpu`` is given::

    # the defaults: streamed decode through the CUDA kernel
    python -m flextree_tpu_torch.serving --requests 16

    # the gather oracle path
    python -m flextree_tpu_torch.serving --no-fused-decode

    # on-demand allocation with swap-out preemption, on the CPU
    python -m flextree_tpu_torch.serving --cpu --admission ondemand \\
        --preempt swap --blocks 33 --requests 24

Prints a JSON report: completions, throughput, TTFT percentiles and the
cache-pressure accounting from the engine's metrics registry.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flextree_tpu_torch.serving")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=65,
                    help="pool size INCLUDING the reserved null block")
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--blocks-per-seq", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=12,
                    help="prompts are uniform over [4, prompt-len]")
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--n-heads", type=int, default=8)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--d-ff", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--fused-decode", action=argparse.BooleanOptionalAction, default=True,
        help="streamed paged-attention decode (ops/paged_attention.py), "
        "within a pinned tolerance of the gather oracle (the default); "
        "--no-fused-decode keeps the gather path",
    )
    ap.add_argument(
        "--decode-impl", choices=["torch", "cuda"], default="cuda",
        help="streamed-path implementation: the CUDA kernel (default; on "
        "the CPU the plain stream stands in for it) or the plain PyTorch "
        "stream on any device",
    )
    ap.add_argument("--admission", choices=["reserve", "ondemand"],
                    default="reserve",
                    help="block admission policy: reserve = whole "
                    "prompt+output budget up front, ondemand = prompt "
                    "blocks only, pool exhaustion preempts")
    ap.add_argument("--preempt", choices=["swap", "recompute"],
                    default="swap",
                    help="what an evicted sequence keeps: swap = K/V bytes "
                    "in host memory, recompute = replay prefill on resume")
    ap.add_argument("--report", type=str, default=None,
                    help="also write the JSON report to this path")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..models.transformer import TransformerConfig, init_params
    from . import BatcherConfig, PagedCacheConfig, Request, ServingEngine

    device = "cpu" if args.cpu else "cuda"
    cfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff,
    )
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device=device)
    pcfg = PagedCacheConfig(
        num_blocks=args.blocks, block_size=args.block_size,
        blocks_per_seq=args.blocks_per_seq,
    )
    eng = ServingEngine(
        params, cfg, pcfg,
        BatcherConfig(slots=args.slots, admission=args.admission,
                      preempt=args.preempt),
        fused=args.fused_decode,
        decode_impl=args.decode_impl,
        device=device,
    )
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(
                0, args.vocab, (int(rng.integers(4, args.prompt_len + 1)),)
            ).astype(np.int32),
            max_new_tokens=args.max_new,
        )
        for i in range(args.requests)
    ]
    eng.warmup()
    t0 = time.monotonic()
    submitted = sum(1 for r in reqs if eng.submit(r))
    eng.run_until_idle()
    makespan = time.monotonic() - t0
    tokens = sum(d.n_tokens for d in eng.completed.values())
    report = {
        "config": {
            "device": str(eng.device),
            "fused_decode": args.fused_decode,
            "decode_impl": args.decode_impl,
            "admission": args.admission,
            "preempt": args.preempt,
            "slots": args.slots,
            "blocks": args.blocks,
        },
        "submitted": submitted,
        "rejected": list(eng.batcher.rejected),
        "completed": len(eng.completed),
        "tokens": tokens,
        "makespan_s": makespan,
        "throughput_tok_s": tokens / makespan if makespan else 0.0,
        **eng.report(),
    }
    text = json.dumps(report, indent=1)
    print(text)
    if args.report:
        with open(args.report, "w") as f:
            f.write(text + "\n")
    return 0 if len(eng.completed) == submitted else 1


if __name__ == "__main__":
    raise SystemExit(main())
