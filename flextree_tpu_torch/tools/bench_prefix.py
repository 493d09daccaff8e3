"""Cross-request prefix cache A/B: a warm-index engine against a cold one
on a Zipf-shared system-prompt workload.

    python -m flextree_tpu_torch.tools.bench_prefix [--smoke] [--seed N]
        [--device cuda|cpu] [--out PATH]

The port's copy of the JAX package's ``tools/bench_prefix.py``, with its
floors, machine-checked (a non-zero exit on any violation):

1. **Bitwise floor**: every request the WARM-index engine served produced
   exactly the tokens the persistent COLD engine (prefix cache off) and
   the contiguous-cache ``models/generate.py::generate`` produce — the
   oracle, which shares no serving code with either engine.
2. **Tokens-not-recomputed floor**: at least :data:`MIN_SAVED_FRAC` of
   all prompt tokens come from cached blocks, overall and on every warm
   round.
3. **Hit-rate floor**: every round after the first hits on at least
   :data:`MIN_WARM_HIT_RATE` of its admissions.
4. **TTFT floor** (full run only): the median paired per-request TTFT
   ratio, warm over cold, on warm rounds is at most
   :data:`MAX_HIT_TTFT_RATIO`.
5. **Leak floor**: after draining and dropping the index's references,
   every block is back on the free list.
6. **Negative control**: unique prompts through a fresh warm-enabled
   engine hit nothing, save nothing, and are still bitwise.

Both engines decode on the fused paged path (the paged-attention kernel
on a card, its plain stream on the CPU).  The workload is the JAX
tool's, from the same numpy seed: :data:`N_SYS` system prompts of
:data:`SYS_LEN` tokens, Zipf-weighted (a = 1.2), heavy-tailed private
suffixes, ~10% bare system prompts (the full-chain COW case); its token
ids are drawn over the JAX tool's vocabulary (:data:`WORKLOAD_VOCAB`)
whatever the model's, so :func:`build_round` gives the JAX tool's
requests bitwise.  The model is the JAX tool's (vocab 256, d_model 128,
8 heads, 4 layers, d_ff 512) on the CPU and the flagship width on a card,
float32 either way.  The report (the JAX keys) goes to ``--out``
(default ``tmp/bench_prefix.json``), never to ``BENCH_PREFIX.json``.
Runs on ``cuda`` unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import sys

import numpy as np
import torch

from . import FLAGSHIP, checked_out

__all__ = ["SYS_LEN", "N_SYS", "SUFFIX_LENS", "SUFFIX_PROBS", "BARE_FRAC",
           "OUT_LENS", "OUT_PROBS", "MIN_SAVED_FRAC", "MIN_WARM_HIT_RATE",
           "MAX_HIT_TTFT_RATIO", "WORKLOAD_VOCAB", "build_round",
           "negative_control", "run_bench", "main"]

SYS_LEN = 32  # 4 full blocks at block_size 8
N_SYS = 5
SUFFIX_LENS = [2, 3, 4, 6, 8, 12, 16]
SUFFIX_PROBS = [0.24, 0.20, 0.18, 0.14, 0.12, 0.07, 0.05]
BARE_FRAC = 0.10  # bare system prompt: the full-chain COW case
OUT_LENS = [4, 6, 8, 12]
OUT_PROBS = [0.35, 0.30, 0.20, 0.15]

MIN_SAVED_FRAC = 0.50
MIN_WARM_HIT_RATE = 0.50
MAX_HIT_TTFT_RATIO = 0.90  # full-run TTFT floor: hits >= 10% faster

#: the JAX tool's vocabulary: the workload's token ids are drawn over it
WORKLOAD_VOCAB = 256

#: the model widths: the JAX tool's on the CPU, the flagship's on a card
WIDTHS = {
    "jax": dict(vocab_size=256, d_model=128, n_heads=8, n_layers=4,
                d_ff=512),
    "flagship": dict(FLAGSHIP),
}


def _model(widths: dict, dev):
    from ..models.transformer import TransformerConfig, init_params

    cfg = TransformerConfig(**widths, dtype=torch.float32)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device=dev)


def _pcfg():
    from ..serving import PagedCacheConfig

    return PagedCacheConfig(num_blocks=128, block_size=8, blocks_per_seq=8)


def _zipf_weights(n: int, a: float = 1.2) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** a
    return w / w.sum()


def build_round(rng, sys_prompts, n: int, rid0: int, vocab: int,
                suffix_lens=None, suffix_probs=None,
                out_lens=None, out_probs=None):
    """One round of requests: Zipf-weighted system prompt + heavy-tailed
    private suffix (or no suffix at all — the COW case); the JAX tool's
    draws, in its order."""
    from ..serving import Request

    suffix_lens = SUFFIX_LENS if suffix_lens is None else suffix_lens
    suffix_probs = SUFFIX_PROBS if suffix_probs is None else suffix_probs
    out_lens = OUT_LENS if out_lens is None else out_lens
    out_probs = OUT_PROBS if out_probs is None else out_probs
    reqs = []
    zipf = _zipf_weights(len(sys_prompts))
    for i in range(n):
        sysp = sys_prompts[rng.choice(len(sys_prompts), p=zipf)]
        if rng.random() < BARE_FRAC:
            prompt = sysp.copy()
        else:
            s = int(rng.choice(suffix_lens, p=suffix_probs))
            prompt = np.concatenate(
                [sysp, rng.integers(0, vocab, (s,)).astype(np.int32)]
            )
        reqs.append(Request(
            rid=rid0 + i, prompt=prompt,
            max_new_tokens=int(rng.choice(out_lens, p=out_probs)),
        ))
    return reqs


def run_batch(eng, reqs):
    """Submit a round and drain it; returns per-rid TTFT seconds."""
    from ..serving import engine as engine_mod

    for r in reqs:
        r = dataclasses.replace(r, arrival_s=engine_mod._now())
        if not eng.submit(r):
            raise RuntimeError(f"rid {r.rid} rejected at submit")
    eng.run_until_idle()
    return {r.rid: eng.completed[r.rid].ttft_s for r in reqs}


def _oracle(cfg, params, pcfg, prompt, max_new, dev) -> np.ndarray:
    from ..models.generate import generate

    p = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=dev)
    return generate(params, p[None], cfg, max_new_tokens=max_new,
                    max_len=pcfg.max_len)[0].cpu().numpy()


def check_bitwise(cfg, params, pcfg, reqs, warm_eng, cold_eng, dev):
    violations = 0
    for r in reqs:
        want = _oracle(cfg, params, pcfg, r.prompt, r.max_new_tokens, dev)
        w = warm_eng.completed[r.rid].tokens
        c = cold_eng.completed[r.rid].tokens
        if not (np.array_equal(w, want) and np.array_equal(c, want)):
            violations += 1
    return violations


def _prefix_counters(eng) -> dict:
    snap = eng.metrics.snapshot()["counters"]
    return {
        k: snap.get(k, 0)
        for k in ("serve.prefix_hits", "serve.prefix_misses",
                  "serve.prefix_cow", "serve.cached_tokens_saved")
    }


def negative_control(cfg, params, pcfg, seed: int, n: int, dev,
                     len_choices=None) -> dict:
    """Unique prompts through a fresh warm-enabled engine: the cache must
    win nothing and corrupt nothing.  ``len_choices`` pins prompt lengths
    to a small set (smoke mode: uniqueness lives in the token content,
    not the length)."""
    from ..serving import BatcherConfig, Request, ServingEngine

    rng = np.random.default_rng(seed)
    eng = ServingEngine(params, cfg, pcfg,
                        BatcherConfig(slots=4, prefix_cache=True),
                        device=dev)
    reqs = [
        Request(rid=i, prompt=rng.integers(
            0, WORKLOAD_VOCAB,
            (int(rng.choice(len_choices)) if len_choices is not None
             else int(rng.integers(20, 45)),)
        ).astype(np.int32), max_new_tokens=4)
        for i in range(n)
    ]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    violations = sum(
        0 if np.array_equal(
            eng.completed[r.rid].tokens,
            _oracle(cfg, params, pcfg, r.prompt, 4, dev),
        ) else 1
        for r in reqs
    )
    ctr = _prefix_counters(eng)
    eng.release_prefix_cache()
    return {
        "requests": n,
        "hits": ctr["serve.prefix_hits"],
        "cached_tokens_saved": ctr["serve.cached_tokens_saved"],
        "bitwise_violations": violations,
        "leaked_blocks": (
            pcfg.num_blocks - 1 - eng.batcher.allocator.num_free
        ),
        "ok": (
            ctr["serve.prefix_hits"] == 0
            and ctr["serve.cached_tokens_saved"] == 0
            and violations == 0
            and eng.batcher.allocator.num_free == pcfg.num_blocks - 1
        ),
        # decode rounds run on the fused path (the kernel once a layer on a
        # card); this engine runs no warmup
        "fused_rounds": eng.decode_steps,
    }


def run_bench(*, smoke: bool, seed: int = 0, device=None, widths=None,
              log=print) -> dict:
    """The whole A/B and its floors (the JAX tool's ``main``).
    ``widths`` replaces the model's (a test's tiny model)."""
    import time

    from ..device import resolve_device
    from ..serving import BatcherConfig, ServingEngine

    _now = time.perf_counter
    dev = resolve_device(device)
    t_start = _now()
    rounds = 2 if smoke else 5
    per_round = 10 if smoke else 24
    # smoke trims the distributions' diversity, not behavior: fewer
    # distinct (prompt, suffix, output) lengths, as the JAX tool's smoke
    if smoke:
        suffix_lens, suffix_probs = [2, 4, 8], [0.45, 0.35, 0.20]
        out_lens, out_probs = [4, 8], [0.75, 0.25]
        per_round = 8
    else:
        suffix_lens, suffix_probs = SUFFIX_LENS, SUFFIX_PROBS
        out_lens, out_probs = OUT_LENS, OUT_PROBS
    if widths is None:
        widths = WIDTHS["flagship" if dev.type == "cuda" else "jax"]
    cfg, params = _model(widths, dev)
    pcfg = _pcfg()
    rng = np.random.default_rng(seed)
    sys_prompts = [
        rng.integers(0, WORKLOAD_VOCAB, (SYS_LEN,)).astype(np.int32)
        for _ in range(N_SYS)
    ]

    warm = ServingEngine(params, cfg, pcfg,
                         BatcherConfig(slots=4, prefix_cache=True),
                         device=dev)
    cold = ServingEngine(params, cfg, pcfg, BatcherConfig(slots=4),
                         device=dev)
    # launch everything once outside the timed rounds, for BOTH engines:
    # the TTFT comparison must measure reuse, not who warmed first
    prompt_lens = sorted({SYS_LEN} | {SYS_LEN + s for s in suffix_lens})
    block_counts = sorted({
        pcfg.blocks_for(t + m) for t in prompt_lens for m in out_lens
    })
    suffix_buckets = [(SYS_LEN, s) for s in suffix_lens] + [(SYS_LEN - 2, 2)]
    log(f"warmup: prompts {prompt_lens}, suffix buckets {suffix_buckets}")
    warm.warmup(prompt_lens, block_counts, suffix_buckets=suffix_buckets)
    cold.warmup(prompt_lens, block_counts)

    round_stats = []
    hit_ttfts, cold_hit_ttfts = [], []
    total_prompt_tokens = 0
    rid0 = 0
    for rnd in range(rounds):
        reqs = build_round(rng, sys_prompts, per_round, rid0, WORKLOAD_VOCAB,
                           suffix_lens, suffix_probs, out_lens, out_probs)
        if smoke and rnd > 0:
            # pin one bare Zipf-head prompt per warm round (the
            # full-chain COW case), as the JAX tool's smoke does
            reqs[-1] = dataclasses.replace(
                reqs[-1], prompt=sys_prompts[0].copy()
            )
        rid0 += per_round
        before = _prefix_counters(warm)
        warm_ttft = run_batch(warm, reqs)
        cold_ttft = run_batch(cold, reqs)
        after = _prefix_counters(warm)
        warm.batcher.prefix_index.check()  # loud structural audit per round
        violations = check_bitwise(cfg, params, pcfg, reqs, warm, cold, dev)
        hits = after["serve.prefix_hits"] - before["serve.prefix_hits"]
        misses = after["serve.prefix_misses"] - before["serve.prefix_misses"]
        saved = (after["serve.cached_tokens_saved"]
                 - before["serve.cached_tokens_saved"])
        prompt_tokens = sum(r.prompt_len for r in reqs)
        total_prompt_tokens += prompt_tokens
        if rnd > 0:
            for r in reqs:
                hit_ttfts.append(warm_ttft[r.rid])
                cold_hit_ttfts.append(cold_ttft[r.rid])
        stat = {
            "round": rnd,
            "requests": per_round,
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / max(hits + misses, 1), 3),
            "cow_forks": after["serve.prefix_cow"] - before["serve.prefix_cow"],
            "cached_tokens_saved": saved,
            "prompt_tokens": prompt_tokens,
            "tokens_saved_frac": round(saved / prompt_tokens, 3),
            "bitwise_violations": violations,
            "warm_ttft_ms_mean": round(
                1e3 * float(np.mean(list(warm_ttft.values()))), 3),
            "cold_ttft_ms_mean": round(
                1e3 * float(np.mean(list(cold_ttft.values()))), 3),
            "index_blocks": warm.batcher.prefix_index.size,
        }
        log(f"round {rnd}: {json.dumps(stat)}")
        round_stats.append(stat)
    # each warmup runs one decode round beside the engines' counted ones
    fused_rounds = {"warm": warm.decode_steps, "cold": cold.decode_steps,
                    "warmup": 2}

    # leak floor: drop the index's references; the pool must be whole
    released = warm.release_prefix_cache()
    leaked = pcfg.num_blocks - 1 - warm.batcher.allocator.num_free
    neg = negative_control(cfg, params, pcfg, seed + 7,
                           4 if smoke else 12, dev,
                           len_choices=[21, 26, 33, 40] if smoke else None)
    fused_rounds["negative_control"] = neg.pop("fused_rounds")
    log(f"negative control: {neg}")

    total_saved = sum(r["cached_tokens_saved"] for r in round_stats)
    saved_frac = total_saved / total_prompt_tokens
    warm_rounds = round_stats[1:]
    # paired per-request ratios (same rid, same queue position on both
    # engines), then the median
    ttft_ratio = (
        float(np.median([w / c for w, c in zip(hit_ttfts, cold_hit_ttfts)]))
        if cold_hit_ttfts else 0.0
    )
    enforce_ttft = not smoke
    floors = {
        "prefix_cache_bitwise_violations": sum(
            r["bitwise_violations"] for r in round_stats
        ) + neg["bitwise_violations"],
        "prefix_tokens_saved_frac": round(saved_frac, 3),
        "min_tokens_saved_frac": MIN_SAVED_FRAC,
        "saved_frac_ok": saved_frac >= MIN_SAVED_FRAC and all(
            r["tokens_saved_frac"] >= MIN_SAVED_FRAC for r in warm_rounds
        ),
        "warm_round_hit_rates": [r["hit_rate"] for r in warm_rounds],
        "min_warm_hit_rate": MIN_WARM_HIT_RATE,
        "hit_rate_ok": all(
            r["hit_rate"] >= MIN_WARM_HIT_RATE for r in warm_rounds
        ),
        "cow_forks": sum(r["cow_forks"] for r in round_stats),
        "cow_ok": sum(r["cow_forks"] for r in round_stats) >= 1,
        "hit_ttft_ratio": round(ttft_ratio, 3),
        "max_hit_ttft_ratio": MAX_HIT_TTFT_RATIO,
        "ttft_floor_enforced": enforce_ttft,
        "ttft_ok": (
            ttft_ratio <= MAX_HIT_TTFT_RATIO if enforce_ttft else True
        ),
        "leaked_blocks": leaked,
        "leak_ok": leaked == 0,
        "negative_control_ok": neg["ok"],
    }
    floors["bitwise_ok"] = floors["prefix_cache_bitwise_violations"] == 0
    ok = bool(
        floors["bitwise_ok"] and floors["saved_frac_ok"]
        and floors["hit_rate_ok"] and floors["cow_ok"]
        and floors["ttft_ok"] and floors["leak_ok"]
        and floors["negative_control_ok"]
    )
    from .bench_serving import _device_line

    return {
        "bench": "prefix_cache_zipf_shared_prompts",
        "smoke": bool(smoke),
        "host": {
            "platform": platform.platform(),
            "python": sys.version.split()[0],
            "torch": torch.__version__,
            "backend": dev.type,
        },
        "device": _device_line(dev),
        "config": {
            "model": f"v{cfg.vocab_size}_d{cfg.d_model}_h{cfg.n_heads}"
            f"_L{cfg.n_layers}_ff{cfg.d_ff}_f32",
            "paged_cache": dataclasses.asdict(pcfg),
            "workload": {
                "rounds": rounds,
                "requests_per_round": per_round,
                "system_prompts": N_SYS,
                "system_prompt_len": SYS_LEN,
                "zipf_a": 1.2,
                "suffix_lens": suffix_lens,
                "suffix_probs": suffix_probs,
                "bare_prompt_frac": BARE_FRAC,
                "out_lens": out_lens,
                "seed": seed,
                "token_vocab": WORKLOAD_VOCAB,
            },
        },
        "rounds": round_stats,
        "index_blocks_released_at_drain": released,
        "negative_control": neg,
        "floors": floors,
        "ok": ok,
        # decode rounds run on the fused path, by engine (the paged kernel
        # once a layer each on a card)
        "fused_rounds": fused_rounds,
        "elapsed_s": round(_now() - t_start, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flextree_tpu_torch.tools.bench_prefix",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("tmp", "bench_prefix.json"))
    ap.add_argument("--smoke", action="store_true",
                    help="small workload; the TTFT floor reported, not "
                         "enforced")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = checked_out(ap, args.out)
    doc = run_bench(smoke=args.smoke, seed=args.seed, device=args.device,
                    log=lambda m: print(m, flush=True))
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(json.dumps({
        "ok": doc["ok"],
        "tokens_saved_frac": doc["floors"]["prefix_tokens_saved_frac"],
        "hit_ttft_ratio": doc["floors"]["hit_ttft_ratio"],
    }))
    if not doc["ok"]:
        print("MACHINE-CHECK FAILED; see floors in " + out, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
