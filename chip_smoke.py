#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``flextree_tpu_torch`` (never JAX) on the card, in phases; any
failure raises and exits non-zero:

1. device and build — the card's name and power limit (``nvidia-smi``),
   and every CUDA kernel built from ``flextree_tpu_torch/csrc``;
2. kernel parity — the paged-decode kernel against its plain versions
   (the plain stream and the gather oracle) at the flagship decode shape
   (S=8 slots, H=8, D=64, bs=16, P=64, N=257) on boundary lengths:
   within ``FUSED_DECODE_ATOL`` in float32 and 0.05 in bfloat16, and
   bitwise unchanged when the null block is poisoned;
3. serving — ``ServingEngine`` at the flagship width (vocab 8192,
   d_model 512, 8 heads, 4 layers, d_ff 2048, bf16) with the kernel:
   16 requests, prompts uniform over 16..256, 64 new tokens each.  Every
   request completes, and the kernel's launch count over the run equals
   decode rounds x layers;
4. times — the kernel, its plain stream and
   ``F.scaled_dot_product_attention`` on the pre-gathered view (a
   yardstick only; the port never calls it) on the inputs of the heaviest
   decode round of phase 3, each launch with a cold L2, beside the
   least time the card could take (bytes over the memory rate);
5. profile — 8 more requests through the same engine under
   ``torch.profiler``: the device's busy share of the wall time and the
   kernels that take it;
6. float32 token identity — the kernel engine, the gather-oracle engine
   and the contiguous-cache ``generate`` give the same greedy tokens.

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when no CUDA device is present.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))

# flagship model (the JAX package's single-chip flagship) and its cache
MODEL = dict(vocab_size=8192, d_model=512, n_heads=8, n_layers=4, d_ff=2048)
CACHE = dict(num_blocks=257, block_size=16, blocks_per_seq=64)
SLOTS = 8
N_REQUESTS = 16
PROMPT_RANGE = (16, 256)
MAX_NEW = 64
SEED = 0

# memory rate (bytes/s) and float32 non-tensor-core peak (FLOP/s) by card
# name, from NVIDIA's data sheets (dense, full power limit)
_CARDS = (
    ("H200", 4.8e12, 67e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100", 3.35e12, 67e12),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    for key, bw, flops in _CARDS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no peak rates recorded for card {name!r}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def boundary_inputs(dtype, gen, dev, lengths, S=8, H=8, D=64, N=257, bs=16,
                    P=64):
    """q, k_new, v_new, pools, tables, lengths at the flagship decode
    shape; each row owns ``length // bs + 1`` private blocks (block 0, the
    null block, pads every table row)."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    q, kn, vn = rnd(S, H, D), rnd(S, H, D), rnd(S, H, D)
    kp, vp = rnd(N, bs, H, D), rnd(N, bs, H, D)
    tables = torch.zeros((S, P), dtype=torch.int32)
    nxt = 1
    for s, length in enumerate(lengths):
        n = min(length // bs + 1, P)
        tables[s, :n] = torch.arange(nxt, nxt + n)
        nxt += n
    if nxt > N:
        raise ValueError("boundary rows need more blocks than the pool has")
    return (q, kn, vn, kp, vp, tables.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def phase_parity(dev, FUSED_DECODE_ATOL, pa):
    bs, P = CACHE["block_size"], CACHE["blocks_per_seq"]
    lengths = [0, 1, bs - 1, bs, bs + 1, P * bs - 1, 300, 700]
    gen = torch.Generator().manual_seed(SEED)
    out = {}
    for name, dtype, tol in (("f32", torch.float32, FUSED_DECODE_ATOL),
                             ("bf16", torch.bfloat16, 0.05)):
        args = boundary_inputs(dtype, gen, dev, lengths)
        got = pa.paged_attention(*args)
        stream = pa.paged_attention(*args, impl="torch")
        gather = pa.paged_attention_gather(*args)
        torch.cuda.synchronize()
        e_stream = (got.float() - stream.float()).abs().max().item()
        e_gather = (got.float() - gather.float()).abs().max().item()
        if not (e_stream <= tol and e_gather <= tol):
            raise AssertionError(
                f"{name}: kernel vs plain stream {e_stream}, vs gather "
                f"{e_gather}, tolerance {tol}"
            )
        q, kn, vn, kp, vp, tables, lens = args
        if not torch.equal(got[0], vn[0]):
            raise AssertionError(f"{name}: inactive slot != v_new")
        pk, pv = kp.clone(), vp.clone()
        pk[0] = 1e30
        pv[0] = 1e30
        poisoned = pa.paged_attention(q, kn, vn, pk, pv, tables, lens)
        torch.cuda.synchronize()
        if not torch.equal(poisoned, got):
            raise AssertionError(f"{name}: poisoned null block moved the "
                                 f"kernel output")
        out[name] = {"vs_stream": e_stream, "vs_gather": e_gather,
                     "tolerance": tol, "poison_bitwise": True}
        log(f"phase 2 parity {name}: kernel vs stream {e_stream:.3g}, vs "
            f"gather {e_gather:.3g} (tol {tol}); poisoned null block "
            f"bitwise equal; inactive slot == v_new")
    return out


def make_requests(Request):
    rng = np.random.default_rng(SEED)
    return [
        Request(
            rid=i,
            prompt=rng.integers(
                0, MODEL["vocab_size"],
                (int(rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1)),),
            ).astype(np.int32),
            max_new_tokens=MAX_NEW,
        )
        for i in range(N_REQUESTS)
    ]


def run_engine(serving, params, cfg, pcfg, fused, dev, record_rounds=None):
    eng = serving.ServingEngine(
        params, cfg, pcfg, serving.BatcherConfig(slots=SLOTS), fused=fused,
        decode_impl="cuda", device=dev,
    )
    if record_rounds is not None:
        inner = eng._decode

        def recording(p, pools, tables, lengths, tokens):
            record_rounds.append((tables.clone(), lengths.clone()))
            return inner(p, pools, tables, lengths, tokens)

        eng._decode = recording
    eng.warmup()
    return eng


def drive(eng, reqs, pa):
    """Submit every request and run to idle, with the launch count set
    to 0 just before and read just after."""
    pa.paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for r in reqs:
        if not eng.submit(r):
            raise AssertionError(f"request {r.rid} rejected: "
                                 f"{eng.batcher.rejected}")
    eng.run_until_idle()
    torch.cuda.synchronize()
    makespan = time.monotonic() - t0
    return makespan, pa.paged_attention.launches


def time_launches(fn, n, flush):
    """Mean ms of ``fn()`` over ``n`` launches, each after an L2 flush."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for _ in range(3):
        fn()
    for i in range(n):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / n


def phase_times(dev, pa, pools, rounds, bw, fp32_peak):
    """Kernel, plain stream and SDPA yardstick on the heaviest phase-3
    round's tables and lengths (the engine's bf16 layer-0 pools)."""
    tables, lengths = max(rounds, key=lambda r: int(r[1].sum()))
    S, H, D = SLOTS, MODEL["n_heads"], MODEL["d_model"] // MODEL["n_heads"]
    kp, vp = pools["k"][0], pools["v"][0]
    gen = torch.Generator().manual_seed(SEED + 1)
    q, kn, vn = (torch.randn((S, H, D), generator=gen).to(dev, kp.dtype)
                 for _ in range(3))
    args = (q, kn, vn, kp, vp, tables, lengths)
    got = pa.paged_attention(*args)
    plain = pa.paged_attention(*args, impl="torch")
    err = (got.float() - plain.float()).abs().max().item()
    if err > 0.05:
        raise AssertionError(f"main-path inputs: kernel vs plain {err}")
    # the yardstick: SDPA over the pre-gathered, spliced view
    bs = kp.shape[1]
    view_k = kp[tables.long()].reshape(S, -1, H, D)
    view_v = vp[tables.long()].reshape(S, -1, H, D)
    rows = torch.arange(S, device=dev)
    view_k[rows, lengths.long()] = kn
    view_v[rows, lengths.long()] = vn
    vk, vv = view_k.transpose(1, 2), view_v.transpose(1, 2)  # (S, H, L, D)
    pos = torch.arange(vk.shape[2], device=dev)
    mask = (pos[None, :] <= lengths.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = F.scaled_dot_product_attention(q4, vk, vv, attn_mask=mask)[:, :, 0]
    lib_err = (lib.float() - plain.float()).abs().max().item()
    if lib_err > 0.05:
        raise AssertionError(f"SDPA yardstick disagrees: {lib_err}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    saved = pa.paged_attention.launches
    ms = time_launches(lambda: pa.paged_attention(*args), 200, flush)
    pa.paged_attention.launches = saved  # timing launches do not count
    plain_ms = time_launches(
        lambda: pa.paged_attention(*args, impl="torch"), 30, flush)
    library_ms = time_launches(
        lambda: F.scaled_dot_product_attention(q4, vk, vv, attn_mask=mask),
        200, flush)
    # least work: each row's K/V positions < length read once, the new
    # token's K/V, q and the output once, its table entries and length
    elem = kp.element_size()
    lens = lengths.long().cpu()
    positions = int(lens.sum())
    kv_bytes = 2 * positions * H * D * elem
    table_bytes = int(((lens + bs - 1) // bs).sum()) * 4 + S * 4
    io_bytes = 4 * S * H * D * elem
    n_bytes = kv_bytes + table_bytes + io_bytes
    flops = 4 * (positions + S) * H * D  # q.k and p.v multiply-adds
    t_bytes, t_ops = n_bytes / bw * 1e3, flops / fp32_peak * 1e3
    return {
        "lengths": [int(x) for x in lens],
        "max_abs_err": err,
        "sdpa_vs_plain": lib_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bytes": n_bytes,
        "flops": flops,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def phase_profile(eng, reqs):
    """Run ``reqs`` again (fresh ids) under ``torch.profiler``: device
    busy time (kernel time summed; one stream, so no overlap) over the
    wall time, and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for r in reqs:
            eng.submit(dataclasses.replace(r, rid=r.rid + 10_000,
                                           arrival_s=0.0))
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the device's own rows (kernels, copies): operator rows carry their
    # kernels' time too, and counting both would count it twice
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    busy_us = sum(device_us(e) for e in rows)
    top = sorted(rows, key=device_us, reverse=True)[:10]
    out = {
        "wall_s": wall_s,
        "device_busy_s": busy_us / 1e6 if rows else None,
        "device_busy_share": busy_us / 1e6 / wall_s if rows else None,
        "top": [{"name": e.key[:80], "count": e.count,
                 "device_ms": device_us(e) / 1e3} for e in top],
    }
    if rows:
        log(f"phase 5 profile: wall {wall_s:.3f} s, device busy "
            f"{out['device_busy_s']:.3f} s = "
            f"{100 * out['device_busy_share']:.1f}% (under the profiler)")
        for t in out["top"]:
            log(f"  {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['name']}")
    else:
        log("phase 5 profile: the profiler recorded no device time "
            "(not measured)")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from flextree_tpu_torch import kernels, serving
    from flextree_tpu_torch.models.generate import generate
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from flextree_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- phase 1: device and build
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    bw, fp32_peak = card_peaks(kind)
    log(f"phase 1 device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")
    t0 = time.monotonic()
    kernels.build()
    build_s = time.monotonic() - t0
    for name, info in kernels.build_log.items():
        regs = [ln.strip() for ln in info["ptxas"].splitlines()
                if "registers" in ln]
        log(f"phase 1 build {name}: {info['seconds']:.2f} s; "
            f"{' | '.join(regs)}")
    log(f"phase 1 build total: {build_s:.2f} s")

    # ---- phase 2: kernel parity at the flagship decode shape
    phase_parity(dev, pa.FUSED_DECODE_ATOL, pa)

    # ---- phase 3: serving at flagship width, bf16, through the kernel
    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16)
    pcfg = serving.PagedCacheConfig(**CACHE)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device=dev)
    reqs = make_requests(serving.Request)
    rounds: list = []
    eng = run_engine(serving, params, cfg, pcfg, True, dev, rounds)
    makespan, launches = drive(eng, reqs, pa)
    done = eng.completed
    if len(done) != N_REQUESTS or any(
        d.n_tokens != MAX_NEW for d in done.values()
    ):
        raise AssertionError(f"{len(done)}/{N_REQUESTS} requests completed")
    for d in done.values():
        if not ((d.tokens >= 0) & (d.tokens < MODEL["vocab_size"])).all():
            raise AssertionError(f"request {d.rid}: token out of range")
    want = eng.decode_steps * MODEL["n_layers"]
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != decode rounds "
                             f"{eng.decode_steps} x layers")
    tokens = sum(d.n_tokens for d in done.values())
    ttft = np.array([d.ttft_s for d in done.values()]) * 1e3
    per_tok = np.array([d.per_token_s for d in done.values()]) * 1e3
    serve = {
        "requests": N_REQUESTS, "completed": len(done), "tokens": tokens,
        "decode_rounds": eng.decode_steps, "kernel_launches": launches,
        "makespan_s": makespan, "tok_per_s": tokens / makespan,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "per_token_ms_mean": float(per_tok.mean()),
        "round_ms_p50": eng.report()["histograms"]["serve.round_ms"]["p50"],
    }
    log(f"phase 3 serving: {len(done)}/{N_REQUESTS} completed, {tokens} "
        f"tokens in {makespan:.3f} s = {serve['tok_per_s']:.1f} tok/s; TTFT "
        f"p50 {serve['ttft_ms_p50']:.2f} ms p99 {serve['ttft_ms_p99']:.2f} "
        f"ms; per-token {serve['per_token_ms_mean']:.3f} ms; kernel launches "
        f"{launches} = {eng.decode_steps} rounds x {MODEL['n_layers']} layers")

    # ---- phase 4: times, on phase 3's inputs
    times = phase_times(dev, pa, eng.pools, rounds, bw, fp32_peak)
    log(f"phase 4 times (lengths {times['lengths']}): kernel "
        f"{times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, SDPA "
        f"{times['library_ms']:.4f} ms, bound {times['bound_ms']:.4f} ms "
        f"({times['bound_by']})")

    # ---- phase 5: where a serving run's time goes
    phase_profile(eng, reqs[:8])
    del eng

    # ---- phase 6: float32 greedy token identity
    cfg32 = TransformerConfig(**MODEL, dtype=torch.float32)
    tokens32 = {}
    for fused in (True, False):
        e = run_engine(serving, params, cfg32, pcfg, fused, dev)
        drive(e, reqs, pa)
        tokens32[fused] = {rid: d.tokens for rid, d in e.completed.items()}
        del e
    same = all(np.array_equal(tokens32[True][r.rid], tokens32[False][r.rid])
               for r in reqs)
    if not same:
        raise AssertionError("f32 kernel engine and gather engine disagree")
    for r in reqs[:4]:
        ref = generate(
            params, torch.as_tensor(r.prompt, dtype=torch.long,
                                    device=dev)[None],
            cfg32, max_new_tokens=MAX_NEW, max_len=pcfg.max_len,
        )[0].cpu().numpy()
        if not np.array_equal(ref, tokens32[True][r.rid]):
            raise AssertionError(f"request {r.rid}: engine != generate")
    log(f"phase 6 f32: kernel engine == gather engine on all {N_REQUESTS} "
        f"requests; == generate on 4")

    kline = {"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "flextree_tpu_torch/csrc/paged_attention.cu",
        "replaces": "flextree_tpu/ops/paged_attention.py:183",
        "launches": launches,
        "max_abs_err": times["max_abs_err"],
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": times["library_ms"],
    }]}
    print(json.dumps(kline))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
