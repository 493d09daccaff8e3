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
   and the contiguous-cache ``generate`` give the same greedy tokens;
7. flash parity — each flash kernel (forward, dq, dk/dv) against its
   plain version on the same inputs, float32 and bfloat16, at the
   training shape (B=8, T=1024, H=8, D=64), at B=4, T=4096, H=16, D=128
   and on edge cases (ragged Tq, Tq != Tk with offsets, non-causal, rows
   that see no key, an lse cotangent): out within 2e-5 and grads within
   1e-4 in float32; in bfloat16, where both round at the same points,
   each element within 2**-5 of max(|ref|, rms(ref)) and the rms error
   within 2e-4 of rms(ref); the lse within 1e-4; rows that see no key
   exactly 0; every ``variant`` runs the one forward kernel;
8. training — ``trainer.main`` at the flagship width (bf16 compute,
   flash attention, batch 8 x 1024 tokens, 30 steps, warmup-cosine,
   clipping, a checkpoint every 10 steps): the loss is finite and falls,
   each flash kernel launches steps x layers times, the saved checkpoint
   restores bitwise; then steady step time, tokens/s, peak memory and a
   ``torch.profiler`` breakdown of three more steps;
9. float32 end to end — three train steps at full width (batch 2 x 1024)
   with flash and with reference attention from one state: losses within
   rtol 1e-5 and gradients within atol 1e-5; the parameters against atol
   1e-5 printed, each miss beside its step-1 gradient and gradient gap,
   and beside a witness (reference attention on the batch rows reversed);
10. flash times — each flash kernel, its plain version and the SDPA
    yardstick at the training shape (CUDA-event medians), beside the
    least time the card could take;
11. fold and copy parity — the fold kernel against its plain version,
    bitwise, for every op x dtype of the registry, W in {2, 3, 8}, a
    16-byte-aligned and a ragged L, ``sources_tile`` 1 and 4, NaN rows in
    float max/min and a misaligned ``out``; the copy kernel against
    ``clone``, bitwise;
12. fold times — ``bench.harness.run_reduce_bench`` (the ``--bench
    reduce`` path) at the heaviest fold of each phase-13 shape: kernel,
    plain, ``torch.sum``/``amax`` and the copy kernel (with ``clone`` and
    ``copy_``) at the same bytes, each launch with a cold L2 and started
    only once enqueued, beside the byte bound;
13. the FlexTree allreduce — ``bench.harness.run_allreduce_bench`` on an
    in-process mesh of 8 ranks (7 for ``"3,2+1"``) on the card at the
    flagship's parameter count (16,781,824 per rank), shapes ``(8,)``,
    ``(4,2)``, ``(2,2,2)``, the ring and ``"3,2+1"``; f32 and bf16 sum,
    int32 band and f32 max: correct, and the fold kernel's launch count
    equal to the count derived from the topology; each case again on
    seeded random data, every rank identical and bitwise the group-fold
    oracle (integers also the simulator), nine more op/dtype cases at
    1,000,003, the tail path at the count + 5; per shape the median ms,
    bus GB/s and the fold kernel's share under ``torch.profiler``;
14. distributed — four processes on the card over gloo (host staging),
    every rank bitwise the in-process mesh; NCCL at world size 1 returns
    its input bitwise.

Prints each phase's seconds, a ``{"kernels": [...]}`` line, the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, when no CUDA device is present.
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

# memory rate (bytes/s), float32 non-tensor-core peak and bf16 tensor-core
# peak (FLOP/s) by card name, from NVIDIA's data sheets (dense, full power
# limit)
_CARDS = (
    ("H200", 4.8e12, 67e12, 989e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100", 3.35e12, 67e12, 989e12),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    for key, *peaks in _CARDS:
        if key in name:
            return peaks
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


FLASH_REPLACES = (
    ("flash_fwd", "flextree_tpu/ops/pallas_attention.py:79 and :212"),
    ("flash_bwd_dq", "flextree_tpu/ops/pallas_attention.py:524"),
    ("flash_bwd_dkv", "flextree_tpu/ops/pallas_attention.py:601"),
)

# flash parity cases: (name, B, Tq, Tk, H, D, causal, q_offset, k_offset,
# with an lse cotangent)
FLASH_TRAIN = (8, 1024, 8, 64)  # B, T, H, D of one layer of the train step
FLASH_CASES = (
    ("train", 8, 1024, 1024, 8, 64, True, 0, 0, False),
    ("long", 4, 4096, 4096, 16, 128, True, 0, 0, False),
    ("ragged", 2, 100, 100, 4, 64, True, 0, 0, False),
    ("cross", 2, 96, 200, 4, 64, True, 104, 0, False),
    ("noncausal", 2, 100, 160, 4, 128, False, 0, 0, False),
    ("masked_rows", 2, 128, 128, 4, 64, True, 0, 64, False),
    ("lse_grad", 2, 192, 192, 4, 40, True, 0, 0, True),
)
# float32: max |kernel - plain| on out and on the grads (the JAX package's
# own tolerances for its kernels); the lse within LSE_TOL in both dtypes
F32_TOL = {"out": 2e-5, "grad": 1e-4}
LSE_TOL = 1e-4
# bfloat16, where kernel and plain round at the same points and differ in
# float32 summation order: each element within BF16_PEAK of max(|ref|,
# rms(ref)), and the rms of the difference within BF16_RMS of rms(ref).
# Set from the measured errors; removing one rounding point of the TPU
# kernels breaks them (chip_flash_mutants.py, PERF.md)
BF16_PEAK = 2 ** -5
BF16_RMS = 2e-4


def flash_counts(fa):
    return {"flash_fwd": fa.flash_fwd.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def zero_flash_counts(fa):
    fa.flash_fwd.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0


def flash_inputs(case, dtype, dev, gen):
    """q, k, v, do and the lse cotangent (or None) of a parity case."""
    _, b, tq, tk, h, d, _, _, _, with_glse = case

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    glse = (torch.randn((b, h, tq), generator=gen).to(dev)
            if with_glse else None)
    return rnd(b, tq, h, d), rnd(b, tk, h, d), rnd(b, tk, h, d), \
        rnd(b, tq, h, d), glse


def by_batch(fn, *tensors, **kw):
    """``fn`` one batch element at a time (every tensor is batch-first),
    results concatenated: the plain versions form (H, Tq, Tk) matrices,
    and at the long shape a whole batch of them would be ~17 GB each."""
    outs = []
    for i in range(tensors[0].shape[0]):
        outs.append(fn(*(None if t is None else t[i:i + 1] for t in tensors),
                       **kw))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def bf16_errors(got, ref):
    """``(peak, rms)`` of a bfloat16 result against its plain version: the
    largest ``|got - ref| / max(|ref|, rms(ref))`` over the elements, and
    ``rms(got - ref) / rms(ref)``."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    rms = r.square().mean().sqrt().clamp_min(1e-30)
    peak = (diff / torch.maximum(r.abs(), rms)).max()
    return peak.item(), (diff.square().mean().sqrt() / rms).item()


def flash_compare(fa, case, dtype, dev, gen):
    """One parity case through the three kernels and their plain versions
    on the same inputs.  Returns ``(errors, failures, note, kernel
    run)``: errors maps out/lse/dq/dk/dv to ``{"abs": max |got - ref|}``
    (bfloat16 adds ``peak`` and ``rms``, :func:`bf16_errors`), failures
    lists each bar or exact-zero rule broken, note counts the rows that
    see no key and the keys no row sees, and the run is ``(q, k, v,
    out)``."""
    _, _, tq, tk, _, d, causal, qo, ko, _ = case
    q, k, v, do, glse = flash_inputs(case, dtype, dev, gen)
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=qo, k_offset=ko)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    p_out, p_lse = by_batch(fa.flash_fwd_plain, q, k, v, **kw)
    dq = fa.flash_bwd_dq(q, k, v, out, do, lse, glse, **kw)
    p_dq = by_batch(fa.flash_bwd_dq_plain, q, k, v, out, do, lse, glse, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, out, do, lse, glse, **kw)
    p_dk, p_dv = by_batch(fa.flash_bwd_dkv_plain, q, k, v, out, do, lse,
                          glse, **kw)
    torch.cuda.synchronize()
    errs, failures = {}, []
    for key, got, ref in (("out", out, p_out), ("lse", lse, p_lse),
                          ("dq", dq, p_dq), ("dk", dk, p_dk),
                          ("dv", dv, p_dv)):
        e = {"abs": (got.float() - ref.float()).abs().max().item()}
        if key == "lse":
            ok = e["abs"] <= LSE_TOL
        elif dtype == torch.float32:
            ok = e["abs"] <= F32_TOL["out" if key == "out" else "grad"]
        else:
            e["peak"], e["rms"] = bf16_errors(got, ref)
            ok = e["peak"] <= BF16_PEAK and e["rms"] <= BF16_RMS
        if not ok:  # also NaN
            failures.append(f"{key} {e}")
        errs[key] = e
    # rows that see no key: exactly 0 out and dq, the +1e30 sentinel;
    # keys that no row sees: exactly 0 dk and dv
    qpos = qo + torch.arange(tq, device=dev)
    kpos = ko + torch.arange(tk, device=dev)
    vis = (qpos[:, None] >= kpos[None, :]) if causal else \
        torch.ones(tq, tk, dtype=torch.bool, device=dev)
    dead_q, dead_k = ~vis.any(1), ~vis.any(0)
    if dead_q.any() and not ((out[:, dead_q] == 0).all()
                             and (dq[:, dead_q] == 0).all()
                             and (lse[:, :, dead_q] == 1e30).all()):
        failures.append("rows that see no key are not exactly 0")
    if dead_k.any() and not ((dk[:, dead_k] == 0).all()
                             and (dv[:, dead_k] == 0).all()):
        failures.append("keys no row sees have nonzero grads")
    note = (f"{int(dead_q.sum())} dead rows, {int(dead_k.sum())} dead keys "
            f"exact")
    return errs, failures, note, (q, k, v, out)


def describe_case(case, tname):
    name, b, tq, tk, h, d, causal, qo, ko, with_glse = case
    return (f"{name} {tname} (B={b} Tq={tq} Tk={tk} H={h} D={d} "
            f"causal={causal} offsets={qo},{ko}{' g_lse' if with_glse else ''})")


def describe_errors(errs):
    return ", ".join(
        f"{key} {e['abs']:.3g}" + (f" (peak {e['peak']:.3g}, rms "
                                   f"{e['rms']:.3g})" if "peak" in e else "")
        for key, e in errs.items())


def phase_flash_parity(dev, fa):
    """Each flash kernel against its plain version on the same inputs, in
    float32 and bfloat16, at the training shape, the long shape and the
    edge cases (:func:`flash_compare`); at the training shape
    ``flash_attention`` gives the kernel's output bitwise for each
    ``variant``.  Returns each kernel's largest absolute error at the
    training shape."""
    gen = torch.Generator().manual_seed(SEED + 2)
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for case in FLASH_CASES:
        for tname, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            errs, failures, note, run = flash_compare(fa, case, dtype, dev,
                                                      gen)
            if failures:
                raise AssertionError(f"flash parity {describe_case(case, tname)}"
                                     f": " + "; ".join(failures))
            if case[0] == "train":
                # every JAX forward schedule runs this one kernel
                q, k, v, out = run
                for variant in fa.VARIANTS:
                    got = fa.flash_attention(q, k, v, causal=True,
                                             variant=variant)
                    if not torch.equal(got, out):
                        raise AssertionError(f"flash variant {variant!r} "
                                             f"differs from the kernel")
                for name, keys in (("flash_fwd", ("out",)),
                                   ("flash_bwd_dq", ("dq",)),
                                   ("flash_bwd_dkv", ("dk", "dv"))):
                    worst[name] = max([worst[name]]
                                      + [errs[k_]["abs"] for k_ in keys])
            log(f"phase 7 flash parity {describe_case(case, tname)}: "
                f"{describe_errors(errs)}; {note}")
            del run
            torch.cuda.empty_cache()
    return worst


def median_ms(fn, n=30, warmup=3):
    """Median ms of ``fn()`` over ``n`` launches timed with CUDA events,
    after ``warmup`` untimed ones."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for i in range(n):
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def flash_work(b, t, h, d, elem):
    """(flops, bytes) of each flash kernel for one causal layer of
    (B, T, H, D): products over the visible (i, j) pairs — 2 per
    multiply-add, 2 products of D in the forward (q.k, p.v), 3 in dq
    (q.k, do.v, ds.k), 4 in dk/dv (q.k, do.v, p^T do, ds^T q) — and each
    input read once, each output written once (lse and its row vectors
    float32)."""
    pairs = b * h * t * (t + 1) // 2
    x = b * t * h * d * elem  # one (B, T, H, D) tensor
    rows = b * h * t * 4  # one float32 (B, H, T) vector
    return {
        "flash_fwd": (4 * pairs * d, 3 * x + x + rows),
        "flash_bwd_dq": (6 * pairs * d, 5 * x + rows + x),
        "flash_bwd_dkv": (8 * pairs * d, 5 * x + rows + 2 * x),
    }


def phase_flash_times(dev, fa, bw, bf16_peak):
    """Each flash kernel, its plain version and the SDPA yardstick at the
    training shape in bf16, causal: CUDA-event medians after warm-up,
    beside the bound from the data sheet.  SDPA's backward computes dq,
    dk and dv in one call; both backward rows carry that one time."""
    b, t, h, d = FLASH_TRAIN
    gen = torch.Generator().manual_seed(SEED + 3)
    dtype = torch.bfloat16
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen).to(dev, dtype)
                   for _ in range(4))
    kw = dict(causal=True, scale=d ** -0.5)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    runs = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                      lambda: fa.flash_fwd_plain(q, k, v, **kw)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, out, do, lse, **kw),
            lambda: fa.flash_bwd_dq_plain(q, k, v, out, do, lse, **kw)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, out, do, lse, **kw),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, out, do, lse, **kw)),
    }
    # the yardstick, on (B, H, T, D) views; never called by the port
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_err = (sdpa_out.transpose(1, 2).float() - out.float()).abs().max()
    if not lib_err.item() <= 0.05:
        raise AssertionError(f"SDPA yardstick disagrees: {lib_err.item()}")
    dot = do.transpose(1, 2)
    lib_fwd = median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    lib_bwd = median_ms(lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), dot, retain_graph=True))
    work = flash_work(b, t, h, d, q.element_size())
    out_rows = {}
    for name, (kern, plain) in runs.items():
        ms = median_ms(kern)
        plain_ms = median_ms(plain, n=20)
        flops, n_bytes = work[name]
        t_bytes = n_bytes / bw * 1e3
        t_ops = flops / bf16_peak * 1e3
        out_rows[name] = {
            "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_fwd if name == "flash_fwd" else lib_bwd,
            "flops": flops, "bytes": n_bytes,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        log(f"phase 10 times {name} (B={b} T={t} H={h} D={d} bf16 causal): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
            f"{out_rows[name]['library_ms']:.4f} ms, bound "
            f"{out_rows[name]['bound_ms']:.4f} ms ({out_rows[name]['bound_by']}: "
            f"{flops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB); "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
    return out_rows


TRAIN_STEPS = 30
TRAIN_ARGV = [
    "--model", "dense", "--vocab", str(MODEL["vocab_size"]),
    "--d-model", str(MODEL["d_model"]), "--n-heads", str(MODEL["n_heads"]),
    "--n-layers", str(MODEL["n_layers"]), "--d-ff", str(MODEL["d_ff"]),
    "--dtype", "bfloat16", "--attn-impl", "flash",
    "--batch", str(FLASH_TRAIN[0]), "--seq-len", str(FLASH_TRAIN[1]),
    "--corpus-tokens", "1000000", "--seed", str(SEED),
    "--steps", str(TRAIN_STEPS), "--schedule", "warmup_cosine",
    "--warmup-steps", "5", "--grad-clip", "1.0", "--ckpt-every", "10",
    "--log-every", "1",
]


def device_profile(run, tag):
    """``run()`` under ``torch.profiler``: the wall time, the device's busy
    share of it (kernel time summed; one stream, so no overlap) and the
    kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
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
        log(f"{tag}: wall {wall_s:.3f} s, device busy "
            f"{out['device_busy_s']:.3f} s = "
            f"{100 * out['device_busy_share']:.1f}% (under the profiler)")
        for t in out["top"]:
            log(f"  {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['name']}")
    else:
        log(f"{tag}: the profiler recorded no device time (not measured)")
    return out


def phase_train(dev, fa, trainer, ckpt, train_mod):
    """The flagship train run through ``trainer.main``, the normal entry
    point, with the flash launch counts set to 0 just before and read
    just after; then, after that read, steady-state step times and a
    profile of a few more steps from the trained state."""
    import tempfile

    b, t = FLASH_TRAIN[:2]
    layers = MODEL["n_layers"]
    with tempfile.TemporaryDirectory(prefix="ft-train-") as ckpt_dir:
        out: dict = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_flash_counts(fa)
        t0 = time.monotonic()
        trainer.main(TRAIN_ARGV + ["--ckpt-dir", ckpt_dir], out=out)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        launches = flash_counts(fa)
        peak_bytes = torch.cuda.max_memory_allocated()
        res = out["result"]
        losses = [loss for _, loss in res.losses]
        if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"train losses not finite: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train loss did not fall: {losses[0]} -> "
                                 f"{losses[-1]}")
        want = TRAIN_STEPS * layers
        if any(n != want for n in launches.values()):
            raise AssertionError(f"flash launches {launches} != steps x "
                                 f"layers = {want}")
        if res.report.skipped_steps:
            raise AssertionError(f"skipped steps {res.report.skipped_steps}")
        saved = ckpt.restore_train_state(ckpt_dir, dev)
        live = train_mod.tree_leaves(res.state)
        back = train_mod.tree_leaves(saved)
        if len(live) != len(back) or not all(
            a.dtype == b_.dtype and torch.equal(a, b_)
            for a, b_ in zip(live, back)
        ):
            raise AssertionError("the saved checkpoint does not restore "
                                 "bitwise to the live state")
    hist = res.report.metrics["histograms"]["train.step_ms"]
    # steady state: more steps from the trained state, host-timed to
    # the device's end, one at a time
    step = train_mod.make_train_step(out["model_cfg"], out["train_cfg"],
                                     device=dev)
    data = np.random.default_rng(SEED).integers(
        0, MODEL["vocab_size"], (2, b, t)).astype(np.int32)
    state = res.state
    step_s = []
    for i in range(12):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        state, metrics = step(state, data[0], data[1])
        float(metrics["loss"])
        step_s.append(time.monotonic() - t1)
    steady_ms = float(np.median(step_s[2:])) * 1e3

    def three_steps():
        s = state
        for _ in range(3):
            s, m = step(s, data[0], data[1])
        float(m["loss"])

    prof = device_profile(three_steps, "phase 8 profile (3 train steps)")
    summary = {
        "steps": TRAIN_STEPS, "wall_s": wall_s,
        "loss_first": losses[0], "loss_last": losses[-1],
        "launches": launches, "peak_mem_bytes": peak_bytes,
        "registry_step_ms_p50": hist["p50"],
        "registry_step_ms_min": hist["min"],
        "steady_step_ms_median": steady_ms,
        "tokens_per_s": b * t / (steady_ms / 1e3),
        "profile": prof,
    }
    log(f"phase 8 train (flagship, bf16, flash, B={b} T={t}): {TRAIN_STEPS} "
        f"steps in {wall_s:.3f} s via trainer.main; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; flash launches {launches} = {TRAIN_STEPS} steps x "
        f"{layers} layers; checkpoint restores bitwise; steady step "
        f"{steady_ms:.3f} ms (median of 10) = {summary['tokens_per_s']:.0f} "
        f"tokens/s; registry step_ms p50 {hist['p50']}; peak memory "
        f"{peak_bytes / 2**30:.3f} GiB")
    return summary


F32_STEPS = 3
F32_BATCH = 2


def named_leaves(tree, prefix=""):
    """``[(path, tensor)]`` of a dict/list tree, in ``tree_map`` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def f32_run(models, train_mod, cfg, init, batches, dev):
    """Train steps from ``init`` over ``batches``: ``(losses, [(name,
    final param)], [each step's gradients])``."""
    step = train_mod.make_train_step(cfg, train_mod.TrainConfig(),
                                     device=dev)
    state, losses, grads = init, [], []
    for tokens, targets in batches:
        params = train_mod.tree_map(
            lambda p: p.detach().requires_grad_(), state["params"])
        logits = models.forward(params, torch.as_tensor(
            tokens, device=dev).long(), cfg)
        loss_sum, _ = models.cross_entropy_loss(
            logits, torch.as_tensor(targets, device=dev))
        grads.append(torch.autograd.grad(loss_sum / tokens.size,
                                         train_mod.tree_leaves(params)))
        del params, logits, loss_sum
        state, metrics = step(state, tokens, targets)
        losses.append(float(metrics["loss"]))
    return losses, named_leaves(state["params"]), grads


def f32_gaps(run, base):
    """How far ``run`` lands from ``base``: the largest relative loss gap,
    the largest gradient gap over the steps, the largest parameter gap,
    and one line per parameter leaf with elements more than 1e-5 apart,
    giving at those elements the step-1 gradient and its gap."""
    (l_run, p_run, g_run), (l_base, p_base, g_base) = run, base
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_run, l_base))
    grad_abs = max((a - b).abs().max().item()
                   for gs_run, gs_base in zip(g_run, g_base)
                   for a, b in zip(gs_run, gs_base))
    param_abs, misses = 0.0, []
    for i, ((name, a), (_, b)) in enumerate(zip(p_run, p_base)):
        gap = (a - b).abs()
        param_abs = max(param_abs, gap.max().item())
        over = gap > 1e-5
        if over.any():
            g1 = g_base[0][i][over].abs()
            dg1 = (g_run[0][i][over] - g_base[0][i][over]).abs()
            misses.append(
                f"{name}: {int(over.sum())}/{gap.numel()} over, gap "
                f"{gap.max().item():.3g}; step-1 |g| there "
                f"{g1.min().item():.3g}..{g1.max().item():.3g}, its gap "
                f"{dg1.min().item():.3g}..{dg1.max().item():.3g} (largest "
                f"gap/|g| {(dg1 / g1.clamp_min(1e-30)).max().item():.3g})")
    return loss_rel, grad_abs, param_abs, misses


def phase_f32_train(dev, models, train_mod, data_mod):
    """Flash against reference attention, float32 compute at full width,
    from one initial state over the same batches: each step's loss within
    rtol 1e-5 and each step's gradients within atol 1e-5, checked; each
    parameter against the JAX package's atol 1e-5, printed.  A parameter
    can miss that bar while its gradients agree: AdamW's first step moves
    a parameter by ``lr * g / (|g| + eps)``, so where |g| is near eps =
    1e-8 a gradient gap of the size of g moves it by up to ~lr (PERF.md).
    Each miss is printed with its step-1 gradient and gradient gap; and a
    second witness, reference attention on the same batches with their
    rows reversed (the same loss, a different float32 summation order),
    is held against the reference the same way."""
    dataset = data_mod.LMDataset(
        data_mod.synthetic_tokens(200_000, MODEL["vocab_size"], seed=SEED),
        batch=F32_BATCH, seq_len=FLASH_TRAIN[1], seed=SEED)
    batches = [dataset.batch_at(i) for i in range(F32_STEPS)]
    reversed_rows = [(np.ascontiguousarray(t[::-1]),
                      np.ascontiguousarray(g[::-1])) for t, g in batches]
    init = train_mod.init_train_state(
        models.TransformerConfig(**MODEL),
        torch.Generator().manual_seed(SEED), device=dev)

    def cfg(impl):
        return models.TransformerConfig(**MODEL, dtype=torch.float32,
                                        attn_impl=impl)

    ref = f32_run(models, train_mod, cfg("reference"), init, batches, dev)
    flash = f32_run(models, train_mod, cfg("flash"), init, batches, dev)
    witness = f32_run(models, train_mod, cfg("reference"), init,
                      reversed_rows, dev)
    loss_rel, grad_abs, param_abs, misses = f32_gaps(flash, ref)
    w_loss, w_grad, w_param, w_misses = f32_gaps(witness, ref)
    log(f"phase 9 f32 train, flash vs reference ({F32_STEPS} steps, B="
        f"{F32_BATCH} T={FLASH_TRAIN[1]}, full width): losses {flash[0]} vs "
        f"{ref[0]}; max loss rel gap {loss_rel:.3g} (bar 1e-5); max grad "
        f"abs gap {grad_abs:.3g} (bar 1e-5); max param abs gap "
        f"{param_abs:.3g} (JAX bar 1e-5; {len(misses)} leaves miss it)")
    for m in misses:
        log(f"  param over the bar: {m}")
    log(f"phase 9 witness, reference with the batch rows reversed vs "
        f"reference: max loss rel gap {w_loss:.3g}; max grad abs gap "
        f"{w_grad:.3g}; max param abs gap {w_param:.3g} ({len(w_misses)} "
        f"leaves over 1e-5)")
    for m in w_misses:
        log(f"  witness param over 1e-5: {m}")
    if not (loss_rel <= 1e-5 and grad_abs <= 1e-5):
        raise AssertionError(f"f32 flash vs reference: loss rel {loss_rel}, "
                             f"grad abs {grad_abs} (bar 1e-5 each)")
    return {"loss_rel_gap": loss_rel, "grad_abs_gap": grad_abs,
            "param_abs_gap": param_abs, "param_misses": misses,
            "witness_param_abs_gap": w_param, "witness_misses": w_misses}


def phase_profile(eng, reqs):
    """Run ``reqs`` again (fresh ids) under ``torch.profiler``."""
    def run():
        for r in reqs:
            eng.submit(dataclasses.replace(r, rid=r.rid + 10_000,
                                           arrival_s=0.0))
        eng.run_until_idle()

    return device_profile(run, "phase 5 profile")


# ------------------------------------------------ the FlexTree collectives

# the flagship model's parameter count (tied embedding): the gradient the
# train step of phases 8-9 would sync, read from init_params in phase 13
FOLD_LENGTHS = (1_000_048, 100_003)  # 16-byte rows (vector path); ragged
FOLD_WIDTHS = (2, 3, 8)
FOLD_TILES = (1, 4)
COLLECTIVE_SHAPES = (("8", 8), ("4,2", 8), ("2,2,2", 8), ("1", 8),
                     ("3,2+1", 7))
MAIN_CASES = (("sum", "float32"), ("sum", "bfloat16"), ("band", "int32"),
              ("max", "float32"))
OTHER_CASES = (("prod", "float32"), ("min", "float32"), ("sum", "int32"),
               ("bor", "int32"), ("bxor", "int32"), ("min", "uint64"),
               ("prod", "bfloat16"), ("sum", "float16"), ("max", "int8"))
OTHER_COUNT = 1_000_003
DIST_COUNT = 4_194_304
DIST_SPECS = ("4", "2,2", "1", "3+1")


def device_rows(w, length, dtype, gen, dev):
    """A seeded (w, length) input made on the card: normals for floats,
    random bits over the whole width for integers, random bools."""
    if dtype.is_floating_point:
        return torch.randn((w, length), generator=gen, device=dev).to(dtype)
    if dtype == torch.bool:
        return torch.randint(0, 2, (w, length), generator=gen,
                             device=dev).bool()
    bits = torch.iinfo(dtype).bits
    signed = {8: torch.int8, 16: torch.int16, 32: torch.int32,
              64: torch.int64}[bits]
    raw = torch.randint(-2 ** 62, 2 ** 62, (w, length), generator=gen,
                        device=dev, dtype=torch.int64)
    return raw.to(signed).view(dtype) if bits < 64 else raw.view(dtype)


def same_bits(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def phase_fold_parity(dev, rs, registry, harness):
    """Phase 11: the fold kernel against its plain version, bitwise, for
    every op x dtype of the registry, W in FOLD_WIDTHS, a 16-byte-aligned
    and a ragged L, sources_tile 1 and 4, with NaNs in the float max/min
    inputs, and into a misaligned ``out`` view; the copy kernel against
    ``clone``, bitwise, aligned, ragged and misaligned."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    nan = float("nan")
    cases = 0
    for name, rop in registry.SUPPORTED_OPS.items():
        for dt_name in rop.dtypes:
            dtype = harness.torch_dtype(dt_name)
            for w in FOLD_WIDTHS:
                for length in FOLD_LENGTHS:
                    x = device_rows(w, length, dtype, gen, dev)
                    if dtype.is_floating_point and name in ("max", "min"):
                        x[1, ::7] = nan
                        x[w - 1, 3::11] = nan
                    for st in FOLD_TILES:
                        got = rs.reduce_stacked(x, name, st)
                        plain = rs.reduce_stacked_plain(x, name, st)
                        if not same_bits(got, plain):
                            raise AssertionError(
                                f"fold kernel != plain: {name} {dt_name} "
                                f"W={w} L={length} sources_tile={st}")
                        cases += 1
                buf = torch.empty(FOLD_LENGTHS[1] + 1, dtype=dtype, device=dev)
                out = buf[1:]
                rs.reduce_stacked(x, name, out=out)
                if not same_bits(out, rs.reduce_stacked_plain(x, name)):
                    raise AssertionError(f"fold kernel into a misaligned out: "
                                         f"{name} {dt_name} W={w}")
                cases += 1
    torch.cuda.synchronize()
    raw = device_rows(1, 4 * FOLD_LENGTHS[0] + 8, torch.uint8, gen, dev)[0]
    for src in (raw[:4 * FOLD_LENGTHS[0]].view(torch.float32),
                raw[:FOLD_LENGTHS[1]], raw[1:FOLD_LENGTHS[1] + 1]):
        if not same_bits(harness.hbm_copy(src), harness.hbm_copy_plain(src)):
            raise AssertionError(f"copy kernel != clone at {src.numel()} "
                                 f"elements, offset {src.storage_offset()}")
    log(f"phase 11 fold parity: kernel == plain bitwise in all {cases} cases "
        f"({len(registry.SUPPORTED_OPS)} ops over the registry's dtypes, "
        f"W {FOLD_WIDTHS}, L {FOLD_LENGTHS}, sources_tile {FOLD_TILES}, NaN "
        f"rows for float max/min, a misaligned out); copy kernel == clone "
        f"bitwise (aligned, ragged, misaligned)")
    return {"cases": cases, "max_abs_err": 0.0}


def fold_shapes(spec, n, count, stages):
    """The fold kernel's launches in one allreduce call, by ``(W, L)``,
    derived from the topology alone: a tree stage of width w is one fold of
    w tiles on every tree rank, a ring step one 2-source fold on every
    rank, a buddy fold one 2-source fold of the whole head, and a tail one
    fold of all ranks' tails on every rank."""
    topo = stages.Topology.resolve(n, spec)
    lonely = isinstance(topo, stages.LonelyTopology)
    tree = topo.tree if lonely else topo
    owners = tree.num_nodes
    head = count // owners * owners
    shapes: dict = {}

    def add(key, k):
        shapes[key] = shapes.get(key, 0) + k

    if head and lonely:
        add((2, head), topo.lonely)
    if head and topo.is_ring:
        add((2, head // n), n * (n - 1))
    elif head:
        length = head
        for w in tree.widths:
            length //= w
            add((w, length), owners)
    if head < count:
        add((n, count - head), n)
    return shapes


def group_fold_oracle(x, spec, rop, stages):
    """Phase 13's oracle, in plain PyTorch on the card: per tree stage each
    group folds its members' rows in group order and every member gets the
    result; a lonely shape folds rank m+i into buddy i first; the ring
    walks the reference's 2(N-1) steps on the divisible head; the tail
    folds over all ranks in rank order."""
    n, count = x.shape
    topo = stages.Topology.resolve(n, spec)
    lonely = isinstance(topo, stages.LonelyTopology)
    tree = topo.tree if lonely else topo
    owners = tree.num_nodes
    head = count // owners * owners
    out = torch.empty_like(x)
    if head and topo.is_ring:
        v = [x[r, :head].clone().view(n, -1) for r in range(n)]
        for step in range(n - 1):
            sent = [v[r][(r - step) % n].clone() for r in range(n)]
            for r in range(n):
                b = (r - step - 1) % n
                v[r][b] = rop.fold(v[r][b], sent[(r - 1) % n])
        for step in range(n - 1):
            sent = [v[r][(r + 1 - step) % n].clone() for r in range(n)]
            for r in range(n):
                v[r][(r - step) % n] = sent[(r - 1) % n]
        for r in range(n):
            out[r, :head] = v[r].view(-1)
    elif head:
        rows = [x[r, :head] for r in range(n)]
        for i in range(topo.lonely if lonely else 0):
            rows[i] = rop.fold(rows[i], rows[owners + i])
        for i in range(tree.num_stages):
            for grp in tree.groups(i):
                acc = rows[grp[0]]
                for r in grp[1:]:
                    acc = rop.fold(acc, rows[r])
                for r in grp:
                    rows[r] = acc
        for r in range(n):
            out[r, :head] = rows[r if r < owners else r - owners]
    if head < count:
        acc = x[0, head:]
        for r in range(1, n):
            acc = rop.fold(acc, x[r, head:])
        out[:, head:] = acc
    return out


def phase_fold_times(dev, harness, param_count):
    """Phase 12: ``bench.harness.run_reduce_bench`` (the ``--bench reduce``
    path) at the heaviest fold of each phase-13 shape, f32 sum, and f32 max
    at a ring step, with the copy kernel's launch count set to 0 just
    before and read just after."""
    c = param_count
    shapes = ((8, c // 8), (4, c // 4), (2, c // 2), (2, c // 8))
    harness.hbm_copy.launches = 0
    doc = harness.run_reduce_bench(harness.ReduceBenchConfig(
        shapes=shapes, dtype="float32", op="sum", device=str(dev)))
    doc_max = harness.run_reduce_bench(harness.ReduceBenchConfig(
        shapes=((2, c // 8),), dtype="float32", op="max", device=str(dev)))
    copy_launches = harness.hbm_copy.launches
    if copy_launches == 0:
        raise AssertionError("the reduce bench launched no copy kernel")
    rows = doc["rows"] + doc_max["rows"]
    for r in rows:
        log(f"phase 12 fold {r['op']} W={r['W']} L={r['L']} f32 "
            f"({r['bytes'] / 1e6:.1f} MB): kernel {r['ms']:.4f} ms = "
            f"{r['GBps']:.0f} GB/s, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms = {r['library_GBps']:.0f} GB/s, bound "
            f"{r['bound_ms']:.4f} ms (bytes); copy kernel {r['copy_ms']:.4f} "
            f"ms = {r['copy_GBps']:.0f} GB/s, clone {r['copy_plain_ms']:.4f} "
            f"ms, copy_ {r['copy_library_ms']:.4f} ms (cold L2)")
    return rows, copy_launches


def check_result(out, x, spec, name, rop, stages, sim):
    """Every row identical, bitwise the group-fold oracle, and integers
    bitwise the simulator (on the host); returns a short note."""
    n = x.shape[0]
    for r in range(1, n):
        if not same_bits(out[r], out[0]):
            raise AssertionError(f"{spec} {name}: rank {r} != rank 0")
    if not same_bits(out, group_fold_oracle(x, spec, rop, stages)):
        raise AssertionError(f"{spec} {name}: not the group-fold oracle")
    if x.dtype.is_floating_point:
        return "rows identical, == oracle"
    want = sim.simulate_allreduce(x.cpu().numpy(), spec, rop.name)
    if not same_bits(out[0].cpu(), torch.from_numpy(want[0])):
        raise AssertionError(f"{spec} {name}: not the simulator")
    return "rows identical, == oracle, == simulator"


def fold_share(run):
    """``run()`` under ``torch.profiler``: the fold kernel's device time
    and the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    fold_us = busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        busy_us += us
        if "fold_kernel" in e.key:
            fold_us += us
    return fold_us / 1e6, busy_us / 1e6, wall


def phase_allreduce(dev, harness, stages, registry, sim, allreduce_over_mesh,
                    flat_mesh, rs, param_count):
    """Phase 13: the FlexTree allreduce through
    ``bench.harness.run_allreduce_bench`` on an in-process mesh on the
    card, every shape and main case at the flagship's parameter count,
    with the fold kernel's count set to 0 before and read after each run;
    then each case on seeded random data held to the contracts."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    launches = 0
    shape_launches: dict = {}
    per_shape = {}
    for spec, n in COLLECTIVE_SHAPES:
        mesh = flat_mesh(n, dev)
        per_call = fold_shapes(spec, n, param_count, stages)
        for name, dt in MAIN_CASES:
            cfg = harness.BenchConfig(size=param_count, repeat=10, topo=spec,
                                      devices=n, dtype=dt, op=name,
                                      device=str(dev))
            rs.reduce_stacked.launches = 0
            report = harness.run_allreduce_bench(cfg)
            got = rs.reduce_stacked.launches
            want = sum(per_call.values()) * report.calls
            if not report.correct:
                raise AssertionError(f"bench {spec} {name} {dt}: incorrect")
            if got != want:
                raise AssertionError(f"bench {spec} {name} {dt}: fold launches "
                                     f"{got} != {want} from the topology")
            launches += got
            for key, k in per_call.items():
                shape_launches[key] = shape_launches.get(key, 0) + k * report.calls
            if (name, dt) == ("sum", "float32"):
                per_shape[spec] = report
            dtype = harness.torch_dtype(dt)
            x = device_rows(n, param_count, dtype, gen, dev)
            out = allreduce_over_mesh(x, mesh, spec, name)
            note = check_result(out, x, spec, f"{name} {dt}",
                                registry.get_op(name), stages, sim)
            log(f"phase 13 {spec} on {n} ranks, {name} {dt}, {param_count} "
                f"per rank: bench median {report.result.median_s * 1e3:.3f} "
                f"ms, correct; fold launches {got} = {sum(per_call.values())} "
                f"a call x {report.calls} calls; random data: {note}")
            del x, out
        for name, dt in OTHER_CASES:
            x = device_rows(n, OTHER_COUNT, harness.torch_dtype(dt), gen, dev)
            check_result(allreduce_over_mesh(x, mesh, spec, name), x, spec,
                         f"{name} {dt}", registry.get_op(name), stages, sim)
        log(f"phase 13 {spec}: {len(OTHER_CASES)} more op/dtype cases at "
            f"{OTHER_COUNT} per rank held to the same contracts")
        torch.cuda.empty_cache()
    # the tail path at full size (the parameter count + 5)
    for name, dt in (("sum", "float32"), ("band", "int32")):
        x = device_rows(8, param_count + 5, harness.torch_dtype(dt), gen, dev)
        out = allreduce_over_mesh(x, flat_mesh(8, dev), "4,2", name)
        note = check_result(out, x, "4,2", f"{name} {dt}",
                            registry.get_op(name), stages, sim)
        log(f"phase 13 tail: 4,2 {name} {dt} at {param_count + 5} per rank: "
            f"{note}")
        del x, out
    # per shape: time, fold share and bus bandwidth of the f32 sum
    summary = {}
    for spec, n in COLLECTIVE_SHAPES:
        report = per_shape[spec]
        mesh = flat_mesh(n, dev)
        x = device_rows(n, param_count, torch.float32, gen, dev)
        fold_s, busy_s, wall_s = fold_share(
            lambda: [allreduce_over_mesh(x, mesh, spec, "sum")
                     for _ in range(3)])
        summary[spec] = {
            "ranks": n, "median_ms": report.result.median_s * 1e3,
            "min_ms": report.result.min_s * 1e3,
            "bus_GBps": report.bus_bw_GBps,
            "fold_share_of_busy": fold_s / busy_s if busy_s else None,
            "device_busy_share": busy_s / wall_s,
        }
        log(f"phase 13 times {spec} on {n} ranks, f32 sum, {param_count} per "
            f"rank (in-process mesh, HBM copies, not a network): median "
            f"{summary[spec]['median_ms']:.3f} ms, min "
            f"{summary[spec]['min_ms']:.3f} ms, bus "
            f"{report.bus_bw_GBps:.1f} GB/s; fold kernel "
            f"{fold_s * 1e3 / 3:.3f} ms a call = "
            f"{100 * (summary[spec]['fold_share_of_busy'] or 0):.1f}% of the "
            f"device's busy time, busy {100 * busy_s / wall_s:.1f}% of the "
            f"wall (under the profiler)")
        del x
    top = max(shape_launches, key=shape_launches.get)
    log(f"phase 13 fold launches {launches} over the bench runs; most "
        f"launched shape W={top[0]} L={top[1]} ({shape_launches[top]})")
    return launches, top, summary


def phase_dist(dev, harness, launch, allreduce_mod, flat_mesh):
    """Phase 14: four processes on the one card over gloo (host staging),
    each checking bitwise agreement with the in-process mesh; NCCL at
    world size 1."""
    cases = [(spec, DIST_COUNT, name, dt, SEED + k, 1)
             for k, spec in enumerate(DIST_SPECS)
             for name, dt in (("sum", "float32"), ("bxor", "int32"))]
    t0 = time.monotonic()
    got = launch.spawn(harness.dist_allreduce_cases, 4, (cases, str(dev)),
                       backend="gloo", timeout=600)
    spawn_s = time.monotonic() - t0
    mesh = flat_mesh(4, dev)
    for k, (spec, count, name, dt, seed, _) in enumerate(cases):
        x = harness.seeded_rows(4, count, harness.torch_dtype(dt), seed).to(dev)
        full = allreduce_mod.allreduce(list(x), mesh, spec, name)
        shards = allreduce_mod.reduce_scatter(list(x), mesh, spec, name)
        for r in range(4):
            full_d, shard_d, back_d, launches = got[r][k]
            if not (full_d == back_d == harness.digest(full[r])
                    and shard_d == harness.digest(shards[r])):
                raise AssertionError(f"dist rank {r} {spec} {name} {dt}: "
                                     f"differs from the in-process mesh")
            if launches <= 0:
                raise AssertionError(f"dist rank {r} {spec}: no fold launch")
    log(f"phase 14 dist: 4 processes on {dev}, gloo with host staging, "
        f"{len(cases)} cases ({', '.join(DIST_SPECS)} x f32 sum, int32 bxor "
        f"at {DIST_COUNT} per rank): every rank's allreduce, shard and "
        f"gathered shard bitwise the in-process mesh's, fold launches > 0 on "
        f"every rank; {spawn_s:.1f} s with spawn")
    from flextree_tpu_torch.parallel.launch import ClusterConfig

    launch.init_distributed(
        ClusterConfig(f"127.0.0.1:{launch.free_port()}", 1, 0),
        backend="nccl", device=dev, timeout=120, retries=0, merge_env=False)
    try:
        x = harness.seeded_row(0, DIST_COUNT, torch.float32, SEED).to(dev)
        y = allreduce_mod.allreduce(x, None, "1", "sum")
        back = allreduce_mod.all_gather(
            allreduce_mod.reduce_scatter(x, None, None, "sum"), None, None,
            out_shape=(DIST_COUNT,))
        if not (same_bits(y, x) and same_bits(back, x)):
            raise AssertionError("NCCL world of one changed its input")
    finally:
        launch.shutdown_distributed()
    log("phase 14 NCCL at world size 1: allreduce and all_gather of "
        "reduce_scatter return the input bitwise")


def collective_phases(dev) -> list:
    """Phases 11-14 (the FlexTree collectives); returns their rows of the
    kernels line (``reduce_stacked``, ``copy``)."""
    from flextree_tpu_torch.backends import simulator as sim
    from flextree_tpu_torch.bench import harness
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from flextree_tpu_torch.ops import reduce as registry
    from flextree_tpu_torch.ops import reduce_stacked as rs
    from flextree_tpu_torch.parallel import allreduce as allreduce_mod
    from flextree_tpu_torch.parallel import launch
    from flextree_tpu_torch.parallel.mesh import (
        allreduce_over_mesh,
        flat_mesh,
    )
    from flextree_tpu_torch.parallel.train import tree_leaves
    from flextree_tpu_torch.schedule import stages

    params = init_params(TransformerConfig(**MODEL),
                         torch.Generator().manual_seed(SEED), device=dev)
    param_count = sum(p.numel() for p in tree_leaves(params))
    del params
    log(f"flagship parameter count (the gradient a train step syncs): "
        f"{param_count}")
    out = {}
    for phase, run in (
        (11, lambda: phase_fold_parity(dev, rs, registry, harness)),
        (12, lambda: phase_fold_times(dev, harness, param_count)),
        (13, lambda: phase_allreduce(dev, harness, stages, registry, sim,
                                     allreduce_over_mesh, flat_mesh, rs,
                                     param_count)),
        (14, lambda: phase_dist(dev, harness, launch, allreduce_mod,
                                flat_mesh)),
    ):
        t0 = time.monotonic()
        out[phase] = run()
        log(f"phase {phase}: {time.monotonic() - t0:.1f} s")
        torch.cuda.empty_cache()
    parity, (times, copy_launches), (launches, top, _) = \
        out[11], out[12], out[13]
    row = next(r for r in times if (r["W"], r["L"]) == top and r["op"] == "sum")
    return [{
        "name": "reduce_stacked",
        "route": "cuda",
        "source": "flextree_tpu_torch/csrc/reduce_stacked.cu",
        "replaces": "flextree_tpu/ops/pallas_reduce.py:33",
        "launches": launches,
        "max_abs_err": parity["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": row["library_ms"],
    }, {
        "name": "copy",
        "route": "cuda",
        "source": "flextree_tpu_torch/csrc/copy.cu",
        "replaces": "tools/roofline_reduce.py:101",
        "launches": copy_launches,
        "max_abs_err": 0.0,
        "ms": row["copy_ms"],
        "plain_ms": row["copy_plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": row["copy_library_ms"],
    }]


def model_phases(dev, bw, fp32_peak, bf16_peak) -> list:
    """Phases 2-10 (serving and training); returns their rows of the
    kernels line."""
    from flextree_tpu_torch import data as data_mod
    from flextree_tpu_torch import models, serving, trainer
    from flextree_tpu_torch.models.generate import generate
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from flextree_tpu_torch.ops import flash_attention as fa
    from flextree_tpu_torch.ops import paged_attention as pa
    from flextree_tpu_torch.parallel import train as train_mod
    from flextree_tpu_torch.utils import checkpoint as ckpt

    clock = [time.monotonic()]

    def lap(phase):
        now = time.monotonic()
        log(f"phase {phase}: {now - clock[0]:.1f} s")
        clock[0] = now

    # ---- phase 2: kernel parity at the flagship decode shape
    phase_parity(dev, pa.FUSED_DECODE_ATOL, pa)

    lap(2)

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

    lap(3)

    # ---- phase 4: times, on phase 3's inputs
    times = phase_times(dev, pa, eng.pools, rounds, bw, fp32_peak)
    log(f"phase 4 times (lengths {times['lengths']}): kernel "
        f"{times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, SDPA "
        f"{times['library_ms']:.4f} ms, bound {times['bound_ms']:.4f} ms "
        f"({times['bound_by']})")

    lap(4)

    # ---- phase 5: where a serving run's time goes
    phase_profile(eng, reqs[:8])
    del eng

    lap(5)

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
    del params

    lap(6)

    # ---- phase 7: each flash kernel against its plain version
    worst = phase_flash_parity(dev, fa)

    lap(7)

    # ---- phase 8: the flagship train run through trainer.main
    train = phase_train(dev, fa, trainer, ckpt, train_mod)

    lap(8)

    # ---- phase 9: float32 flash vs reference train steps
    phase_f32_train(dev, models, train_mod, data_mod)

    lap(9)

    # ---- phase 10: flash kernel times at the training shape
    ftimes = phase_flash_times(dev, fa, bw, bf16_peak)
    lap(10)

    return [{
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
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"flextree_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": train["launches"][name],
        "max_abs_err": worst[name],
        "ms": ftimes[name]["ms"],
        "plain_ms": ftimes[name]["plain_ms"],
        "bound_ms": ftimes[name]["bound_ms"],
        "bound_by": ftimes[name]["bound_by"],
        "library_ms": ftimes[name]["library_ms"],
    } for name, replaces in FLASH_REPLACES]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from flextree_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- phase 1: device and build
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    bw, fp32_peak, bf16_peak = card_peaks(kind)
    log(f"phase 1 device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")
    t0 = time.monotonic()
    kernels.build()
    build_s = time.monotonic() - t0
    for name, info in kernels.build_log.items():
        regs = [ln.strip() for ln in info["ptxas"].splitlines()
                if "registers" in ln]
        log(f"phase 1 build {name}: {info['seconds']:.2f} s; "
            f"{' | '.join(regs[:4])}{' | ...' if len(regs) > 4 else ''}")
    log(f"phase 1 build total: {build_s:.2f} s")

    t0 = time.monotonic()
    rows = model_phases(dev, bw, fp32_peak, bf16_peak)
    log(f"phases 2-10: {time.monotonic() - t0:.1f} s")
    rows += collective_phases(dev)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
