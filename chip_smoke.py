#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --train-ab PARENT   # phase 8, PARENT's checkout and this in turns
    python3 chip_smoke.py --allreduce-ab PARENT   # phase 13's f32 sums, the same way

Drives ``flextree_tpu_torch`` (never JAX) on the card, in phases; any
failure raises and exits non-zero:

1. device and build — the card's name and power limit (``nvidia-smi``),
   and every CUDA kernel built from ``flextree_tpu_torch/csrc``; the bf16
   flash forward, dq and dk/dv have ``HMMA`` (``mma.sync``) in their SASS
   and no register spills at head dim 64 (128's are reported);
2. kernel parity — the paged-decode kernel against its plain versions
   (the plain stream, the plain split-K and the gather oracle) at the
   flagship decode shape (S=8 slots, H=8, D=64, bs=16, P=64, N=257) on
   two rows of boundary lengths (a block's and a split's edges), four
   draws each: within ``FUSED_DECODE_ATOL`` in float32; in bfloat16 each
   element within ``PAGED_BF16_PEAK`` of max(|ref|, rms(ref)) and the rms
   error within ``PAGED_BF16_RMS`` of rms(ref); bitwise unchanged when the
   null block is poisoned, the inactive slot exactly v_new, two calls
   bitwise equal;
3. serving — ``ServingEngine`` at the flagship width (vocab 8192,
   d_model 512, 8 heads, 4 layers, d_ff 2048, bf16) with the kernel:
   16 requests, prompts uniform over 16..256, 64 new tokens each.  Every
   request completes, and the kernel's launch count over the run equals
   decode rounds x layers;
4. times — the kernel, its plain stream and
   ``F.scaled_dot_product_attention`` on the pre-gathered view (a
   yardstick only; the port never calls it) on the inputs of the heaviest
   decode round of phase 3, each launch with a cold L2 and a ~0.5 ms head
   start (:func:`time_launches`), beside the least time the card could
   take (bytes over the memory rate);
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
   exactly 0; every ``variant`` runs the one forward kernel; the bf16
   flash kernels (tensor-core kernels) and the paged kernel refuse an
   input view that is not 16-byte aligned;
8. training — ``trainer.main`` at the flagship width (bf16 compute,
   flash attention, batch 8 x 1024 tokens, 30 steps, warmup-cosine,
   clipping, a checkpoint every 10 steps): the loss is finite and falls,
   each flash kernel launches steps x layers times, the saved checkpoint
   restores bitwise; then steady step time, tokens/s, peak memory and a
   ``torch.profiler`` breakdown of three more steps (the device time a
   step).  ``--train-ab PARENT`` runs only this phase, for the checkout at
   PARENT and this one in turns, each in a process of its own;
9. float32 end to end — three train steps at full width (batch 2 x 1024)
   with flash and with reference attention from one state: losses within
   rtol 1e-5 and gradients within atol 1e-5; the parameters against atol
   1e-5 printed, each miss beside its step-1 gradient and gradient gap,
   and beside a witness (reference attention on the batch rows reversed);
10. flash times — each flash kernel, its plain version and the SDPA
    yardstick (forward; backward through ``torch.autograd.grad``) at the
    training shape, each launch with a cold L2 and a ~0.5 ms head start
    (CUDA-event medians, :func:`time_launches`), beside the least time
    the card could take, with TFLOP/s and the ratio to SDPA;
11. fold and copy parity — the fold kernel against its plain versions,
    bitwise, for every op x dtype of the registry, W in {2, 3, 8}, a
    16-byte-aligned and a ragged L, ``sources_tile`` 1 and 4, NaN rows in
    float max/min: ``reduce_stacked`` (and into a misaligned ``out``), and
    ``reduce_sources`` on batches of 1 and 8 folds, in place and with a
    misaligned source (the kernel's element body; aligned folds run its
    bulk-copy body), against its plain version and ``reduce_stacked`` on
    the same sources stacked; the
    aliasing it refuses; the copy kernel against ``clone``, bitwise;
12. fold times — ``bench.harness.run_reduce_bench`` (the ``--bench
    reduce`` path, the stacked entry) at the heaviest fold of each
    phase-13 shape: kernel, plain, ``torch.sum``/``amax`` and the copy
    kernel (with ``clone`` and ``copy_``) at the same bytes; then
    ``reduce_sources`` at each shape's heaviest stage, every rank's fold in
    one launch, beside the same folds as stacked launches, the copy kernel at the same bytes and, at W=2,
    ``torch._foreach_add``; each launch with a cold L2 and started only
    once enqueued, beside the byte bound;
13. the FlexTree allreduce — ``bench.harness.run_allreduce_bench`` on an
    in-process mesh of 8 ranks (7 for ``"3,2+1"``) on the card at the
    flagship's parameter count (16,781,824 per rank), shapes ``(8,)``,
    ``(4,2)``, ``(2,2,2)``, the ring and ``"3,2+1"``; f32 and bf16 sum,
    int32 band and f32 max: correct, and the fold kernel's launch count
    equal to the count derived from the topology (one launch a fold
    stage, no stacked fold); each case again on
    seeded random data, every rank identical and bitwise the group-fold
    oracle (integers also the simulator), nine more op/dtype cases at
    1,000,003, the tail path at the count + 5; per shape the median ms,
    bus GB/s, the fold kernel's share and the launches a call by kind
    under ``torch.profiler`` (the copies must be the gather phase's
    alone).  ``--allreduce-ab PARENT`` runs only the f32 sums, for the
    checkout at PARENT and this one in turns, each in its own process;
14. distributed — four processes on the card over gloo (host staging),
    every rank bitwise the in-process mesh; NCCL at world size 1 returns
    its input bitwise;
15. IR families and the planner — ``swing``, ``gen:4,2@2``, ``gen:8@7``
    and ``gen:2,2,2@1`` on 8 in-process ranks and ``swing`` on 7 (fold and
    restore hops, a tail) at the flagship's parameter count: every rank's
    row identical and bitwise the same executor on a CPU mesh, int32 and
    integer-valued f32 sums exact, the fold kernel's launches equal to
    ``call_shape``'s count, each timed in place by
    ``run_allreduce_bench`` beside phase 13's shapes; a corrupted program
    refused with ``IRViolationError`` before any fold or copy.  Then the
    cost model's constants fitted on the card over
    ``tools.calibrate_host``'s matrix (the card's work, and for the record
    the wall time), saved, loaded back, refused under another
    fingerprint, with the Spearman rho of predicted against measured at
    least 0.8; the planner's winner over every shape and IR family run
    correct, its time beside the fastest measured (printed, not gated).

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


# paged decode, bfloat16: kernel and plain versions round at the same
# points (each score to bf16, the output once) and differ in float32
# summation order, which flips a rare output rounding by one bf16 ulp (at
# most 2**-7 of the element).  Over PAGED_DRAWS draws of a row, each
# element within PAGED_BF16_PEAK of max(|ref|, rms(ref)), and the rms of
# the difference within PAGED_BF16_RMS of rms(ref): a flip at the largest
# element moves the rms by ~3e-4 of rms(ref) at one draw (4096 outputs),
# ~1.4e-4 over four; rounding the score or the partials elsewhere moves it
# by ~1.1-1.4e-3 (chip_flash_mutants.py, PERF.md)
PAGED_BF16_PEAK = 2 ** -6
PAGED_BF16_RMS = 5e-4
PAGED_DRAWS = 4


def paged_rows():
    """Phase 2's rows of lengths at the flagship decode shape: length 0,
    either side of a block's and of a split's edge, a full table row."""
    bs, P = CACHE["block_size"], CACHE["blocks_per_seq"]
    span = bs * 4  # KERNEL_BLOCKS_PER_SPLIT blocks
    return ([0, 1, bs - 1, bs, bs + 1, P * bs - 1, 300, 700],
            [0, span - 1, span, span + 1, 2 * span - 1, 2 * span,
             2 * span + 1, 1000])


def paged_compare(pa, dtype, lengths, dev, gen):
    """The paged kernel against the plain stream, the plain split-K and
    the gather oracle on one row of lengths, over :data:`PAGED_DRAWS`
    draws of the inputs: ``(errors, failures)``.  Errors map each
    reference to ``{"abs": max |got - ref|}`` over the draws (bfloat16 adds
    ``peak`` and ``rms``, :func:`bf16_errors` of all draws' outputs
    together); failures list each bar broken, and an inactive slot that is
    not v_new exactly, a poisoned null block that moves the output, or two
    calls that differ in a bit."""
    outs, refs, failures = [], {"stream": [], "split": [], "gather": []}, []
    for _ in range(PAGED_DRAWS):
        args = boundary_inputs(dtype, gen, dev, lengths)
        q, kn, vn, kp, vp, tables, lens = args
        got = pa.paged_attention(*args)
        again = pa.paged_attention(*args)
        refs["stream"].append(pa.paged_attention(*args, impl="torch"))
        refs["split"].append(pa.paged_attention_split_plain(
            *args, scale=q.shape[-1] ** -0.5))
        refs["gather"].append(pa.paged_attention_gather(*args))
        pk, pv = kp.clone(), vp.clone()
        pk[0] = 1e30
        pv[0] = 1e30
        poisoned = pa.paged_attention(q, kn, vn, pk, pv, tables, lens)
        torch.cuda.synchronize()
        if not torch.equal(got[0], vn[0]):
            failures.append("inactive slot != v_new")
        if not torch.equal(poisoned, got):
            failures.append("poisoned null block moved the output")
        if not torch.equal(again, got):
            failures.append("two calls differ")
        outs.append(got)
    got = torch.cat(outs)
    errs = {}
    for name, parts in refs.items():
        ref = torch.cat(parts)
        e = {"abs": (got.float() - ref.float()).abs().max().item()}
        if dtype == torch.float32:
            ok = e["abs"] <= pa.FUSED_DECODE_ATOL
        else:
            e["peak"], e["rms"] = bf16_errors(got, ref)
            ok = e["peak"] <= PAGED_BF16_PEAK and e["rms"] <= PAGED_BF16_RMS
        if not ok:  # also NaN
            failures.append(f"vs {name} {e}")
        errs[name] = e
    return errs, sorted(set(failures))


def phase_parity(dev, pa):
    gen = torch.Generator().manual_seed(SEED)
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for lengths in paged_rows():
            errs, failures = paged_compare(pa, dtype, lengths, dev, gen)
            if failures:
                raise AssertionError(f"paged parity {name} {lengths}: "
                                     + "; ".join(failures))
            for ref, e in errs.items():
                worst = out.setdefault(name, {}).setdefault(ref, {})
                for key, x in e.items():
                    worst[key] = max(worst.get(key, 0.0), x)
            log(f"phase 2 parity {name} lengths {lengths} ({PAGED_DRAWS} "
                f"draws): kernel vs " + describe_errors(errs)
                + "; poisoned null block bitwise equal; inactive slot == "
                "v_new; two calls bitwise equal")
    bar = (f"f32 abs {pa.FUSED_DECODE_ATOL}; bf16 peak {PAGED_BF16_PEAK:.3g}, "
           f"rms {PAGED_BF16_RMS:.3g}")
    log(f"phase 2 parity worst ({bar}): " + "; ".join(
        f"{name} " + describe_errors(w) for name, w in out.items()))
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


# GPU cycles (~0.5 ms) the card spins before each timed launch, as
# bench/harness.py's reduce bench does: the launch is enqueued while the
# card is busy, so its events time the kernel and not the wrapper's Python
HEAD_START_CYCLES = 1_000_000


def time_launches(fn, n, flush, warmup=3):
    """Median ms of ``fn()`` over ``n`` launches timed with CUDA events,
    after ``warmup`` untimed ones; each timed launch follows an L2 flush
    (a cold L2) and a ~0.5 ms spin of the card (the head start)."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for i in range(n):
        flush.zero_()
        torch.cuda._sleep(HEAD_START_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


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
    peak, rms = bf16_errors(got, plain)
    if not (peak <= PAGED_BF16_PEAK and rms <= PAGED_BF16_RMS):
        raise AssertionError(f"main-path inputs: kernel vs plain peak {peak}"
                             f", rms {rms} (bar {PAGED_BF16_PEAK}, "
                             f"{PAGED_BF16_RMS})")
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


def phase_flash_parity(dev, fa, pa):
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
    check_misaligned(fa, pa, dev)
    return worst


def check_misaligned(fa, pa, dev):
    """The bfloat16 flash kernels and the paged kernel read their inputs
    16 bytes at a time (``cp.async`` and vector loads): a contiguous view
    that starts 2 bytes past a 16-byte boundary must be refused by the
    wrapper, not launched."""
    b, t, h, d = 1, 64, 2, 64
    n = b * t * h * d
    buf = torch.zeros(n + 8, dtype=torch.bfloat16, device=dev)
    ok = buf[:n].view(b, t, h, d)
    bad = buf[1:n + 1].view(b, t, h, d)
    lse = torch.zeros((b, h, t), device=dev)
    kw = dict(causal=True, scale=d ** -0.5)
    # the paged kernel at (S, H, D) = (1, 2, 64), four 16-row blocks
    pool, bad_pool = ok.view(4, 16, h, d), bad.view(4, 16, h, d)
    row = buf[:h * d].view(1, h, d)
    tables = torch.arange(1, 3, dtype=torch.int32, device=dev)[None]
    lens = torch.full((1,), 20, dtype=torch.int32, device=dev)
    saved = flash_counts(fa), pa.paged_attention.launches
    for name, call in (
            ("flash_fwd", lambda: fa.flash_fwd(ok, bad, ok, **kw)),
            ("flash_bwd_dq",
             lambda: fa.flash_bwd_dq(ok, ok, ok, bad, ok, lse, **kw)),
            ("flash_bwd_dkv",
             lambda: fa.flash_bwd_dkv(ok, ok, ok, ok, bad, lse, **kw)),
            ("paged_attention",
             lambda: pa.paged_attention(row, row, row, pool, bad_pool,
                                        tables, lens))):
        try:
            call()
        except ValueError as err:
            log(f"phase 7 misaligned {name}: refused ({err})")
        else:
            raise AssertionError(f"{name} launched on a misaligned input")
    if (flash_counts(fa), pa.paged_attention.launches) != saved:
        raise AssertionError("a refused call counted a launch")


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
    training shape in bf16, causal: medians of :func:`time_launches`
    (each launch with a cold L2 and the head start), beside the bound from
    the data sheet.  SDPA's backward computes dq, dk and dv in one call;
    both backward rows carry that one time, and its rate counts the work
    of both backward kernels."""
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
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    lib_fwd = time_launches(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 50, flush)
    lib_bwd = time_launches(lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), dot, retain_graph=True), 50, flush)
    work = flash_work(b, t, h, d, q.element_size())
    bwd_flops = work["flash_bwd_dq"][0] + work["flash_bwd_dkv"][0]
    log(f"phase 10 times SDPA (B={b} T={t} H={h} D={d} bf16 causal): "
        f"forward {lib_fwd:.4f} ms = "
        f"{work['flash_fwd'][0] / lib_fwd / 1e9:.1f} TFLOP/s, backward "
        f"(dq, dk, dv) {lib_bwd:.4f} ms = {bwd_flops / lib_bwd / 1e9:.1f} "
        f"TFLOP/s")
    out_rows = {}
    for name, (kern, plain) in runs.items():
        ms = time_launches(kern, 50, flush)
        plain_ms = time_launches(plain, 20, flush)
        flops, n_bytes = work[name]
        t_bytes = n_bytes / bw * 1e3
        t_ops = flops / bf16_peak * 1e3
        lib = lib_fwd if name == "flash_fwd" else lib_bwd
        out_rows[name] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib,
            "flops": flops, "bytes": n_bytes,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        log(f"phase 10 times {name} (B={b} T={t} H={h} D={d} bf16 causal): "
            f"kernel {ms:.4f} ms = {flops / ms / 1e9:.1f} TFLOP/s, "
            f"{ms / lib:.2f}x SDPA's {lib:.4f} ms; plain {plain_ms:.4f} ms; "
            f"bound {out_rows[name]['bound_ms']:.4f} ms "
            f"({out_rows[name]['bound_by']}: {flops / 1e9:.2f} GFLOP, "
            f"{n_bytes / 1e6:.1f} MB)")
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
        f"{peak_bytes / 2**30:.3f} GiB; device "
        + (f"{prof['device_busy_s'] * 1e3 / 3:.3f} ms a step (the profile)"
           if prof["device_busy_s"] is not None else "time not measured"))
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
FOLD_LENGTHS = (1_000_048, 100_003)  # 16-byte rows (bulk copies); ragged
FOLD_WIDTHS = (2, 3, 8)
FOLD_TILES = (1, 4)
# reduce_sources in phase 11: folds a batch, in place
FOLD_BATCH = 8
FOLD_BATCH_CASES = ((1, False), (FOLD_BATCH, False), (FOLD_BATCH, True))
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


def check_batch(rs, x, name, st, batch, in_place):
    """``reduce_sources`` over the first ``batch`` folds of ``x`` (R, W, L),
    sources in reversed row order, into new outputs or in place (each
    fold's output its source 0): bitwise ``reduce_sources_plain`` and
    ``reduce_stacked`` of the same sources stacked; returns the cases."""
    w = x.shape[1]
    order = list(reversed(range(w)))
    src = x[:batch].clone() if in_place else x
    folds = [([src[f, j] for j in order],
              src[f, order[0]] if in_place else torch.empty_like(x[f, 0]))
             for f in range(batch)]
    want = rs.reduce_sources_plain(
        [([x[f, j] for j in order], None) for f in range(batch)], name, st)
    got = rs.reduce_sources(folds, name, st)
    for f in range(batch):
        # the sources stacked, gathered as bytes (PyTorch has no CUDA
        # indexing kernel for uint16/32/64)
        stacked = x[f].view(torch.uint8)[order].view(x.dtype)
        if not (same_bits(got[f], want[f]) and same_bits(
                got[f], rs.reduce_stacked(stacked, name, st))):
            raise AssertionError(
                f"reduce_sources != plain or stacked: {name} {x.dtype} "
                f"W={w} L={x.shape[2]} sources_tile={st} fold {f} of "
                f"{batch}{', in place' if in_place else ''}")
    return batch


def check_refusals(rs, dev):
    """The aliasing ``reduce_sources`` must refuse on the card."""
    a = torch.zeros(4, 1024, device=dev)
    bad = {
        "output partly over a source": [([a[0], a[1]],
                                         a.view(-1)[512:1536])],
        "output equal to source 1": [([a[0], a[1]], a[1])],
        "output over another fold's source": [([a[0], a[1]], a[2]),
                                              ([a[2], a[3]], a[3])],
        "two outputs overlapping": [([a[0], a[1]], a[2]),
                                    ([a[0], a[1]], a[2])],
    }
    for what, folds in bad.items():
        try:
            rs.reduce_sources(folds, "sum")
        except ValueError:
            continue
        raise AssertionError(f"reduce_sources took {what}")
    return len(bad)


def phase_fold_parity(dev, rs, registry, harness):
    """Phase 11: the fold kernel against its plain version, bitwise, for
    every op x dtype of the registry, W in FOLD_WIDTHS, a 16-byte-aligned
    and a ragged L, sources_tile 1 and 4, with NaNs in the float max/min
    inputs: through ``reduce_stacked``, into a misaligned ``out`` view too,
    and through ``reduce_sources`` (batches of 1 and 8 folds, in place, a
    misaligned source) against its plain version and
    ``reduce_stacked`` on the same sources stacked; the refused aliasing;
    the copy kernel against ``clone``, bitwise, aligned, ragged and
    misaligned."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    nan = float("nan")
    cases = sources_cases = 0
    for name, rop in registry.SUPPORTED_OPS.items():
        for dt_name in rop.dtypes:
            dtype = harness.torch_dtype(dt_name)
            for w in FOLD_WIDTHS:
                for length in FOLD_LENGTHS:
                    x = device_rows(FOLD_BATCH * w, length, dtype, gen,
                                    dev).view(FOLD_BATCH, w, length)
                    if dtype.is_floating_point and name in ("max", "min"):
                        x[:, 1, ::7] = nan
                        x[:, w - 1, 3::11] = nan
                    for st in FOLD_TILES:
                        got = rs.reduce_stacked(x[0], name, st)
                        plain = rs.reduce_stacked_plain(x[0], name, st)
                        if not same_bits(got, plain):
                            raise AssertionError(
                                f"fold kernel != plain: {name} {dt_name} "
                                f"W={w} L={length} sources_tile={st}")
                        cases += 1
                        for batch, in_place in FOLD_BATCH_CASES:
                            sources_cases += check_batch(
                                rs, x, name, st, batch, in_place)
                x = x[0]
                buf = torch.empty(FOLD_LENGTHS[1] + 1, dtype=dtype, device=dev)
                out = buf[1:]
                rs.reduce_stacked(x, name, out=out)
                if not same_bits(out, rs.reduce_stacked_plain(x, name)):
                    raise AssertionError(f"fold kernel into a misaligned out: "
                                         f"{name} {dt_name} W={w}")
                cases += 1
                out.view(torch.uint8).copy_(x[1].view(torch.uint8))
                sources = [x[0], out] + list(x[2:])  # source 1 misaligned
                got = rs.reduce_sources([(sources, torch.empty_like(x[0]))],
                                        name)
                if not same_bits(got[0], rs.reduce_stacked_plain(x, name)):
                    raise AssertionError(f"reduce_sources with a misaligned "
                                         f"source: {name} {dt_name} W={w}")
                sources_cases += 1
    refused = check_refusals(rs, dev)
    torch.cuda.synchronize()
    raw = device_rows(1, 4 * FOLD_LENGTHS[0] + 8, torch.uint8, gen, dev)[0]
    for src in (raw[:4 * FOLD_LENGTHS[0]].view(torch.float32),
                raw[:FOLD_LENGTHS[1]], raw[1:FOLD_LENGTHS[1] + 1]):
        if not same_bits(harness.hbm_copy(src), harness.hbm_copy_plain(src)):
            raise AssertionError(f"copy kernel != clone at {src.numel()} "
                                 f"elements, offset {src.storage_offset()}")
    log(f"phase 11 fold parity: reduce_stacked == plain bitwise in all "
        f"{cases} cases ({len(registry.SUPPORTED_OPS)} ops over the "
        f"registry's dtypes, W {FOLD_WIDTHS}, L {FOLD_LENGTHS}, sources_tile "
        f"{FOLD_TILES}, NaN rows for float max/min, a misaligned out); "
        f"reduce_sources == its plain version == reduce_stacked on the same "
        f"sources stacked, bitwise, in all {sources_cases} folds (batches of "
        f"1 and {FOLD_BATCH}, in place, a misaligned source: both kernel "
        f"bodies); {refused} aliasing cases refused; copy kernel == clone "
        f"bitwise (aligned, ragged, misaligned)")
    return {"cases": cases + sources_cases, "max_abs_err": 0.0}


def fold_shapes(spec, n, count, ar, max_pointers):
    """The fold kernel's launches in one allreduce call, by ``(W, L)``, from
    the topology (``parallel.allreduce.call_shape``): a stage of R folds is
    one launch of ``reduce_sources`` for every ``max_pointers // (W + 1)``
    folds."""
    shapes: dict = {}
    for r, w, length in ar.call_shape(n, spec, count).folds:
        per = max_pointers // (w + 1)
        shapes[(w, length)] = shapes.get((w, length), 0) + -(-r // per)
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
    path, the stacked entry) at the heaviest fold of each phase-13 shape,
    f32 sum, and f32 max at a ring step, with the copy kernel's and the
    stacked fold's launch counts set to 0 just before and read just
    after."""
    c = param_count
    shapes = ((8, c // 8), (4, c // 4), (2, c // 2), (2, c // 8))
    harness.hbm_copy.launches = harness.reduce_stacked.launches = 0
    doc = harness.run_reduce_bench(harness.ReduceBenchConfig(
        shapes=shapes, dtype="float32", op="sum", device=str(dev)))
    doc_max = harness.run_reduce_bench(harness.ReduceBenchConfig(
        shapes=((2, c // 8),), dtype="float32", op="max", device=str(dev)))
    copy_launches = harness.hbm_copy.launches
    stacked_launches = harness.reduce_stacked.launches
    if copy_launches == 0 or stacked_launches == 0:
        raise AssertionError("the reduce bench launched no copy or stacked "
                             "fold kernel")
    rows = doc["rows"] + doc_max["rows"]
    for r in rows:
        log(f"phase 12 fold {r['op']} W={r['W']} L={r['L']} f32 "
            f"({r['bytes'] / 1e6:.1f} MB): kernel {r['ms']:.4f} ms = "
            f"{r['GBps']:.0f} GB/s, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms = {r['library_GBps']:.0f} GB/s, bound "
            f"{r['bound_ms']:.4f} ms (bytes); copy kernel {r['copy_ms']:.4f} "
            f"ms = {r['copy_GBps']:.0f} GB/s, clone {r['copy_plain_ms']:.4f} "
            f"ms, copy_ {r['copy_library_ms']:.4f} ms (cold L2)")
    return rows, copy_launches, stacked_launches


def stage_times(dev, harness, rs, ar, param_count, bw):
    """Phase 12, the stage-wide fold: ``reduce_sources`` at the heaviest
    fold stage of each phase-13 shape (f32 sum), one launch for every
    rank's fold, beside its byte bound
    Σ(W+1)·L·4 over the memory rate, the same folds as R launches of
    ``reduce_stacked`` on stacks, the plain version, the copy kernel at the
    same bytes and, for W=2, ``torch._foreach_add`` (one PyTorch call for
    the stage); then one ring-step fold against ``torch.add(a, b,
    out=o)``.  Each launch with a cold L2 and a head start."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    seen, rows = set(), []
    for spec, n in COLLECTIVE_SHAPES:
        r, w, length = max(ar.call_shape(n, spec, param_count).folds,
                           key=lambda t: t[0] * (t[1] + 1) * t[2])
        if (r, w, length) in seen:
            continue
        seen.add((r, w, length))
        x = torch.randn((r, w, length), generator=gen, device=dev)
        outs = torch.empty((r, length), device=dev)
        folds = [(list(x[f]), outs[f]) for f in range(r)]
        rs.reduce_sources(folds, "sum")
        for f in range(r):
            if not same_bits(outs[f], rs.reduce_stacked(x[f], "sum")):
                raise AssertionError(f"stage fold {spec} != reduce_stacked")
        n_bytes = r * (w + 1) * length * 4
        src = torch.empty(n_bytes // 2, dtype=torch.uint8, device=dev)
        row = {
            "shape": spec, "R": r, "W": w, "L": length, "bytes": n_bytes,
            "ms": time_launches(lambda: rs.reduce_sources(folds, "sum"), 20,
                                flush),
            "stacked_ms": time_launches(
                lambda: [rs.reduce_stacked(x[f], "sum", out=outs[f])
                         for f in range(r)], 20, flush),
            "plain_ms": time_launches(
                lambda: rs.reduce_sources_plain(folds, "sum"), 10, flush),
            "copy_ms": time_launches(lambda: harness.hbm_copy(src), 20,
                                     flush),
            "library_ms": time_launches(
                lambda: torch._foreach_add(list(x[:, 0]), list(x[:, 1])), 20,
                flush) if w == 2 else None,
            "bound_ms": n_bytes / bw * 1e3,
        }
        rows.append(row)
        lib = row["library_ms"]
        log(f"phase 12 stage fold {spec}: {r} x (W={w}, L={length}) f32 sum "
            f"({n_bytes / 1e6:.1f} MB), one launch: kernel {row['ms']:.4f} ms"
            f" = {n_bytes / row['ms'] / 1e6:.0f} GB/s "
            f"({100 * row['bound_ms'] / row['ms']:.1f}% of the bound "
            f"{row['bound_ms']:.4f} ms); {r} stacked launches {row['stacked_ms']:.4f} ms; copy kernel "
            f"{row['copy_ms']:.4f} ms; plain {row['plain_ms']:.4f} ms"
            + (f"; torch._foreach_add {lib:.4f} ms" if lib is not None
               else "") + " (cold L2)")
        del x, outs, folds, src
        torch.cuda.empty_cache()
    ring = next(r for r in rows if r["shape"] == "1")
    length = ring["L"]
    a, b, o = (torch.randn(length, generator=gen, device=dev)
               for _ in range(3))
    one = {
        "kernel": time_launches(lambda: rs.reduce_sources([([a, b], o)]),
                                20, flush),
        "torch.add": time_launches(lambda: torch.add(a, b, out=o), 20, flush),
        "bound": 3 * length * 4 / bw * 1e3,
    }
    log(f"phase 12 one ring-step fold (W=2, L={length}) f32 sum: "
        f"reduce_sources {one['kernel']:.4f} ms, torch.add(a, b, out=o) "
        f"{one['torch.add']:.4f} ms, bound {one['bound']:.4f} ms (cold L2)")
    return rows


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


def fold_share(run, warm):
    """``run()`` under ``torch.profiler``, after ``warm()`` in its warm-up
    step (the tracer misses the first launches after it starts): the fold
    kernel's device time, the device's busy time, the wall time, and the
    device's launches by kind (``fold``, ``copy``: ``copy_``'s memcpy and
    copy kernels, ``other``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        prof.step()
    fold_us = busy_us = 0.0
    counts = {"fold": 0, "copy": 0, "other": 0}
    for e in prof.key_averages():
        # the step's own row spans the whole step: not a launch
        if e.device_type != DeviceType.CUDA or \
                e.key.startswith("ProfilerStep"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us <= 0:
            continue
        busy_us += us
        if "fold_kernel" in e.key:
            fold_us += us
            counts["fold"] += e.count
        elif "memcpy" in e.key.lower() or "copy" in e.key.lower():
            counts["copy"] += e.count
        else:
            counts["other"] += e.count
    return fold_us / 1e6, busy_us / 1e6, wall, counts


def phase_allreduce(dev, harness, stages, ar, registry, sim,
                    allreduce_over_mesh, flat_mesh, rs, param_count):
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
        per_call = fold_shapes(spec, n, param_count, ar, rs.MAX_POINTERS)
        for name, dt in MAIN_CASES:
            cfg = harness.BenchConfig(size=param_count, repeat=10, topo=spec,
                                      devices=n, dtype=dt, op=name,
                                      device=str(dev))
            rs.reduce_sources.launches = rs.reduce_stacked.launches = 0
            report = harness.run_allreduce_bench(cfg)
            got = rs.reduce_sources.launches
            want = sum(per_call.values()) * report.calls
            if not report.correct:
                raise AssertionError(f"bench {spec} {name} {dt}: incorrect")
            if got != want or rs.reduce_stacked.launches:
                raise AssertionError(
                    f"bench {spec} {name} {dt}: fold launches {got} != "
                    f"{want} from the topology, or a stacked fold "
                    f"({rs.reduce_stacked.launches})")
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
    # per shape: time, fold share, launches and bus bandwidth of the f32
    # sum, profiled on the bench's timed path (in place)
    summary = {}
    for spec, n in COLLECTIVE_SHAPES:
        report = per_shape[spec]
        mesh = flat_mesh(n, dev)
        x = device_rows(n, param_count, torch.float32, gen, dev)
        folds = sum(fold_shapes(spec, n, param_count, ar,
                                rs.MAX_POINTERS).values())
        copies = ar.call_shape(n, spec, param_count).copies
        # the tracer can drop launches from a window (on an H100, 65 of
        # 190 in one window of 25): a window that misses is taken again;
        # a staging copy would show in every one
        for attempt in range(1, 4):
            fold_s, busy_s, wall_s, counts = fold_share(
                lambda: [allreduce_over_mesh(x, mesh, spec, "sum",
                                             in_place=True)
                         for _ in range(3)],
                lambda: allreduce_over_mesh(x, mesh, spec, "sum",
                                            in_place=True))
            if counts["fold"] == 3 * folds and counts["copy"] == 3 * copies:
                break
            log(f"phase 13 {spec}: profiled window {attempt} counted "
                f"{counts} over 3 calls, want {folds} folds and {copies} "
                f"copies a call")
        else:
            raise AssertionError(
                f"{spec}: {counts} under the profiler over 3 calls, want "
                f"{folds} folds and {copies} copies (the gather phase and "
                f"the tail's snapshot) a call")
        summary[spec] = {
            "ranks": n, "median_ms": report.result.median_s * 1e3,
            "min_ms": report.result.min_s * 1e3,
            "bus_GBps": report.bus_bw_GBps,
            "fold_share_of_busy": fold_s / busy_s if busy_s else None,
            "device_busy_share": busy_s / wall_s,
            "launches_per_call": {k: v / 3 for k, v in counts.items()},
        }
        log(f"phase 13 times {spec} on {n} ranks, f32 sum, {param_count} per "
            f"rank (in-process mesh, HBM copies, not a network): median "
            f"{summary[spec]['median_ms']:.3f} ms, min "
            f"{summary[spec]['min_ms']:.3f} ms, bus "
            f"{report.bus_bw_GBps:.1f} GB/s; fold kernel "
            f"{fold_s * 1e3 / 3:.3f} ms a call = "
            f"{100 * (summary[spec]['fold_share_of_busy'] or 0):.1f}% of the "
            f"device's busy time, busy {100 * busy_s / wall_s:.1f}% of the "
            f"wall (under the profiler); launches a call "
            f"{sum(counts.values()) / 3:g}: {counts['fold'] / 3:g} fold, "
            f"{counts['copy'] / 3:g} copy (the gather phase and any tail "
            f"snapshot: the fold stages copy nothing), "
            f"{counts['other'] / 3:g} other")
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


# phase 15: the IR families at the gradient's size (plus a few elements,
# for a tail), and the planner
IR_SHAPES = (("swing", 8, 0), ("gen:4,2@2", 8, 0), ("gen:8@7", 8, 0),
             ("gen:2,2,2@1", 8, 0), ("swing", 7, 3))
# the JAX package's bar for a fitted model (tests/test_calibration.py)
SPEARMAN_BAR = 0.8


def corrupted_swing(sir, n):
    """``swing_ir(n)`` with every transfer of its second stage sent to the
    peer two ranks on (the JAX package's seeded corruption)."""
    prog = sir.swing_ir(n, count=n * n)
    st = prog.stages[1]
    bad = tuple(dataclasses.replace(x, dst=(x.dst + 2) % n) for x in st.xfers)
    return dataclasses.replace(
        prog, stages=prog.stages[:1] + (dataclasses.replace(st, xfers=bad),)
        + prog.stages[2:])


def check_ir_family(spec, n, count, gen, dev, flat_mesh,
                    allreduce_over_mesh):
    """One IR family on ``n`` ranks at ``count`` a rank: random f32 rows
    identical and bitwise the same executor on a CPU mesh (the plain fold
    in the same order), int32 and integer-valued f32 sums bitwise the exact
    sum."""
    mesh = flat_mesh(n, dev)
    x = device_rows(n, count, torch.float32, gen, dev)
    out = allreduce_over_mesh(x, mesh, spec, "sum")
    for r in range(1, n):
        if not same_bits(out[r], out[0]):
            raise AssertionError(f"{spec} on {n}: rank {r} != rank 0")
    cpu = allreduce_over_mesh(x.cpu(), flat_mesh(n, "cpu"), spec, "sum")
    if not same_bits(out.cpu(), cpu):
        raise AssertionError(f"{spec} on {n}: not its CPU executor")
    del x, out, cpu
    xi = device_rows(n, count, torch.int32, gen, dev)
    if not same_bits(allreduce_over_mesh(xi, mesh, spec, "sum"),
                     xi.sum(0, dtype=torch.int32).expand(n, -1)):
        raise AssertionError(f"{spec} on {n}: int32 sum not exact")
    del xi
    xf = torch.randint(-8, 8, (n, count), generator=gen, device=dev).float()
    if not same_bits(allreduce_over_mesh(xf, mesh, spec, "sum"),
                     xf.sum(0).expand(n, -1)):
        raise AssertionError(f"{spec} on {n}: integer-valued f32 sum not "
                             f"exact")


def phase_ir_families(dev, harness, ar, rs, flat_mesh, allreduce_over_mesh,
                      param_count, shape_times):
    """Phase 15: the IR families (swing, generalized) at the gradient's
    size, held to their CPU executor and exact sums, their fold launches
    to ``call_shape``, a corrupted program refused before any launch;
    then the planner's constants fitted on the card, saved, reloaded and
    refused under another fingerprint, and the planner's winner run."""
    from flextree_tpu_torch.planner import calibrate as cal
    from flextree_tpu_torch.planner import choose_topology
    from flextree_tpu_torch.schedule import ir as sir
    from flextree_tpu_torch.tools import calibrate_host

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    launches = 0
    times = dict(shape_times)
    for spec, n, extra in IR_SHAPES:
        count = param_count + extra
        check_ir_family(spec, n, count, gen, dev, flat_mesh,
                        allreduce_over_mesh)
        per_call = sum(fold_shapes(spec, n, count, ar,
                                   rs.MAX_POINTERS).values())
        shape = ar.call_shape(n, spec, count)
        rs.reduce_sources.launches = 0
        report = harness.run_allreduce_bench(harness.BenchConfig(
            size=count, repeat=10, topo=spec, devices=n, device=str(dev)))
        got = rs.reduce_sources.launches
        if not report.correct or got != per_call * report.calls:
            raise AssertionError(
                f"{spec} on {n}: correct={report.correct}, fold launches "
                f"{got} != {per_call} a call x {report.calls} calls")
        launches += got
        times[spec, n] = report.result.median_s * 1e3
        log(f"phase 15 {spec} on {n} ranks, {count} f32 per rank: "
            f"rows identical and bitwise its CPU executor, int32 and "
            f"integer-valued f32 sums exact; bench median "
            f"{report.result.median_s * 1e3:.3f} ms, bus "
            f"{report.bus_bw_GBps:.1f} GB/s, correct; fold launches {got} = "
            f"{per_call} a call x {report.calls} calls ({len(shape.folds)} "
            f"fold stages, {shape.messages} gather messages a call)")
    # a corrupted program is refused before anything runs
    x = device_rows(8, 1 << 12, torch.float32, gen, dev)
    out = torch.full_like(x, float("nan"))
    rs.reduce_sources.launches = 0
    try:
        ar.allreduce(list(x), flat_mesh(8, dev), corrupted_swing(sir, 8),
                     out=list(out))
    except sir.IRViolationError as err:
        refusal = f"{len(err.violations)} violations"
    else:
        raise AssertionError("a corrupted swing program ran")
    if rs.reduce_sources.launches or not torch.isnan(out).all():
        raise AssertionError("the corrupted program launched or copied")
    log(f"phase 15 corrupted swing (stage 1 peers moved by 2): refused with "
        f"IRViolationError ({refusal}) before any fold or copy")
    log(f"phase 15 times at {param_count} f32 per rank (swing on 7: + 3; "
        f"median ms of run_allreduce_bench): " + ", ".join(
            f"{spec} on {n} {ms:.3f}" for (spec, n), ms in
            sorted(times.items(), key=lambda kv: kv[1])))

    # the planner's constants, fitted on the card
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"ft_calibration_{os.getpid()}.json")
    try:
        wall = calibrate_host.calibrate(path, device=str(dev), wall=True)
        fit = calibrate_host.calibrate(path, device=str(dev))
        params = cal.load_calibration(path, backend=fit["backend"],
                                      fingerprint=fit["fingerprint"])
        other = cal.load_calibration(
            path, backend=fit["backend"],
            fingerprint=fit["fingerprint"].replace("|r8|", "|r4|"))
    finally:
        if os.path.exists(path):
            os.remove(path)
    if params is None or cal._params_to_dict(params) != fit["params"]:
        raise AssertionError("the saved calibration does not load back")
    if other is not None:
        raise AssertionError("a calibration loaded under another fingerprint")
    for p in fit["points"]:
        log(f"phase 15 calibration point {'*'.join(map(str, p['widths']))} "
            f"at {p['nbytes']} bytes: measured {p['measured_us']:.1f} us "
            f"(noise {p['noise_us']:.1f}), predicted "
            f"{p['predicted_us']:.1f} us")
    log(f"phase 15 calibration ({fit['fingerprint']}): "
        f"{json.dumps(fit['params'])}; Spearman rho {fit['spearman']:.4f} "
        f"(bar {SPEARMAN_BAR}), over the card's work; the wall-time fit "
        f"(host dispatch included) has rho {wall['spearman']:.4f}; saved, "
        f"loaded back equal, a miss under another fingerprint")
    if not fit["spearman"] >= SPEARMAN_BAR:
        raise AssertionError(f"Spearman rho {fit['spearman']} < "
                             f"{SPEARMAN_BAR}")

    # plan with the fitted constants and run the winner
    plan = choose_topology(8, param_count * 4, params,
                           ir_families=("swing", "generalized"))
    log("phase 15 plan:\n" + plan.summary())
    report = harness.run_allreduce_bench(harness.BenchConfig(
        size=param_count, repeat=10, topo=plan.to_ft_topo(), devices=8,
        device=str(dev)))
    if not report.correct:
        raise AssertionError(f"the planner's winner {plan.to_ft_topo()} is "
                             f"not correct")
    eight = {spec: ms for (spec, n), ms in times.items() if n == 8}
    best = min(eight, key=eight.get)
    won = report.result.median_s * 1e3
    log(f"phase 15 planner winner {plan.to_ft_topo()}: "
        f"{plan.candidates[0].total_us:.1f} us predicted, measured median "
        f"{won:.3f} ms, correct; the fastest measured on 8 ranks is {best} "
        f"at {eight[best]:.3f} ms (gap {won / eight[best]:.3f}x, printed, "
        f"not gated)")
    return launches, {"times_ms": times, "fit": fit, "wall_rho":
                      wall["spearman"], "winner": plan.to_ft_topo(),
                      "winner_ms": won, "best": best}


def collective_phases(dev, bw) -> list:
    """Phases 11-15 (the FlexTree collectives); returns their rows of the
    kernels line (``reduce_sources`` and ``reduce_stacked``, the fold
    kernel's two entry points, and ``copy``)."""
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
        (12, lambda: (phase_fold_times(dev, harness, param_count),
                      stage_times(dev, harness, rs, allreduce_mod,
                                  param_count, bw))),
        (13, lambda: phase_allreduce(dev, harness, stages, allreduce_mod,
                                     registry, sim, allreduce_over_mesh,
                                     flat_mesh, rs, param_count)),
        (14, lambda: phase_dist(dev, harness, launch, allreduce_mod,
                                flat_mesh)),
        (15, lambda: phase_ir_families(
            dev, harness, allreduce_mod, rs, flat_mesh, allreduce_over_mesh,
            param_count, {(spec, r["ranks"]): r["median_ms"]
                          for spec, r in out[13][2].items()})),
    ):
        t0 = time.monotonic()
        out[phase] = run()
        log(f"phase {phase}: {time.monotonic() - t0:.1f} s")
        torch.cuda.empty_cache()
    parity, ((times, copy_launches, stacked_launches), stage_rows), \
        (launches, top, _), (ir_launches, _) = out[11], out[12], out[13], \
        out[15]
    row = next(r for r in times if (r["W"], r["L"]) == top and r["op"] == "sum")
    stage = next(r for r in stage_rows if r["shape"] == "1")
    return [{
        "name": "reduce_sources",
        "route": "cuda",
        "source": "flextree_tpu_torch/csrc/reduce_stacked.cu",
        "replaces": "flextree_tpu/ops/pallas_reduce.py:33",
        "launches": launches + ir_launches,
        "max_abs_err": parity["max_abs_err"],
        "ms": stage["ms"],
        "plain_ms": stage["plain_ms"],
        "bound_ms": stage["bound_ms"],
        "bound_by": "bytes",
        "library_ms": stage["library_ms"],
    }, {
        "name": "reduce_stacked",
        "route": "cuda",
        "source": "flextree_tpu_torch/csrc/reduce_stacked.cu",
        "replaces": "flextree_tpu/ops/pallas_reduce.py:33",
        "launches": stacked_launches,
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
    phase_parity(dev, pa)

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
        f"{times['ms']:.4f} ms ({times['ms'] / times['library_ms']:.2f}x "
        f"SDPA), plain {times['plain_ms']:.4f} ms, SDPA "
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
    worst = phase_flash_parity(dev, fa, pa)

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


# the flash kernels whose bf16 path runs on the tensor cores
MMA_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def ptxas_report(kernels, name, dm):
    """ptxas' registers and spills of kernel ``name``'s tensor-core
    instantiation at head dim ``dm``, from this run's build, or None when
    the library came from an earlier build."""
    if name not in kernels.build_log:
        return None
    lines = kernels.build_log[name]["ptxas"].splitlines()
    at = [i for i, ln in enumerate(lines)
          if "Compiling entry function" in ln and f"mma_kernelILi{dm}E" in ln]
    if len(at) != 1:
        raise AssertionError(f"{name}: no DM={dm} tensor-core kernel in the "
                             f"ptxas report")
    return [ln.split(":", 1)[-1].strip()
            for ln in lines[at[0] + 1:at[0] + 4]
            if "spill" in ln or "registers" in ln]


def check_tensor_cores(kernels, paths):
    """The bf16 flash kernels (forward, dq, dk/dv) run their products on
    the tensor cores: ``HMMA`` (``mma.sync``) in their SASS
    (``cuobjdump``), and ptxas reports no register spills for their DM=64
    instantiation, the training shape's; DM=128's registers and spills are
    reported (a little spill is allowed there)."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    for name in MMA_KERNELS:
        sass = subprocess.run([cuobjdump, "-sass", str(paths[name])],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        hmma = sass.count("HMMA")
        if not hmma:
            raise AssertionError(f"{name}: no HMMA in its SASS")
        report = {dm: ptxas_report(kernels, name, dm) for dm in (64, 128)}
        if report[64] is None:
            note = "cached build, no ptxas report in this run"
        else:
            if not any("0 bytes spill stores, 0 bytes spill loads" in ln
                       for ln in report[64]):
                raise AssertionError(f"{name}: DM=64 spills registers "
                                     f"({'; '.join(report[64])})")
            note = "; ".join(f"DM={dm}: " + "; ".join(r)
                             for dm, r in report.items())
        log(f"phase 1 tensor cores {name}: {hmma} HMMA in the SASS; "
            f"bf16 {note}")


def train_ab(parent: str) -> int:
    """Phase 8's train run (:func:`phase_train`) of the checkout at
    ``parent`` and of this one in turns (parent, this, this, parent), each
    in a process of its own that imports its own checkout's package and
    builds its kernels: the steady step ms and the device time a step
    (``torch.profiler`` over three steps) of each run."""
    code = (
        "import json, sys, torch\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke as cs\n"
        "from flextree_tpu_torch import trainer\n"
        "from flextree_tpu_torch.ops import flash_attention as fa\n"
        "from flextree_tpu_torch.parallel import train as train_mod\n"
        "from flextree_tpu_torch.utils import checkpoint as ckpt\n"
        "torch.backends.cuda.matmul.allow_tf32 = False\n"
        "s = cs.phase_train(torch.device('cuda', 0), fa, trainer, ckpt, "
        "train_mod)\n"
        "busy = s['profile']['device_busy_s']\n"
        "print('train_ab ' + json.dumps({'steady_step_ms': "
        "s['steady_step_ms_median'], 'device_ms_per_step': None if busy is "
        "None else busy * 1e3 / 3, 'top': s['profile']['top'][:6]}))\n"
    )
    runs = []
    for tag, where in (("parent", parent), ("this", HERE), ("this", HERE),
                       ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", code], cwd=where,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"train run of {tag} ({where}) exited "
                                 f"{proc.returncode}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("train_ab ")][-1]
        res = json.loads(line[len("train_ab "):])
        runs.append((tag, res))
        dev_ms = res["device_ms_per_step"]
        log(f"phase 8 A/B {tag} ({where}): steady step "
            f"{res['steady_step_ms']:.3f} ms; device "
            + ("time not measured" if dev_ms is None else
               f"{dev_ms:.3f} ms a step (torch.profiler, 3 steps)")
            + "; top: " + ", ".join(
                f"{r['name'][:40]} {r['device_ms'] / 3:.3f}"
                for r in res["top"]))
    print(json.dumps({"train_ab": runs}))
    return 0


# one checkout's allreduce run for --allreduce-ab: phase 13's f32-sum bench
# (the bench's in-place timed path) and three in-place calls under
# torch.profiler, per shape; the same code measures both checkouts
ALLREDUCE_AB_CODE = """
import json, sys, time, torch
sys.path.insert(0, '.')
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule
from flextree_tpu_torch.bench import harness
from flextree_tpu_torch.parallel.mesh import allreduce_over_mesh, flat_mesh
count, shapes = json.loads(sys.argv[1])
dev = torch.device('cuda', 0)
out = {}
for spec, n in shapes:
    report = harness.run_allreduce_bench(harness.BenchConfig(
        size=count, repeat=20, topo=spec, devices=n, dtype='float32',
        op='sum', device=str(dev)))
    assert report.correct, spec
    x = torch.randn((n, count), generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev)
    mesh = flat_mesh(n, dev)
    # the tracer misses the first launches after it starts: one call in
    # its warm-up step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        allreduce_over_mesh(x, mesh, spec, 'sum', in_place=True)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.monotonic()
        for _ in range(3):
            allreduce_over_mesh(x, mesh, spec, 'sum', in_place=True)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        prof.step()
    busy = launches = 0
    for e in prof.key_averages():
        us = getattr(e, 'self_device_time_total',
                     getattr(e, 'self_cuda_time_total', 0.0))
        if e.device_type == DeviceType.CUDA and us > 0 and \
                not e.key.startswith('ProfilerStep'):
            busy += us / 1e6
            launches += e.count
    out[spec] = {'median_ms': report.result.median_s * 1e3,
                 'min_ms': report.result.min_s * 1e3,
                 'launches_per_call': launches / 3,
                 'device_ms_per_call': busy * 1e3 / 3,
                 'busy_share': busy / wall}
print('allreduce_ab ' + json.dumps(out))
"""


def allreduce_ab(parent: str) -> int:
    """Phase 13's five f32-sum shapes at the flagship's parameter count, for
    the checkout at ``parent`` and this one in turns (parent, this, this,
    parent), each in a process of its own that imports its own checkout's
    package and builds its kernels: per shape the bench's median ms a call
    and, over three more calls under ``torch.profiler``, the device's
    launches a call and its busy share of the wall."""
    sys.path.insert(0, HERE)
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from flextree_tpu_torch.parallel.train import tree_leaves

    params = init_params(TransformerConfig(**MODEL),
                         torch.Generator().manual_seed(SEED), device="cpu")
    count = sum(p.numel() for p in tree_leaves(params))
    arg = json.dumps([count, COLLECTIVE_SHAPES])
    runs = []
    for tag, where in (("parent", parent), ("this", HERE), ("this", HERE),
                       ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", ALLREDUCE_AB_CODE, arg],
                              cwd=where, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"allreduce run of {tag} ({where}) exited "
                                 f"{proc.returncode}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("allreduce_ab ")][-1]
        res = json.loads(line[len("allreduce_ab "):])
        runs.append((tag, res))
        for spec, r in res.items():
            log(f"phase 13 A/B {tag} {spec}: median {r['median_ms']:.3f} ms "
                f"(min {r['min_ms']:.3f}), {r['launches_per_call']:g} "
                f"launches a call, device {r['device_ms_per_call']:.3f} ms a "
                f"call, busy {100 * r['busy_share']:.1f}% of the wall")
    print(json.dumps({"allreduce_ab": runs}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    ab = {"--train-ab": train_ab, "--allreduce-ab": allreduce_ab}
    if sys.argv[1:2] and sys.argv[1] in ab:
        if len(sys.argv) != 3:
            print("usage: chip_smoke.py [--train-ab | --allreduce-ab "
                  "PARENT_CHECKOUT]", file=sys.stderr)
            return 2
        print(smi_line())
        return ab[sys.argv[1]](os.path.abspath(sys.argv[2]))
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
    paths = kernels.build()
    build_s = time.monotonic() - t0
    for name, info in kernels.build_log.items():
        regs = [ln.strip() for ln in info["ptxas"].splitlines()
                if "registers" in ln]
        log(f"phase 1 build {name}: {info['seconds']:.2f} s; "
            f"{' | '.join(regs[:4])}{' | ...' if len(regs) > 4 else ''}")
    log(f"phase 1 build total: {build_s:.2f} s")
    check_tensor_cores(kernels, paths)

    t0 = time.monotonic()
    rows = model_phases(dev, bw, fp32_peak, bf16_peak)
    log(f"phases 2-10: {time.monotonic() - t0:.1f} s")
    rows += collective_phases(dev, bw)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
