"""Benchmark harness: the FlexTree allreduce and its local fold on the
port's devices.

PyTorch counterpart of ``flextree_tpu/bench/harness.py`` (the allreduce
A/B, mirroring the reference's ``allreduce_over_mpi/benchmark.cpp``) and
of ``tools/roofline_reduce.py`` (the fold kernel against the copy
ceiling):

- :func:`run_allreduce_bench` — per-rep timing with a completion gate
  (``benchmark.cpp:149-159``; CUDA events, :mod:`..utils.timing`), the
  reference's data rule and a hard correctness check
  (``benchmark.cpp:180-189``), bus bandwidth ``2(N-1)/N * S / t``
  (``planner.cost_model.bus_bandwidth_GBps``), result files named as the
  reference names them (``benchmark.cpp:193-213``).  ``topo`` is any shape
  ``allreduce`` takes, the IR families (``"swing"``, ``"gen:4,2@2"``)
  included.  Ranks are an in-process mesh on one
  device (the JAX package's virtual devices), or, with ``dist=True``, the
  processes of the default ``torch.distributed`` group.  Only the FlexTree
  allreduce is timed: the JAX harness's ``xla`` baseline has no
  counterpart here.
- :func:`run_reduce_bench` — the fold kernel's GB/s at each ``(W, L)``
  beside its plain version, the one PyTorch call that computes the same
  function (``torch.sum(x, 0)``, ``amax``, ``amin``, ``prod``) and the
  copy kernel at the same bytes, each beside the least time the card
  could take.
- :func:`hbm_copy` — the copy kernel ``csrc/copy.cu``, which replaces the
  Pallas ``copy_kernel`` of ``tools/roofline_reduce.py:101``: the measured
  streaming ceiling the fold is judged against.

A number from a CPU run says how fast PyTorch's CPU kernels are; every
report names the device it ran on.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..ops.reduce import get_op
from ..ops.reduce_stacked import (
    reduce_sources,
    reduce_stacked,
    reduce_stacked_plain,
)
from ..parallel.mesh import allreduce_over_mesh, flat_mesh
from ..planner.cost_model import bus_bandwidth_GBps
from ..schedule.ir import is_ir_family_spec, resolve_collective
from ..schedule.stages import Topology
from ..utils.timing import BenchResult, time_fn, time_fn_inplace

__all__ = [
    "BenchConfig",
    "BenchReport",
    "run_allreduce_bench",
    "ReduceBenchConfig",
    "run_reduce_bench",
    "bus_bandwidth_GBps",
    "hbm_copy",
    "hbm_copy_plain",
    "torch_dtype",
    "seeded_row",
    "seeded_rows",
    "digest",
    "dist_allreduce_cases",
    "dist_bench",
    "CARD_MEMORY_RATE",
    "DEVICE_HEAD_START_CYCLES",
]

#: untimed calls after the first and before the timed ones
WARMUP = 2

#: Memory rate in bytes/s by card name, from NVIDIA's data sheets (the
#: full power limit); the first key found in the device name wins.
CARD_MEMORY_RATE = (("H200", 4.8e12), ("H100 NVL", 3.9e12),
                    ("H100 PCIe", 2.0e12), ("H100", 3.35e12))


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a registry dtype name (``"bfloat16"``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _memory_rate(device: torch.device) -> float | None:
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((rate for key, rate in CARD_MEMORY_RATE if key in name), None)


def _device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"type": "cuda", "name": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count()}
    return {"type": device.type, "name": device.type, "count": 1}


# ---------------------------------------------------------------- copy


def hbm_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """The copy in plain PyTorch: ``x.clone()``."""
    return x.clone()


def hbm_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of contiguous ``x``.  On a CUDA tensor it launches
    ``csrc/copy.cu`` (16-byte words, a grid-stride loop) and counts the
    launch in ``hbm_copy.launches``; on a CPU tensor it is
    :func:`hbm_copy_plain`."""
    if x.device.type == "cpu":
        return hbm_copy_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"copy kernel runs on CUDA tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("copy kernel needs a contiguous tensor")
    from ..kernels import load

    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size()
    if nbytes == 0:
        return out
    fn = load("copy").ft_copy
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), nbytes, stream)
    if rc != 0:
        raise RuntimeError(f"copy kernel launch failed: CUDA error {rc}")
    hbm_copy.launches += 1
    return out


#: Kernel launches since the count was last reset (set it to 0 to reset).
hbm_copy.launches = 0


# ------------------------------------------------------------------ data


def seeded_row(rank: int, count: int, dtype: torch.dtype,
               seed: int) -> torch.Tensor:
    """Rank ``rank``'s input of a seeded test case, on the CPU: standard
    normals for floats (rounded to the dtype), random integers over the
    dtype's low bits for integers, random bits for bool.  Each row has
    its own generator, so a process can make its row alone."""
    rng = np.random.default_rng([seed, rank])
    if dtype.is_floating_point:
        return torch.from_numpy(
            rng.standard_normal(count).astype(np.float32)).to(dtype)
    if dtype == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, count).astype(np.bool_))
    bits = torch.iinfo(dtype).bits
    raw = rng.integers(0, 2 ** min(bits, 62), count, dtype=np.int64)
    return torch.from_numpy(raw).to(dtype)  # wraps to the width


def seeded_rows(n: int, count: int, dtype: torch.dtype,
                seed: int) -> torch.Tensor:
    """The ``(n, count)`` stack of :func:`seeded_row` for every rank."""
    return torch.stack([seeded_row(r, count, dtype, seed) for r in range(n)])


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes (the bitwise identity of a result)."""
    return hashlib.sha256(
        t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
    ).hexdigest()


def _reference_rows(n: int, size: int, dtype: torch.dtype) -> torch.Tensor:
    """``data[r, i] = (i % 256) + r`` (``benchmark.cpp:119-124``, with
    per-rank-distinct rows so every op has a non-trivial reduction); small
    values, so float32 sums stay exact and integer wraparound is the same
    on host and device."""
    base = np.arange(size, dtype=np.int64) % 256
    data = base[None, :] + np.arange(n, dtype=np.int64)[:, None]
    return torch.from_numpy(data).to(dtype)  # wraps to the width


# ------------------------------------------------------------ allreduce


@dataclass(frozen=True)
class BenchConfig:
    size: int = 35  # elements per rank (reference default, benchmark.cpp:36)
    repeat: int = 10
    comm_type: str = "flextree"  # the port times the FlexTree allreduce
    topo: str | None = None  # FT_TOPO-style spec or IR family; None -> env/flat
    devices: int | None = None  # ranks of the in-process mesh (None -> 8)
    dtype: str = "float32"
    op: str = "sum"
    tag: str = "flextree"
    to_file: bool = False
    out_dir: str = "."
    # in-place timing (the reference benchmark's MPI_IN_PLACE compounding
    # loop, benchmark.cpp:149-159): each rep's output is the next rep's
    # input, written over it
    in_place: bool = True
    device: str | None = None  # None -> cuda; "cpu" to run on the host
    dist: bool = False  # ranks = the default process group's processes
    # on the card, in-process mesh: each timed call is enqueued while the
    # card spins (DEVICE_HEAD_START_CYCLES), so its events time the
    # device's work and not the host's dispatch; a call still enqueueing
    # when the spin ends raises
    device_time: bool = False


#: GPU cycles (~20 ms on an H100) the card spins before each timed call
#: of a ``device_time`` run: longer than the host takes to enqueue a call
DEVICE_HEAD_START_CYCLES = 40_000_000


@dataclass(frozen=True)
class BenchReport:
    config: BenchConfig
    num_devices: int
    topo: str
    result: BenchResult
    bus_bw_GBps: float
    correct: bool
    result_path: str | None = None
    device: dict | None = None
    calls: int = 0  # allreduce calls the run made (launch accounting)

    def payload(self) -> dict:
        return {
            "config": dataclasses.asdict(self.config),
            "num_devices": self.num_devices,
            "topo": self.topo,
            "times_s": list(self.result.times_s),
            "compile_s": self.result.compile_s,
            "min_s": self.result.min_s,
            "avg_s": self.result.avg_s,
            "bus_bw_GBps": self.bus_bw_GBps,
            "correct": self.correct,
            "device": self.device,
        }


def result_file_name(tag: str, num_devices: int, size: int, topo: str) -> str:
    """``{tag}.{N}.{size}.{topo}.ar_test.{unix_time}-{seq}.json`` — the
    reference's scheme (``benchmark.cpp:196-200``), as the JAX package
    writes it."""
    result_file_name.seq += 1
    topo_s = topo.replace(",", "-").replace("*", "-") or "flat"
    return (f"{tag}.{num_devices}.{size}.{topo_s}.ar_test."
            f"{int(time.time())}-{result_file_name.seq:04d}.json")


result_file_name.seq = 0


def _expected(data: torch.Tensor, rop) -> torch.Tensor:
    """The op folded over the host rows: in float64 for floats (exact for
    the reference data's sums and products), in the dtype otherwise
    (integer wraparound then matches the device exactly)."""
    rows = data.double() if data.dtype.is_floating_point else data
    expect = rows[0]
    for r in range(1, rows.shape[0]):
        expect = rop.fold(expect, rows[r])
    return expect


def _matches(got: torch.Tensor, expect: torch.Tensor, data: torch.Tensor,
             rop) -> bool:
    """Integers, max and min: bitwise.  Float sums and products: within the
    bound any fold order keeps, ``N·u·Σ_r|x_r|`` (sum) or ``N·u·|Π_r x_r|``
    (prod), with ``u`` the dtype's unit roundoff — the schedule folds in
    another order than the host, and float16/bfloat16 round every step (a
    fixed rtol of 1e-3, the JAX harness's, is below bfloat16's own
    rounding)."""
    if not got.dtype.is_floating_point or rop.name in ("max", "min"):
        return bool(torch.equal(got, expect.to(got.dtype)))
    n = data.shape[0]
    u = 2.0 ** -{torch.float16: 11, torch.bfloat16: 8, torch.float32: 24,
                 torch.float64: 53}[got.dtype]
    mags = data.double().abs()
    scale = mags.sum(0) if rop.name == "sum" else mags.prod(0)
    g = got.double()
    overflow = expect.abs() > torch.finfo(got.dtype).max
    ok = (g - expect).abs() <= n * u * scale
    return bool((ok | (overflow & torch.isinf(g))).all())


def run_allreduce_bench(cfg: BenchConfig) -> BenchReport:
    """Time the FlexTree allreduce of ``cfg.size`` elements per rank and
    check its result: every rank's row bitwise identical, and equal to the
    op folded over the inputs on the host (float sums and products within
    the fold-order bound of :func:`_matches`).  With ``cfg.device_time``
    the times are the card's work alone (see :class:`BenchConfig`)."""
    if cfg.comm_type != "flextree":
        raise ValueError(f"unknown --comm-type {cfg.comm_type!r}: the port "
                         f"times the FlexTree allreduce only (flextree)")
    dev = resolve_device(cfg.device)
    dtype = torch_dtype(cfg.dtype)
    rop = get_op(cfg.op)
    rop.check_dtype(dtype)
    if cfg.dist:
        import torch.distributed as dist

        n, rank = dist.get_world_size(), dist.get_rank()
    else:
        n, rank = cfg.devices or 8, None
    # IR families ("swing", "gen:4,2@2") resolve to their spec, and the
    # report's topo names them by it
    topo = resolve_collective(n, cfg.topo) if n > 1 else Topology.flat(1)
    data = _reference_rows(n, cfg.size, dtype)
    expect = _expected(data, rop)

    if cfg.dist:
        from ..parallel.allreduce import allreduce

        x = data[rank].to(dev)
        fn = lambda t: allreduce(t, None, topo=topo, op=rop)  # noqa: E731
        timed = (lambda t: allreduce(t, None, topo=topo, op=rop, out=t)
                 ) if cfg.in_place else fn
        before = dist.barrier
    else:
        mesh = flat_mesh(n, dev)
        x = data.to(dev)
        fn = lambda t: allreduce_over_mesh(t, mesh, topo, rop)  # noqa: E731
        timed = (lambda t: allreduce_over_mesh(t, mesh, topo, rop,
                                               in_place=True)
                 ) if cfg.in_place else fn
        before = None
        if cfg.device_time and dev.type == "cuda":
            timed, before = _ahead_of_the_card(timed)
    if cfg.in_place:
        result = time_fn_inplace(timed, x.clone(), repeat=cfg.repeat,
                                 warmup=WARMUP, before=before)
    else:
        result = time_fn(timed, x, repeat=cfg.repeat, warmup=WARMUP,
                         before=before)
    out = fn(x).cpu()
    if cfg.dist:
        correct = _matches(out, expect, data, rop)
        from ..parallel.allreduce import allreduce

        flag = torch.tensor([int(correct)], dtype=torch.uint8, device=dev)
        correct = bool(allreduce(flag, None, op="band").item())
    else:
        correct = all(torch.equal(out[r], out[0]) for r in range(n)) and \
            _matches(out[0], expect, data, rop)
    nbytes = cfg.size * x.element_size()
    bus = bus_bandwidth_GBps(n, nbytes, result.min_s * 1e6)
    calls = 1 + WARMUP + cfg.repeat + 1
    report = BenchReport(cfg, n, str(topo), result, bus, correct, None,
                         _device_info(dev), calls)
    if cfg.to_file:
        name = result_file_name(cfg.tag, n, cfg.size, str(topo))
        path = Path(cfg.out_dir) / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report.payload(), indent=2,
                                   sort_keys=True) + "\n")
        report = dataclasses.replace(report, result_path=str(path))
    return report


def _ahead_of_the_card(fn):
    """``fn`` and a ``before`` hook that starts the card spinning: each
    call is enqueued behind the spin, and raises if the spin ended before
    the host finished enqueueing it (its events would then time the
    host)."""
    done = torch.cuda.Event()
    armed = []

    def before():
        torch.cuda._sleep(DEVICE_HEAD_START_CYCLES)
        done.record()
        armed.append(True)

    def ahead(t):
        out = fn(t)
        if armed and armed.pop() and done.query():
            raise RuntimeError("the card's head start ended before the call "
                               "was enqueued: raise DEVICE_HEAD_START_CYCLES")
        return out

    return ahead, before


# ------------------------------------------------------- dist test cases


def dist_allreduce_cases(rank: int, world: int, cases, device: str = "cpu"):
    """Run seeded cases on this rank of the default process group
    (:func:`..parallel.launch.spawn` calls it).  ``cases``: ``(topo, count,
    op, dtype name, seed, chunks)``; this rank's input is :func:`seeded_row`.
    Returns per case the digests of ``allreduce``, of this rank's
    ``reduce_scatter`` shard and of ``all_gather`` of that shard (None for
    an IR family, which has no standalone phases), and the fold kernel's
    launches during the allreduce."""
    from ..parallel.allreduce import all_gather, allreduce, reduce_scatter

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out = []
    for topo, count, op, dtype, seed, chunks in cases:
        x = seeded_row(rank, count, torch_dtype(dtype), seed).to(dev)
        reduce_sources.launches = 0
        full = allreduce(x, None, topo=topo, op=op, chunks=chunks)
        launches = reduce_sources.launches
        if is_ir_family_spec(topo):
            out.append((digest(full), None, None, launches))
            continue
        shard = reduce_scatter(x, None, topo=topo, op=op)
        back = all_gather(shard, None, topo=topo, out_shape=(count,))
        out.append((digest(full), digest(shard), digest(back), launches))
    return out


def dist_bench(rank: int, world: int, cfg: BenchConfig) -> dict:
    """:func:`run_allreduce_bench` on this rank of the default process
    group (``cfg.dist`` must be set); returns the report's payload."""
    return run_allreduce_bench(cfg).payload()


# ------------------------------------------------------------- the fold


@dataclass(frozen=True)
class ReduceBenchConfig:
    """Fold shapes ``(W, L)`` to time; every row of a shape moves
    ``(W+1)·L·itemsize`` bytes."""

    shapes: tuple = ((2, 1 << 24), (4, 1 << 23), (8, 1 << 22))
    dtype: str = "float32"
    op: str = "sum"
    repeat: int = 20
    device: str | None = None  # None -> cuda


#: GPU cycles (~0.5 ms) spent spinning before each timed launch
_HEAD_START_CYCLES = 1_000_000

_LIBRARY = {"sum": lambda x: torch.sum(x, 0), "max": lambda x: torch.amax(x, 0),
            "min": lambda x: torch.amin(x, 0), "prod": lambda x: torch.prod(x, 0)}


def run_reduce_bench(cfg: ReduceBenchConfig) -> dict:
    """The fold kernel against its plain version, the PyTorch call that
    computes the same function, and the copy kernel moving the same bytes
    (with ``clone`` and ``copy_`` beside it): median ms over ``repeat``
    timed launches, GB/s, and the least time the card could take (bytes
    over its memory rate).  On the card each timed launch follows an L2
    flush and a ~0.5 ms spin, so it starts cold and only once the host has
    enqueued it.  The kernel must match its plain version bitwise."""
    dev = resolve_device(cfg.device)
    dtype = torch_dtype(cfg.dtype)
    rop = get_op(cfg.op)
    rop.check_dtype(dtype)
    rate = _memory_rate(dev)
    before = None
    if dev.type == "cuda":
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

        def before():  # a cold L2, as the allreduce's stages find it
            flush.zero_()
            # keep the card busy while the host enqueues the timed launch,
            # so the events time the kernel and not the wrapper's Python
            torch.cuda._sleep(_HEAD_START_CYCLES)

    def ms(fn, *args):
        return time_fn(fn, *args, device=dev, repeat=cfg.repeat,
                       warmup=WARMUP, before=before).median_s * 1e3

    rows = []
    for w, length in cfg.shapes:
        x = seeded_rows(w, length, dtype, seed=w).to(dev)
        got = reduce_stacked(x, rop)
        plain = reduce_stacked_plain(x, rop)
        bitwise = digest(got) == digest(plain)
        if not bitwise:
            raise AssertionError(f"fold kernel differs from its plain version "
                                 f"at W={w} L={length}")
        lib = _LIBRARY.get(rop.name)
        n_bytes = (w + 1) * length * x.element_size()
        src = torch.empty(n_bytes // 2, dtype=torch.uint8, device=dev)
        row = {
            "W": w, "L": length, "dtype": cfg.dtype, "op": rop.name,
            "bytes": n_bytes, "bitwise_vs_plain": bitwise,
            "ms": ms(reduce_stacked, x, rop),
            "plain_ms": ms(reduce_stacked_plain, x, rop),
            "library_ms": ms(lib, x) if lib is not None else None,
            "copy_ms": ms(hbm_copy, src),
            "copy_plain_ms": ms(hbm_copy_plain, src),
            "copy_library_ms": ms(torch.Tensor.copy_, torch.empty_like(src),
                                  src),
            "bound_ms": n_bytes / rate * 1e3 if rate else None,
        }
        for key in ("ms", "plain_ms", "library_ms", "copy_ms",
                    "copy_plain_ms", "copy_library_ms"):
            if row[key] is not None:
                row[key.replace("ms", "GBps")] = n_bytes / row[key] / 1e6
        rows.append(row)
        del x, got, plain, src
    return {"device": _device_info(dev), "memory_rate_GBps":
            rate / 1e9 if rate else None, "rows": rows}
