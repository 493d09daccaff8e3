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
- :func:`run_grad_sync_bench` — the bucketed gradient sync against the
  per-leaf one on an in-process mesh (the JAX harness's A/B of the same
  name): per-leaf, fused and fused chunk-pipelined, timed in turns, and
  the three results held bitwise equal; with ``codecs``, a lossy fused
  row a codec, held to the codec's error bound;
- :func:`run_train_step_bench` — the data-parallel train step under the
  per-leaf, fused and chunked syncs (the JAX harness's function of the
  same name), and with ``overlap`` its readiness-ordered step, that
  step's serialized twin and the sync-free step
  (:func:`make_nosync_train_step`), timed in turns: each sync row's
  exposed and hidden sync time (``utils.profiling.exposed_split``), and
  every step's parameters held bitwise to the per-leaf step's;
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
    "dist_train_steps",
    "GradSyncBenchConfig",
    "run_grad_sync_bench",
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
        t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
        .tobytes()
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


def dist_compressed_cases(rank: int, world: int, cases,
                          device: str = "cpu"):
    """Run seeded compressed-collective cases on this rank of the default
    process group (:func:`..parallel.launch.spawn` calls it).  ``cases``:
    ``(topo, count, codec, seed, chunks, step)``; this rank's input is
    :func:`seeded_row` (float32).  Returns per case the digests of
    ``compressed_allreduce``'s result and residual, of this rank's
    ``compressed_reduce_scatter`` shard and of ``compressed_all_gather``
    of that shard."""
    from ..parallel.compressed import (
        compressed_all_gather,
        compressed_allreduce,
        compressed_reduce_scatter,
    )

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out = []
    for topo, count, codec, seed, chunks, step in cases:
        x = seeded_row(rank, count, torch.float32, seed).to(dev)
        full, res = compressed_allreduce(x, None, topo, codec, chunks, step,
                                         return_residual=True)
        shard = compressed_reduce_scatter(x, None, topo, codec, step)
        back = compressed_all_gather(shard, None, topo, (count,), codec,
                                     step)
        out.append(tuple(digest(t) for t in (full, res, shard, back)))
    return out


def dist_bench(rank: int, world: int, cfg: BenchConfig) -> dict:
    """:func:`run_allreduce_bench` on this rank of the default process
    group (``cfg.dist`` must be set); returns the report's payload."""
    return run_allreduce_bench(cfg).payload()


def dist_train_steps(rank: int, world: int, model: dict, train: dict,
                     batches, seed: int, device: str = "cpu"):
    """Data-parallel train steps on this rank of the default process group
    (:func:`..parallel.launch.spawn` calls it): the state from
    ``init_train_state`` with a generator seeded by ``seed``,
    ``TransformerConfig(**model)`` and ``TrainConfig(**train)``, then one
    step a ``(tokens, targets)`` global batch.  Returns the digests of the
    state's leaves (``tree_leaves`` order) and the step losses."""
    import torch.distributed as dist

    from ..models.transformer import TransformerConfig
    from ..parallel.train import (
        TrainConfig,
        init_train_state,
        make_train_step,
        tree_leaves,
    )

    cfg, tc = TransformerConfig(**model), TrainConfig(**train)
    state = init_train_state(cfg, torch.Generator().manual_seed(seed), tc,
                             device=device, comm=dist.group.WORLD)
    step = make_train_step(cfg, tc, device=device, comm=dist.group.WORLD)
    losses = []
    for tokens, targets in batches:
        state, metrics = step(state, tokens, targets)
        losses.append(float(metrics["loss"]))
    return [digest(t) for t in tree_leaves(state)], losses


# ---------------------------------------------------------- gradient sync


@dataclass(frozen=True)
class GradSyncBenchConfig:
    """The bucketed gradient sync against the per-leaf one.

    ``n_leaves`` leaves of ``leaf_size`` float32 elements (the JAX
    harness's many-small-leaves regime), or the leaf ``shapes`` given (a
    model's gradient), on each of ``devices`` ranks (None: 8) of an
    in-process mesh on ``device`` (None: ``cuda``)."""

    n_leaves: int = 48
    leaf_size: int = 16384  # float32 elements per leaf
    shapes: tuple | None = None  # leaf shapes; replaces n_leaves x leaf_size
    devices: int | None = None
    topo: str | None = None  # FT_TOPO-style; None -> env/flat
    repeat: int = 10
    chunks: int = 2  # the ours_chunked row's pipelining factor
    bucket_bytes: int | None = None  # None -> planner-derived
    device: str | None = None
    # wire codecs (ops/quantize.py), e.g. ("bf16", "int8"): each adds an
    # ``ours_fused_<codec>`` row, held to the codec's error bound against
    # the per-leaf sync instead of bitwise
    codecs: tuple = ()


def run_grad_sync_bench(cfg: GradSyncBenchConfig) -> dict:
    """Rows ``per_leaf`` (one allreduce a leaf), ``ours_fused`` (bucketed)
    and ``ours_chunked`` (bucketed, chunk-pipelined), and one
    ``ours_fused_<codec>`` a codec of ``cfg.codecs``: min, mean and median
    ms each, timed in turns (:func:`_interleaved_times`), the fused rows'
    speedup over per-leaf, the bucket plan, and the check that every
    rank's every leaf is bitwise the same in the three lossless rows (the
    sync's contract; raises otherwise).  A codec row's
    ``err_over_bound`` is its worst leaf's max error against the per-leaf
    sync over ``Codec.error_bound`` (raises above 1)."""
    from ..ops.quantize import get_codec
    from ..parallel.bucketing import plan_buckets
    from ..parallel.train import resolve_axis_topos, sync_grads, tree_leaves
    from ..schedule.stages import LonelyTopology

    dev = resolve_device(cfg.device)
    n = cfg.devices or 8
    mesh = flat_mesh(n, dev, "dp")
    axes = ("dp",)
    topos = resolve_axis_topos(mesh, axes, cfg.topo)
    shapes = cfg.shapes or ((cfg.leaf_size,),) * cfg.n_leaves
    gen = torch.Generator(device=dev).manual_seed(0)
    trees = [{f"leaf{i}": torch.randn(tuple(s), generator=gen, device=dev)
              for i, s in enumerate(shapes)} for _ in range(n)]

    def make_fn(bucket_bytes, chunks, codec="f32"):
        return lambda: sync_grads(trees, None, axes, topos,
                                  bucket_bytes=bucket_bytes, chunks=chunks,
                                  codec=codec, comm=mesh)

    variants = {
        "per_leaf": make_fn(0, 1),
        "ours_fused": make_fn(cfg.bucket_bytes, 1),
        "ours_chunked": make_fn(cfg.bucket_bytes, cfg.chunks),
    }
    for codec in cfg.codecs:
        variants[f"ours_fused_{codec}"] = make_fn(cfg.bucket_bytes, 1, codec)
    outs = {name: [tree_leaves(t) for t in fn()]  # also the warm-up call
            for name, fn in variants.items()}
    worst = {}
    t = topos["dp"]
    widths, lonely = (t.tree.widths, t.lonely) \
        if isinstance(t, LonelyTopology) else (t.widths, 0)
    for codec in cfg.codecs:
        c = get_codec(codec)
        worst[codec] = 0.0
        for i in range(len(shapes)):
            exact = outs["per_leaf"][0][i].double()
            amax = max(float(tr[i].abs().max()) for tr in
                       (tree_leaves(x) for x in trees))
            bound = c.error_bound(amax, n, widths, lonely) + 1e-5
            err = max(float((r[i].double() - exact).abs().max())
                      for r in outs[f"ours_fused_{codec}"])
            worst[codec] = max(worst[codec], err / bound)
        if worst[codec] > 1:
            raise RuntimeError(f"codec {codec} sync error exceeds its "
                               f"documented bound ({worst[codec]:.3f} of it)")
        del outs[f"ours_fused_{codec}"]
    identical = all(
        torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        for name in ("ours_fused", "ours_chunked")
        for ra, rb in zip(outs["per_leaf"], outs[name])
        for a, b in zip(ra, rb)
    ) and all(torch.equal(a, b) for r in outs["per_leaf"][1:]
              for a, b in zip(outs["per_leaf"][0], r))
    del outs
    if not identical:
        raise RuntimeError("fused sync output diverged from per-leaf "
                           "(bitwise)")
    rows = _interleaved_times(variants, cfg.repeat, dev)
    for name in rows:
        if name != "per_leaf":
            rows[name]["vs_per_leaf"] = (rows["per_leaf"]["min_ms"]
                                         / rows[name]["min_ms"])
    for codec, w in worst.items():
        rows[f"ours_fused_{codec}"]["err_over_bound"] = w
    leaves = tree_leaves(trees[0])
    buckets = plan_buckets(leaves, [None] * len(leaves), axes, topos=topos,
                           axis_sizes={"dp": n},
                           bucket_bytes=cfg.bucket_bytes)
    return {
        "config": dataclasses.asdict(cfg),
        "num_devices": n,
        "device": _device_info(dev),
        "topo": str(topos["dp"]),
        "total_mb": sum(g.numel() * g.element_size() for g in leaves) / 2**20,
        "n_leaves": len(leaves),
        "n_buckets": len(buckets),
        "bucket_bytes": [b.nbytes for b in buckets],
        "identical": identical,
        "rows": rows,
    }


# ------------------------------------------------------------ train step


@dataclass(frozen=True)
class TrainStepBenchConfig:
    """The data-parallel train step (forward, backward, sync, AdamW) under
    each sync: the JAX ``TrainStepBenchConfig``, field for field, plus the
    ``device``.  The model computes as the flagship does (bfloat16, the
    flash kernels; float32 parameters).  The default model is the
    many-small-leaves regime (50 gradient leaves) on ``devices`` in-process
    ranks (None: 8).

    ``overlap`` adds ``no_sync`` (the same step with the sync left out:
    the exposure baseline), ``ours_overlapped`` (``TrainConfig(overlap=
    True)``) and ``ours_overlap_serialized`` (its twin).  ``sharded`` adds
    the ZeRO-1 rows ``ours_sharded`` (float32 wire, held bitwise to the
    per-leaf step) and ``ours_sharded_int8`` (both wires int8), each with
    its per-rank optimizer-state ratio
    (:func:`..parallel.zero.zero_shard_bytes`).  ``supervised`` and
    ``recorder`` (the JAX rows of the supervision host path and the flight
    recorder) wait for their modules and raise; ``supervised`` defaults to
    False here, where JAX's is True."""

    n_layers: int = 6
    d_model: int = 64
    d_ff: int = 128
    n_heads: int = 4
    vocab_size: int = 256
    batch: int = 8
    seq_len: int = 64
    devices: int | None = None
    topo: str | None = None  # grad_topo for the sync
    repeat: int = 5
    chunks: int = 2
    supervised: bool = False
    overlap: bool = False
    sharded: bool = False
    recorder: bool = False
    device: str | None = None


def make_nosync_train_step(model_cfg, train_cfg, device=None, comm=None):
    """The sync-free twin of ``make_train_step``: every rank's forward and
    backward, clipping and AdamW, with the gradient sync left out (the
    first local rank's gradient updates the state).  Not a training step
    (the ranks' gradients are never summed), but the baseline the overlap
    bench needs: a step's time over this one's is the sync time that
    extended the step (``utils.profiling.exposed_split``)."""
    from ..parallel import train as tm

    tm._refuse_unported(train_cfg)
    dev, dp, local = tm._local_ranks(comm, device)

    def step(state, tokens, targets):
        toks, tgts, n_total = tm._rank_batches(tokens, targets, dev, dp,
                                               local)
        runs = [tm._rank_loss_and_grads(model_cfg, state["params"], t, y,
                                        n_total) for t, y in zip(toks, tgts)]
        metrics = {"loss": tm._global_loss([loss for loss, _ in runs],
                                           comm)}
        # clipping stays: compute parity with the real step
        grads = tm.maybe_clip_grads(runs[0][1], train_cfg, metrics)
        return tm.adamw_apply(state, grads, train_cfg), metrics

    return step


def run_train_step_bench(cfg: TrainStepBenchConfig) -> dict:
    """Rows of the train step's ms (min, mean, median) a sync strategy,
    timed in turns (:func:`_interleaved_times`), on an in-process mesh of
    ``cfg.devices`` ranks on ``cfg.device``; ``sync_ms`` is the sync alone
    on gradient-shaped data, so ``step - sync`` reads as the compute.  With
    ``cfg.overlap`` the rows ``no_sync``, ``ours_overlapped`` and
    ``ours_overlap_serialized`` come too, and every sync row carries
    ``exposed_comm_ms`` and ``hidden_comm_ms`` (:func:`exposed_split` over
    the ``no_sync`` step; the overlap rows cut the twin's exposure, the
    JAX bench's comm total, the others their own ``sync_ms``) and
    ``exposed_vs_serialized`` (the twin's exposure over the row's).  With
    ``cfg.sharded`` the rows ``ours_sharded`` and ``ours_sharded_int8``
    come too (step ms, ``vs_per_leaf`` and ``opt_state_bytes_ratio``), and
    ``opt_state_bytes`` gives each one's ``zero_shard_bytes`` beside the
    bytes a rank of the sharded moment (and master) buffers its state
    holds.  Raises unless the fused, chunked, overlap and ``ours_sharded``
    steps update the parameters bitwise as the per-leaf step does."""
    from ..models.transformer import TransformerConfig, param_specs
    from ..parallel import overlap as ov
    from ..parallel.train import (
        AXIS_NAMES,
        TrainConfig,
        init_train_state,
        make_train_step,
        resolve_axis_topos,
        sync_grads,
        tree_leaves,
        tree_map,
    )
    from ..utils.profiling import exposed_split

    refusals = ((cfg.supervised, "supervised=True"),
                (cfg.recorder, "recorder=True"))
    for bad, what in refusals:
        if bad:
            raise NotImplementedError(f"TrainStepBenchConfig {what} is not "
                                      f"ported yet (ROADMAP.md, Queue 1: "
                                      f"'Checkpoint, supervision and "
                                      f"feedback plumbing')")
    dev = resolve_device(cfg.device)
    n = cfg.devices or 8
    mesh = flat_mesh(n, dev, "dp")
    model_cfg = TransformerConfig(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_layers=cfg.n_layers, d_ff=cfg.d_ff, dtype=torch.bfloat16,
        attn_impl="flash")
    state = init_train_state(model_cfg, torch.Generator().manual_seed(0),
                             device=dev)
    n_leaves = len(tree_leaves(state["params"]))
    rng = np.random.default_rng(1)
    toks, tgts = (torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (cfg.batch, cfg.seq_len)).astype(np.int32),
        device=dev) for _ in range(2))
    train_cfgs = {
        "per_leaf": TrainConfig(grad_topo=cfg.topo, bucket_bytes=0),
        "ours_fused": TrainConfig(grad_topo=cfg.topo),
        "ours_chunked": TrainConfig(grad_topo=cfg.topo,
                                    grad_chunks=cfg.chunks),
    }
    # the sync alone, on gradient-shaped data, one tree a rank
    pspecs = param_specs(model_cfg)
    topos = resolve_axis_topos(mesh, AXIS_NAMES, cfg.topo)
    gen = np.random.default_rng(2)
    grads = tree_map(lambda p: torch.as_tensor(gen.standard_normal(
        tuple(p.shape)).astype(np.float32), device=dev), state["params"])
    trees = [tree_map(torch.clone, grads) for _ in range(n)]

    def make_sync(tc):
        return lambda: sync_grads(trees, pspecs, AXIS_NAMES, topos,
                                  bucket_bytes=tc.bucket_bytes,
                                  chunks=tc.grad_chunks, comm=mesh)

    steps = {name: make_train_step(model_cfg, tc, comm=mesh)
             for name, tc in train_cfgs.items()}
    syncs = {name: make_sync(tc) for name, tc in train_cfgs.items()}
    plan = None
    if cfg.overlap:
        tc_ovl = TrainConfig(grad_topo=cfg.topo, overlap=True)
        steps["ours_overlapped"] = make_train_step(model_cfg, tc_ovl,
                                                   comm=mesh)
        steps["ours_overlap_serialized"] = make_train_step(
            model_cfg, tc_ovl, comm=mesh, serialize_overlap=True)
        steps["no_sync"] = make_nosync_train_step(model_cfg, tc_ovl,
                                                  comm=mesh)
        plan = ov.plan_overlap(
            state["params"], pspecs, AXIS_NAMES, topos, {"dp": n},
            n_tokens=cfg.batch // n * cfg.seq_len, t_local=cfg.seq_len,
            d_model=cfg.d_model)
        fired = list(zip(ov.fired_payloads(plan, pspecs),
                         zip(*(ov.fired_payloads(plan, t) for t in trees))))

        def overlap_sync():  # the fired buckets' syncs alone, in order
            return [sync_grads(list(bt), specs, AXIS_NAMES, topos,
                               bucket_bytes=tc_ovl.bucket_bytes,
                               chunks=tc_ovl.grad_chunks, comm=mesh)
                    for specs, bt in fired]

        syncs["ours_overlapped"] = syncs["ours_overlap_serialized"] = \
            overlap_sync
    states_in = {name: state for name in steps}
    shard_bytes = {}
    if cfg.sharded:
        from ..parallel.train import zero_layout_for
        from ..parallel.zero import zero_shard_bytes

        layout = zero_layout_for(mesh, state["params"], pspecs)
        tc_sh = TrainConfig(grad_topo=cfg.topo, shard_optimizer=True)
        for name, tc2 in (("ours_sharded", tc_sh),
                          ("ours_sharded_int8",
                           dataclasses.replace(tc_sh, codec="int8"))):
            steps[name] = make_train_step(model_cfg, tc2, comm=mesh)
            states_in[name] = init_train_state(
                model_cfg, torch.Generator().manual_seed(0), tc2,
                device=dev, comm=mesh)
            # a rank's bytes: its block of each shard buffer (the mesh's
            # state holds every rank's) and the whole replicated tails
            held = sum(t.numel() * t.element_size()
                       // (n if k.endswith("_shard") else 1)
                       for k, tree in states_in[name].items()
                       if k.endswith(("_shard", "_tail"))
                       for t in tree_leaves(tree))
            shard_bytes[name] = dict(zero_shard_bytes(layout,
                                                      tc2.codec != "f32"),
                                     live_bytes_per_rank=held)
    states_out = {name: step(states_in[name], toks, tgts)[0]  # warm-up too
                  for name, step in steps.items()}
    for fn in set(syncs.values()):
        fn()
    identical = True
    for name in states_out:
        if name in ("per_leaf", "no_sync", "ours_sharded_int8"):
            continue  # int8 is lossy: bounded, not bitwise
        same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(tree_leaves(states_out["per_leaf"]
                                               ["params"]),
                                   tree_leaves(states_out[name]["params"])))
        if not same:
            raise RuntimeError(f"{name} train step diverged from per-leaf "
                               f"(bitwise)")
        identical = identical and same
    del states_out
    step_times = _interleaved_times(
        {name: (lambda step=step, st=states_in[name]: step(st, toks, tgts))
         for name, step in steps.items()}, cfg.repeat, dev)
    sync_times = _interleaved_times(
        {name: fn for name, fn in syncs.items()
         if name != "ours_overlap_serialized"}, cfg.repeat, dev)
    if cfg.overlap:
        sync_times["ours_overlap_serialized"] = sync_times["ours_overlapped"]
    rows = {}
    for name, t in step_times.items():
        rows[name] = {"train_step_ms": t["min_ms"],
                      "train_step_avg_ms": t["avg_ms"],
                      "train_step_median_ms": t["median_ms"]}
        if name in syncs:
            rows[name]["sync_ms"] = sync_times[name]["min_ms"]
            rows[name]["compute_ms"] = max(
                t["min_ms"] - sync_times[name]["min_ms"], 0.0)
        if name in syncs or name in shard_bytes:
            rows[name]["vs_per_leaf"] = (step_times["per_leaf"]["min_ms"]
                                         / t["min_ms"])
        if name in shard_bytes:
            rows[name]["opt_state_bytes_ratio"] = shard_bytes[name]["ratio"]
    if cfg.overlap:
        nosync_ms = step_times["no_sync"]["min_ms"]
        # the twin hides nothing, so its exposure is the overlapped step's
        # sync total (the same buckets, the same payloads)
        twin_exposed = max(
            step_times["ours_overlap_serialized"]["min_ms"] - nosync_ms, 0.0)
        for name in syncs:
            total = twin_exposed if name.startswith("ours_overlap") else \
                rows[name]["sync_ms"]
            exp, hid = exposed_split(rows[name]["train_step_ms"], nosync_ms,
                                     total)
            # a zero exposure (fully hidden, or noise crossing zero) must
            # not put Infinity into the report
            rows[name].update(exposed_comm_ms=exp, hidden_comm_ms=hid,
                              exposed_vs_serialized=twin_exposed
                              / max(exp, 0.1))
    return {
        "config": dataclasses.asdict(cfg),
        "num_devices": n,
        "device": _device_info(dev),
        "n_grad_leaves": n_leaves,
        "identical": identical,
        "overlap_plan": None if plan is None else dataclasses.asdict(plan),
        "opt_state_bytes": shard_bytes or None,
        "rows": rows,
    }


def _interleaved_times(calls: dict, repeat: int, device) -> dict:
    """Each variant's min, mean and median ms over ``repeat`` rounds, one
    call of every variant a round in a shuffled order (seeded), so that a
    stretch of contention on a shared host lands on every variant and no
    variant always follows the same one.  ``calls`` maps a name to a
    warm, argument-free function; each call is host-timed to the device's
    end (``torch.cuda.synchronize`` on a card)."""
    import random

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    order = list(calls)
    shuffler = random.Random(0)
    times: dict[str, list[float]] = {name: [] for name in calls}
    for _ in range(repeat):
        shuffler.shuffle(order)
        for name in order:
            sync()
            t0 = time.perf_counter()
            calls[name]()
            sync()
            times[name].append(time.perf_counter() - t0)
    return {
        name: {
            "min_ms": min(ts) * 1e3,
            "avg_ms": sum(ts) / len(ts) * 1e3,
            "median_ms": float(np.median(ts)) * 1e3,
            # round i of every variant ran in the same shuffled round, so
            # callers can pair them
            "times_ms": [t * 1e3 for t in ts],
        }
        for name, ts in times.items()
    }


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
