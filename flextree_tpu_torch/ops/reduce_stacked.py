"""Fold W source buffers into one, elementwise: the collectives' local
reduce.

PyTorch counterpart of ``flextree_tpu/ops/pallas_reduce.py``, the rebuild
of the reference's local reduction kernels ``reduce_sum``/``reduce_band``
(``allreduce_over_mpi/mpi_mod.hpp:246-660``).  Two interfaces over one
hand-written kernel, ``csrc/reduce_stacked.cu`` (which replaces the
Pallas ``_kernel``):

- a ``(W, L)`` stack folded over its first axis, the JAX function's
  interface: :func:`reduce_stacked_reference` (the oracle: the plain left
  fold ``acc = x[0]; acc = op(acc, x[j])``, as the JAX module's
  ``reduce_stacked_reference``), :func:`reduce_stacked_plain` (the
  kernel's arithmetic in plain PyTorch: sources in groups of
  ``sources_tile``, each group folded pairwise, the groups folded into the
  accumulator in order, every step through :attr:`~.reduce.ReduceOp.fold`)
  and :func:`reduce_stacked` (the wrapper);
- a batch of folds, each over W tensors that lie where they lie, the
  collectives' interface: :func:`reduce_sources_plain` and
  :func:`reduce_sources`, which folds a whole stage of the allreduce in one
  launch and never builds a stack.

Each wrapper, on a CUDA tensor, launches the kernel or raises; on a CPU
tensor it computes its plain version, the only reason it ever does.  All
give the same bits as the JAX ``reduce_stacked`` on the same sources
stacked in the same order, for every op and dtype of the registry and
every ``sources_tile``; at ``sources_tile=1`` that is also the oracle's.
The JAX knobs ``rows_tile`` and ``interpret`` only tile the TPU's grid and
select its interpreter, so the port drops them: the kernel masks the
ragged edge instead of padding ``L`` with the op's identity.
"""

from __future__ import annotations

import ctypes
import math
from bisect import bisect_right

import torch

from .reduce import ReduceOp, get_op

__all__ = [
    "reduce_stacked",
    "reduce_stacked_plain",
    "reduce_stacked_reference",
    "reduce_sources",
    "reduce_sources_plain",
    "MAX_SOURCES_TILE",
    "MAX_POINTERS",
]

#: Largest ``sources_tile`` (after the gcd clamp) the kernel takes.
MAX_SOURCES_TILE = 32
#: Pointers one launch of :func:`reduce_sources` carries, R·W sources plus
#: R outputs (the kernel's ``kMaxPointers``): a batch of R folds of W
#: sources takes ``ceil(R / (MAX_POINTERS // (W + 1)))`` launches.
MAX_POINTERS = 496

_KERNEL_DTYPES = {
    torch.float16: 0, torch.bfloat16: 1, torch.float32: 2, torch.float64: 3,
    torch.int8: 4, torch.int16: 5, torch.int32: 6, torch.int64: 7,
    torch.uint8: 8, torch.uint16: 9, torch.uint32: 10, torch.uint64: 11,
    torch.bool: 12,
}
_KERNEL_OPS = {"sum": 0, "prod": 1, "max": 2, "min": 3, "band": 4, "bor": 5,
               "bxor": 6}


def _check(x: torch.Tensor, op) -> ReduceOp:
    rop = get_op(op)
    rop.check_dtype(x.dtype)
    if x.dim() != 2:
        raise ValueError(f"expected (num_sources, length), got {tuple(x.shape)}")
    return rop


def _sources_tile(sources_tile, w: int) -> int:
    """``sources_tile`` clamped to ``gcd(sources_tile, W)`` (0 or None
    mean 1), as the JAX kernel clamps it."""
    return math.gcd(int(sources_tile), w) if sources_tile else 1


def reduce_stacked_reference(x: torch.Tensor, op="sum") -> torch.Tensor:
    """Plain oracle: fold ``x[(W, L)]`` over axis 0 with ``op``, left to
    right."""
    rop = get_op(op)
    acc = x[0]
    for j in range(1, x.shape[0]):
        acc = rop.fold(acc, x[j])
    return acc


def reduce_stacked_plain(x: torch.Tensor, op="sum",
                         sources_tile: int = 1) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: for each group of
    ``sources_tile`` sources, fold adjacent pairs level by level (an odd
    last one carried up), then fold the group's value into the
    accumulator — the JAX ``_kernel``'s order (``pallas_reduce.py:46-60``)."""
    rop = _check(x, op)
    return _fold(list(x.unbind(0)), rop, _sources_tile(sources_tile,
                                                        x.shape[0]))


def _fold(sources: list, rop: ReduceOp, st: int) -> torch.Tensor:
    """One fold in the kernel's order; ``st`` already clamped.  One source
    is returned as it is."""
    acc = None
    for g in range(0, len(sources), st):
        vals = sources[g:g + st]
        while len(vals) > 1:
            vals = [rop.fold(vals[t], vals[t + 1]) if t + 1 < len(vals)
                    else vals[t] for t in range(0, len(vals), 2)]
        acc = vals[0] if acc is None else rop.fold(acc, vals[0])
    return acc


def _launch(x: torch.Tensor, rop: ReduceOp, st: int, out):
    """Validate what the kernel takes and launch ``csrc/reduce_stacked.cu``
    on the current stream, into ``out`` or a new tensor."""
    from ..kernels import load

    w, length = x.shape
    if st > MAX_SOURCES_TILE:
        raise ValueError(f"reduce_stacked kernel takes sources_tile <= "
                         f"{MAX_SOURCES_TILE} (after the gcd clamp), got {st}")
    if not x.is_contiguous():
        raise ValueError("reduce_stacked kernel needs a contiguous (W, L) stack")
    if out is None:
        out = torch.empty(length, dtype=x.dtype, device=x.device)
    if length == 0:
        return out
    fn = load("reduce_stacked").ft_reduce_stacked
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), w, length, st,
                _KERNEL_DTYPES[x.dtype], _KERNEL_OPS[rop.name], stream)
    if rc != 0:
        raise RuntimeError(f"reduce_stacked kernel launch failed: CUDA error {rc}")
    reduce_stacked.launches += 1
    return out


def reduce_stacked(x: torch.Tensor, op="sum", sources_tile: int = 1, *,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Reduce ``x`` of shape ``(W, L)`` over axis 0 -> ``(L,)``.

    ``sources_tile`` folds that many sources pairwise before they meet the
    accumulator; it is clamped to ``gcd(sources_tile, W)`` so any W stays
    valid.  It changes the fold order of float sums and products (exact for
    the bitwise and lattice ops); the collectives call it with 1, a plain
    left fold.  ``W == 1`` returns ``x[0]``.  ``out``, when given, is a
    contiguous ``(L,)`` tensor of ``x``'s dtype and device that receives
    the result (the ring writes a step's fold straight into its buffer).

    On a CUDA tensor it launches the kernel and counts the launch in
    ``reduce_stacked.launches``; on a CPU tensor it computes
    :func:`reduce_stacked_plain`.
    """
    rop = _check(x, op)
    w, length = x.shape
    if out is not None and (out.shape != (length,) or out.dtype != x.dtype
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError(
            f"out must be a contiguous ({length},) {x.dtype} tensor on "
            f"{x.device}, got {tuple(out.shape)} {out.dtype} on {out.device}")
    if w == 1:
        return x[0] if out is None else out.copy_(x[0])
    st = _sources_tile(sources_tile, w)
    if x.device.type == "cpu":
        res = reduce_stacked_plain(x, rop, st)
        return res if out is None else out.copy_(res)
    if x.device.type != "cuda":
        raise ValueError(f"reduce_stacked kernel runs on CUDA tensors, got "
                         f"{x.device}")
    return _launch(x, rop, st, out)


#: Kernel launches since the count was last reset (set it to 0 to reset).
reduce_stacked.launches = 0


# ------------------------------------------------- a batch of W-pointer folds


def _span(t: torch.Tensor) -> tuple[int, int]:
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors on one device share any byte."""
    (alo, ahi), (blo, bhi) = _span(a), _span(b)
    return alo < bhi and blo < ahi


def _check_aliasing(folds) -> None:
    """Refuse any overlap the kernel cannot fold through: outputs that
    overlap each other, an output that overlaps a source of another fold,
    or one of its own sources other than being exactly its source 0 (the
    in-place fold)."""
    outs = sorted((_span(out), f) for f, (_, out) in enumerate(folds))
    for ((_, ahi), f), ((blo, _), g) in zip(outs, outs[1:]):
        if blo < ahi:
            raise ValueError(f"the outputs of folds {f} and {g} overlap")
    starts = [lo for (lo, _), _ in outs]
    for f, (sources, _) in enumerate(folds):
        for j, src in enumerate(sources):
            lo, hi = _span(src)
            k = max(bisect_right(starts, lo) - 1, 0)
            while k < len(outs) and outs[k][0][0] < hi:
                (olo, ohi), g = outs[k]
                k += 1
                if not (olo < hi and lo < ohi):
                    continue
                if g != f:
                    raise ValueError(f"the output of fold {g} overlaps "
                                     f"source {j} of fold {f}")
                if olo != lo:
                    raise ValueError(f"the output of fold {f} partly "
                                     f"overlaps its source {j}")
                if j != 0:
                    raise ValueError(f"the output of fold {f} is its source "
                                     f"{j}: only source 0 may be the output")


def _check_folds(folds, op) -> tuple[list, ReduceOp]:
    """Validate a batch: every fold has the same number of sources, every
    tensor contiguous with the first output's length and dtype and on its
    fold's output's device, all outputs on one device, the dtype in the
    op's matrix and no refused aliasing.  Returns ``[(sources, out)]``."""
    folds = [(list(sources), out) for sources, out in folds]
    if not folds:
        raise ValueError("reduce_sources needs at least one fold")
    rop = get_op(op)
    w = len(folds[0][0])
    first = folds[0][1]
    length, dtype = first.numel(), first.dtype
    rop.check_dtype(dtype)
    if w < 1:
        raise ValueError("a fold needs at least one source")
    for f, (sources, out) in enumerate(folds):
        if len(sources) != w:
            raise ValueError(f"fold {f} has {len(sources)} sources, fold 0 "
                             f"{w}: a batch shares W")
        if out.device != first.device:
            raise ValueError(f"fold {f}'s output is on {out.device}, fold "
                             f"0's on {first.device}")
        for t in (*sources, out):
            if t.device != out.device:
                raise ValueError(f"fold {f} has a source on {t.device} and "
                                 f"its output on {out.device}")
            if t.dtype != dtype or t.numel() != length or \
                    not t.is_contiguous():
                raise ValueError(
                    f"fold {f}: every source and output must be a contiguous "
                    f"{dtype} tensor of {length} elements, got "
                    f"{tuple(t.shape)} {t.dtype}")
    if length:
        _check_aliasing(folds)
    return folds, rop


def reduce_sources_plain(folds, op="sum", sources_tile: int = 1) -> list:
    """The kernel's arithmetic on a batch, in plain PyTorch: for each
    ``(sources, out)`` of ``folds``, the fold of ``sources`` in the order
    :func:`reduce_stacked_plain` takes on them stacked, computed from the
    tensors where they lie (no stack is built).  Returns the results and
    writes no ``out``; one source is returned as it is."""
    rop = get_op(op)
    res = []
    for sources, _ in folds:
        sources = list(sources)
        res.append(_fold(sources, rop, _sources_tile(sources_tile,
                                                     len(sources))))
    return res


def reduce_sources(folds, op="sum", sources_tile: int = 1) -> list:
    """Fold a batch: for each ``(sources, out)`` of ``folds``, ``out``
    receives the fold of the W tensors ``sources`` in order, as
    :func:`reduce_stacked` folds them stacked (``sources_tile`` clamped to
    ``gcd(sources_tile, W)``).  Returns the outputs.

    The folds share W, the length, the dtype and the output device; each
    tensor is contiguous (any shape, read flat) and lies on its fold's
    output's device — moving a source across devices is the caller's job.
    An output may be exactly its fold's source 0 (folding in place); any
    other overlap of an output with a source, or of two outputs, raises
    ``ValueError``.

    On CUDA tensors it launches ``csrc/reduce_stacked.cu``'s
    ``ft_reduce_sources``, every fold of the batch in one launch (more when
    ``len(folds)·(W + 1)`` exceeds :data:`MAX_POINTERS`), and counts each
    launch in ``reduce_sources.launches``.  On CPU tensors it computes
    :func:`reduce_sources_plain` and writes the results.
    """
    folds, rop = _check_folds(folds, op)
    w = len(folds[0][0])
    st = _sources_tile(sources_tile, w)
    outs = [out for _, out in folds]
    dev = outs[0].device
    if dev.type == "cpu":
        for out, res in zip(outs, reduce_sources_plain(folds, rop, st)):
            if res.data_ptr() != out.data_ptr():
                out.view(-1).copy_(res.view(-1))
        return outs
    if dev.type != "cuda":
        raise ValueError(f"reduce_sources kernel runs on CUDA tensors, got "
                         f"{dev}")
    if st > MAX_SOURCES_TILE:
        raise ValueError(f"reduce_sources kernel takes sources_tile <= "
                         f"{MAX_SOURCES_TILE} (after the gcd clamp), got {st}")
    per = MAX_POINTERS // (w + 1)
    if per == 0:
        raise ValueError(f"a fold of {w} sources needs more than "
                         f"{MAX_POINTERS} kernel pointers")
    length = outs[0].numel()
    if length == 0:
        return outs
    from ..kernels import load

    fn = load("reduce_stacked").ft_reduce_sources
    dtype, opcode = _KERNEL_DTYPES[outs[0].dtype], _KERNEL_OPS[rop.name]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b in range(0, len(folds), per):
            batch = folds[b:b + per]
            srcs = (ctypes.c_void_p * (len(batch) * w))(
                *[t.data_ptr() for sources, _ in batch for t in sources])
            dsts = (ctypes.c_void_p * len(batch))(
                *[out.data_ptr() for _, out in batch])
            rc = fn(srcs, dsts, len(batch), w, length, st, dtype, opcode,
                    stream)
            if rc != 0:
                raise RuntimeError(f"reduce_sources kernel launch failed: "
                                   f"CUDA error {rc}")
            reduce_sources.launches += 1
    return outs


#: Kernel launches since the count was last reset (set it to 0 to reset).
reduce_sources.launches = 0
