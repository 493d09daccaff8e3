"""Fold a ``(W, L)`` stack of source buffers over its first axis: the
collectives' local reduce.

PyTorch counterpart of ``flextree_tpu/ops/pallas_reduce.py``, the rebuild
of the reference's local reduction kernels ``reduce_sum``/``reduce_band``
(``allreduce_over_mpi/mpi_mod.hpp:246-660``).  Three versions, one
contract:

- :func:`reduce_stacked_reference` — the oracle: the plain left fold
  ``acc = x[0]; acc = op(acc, x[j])``, as the JAX module's
  ``reduce_stacked_reference``;
- :func:`reduce_stacked_plain` — the plain PyTorch version of the kernel:
  sources in groups of ``sources_tile``, each group folded pairwise, the
  groups folded into the accumulator in order, every step through
  :attr:`~.reduce.ReduceOp.fold`;
- :func:`reduce_stacked` — the wrapper every collective of the port calls.
  On a CUDA tensor it launches the hand-written kernel
  ``csrc/reduce_stacked.cu`` (which replaces the Pallas ``_kernel``) or
  raises; on a CPU tensor it computes :func:`reduce_stacked_plain`, the
  only reason it ever does.

All three give the same bits as the JAX ``reduce_stacked`` for every op
and dtype of the registry and every ``sources_tile``; at
``sources_tile=1`` that is also the oracle's.  The JAX knobs ``rows_tile``
and ``interpret`` only tile the TPU's grid and select its interpreter, so
the port drops them: the kernel masks the ragged edge instead of padding
``L`` with the op's identity.
"""

from __future__ import annotations

import math

import torch

from .reduce import ReduceOp, get_op

__all__ = [
    "reduce_stacked",
    "reduce_stacked_plain",
    "reduce_stacked_reference",
    "MAX_SOURCES_TILE",
]

#: Largest ``sources_tile`` (after the gcd clamp) the kernel takes.
MAX_SOURCES_TILE = 32

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
    w = x.shape[0]
    if w == 1:
        return x[0]
    st = _sources_tile(sources_tile, w)
    acc = None
    for g in range(0, w, st):
        vals = [x[g + t] for t in range(st)]
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
