"""Reduction-op registry: which elementwise reductions the collectives
support, over which dtypes, with NumPy and PyTorch implementations.

A copy of ``flextree_tpu/ops/reduce.py`` (the port imports nothing of the
JAX package): the same op names, dtype matrix and identities, which mirror
the reference's ``handle_reduce`` dispatch (``mpi_mod.hpp:825-874``).  In
place of the JAX module's ``jnp_name`` each op carries :meth:`ReduceOp.fold`,
the plain PyTorch binary fold that the fold kernel's plain version
(:func:`.reduce_stacked.reduce_stacked_plain`) and the collectives' oracles
apply.

:meth:`ReduceOp.fold` gives the bits the kernel gives, for every dtype of
the matrix, on any device:

- floats fold in their own dtype, so float16 and bfloat16 round to the
  storage type after every step (``a + b`` on two bfloat16 tensors), as
  ``jnp.add`` and NumPy do;
- integer sums and products wrap.  PyTorch lacks most kernels for
  uint16/32/64 (``add`` and ``maximum`` on the CPU, ``where`` on CUDA), so
  those fold on the same-width signed view (the same bits) and
  order-compare on the view with the sign bit flipped;
- ``max``/``min`` follow NumPy's rule: ``a`` where ``a > b`` (``a < b``)
  or ``a`` is NaN, else ``b``, so a NaN in either operand propagates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

__all__ = ["ReduceOp", "get_op", "SUPPORTED_OPS", "check_dtype", "dtype_name"]

_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")
_INT_DTYPES = ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64")
_BOOL_DTYPES = ("bool",)

# The reference's MPI_SUM dtype set (mpi_mod.hpp:827-837) translated to TPU
# dtypes; MPI_BAND's integer set (mpi_mod.hpp:851-858) plus bool.
_SUM_DTYPES = _FLOAT_DTYPES + _INT_DTYPES
_BITWISE_DTYPES = _INT_DTYPES + _BOOL_DTYPES
_ORDER_DTYPES = _FLOAT_DTYPES + _INT_DTYPES

# unsigned dtype -> the signed dtype of its width (torch has no add or
# order comparison for uint16/32/64)
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}
_SIGN_BIT = {torch.int16: -(2 ** 15), torch.int32: -(2 ** 31),
             torch.int64: -(2 ** 63)}


def dtype_name(dtype) -> str:
    """The registry's name of a torch or NumPy dtype (``ml_dtypes``'
    bfloat16 included)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if "bfloat16" in str(dtype):
        return "bfloat16"
    return np.dtype(dtype).name


def _signed_view(fold):
    """Fold uint16/32/64 on the same-width signed view, which has the same
    bits: PyTorch lacks most kernels for those dtypes (``add`` and
    ``maximum`` on the CPU, ``where`` on CUDA).  ``fold`` is told whether
    its operands are such a view."""
    def wrapped(a, b):
        signed = _SIGNED_VIEW.get(a.dtype)
        if signed is None:
            return fold(a, b, False)
        return fold(a.view(signed), b.view(signed), True).view(a.dtype)

    return wrapped


def _order(greater: bool):
    def fold(a, b, unsigned):
        ka, kb = a, b
        if unsigned:  # flip the sign bit: the view then orders as unsigned
            ka, kb = a ^ _SIGN_BIT[a.dtype], b ^ _SIGN_BIT[a.dtype]
        take_a = ka > kb if greater else ka < kb
        if a.is_floating_point():
            take_a = take_a | torch.isnan(a)
        return torch.where(take_a, a, b)

    return _signed_view(fold)


def _binary(fn):
    return _signed_view(lambda a, b, unsigned: fn(a, b))


@dataclass(frozen=True)
class ReduceOp:
    """An associative+commutative elementwise reduction.

    ``np_fn`` and :attr:`fold` are binary; collectives fold them over peer
    copies.  ``identity`` is the neutral element used when padding buffers
    so that the padded tail never corrupts real data.
    """

    name: str
    np_fn: Callable[[np.ndarray, np.ndarray], np.ndarray]
    fold: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    dtypes: tuple[str, ...]
    identity: Callable[[np.dtype], object]

    def check_dtype(self, dtype) -> None:
        check_dtype(self, dtype)

    def identity_for(self, dtype) -> object:
        """The identity for a NumPy dtype (a NumPy scalar, as the JAX
        registry gives it) or a torch dtype (a Python scalar, bfloat16's
        computed on float32)."""
        if isinstance(dtype, torch.dtype):
            name = dtype_name(dtype)
            np_dtype = np.float32 if name == "bfloat16" else np.dtype(name)
            return np.asarray(self.identity(np.dtype(np_dtype))).item()
        return self.identity(np.dtype(dtype))


def _all_ones(dt: np.dtype):
    if dt == np.bool_:
        return True
    return dt.type(~dt.type(0))  # all bits set


def _min_value(dt: np.dtype):
    # np.issubdtype is False for ml_dtypes floats (bfloat16 has kind 'V'),
    # so classify by "not integer/bool" rather than "is np.floating".
    if np.issubdtype(dt, np.integer):
        return np.iinfo(dt).min
    return dt.type(-np.inf)


def _max_value(dt: np.dtype):
    if np.issubdtype(dt, np.integer):
        return np.iinfo(dt).max
    return dt.type(np.inf)


SUPPORTED_OPS: dict[str, ReduceOp] = {
    op.name: op
    for op in [
        ReduceOp("sum", np.add, _binary(torch.add), _SUM_DTYPES,
                 lambda dt: dt.type(0)),
        ReduceOp("prod", np.multiply, _binary(torch.mul), _SUM_DTYPES,
                 lambda dt: dt.type(1)),
        ReduceOp("max", np.maximum, _order(True), _ORDER_DTYPES, _min_value),
        ReduceOp("min", np.minimum, _order(False), _ORDER_DTYPES, _max_value),
        ReduceOp("band", np.bitwise_and, _binary(torch.bitwise_and), _BITWISE_DTYPES,
                 _all_ones),
        ReduceOp("bor", np.bitwise_or, _binary(torch.bitwise_or), _BITWISE_DTYPES,
                 lambda dt: dt.type(0)),
        ReduceOp("bxor", np.bitwise_xor, _binary(torch.bitwise_xor), _BITWISE_DTYPES,
                 lambda dt: dt.type(0)),
    ]
}


def get_op(op: "str | ReduceOp") -> ReduceOp:
    """Resolve an op name (or pass through a ReduceOp).  Unknown ops raise,
    mirroring the reference's abort on unsupported MPI ops
    (``mpi_mod.hpp:875-877``)."""
    if isinstance(op, ReduceOp):
        return op
    try:
        return SUPPORTED_OPS[op]
    except KeyError:
        raise ValueError(
            f"unsupported reduce op {op!r}; supported: {sorted(SUPPORTED_OPS)}"
        ) from None


def check_dtype(op: ReduceOp, dtype) -> None:
    """Raise if ``dtype`` (torch or NumPy) is outside the op's supported
    matrix (the analog of the reference's per-dtype dispatch aborting,
    ``mpi_mod.hpp:838-841``)."""
    name = dtype_name(dtype)
    if name not in op.dtypes:
        raise TypeError(f"op {op.name!r} does not support dtype {name}")
