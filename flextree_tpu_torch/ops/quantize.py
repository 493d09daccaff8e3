"""Wire codecs for the compressed collectives: what the bytes on the wire are.

The port's copy of ``flextree_tpu/ops/quantize.py`` (the port imports
nothing of the JAX package), on tensors.  The per-hop use of a codec inside
the tree, ring and lonely schedules is ``parallel/compressed.py``.

Codecs:

- ``f32`` — the identity: the collectives move the bytes as they are.
- ``bf16`` — the payload cast to bfloat16, carried and summed in bfloat16
  (the fold kernel's bf16 sum).  Ratio 0.5.
- ``int8`` — block-scaled 8-bit: each ``block`` run of elements shares one
  f32 scale ``amax / 127``, and each value is rounded stochastically,
  ``q = floor(x / scale + u)``, with ``u`` an integer hash of (element
  index, step, salt): no random generator, no host entropy, and the same
  (shape, step, salt) gives the same bits on every device.  Wire payload:
  int8 plus one f32 scale a block, ratio ``0.25 + 4 / (4 * block)``.

The contract with the JAX module is bitwise: the same ``(v, step, salt,
block)`` gives the same ``q`` and ``scales``.  ``_uniform01`` is uint32
arithmetic, done here in int64 with the low 32 bits kept after every
multiply (the products stay below 2**63), so it is exact on every backend;
the division ``x / scale`` divides by a tensor, never by a Python scalar
(PyTorch's CUDA division by a host scalar multiplies by its reciprocal,
which is not the division).

Error bound (``Codec.error_bound``): one encode of a buffer bounded by
``A`` errs by less than one step, ``A / 127``, per element; an allreduce
over ``n`` ranks quantizes partial sums bounded by ``n * amax`` once a hop
on the accumulation path, so ``|result - exact| <= hops * n * amax / 127``
(int8) or ``hops * n * amax * 2**-8`` (bf16), with ``hops`` from
:meth:`Codec.hops_for`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = [
    "Codec",
    "CODECS",
    "get_codec",
    "encode_int8",
    "decode_int8",
    "DEFAULT_BLOCK",
]

#: Elements sharing one int8 scale (the JAX package's default).
DEFAULT_BLOCK = 1024

_MASK = 0xFFFFFFFF


def _uniform01(n: int, step, salt: int, device=None) -> torch.Tensor:
    """Deterministic uniforms in [0, 1), one an element: the JAX module's
    uint32 bit-mix of (element index, step, salt), bit for bit.  ``step``
    is an int or a 0-d integer tensor, taken as int32 and then uint32."""
    s = int(step) & _MASK
    c = (s * 0x85EBCA6B + ((salt * 0xC2B2AE35) & _MASK)) & _MASK
    k = (torch.arange(n, dtype=torch.int64, device=device) * 0x9E3779B9) & _MASK
    k ^= c
    k ^= k >> 15
    k = (k * 0x2C1B3C6D) & _MASK
    k ^= k >> 12
    k = (k * 0x297A2D39) & _MASK
    k ^= k >> 15
    return (k >> 8).to(torch.float32) * 2.0 ** -24


def _pad_to_block(v: torch.Tensor, block: int) -> torch.Tensor:
    """``v`` with zeros appended to its last axis up to a multiple of
    ``block``: each row pads on its own."""
    pad = (-v.shape[-1]) % block
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    return v


def _quantize(v: torch.Tensor, u: torch.Tensor, block: int):
    """The encode of a block-padded ``v`` given its uniforms ``u`` (one an
    element of ``v``): JAX's ops in JAX's order."""
    b = v.reshape(v.shape[:-1] + (-1, block))
    amax = b.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        amax.new_ones(()))
    q = torch.floor(b / scale[..., None] + u.view(b.shape))
    return q.clamp_(-127, 127).to(torch.int8).view(v.shape), scale


def encode_int8(v: torch.Tensor, step=0, *, salt: int = 0,
                block: int = DEFAULT_BLOCK):
    """Block-scaled int8 encode of ``v`` (..., L) along the last axis.

    Returns ``(q, scales)``: ``q`` int8 of shape (..., ceil(L/B)*B) and
    ``scales`` f32 of shape (..., ceil(L/B)).  Each row pads to a multiple
    of ``block`` and the hash index runs over the padded (..., L') layout,
    so a batch of rows is not the rows encoded one at a time.  The pad
    (zeros) quantizes to 0 exactly."""
    v = _pad_to_block(v, block)
    return _quantize(v, _uniform01(v.numel(), step, salt, v.device), block)


def decode_int8(q: torch.Tensor, scales: torch.Tensor,
                length: int | None = None, *, block: int = DEFAULT_BLOCK):
    """Inverse of :func:`encode_int8`; ``length`` slices the block pad off
    the last axis (None keeps the padded length)."""
    b = q.reshape(q.shape[:-1] + (-1, block)).to(torch.float32)
    out = (b * scales[..., None]).reshape(q.shape)
    if length is not None and length != out.shape[-1]:
        out = out[..., :length]
    return out


@dataclass(frozen=True)
class Codec:
    """One wire format for the compressed collectives.

    ``wire_ratio`` is payload wire bytes per f32 input byte (scales
    included for int8), the factor the cost model puts on the bandwidth
    term.  ``hop_cost`` marks codecs that pay an encode/decode pass a hop
    (priced by ``TpuCostParams.codec_bw_GBps``)."""

    name: str
    wire_ratio: float
    lossy: bool
    hop_cost: bool
    block: int = DEFAULT_BLOCK

    def roundtrip(self, x: torch.Tensor, step=0, *, salt: int = 0):
        """The local lossy map ``C(x)``, decode(encode(x)) of the flat
        buffer: the error-feedback residual's reference ``e' = v - C(v)``.
        A block-aligned tree's stage-0 encode is exactly this map (salt 0)."""
        if not self.lossy:
            return x
        if self.name == "bf16":
            return x.to(torch.bfloat16).to(x.dtype)
        v = x.reshape(-1).to(torch.float32)
        q, s = encode_int8(v, step, salt=salt, block=self.block)
        return decode_int8(q, s, v.shape[0], block=self.block) \
            .reshape(x.shape).to(x.dtype)

    def wire_bytes(self, n_elems: int) -> int:
        """Exact payload bytes this codec puts on the wire for ``n_elems``
        f32 elements (int8: the padded payload and one f32 scale a
        block)."""
        n = max(int(n_elems), 0)
        if self.name == "f32":
            return 4 * n
        if self.name == "bf16":
            return 2 * n
        blocks = -(-n // self.block) if n else 0
        return blocks * self.block + 4 * blocks

    def hops_for(self, n: int, widths, lonely: int = 0) -> int:
        """Encode events on the accumulation path of one allreduce: a tree
        re-encodes at each phase-1 stage and once for phase 2; the ring at
        each fold step and once for phase 2; a lonely shape pays the buddy
        fold, both phases' stages and the restore."""
        if widths is not None and tuple(widths) == (1,):
            return max(n, 1)
        k = len(tuple(widths)) if widths is not None else 1
        if lonely:
            return 2 * k + 2
        return k + 1

    def error_bound(self, amax: float, n: int, widths=None,
                    lonely: int = 0) -> float:
        """Per-element absolute error bound of one allreduce over ``n``
        ranks of data with per-rank max |x| <= ``amax``; 0 for the
        identity."""
        if not self.lossy:
            return 0.0
        hops = self.hops_for(n, widths, lonely)
        step_size = 1.0 / 127.0 if self.name == "int8" else 2.0 ** -8
        return hops * n * float(amax) * step_size


CODECS: dict[str, Codec] = {
    "f32": Codec("f32", wire_ratio=1.0, lossy=False, hop_cost=False),
    "bf16": Codec("bf16", wire_ratio=0.5, lossy=True, hop_cost=False),
    "int8": Codec("int8", wire_ratio=0.25 + 4.0 / (4.0 * DEFAULT_BLOCK),
                  lossy=True, hop_cost=True),
}


def get_codec(codec) -> Codec:
    """Resolve a codec name (or pass a :class:`Codec` through; None is
    ``f32``).  An unknown name raises ``ValueError``."""
    if isinstance(codec, Codec):
        return codec
    if codec is None:
        return CODECS["f32"]
    try:
        return CODECS[codec]
    except KeyError:
        raise ValueError(
            f"unsupported codec {codec!r}; supported: {sorted(CODECS)}"
        ) from None
