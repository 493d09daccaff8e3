"""Paged/blocked KV cache: ragged sequences share one fixed-shape pool.

PyTorch counterpart of ``flextree_tpu/serving/kv_cache.py``:

- the pool is per layer ``(num_blocks, block_size, H, Dh)`` in the compute
  dtype, one shape for the server's lifetime;
- each sequence owns a **block table** (a row of block ids): block ``p``
  of the table holds cache positions ``p*block_size ..``;
- a host-side :class:`BlockAllocator` (LIFO free list with per-block
  reference counts for prefix sharing) hands blocks out and takes them
  back.

Block id 0 is the **null block**: never allocated, it pads every table row
past the sequence's blocks, and inactive slots write into it.  Whatever it
holds lies past every causal bound, where attention gives it weight
exactly 0.0.

Where JAX donates the pool buffers to a jitted step and gets new ones
back, the port **updates the pools in place** (index assignment into the
tensors in ``pools``) and the write functions return the same dict.  Every
tensor handed to the host (a swap-out) is a copy, never a view of the
pool.

The decode step has two attention paths behind ``fused=``: the gather
oracle (``ops.paged_attention.paged_attention_gather``, the path that
reproduces the contiguous-cache ``generate``) and the streamed path
(``ops.paged_attention.paged_attention``: the CUDA kernel on the card,
the plain stream on the CPU), within ``FUSED_DECODE_ATOL`` of the oracle.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.generate import _qkv
from ..models.transformer import (
    TransformerConfig,
    apply_rope,
    final_logits,
    mlp_block,
    rms_norm,
)
from ..ops.paged_attention import paged_attention, paged_attention_gather

__all__ = [
    "NULL_BLOCK",
    "CacheExhausted",
    "PagedCacheConfig",
    "BlockAllocator",
    "init_pools",
    "write_prefill",
    "write_prefill_at",
    "write_swapped",
    "export_blocks",
    "write_imported",
    "paged_decode_step",
    "make_paged_decode_fn",
    "gather_seq",
]

#: Block id 0 is reserved: it pads table rows and is never allocated.
NULL_BLOCK = 0


class CacheExhausted(RuntimeError):
    """The allocator cannot satisfy a reservation — the admission layer's
    signal to keep the request queued."""

    code = "FT_CACHE_EXHAUSTED"

    def __init__(self, want: int, free: int):
        self.want, self.free = want, free
        super().__init__(f"{self.code}: need {want} cache blocks, {free} free")


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Shape of the paged pool.  ``num_blocks`` counts the null block, so
    ``num_blocks - 1`` are allocatable; ``blocks_per_seq`` is the block
    table width P — the longest admissible sequence is ``max_len =
    block_size * blocks_per_seq`` tokens (prompt + generated)."""

    num_blocks: int
    block_size: int = 16
    blocks_per_seq: int = 8

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is reserved)")
        if self.block_size < 1 or self.blocks_per_seq < 1:
            raise ValueError("block_size and blocks_per_seq must be >= 1")

    @property
    def max_len(self) -> int:
        return self.block_size * self.blocks_per_seq

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` cache positions."""
        return -(-tokens // self.block_size)


class BlockAllocator:
    """Host-side LIFO free list over block ids ``1..num_blocks-1``, with
    per-block reference counts for cross-request prefix sharing.

    ``alloc`` hands blocks out at refcount 1; ``retain`` adds a holder;
    ``release`` drops one and returns the block to the free list at 0;
    ``free`` is for exclusively held blocks and is loud on a shared one;
    ``fork_block`` allocates the private twin of a shared block
    (copy-on-write).  Double frees and foreign ids are loud errors — a
    block handed to two sequences would corrupt both."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is reserved)")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))  # pop() yields 1 first
        self._allocated: set[int] = set()
        self._refcount: dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        """Current holder count (0 for free / never-allocated ids)."""
        return self._refcount.get(block, 0)

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` blocks or raise :class:`CacheExhausted` (taking
        nothing — admission is all-or-nothing per request)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            raise CacheExhausted(n, len(self._free))
        out = [self._free.pop() for _ in range(n)]
        self._allocated.update(out)
        for b in out:
            self._refcount[b] = 1
        return out

    def retain(self, blocks) -> None:
        """Add one holder to each block (all must be allocated)."""
        blocks = list(blocks)
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(f"cannot retain block {b}: not allocated")
        for b in blocks:
            self._refcount[b] += 1

    def release(self, blocks) -> None:
        """Drop one holder from each block; a block returns to the free
        list only when its refcount reaches 0."""
        blocks = list(blocks)
        if len(set(blocks)) != len(blocks):
            raise ValueError(f"duplicate block ids in release(): {blocks}")
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(
                    f"block {b} is not allocated (double release or "
                    f"foreign id)"
                )
        for b in blocks:
            self._refcount[b] -= 1
            if self._refcount[b] == 0:
                del self._refcount[b]
                self._allocated.remove(b)
                self._free.append(b)

    def free(self, blocks) -> None:
        """Return exclusively held blocks to the free list.  Loud on
        duplicates, foreign ids and shared blocks."""
        blocks = list(blocks)
        if len(set(blocks)) != len(blocks):
            raise ValueError(f"duplicate block ids in free(): {blocks}")
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(
                    f"block {b} is not allocated (double free or foreign id)"
                )
            if self._refcount[b] != 1:
                raise ValueError(
                    f"block {b} is shared (refcount "
                    f"{self._refcount[b]}); use release(), not free()"
                )
        for b in blocks:
            del self._refcount[b]
            self._allocated.remove(b)
            self._free.append(b)

    def fork_block(self, src: int) -> int:
        """Copy-on-write fork: allocate a private twin for SHARED block
        ``src``; the caller fills it and releases its hold on ``src``."""
        if src not in self._allocated:
            raise ValueError(f"cannot fork block {src}: not allocated")
        if self._refcount[src] < 2:
            raise ValueError(
                f"cannot fork block {src}: refcount "
                f"{self._refcount[src]} (not shared — write in place)"
            )
        return self.alloc(1)[0]


def init_pools(cfg: TransformerConfig, pcfg: PagedCacheConfig,
               device) -> dict:
    """Per-layer (num_blocks, block_size, H, Dh) K/V pools, zeros in the
    compute dtype on ``device``."""
    shape = (pcfg.num_blocks, pcfg.block_size, cfg.n_heads, cfg.head_dim)
    return {
        kind: [torch.zeros(shape, dtype=cfg.dtype, device=device)
               for _ in range(cfg.n_layers)]
        for kind in ("k", "v")
    }


def _block_index(block_ids, device) -> torch.Tensor:
    return torch.as_tensor(block_ids, dtype=torch.long).to(device)


def write_prefill(pools: dict, cache: dict, block_ids) -> dict:
    """Scatter a single-sequence contiguous prefill cache into the pool,
    in place: its first ``len(block_ids) * block_size`` positions land in
    ``block_ids`` in order (positions past the prompt carry the cache's
    zeros, which decode writes later fill)."""
    n = len(block_ids)
    for pk, pv, kc, vc in zip(pools["k"], pools["v"], cache["k"], cache["v"]):
        bs = pk.shape[1]
        if kc.shape[1] < n * bs:
            raise ValueError(
                f"prefill cache holds {kc.shape[1]} positions, "
                f"{n} blocks need {n * bs}"
            )
        idx = _block_index(block_ids, pk.device)
        pk[idx] = kc[0, : n * bs].reshape(n, bs, *pk.shape[2:])
        pv[idx] = vc[0, : n * bs].reshape(n, bs, *pv.shape[2:])
    return pools


def write_prefill_at(pools: dict, cache: dict, block_ids,
                     start_block: int) -> dict:
    """Scatter a prefill cache's positions from ``start_block * bs`` on
    into ``block_ids``, in place — the suffix half of a prefix-cache hit:
    the blocks below ``start_block`` are cached (maybe shared) and never
    rewritten."""
    n = len(block_ids)
    if start_block < 0:
        raise ValueError(f"start_block must be >= 0, got {start_block}")
    for pk, pv, kc, vc in zip(pools["k"], pools["v"], cache["k"], cache["v"]):
        bs = pk.shape[1]
        s0 = start_block * bs
        if kc.shape[1] < s0 + n * bs:
            raise ValueError(
                f"prefill cache holds {kc.shape[1]} positions, blocks "
                f"{start_block}..{start_block + n} need {s0 + n * bs}"
            )
        idx = _block_index(block_ids, pk.device)
        pk[idx] = kc[0, s0 : s0 + n * bs].reshape(n, bs, *pk.shape[2:])
        pv[idx] = vc[0, s0 : s0 + n * bs].reshape(n, bs, *pv.shape[2:])
    return pools


def write_swapped(pools: dict, kv: dict, block_ids) -> dict:
    """Scatter a swapped-out sequence's saved K/V back into newly assigned
    blocks, in place — the resume half of preemption.  ``kv`` is per layer
    ``{"k": [(n*bs, H, Dh)], "v": [...]}``, exactly ``len(block_ids) *
    block_size`` positions (zero-padded past the saved length, which lies
    past the causal bound)."""
    n = len(block_ids)
    for pk, pv, k, v in zip(pools["k"], pools["v"], kv["k"], kv["v"]):
        bs = pk.shape[1]
        if k.shape[0] != n * bs:
            raise ValueError(
                f"swapped K/V holds {k.shape[0]} positions, "
                f"{n} blocks need {n * bs}"
            )
        idx = _block_index(block_ids, pk.device)
        pk[idx] = k.reshape(n, bs, *pk.shape[2:]).to(pk.device, pk.dtype)
        pv[idx] = v.reshape(n, bs, *pv.shape[2:]).to(pv.device, pv.dtype)
    return pools


def export_blocks(pools: dict, block_ids) -> dict:
    """Pull a sequence's blocks out of the pool at block granularity —
    per layer ``(n, bs, H, Dh)`` — for migration to another replica.

    Not :func:`gather_seq`: no ``(n*bs, H, Dh)`` row is made.  The wire
    payload ships blocks exactly as the pool stores them, and the
    importing side scatters the same block-shaped tensors straight back
    with :func:`write_imported`, so the f32 codec moves the pool's bytes
    verbatim.  A copy on the pools' device, never a view of them."""
    out = {"k": [], "v": []}
    for pk, pv in zip(pools["k"], pools["v"]):
        idx = _block_index(block_ids, pk.device)
        out["k"].append(pk[idx])
        out["v"].append(pv[idx])
    return out


def write_imported(pools: dict, kv: dict, block_ids) -> dict:
    """Scatter migrated block-shaped K/V into newly assigned blocks, in
    place — the receiving half of :func:`export_blocks`.

    ``kv`` is per layer ``{"k": [(n, bs, H, Dh)], "v": [...]}`` with
    exactly ``len(block_ids)`` blocks, on any device and in any float
    dtype: each tensor is cast to the pool's dtype on the pool's device
    (a float32 payload of a bfloat16 pool casts back losslessly).
    Positions in the final block past the migrated sequence's length lie
    at or beyond its causal bound, invisible until decode writes
    overwrite them.  Blocks not named are untouched."""
    n = len(block_ids)
    for pk, k in zip(pools["k"] + pools["v"], kv["k"] + kv["v"]):
        if k.shape[0] != n or tuple(k.shape[1:]) != tuple(pk.shape[1:]):
            raise ValueError(
                f"imported K/V shaped {tuple(k.shape)}, "
                f"{n} blocks of {tuple(pk.shape[1:])} expected"
            )
    for pk, pv, k, v in zip(pools["k"], pools["v"], kv["k"], kv["v"]):
        idx = _block_index(block_ids, pk.device)
        pk[idx] = k.to(pk.device, pk.dtype)
        pv[idx] = v.to(pv.device, pv.dtype)
    return pools


def paged_decode_step(params, pools, tables, lengths, tokens,
                      cfg: TransformerConfig, fused: bool = False,
                      impl: str = "cuda"):
    """One decode step for S slots over the paged pool.

    ``tables`` (S, P) int32 block tables, ``lengths`` (S,) int32 cache
    positions already filled per slot, ``tokens`` (S,) the token to decode
    at each slot's position, all on the pools' device.  Returns (S, vocab)
    float32 next-position logits; each slot's new K/V is written in place
    at ``(tables[s, lengths[s]//bs], lengths[s] % bs)``.

    Inactive slots carry all-``NULL_BLOCK`` table rows and length 0: their
    writes land in the null block and their logits are discarded.
    ``fused=False`` attends through the gather oracle; ``fused=True``
    through ``paged_attention(impl=impl)`` — the CUDA kernel on the card.
    """
    s = tokens.shape[0]
    lengths_l = lengths.long()
    positions = lengths_l[:, None]  # (S, 1) per sequence
    bs = pools["k"][0].shape[1]
    rows = torch.arange(s, device=tokens.device)
    blk = tables.long()[rows, lengths_l // bs]  # (S,) current block per slot
    off = lengths_l % bs
    x = params["embed"][tokens.long()[:, None]].to(cfg.dtype)
    for layer, pk, pv in zip(params["layers"], pools["k"], pools["v"]):
        h = rms_norm(x, layer["ln1"])
        q, k, v = _qkv(layer, h, cfg)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if fused:
            attn = paged_attention(q[:, 0], k[:, 0], v[:, 0], pk, pv, tables,
                                   lengths, impl=impl)
        else:
            attn = paged_attention_gather(q[:, 0], k[:, 0], v[:, 0], pk, pv,
                                          tables, lengths)
        x = x + attn.reshape(s, 1, -1) @ layer["wo"].to(cfg.dtype)
        x = mlp_block(layer, x, cfg)
        # the appended K/V goes into each row's current block, after the
        # attention read (which took it from k/v directly)
        pk[blk, off] = k[:, 0]
        pv[blk, off] = v[:, 0]
    return final_logits(params["embed"], params["ln_f"], x)[:, 0]


def make_paged_decode_fn(cfg: TransformerConfig, fused: bool = False,
                         impl: str = "cuda"):
    """``paged_decode_step`` bound to a config and attention path:
    ``fn(params, pools, tables, lengths, tokens) -> logits``, the pools
    updated in place."""

    def decode(params, pools, tables, lengths, tokens):
        return paged_decode_step(params, pools, tables, lengths, tokens, cfg,
                                 fused=fused, impl=impl)

    return decode


def gather_seq(pools: dict, block_ids, length: int | None = None) -> dict:
    """One sequence's contiguous K/V — per layer (n_blocks*bs, H, Dh),
    cut to ``length`` if given.  A copy on the pools' device, never a view
    of them."""
    out = {"k": [], "v": []}
    for pk, pv in zip(pools["k"], pools["v"]):
        idx = _block_index(block_ids, pk.device)
        k = pk[idx].reshape(-1, *pk.shape[2:])
        v = pv[idx].reshape(-1, *pv.shape[2:])
        if length is not None:
            k, v = k[:length], v[:length]
        out["k"].append(k)
        out["v"].append(v)
    return out
