"""Serving: continuous-batching generation over a paged KV cache.

- :mod:`.kv_cache` — the paged pool, the block allocator and the paged
  decode step (the CUDA paged-attention kernel on the card);
- :mod:`.batcher` — the continuous batcher (host-only);
- :mod:`.prefix_index` — the cross-request prefix cache index (host-only);
- :mod:`.engine` — one serving replica; ``python -m
  flextree_tpu_torch.serving`` drives it from the command line.
"""

from .batcher import (
    BatcherConfig,
    ContinuousBatcher,
    PreemptedSeq,
    Request,
    SeqState,
)
from .engine import CompletedRequest, ServingEngine
from .kv_cache import (
    NULL_BLOCK,
    BlockAllocator,
    CacheExhausted,
    PagedCacheConfig,
    gather_seq,
    init_pools,
    make_paged_decode_fn,
    paged_decode_step,
    write_prefill,
    write_prefill_at,
    write_swapped,
)
from .prefix_index import PrefixIndex, PrefixIndexError

__all__ = [
    "BatcherConfig",
    "ContinuousBatcher",
    "PreemptedSeq",
    "Request",
    "SeqState",
    "CompletedRequest",
    "ServingEngine",
    "NULL_BLOCK",
    "BlockAllocator",
    "CacheExhausted",
    "PagedCacheConfig",
    "gather_seq",
    "init_pools",
    "make_paged_decode_fn",
    "paged_decode_step",
    "write_prefill",
    "write_prefill_at",
    "write_swapped",
    "PrefixIndex",
    "PrefixIndexError",
]
