"""Serving: continuous-batching generation over a paged KV cache.

- :mod:`.kv_cache` — the paged pool, the block allocator, the paged
  decode step (the CUDA paged-attention kernel on the card) and the
  block-granular export/import of a migrated sequence;
- :mod:`.batcher` — the continuous batcher (host-only);
- :mod:`.prefix_index` — the cross-request prefix cache index (host-only);
- :mod:`.engine` — one serving replica; ``python -m
  flextree_tpu_torch.serving`` drives it from the command line;
- :mod:`.migration` / :mod:`.costs` — prefill/decode disaggregation: the
  KV payload on the wire codecs (f32 verbatim, int8 block-scaled), with
  per-tensor CRCs, the JAX package's bytes; the cost planner's
  migrate-vs-recompute crossover and the per-round decode prediction;
- :mod:`.rpc` / :mod:`.replica_main` / :mod:`.frontdoor` — the
  real-process tier: the CRC-trailered frame protocol over TCP (the JAX
  package's wire), one replica process per engine (``python -m
  flextree_tpu_torch.serving.replica_main --role prefill|decode|both``,
  heartbeat-registered, SIGTERM-drainable), and the front door that
  routes, retries, hedges, sheds and sends long prompts through a
  prefill replica to a decode replica, with exactly-once results;
- :mod:`.pool` — the in-process elastic replica pool: engines under
  heartbeat supervision and a step watchdog, a dead replica's requests
  drained and re-routed to the survivors, exactly once (the reference
  semantics the real-process tier is held to);
- :mod:`.workload` — the open-loop spike load generator;
- :mod:`.rpc_model` — the RPC and KV-migration protocols as explicit
  transition models (``analysis.protocol_check`` explores them).
"""

from .batcher import (
    BatcherConfig,
    ContinuousBatcher,
    PreemptedSeq,
    Request,
    SeqState,
)
from .engine import CompletedRequest, ServingEngine
from .frontdoor import (
    FrontDoor,
    FrontDoorConfig,
    FrontDoorResult,
    ReplicaClient,
)
from .kv_cache import (
    NULL_BLOCK,
    BlockAllocator,
    CacheExhausted,
    PagedCacheConfig,
    export_blocks,
    gather_seq,
    init_pools,
    make_paged_decode_fn,
    paged_decode_step,
    write_imported,
    write_prefill,
    write_prefill_at,
    write_swapped,
)
from .migration import (
    MigrationError,
    migration_error_bound,
    pack_kv,
    unpack_kv,
)
from .pool import PoolConfig, ReplicaFailed, ReplicaPool
from .prefix_index import PrefixIndex, PrefixIndexError
from .rpc import (
    RpcConnection,
    RpcConnRefused,
    RpcError,
    RpcShed,
    RpcTimeout,
    RpcTornFrame,
)

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
    "export_blocks",
    "gather_seq",
    "init_pools",
    "make_paged_decode_fn",
    "paged_decode_step",
    "write_imported",
    "write_prefill",
    "write_prefill_at",
    "write_swapped",
    "PrefixIndex",
    "PrefixIndexError",
    "PoolConfig",
    "ReplicaFailed",
    "ReplicaPool",
    "MigrationError",
    "pack_kv",
    "unpack_kv",
    "migration_error_bound",
    "RpcError",
    "RpcTimeout",
    "RpcConnRefused",
    "RpcTornFrame",
    "RpcShed",
    "RpcConnection",
    "ReplicaConfig",
    "ReplicaServer",
    "FrontDoor",
    "FrontDoorConfig",
    "FrontDoorResult",
    "ReplicaClient",
]


def __getattr__(name):
    # the replica server loads on first use, not with the package: ``python
    # -m flextree_tpu_torch.serving.replica_main`` must not find its own
    # module already imported by the package it runs from
    if name in ("ReplicaConfig", "ReplicaServer"):
        from . import replica_main

        return getattr(replica_main, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
