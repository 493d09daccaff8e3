"""One elastic device pool: a train/serve chip arbiter.

The port's copy of ``flextree_tpu/arbiter/``.

Training and serving already share the runtime package (heartbeats,
leases, watchdogs, shrink/replan) but owned their devices statically.
This package unifies them behind a single inventory:

- :mod:`.inventory` — :class:`DeviceInventory`: single-assignment chip
  ownership (``train`` / ``serve`` / ``arbiter``-parked) with loud
  whole-set moves;
- :mod:`.core` — :class:`PoolArbiter`: leases chips to training by
  default, preempts them to serving replicas when the metrics registry's
  windowed TTFT p99 breaches the SLO, and returns them when the burst
  drains (hysteresis band + cooldown, so a single spike cannot thrash).

The cross-process protocol lives in :mod:`flextree_tpu_torch.runtime.leases`
(epoch-numbered grants + acks on the heartbeat dir); training's side is
``parallel.loop.fit(arbiter=TrainLeaseClient(...))``, serving's side is
``ReplicaPool.add_replica`` / ``release_replica``.  The executed proof
is ``python -m flextree_tpu_torch.tools.arbiter_spike``.
"""

from .core import (
    ArbiterConfig,
    PoolArbiter,
    SloReading,
    file_slo_reader,
    pool_slo_reader,
)
from .inventory import DeviceInventory

__all__ = [
    "ArbiterConfig",
    "DeviceInventory",
    "PoolArbiter",
    "SloReading",
    "pool_slo_reader",
    "file_slo_reader",
]
