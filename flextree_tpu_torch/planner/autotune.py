"""Measured plan autotuner: close the analytic -> measured loop.

The port's copy of ``flextree_tpu/planner/autotune.py``.  Take the top-K
**analytic** candidates over the (tree shape x wire codec) product, time
each on an in-process mesh of the card with the bench harness's
shuffled-interleaved protocol (every candidate's allreduce folds on the
fold kernel, ``ops.reduce_stacked.reduce_sources``), pick the
**measured** winner, and persist it in a plan cache so the second run is
a pure cache hit that times nothing and launches nothing.

Cache contract: entries are keyed by ``plan_cache_key(fingerprint, n,
nbytes, dtype, codecs, overlap, sharded)`` with the fingerprint of the
measuring backend (``calibrate.backend_fingerprint(device, ranks=n,
transport="mesh")``: the card, its count, the rank count and the torch
version), so a plan measured on one backend is never replayed on another;
a fingerprint mismatch is a miss and the candidates are re-measured.  The
cache file is JSON (an explicit ``cache_path``, else
``FLEXTREE_PLAN_CACHE``, else :data:`DEFAULT_CACHE_PATH`, a user-level
file of the port's own, so a port run never rewrites the JAX package's),
one entry per key, schema-versioned by :data:`PLAN_CACHE_SCHEMA` (the JAX
package's, its own constant apart from the calibration schema).

The measured winner can only improve on the analytic argmin: the argmin
is always in the shortlist, so ``min(measured)`` is never slower than the
argmin's own measured time.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from ..schedule.ir import IRFamilySpec
from ..schedule.stages import LonelyTopology, Topology
from .calibrate import backend_fingerprint, default_params, plan_cache_key
from .choose import choose_topology

#: Plan-cache file schema (the JAX package's): bump only when the entry
#: format itself changes.
PLAN_CACHE_SCHEMA = 3

__all__ = [
    "TunedPlan",
    "analytic_shortlist",
    "autotune_plan",
    "invalidate_plan_cache",
    "DEFAULT_CACHE_PATH",
    "DEFAULT_CODECS",
    "DEFAULT_IR_FAMILIES",
    "PLAN_CACHE_SCHEMA",
]

DEFAULT_CODECS = ("f32", "bf16", "int8")

#: schedule-IR families offered to the measured search by default, for
#: the identity codec and unsharded plans only
DEFAULT_IR_FAMILIES = ("swing", "generalized")

#: the plan cache when neither ``cache_path`` nor ``FLEXTREE_PLAN_CACHE``
#: names one (entries are fingerprinted, so one user-level file is safe
#: across hosts and cards)
DEFAULT_CACHE_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "flextree_tpu_torch", "plan_cache.json"
)


@dataclass(frozen=True)
class TunedPlan:
    """Autotuner output: the winning (shape, codec) plus provenance.

    ``family`` is ``"tree"`` for every legacy shape (the ring included) or
    an IR family (``"swing"``/``"generalized"``); cache entries keep it,
    so an IR winner never replays as a legacy widths vector."""

    num_nodes: int
    nbytes: int
    dtype: str
    widths: tuple[int, ...]
    lonely: int
    codec: str
    predicted_us: float
    measured_us: float | None
    source: str  # "measured" | "cache"
    #: ranked shortlist rows: (shape, lonely, codec, predicted_us,
    #: measured_us) — a widths tuple for legacy rows, a spec string for IR
    table: tuple = ()
    family: str = "tree"
    ports: int = 0

    def to_ft_topo(self) -> str:
        if self.family == "swing":
            return "swing"
        if self.family == "generalized":
            return f"gen:{','.join(map(str, self.widths))}@{self.ports}"
        spec = ",".join(map(str, self.widths))
        if self.lonely:
            spec += f"+{self.lonely}"
        return spec

    @property
    def topology(self):
        if self.family == "swing":
            return IRFamilySpec("swing", self.num_nodes)
        if self.family == "generalized":
            return IRFamilySpec("generalized", self.num_nodes, self.widths,
                                self.ports)
        if self.widths == (1,):
            return Topology.ring(self.num_nodes)
        if self.lonely:
            return LonelyTopology(
                self.num_nodes,
                Topology(self.num_nodes - self.lonely, self.widths),
                self.lonely,
            )
        return Topology(self.num_nodes, self.widths)


def analytic_shortlist(n: int, nbytes: int, codecs=DEFAULT_CODECS,
                       params=None, top_k: int = 4, sharded: bool = False,
                       ir_families=DEFAULT_IR_FAMILIES) -> list[tuple]:
    """Top-K ``(shape, lonely, codec, predicted_us)`` over the shape x
    codec product, cheapest first: ``shape`` is a widths tuple, or an
    ``IRFamilySpec`` for swing/generalized rows (offered under the
    identity codec of an unsharded plan only).  The analytic argmin is
    rank 0.  ``sharded`` prices one ZeRO-1 round (reduce-scatter +
    all-gather, ``choose_topology(collective="sharded")``)."""
    if params is None:
        params = default_params()
    rows: list[tuple] = []
    for codec in codecs:
        offer_ir = tuple(ir_families) if codec == "f32" and not sharded \
            else ()
        plan = choose_topology(
            n, nbytes, params=params, codec=codec,
            collective="sharded" if sharded else "allreduce",
            ir_families=offer_ir,
        )
        for c in plan.candidates:
            if c.family == "tree":
                rows.append((c.widths, c.lonely, codec, c.total_us))
            else:
                fam = (IRFamilySpec("swing", n) if c.family == "swing" else
                       IRFamilySpec("generalized", n, c.widths, c.ports))
                rows.append((fam, 0, codec, c.total_us))
    rows.sort(key=lambda r: r[3])
    return rows[: max(1, top_k)]


# ------------------------------------------------------------- cache


def _cache_path(cache_path):
    if cache_path is not None:
        return cache_path
    return os.environ.get("FLEXTREE_PLAN_CACHE") or DEFAULT_CACHE_PATH


def _cache_load(path) -> dict:
    empty = {"schema": PLAN_CACHE_SCHEMA, "entries": {}}
    if not path or not os.path.exists(path):
        return empty
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return empty
    if doc.get("schema", 1) > PLAN_CACHE_SCHEMA:
        return empty
    doc.setdefault("entries", {})
    return doc


def _cache_store(path, doc) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)  # atomic: a concurrent reader never sees a torn file


def invalidate_plan_cache(predicate, cache_path=None) -> int:
    """Drop the plan-cache entries for which ``predicate(key, entry)`` is
    true (the key is the flat :func:`.calibrate.plan_cache_key` string,
    the entry carries its ``fingerprint``); returns how many went.  A
    missing or empty cache is a no-op, and an untouched file is not
    rewritten."""
    path = _cache_path(cache_path)
    if not path or not os.path.exists(path):
        return 0
    doc = _cache_load(path)
    keep = {k: e for k, e in doc["entries"].items() if not predicate(k, e)}
    removed = len(doc["entries"]) - len(keep)
    if removed:
        doc["entries"] = keep
        _cache_store(path, doc)
    return removed


# ------------------------------------------------------------ measure


def _spec(shape, lonely) -> str:
    if isinstance(shape, IRFamilySpec):
        return shape.spec
    return ",".join(map(str, shape)) + (f"+{lonely}" if lonely else "")


def _default_timer(candidates, n, nbytes, dtype, repeat, sharded=False,
                   device=None):
    """Seconds a candidate, aligned with ``candidates``: each one's
    collective on an in-process ``flat_mesh(n, device)`` over seeded rows
    of ``nbytes`` a rank, warmed once, then timed with the bench harness's
    shuffled-interleaved protocol (``bench.harness._interleaved_times``,
    so a stretch of host contention lands on every candidate); the min of
    ``repeat`` rounds.  Unsharded: ``compressed.compressed_allreduce``
    with the candidate's codec; ``sharded``: ``reduce_scatter`` then
    ``all_gather``, the codec on both wires (the ZeRO-1 round)."""
    import numpy as np
    import torch

    from ..bench.harness import _interleaved_times
    from ..device import resolve_device
    from ..parallel.allreduce import all_gather, reduce_scatter
    from ..parallel.compressed import compressed_allreduce
    from ..parallel.mesh import flat_mesh

    dev = resolve_device(device)
    mesh = flat_mesh(n, dev)
    tdt = getattr(torch, dtype)
    size = max(1, nbytes // tdt.itemsize)
    rng = np.random.default_rng(0)
    rows = list(torch.as_tensor(
        rng.standard_normal((n, size)).astype(np.float32),
        device=dev).to(tdt).unbind(0))

    calls = {}
    for i, (shape, lonely, codec, _pred) in enumerate(candidates):
        spec = _spec(shape, lonely)
        if sharded:
            def fn(spec=spec, codec=codec):
                shards = reduce_scatter(rows, mesh, topo=spec, codec=codec)
                return all_gather(shards, mesh, topo=spec,
                                  out_shape=rows[0].shape, codec=codec)
        else:
            def fn(spec=spec, codec=codec):
                return compressed_allreduce(rows, mesh, topo=spec,
                                            codec=codec)
        fn()  # warm outside the timed rounds
        calls[str(i)] = fn
    times = _interleaved_times(calls, repeat, dev)
    return [times[str(i)]["min_ms"] * 1e-3 for i in range(len(candidates))]


# ------------------------------------------------------------- entry


def autotune_plan(n: int, nbytes: int, *, dtype: str = "float32",
                  codecs=DEFAULT_CODECS, top_k: int = 4, params=None,
                  cache_path=None, timer=None, repeat: int = 5,
                  use_cache: bool = True, overlap: bool = False,
                  sharded: bool = False, ir_families=DEFAULT_IR_FAMILIES,
                  device=None) -> TunedPlan:
    """Pick the gradient-sync plan by measurement.

    First run: rank the shape x codec product analytically, measure the
    top ``top_k`` (``timer(candidates, n, nbytes, dtype, repeat) ->
    [seconds]``, by default :func:`_default_timer` on ``device``, default
    ``cuda``), persist the winner under the fingerprinted key.  A second
    run with the same key is a pure cache hit: no timing, no launch.

    ``overlap`` and ``sharded`` tag the key, so a plan measured for the
    serialized sync never replays for the overlapped one, nor a
    replicated plan for ZeRO-1's split round; ``sharded`` also switches
    the costing and the measured protocol to that round."""
    from ..device import resolve_device

    codecs = tuple(codecs)
    dev = resolve_device(device)
    shortlist = analytic_shortlist(n, nbytes, codecs, params=params,
                                   top_k=top_k, sharded=sharded,
                                   ir_families=ir_families)
    fp = backend_fingerprint(dev, ranks=n, transport="mesh")
    key = plan_cache_key(
        fp, f"n{n}", f"{nbytes}B", dtype, ",".join(codecs),
        "overlap" if overlap else "serial",
        "sharded" if sharded else "replicated",
    )
    path = _cache_path(cache_path)

    if use_cache and path:
        hit = _cache_load(path)["entries"].get(key)
        if hit is not None and hit.get("fingerprint") == fp:
            return TunedPlan(
                n, nbytes, dtype, tuple(hit["widths"]),
                int(hit.get("lonely", 0)), hit["codec"],
                float(hit["predicted_us"]), float(hit["measured_us"]),
                source="cache",
                table=tuple(tuple(r) for r in hit.get("table", ())),
                family=hit.get("family", "tree"),
                ports=int(hit.get("ports", 0)),
            )

    if timer is None:
        def timer(c, n_, nb, dt, rep):
            return _default_timer(c, n_, nb, dt, rep, sharded=sharded,
                                  device=dev)
    measured_s = timer(shortlist, n, nbytes, dtype, repeat)
    if len(measured_s) != len(shortlist):
        raise ValueError(f"timer returned {len(measured_s)} times for "
                         f"{len(shortlist)} candidates")
    table = tuple(
        (shape.spec if isinstance(shape, IRFamilySpec) else shape, lonely,
         codec, pred, t * 1e6)
        for (shape, lonely, codec, pred), t in zip(shortlist, measured_s)
    )
    best = min(range(len(shortlist)), key=lambda i: measured_s[i])
    shape, lonely, codec, pred = shortlist[best]
    if isinstance(shape, IRFamilySpec):
        family, widths, ports = shape.family, shape.widths, shape.ports
    else:
        family, widths, ports = "tree", shape, 0
    plan = TunedPlan(n, nbytes, dtype, widths, lonely, codec, pred,
                     measured_s[best] * 1e6, source="measured", table=table,
                     family=family, ports=ports)
    if use_cache and path:
        doc = _cache_load(path)
        doc["entries"][key] = {
            "fingerprint": fp,
            "widths": list(widths),
            "lonely": lonely,
            "codec": codec,
            "family": family,
            "ports": ports,
            "predicted_us": pred,
            "measured_us": plan.measured_us,
            "table": [[w if isinstance(w, str) else list(w), l, c, p, m]
                      for (w, l, c, p, m) in table],
        }
        _cache_store(path, doc)
    return plan
