"""Plan provenance for comm events: which plan, and what it predicted.

The port's copy of ``flextree_tpu/obs/provenance.py``.  A bucket span that
only says "4.2 MB over dp" answers what moved; :func:`bucket_provenance`
adds why: the widths, codec and chunking of the plan the sync ran and the
cost the planner's model predicted for it, as the JSON-safe dict that
:func:`..utils.profiling.comm_span` attaches to the recorded event.

Free while telemetry is off: with no flight recorder installed the helper
returns ``None`` at once, so the step never pays the cost-model call.
"""

from __future__ import annotations

import dataclasses

from .recorder import current_recorder

__all__ = ["topo_spec", "bucket_provenance"]


def topo_spec(topo) -> str:
    """The ``FT_TOPO``-style spec of a resolved topology (``"4,2"``,
    ``"3,2+2"``, ``"ring"``); the ``"psum"`` sentinel (None) reads
    ``"psum"``."""
    if topo is None:
        return "psum"
    if getattr(topo, "is_ring", False):
        return "ring"
    return str(topo).replace("*", ",")


def bucket_provenance(axes, topos, nbytes: int, *, n_leaves: int | None = None,
                      dtype: str | None = None, codec=None, chunks: int = 1,
                      sharded: bool = False, fired: bool = False
                      ) -> dict | None:
    """The plan-provenance payload of one bucket's comm event, or None when
    no recorder is installed.

    ``axes``/``topos``: the replication axes the bucket reduces over and
    their resolved topologies (``None`` = the ``"psum"`` sentinel, a dense
    fold of every rank); ``codec``: the wire codec the bucket ran (a
    name or a ``Codec``; None is ``"f32"``); ``sharded``: the bucket
    reduce-scatters into optimizer shards (ZeRO-1); ``fired``: the overlap
    engine fired it as its backward segments finished
    (:mod:`..parallel.overlap`).  The predicted
    :class:`~..planner.cost_model.CostBreakdown` is computed per scheduled
    axis with :func:`..planner.calibrate.default_params` (the constants
    the bucket size was chosen with) and summed."""
    if current_recorder() is None:
        return None
    axes = tuple(axes)
    prov: dict = {
        "axes": list(axes),
        "topo": {ax: topo_spec(topos.get(ax)) for ax in axes},
        # world size per axis (None for the sentinel, whose group size the
        # topology does not carry): a "ring" spec is ambiguous without it
        "world": {ax: (int(topos[ax].num_nodes)
                       if topos.get(ax) is not None else None)
                  for ax in axes},
        "nbytes": int(nbytes),
        "chunks": int(chunks),
        "codec": getattr(codec, "name", None) or (str(codec) if codec
                                                  else "f32"),
        "sharded": bool(sharded),
        "fired": bool(fired),
    }
    if n_leaves is not None:
        prov["n_leaves"] = int(n_leaves)
    if dtype is not None:
        prov["dtype"] = str(dtype)
    try:
        from ..planner.calibrate import default_params
        from ..planner.cost_model import allreduce_cost, lonely_allreduce_cost
        from ..schedule.stages import LonelyTopology

        params = default_params()
        total = 0.0
        breakdown: dict[str, float] = {}
        for ax in axes:
            topo = topos.get(ax)
            if topo is None:
                continue  # the sentinel: the model has no term for it
            if isinstance(topo, LonelyTopology):
                cost = lonely_allreduce_cost(topo.tree, topo.lonely,
                                             int(nbytes), params, codec=codec)
            else:
                cost = allreduce_cost(topo, int(nbytes), params, codec=codec)
            total += cost.total_us
            for key, val in dataclasses.asdict(cost).items():
                breakdown[key] = round(breakdown.get(key, 0.0) + val, 3)
        if breakdown:
            prov["predicted"] = breakdown
            prov["predicted_us"] = round(total, 3)
    except Exception:  # telemetry must never break the sync it describes
        prov["predicted_error"] = True
    return prov
