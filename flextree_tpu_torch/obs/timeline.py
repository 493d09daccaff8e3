"""Cross-rank timeline merger: per-rank event files → one Chrome trace.

The port's copy of ``flextree_tpu/obs/timeline.py``; the port's recorder
writes the same event files, so either package's merger reads the
other's.  ``bucket_measured`` (the twin of the port's
``bucket_planned``) comes from the step span clock
(``obs/stepclock.py``) and the feedback prober (``planner/feedback.py``).

Reads every ``flight_*.jsonl`` (and ``*.dump.json`` sidecar) a run left
in its obs directory and fuses them into one JSON document loadable by
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``:

- each **rank is a track** (trace ``pid``; the event's ``src`` — train /
  serve / peer — names the process), with the recorder's main lane and
  the heartbeat daemon's lane as separate ``tid``\\ s so beats don't
  visually interleave with steps;
- paired ``*_start``/``*_end`` kinds (steps today; any future pair works
  by naming convention) become **complete events** (``ph: "X"``) whose
  duration is the measured wall-time between the pair;
- ``bucket_planned``/``bucket_fired`` comm events become spans whose
  duration is the *planner's predicted* time and whose ``args`` carry
  the full plan provenance (topo widths/codec/sharded + the predicted
  ``CostBreakdown``), so predicted-vs-measured per-phase residuals can
  be read off any run's timeline;
- serving request lifecycles (``serve_admit`` → ``serve_retire``)
  become **flow arrows** keyed by request id — a re-routed request's
  arrow visibly jumps tracks;
- arbiter decisions (``slo_breach``, ``lease_preempt``/``lease_grant``/
  ``lease_return``, the trainer's ``lease_resize``) render on a
  dedicated **arbiter lane** with the SLO reading in their ``args``, so
  every chip reallocation is visible beside the train/serve spans it
  caused;
- coordination-protocol events (``coord_propose``/``coord_ack``/
  ``coord_commit``/``coord_repropose``/``coord_failover``/
  ``coord_fence``/``coord_apply``, ``runtime/coordination.py``) render
  on a dedicated **coordination lane**, so a merged trace shows which
  rank proposed each control epoch, who acked late, where the commit
  landed and who got fenced;
- everything else is an instant event carrying its fields as ``args``.

Timestamps are wall-clock (the recorders stamp with ``time.time`` for
exactly this reason); the merger rebases to the earliest event so the
trace starts at 0 µs.  :func:`validate_trace` is the schema check the
tests and the chip smoke test share — "loadable Chrome-trace JSON" is
machine-checked, not assumed.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import statistics

__all__ = [
    "read_events",
    "read_dir",
    "merge_events",
    "merge_dir",
    "validate_trace",
    "write_trace",
    "ResidualSample",
    "residual_pairs",
    "residual_table",
    "residual_group_key",
    "phase_components",
]

#: kinds rendered on the heartbeat lane (tid 1) instead of the main lane
_HEARTBEAT_KINDS = frozenset({"heartbeat"})

#: arbiter-decision kinds rendered on their own lane (tid 2), so every
#: chip reallocation is visible BESIDE the train/serve spans it caused —
#: slo_breach carries the SLO reading, the lease_* kinds carry the chips
_ARBITER_KINDS = frozenset(
    {"slo_breach", "lease_grant", "lease_preempt", "lease_return",
     "lease_resize"}
)

#: coordination-protocol kinds (runtime/coordination.py) rendered on their
#: own lane (tid 3), the same pattern as the arbiter lane: a merged trace
#: shows which rank proposed, who acked (and who acked late), where the
#: commit landed, who took over after a coordinator death, and who got
#: fenced — plus the control-plane health events (torn control files,
#: wall-clock regressions) beside the decisions they endangered
_COORD_KINDS = frozenset(
    {"coord_propose", "coord_ack", "coord_commit", "coord_repropose",
     "coord_failover", "coord_fence", "coord_apply", "coord_commit_race",
     "torn_control_file", "clock_regression"}
)

#: paired-kind suffixes → complete events
_START_SUFFIX, _END_SUFFIX = "_start", "_end"

#: comm-plan kinds rendered as predicted-duration spans
_PLAN_KINDS = frozenset({"bucket_planned", "bucket_fired", "collective"})

#: measured-comm kinds rendered as spans whose duration is the MEASURED
#: time — the twin of the comm-plan spans above, so Perfetto shows the
#: prediction and the measurement side by side.  ``bucket_measured``
#: comes from the feedback prober's timed collectives (planner/
#: feedback.py) AND from the per-step span clock (obs/stepclock.py:
#: ``per_step: true``, host-timed steps apportioned over the compile-time
#: plan); ``serve_round_measured`` is the serving engine's decode round
#: against the paged-decode cost estimate (serving/costs.py).
_MEASURED_KINDS = frozenset({"bucket_measured", "serve_round_measured"})

#: whole-step measured spans (obs/stepclock.py): duration is the step's
#: host wall time, args carry the comm/floor split and the plan signature
_STEP_MEASURED_KINDS = frozenset({"step_measured"})

_META_KEYS = frozenset({"ts", "rank", "src", "seq", "kind"})


def read_events(path: str) -> list[dict]:
    """Parse one JSONL event file, tolerating a torn final line (the
    writer may have been SIGKILL'd mid-write — everything before the
    tear is still evidence)."""
    out: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue  # torn tail
            if isinstance(ev, dict) and "kind" in ev and "ts" in ev:
                out.append(ev)
    return out


def read_dir(dir: str) -> tuple[list[dict], dict[int, dict]]:
    """(events, dumps-by-rank) from every flight file under ``dir``."""
    events: list[dict] = []
    for path in sorted(glob.glob(os.path.join(dir, "flight_*.jsonl"))):
        events.extend(read_events(path))
    dumps: dict[int, dict] = {}
    for path in sorted(glob.glob(os.path.join(dir, "flight_*.dump.json"))):
        try:
            with open(path, encoding="utf-8") as f:
                d = json.load(f)
            dumps[int(d["rank"])] = d
        except (OSError, ValueError, KeyError):
            continue
    return events, dumps


def _args(ev: dict) -> dict:
    return {k: v for k, v in ev.items() if k not in _META_KEYS}


def _pair_key(ev: dict, base: str):
    """Identity connecting a ``*_start`` to its ``*_end``: the rank plus
    the pair's own id — an explicit ``id`` field wins over ``step``
    (``fit_start``/``fit_end`` share an ``id`` while their ``step``
    fields legitimately differ: a run starts at ``start`` and ends at
    the final step)."""
    return (ev.get("rank", 0), base, ev.get("id", ev.get("step")))


def merge_events(events, dumps: dict[int, dict] | None = None) -> dict:
    """Fuse recorder events into one Chrome-trace JSON document."""
    # defense against duplicated spill lines (a retried batch, a file
    # read twice): identical (rank, seq, ts, kind) is the same event.
    # ts is part of the key because seq restarts at 0 when a later
    # process appends to the same rank's file (the resume-after-SIGTERM
    # pattern) — those are distinct events, not duplicates.
    seen: set = set()
    deduped = []
    for ev in events:
        key = (ev.get("rank", 0), ev.get("seq"), ev["ts"], ev["kind"])
        if key in seen:
            continue
        seen.add(key)
        deduped.append(ev)
    events = sorted(deduped, key=lambda e: (e["ts"], e.get("seq", 0)))
    t0 = events[0]["ts"] if events else 0.0

    def us(ts: float) -> float:
        return round((ts - t0) * 1e6, 1)

    trace: list[dict] = []
    ranks: dict[int, str] = {}
    arbiter_ranks: set = set()
    coord_ranks: set = set()
    open_pairs: dict = {}
    flow_open: set = set()

    for ev in events:
        rank = int(ev.get("rank", 0))
        ranks.setdefault(rank, str(ev.get("src", "rank")))
        kind = str(ev["kind"])
        tid = 1 if kind in _HEARTBEAT_KINDS else 0
        if kind in _ARBITER_KINDS:
            tid = 2
            arbiter_ranks.add(rank)
        elif kind in _COORD_KINDS:
            tid = 3
            coord_ranks.add(rank)
        common = {"pid": rank, "tid": tid, "ts": us(ev["ts"])}

        if kind.endswith(_START_SUFFIX):
            open_pairs[_pair_key(ev, kind[: -len(_START_SUFFIX)])] = ev
            continue
        if kind.endswith(_END_SUFFIX):
            base = kind[: -len(_END_SUFFIX)]
            start = open_pairs.pop(_pair_key(ev, base), None)
            if start is not None:
                pair_id = _pair_key(ev, base)[2]
                name = base if pair_id is None else f"{base} {pair_id}"
                trace.append(
                    {
                        "name": name,
                        "cat": base,
                        "ph": "X",
                        **common,
                        "ts": us(start["ts"]),
                        "dur": max(round((ev["ts"] - start["ts"]) * 1e6, 1), 0.1),
                        "args": {**_args(start), **_args(ev)},
                    }
                )
                continue
            # unmatched end (start predates the ring / the file): instant
            trace.append(
                {"name": kind, "cat": base, "ph": "i", "s": "t", **common,
                 "args": _args(ev)}
            )
            continue

        if kind in _PLAN_KINDS:
            args = _args(ev)
            dur = max(float(args.get("predicted_us") or 1.0), 1.0)
            trace.append(
                {
                    "name": str(args.get("name", kind)),
                    "cat": "comm-plan",
                    "ph": "X",
                    **common,
                    "dur": round(dur, 1),
                    "args": args,
                }
            )
            continue

        if kind in _MEASURED_KINDS:
            args = _args(ev)
            dur = max(float(args.get("measured_us") or 1.0), 1.0)
            trace.append(
                {
                    "name": str(args.get("name", kind)),
                    "cat": (
                        "serve-measured"
                        if kind == "serve_round_measured"
                        else "comm-measured"
                    ),
                    "ph": "X",
                    **common,
                    "dur": round(dur, 1),
                    "args": args,
                }
            )
            continue

        if kind in _STEP_MEASURED_KINDS:
            args = _args(ev)
            dur = max(float(args.get("step_us") or 1.0), 1.0)
            trace.append(
                {
                    "name": f"step_measured {args.get('step', '')}".strip(),
                    "cat": "step-measured",
                    "ph": "X",
                    **common,
                    "dur": round(dur, 1),
                    "args": args,
                }
            )
            continue

        if kind.startswith("serve_") and "rid" in ev:
            rid = int(ev["rid"])
            trace.append(
                {"name": kind, "cat": "serve", "ph": "i", "s": "t", **common,
                 "args": _args(ev)}
            )
            flow = {"name": f"request {rid}", "cat": "request", "id": rid,
                    **common}
            if kind == "serve_admit" and rid not in flow_open:
                flow_open.add(rid)
                trace.append({**flow, "ph": "s"})
            elif kind == "serve_retire" and rid in flow_open:
                flow_open.discard(rid)
                trace.append({**flow, "ph": "f", "bp": "e"})
            elif rid in flow_open:
                trace.append({**flow, "ph": "t"})
            continue

        if kind.startswith("serve_prefix"):
            # rid-less prefix-cache events (``serve_prefix_evict``) still
            # belong on the serve lane, not the generic fallback
            trace.append(
                {"name": kind, "cat": "serve", "ph": "i", "s": "t",
                 **common, "args": _args(ev)}
            )
            continue

        if kind in _ARBITER_KINDS:
            # process-scoped instants: a chip reallocation concerns every
            # lane of the track, not one thread's local moment
            trace.append(
                {"name": kind, "cat": "arbiter", "ph": "i", "s": "p",
                 **common, "args": _args(ev)}
            )
            continue

        if kind in _COORD_KINDS:
            # handshake phases as process-scoped instants on the
            # coordination lane: a control epoch concerns the whole rank
            trace.append(
                {"name": kind, "cat": "coordination", "ph": "i", "s": "p",
                 **common, "args": _args(ev)}
            )
            continue

        scope = "p" if kind in ("dump", "shrink", "preempt") else "t"
        trace.append(
            {"name": kind, "cat": kind, "ph": "i", "s": scope, **common,
             "args": _args(ev)}
        )

    # unmatched starts: the step a rank never finished — the cut-off
    # moment a forensic timeline exists to show — rendered as instants
    for (rank, base, pair_id), start in sorted(
        open_pairs.items(), key=lambda kv: kv[1]["ts"]
    ):
        trace.append(
            {
                "name": (f"{base} {pair_id}" if pair_id is not None else base)
                + " (unfinished)",
                "cat": base,
                "ph": "i",
                "s": "p",
                "pid": int(rank),
                "tid": 0,
                "ts": us(start["ts"]),
                "args": _args(start),
            }
        )

    # track names + dump summaries
    for rank, src in sorted(ranks.items()):
        trace.append(
            {"name": "process_name", "ph": "M", "pid": rank, "tid": 0,
             "args": {"name": f"rank {rank} ({src})"}}
        )
        trace.append(
            {"name": "thread_name", "ph": "M", "pid": rank, "tid": 0,
             "args": {"name": "events"}}
        )
        trace.append(
            {"name": "thread_name", "ph": "M", "pid": rank, "tid": 1,
             "args": {"name": "heartbeat"}}
        )
        if rank in arbiter_ranks:
            trace.append(
                {"name": "thread_name", "ph": "M", "pid": rank, "tid": 2,
                 "args": {"name": "arbiter"}}
            )
        if rank in coord_ranks:
            trace.append(
                {"name": "thread_name", "ph": "M", "pid": rank, "tid": 3,
                 "args": {"name": "coordination"}}
            )

    doc = {
        "traceEvents": trace,
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": "flextree_tpu_torch.obs",
            "ranks": sorted(ranks),
            "events": len(events),
            "epoch_s": t0,
            "dumps": {
                str(r): {"reason": d.get("reason"),
                         "events": len(d.get("events", ()))}
                for r, d in sorted((dumps or {}).items())
            },
        },
    }
    return doc


def merge_dir(dir: str) -> dict:
    """Merge every per-rank flight file under ``dir``."""
    events, dumps = read_dir(dir)
    return merge_events(events, dumps)


_VALID_PH = frozenset("BEXiIsMtfPNODC")


def validate_trace(doc) -> list[str]:
    """Schema-validity violations of a merged timeline (empty = loadable
    Chrome-trace JSON, object format).  The checks mirror what the
    Perfetto/catapult loaders actually require: a ``traceEvents`` list
    whose entries carry ``name``/``ph``/``ts``/``pid``/``tid``, complete
    events with a non-negative ``dur``, and flow starts matched by flow
    finishes."""
    bad: list[str] = []
    if not isinstance(doc, dict) or not isinstance(
        doc.get("traceEvents"), list
    ):
        return ["document is not a dict with a traceEvents list"]
    flows: dict = {}
    for i, ev in enumerate(doc["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            bad.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            bad.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            bad.append(f"{where}: missing name")
        if ph != "M":
            for key in ("ts", "pid", "tid"):
                if not isinstance(ev.get(key), (int, float)):
                    bad.append(f"{where}: missing/non-numeric {key}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                bad.append(f"{where}: complete event with bad dur {dur!r}")
        if ph in "stf":
            if "id" not in ev:
                bad.append(f"{where}: flow event without id")
            elif ph != "t":
                flows[ev["id"]] = flows.get(ev["id"], 0) + (1 if ph == "s" else -1)
        if "args" in ev:
            try:
                json.dumps(ev["args"])
            except (TypeError, ValueError):
                bad.append(f"{where}: args not JSON-serializable")
    for fid, n in sorted(flows.items()):
        # an s without an f is fine (a request in flight when the rank
        # died is exactly what a forensic timeline shows); an f that was
        # never opened is a merger bug
        if n < 0:
            bad.append(f"flow id {fid}: finish without start")
    return bad


# ---------------------------------------------------------------------------
# predicted-vs-measured residual query (planner feedback)
#
# ``bucket_planned`` events carry the planner's predicted CostBreakdown for
# a comm span (obs/provenance.py — per-compile, the plan as priced);
# ``bucket_measured`` events carry a MEASURED wall time for the same
# (topo, world, codec, sharded, nbytes) point (the feedback prober's timed
# collective runs, planner/feedback.py in the JAX package).  Pairing them
# yields the predicted-vs-measured residual samples the closed-loop
# fitter consumes — this module owns the pairing so the ``python -m
# flextree_tpu_torch.obs residuals`` CLI and a feedback fitter share one
# code path and cannot diverge.
# ---------------------------------------------------------------------------


#: CostBreakdown terms grouped into the three independently-identifiable
#: phases (shared with obs/stepclock.py and the planner.feedback phase
#: fit): per-message fixed costs, byte-proportional costs (wire +
#: reduce, structurally collinear on an f32 wire), and codec work.
_PHASE_TERMS = {
    "fixed": ("latency_us", "control_us"),
    "bytes": ("bandwidth_us", "reduce_us"),
    "codec": ("codec_us",),
}


def phase_components(breakdown: dict | None) -> dict | None:
    """Collapse a per-term ``CostBreakdown`` dict into the three fit
    phases ``{"fixed", "bytes", "codec"}`` (µs).  None in, None out."""
    if not isinstance(breakdown, dict):
        return None
    return {
        phase: sum(float(breakdown.get(t, 0.0)) for t in terms)
        for phase, terms in _PHASE_TERMS.items()
    }


@dataclasses.dataclass(frozen=True)
class ResidualSample:
    """One predicted-vs-measured comm point read off a flight record."""

    topo: str  # FT_TOPO-style spec of the axis's topology ("4,2", "ring")
    world: int | None  # group size on that axis (None: unknown/psum)
    codec: str
    sharded: bool
    nbytes: int
    predicted_us: float
    measured_us: float
    fingerprint: str | None = None  # measuring backend, when recorded
    step: int | None = None
    ts: float | None = None
    #: "paired" when the prediction came from a matching ``bucket_planned``
    #: span; "self" when the measured event carried its own prediction
    #: (the prober prices with the same model the planner used); "step"
    #: for per-step span-clock samples (obs/stepclock.py) — host-timed
    #: step totals apportioned over the compile-time plan, so within one
    #: step their measured/predicted ratios are uniform by construction
    #: (they feed the phase-scale fit and the drift detector, never the
    #: point-wise α-β solve)
    source: str = "paired"
    #: the predicted per-term CostBreakdown behind ``predicted_us`` when
    #: the record carried one — the component-wise residual material the
    #: per-phase fit consumes (planner.feedback.fit_phase_scales)
    predicted_breakdown: dict | None = None

    @property
    def rel_residual(self) -> float:
        """|predicted - measured| / measured — the drift-band quantity."""
        return abs(self.predicted_us - self.measured_us) / max(
            self.measured_us, 1e-9
        )

    @property
    def phases(self) -> dict | None:
        """Predicted µs per fit phase (fixed / bytes / codec), or None
        when the record carried no breakdown."""
        return phase_components(self.predicted_breakdown)


def _plan_points(ev: dict):
    """(topo_spec, world) per axis of a plan/measured event —
    provenance records one event per axis (axes is a 1-tuple at both call
    sites), but tolerate multi-axis payloads by yielding each axis.
    Ring specs are normalized: provenance labels the ring topology
    ``"ring"`` while the wire grammar's sentinel is ``"1"`` — the pairing
    must treat them as one point."""
    topo = ev.get("topo") or {}
    world = ev.get("world") or {}
    for ax in sorted(topo):
        w = world.get(ax)
        spec = str(topo[ax])
        if spec == "1":
            spec = "ring"
        yield spec, (int(w) if w is not None else None)


def _pairing_keys(ev: dict):
    nbytes = ev.get("nbytes")
    if nbytes is None:
        return
    for spec, world in _plan_points(ev):
        yield (
            spec,
            world,
            str(ev.get("codec", "f32")),
            bool(ev.get("sharded", False)),
            int(nbytes),
        )


def residual_pairs(events) -> tuple[list[ResidualSample], dict]:
    """Pair ``bucket_planned`` predictions with ``bucket_measured`` times.

    Returns ``(samples, skipped)`` where ``skipped`` counts events that
    produced no sample and why: ``predicted_error`` (the cost model raised
    at trace time — obs/provenance.py's never-break-a-trace path; such
    spans are skipped, never crashed on), ``unpredicted`` (a measured
    point with no prediction on either side), ``invalid_measured`` (a
    measured event whose ``measured_us`` is missing or non-positive —
    a torn write or producer bug, not a pairing gap), ``unmeasured_plans``
    (planned spans that no probe ever measured — expected: plans are
    per-compile, probes are per-tick).
    """
    skipped = {
        "predicted_error": 0,
        "unpredicted": 0,
        "invalid_measured": 0,
        "unmeasured_plans": 0,
    }
    predicted: dict[tuple, tuple] = {}  # key -> (pred_us, breakdown|None)
    matched: set = set()
    for ev in events:
        if ev.get("kind") != "bucket_planned":
            continue
        if ev.get("predicted_error"):
            skipped["predicted_error"] += 1
            continue
        pred = ev.get("predicted_us")
        if not isinstance(pred, (int, float)):
            continue  # a bare span with no costed prediction: nothing to pair
        breakdown = ev.get("predicted")
        breakdown = dict(breakdown) if isinstance(breakdown, dict) else None
        for key in _pairing_keys(ev):
            # latest prediction wins: a recompile re-prices the same point
            predicted[key] = (float(pred), breakdown)

    samples: list[ResidualSample] = []
    for ev in events:
        if ev.get("kind") != "bucket_measured":
            continue
        meas = ev.get("measured_us")
        if not isinstance(meas, (int, float)) or meas <= 0:
            skipped["invalid_measured"] += 1
            continue
        keys = list(_pairing_keys(ev))
        if not keys:
            skipped["unpredicted"] += 1
            continue
        own_breakdown = ev.get("predicted")
        own_breakdown = (
            dict(own_breakdown) if isinstance(own_breakdown, dict) else None
        )
        per_step = bool(ev.get("per_step"))
        for key in keys:
            spec, world, codec, sharded, nbytes = key
            if key in predicted:
                (pred, breakdown), source = predicted[key], "paired"
                matched.add(key)
                # the measured event's own breakdown is the fresher view
                # (the prober/span clock prices with the live constants)
                breakdown = own_breakdown or breakdown
            elif isinstance(ev.get("predicted_us"), (int, float)):
                pred, source = float(ev["predicted_us"]), "self"
                breakdown = own_breakdown
            else:
                skipped["unpredicted"] += 1
                continue
            samples.append(
                ResidualSample(
                    topo=spec,
                    world=world,
                    codec=codec,
                    sharded=sharded,
                    nbytes=nbytes,
                    predicted_us=pred,
                    measured_us=float(meas),
                    fingerprint=ev.get("fingerprint"),
                    step=ev.get("step"),
                    ts=ev.get("ts"),
                    source="step" if per_step else source,
                    predicted_breakdown=breakdown,
                )
            )
    skipped["unmeasured_plans"] = len(set(predicted) - matched)
    return samples, skipped


def residual_group_key(s: ResidualSample) -> tuple:
    """The CLI/fit grouping of a residual sample: (topo, codec, tier)
    where ``tier`` is the group size plus the sharded flag (the per-tier
    grouping the two-tier roadmap item will refine)."""
    tier = f"n{s.world if s.world is not None else '?'}" + (
        "/sharded" if s.sharded else ""
    )
    return (s.topo, s.codec, tier)


def _phase_mix(grp) -> str:
    """Median predicted per-phase mix of a sample group, as
    ``fixed/bytes/codec`` percentage string (``-`` when no sample in the
    group carried a breakdown)."""
    mixes = []
    for s in grp:
        ph = s.phases
        if ph is None:
            continue
        total = sum(ph.values())
        if total <= 0:
            continue
        mixes.append([ph["fixed"] / total, ph["bytes"] / total,
                      ph["codec"] / total])
    if not mixes:
        return "-"
    med = [
        statistics.median(m[i] for m in mixes) for i in range(3)
    ]
    return "/".join(f"{round(100 * v):d}" for v in med) + "%"


def residual_table(
    samples, skipped: dict | None = None, attribution: dict | None = None
) -> str:
    """Human-readable per-(topo, codec, tier) residual summary — the CLI
    twin of the feedback fitter's extractor (``python -m
    flextree_tpu_torch.obs residuals DIR``).  The ``phases f/b/c`` column is the group's median
    predicted phase mix (fixed/bytes/codec — the component-wise
    ``CostBreakdown`` shares the per-phase fit consumes); ``attribution``
    optionally maps :func:`residual_group_key` keys to a drifted-phase
    string (``planner.feedback.attribute_groups``) rendered as a final
    ``drift`` column."""
    if not samples:
        lines = ["no predicted-vs-measured residual pairs in this record"]
        if skipped and skipped.get("unmeasured_plans"):
            lines.append(
                f"({skipped['unmeasured_plans']} planned span(s) were never "
                "measured: run with the feedback prober on — "
                "docs/FEEDBACK.md)"
            )
        return "\n".join(lines)

    groups: dict[tuple, list[ResidualSample]] = {}
    for s in samples:
        groups.setdefault(residual_group_key(s), []).append(s)
    head = (
        f"{'topo':>10} {'codec':>6} {'tier':>10} {'count':>6} "
        f"{'med pred':>10} {'med meas':>10} {'med |r|':>8} {'max |r|':>8} "
        f"{'phases f/b/c':>13}"
    )
    if attribution:
        head += f" {'drift':>14}"
    lines = [head, "-" * len(head)]
    for key, grp in sorted(groups.items()):
        topo, codec, tier = key
        row = (
            f"{topo:>10} {codec:>6} {tier:>10} {len(grp):>6} "
            f"{statistics.median(s.predicted_us for s in grp):>9.1f}u "
            f"{statistics.median(s.measured_us for s in grp):>9.1f}u "
            f"{statistics.median(s.rel_residual for s in grp):>8.3f} "
            f"{max(s.rel_residual for s in grp):>8.3f} "
            f"{_phase_mix(grp):>13}"
        )
        if attribution:
            row += f" {attribution.get(key, '-'):>14}"
        lines.append(row)
    if skipped:
        parts = [f"{k}={v}" for k, v in sorted(skipped.items()) if v]
        if parts:
            lines.append("skipped: " + ", ".join(parts))
    return "\n".join(lines)


def write_trace(doc: dict, path: str | os.PathLike) -> str:
    path = os.fspath(path)
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return path
