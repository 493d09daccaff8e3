"""CLI: merge per-rank flight-recorder files into one Chrome trace.

The port's copy of ``python -m flextree_tpu.obs``.  Usage::

    python -m flextree_tpu_torch.obs merge  OBS_DIR --out timeline.json
    python -m flextree_tpu_torch.obs validate timeline.json
    python -m flextree_tpu_torch.obs summary OBS_DIR
    python -m flextree_tpu_torch.obs residuals OBS_DIR [--fingerprint FP] [--json]
    python -m flextree_tpu_torch.obs metrics OBS_DIR [--prom]
    python -m flextree_tpu_torch.obs fleet OBS_DIR [OBS_DIR ...] [--json] [--fit-out PATH]
    python -m flextree_tpu_torch.obs --device cpu summary OBS_DIR

Like every entry point of the port, it resolves ``--device`` first
(``cuda`` by default) and refuses without a card unless given ``--device
cpu``; the subcommands themselves read files on the host.

``merge`` fuses every ``flight_*.jsonl`` (+ ``*.dump.json``) under
OBS_DIR into one timeline (ranks as tracks, requests/buckets as flows)
and validates it before writing — a merge that would not load in
Perfetto exits non-zero.  Open the result at https://ui.perfetto.dev or
``chrome://tracing``.  ``summary`` prints per-rank event/dump counts —
the 10-second "what did this run leave behind".  ``residuals`` prints
the per-(topo, codec, tier) predicted-vs-measured comm residual table
built from ``timeline.residual_pairs``, with a ``drift`` column naming
each group's drifted phase (``planner.feedback.attribute_groups``);
``--fingerprint`` narrows to one measuring backend and ``--json`` emits
the machine-readable sample list instead of the table.  ``metrics`` prints the per-rank
``metrics_{rank}.json`` registry snapshots; with ``--prom`` they render
as Prometheus text exposition (histogram ``_bucket``/``_sum``/``_count``
series plus windowed ``_window_p99`` gauges), so serving SLO instruments
are scrapeable without parsing the JSON.  ``fleet`` pools the residual
samples of many runs' obs dirs per backend fingerprint and fits each pool
with ``planner.feedback.fit_residuals_auto`` (the α-β solve where the
pooled geometry allows it, else the per-phase scales), beside each run's
own fit; ``--fit-out`` writes the largest pool's fit as a calibration
section (``source="feedback"``, the dirs and sample count under
``meta.fleet``).  It exits non-zero when nothing could be fitted.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import sys
from collections import Counter as _Counter

from ..device import resolve_device
from .metrics import prometheus_exposition
from .timeline import (
    merge_events,
    read_dir,
    residual_pairs,
    residual_table,
    validate_trace,
    write_trace,
)


def _sample_json(s) -> dict:
    return {
        "topo": s.topo,
        "world": s.world,
        "codec": s.codec,
        "sharded": s.sharded,
        "nbytes": s.nbytes,
        "predicted_us": s.predicted_us,
        "measured_us": s.measured_us,
        "rel_residual": round(s.rel_residual, 6),
        "fingerprint": s.fingerprint,
        "step": s.step,
        "source": s.source,
        "phases": s.phases,
    }


def _fit_condition(meta: dict) -> float | None:
    cond = meta.get("condition")
    return float(cond) if isinstance(cond, (int, float)) else None


def _dir_samples(dir: str):
    events, _dumps = read_dir(dir)
    return residual_pairs(events)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flextree_tpu_torch.obs",
                                 description=__doc__)
    ap.add_argument("--device", default=None,
                    help="the device this run is on (default cuda; "
                    "without a card pass --device cpu)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser("merge", help="merge an obs dir into a Chrome trace")
    mp.add_argument("dir")
    mp.add_argument("--out", default="timeline.json")
    vp = sub.add_parser("validate", help="schema-check a merged trace")
    vp.add_argument("trace")
    sp = sub.add_parser("summary", help="per-rank event/dump counts")
    sp.add_argument("dir")
    rp = sub.add_parser(
        "residuals",
        help="per-(topo, codec, tier) predicted-vs-measured residual table",
    )
    rp.add_argument("dir")
    rp.add_argument(
        "--fingerprint",
        help="only samples measured under this backend fingerprint",
    )
    rp.add_argument(
        "--json", action="store_true",
        help="emit the machine-readable sample list instead of the table",
    )
    xp = sub.add_parser(
        "metrics", help="per-rank metrics registry snapshots"
    )
    xp.add_argument("dir")
    xp.add_argument(
        "--prom", action="store_true",
        help="Prometheus text exposition instead of JSON",
    )
    fp = sub.add_parser(
        "fleet",
        help="pool residuals from many runs' obs dirs per fingerprint "
        "and fit the pooled set",
    )
    fp.add_argument("dirs", nargs="+")
    fp.add_argument("--fingerprint", help="fit only this fingerprint")
    fp.add_argument("--json", action="store_true")
    fp.add_argument(
        "--fit-out",
        help="persist the pooled refit as a calibration section "
        "(source='feedback', fleet provenance in meta)",
    )
    fp.add_argument(
        "--backend", default=None,
        help="calibration section name for --fit-out (default: the "
        "--device's type)",
    )
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.cmd == "merge":
        events, dumps = read_dir(args.dir)
        if not events:
            print(f"no flight_*.jsonl events under {args.dir}", file=sys.stderr)
            return 1
        doc = merge_events(events, dumps)
        bad = validate_trace(doc)
        if bad:
            for b in bad:
                print(f"invalid: {b}", file=sys.stderr)
            return 1
        path = write_trace(doc, args.out)
        print(
            f"merged {len(events)} events from {len(doc['otherData']['ranks'])} "
            f"rank(s) ({len(dumps)} dump(s)) -> {path}"
        )
        return 0

    if args.cmd == "validate":
        with open(args.trace, encoding="utf-8") as f:
            doc = json.load(f)
        bad = validate_trace(doc)
        for b in bad:
            print(f"invalid: {b}", file=sys.stderr)
        print(f"{args.trace}: {'INVALID' if bad else 'ok'} "
              f"({len(doc.get('traceEvents', []))} trace events)")
        return 1 if bad else 0

    if args.cmd == "residuals":
        samples, skipped = _dir_samples(args.dir)
        if not samples and not any(skipped.values()):
            print(f"no flight_*.jsonl events under {args.dir}", file=sys.stderr)
            return 1
        if args.fingerprint:
            samples = [s for s in samples if s.fingerprint == args.fingerprint]
        if args.json:
            print(json.dumps(
                {
                    "samples": [_sample_json(s) for s in samples],
                    "skipped": skipped,
                },
                indent=1, sort_keys=True,
            ))
            return 0
        # the per-group drift attribution of the per-phase fit
        attribution = None
        if samples:
            try:
                from ..planner.feedback import attribute_groups

                attribution = attribute_groups(samples)
            except Exception:  # noqa: BLE001 — the table must still print
                attribution = None
        print(residual_table(samples, skipped, attribution=attribution))
        return 0

    if args.cmd == "metrics":
        snaps: dict[str, dict] = {}
        for path in sorted(
            _glob.glob(os.path.join(args.dir, "metrics_*.json"))
        ):
            stem = os.path.splitext(os.path.basename(path))[0]
            rank = stem.split("_", 1)[1] if "_" in stem else stem
            try:
                with open(path, encoding="utf-8") as f:
                    snaps[rank] = json.load(f)
            except (OSError, ValueError) as e:
                print(f"skipping {path}: {e}", file=sys.stderr)
        if not snaps:
            print(f"no metrics_*.json under {args.dir}", file=sys.stderr)
            return 1
        if args.prom:
            sys.stdout.write(prometheus_exposition(snaps))
        else:
            print(json.dumps(snaps, indent=1, sort_keys=True))
        return 0

    if args.cmd == "fleet":
        return _fleet(args, dev)

    events, dumps = read_dir(args.dir)
    by_rank: dict[int, _Counter] = {}
    for ev in events:
        by_rank.setdefault(int(ev.get("rank", 0)), _Counter())[ev["kind"]] += 1
    for rank in sorted(by_rank):
        kinds = ", ".join(
            f"{k}={n}" for k, n in sorted(by_rank[rank].items())
        )
        dumped = dumps.get(rank)
        tail = f"  [dump: {dumped['reason']}]" if dumped else ""
        print(f"rank {rank}: {sum(by_rank[rank].values())} events ({kinds}){tail}")
    if not by_rank:
        print(f"no events under {args.dir}")
        return 1
    return 0


def _fleet(args, dev) -> int:
    """``fleet``: each run's fit, then each fingerprint's pooled fit."""
    from ..planner.feedback import FeedbackRefused, fit_residuals_auto

    runs = []
    by_fp: dict = {}
    fp_runs: dict = {}
    for dir in args.dirs:
        samples, skipped = _dir_samples(dir)
        if args.fingerprint:
            samples = [s for s in samples if s.fingerprint == args.fingerprint]
        row = {"dir": dir, "samples": len(samples), "skipped": skipped,
               "condition": None, "mode": None, "refused": None}
        if samples:
            try:
                _params, meta = fit_residuals_auto(samples)
                row["condition"] = _fit_condition(meta)
                row["mode"] = meta.get("mode")
            except FeedbackRefused as e:
                row["refused"] = str(e)[:200]
        else:
            row["refused"] = "no residual samples"
        runs.append(row)
        for s in samples:
            by_fp.setdefault(s.fingerprint, []).append(s)
            fp_runs.setdefault(s.fingerprint, set()).add(dir)

    pooled: dict = {}
    fitted: dict = {}
    for fpr, samples in sorted(by_fp.items(), key=lambda kv: str(kv[0])):
        entry = {"samples": len(samples), "runs": len(fp_runs.get(fpr, ())),
                 "condition": None, "mode": None, "drifted_phase": None,
                 "refused": None}
        try:
            params, meta = fit_residuals_auto(samples)
            entry["condition"] = _fit_condition(meta)
            entry["mode"] = meta.get("mode")
            entry["drifted_phase"] = meta.get("drifted_phase")
            fitted[fpr] = (params, meta)
        except FeedbackRefused as e:
            entry["refused"] = str(e)[:200]
        pooled[str(fpr)] = entry

    out_doc = {"runs": runs, "pooled": pooled, "fit_out": None}
    if args.fit_out and fitted:
        from ..planner.calibrate import save_calibration

        # the pool with the most samples (or the one --fingerprint kept)
        fpr = max(fitted, key=lambda k: len(by_fp[k]))
        params, meta = fitted[fpr]
        save_calibration(
            args.fit_out, params, backend=args.backend or dev.type,
            fingerprint=fpr, source="feedback",
            meta={"fleet": {"dirs": list(args.dirs),
                            "samples": len(by_fp[fpr]), "fit": meta}})
        out_doc["fit_out"] = args.fit_out
    if args.json:
        print(json.dumps(out_doc, indent=1, sort_keys=True))
    else:
        for r in runs:
            status = (f"condition {r['condition']:.3g} ({r['mode']})"
                      if r["condition"] is not None
                      else f"refused: {r['refused']}")
            print(f"{r['dir']}: {r['samples']} sample(s), {status}")
        for fpr, e in pooled.items():
            status = (
                f"condition {e['condition']:.3g} ({e['mode']}"
                + (f", drift {e['drifted_phase']}" if e["drifted_phase"]
                   else "") + ")"
                if e["condition"] is not None
                else f"refused: {e['refused']}")
            print(f"pooled[{fpr}]: {e['samples']} sample(s) from "
                  f"{len(args.dirs)} dir(s), {status}")
        if out_doc["fit_out"]:
            print(f"wrote pooled calibration -> {out_doc['fit_out']}")
    # pooling exists because single runs are thin: non-zero when nothing
    # could be fitted, also when a --fingerprint filter left no samples
    return 0 if fitted else 1


if __name__ == "__main__":
    raise SystemExit(main())
