"""Run the probe-free planner feedback end to end and check it.

    python -m flextree_tpu_torch.tools.probe_free_feedback [--out PATH] \\
        [--baseline tmp/feedback_convergence.json] [--smoke]
    python -m flextree_tpu_torch.tools.probe_free_feedback --device cpu --smoke

The port's counterpart of the JAX package's ``tools/probe_free_feedback.py``:
the mis-calibrated start of ``tools.feedback_convergence`` recovered with
zero dedicated probe collectives.  Every recorded training step is the
measurement (host-timed, waited for on the card, against its bucket plan,
``obs/stepclock.py``), drift is detected from the per-step spans, and the
refit solves per-phase scale factors across a rotation of bucket sizes,
which change the schedule and never a value, so the sample is production
traffic.  On an in-process mesh of 8 ranks of one device (``cuda`` by
default):

1. the oracle calibration (measured fit) and the skewed one, as the
   convergence tool makes them;
2. the compute floor: the sync-free twin (``make_nosync_train_step``)
   timed for a few steps; it enters no communication span (checked with
   a span ledger);
3. the probe-free run: ``fit(supervision=Supervision(feedback=...))``
   with ``probe_free=True`` and a probe timer that raises if called;
   the controller detects, rotates the step through bucket sizes, fits
   the per-phase scales, writes the refit (``source="feedback"``,
   ``fit.mode="probe-free"``), drops the plan cache and swaps in the
   replanned step;
4. fleet pooling: three probe-based mini runs each record a thin
   residual set (one topology at two sizes, which alone refuses to fit);
   ``python -m flextree_tpu_torch.obs fleet`` pools them by fingerprint
   and the pooled fit must be better conditioned than every run's own;
5. checks (exit 1 on a violation): zero probe collectives in the
   probe-free run (no ``ftfb`` event, no probing tick, no
   ``feedback_error``, and the fold kernel's launches in the run exactly
   the launches the steps' syncs make by the code) and a probe-free refit
   with per-phase scales; the dropped plan-cache entry measured again;
   the timeline valid with measured spans paired to planned ones; the
   recovery (oracle over recovered, paired rounds) at least 0.9 x the
   probe-based recovery of ``--baseline`` (the port's own convergence
   run; 0.9 without one); the mis-calibration gap at least 1.05; the
   span clock's host cost a step, timed directly with the recorder on,
   under 2% of a step.

``--smoke`` shrinks every measured phase and waives the timing floors,
keeping every correctness check.  Results go to ``--out`` (default
``tmp/probe_free_feedback.json``), which must lie under ``tmp/``; the JAX
package's committed ``FEEDBACK.json``, ``OBS_ATTRIBUTION.json`` and
``BENCH_*.json`` are refused, as out and as baseline.
"""

from __future__ import annotations

import contextlib
import io
import json
import tempfile
import time

from . import checked_out, committed
from .feedback_convergence import (
    MISCAL_GAP_FLOOR,
    N,
    Scenario,
    finish,
    header,
    parser,
    skew_params,
    timeline_checks,
)

RECOVERY_VS_PROBE_FLOOR = 0.90
SPAN_BUDGET_FRAC = 0.02  # the span clock's cost a step


def main(argv=None) -> int:
    ap = parser(__doc__, "probe_free_feedback.json")
    ap.add_argument("--baseline", default=None,
                    help="the port's probe-based run "
                    "(feedback_convergence's --out): its recovery sets "
                    "this run's floor")
    args = ap.parse_args(argv)
    out = checked_out(ap, args.out)
    if args.baseline and committed(args.baseline):
        ap.error(f"--baseline {args.baseline}: a committed JAX result; "
                 f"give the port's own convergence run")

    from ..device import resolve_device

    dev = resolve_device(args.device)
    smoke = args.smoke
    every_k = 5
    cycles = 2 if smoke else 3
    # detection tick + (2 variants + the base) x cycles swaps + the fit
    # tick + the recovered tail, with room for a second rotation when a
    # noisy first window refuses the fit
    num_steps = every_k * (3 * cycles * 2 + (4 if smoke else 8))
    time_repeat = 6 if smoke else 16
    floor_steps = 3 if smoke else 6
    violations: list[str] = []
    result = header(args, dev, {"recovery_vs_probe": RECOVERY_VS_PROBE_FLOOR,
                                "miscal_gap": MISCAL_GAP_FLOOR,
                                "span_overhead": SPAN_BUDGET_FRAC})
    result["protocol"] = {"devices": N, "every_k": every_k,
                          "num_steps": num_steps, "rotation_cycles": cycles,
                          "time_repeat": time_repeat}
    with tempfile.TemporaryDirectory(prefix="ft-probefree-") as td:
        sc = Scenario(dev, smoke, args.seed, td)
        result["model"] = {"param_bytes": sc.param_bytes,
                           "n_leaves": sc.n_leaves}
        print("== phase 1: oracle calibration + deliberate skew", flush=True)
        oracle = sc.oracle_params(3 if smoke else 7)
        oracle_path = sc.save("CALIBRATION_oracle.json", oracle, "measured",
                              "probe_free_feedback oracle fit")
        skew = skew_params()
        live, frozen = (sc.save(name, skew, "measured",
                                "DELIBERATELY SKEWED (probe_free_feedback)")
                        for name in ("CALIBRATION_live.json",
                                     "CALIBRATION_skew.json"))
        result["plans"] = {"oracle": sc.plan(oracle),
                           "miscalibrated": sc.plan(skew)}
        print(f"   plans: {result['plans']}", flush=True)
        if sc.buckets(skew) == sc.buckets(oracle):
            violations.append("scenario invalid: the skewed and the oracle "
                              "constants give the same bucket plan")
        step_oracle = sc.pinned(oracle_path)

        print("== phase 2: compute floor from the sync-free twin",
              flush=True)
        floor_us, nosync_spans = compute_floor(sc, live, floor_steps)
        result["compute_floor"] = {"floor_us": floor_us,
                                   "nosync_comm_spans": nosync_spans,
                                   "steps": floor_steps}
        if nosync_spans:
            violations.append(f"the sync-free twin entered {nosync_spans} "
                              "communication span(s)")

        print("== phase 3: probe-free feedback run (skewed start)",
              flush=True)
        run = probe_free_run(sc, live, skew, floor_us, every_k, cycles,
                             num_steps, violations)
        ctl = run.pop("controller")
        result.update(run)
        result["plans"]["recovered"] = sc.plan(ctl.params)
        step_recovered = sc.pinned(live)
        step_miscal = sc.pinned(frozen)

        print("== phase 4: fleet pooling across thin single-shape runs",
              flush=True)
        result["fleet"] = fleet(sc, oracle, violations)
        print(f"   pooled condition {result['fleet'].get('pooled_condition')}"
              f", single {result['fleet'].get('single_conditions')}",
              flush=True)

        print("== phase 5: paired step timing (oracle / miscal / recovered)",
              flush=True)
        timing = sc.paired({"oracle": step_oracle, "miscal": step_miscal,
                            "recovered": step_recovered}, time_repeat)
        baseline = None
        if args.baseline:
            with open(args.baseline) as f:
                baseline = json.load(f)["timing"]["recovery_frac"]
        floor = RECOVERY_VS_PROBE_FLOOR * (baseline or 1.0)
        result["timing"] = {**timing, "probe_based_recovery": baseline,
                            "probe_based_from": args.baseline,
                            "recovery_floor": floor,
                            "protocol": "median of per-round paired ratios "
                            "(shuffled-interleaved rounds)"}
        print(f"   paired recovery {timing['recovery_frac']:.3f} (floor "
              f"{floor:.3f} = {RECOVERY_VS_PROBE_FLOOR} x probe-based "
              f"{baseline}), miscal gap {timing['miscal_gap']:.3f}",
              flush=True)
        if not smoke:
            if timing["recovery_frac"] < floor:
                violations.append(
                    f"probe-free recovery {timing['recovery_frac']:.3f} < "
                    f"floor {floor:.3f}")
            if timing["miscal_gap"] < MISCAL_GAP_FLOOR:
                violations.append(
                    f"mis-calibrated gap {timing['miscal_gap']:.3f} < "
                    f"{MISCAL_GAP_FLOOR}: the scenario proves nothing")

        print("== phase 6: the span clock's cost a step", flush=True)
        result["span_overhead"] = span_overhead(
            sc, live, ctl.params, floor_us, timing["rows"]["oracle"]["min_ms"],
            violations, smoke)
        print(f"   {result['span_overhead']}", flush=True)
    return finish(out, result, violations, "probe-free attribution")


def compute_floor(sc, path, steps) -> tuple[float, int]:
    """The sync-free twin's fastest step (µs) and the communication spans
    it entered."""
    import torch

    from ..bench.harness import make_nosync_train_step
    from ..utils.profiling import span_ledger

    nosync = make_nosync_train_step(sc.model_cfg, sc.train_cfg,
                                    device=sc.dev, comm=sc.comm)
    toks, tgts = sc.batch
    times = []
    with sc.env(path), span_ledger() as led:
        for _ in range(steps + 1):
            if sc.dev.type == "cuda":
                torch.cuda.synchronize(sc.dev)
            t0 = time.perf_counter()
            nosync(sc.state, toks, tgts)
            if sc.dev.type == "cuda":
                torch.cuda.synchronize(sc.dev)
            times.append(time.perf_counter() - t0)
    return min(times[1:]) * 1e6, len(led.names)


class CountedSteps:
    """Builds steps (``build(train_cfg)``) that count the fold launches
    their syncs make by the code (``train.step_sync_fold_launches`` of
    ``model_cfg``'s ``params`` over ``comm``, under the calibration in
    force at the call): the sum is what a run of them may launch on the
    card (a CPU run launches no kernel, and counts nothing)."""

    def __init__(self, build, model_cfg, params, comm, device):
        self.build, self.model_cfg, self.params = build, model_cfg, params
        self.comm, self.device = comm, device
        self.expected, self._memo = 0, {}

    def __call__(self, train_cfg):
        from ..models.transformer import param_specs
        from ..parallel import train as tm
        from ..planner.calibrate import _params_to_dict, default_params

        step = self.build(train_cfg)

        def counted(state, tokens, targets):
            if self.device.type == "cuda":
                key = (train_cfg, json.dumps(_params_to_dict(
                    default_params()), sort_keys=True))
                if key not in self._memo:
                    self._memo[key] = tm.step_sync_fold_launches(
                        self.model_cfg, train_cfg, self.params,
                        param_specs(self.model_cfg), self.comm,
                        tm.AXIS_NAMES, tuple(tokens.shape))
                self.expected += self._memo[key]
            return step(state, tokens, targets)

        return counted


def probe_free_run(sc, live, skew, floor_us, every_k, cycles, num_steps,
                   violations) -> dict:
    from ..obs import flight_recorder
    from ..obs.timeline import read_dir, residual_pairs, residual_table
    from ..ops import reduce_stacked as rs
    from ..parallel.loop import FitConfig, Supervision, fit
    from ..parallel.train import TrainConfig
    from ..planner.feedback import FeedbackConfig, FeedbackController

    cache = sc.path("plan_cache.json")
    with sc.env(live):
        cache_sources = [sc.autotune(cache)]
    obs_dir = sc.path("obs")
    rebuilds, rotations = [], []
    steps = CountedSteps(sc.step, sc.model_cfg, sc.state["params"], sc.comm,
                         sc.dev)

    def on_replan(plan, params):
        rebuilds.append(plan.to_ft_topo())
        return (steps(sc.train_cfg), sc.comm, None)

    def on_rotate(bucket_bytes):
        rotations.append(int(bucket_bytes))
        return (steps(TrainConfig(bucket_bytes=int(bucket_bytes))),
                sc.comm, None)

    def forbidden(probes, n):
        raise AssertionError("the probe timer ran in the probe-free run")

    controller = FeedbackController(
        N, sc.param_bytes,
        FeedbackConfig(
            every_k=every_k, band=0.5, probe_free=True,
            compute_floor_us=floor_us, rotation_cycles=cycles,
            # rotate down: many small buckets move the step's fixed cost
            # well past the noise, inside the regime the α-β model holds
            rotation_factors=(0.0625, 0.25), calibration_path=live,
            plan_cache_path=cache, on_replan=on_replan, on_rotate=on_rotate,
            run_id="probe_free_feedback"),
        params=skew, timer=forbidden, device=sc.dev)
    first = steps(sc.train_cfg)
    rs.reduce_sources.launches = 0
    t0 = time.perf_counter()
    with sc.env(live), flight_recorder(obs_dir, 0):
        run = fit(sc.state, first, sc.dataset,
                  FitConfig(num_steps=num_steps, log_every=0, prefetch=0),
                  supervision=Supervision(feedback=controller))
    launches = rs.reduce_sources.launches
    rep = run.report
    out = {"controller": controller}
    out["feedback_run"] = {
        "steps": run.steps_run, "seconds": time.perf_counter() - t0,
        "refits": rep.feedback_refits, "replans": rep.feedback_replans,
        "refusals": rep.feedback_refusals, "rotations": controller.rotations,
        "rotation_bucket_bytes": rotations, "rebuilds": rebuilds,
        "ticks": controller.ticks,
        "step_samples": len(controller.step_clock.samples)}
    print(f"   {out['feedback_run']}", flush=True)
    if rep.feedback_replans < 1:
        violations.append(
            f"no probe-free replan fired within {num_steps} steps "
            f"(refits={rep.feedback_refits}, refusals={rep.feedback_refusals},"
            f" rotations={controller.rotations})")
    with open(live) as f:
        sec = json.load(f).get(sc.backend, {})
    fit_meta = sec.get("meta", {}).get("fit", {})
    out["refit_calibration"] = {
        k: fit_meta.get(k) for k in ("mode", "phase_scales",
                                     "drifted_phase", "plans", "floor_us")}
    out["refit_calibration"]["source"] = sec.get("source")
    if sec.get("source") != "feedback" or fit_meta.get("mode") != \
            "probe-free" or not fit_meta.get("phase_scales"):
        violations.append(f"refit calibration: source {sec.get('source')!r}"
                          f", mode {fit_meta.get('mode')!r}, phase scales "
                          f"{fit_meta.get('phase_scales')}")
    with sc.env(live):
        cache_sources.append(sc.autotune(cache))
    out["plan_cache"] = {"sources": cache_sources}
    if cache_sources != ["measured", "measured"]:
        violations.append("the drift-dropped plan-cache entry was not "
                          f"measured again: {cache_sources}")

    events, _ = read_dir(obs_dir)

    def count(pred):
        return sum(1 for ev in events if pred(ev))

    audit = {
        "probe_events": count(lambda e: e.get("kind") == "bucket_measured"
                              and (e.get("axis") == "ftfb" or str(
                                  e.get("name", "")).startswith("ftfb"))),
        "probing_ticks": count(lambda e: e.get("kind") == "feedback_tick"
                               and e.get("probes", 0)),
        "feedback_errors": count(lambda e: e.get("kind") ==
                                 "feedback_error"),
        "per_step_bucket_measured": count(
            lambda e: e.get("kind") == "bucket_measured"
            and e.get("per_step")),
        "step_measured": count(lambda e: e.get("kind") == "step_measured"),
        "fold_launches": launches,
        "fold_launches_of_the_steps": steps.expected,
        "refusals": [ev.get("reason") for ev in events
                     if ev.get("kind") == "feedback_refused"],
    }
    out["probe_audit"] = audit
    if audit["probe_events"] or audit["probing_ticks"] or \
            audit["feedback_errors"] or launches != steps.expected:
        violations.append(f"the probe-free run ran probes: {audit}")
    if not audit["per_step_bucket_measured"]:
        violations.append("no per-step bucket_measured events recorded")
    samples, skipped = residual_pairs(events)
    with_phases = [s for s in samples if s.source == "step"
                   and s.phases is not None]
    out["residuals"] = {"samples": len(samples),
                        "per_step_with_breakdowns": len(with_phases),
                        "skipped": skipped,
                        "table": residual_table(samples,
                                                skipped).splitlines()}
    if not with_phases:
        violations.append("per-step residual samples carry no per-phase "
                          "breakdowns")
    tl = timeline_checks(obs_dir, violations)
    doc = tl.pop("doc")
    plans = {ev.get("name") for ev in doc["traceEvents"]
             if ev.get("cat") == "comm-plan"}
    tl["paired_phase_spans"] = sum(
        1 for ev in doc["traceEvents"] if ev.get("cat") == "comm-measured"
        and ev.get("name") in plans
        and isinstance(ev.get("args", {}).get("predicted"), dict))
    if not tl["paired_phase_spans"]:
        violations.append("the timeline pairs no measured span to a planned "
                          "one with its per-phase breakdown")
    out["timeline"] = tl
    return out


def fleet(sc, oracle, violations) -> dict:
    """Three thin probe-based runs (one topology at two sizes each), then
    ``obs fleet`` over their records."""
    from ..obs import flight_recorder
    from ..obs.__main__ import main as obs_cli
    from ..planner.feedback import (
        FeedbackConfig,
        FeedbackController,
        ProbePoint,
    )

    dirs = []
    for i, spec in enumerate(["8", "4,2", "ring"]):
        fdir = sc.path(f"fleet_{i}")
        mini = FeedbackController(
            N, sc.param_bytes,
            FeedbackConfig(probes=(ProbePoint(spec, 1 << 20),
                                   ProbePoint(spec, 1 << 16)),
                           band=1e9, every_k=1, repeat=2),
            params=oracle, device=sc.dev)
        with flight_recorder(fdir, 0):
            mini.tick(1)
        dirs.append(fdir)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obs_cli(["--device", sc.dev.type, "fleet", *dirs, "--json"])
    doc = json.loads(buf.getvalue())
    out = {"rc": rc, **doc}
    pooled = [e["condition"] for e in doc["pooled"].values()
              if e["condition"] is not None]
    if not pooled:
        violations.append("the fleet's pooled fit refused on every "
                          "fingerprint")
        return out
    singles = [r["condition"] if r["condition"] is not None
               else float("inf") for r in doc["runs"]]
    out["pooled_condition"] = min(pooled)
    out["single_conditions"] = [c if c != float("inf") else "refused"
                                for c in singles]
    if not all(min(pooled) < c for c in singles):
        violations.append(f"the pooled condition {min(pooled):.3g} is not "
                          f"below every run's own ({singles})")
    return out


def span_overhead(sc, live, params, floor_us, step_ms, violations,
                  smoke) -> dict:
    """The span clock's host path a step (events, apportioning, the
    detector, the spill; the full plan, the recorder on), timed directly
    over many calls, against the oracle step."""
    from ..obs import flight_recorder
    from ..planner.feedback import FeedbackConfig, FeedbackController
    from ..utils.profiling import plan_capture

    ctl = FeedbackController(
        N, sc.param_bytes,
        FeedbackConfig(probe_free=True, compute_floor_us=floor_us),
        params=params, device=sc.dev)
    step = sc.step()
    with tempfile.TemporaryDirectory() as d, sc.env(live), \
            flight_recorder(d, 0):
        with plan_capture() as cap:
            step(sc.state, *sc.batch)
        ctl.set_step_plan(cap)
        calls = 200
        t0 = time.perf_counter()
        for i in range(calls):
            ctl.observe_step(10_000 + i, step_ms * 1e-3)
        us = (time.perf_counter() - t0) / calls * 1e6
    frac = us / max(step_ms * 1e3, 1e-9)
    if not smoke and frac > SPAN_BUDGET_FRAC:
        violations.append(f"the span clock costs {frac:.4f} of a step > "
                          f"budget {SPAN_BUDGET_FRAC}")
    return {"clock_us_per_step": us, "frac_of_step": frac,
            "budget_frac": SPAN_BUDGET_FRAC,
            "buckets_in_plan": len(ctl.step_clock.plan.buckets)}


if __name__ == "__main__":
    raise SystemExit(main())
