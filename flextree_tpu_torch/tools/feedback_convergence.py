"""Run the closed planner-feedback loop end to end and check it.

    python -m flextree_tpu_torch.tools.feedback_convergence [--out PATH] [--smoke]
    python -m flextree_tpu_torch.tools.feedback_convergence --device cpu --smoke

The port's counterpart of the JAX package's ``tools/feedback_convergence.py``,
on an in-process mesh of 8 data-parallel ranks of one device (``cuda`` by
default; ``--device cpu`` for the plain versions on the host): real
collectives, real train steps, real flight records.

1. **Oracle calibration**: the cost constants fitted from freshly measured
   (topology, size) points (``calibrate.measure_points`` and
   ``fit_cost_params``, the calibration tool's protocol).
2. **Mis-calibration**: a calibration whose constants (near-free fixed
   costs, a starved wire) make the planner cut the gradient into tiny
   buckets instead of the oracle's fused ones.  The tool refuses the
   scenario when the two bucket plans coincide.
3. **The feedback run**: ``fit(supervision=Supervision(feedback=...))``
   from the skewed constants with the flight recorder on.  Every K steps
   the controller times its probes on the mesh; the drift band breaches,
   the constants are refit from the residuals
   (``save_calibration(source="feedback")``), the seeded autotune
   plan-cache entry is dropped, and the replan hook swaps in a rebuilt
   step, whose sync plans its buckets from the refit calibration.
4. **Checks** (exit 1 on a violation): a replan fired; the refit carries
   ``source="feedback"`` and its sample count; the dropped plan-cache
   entry is measured again by the next autotune and then hit; the flight
   record pairs residuals and merges into a valid timeline; the
   recovered step takes at most 1/0.9 of the oracle step's time (the
   median of per-round paired ratios over shuffled interleaved rounds);
   the mis-calibrated step is at least 1.05x slower than the oracle's;
   with no recorder the armed hook never ticks, and its cost, measured
   directly, is under 0.5% of a step.

Each step is the dense LM of the JAX tool (vocab 256, d_model 64, 4
heads, 6 layers, d_ff 128, batch 8 x 64) in float32 with the reference
attention.  ``--smoke`` shrinks every measured phase and waives the three
timing floors, keeping every correctness check.  Results go to ``--out``
(default ``tmp/feedback_convergence.json``), which must lie under
``tmp/``; the JAX package's committed ``FEEDBACK.json``,
``OBS_ATTRIBUTION.json`` and ``BENCH_*.json`` are refused.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import random
import statistics
import sys
import tempfile
import time

from . import checked_out

RECOVERY_FLOOR = 0.90  # recovered >= 90% of the oracle step's speed
MISCAL_GAP_FLOOR = 1.05  # the wrong plan must be measurably wrong
#: the armed hook's directly measured cost a step, as a fraction of the
#: step (one None check against a step of milliseconds)
OVERHEAD_FRAC_BUDGET = 0.005
N = 8


@contextlib.contextmanager
def calibration_env(path: str, backend: str):
    """``FLEXTREE_CALIBRATION`` (and ``_BACKEND``) pointed at ``path`` for
    the block; the sync reads it on every call."""
    saved = {k: os.environ.get(k) for k in (
        "FLEXTREE_CALIBRATION", "FLEXTREE_CALIBRATION_BACKEND")}
    os.environ["FLEXTREE_CALIBRATION"] = path
    os.environ["FLEXTREE_CALIBRATION_BACKEND"] = backend
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def skew_params():
    """Near-free fixed costs and a starved wire: the byte term dominates
    every fixed term, so the bucket argmin runs to tiny buckets."""
    from ..planner.cost_model import LinkParams, TpuCostParams

    return TpuCostParams(
        ici=LinkParams(bandwidth_GBps=0.01, latency_us=0.001),
        dcn=LinkParams(bandwidth_GBps=0.01, latency_us=0.001),
        reduce_bw_GBps=0.05, control_us_per_width=0.0, launch_us=0.001)


class Scenario:
    """The two feedback tools' shared set-up: the mesh, the model, its
    state and batch, and the calibrations of each phase, on ``device``."""

    def __init__(self, device, smoke: bool, seed: int, td: str):
        import torch

        from ..data import LMDataset, synthetic_tokens
        from ..models.transformer import TransformerConfig
        from ..parallel import train as tm
        from ..parallel.mesh import flat_mesh
        from ..planner.calibrate import backend_fingerprint

        self.dev, self.td, self.smoke = device, td, smoke
        self.backend = device.type
        # the process's own fingerprint: what default_params reads back
        self.fingerprint = backend_fingerprint(device)
        self.comm = flat_mesh(N, device, "dp")
        self.model_cfg = TransformerConfig(
            vocab_size=256, d_model=64, n_heads=4,
            n_layers=3 if smoke else 6, d_ff=128)
        self.train_cfg = tm.TrainConfig()
        self.state = tm.init_train_state(
            self.model_cfg, torch.Generator().manual_seed(seed),
            self.train_cfg, device=device, comm=self.comm)
        leaves = tm.tree_leaves(self.state["params"])
        self.param_bytes = sum(t.numel() * t.element_size() for t in leaves)
        self.n_leaves = len(leaves)
        self.dataset = LMDataset(synthetic_tokens(120_000, 256, seed=seed),
                                 batch=8, seq_len=64, seed=seed)
        self.batch = self.dataset.batch_at(0)

    def path(self, name: str) -> str:
        return os.path.join(self.td, name)

    def save(self, name: str, params, source: str, protocol: str) -> str:
        from ..planner.calibrate import save_calibration

        path = self.path(name)
        save_calibration(path, params, backend=self.backend,
                         fingerprint=self.fingerprint, source=source,
                         meta={"protocol": protocol})
        return path

    def oracle_params(self, repeat: int):
        """The constants fitted from freshly measured points."""
        from ..planner.calibrate import fit_cost_params, measure_points

        sizes = [1 << 14, 1 << 18] if self.smoke else \
            [1 << 14, 1 << 17, 1 << 20]
        points = measure_points(["8", "4,2", "2,2,2", "1"], sizes,
                                repeat=repeat, devices=N, device=self.dev)
        return fit_cost_params(points)

    def env(self, path: str):
        return calibration_env(path, self.backend)

    def buckets(self, params) -> list[int]:
        """The bytes of each bucket of the step's sync under ``params``."""
        from ..models.transformer import param_specs
        from ..parallel import bucketing as bk
        from ..parallel import train as tm

        leaves = tm.tree_leaves(self.state["params"])
        specs = bk.spec_leaves(self.state["params"],
                               param_specs(self.model_cfg))
        topos = tm.resolve_axis_topos(self.comm, tm.AXIS_NAMES,
                                      self.train_cfg.grad_topo)
        return [b.nbytes for b in bk.plan_buckets(
            leaves, specs, tm.AXIS_NAMES, topos=topos,
            axis_sizes=bk.comm_axis_sizes(self.comm, tm.AXIS_NAMES),
            params=params)]

    def plan(self, params) -> dict:
        from ..planner.choose import choose_topology

        buckets = self.buckets(params)
        return {"buckets": len(buckets), "bucket_bytes": max(buckets),
                "topo": choose_topology(N, self.param_bytes,
                                        params=params).to_ft_topo()}

    def step(self, train_cfg=None):
        from ..parallel import train as tm

        return tm.make_train_step(self.model_cfg, train_cfg or self.train_cfg,
                                  device=self.dev, comm=self.comm)

    def pinned(self, path: str, train_cfg=None):
        """A warm argument-free call of a step whose sync plans from the
        calibration at ``path``."""
        step = self.step(train_cfg)
        toks, tgts = self.batch

        def call():
            with self.env(path):
                return step(self.state, toks, tgts)

        call()
        return call

    def autotune(self, cache: str) -> str:
        from ..planner.autotune import autotune_plan

        return autotune_plan(N, self.param_bytes, codecs=("f32",), top_k=2,
                             repeat=2, cache_path=cache, ir_families=(),
                             device=self.dev).source

    def paired(self, calls: dict, repeat: int) -> dict:
        """Each call's interleaved rounds and the paired ratios: the
        recovery (oracle over recovered) and the mis-calibration gap
        (mis-calibrated over oracle), medians of per-round ratios."""
        from ..bench.harness import _interleaved_times

        rows = _interleaved_times(calls, repeat, self.dev)
        o, m, r = (rows[k]["times_ms"] for k in ("oracle", "miscal",
                                                 "recovered"))
        return dict(rows=rows,
                    recovery_frac=statistics.median(
                        a / max(b, 1e-9) for a, b in zip(o, r)),
                    miscal_gap=statistics.median(
                        a / max(b, 1e-9) for a, b in zip(m, o)))


def timeline_checks(obs_dir: str, violations: list) -> dict:
    """The merged timeline of a run's record: valid, with measured spans."""
    from ..obs.timeline import merge_dir, validate_trace

    doc = merge_dir(obs_dir)
    bad = validate_trace(doc)
    measured = [ev for ev in doc["traceEvents"]
                if ev.get("cat") == "comm-measured"]
    if bad:
        violations.append(f"merged timeline schema-invalid: {bad[:3]}")
    if not measured:
        violations.append("merged timeline has no comm-measured spans")
    return {"doc": doc, "events": len(doc["traceEvents"]),
            "schema_violations": bad, "comm_measured_spans": len(measured)}


def header(args, device, floors: dict) -> dict:
    from .calibrate_host import smi_line

    import torch

    return {
        "smoke": args.smoke,
        "date": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"),
        "device": {"type": device.type,
                   "name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "nvidia_smi": smi_line() if device.type == "cuda"
                   else None},
        "torch": torch.__version__,
        "floors": {**floors, "timing_floors_enforced": not args.smoke},
    }


def finish(out: str, result: dict, violations: list, what: str) -> int:
    result["violations"] = violations
    result["ok"] = not violations
    with open(out, "w") as f:
        json.dump(result, f, indent=1, sort_keys=True, default=str)
        f.write("\n")
    print(f"wrote {out}")
    for v in violations:
        print(f"VIOLATION: {v}", file=sys.stderr)
    if not violations:
        print(f"all {what} checks passed")
    return 1 if violations else 0


def parser(doc: str, default_out: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("tmp", default_out))
    ap.add_argument("--smoke", action="store_true",
                    help="shrink the measured phases; waive the timing "
                    "floors, keep the correctness checks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    ap = parser(__doc__, "feedback_convergence.json")
    args = ap.parse_args(argv)
    out = checked_out(ap, args.out)

    from ..device import resolve_device
    from ..obs import flight_recorder
    from ..obs.timeline import residual_table
    from ..parallel.loop import FitConfig, Supervision, fit
    from ..planner.feedback import (
        FeedbackConfig,
        FeedbackController,
        extract_residuals,
    )

    dev = resolve_device(args.device)
    smoke = args.smoke
    every_k = 3 if smoke else 5
    num_steps = every_k * (3 if smoke else 6)
    time_repeat = 6 if smoke else 16
    overhead_reps = 4 if smoke else 12
    violations: list[str] = []
    result = header(args, dev, {"recovery_frac": RECOVERY_FLOOR,
                                "miscal_gap": MISCAL_GAP_FLOOR,
                                "overhead_frac": OVERHEAD_FRAC_BUDGET})
    result["protocol"] = {"devices": N, "every_k": every_k,
                          "num_steps": num_steps, "time_repeat": time_repeat}
    with tempfile.TemporaryDirectory(prefix="ft-fbconv-") as td:
        sc = Scenario(dev, smoke, args.seed, td)
        result["model"] = {"param_bytes": sc.param_bytes,
                           "n_leaves": sc.n_leaves,
                           "n_layers": sc.model_cfg.n_layers}

        print("== phase 1: oracle calibration (measured fit)", flush=True)
        oracle = sc.oracle_params(3 if smoke else 7)
        oracle_path = sc.save("CALIBRATION_oracle.json", oracle, "measured",
                              "feedback_convergence oracle fit")
        print("== phase 2: deliberate mis-calibration", flush=True)
        skew = skew_params()
        live = sc.save("CALIBRATION_live.json", skew, "measured",
                       "DELIBERATELY SKEWED (feedback_convergence)")
        frozen = sc.save("CALIBRATION_skew.json", skew, "measured",
                         "DELIBERATELY SKEWED (feedback_convergence)")
        result["plans"] = {"oracle": sc.plan(oracle),
                           "miscalibrated": sc.plan(skew)}
        print(f"   plans: {result['plans']}", flush=True)
        if sc.buckets(skew) == sc.buckets(oracle):
            violations.append("scenario invalid: the skewed and the oracle "
                              "constants give the same bucket plan")
        step_oracle = sc.pinned(oracle_path)
        step_miscal = sc.pinned(frozen)

        print("== phase 3: feedback run from the mis-calibrated start",
              flush=True)
        cache = sc.path("plan_cache.json")
        with sc.env(live):
            cache_sources = [sc.autotune(cache)]
        obs_dir = sc.path("obs")
        rebuilds: list = []

        def on_replan(plan, params):
            rebuilds.append(plan.to_ft_topo())
            return (sc.step(), sc.comm, None)

        controller = FeedbackController(
            N, sc.param_bytes,
            FeedbackConfig(every_k=every_k, band=0.5, calibration_path=live,
                           plan_cache_path=cache, on_replan=on_replan,
                           run_id="feedback_convergence"),
            params=skew, device=dev)
        t0 = time.perf_counter()
        with sc.env(live), flight_recorder(obs_dir, 0):
            run = fit(sc.state, sc.step(), sc.dataset,
                      FitConfig(num_steps=num_steps, log_every=0,
                                prefetch=0),
                      supervision=Supervision(feedback=controller))
        rep = run.report
        result["feedback_run"] = {
            "steps": run.steps_run, "seconds": time.perf_counter() - t0,
            "refits": rep.feedback_refits, "replans": rep.feedback_replans,
            "refusals": rep.feedback_refusals, "rebuilds": rebuilds,
            "probe_ticks": controller.ticks}
        print(f"   {result['feedback_run']}", flush=True)
        if rep.feedback_replans < 1:
            violations.append(
                f"no feedback replan fired within {num_steps} steps "
                f"(refits={rep.feedback_refits}, "
                f"refusals={rep.feedback_refusals})")
        with open(live) as f:
            sec = json.load(f).get(sc.backend, {})
        result["refit_calibration"] = {
            "source": sec.get("source"), "schema": sec.get("schema"),
            "samples": sec.get("meta", {}).get("samples"),
            "run_id": sec.get("meta", {}).get("run_id")}
        if sec.get("source") != "feedback" or \
                not sec.get("meta", {}).get("samples"):
            violations.append(f"refit calibration source "
                              f"{sec.get('source')!r}, samples "
                              f"{sec.get('meta', {}).get('samples')}")
        result["plans"]["recovered"] = sc.plan(controller.params)
        step_recovered = sc.pinned(live)

        with sc.env(live):
            cache_sources += [sc.autotune(cache), sc.autotune(cache)]
        result["plan_cache"] = {"sources": cache_sources}
        if cache_sources != ["measured", "measured", "cache"]:
            violations.append(
                "plan-cache trail should be seeded-measured -> "
                "re-measured-after-invalidation -> cache-hit; got "
                f"{cache_sources}")

        samples, skipped = extract_residuals(obs_dir)
        result["residuals"] = {
            "samples": len(samples),
            "paired": sum(s.source == "paired" for s in samples),
            "skipped": skipped,
            "table": residual_table(samples, skipped).splitlines()}
        if not samples:
            violations.append("flight record yielded no residual samples")
        tl = timeline_checks(obs_dir, violations)
        tl.pop("doc")
        result["timeline"] = tl

        print("== phase 4: paired step timing (oracle / miscal / recovered)",
              flush=True)
        timing = sc.paired({"oracle": step_oracle, "miscal": step_miscal,
                            "recovered": step_recovered}, time_repeat)
        result["timing"] = {
            **timing, "protocol": "median of per-round paired ratios "
            "(shuffled-interleaved rounds)"}
        oracle_ms = timing["rows"]["oracle"]["min_ms"]
        print(f"   oracle {oracle_ms:.3f} ms, miscal "
              f"{timing['rows']['miscal']['min_ms']:.3f} ms, recovered "
              f"{timing['rows']['recovered']['min_ms']:.3f} ms (min); "
              f"paired recovery {timing['recovery_frac']:.3f}, miscal gap "
              f"{timing['miscal_gap']:.3f}", flush=True)
        if not smoke:
            if timing["recovery_frac"] < RECOVERY_FLOOR:
                violations.append(
                    f"recovered step holds only "
                    f"{timing['recovery_frac']:.3f} of the oracle step's "
                    f"speed < floor {RECOVERY_FLOOR}")
            if timing["miscal_gap"] < MISCAL_GAP_FLOOR:
                violations.append(
                    f"mis-calibrated step gap {timing['miscal_gap']:.3f} "
                    f"< {MISCAL_GAP_FLOOR}: the scenario proves nothing "
                    "on this device")

        print("== phase 5: recorder-off cost of the armed hook", flush=True)
        result["overhead"] = overhead(sc, controller.params, every_k,
                                      oracle_ms, overhead_reps, violations,
                                      smoke)
        print(f"   {result['overhead']}", flush=True)
    return finish(out, result, violations, "feedback-convergence")


def overhead(sc, params, every_k, step_ms, reps, violations, smoke) -> dict:
    """With no recorder the armed hook never ticks; its cost a step,
    timed directly, against the step.  A paired whole-fit A/B (armed with
    no recorder against unarmed) is recorded beside it as context: its
    run-to-run wander on a shared host is far larger than the hook."""
    from ..parallel.loop import FitConfig, Supervision, fit
    from ..planner.feedback import FeedbackConfig, FeedbackController

    def exploding(probes, n):
        raise AssertionError("probe timer ran with the recorder off")

    armed = FeedbackController(N, sc.param_bytes,
                               FeedbackConfig(every_k=every_k),
                               params=params, timer=exploding, device=sc.dev)
    calls = 100_000
    t0 = time.perf_counter()
    for i in range(calls):
        armed.maybe_tick(i)
    hook_us = (time.perf_counter() - t0) / calls * 1e6
    frac = hook_us / max(step_ms * 1e3, 1e-9)
    if armed.ticks:
        violations.append("the controller ticked with no recorder installed")
    if not smoke and frac > OVERHEAD_FRAC_BUDGET:
        violations.append(f"recorder-off hook costs {frac:.2e} of a step > "
                          f"budget {OVERHEAD_FRAC_BUDGET}")
    step = sc.step()
    steps = 6
    laps: dict = {"armed": [], "off": []}
    order = list(laps)
    shuffler = random.Random(0)
    for _ in range(reps):
        shuffler.shuffle(order)
        for name in order:
            sup = Supervision(feedback=armed) if name == "armed" \
                else Supervision()
            t0 = time.perf_counter()
            fit(sc.state, step, sc.dataset,
                FitConfig(num_steps=steps, log_every=0, prefetch=0),
                supervision=sup)
            laps[name].append(time.perf_counter() - t0)
    return {"hook_us_per_step": hook_us, "overhead_frac_of_step": frac,
            "frac_budget": OVERHEAD_FRAC_BUDGET,
            "fit_ab_ratio_informational":
                min(laps["armed"]) / max(min(laps["off"]), 1e-9),
            "reps": reps, "steps_per_fit": steps}


if __name__ == "__main__":
    raise SystemExit(main())
