"""Per-step cost attribution: host-timed steps keyed to their bucket plans.

The port's copy of ``flextree_tpu/obs/stepclock.py``.  Every bucket span
of the gradient sync carries its predicted ``CostBreakdown`` (its
provenance, :func:`..obs.provenance.bucket_provenance`); this module
turns every recorded training step into a measured sample against the
plan that step ran, with zero extra collectives:

- **the plan**: ``utils.profiling.plan_capture`` around a step collects
  the ``(name, provenance)`` of every bucket span the step entered, so
  the clock knows which (topo, world, codec, sharded, nbytes) points,
  and which predicted per-phase terms, the step ran;
- **the measurement**: the host times the whole step, waited for on the
  card (``parallel.loop.fit`` synchronizes the device before it reads
  the clock whenever the clock is armed); the per-bucket collectives
  inside it are not timed one by one;
- **attribution**: measured comm = step time minus the compute floor
  (``compute_floor_us`` when the caller knows it, else a provisional
  floor from the fastest observed step, :meth:`StepSpanClock.floor_us`),
  apportioned across the step's buckets by predicted share.  Within one
  step every bucket's measured/predicted ratio is the same by
  construction (``apportioned: true``), so per-phase information comes
  from variation across plans (the feedback controller's bucket-size
  rotation, or pooling runs with ``obs fleet``).

One difference from the JAX package: a JAX span fires once, while the
step is traced, so a capture holds a plan only on the step that compiles
it; here a span fires on every call, so every captured step hands the
clock its plan.  :meth:`StepSpanClock.set_plan` therefore keeps counting
when the captured plan's signature is the current one, and starts a new
plan (dropping its first step, the warm-up: first launches, allocator
growth) only when the signature changes.  The signature hashes the
buckets' pairing keys in capture order, which is the plan's order on
every step (the overlapped sync fires its buckets in the readiness
plan's order).

Event contract (read by ``obs.timeline.residual_pairs``, the merger and
``python -m flextree_tpu_torch.obs fleet``):

- ``step_measured``: one per sampled step, ``{step, step_us, floor_us,
  comm_us, predicted_us, plan_sig, n_buckets}``;
- ``bucket_measured`` with ``per_step: true``: one per bucket per sampled
  step, with the pairing keys ``bucket_planned`` uses (topo, world,
  codec, sharded, nbytes), the predicted per-phase breakdown, the
  apportioned ``measured_us`` and the ``plan_sig``.

Limits: the provisional floor detects only over-predicted comm (an
under-predicted wire hides inside it; supply ``compute_floor_us``, which
the probe-free refit also needs to split its fitted intercept), and the
first step of each plan is excluded.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import deque

from .recorder import record_event
from .timeline import _PHASE_TERMS

__all__ = [
    "PlannedBucket",
    "StepPlan",
    "StepSample",
    "StepSpanClock",
    "plan_from_capture",
    "PHASE_FIXED",
    "PHASE_BYTES",
    "PHASE_CODEC",
]

#: CostBreakdown terms grouped into the three phases the per-phase fit
#: solves for (fixed: latency + control; bytes: wire bandwidth + reduce;
#: codec), defined once in ``obs.timeline._PHASE_TERMS``.
PHASE_FIXED = _PHASE_TERMS["fixed"]
PHASE_BYTES = _PHASE_TERMS["bytes"]
PHASE_CODEC = _PHASE_TERMS["codec"]


@dataclasses.dataclass(frozen=True)
class PlannedBucket:
    """One captured bucket-axis span: the pairing keys plus the predicted
    per-phase breakdown, as ``bucket_planned`` recorded them."""

    name: str
    axis: str
    topo: str
    world: int | None
    nbytes: int
    codec: str
    sharded: bool
    predicted: dict  # per-term CostBreakdown (µs), as recorded
    predicted_us: float

    @property
    def fixed_us(self) -> float:
        return sum(float(self.predicted.get(k, 0.0)) for k in PHASE_FIXED)

    @property
    def bytes_us(self) -> float:
        return sum(float(self.predicted.get(k, 0.0)) for k in PHASE_BYTES)

    @property
    def codec_us(self) -> float:
        return sum(float(self.predicted.get(k, 0.0)) for k in PHASE_CODEC)


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """A step's bucket plan with its per-phase predicted totals: one row
    of the probe-free fit's design matrix."""

    buckets: tuple
    sig: str
    fixed_us: float
    bytes_us: float
    codec_us: float
    predicted_us: float


@dataclasses.dataclass(frozen=True)
class StepSample:
    """One measured step against the plan it ran."""

    step: int
    step_us: float
    plan_sig: str
    fixed_us: float  # the plan's predicted per-phase totals
    bytes_us: float
    codec_us: float
    predicted_us: float


def plan_from_capture(captured) -> StepPlan | None:
    """A :class:`StepPlan` from ``plan_capture()`` output.  Spans whose
    provenance carries no prediction (``predicted_error``, or a bare
    span) are skipped; None when nothing usable was captured."""
    buckets = []
    for name, prov in captured:
        if not isinstance(prov, dict) or prov.get("predicted_error"):
            continue
        predicted = prov.get("predicted")
        pred_us = prov.get("predicted_us")
        nbytes = prov.get("nbytes")
        if not isinstance(predicted, dict) or not isinstance(
            pred_us, (int, float)
        ) or nbytes is None:
            continue
        topo = prov.get("topo") or {}
        world = prov.get("world") or {}
        for ax in sorted(topo):
            spec = str(topo[ax])
            if spec == "psum":
                continue  # no cost-model row: nothing to attribute
            if spec == "1":
                spec = "ring"
            w = world.get(ax)
            buckets.append(
                PlannedBucket(
                    name=str(name),
                    axis=str(ax),
                    topo=spec,
                    world=int(w) if w is not None else None,
                    nbytes=int(nbytes),
                    codec=str(prov.get("codec", "f32")),
                    sharded=bool(prov.get("sharded", False)),
                    predicted=dict(predicted),
                    predicted_us=float(pred_us),
                )
            )
    if not buckets:
        return None
    buckets = tuple(buckets)
    sig_src = [
        (b.topo, b.world, b.codec, b.sharded, b.nbytes) for b in buckets
    ]
    sig = hashlib.sha256(
        json.dumps(sig_src, sort_keys=True).encode("utf-8")
    ).hexdigest()[:12]
    return StepPlan(
        buckets=buckets,
        sig=sig,
        fixed_us=sum(b.fixed_us for b in buckets),
        bytes_us=sum(b.bytes_us for b in buckets),
        codec_us=sum(b.codec_us for b in buckets),
        predicted_us=sum(b.predicted_us for b in buckets),
    )


class StepSpanClock:
    """The in-step span clock: hold the current plan, fold each step's
    wall time into per-step measured spans.

    ``compute_floor_us``: the step's non-comm floor when the caller knows
    it (a timed sync-free twin: zero collectives, so supplying one keeps
    a probe-free run probe-free).  ``None`` derives a provisional floor,
    ``min(step_us − predicted_comm_us)`` over completed steps clamped at
    0, refined by the rotation fit (``planner.feedback``).
    ``sample_every`` thins event emission (samples still accumulate every
    step).  The caller gates on the flight recorder; the clock itself is
    host bookkeeping.
    """

    def __init__(
        self,
        compute_floor_us: float | None = None,
        sample_every: int = 1,
        fingerprint: str | None = None,
        max_samples: int = 512,
    ):
        self.compute_floor_us = (
            float(compute_floor_us) if compute_floor_us is not None else None
        )
        self.sample_every = max(1, int(sample_every))
        self.fingerprint = fingerprint
        self.plan: StepPlan | None = None
        self._plan_steps = 0  # steps observed under the current plan
        self._floor_min: float | None = None  # provisional-floor tracker
        # bounded to the recent regime (512 steps covers a full rotation
        # cycle set); a refit solves from recent windows
        self.samples: deque[StepSample] = deque(
            maxlen=max(int(max_samples), 8)
        )
        self.dropped_first = 0  # first steps excluded, one a plan

    # -- plan management -----------------------------------------------

    def set_plan(self, captured) -> StepPlan | None:
        """Adopt a captured step's plan.  The same signature as the
        current plan keeps the count of its steps (every step of an eager
        run hands its plan in); a new one starts a plan whose first step
        is excluded.  Returns the plan in force, or None when the capture
        held nothing usable (the previous plan is kept)."""
        plan = plan_from_capture(captured)
        if plan is None:
            return None
        if self.plan is not None and plan.sig == self.plan.sig:
            return self.plan
        self.plan = plan
        self._plan_steps = 0
        return plan

    @property
    def floor_us(self) -> float | None:
        """The configured compute floor, else the provisional minimum of
        (step − predicted comm) seen so far."""
        if self.compute_floor_us is not None:
            return self.compute_floor_us
        return self._floor_min

    # -- the per-step hook ---------------------------------------------

    def observe_step(self, step: int, dur_s: float) -> StepSample | None:
        """Fold one step's wall time.  Returns the :class:`StepSample`
        (also appended to ``samples``), or None when no plan is known or
        this is the plan's first step."""
        plan = self.plan
        if plan is None:
            return None
        self._plan_steps += 1
        if self._plan_steps == 1:
            # the plan's first step: warm-up, not the plan's steady time
            self.dropped_first += 1
            return None
        step_us = float(dur_s) * 1e6
        if self.compute_floor_us is None:
            slack = max(step_us - plan.predicted_us, 0.0)
            if self._floor_min is None or slack < self._floor_min:
                self._floor_min = slack
        sample = StepSample(
            step=int(step),
            step_us=step_us,
            plan_sig=plan.sig,
            fixed_us=plan.fixed_us,
            bytes_us=plan.bytes_us,
            codec_us=plan.codec_us,
            predicted_us=plan.predicted_us,
        )
        self.samples.append(sample)
        if (self._plan_steps - 2) % self.sample_every == 0:
            self._emit(sample, plan)
        return sample

    def comm_us(self, sample: StepSample) -> float | None:
        """The sample's measured comm estimate under the current floor
        (None while no floor exists)."""
        floor = self.floor_us
        if floor is None:
            return None
        return max(sample.step_us - floor, 1e-3)

    # -- event emission -------------------------------------------------

    def _emit(self, sample: StepSample, plan: StepPlan) -> None:
        floor = self.floor_us
        comm = self.comm_us(sample)
        record_event(
            "step_measured",
            step=sample.step,
            step_us=round(sample.step_us, 3),
            floor_us=round(floor, 3) if floor is not None else None,
            comm_us=round(comm, 3) if comm is not None else None,
            predicted_us=round(plan.predicted_us, 3),
            plan_sig=plan.sig,
            n_buckets=len(plan.buckets),
        )
        if comm is None or plan.predicted_us <= 0:
            return
        for b in plan.buckets:
            share = b.predicted_us / plan.predicted_us
            record_event(
                "bucket_measured",
                name=b.name,
                axis=b.axis,
                topo={b.axis: b.topo},
                world={b.axis: b.world},
                nbytes=b.nbytes,
                codec=b.codec,
                sharded=b.sharded,
                measured_us=round(comm * share, 3),
                predicted_us=round(b.predicted_us, 3),
                predicted=b.predicted,
                fingerprint=self.fingerprint,
                step=sample.step,
                per_step=True,
                apportioned=True,
                plan_sig=plan.sig,
                floor_us=round(floor, 3),
            )
