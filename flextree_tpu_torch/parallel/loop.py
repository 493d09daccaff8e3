"""Training loop driver: steps, checkpointing, logging, resume, recovery.

The port's counterpart of ``flextree_tpu/parallel/loop.py::fit`` without
runtime supervision.  It runs any ``step_fn(state, tokens, targets) ->
(state, metrics)`` (:func:`.train.make_train_step`) over an ``LMDataset``
with the same contract as the JAX loop:

- ``state['step']`` is the single source of truth for progress: batches
  are addressed by it (``dataset.batch_at(step)``, prefetched on a
  thread), checkpoints are named by it, and resume reads it back, so a
  run interrupted at any step and resumed gives the same parameters as a
  straight-through run;
- a NaN/Inf guard skips a step whose loss (or grad norm, or the MoE
  step's ``aux`` or ``total``) is non-finite,
  rewinds to the last verified checkpoint after ``max_bad_steps``
  consecutive skips, and raises :class:`TrainingDiverged` once
  ``max_rewinds`` rewinds have not cured it; restores fall back past a
  corrupt checkpoint;
- every step's wall time, device work included, lands in the
  ``train.step_ms`` histogram of the run's metrics registry
  (:class:`..obs.MetricsRegistry`), whose snapshot the
  :class:`RunReport` carries.

Runtime supervision (JAX's ``Supervision``, field for field): pass a
:class:`Supervision` and the loop gains a step watchdog (a hung step
raises a typed ``FT_STEP_TIMEOUT`` instead of blocking forever, with a
bounded retry for transient stalls), heartbeat-driven membership (this
rank beats through a ``runtime.Supervisor``; dead peers confirmed by the
``membership`` view trigger live shrink-to-survivors: drain pending
saves, restore the newest CRC-verified checkpoint, replan the collective
topology with ``planner.replan_for_survivors``, rebuild the step through
``on_shrink`` and resume, with no process restart), straggler
accounting, and preemption-aware checkpointing (a
``runtime.PreemptionGuard``'s SIGTERM flag takes a synchronous
"checkpoint now" path within one step; a ``runtime.BackgroundSaver``
moves periodic saves off the step path).  ``Supervision()`` with every
field None leaves the loop as it is without it.

A retried step is exact: the step is functional and writes into no
buffer that outlives it (the in-process transport's messages land in
each call's own buffers, ZeRO-1's ``_Slots`` hold indices and its shard
buffers are new a step, the overlap side stream is joined before the
step returns, and each rank's ``ef`` is a new tree), so the abandoned
worker, should it finish, leaves nothing the retry reads.

Closed-loop planner feedback (``Supervision(feedback=)``, a
``planner.feedback.FeedbackController``): after every step but the last
the loop calls its ``maybe_tick``, which with no flight recorder
installed is one ``None`` check; on its cadence it times probes (or, in
its probe-free mode, reads the per-step spans the loop feeds it: the
step's bucket plan from ``utils.profiling.plan_capture`` and its time,
waited for on the card) and past its drift band hands back a refitted
plan and a rebuilt step, which the loop swaps in through the shrink's
swap path without a restore.  A tick or span clock that raises records
``feedback_error`` and disarms feedback for the rest of the run; training
goes on under the current plan.

The coordinated control plane (``Supervision(coordination=)``) and the
arbiter lease (``fit(arbiter=)``) are not ported yet (ROADMAP.md, Queue
1: 'Checkpoint, supervision and feedback plumbing'): they raise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Any, Callable

import torch

from ..obs import MetricsRegistry, dump_current, get_registry, record_event
from ..utils.checkpoint import (
    latest_checkpoint,
    restore_train_state,
    save_train_state,
)
from ..utils.logging import get_logger
from ..utils.profiling import plan_capture

__all__ = [
    "FitConfig",
    "FitResult",
    "RunReport",
    "ShrinkExhausted",
    "Supervision",
    "TrainingDiverged",
    "fit",
]

log = get_logger("flextree_tpu_torch.train")

_ITEM = ("ROADMAP.md, Queue 1: 'Checkpoint, supervision and feedback "
         "plumbing'")


class TrainingDiverged(RuntimeError):
    """The NaN/Inf guard exhausted its recovery budget: ``max_bad_steps``
    consecutive anomalies with no checkpoint to rewind to, or
    ``max_rewinds`` rewinds that did not cure the divergence."""


class ShrinkExhausted(RuntimeError):
    """Peers kept dying past the ``Supervision.max_shrinks`` budget — the
    run refuses to keep replanning around a collapsing world."""


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """The JAX ``FitConfig``, field for field."""

    num_steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    max_to_keep: int = 3
    log_every: int = 10
    resume: bool = True  # restore from ckpt_dir's latest checkpoint if any
    # background-prefetch depth (0 disables)
    prefetch: int = 2
    # NaN/Inf guard: skip non-finite steps; rewind after max_bad_steps
    # consecutive skips; give up after max_rewinds rewinds
    nan_guard: bool = True
    max_bad_steps: int = 3
    max_rewinds: int = 2


@dataclasses.dataclass
class Supervision:
    """Runtime-supervision wiring for :func:`fit`, the JAX
    ``Supervision`` field for field (a None field leaves its feature off).

    ``supervisor``: a ``runtime.Supervisor`` — this rank's heartbeat
    emitter, started and stopped by ``fit`` and fed each step's duration.
    ``membership``: a ``runtime.MembershipView`` (or any callable
    returning ``{rank: state_str}``) polled every ``check_every`` steps.
    ``configured_world``: the roster size at start (default: the first
    poll's).  ``step_timeout_s``: the watchdog deadline (None reads
    ``FT_STEP_TIMEOUT``; unset: no watchdog); a timed-out step is retried
    up to ``max_step_retries`` times when no death is confirmed, then the
    ``runtime.StepTimeout`` propagates.  ``on_shrink(n_alive, plan)``:
    the rebuild hook of a shrink — None keeps the current step, a
    ``(step_fn, comm, None)`` triple runs the survivor world's step, and
    a 5-tuple adds ``(state_pack, state_unpack)`` for it (ZeRO-1's
    reshard: the survivors restore the consolidated checkpoint, or
    consolidate the live state when there is none, and recarve it).
    ``nbytes_hint`` prices the replan; ``max_shrinks`` bounds them.
    ``preemption``: a ``runtime.PreemptionGuard`` polled every
    iteration.  ``background_saver``: a ``runtime.BackgroundSaver`` for
    the periodic saves (the final save stays synchronous, after a drain).
    ``feedback``: a ``planner.feedback.FeedbackController`` (module
    docstring).

    ``coordination`` (the JAX coordinated control plane) is not ported:
    setting it raises."""

    supervisor: Any = None
    membership: Any = None
    configured_world: int | None = None
    check_every: int = 1
    step_timeout_s: float | None = None
    max_step_retries: int = 1
    on_shrink: Callable | None = None
    nbytes_hint: int = 4 << 20
    max_shrinks: int = 2
    preemption: Any = None
    background_saver: Any = None
    feedback: Any = None
    coordination: Any = None


@dataclasses.dataclass
class RunReport:
    """End-of-run accounting of what the recovery machinery did: the JAX
    ``RunReport``'s fields and names (the lease and control fields stay
    empty: their modules are not ported)."""

    anomalies: int = 0  # non-finite steps skipped
    skipped_steps: list = dataclasses.field(default_factory=list)
    rewinds: int = 0  # checkpoint rewinds after consecutive anomalies
    ckpt_fallbacks: int = 0  # corrupt checkpoints skipped during restore
    resumed_from: int = 0
    init_retries: int = 0  # bring-up attempts beyond the first
    # --- runtime supervision (all zero/empty when fit ran unsupervised) ---
    step_timeouts: int = 0  # watchdog deadlines hit (FT_STEP_TIMEOUT)
    step_retries: int = 0  # timed-out steps retried (no death confirmed)
    stragglers: list = dataclasses.field(default_factory=list)
    # --- closed-loop planner feedback (zero without a controller) ---
    feedback_refits: int = 0  # drift-triggered constant refits
    feedback_replans: int = 0  # refits whose on_replan hook swapped the step
    feedback_refusals: int = 0  # refits refused (starved/degenerate samples)
    lease_epochs: list = dataclasses.field(default_factory=list)
    # membership epochs: entry 0 is the starting world, one more per live
    # shrink — {"step", "alive", "configured", "topo", "dead"}
    membership_epochs: list = dataclasses.field(default_factory=list)
    control_epochs: list = dataclasses.field(default_factory=list)
    preempted_at: int | None = None  # step the SIGTERM checkpoint ran at
    background_saves: int = 0  # off-step-path checkpoint writes
    # the run's metrics registry snapshot (train.step_ms and the counters)
    metrics: dict | None = None

    def to_payload(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_payload(), indent=2, sort_keys=True)


@dataclasses.dataclass
class FitResult:
    state: Any
    losses: list  # (step, loss) pairs at log points
    steps_run: int
    resumed_from: int
    report: RunReport = dataclasses.field(default_factory=RunReport)


def _metrics_finite(metrics) -> bool:
    """Host-side finiteness of the guard metrics: the loss, the grad norm,
    and the MoE step's router ``aux`` and optimized ``total``."""
    for key in ("loss", "grad_norm", "aux", "total"):
        if key in metrics and not math.isfinite(float(metrics[key])):
            return False
    return True


def _stamp_step(state: dict, step: int) -> dict:
    """A copy of ``state`` with ``state['step']`` set to ``step``."""
    new = dict(state)
    new["step"] = torch.tensor(step, dtype=state["step"].dtype,
                               device=state["step"].device)
    return new


def _apply_rebuild(rebuilt, cur_pack, cur_unpack):
    """``(step_fn, state_pack, state_unpack)`` of an ``on_shrink`` result:
    a triple keeps the current checkpoint converters (its comm and specs
    are the caller's; restores go to the device of ``state['step']``)."""
    if len(rebuilt) == 5:
        return rebuilt[0], rebuilt[3], rebuilt[4]
    return rebuilt[0], cur_pack, cur_unpack


def _disarm_feedback(step: int, exc: Exception, what: str) -> bool:
    """Feedback never kills the run: record why it failed (in the flight
    record, which outlives the process log) and disarm it.  Returns the
    new ``feedback_dead``."""
    record_event("feedback_error", step=step,
                 reason=f"{type(exc).__name__}: {exc}"[:300])
    log.exception("feedback %s failed at step %d; planner feedback disarmed "
                  "for the rest of the run", what, step)
    return True


def _refuse_unported(supervision, arbiter) -> None:
    for bad, what in ((arbiter is not None, "fit(arbiter=)"),
                      (supervision is not None
                       and supervision.coordination is not None,
                       "Supervision(coordination=)")):
        if bad:
            raise NotImplementedError(f"{what} is not ported yet ({_ITEM})")


def fit(state, step_fn: Callable, dataset, cfg: FitConfig = FitConfig(), *,
        supervision: Supervision | None = None, arbiter=None,
        state_pack: Callable | None = None,
        state_unpack: Callable | None = None) -> FitResult:
    """Run ``step_fn`` for ``cfg.num_steps`` total steps over ``dataset``.

    Restores go to the device of ``state['step']``.  The run's metrics
    registry (the ambient one when a flight recorder is installed, else
    the run's own) receives ``train.step_ms`` and the run's counters; its
    snapshot is ``result.report.metrics``.

    ``state_pack``/``state_unpack`` convert the live state to and from its
    checkpoint layout: every save writes ``state_pack(state)`` and every
    restore returns ``state_unpack(loaded)``.  The ZeRO-1 trainer passes
    :func:`.zero.make_consolidate_fn` and :func:`.zero.make_reshard_fn`,
    so its checkpoints are the replicated layout, the same for any world
    size; a live shrink may swap both through ``on_shrink``'s 5-tuple.

    ``supervision`` arms the runtime supervision (:class:`Supervision`);
    without it the loop is the unsupervised one."""
    _refuse_unported(supervision, arbiter)
    report = RunReport()
    sup = supervision
    reg = get_registry()
    if reg is None:
        reg = MetricsRegistry()
    step_ms = reg.histogram("train.step_ms")
    dev = state["step"].device
    # the current epoch's step and converters: a live shrink swaps them
    cur_step_fn, cur_pack, cur_unpack = step_fn, state_pack, state_unpack

    def _fallback(bad_path, exc):
        report.ckpt_fallbacks += 1

    def _restore():
        loaded = restore_train_state(cfg.ckpt_dir, dev, on_fallback=_fallback)
        return loaded if cur_unpack is None else cur_unpack(loaded)

    def _packed(s):
        return s if cur_pack is None else cur_pack(s)

    def _save(s):
        save_train_state(cfg.ckpt_dir, _packed(s),
                         max_to_keep=cfg.max_to_keep)

    resumed_from = 0
    if cfg.resume and cfg.ckpt_dir and latest_checkpoint(cfg.ckpt_dir):
        state = _restore()
        resumed_from = int(state["step"])
        report.resumed_from = resumed_from
        log.info("resumed from step %d (%s)", resumed_from, cfg.ckpt_dir)

    losses: list = []
    start = int(state["step"])
    t0 = time.perf_counter()
    step = start
    bad_streak = 0

    def _batches(from_step):
        if (cfg.prefetch and from_step < cfg.num_steps
                and hasattr(dataset, "iter_from")):
            from ..data import prefetch

            return prefetch(dataset.iter_from(from_step), size=cfg.prefetch)
        return None

    batches = _batches(start)

    def _run_step(st, tokens, targets):
        # the step's device work is waited for inside the call, so the
        # watchdog's deadline covers the kernels, not only their launch
        out = cur_step_fn(st, tokens, targets)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    # ---- runtime supervision (sup=None leaves the unsupervised loop)
    watchdog = step_timeout = world = None
    feedback_dead = False  # a tick raised: feedback disarmed for the run
    known_dead: set = set()
    flagged_stragglers: set = set()
    shrinks = timeout_retries = 0
    if sup is not None:
        from ..runtime.watchdog import (
            StepTimeout,
            StepWatchdog,
            step_timeout_from_env,
        )

        step_timeout = (sup.step_timeout_s if sup.step_timeout_s is not None
                        else step_timeout_from_env())
        if step_timeout is not None:
            watchdog = StepWatchdog()
        if sup.supervisor is not None:
            sup.supervisor.start()

        def _poll_membership() -> dict | None:
            """The liveness source as ``{rank: state_str}``."""
            m = sup.membership
            if m is None:
                return None
            if hasattr(m, "poll"):
                return {r: s.state for r, s in m.poll().items()}
            return dict(m())

        def _drained_saves(timeout=30.0) -> bool:
            """True when no background save is pending or in flight; False
            means a slow save still owns the directory, and the caller
            must start no second writer (or restore) against it."""
            if sup.background_saver is None:
                return True
            ok = sup.background_saver.drain(timeout)
            if not ok:
                log.warning("background save still in flight after %.0fs "
                            "drain; skipping the conflicting synchronous "
                            "writer", timeout)
            return ok

        def _shrink(at_step, new_dead):
            """Live shrink-to-survivors: drain, rebuild, restore, resume."""
            nonlocal state, world, shrinks, step, batches
            nonlocal cur_step_fn, cur_pack, cur_unpack
            from ..planner.choose import replan_for_survivors

            prev_world = world
            n_alive = max(1, world - len(new_dead))
            plan = replan_for_survivors(n_alive, sup.nbytes_hint,
                                        configured=prev_world)
            log.warning("membership shrink at step %d: ranks %s dead, %d/%d "
                        "alive; replanned topo %s", at_step, new_dead,
                        n_alive, prev_world, plan.to_ft_topo())
            _drained_saves(timeout=None)  # a restore never races a save
            old_pack = cur_pack  # the old world's consolidator, pre-swap
            rebuilt = (sup.on_shrink(n_alive, plan)
                       if sup.on_shrink is not None else None)
            if rebuilt is not None:
                cur_step_fn, cur_pack, cur_unpack = _apply_rebuild(
                    rebuilt, cur_pack, cur_unpack)
            if cfg.ckpt_dir and latest_checkpoint(cfg.ckpt_dir):
                state = _restore()
                step = int(state["step"])
                log.warning("restored checkpointed step %d for the survivor "
                            "world", step)
            elif old_pack is not None or cur_unpack is not None:
                # no checkpoint yet, but the layout depends on the world
                # (ZeRO-1 shards): the old world consolidates the live
                # state, the survivor world recarves it
                packed = old_pack(state) if old_pack is not None else state
                state = cur_unpack(packed) if cur_unpack is not None \
                    else packed
                log.warning("no checkpoint to restore: resharded the live "
                            "state for the survivor world")
            world = n_alive
            shrinks += 1
            report.membership_epochs.append({
                "step": at_step, "alive": n_alive, "configured": prev_world,
                "topo": plan.to_ft_topo(), "dead": list(new_dead)})
            record_event("shrink", step=at_step, dead=list(new_dead),
                         alive=n_alive, configured=prev_world,
                         topo=plan.to_ft_topo())
            dump_current("peer_shrink", step=at_step, dead=list(new_dead))
            batches = _batches(step)

        def _membership_tick(at_step) -> str:
            """One liveness poll: record stragglers, shrink on new deaths.
            Returns "shrunk", "ok" or "unknown" (no membership source)."""
            nonlocal world
            statuses = _poll_membership()
            if statuses is None:
                return "unknown"
            if world is None:
                world = sup.configured_world or len(statuses)
            for r, st in sorted(statuses.items()):
                if st == "straggler" and r not in flagged_stragglers:
                    flagged_stragglers.add(r)
                    report.stragglers.append({"rank": r, "step": at_step})
                    record_event("straggler", peer=r, step=at_step)
                    log.warning("rank %d classified straggler at step %d",
                                r, at_step)
            new_dead = sorted(r for r, st in statuses.items()
                              if st == "dead" and r not in known_dead)
            if not new_dead:
                return "ok"
            known_dead.update(new_dead)
            if shrinks >= sup.max_shrinks:
                raise ShrinkExhausted(
                    f"ranks {new_dead} died at step {at_step} after "
                    f"{shrinks} shrink(s); max_shrinks={sup.max_shrinks}")
            _shrink(at_step, new_dead)
            return "shrunk"

        # epoch 0: the starting world
        if sup.membership is not None or sup.configured_world:
            statuses0 = _poll_membership() or {}
            world = sup.configured_world or (len(statuses0) or None)
            if world:
                report.membership_epochs.append({
                    "step": start, "alive": world, "configured": world,
                    "topo": None, "dead": []})

    record_event("fit_start", id=start, step=start, num_steps=cfg.num_steps,
                 resumed_from=resumed_from)
    try:
        while step < cfg.num_steps:
            if sup is not None:
                if sup.preemption is not None and sup.preemption.preempted:
                    # checkpoint now: at most one step lost.  A drain that
                    # times out means the in-flight background save is a
                    # recent checkpoint; a second writer would race it
                    if cfg.ckpt_dir and _drained_saves():
                        _save(state)
                    report.preempted_at = step
                    record_event("preempt", step=step)
                    dump_current("preempted", step=step)
                    log.warning("preemption: checkpointed at step %d, "
                                "exiting", step)
                    break
                if (sup.membership is not None
                        and step % max(1, sup.check_every) == 0
                        and _membership_tick(step) == "shrunk"):
                    continue
            tokens, targets = (
                next(batches) if batches is not None else dataset.batch_at(step)
            )
            record_event("step_start", step=step)
            t_step = time.perf_counter()
            if sup is None:
                new_state, metrics = cur_step_fn(state, tokens, targets)
            else:
                # probe-free feedback: when the controller wants per-step
                # spans (probe-free with the recorder on; off, one None
                # check), capture the step's bucket plan and wait for the
                # card before reading the clock, so the span clock gets
                # the step's time and not its launch's
                fb = sup.feedback
                fb_spans = (fb is not None and not feedback_dead
                            and hasattr(fb, "wants_step_spans")
                            and fb.wants_step_spans())
                try:
                    with (plan_capture() if fb_spans
                          else contextlib.nullcontext()) as fb_cap:
                        new_state, metrics = (
                            watchdog.run(_run_step, state, tokens, targets,
                                         timeout_s=step_timeout, step=step)
                            if watchdog is not None
                            else cur_step_fn(state, tokens, targets))
                        if fb_spans and dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                except StepTimeout as e:
                    report.step_timeouts += 1
                    log.warning("%s", e)
                    dump_current("watchdog_timeout", step=step)
                    batches = _batches(step)  # reseek: the batch was consumed
                    if (sup.membership is not None
                            and _membership_tick(step) == "shrunk"):
                        timeout_retries = 0
                        continue
                    if timeout_retries < sup.max_step_retries:
                        timeout_retries += 1
                        report.step_retries += 1
                        log.warning("retrying step %d after timeout (%d/%d)",
                                    step, timeout_retries,
                                    sup.max_step_retries)
                        continue
                    raise
                timeout_retries = 0
                if fb_spans:
                    try:
                        if fb_cap:
                            fb.set_step_plan(fb_cap)
                        fb.observe_step(step, time.perf_counter() - t_step)
                    except Exception as e:  # noqa: BLE001 — the obs contract
                        feedback_dead = _disarm_feedback(step, e,
                                                         "span clock")
            # the guard reads the metrics back, which waits for the step's
            # device work; without it, wait explicitly so the time is the
            # step's and not its launch's
            finite = _metrics_finite(metrics) if cfg.nan_guard else True
            if not cfg.nan_guard and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dur_s = time.perf_counter() - t_step
            step_ms.observe(dur_s * 1e3)
            if sup is not None and sup.supervisor is not None:
                sup.supervisor.record_step(step, dur_s)
            record_event("step_end", step=step)
            if not finite:
                report.anomalies += 1
                report.skipped_steps.append(step)
                bad_streak += 1
                record_event("nan_skip", step=step, streak=bad_streak)
                log.warning("step %d: non-finite loss/grad (%d consecutive) "
                            "— update skipped", step, bad_streak)
                if bad_streak >= cfg.max_bad_steps:
                    if not (cfg.ckpt_dir and latest_checkpoint(cfg.ckpt_dir)):
                        raise TrainingDiverged(
                            f"{bad_streak} consecutive non-finite steps at "
                            f"step {step} and no checkpoint to rewind to"
                        )
                    if report.rewinds >= cfg.max_rewinds:
                        raise TrainingDiverged(
                            f"still diverging after {report.rewinds} rewinds "
                            f"(step {step})"
                        )
                    if sup is not None:
                        _drained_saves(timeout=None)
                    dump_current("nan_rewind", step=step)
                    state = _restore()
                    report.rewinds += 1
                    bad_streak = 0
                    step = int(state["step"])
                    record_event("nan_rewind", step=step)
                    log.warning("rewound to checkpointed step %d", step)
                    batches = _batches(step)
                    continue
                # skip: discard the poisoned update, advance past the batch
                step += 1
                state = _stamp_step(state, step)
                continue
            state = new_state
            bad_streak = 0
            step += 1
            if (sup is not None and sup.feedback is not None
                    and not feedback_dead and step < cfg.num_steps):
                # closed-loop planner feedback on the loop thread, after
                # the step returned (never beside an abandoned watchdog
                # worker's step); not after the last step, whose plan no
                # step would run
                try:
                    decision = sup.feedback.maybe_tick(step)
                    if decision is not None and decision.rebuilt is not None:
                        # the shrink's swap minus the restore: the world
                        # did not change, only the plan
                        cur_step_fn, cur_pack, cur_unpack = _apply_rebuild(
                            decision.rebuilt, cur_pack, cur_unpack)
                    # a probe-free rotation (a bucket-size variant of the
                    # same plan, values unchanged) swaps without a refit
                    if decision is not None and not getattr(
                            decision, "rotation", False):
                        report.feedback_refits += 1
                        report.feedback_replans += \
                            decision.rebuilt is not None
                        record_event("feedback_replan", step=step,
                                     topo=decision.plan.to_ft_topo(),
                                     invalidated=decision.invalidated,
                                     swapped=decision.rebuilt is not None)
                        log.warning(
                            "feedback replan at step %d: topo %s, %d cache "
                            "entr%s invalidated%s", step,
                            decision.plan.to_ft_topo(), decision.invalidated,
                            "y" if decision.invalidated == 1 else "ies",
                            "" if decision.rebuilt is not None
                            else " (no rebuild hook: plan recorded only)")
                except Exception as e:  # noqa: BLE001 — the obs contract
                    # an unwritable calibration path, a failed probe or a
                    # broken rebuild hook; _apply_rebuild returns before
                    # any name is rebound, so no swap is half-applied
                    feedback_dead = _disarm_feedback(step, e, "tick")
            if cfg.log_every and (step % cfg.log_every == 0
                                  or step == cfg.num_steps):
                loss = float(metrics["loss"])
                losses.append((step, loss))
                rate = (step - start) / (time.perf_counter() - t0)
                log.info("step %d loss %.4f%s (%.1f steps/s)", step, loss,
                         "".join(f" {k} {float(metrics[k]):.4f}"
                                 for k in ("aux", "total") if k in metrics),
                         rate)
            if cfg.ckpt_dir and cfg.ckpt_every and step % cfg.ckpt_every == 0:
                if sup is not None and sup.background_saver is not None:
                    # off the step path (the pack, a collective, runs here)
                    sup.background_saver.submit(_packed(state))
                else:
                    _save(state)
        # the preemption path already saved this exact state
        if cfg.ckpt_dir and step > start and report.preempted_at is None:
            if sup is None or _drained_saves():
                _save(state)
    finally:
        if sup is not None:
            if sup.feedback is not None:
                # refusals happen inside the controller (a refused refit
                # returns no decision): mirror its count into the report
                report.feedback_refusals = getattr(sup.feedback, "refusals",
                                                   0)
            if sup.background_saver is not None:
                sup.background_saver.drain()
                report.background_saves = sup.background_saver.saves
            if sup.supervisor is not None:
                sup.supervisor.stop()
            if watchdog is not None:
                watchdog.close()
        reg.counter("train.steps").inc(max(step - start, 0))
        reg.counter("train.anomalies").inc(report.anomalies)
        reg.counter("train.rewinds").inc(report.rewinds)
        reg.counter("train.step_timeouts").inc(report.step_timeouts)
        reg.counter("train.shrinks").inc(
            max(len(report.membership_epochs) - 1, 0))
        reg.counter("train.background_saves").inc(report.background_saves)
        reg.counter("train.feedback_refits").inc(report.feedback_refits)
        reg.counter("train.feedback_replans").inc(report.feedback_replans)
        reg.counter("train.feedback_refusals").inc(report.feedback_refusals)
        reg.gauge("train.last_step").set(step)
        report.metrics = reg.snapshot()
        record_event("fit_end", id=start, step=step)
        if cfg.ckpt_dir:
            os.makedirs(cfg.ckpt_dir, exist_ok=True)
            with open(os.path.join(cfg.ckpt_dir, "run_report.json"), "w") as f:
                f.write(report.to_json())
    return FitResult(state, losses, step - start, resumed_from, report)
