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

Supervision (watchdog, heartbeats, live shrink, preemption), the arbiter
lease and the feedback replan are not ported yet (ROADMAP.md, Queue 1:
"Checkpoint, supervision and feedback plumbing"): passing
``supervision=`` or ``arbiter=`` raises.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from typing import Any, Callable

import torch

from ..obs import MetricsRegistry, record_event
from ..utils.checkpoint import (
    latest_checkpoint,
    restore_train_state,
    save_train_state,
)

__all__ = ["FitConfig", "FitResult", "RunReport", "TrainingDiverged", "fit"]

log = logging.getLogger("flextree_tpu_torch.train")


class TrainingDiverged(RuntimeError):
    """The NaN/Inf guard exhausted its recovery budget: ``max_bad_steps``
    consecutive anomalies with no checkpoint to rewind to, or
    ``max_rewinds`` rewinds that did not cure the divergence."""


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
class RunReport:
    """End-of-run accounting of what the recovery machinery did (the
    unsupervised subset of the JAX ``RunReport``)."""

    anomalies: int = 0  # non-finite steps skipped
    skipped_steps: list = dataclasses.field(default_factory=list)
    rewinds: int = 0  # checkpoint rewinds after consecutive anomalies
    ckpt_fallbacks: int = 0  # corrupt checkpoints skipped during restore
    resumed_from: int = 0
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


def fit(state, step_fn: Callable, dataset, cfg: FitConfig = FitConfig(), *,
        supervision=None, arbiter=None, state_pack: Callable | None = None,
        state_unpack: Callable | None = None) -> FitResult:
    """Run ``step_fn`` for ``cfg.num_steps`` total steps over ``dataset``.

    Restores go to the device of ``state['step']``.  The run's metrics
    registry receives ``train.step_ms`` and the run's counters; its
    snapshot is ``result.report.metrics``.

    ``state_pack``/``state_unpack`` convert the live state to and from its
    checkpoint layout: every save writes ``state_pack(state)`` and every
    restore returns ``state_unpack(loaded)``.  The ZeRO-1 trainer passes
    :func:`.zero.make_consolidate_fn` and :func:`.zero.make_reshard_fn`,
    so its checkpoints are the replicated layout, the same for any world
    size."""
    if supervision is not None or arbiter is not None:
        raise NotImplementedError(
            "fit(supervision=/arbiter=) is not ported yet (ROADMAP.md, "
            "Queue 1: 'Checkpoint, supervision and feedback plumbing')"
        )
    report = RunReport()
    reg = MetricsRegistry()
    step_ms = reg.histogram("train.step_ms")
    dev = state["step"].device

    def _fallback(bad_path, exc):
        report.ckpt_fallbacks += 1

    def _restore():
        loaded = restore_train_state(cfg.ckpt_dir, dev, on_fallback=_fallback)
        return loaded if state_unpack is None else state_unpack(loaded)

    def _save(state):
        save_train_state(cfg.ckpt_dir, state if state_pack is None
                         else state_pack(state), max_to_keep=cfg.max_to_keep)

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
    record_event("fit_start", id=start, step=start, num_steps=cfg.num_steps,
                 resumed_from=resumed_from)
    try:
        while step < cfg.num_steps:
            tokens, targets = (
                next(batches) if batches is not None else dataset.batch_at(step)
            )
            record_event("step_start", step=step)
            t_step = time.perf_counter()
            new_state, metrics = step_fn(state, tokens, targets)
            # the guard reads the metrics back, which waits for the step's
            # device work; without it, wait explicitly so the time is the
            # step's and not its launch's
            finite = _metrics_finite(metrics) if cfg.nan_guard else True
            if not cfg.nan_guard and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_ms.observe((time.perf_counter() - t_step) * 1e3)
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
                _save(state)
        if cfg.ckpt_dir and step > start:
            _save(state)
    finally:
        reg.counter("train.steps").inc(max(step - start, 0))
        reg.counter("train.anomalies").inc(report.anomalies)
        reg.counter("train.rewinds").inc(report.rewinds)
        reg.gauge("train.last_step").set(step)
        report.metrics = reg.snapshot()
        record_event("fit_end", id=start, step=step)
        if cfg.ckpt_dir:
            os.makedirs(cfg.ckpt_dir, exist_ok=True)
            with open(os.path.join(cfg.ckpt_dir, "run_report.json"), "w") as f:
                f.write(report.to_json())
    return FitResult(state, losses, step - start, resumed_from, report)
