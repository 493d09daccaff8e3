"""Closed-loop planner feedback: fit constants from flight records,
detect drift, replan in-run.

The port's copy of ``flextree_tpu/planner/feedback.py``.  Every bucket span
of the gradient sync carries its plan provenance and the planner's
predicted ``CostBreakdown`` (``obs.provenance.bucket_provenance``); this
module consumes the predicted-vs-measured residuals, so a run that starts
on a mis-calibrated host does not ride the wrong plan to its end (α-β
models must be anchored to measurement and re-anchored when measurement
disagrees, arXiv:2409.04202):

1. **Residual extraction** (:func:`extract_residuals`): pair each
   provenance-annotated ``bucket_planned`` span of a run's
   ``flight_*.jsonl`` files with the ``bucket_measured`` time at the same
   (topo, world, codec, sharded, nbytes) point — the pairing of
   ``obs/timeline.py::residual_pairs``, which the ``python -m
   flextree_tpu_torch.obs residuals`` CLI shares.
2. **Fitting** (:func:`fit_from_samples`): the samples in the
   :class:`~.calibrate.MeasuredPoint` form ``fit_cost_params`` consumes,
   solved for new α-β constants over ``calibrate.feature_vector``'s
   model-derived features, plus a codec-throughput rescale from
   compressed samples and a bwd-GFLOPs update from compute probes.
   Starved or degenerate sets raise :class:`FeedbackRefused`: a fit from
   three points, or from one shape measured fifty times, would hand the
   planner a confident lie.
3. **Drift detection** (:class:`DriftDetector`): sliding windows of
   relative residuals per (fingerprint, world, topology family, codec,
   sharded); a band breach triggers the replan and drops the matching
   autotune plan-cache entries (``autotune.invalidate_plan_cache``), so
   the next measured search measures again.
4. **In-run replanning** (:class:`FeedbackController`):
   ``fit(supervision=Supervision(feedback=...))`` ticks the controller
   every ``every_k`` steps; with the flight recorder on it times a small
   probe set of FlexTree allreduces on an in-process mesh of the card,
   feeds the detector and, past the band, refits, writes the constants
   back through ``save_calibration(source="feedback")``, invalidates the
   plan cache, re-runs ``choose_topology`` under the new constants and
   hands ``fit`` a rebuilt step through the swap path the live shrink
   uses.  With the recorder off the tick is one ``None`` check (the
   check ``record_event`` makes).

The **probe-free** mode (``FeedbackConfig(probe_free=True)``) runs no
dedicated probe: every step is host-timed against its bucket plan
(``obs/stepclock.py``), drift detection rides those per-step spans, and
a refit solves **per-phase scale factors** (:func:`fit_phase_scales`,
:func:`fit_probe_free`) across a rotation of bucket sizes, which change
the schedule and never a value.  The same per-phase machinery attributes
drift to a phase for the probe path (``fit_from_samples``'s meta) and
the residuals CLI (:func:`attribute_groups`); :func:`fit_residuals_auto`
backs ``python -m flextree_tpu_torch.obs fleet``'s cross-run pooling.
``python -m flextree_tpu_torch.tools.feedback_convergence`` and
``...tools.probe_free_feedback`` run both modes end to end.

Differences from the JAX package:

- the probe timer (:meth:`FeedbackController._default_timer`) times
  ``parallel.compressed.compressed_allreduce`` on ``flat_mesh(n)`` of the
  controller's device with the bench harness's interleaved rounds;
- the fingerprint: samples, events and the calibration write-back carry
  ``backend_fingerprint(device)``, the process's own (``r?`` outside a
  process group), which is what ``default_params`` compares a section
  against; the autotuner keys its plan-cache entries with the mesh's
  rank count (``r8``), so :func:`cache_invalidation_predicate` matches a
  ``r?`` fingerprint to this backend's entries at every rank count;
- the rotation's size cap is the controller's device's
  (``parallel.bucketing``'s card or host cap);
- the coordinated control plane (``coordination=``, a
  ``runtime.CoordinationHandle``): followers never probe, the
  coordinator proposes its refit as a group replan with a
  ``suggest_apply_step`` boundary, every rank applies the committed
  payload through :meth:`FeedbackController.apply_committed`, and every
  rank's ack carries its detector's window summary, which the
  coordinator pools before it decides.

Limits: probes measure the collective alone (in-step contention is not
in the sample); in-process mesh wires are memory copies, so the fit
cannot always split bandwidth from latency; lonely ``+k`` shapes have no
feature row (their samples inform drift, not the α-β solve); per-step
samples are step totals apportioned over the plan, so the byte phase is
identifiable only against a compute floor, and the fixed phase keeps the
base calibration's launch/latency split.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from ..obs.recorder import current_recorder, record_event
from ..obs.stepclock import StepSpanClock
from ..obs.timeline import (
    ResidualSample,
    read_dir,
    residual_group_key,
    residual_pairs,
    residual_table,
)
from ..schedule.stages import Topology
from ..utils.logging import get_logger
from .autotune import invalidate_plan_cache
from .calibrate import (
    MeasuredPoint,
    _params_from_dict,
    _params_to_dict,
    backend_fingerprint,
    default_params,
    feature_vector,
    fit_cost_params,
    save_calibration,
)
from .choose import choose_topology
from .cost_model import (
    LinkParams,
    TpuCostParams,
    allreduce_cost,
    lonely_allreduce_cost,
)

__all__ = [
    "FeedbackRefused",
    "ProbePoint",
    "ReplanDecision",
    "FeedbackConfig",
    "FeedbackController",
    "DriftDetector",
    "extract_residuals",
    "residual_report",
    "samples_to_points",
    "fit_from_samples",
    "fit_bwd_gflops",
    "fit_phase_scales",
    "fit_phase_scales_from_residuals",
    "fit_probe_free",
    "fit_residuals_auto",
    "scale_params",
    "attribute_groups",
    "predict_spec_us",
    "predict_spec_cost",
    "sample_family",
    "default_probe_points",
    "cache_invalidation_predicate",
]

log = get_logger("flextree_tpu_torch.feedback")


class FeedbackRefused(RuntimeError):
    """The residual set cannot support a fit: starved (too few samples /
    too few distinct points) or degenerate (ill-conditioned feature
    matrix, or the NNLS active set emptied).  Raised LOUDLY — the
    alternative, fitting anyway, hands the planner confident garbage,
    which is strictly worse than the stale constants it already has."""


# --------------------------------------------------------------- extraction


def extract_residuals(obs_dir: str) -> tuple[list[ResidualSample], dict]:
    """Predicted-vs-measured residual samples from a run's flight record
    (every ``flight_*.jsonl`` under ``obs_dir``) — the shared pairing of
    ``obs.timeline.residual_pairs``, so this extractor and the
    ``python -m flextree_tpu_torch.obs residuals`` CLI cannot diverge."""
    events, _dumps = read_dir(obs_dir)
    return residual_pairs(events)


def residual_report(obs_dir: str) -> str:
    """The CLI table for a recorded run's directory."""
    samples, skipped = extract_residuals(obs_dir)
    return residual_table(samples, skipped)


def _parse_spec(spec: str) -> tuple[tuple[int, ...] | None, int]:
    """FT_TOPO-style spec -> (widths, lonely); ``(None, 0)`` for specs
    with no cost-model row (the native-psum sentinel)."""
    spec = str(spec).strip()
    if spec in ("psum", ""):
        return None, 0
    if spec in ("ring", "1"):
        return (1,), 0
    lonely = 0
    if "+" in spec:
        spec, tail = spec.rsplit("+", 1)
        lonely = int(tail)
    widths = tuple(int(w) for w in spec.replace("*", ",").split(","))
    if any(w == 1 for w in widths):
        return (1,), lonely
    return widths, lonely


def sample_family(sample: ResidualSample) -> str:
    """Topology family of a residual sample: "ring" / "lonely" / "tree"
    (or "psum" for the native sentinel) — the drift detector's grouping
    granularity."""
    widths, lonely = _parse_spec(sample.topo)
    if widths is None:
        return "psum"
    if lonely:
        return "lonely"
    return "ring" if widths == (1,) else "tree"


def predict_spec_cost(
    spec: str,
    n: int,
    nbytes: int,
    params: TpuCostParams | None = None,
    codec: str | None = None,
):
    """Predicted :class:`CostBreakdown` for an FT_TOPO spec — priced by
    the SAME ``allreduce_cost`` the fit's ``feature_vector`` evaluates,
    so probe residuals and the solve agree on the model.  None for specs
    the model has no row for (psum)."""
    if params is None:
        params = default_params()
    widths, lonely = _parse_spec(spec)
    if widths is None:
        return None
    codec_obj = None
    if codec and codec != "f32":
        from ..ops.quantize import get_codec

        codec_obj = get_codec(codec)
    if lonely:
        tree = Topology(n - lonely, widths)
        return lonely_allreduce_cost(
            tree, lonely, nbytes, params, codec=codec_obj
        )
    topo = Topology.ring(n) if widths == (1,) else Topology(n, widths)
    return allreduce_cost(topo, nbytes, params, codec=codec_obj)


def predict_spec_us(
    spec: str,
    n: int,
    nbytes: int,
    params: TpuCostParams | None = None,
    codec: str | None = None,
) -> float | None:
    """Total predicted allreduce time for an FT_TOPO spec (see
    :func:`predict_spec_cost`)."""
    cost = predict_spec_cost(spec, n, nbytes, params, codec)
    return None if cost is None else cost.total_us


# ------------------------------------------------------------------ fitting


def samples_to_points(samples) -> list[MeasuredPoint]:
    """Residual samples -> the ``MeasuredPoint`` form ``fit_cost_params``
    consumes.  Only samples with a feature row qualify: identity codec
    (compressed wires fold codec time into the measurement — they feed
    the codec rescale instead), unsharded, known world, and tree/ring
    shapes (lonely ``+k`` folds have no ``feature_vector`` row).
    Per-step span-clock samples (``source == "step"``) are excluded too:
    their measured times are a step total *apportioned* over the plan by
    predicted share, so within one step every ratio is identical by
    construction — feeding them to the point-wise NNLS would manufacture
    confident agreement with whatever the model already predicted.  They
    carry per-phase information instead (:func:`fit_phase_scales`)."""
    points = []
    for s in samples:
        if s.codec != "f32" or s.sharded or s.world is None:
            continue
        if s.source == "step":
            continue
        widths, lonely = _parse_spec(s.topo)
        if widths is None or lonely:
            continue
        points.append(MeasuredPoint(widths, s.world, s.nbytes, s.measured_us))
    return points


def fit_bwd_gflops(compute_samples) -> float | None:
    """Median achieved backward GFLOP/s from ``(flops, seconds)`` compute
    probes (>= 2 positive samples required), or None — the overlap
    boundary equalizer's absolute compute scale.  Compute probes need a
    sync-free step to time (``bench.harness.make_nosync_train_step``);
    runs without one keep the backend-resolved default."""
    rates = [
        flops / seconds / 1e9
        for flops, seconds in compute_samples
        if flops > 0 and seconds > 0
    ]
    if len(rates) < 2:
        return None
    return float(np.median(rates))


def fit_from_samples(
    samples,
    *,
    base_params: TpuCostParams | None = None,
    min_samples: int = 8,
    min_distinct: int = 4,
    max_condition: float = 1e8,
    compute_samples=(),
) -> tuple[TpuCostParams, dict]:
    """Solve updated cost constants from flight-record residual samples.

    α-β half: :func:`samples_to_points` + ``calibrate.fit_cost_params``
    (relative NNLS over the model-derived feature matrix).  Guards, all
    raising :class:`FeedbackRefused`:

    - **starved**: fewer than ``min_samples`` eligible samples, or fewer
      than ``min_distinct`` distinct (widths, world, nbytes) points —
      four constants fitted from three points is interpolation theater;
    - **degenerate**: the relative-weighted feature matrix's condition
      number exceeds ``max_condition`` (one shape measured many times
      spans a line, not the 4-dim feature space), or ``fit_cost_params``
      itself empties its NNLS active set (measurements contradict the
      model everywhere).

    Codec half (:func:`_refit_codec`): the α-β solve cannot split the
    byte slope between wire and reduce bandwidth — those features are
    structurally collinear on an f32 wire — but compressed samples
    *can*: an int8 hop moves ¼ the wire bytes while reducing the same
    f32 bytes, so the compressed residual set jointly identifies the
    wire/reduce split AND ``codec_bw_GBps`` (a 2-unknown constrained
    least squares holding the f32-identified combined slope fixed).
    Skipped with a ``meta`` note when the set is too small, degenerate,
    or the codec excess is non-positive — the memcpy-wire case where
    codec time is unattributable.  ``compute_samples`` optionally update
    ``bwd_GFLOPs`` (:func:`fit_bwd_gflops`).

    Returns ``(params, meta)`` where ``meta`` records counts/condition —
    the provenance trail ``save_calibration(source="feedback")`` embeds.
    """
    if base_params is None:
        base_params = default_params()
    # materialize once: a generator would be exhausted by fit_bwd_gflops
    # before the meta sample count below re-iterates it
    compute_samples = tuple(compute_samples)
    points = samples_to_points(samples)
    if len(points) < min_samples:
        raise FeedbackRefused(
            f"starved residual set: {len(points)} eligible sample(s) < "
            f"min_samples={min_samples} (identity-codec, unsharded, "
            "tree/ring samples with a known world qualify)"
        )
    distinct = {(p.widths, p.num_nodes, p.nbytes) for p in points}
    if len(distinct) < min_distinct:
        raise FeedbackRefused(
            f"starved residual set: {len(distinct)} distinct "
            f"(shape, world, nbytes) point(s) < min_distinct={min_distinct} "
            "— re-measuring one point cannot pin 4 constants"
        )
    X = np.stack(
        [feature_vector(p.widths, p.num_nodes, p.nbytes) for p in points]
    )
    y = np.array([p.measured_us for p in points])
    Xw = X / np.maximum(y, 1e-9)[:, None]  # fit_cost_params' relative rows
    # Conditioning guard, on the COLUMN-NORMALIZED matrix (the raw
    # features carry wildly different units — launch counts ~1 vs byte
    # terms ~1e6 — which inflates a naive condition number without making
    # the solve degenerate).  Note the model's bandwidth and reduce
    # features are STRUCTURALLY collinear on a uniform fabric (the
    # telescoping identity makes both byte sums shape-independent,
    # cost_model.py docstring), so full rank 4 is unattainable by design;
    # the fit only needs the 3 identifiable directions (launch, latency,
    # combined byte slope).  Refuse when the measured geometry spans
    # fewer — one shape re-measured many times spans a line — or when the
    # spanned directions are themselves near-dependent.
    col_scale = np.abs(Xw).max(axis=0)
    live = col_scale > 1e-12
    sv = np.linalg.svd(Xw[:, live] / col_scale[live], compute_uv=False)
    need = min(3, int(live.sum()))
    rank = int((sv > sv[0] * 1e-10).sum()) if sv.size else 0
    cond = float(sv[0] / sv[need - 1]) if rank >= need else float("inf")
    if rank < need or cond > max_condition:
        raise FeedbackRefused(
            f"degenerate residual set: measured points span {rank} of the "
            f"{need} identifiable feature directions (condition "
            f"{cond:.3g} vs max {max_condition:.3g}) — add shapes/sizes "
            "instead of re-measuring the same point"
        )
    try:
        fitted = fit_cost_params(points)
    except RuntimeError as e:  # the NNLS empty-active-set refusal
        raise FeedbackRefused(f"degenerate residual set: {e}") from e

    meta: dict = {
        "points": len(points),
        "distinct_points": len(distinct),
        "condition": round(cond, 3),
    }

    # preserve constants the α-β solve does not see
    fitted = dataclasses.replace(
        fitted,
        codec_bw_GBps=base_params.codec_bw_GBps,
        bwd_GFLOPs=base_params.bwd_GFLOPs,
        rs_bw_scale=base_params.rs_bw_scale,
        ag_bw_scale=base_params.ag_bw_scale,
    )
    # The f32 data pins only the COMBINED byte slope (wire and reduce
    # features are structurally collinear — see the conditioning note
    # above), so the NNLS split between them is arbitrary.  Normalize to
    # the base calibration's ratio: every f32 prediction is unchanged,
    # and compressed-wire predictions stay anchored to the last measured
    # split instead of jumping with solver round-off.  Compressed samples
    # below re-solve the split from evidence when they can.
    fitted = _resplit_bytes(fitted, base_params, points[0])

    # ---- codec + wire-split refit from compressed samples
    fitted, codec_meta = _refit_codec(samples, fitted, points)
    meta.update(codec_meta)

    # ---- component-wise attribution (meta only): which phase drifted.
    # The α-β solve consumed totals; the breakdowns the samples carry
    # additionally say WHERE the miss lives — reported alongside the fit
    # so a drift log names the phase, never fatal when unattributable.
    phase_rows = [
        r for r in (_sample_phase_row(s) for s in samples) if r is not None
    ]
    if len(phase_rows) >= 2:
        try:
            scales, _pm = fit_phase_scales(phase_rows, floor_us=0.0)
            meta["phase_scales"] = {
                k: (round(v, 4) if v is not None else None)
                for k, v in scales.items()
            }
            meta["drifted_phase"] = drifted_phase(scales)
        except FeedbackRefused as e:
            meta["phase_attribution"] = f"skipped: {e}"[:160]

    # ---- backward-compute scale from compute probes
    bwd = fit_bwd_gflops(compute_samples)
    if bwd is not None:
        fitted = dataclasses.replace(fitted, bwd_GFLOPs=bwd)
        meta["bwd_GFLOPs"] = round(bwd, 3)
        meta["compute_samples"] = len(compute_samples)
    return fitted, meta


def _resplit_bytes(
    fitted: TpuCostParams, base: TpuCostParams, p0: MeasuredPoint
) -> TpuCostParams:
    """Redistribute the f32-identified combined byte slope ``q = c·inv_bw
    + inv_rbw`` between wire and reduce bandwidth in ``base``'s ratio —
    an f32-prediction-preserving change of the one direction the f32 fit
    cannot see (``c`` is the fixed wire/reduce feature ratio, evaluated
    from the model at ``p0``)."""
    tiny = 1e-12
    fv = feature_vector(p0.widths, p0.num_nodes, p0.nbytes)
    if fv[3] <= tiny:
        return fitted
    c = float(fv[2] / fv[3])
    inv_bw = 1.0 / max(fitted.ici.bandwidth_GBps * 1e3, tiny)
    inv_rbw = 1.0 / max(fitted.reduce_bw_GBps * 1e3, tiny)
    q = c * inv_bw + inv_rbw
    base_inv_bw = 1.0 / max(base.ici.bandwidth_GBps * 1e3, tiny)
    base_inv_rbw = 1.0 / max(base.reduce_bw_GBps * 1e3, tiny)
    denom = c * base_inv_bw + base_inv_rbw
    if q <= tiny or denom <= tiny:
        return fitted
    scale = q / denom
    bw = 1.0 / max(base_inv_bw * scale, tiny) / 1e3
    return dataclasses.replace(
        fitted,
        ici=LinkParams(bandwidth_GBps=bw, latency_us=fitted.ici.latency_us),
        dcn=LinkParams(bandwidth_GBps=bw, latency_us=fitted.dcn.latency_us),
        reduce_bw_GBps=1.0 / max(base_inv_rbw * scale, tiny) / 1e3,
    )


def _codec_feature_basis() -> list[TpuCostParams]:
    """``calibrate._params_basis`` extended with a codec one-hot: 5
    settings s.t. ``allreduce_cost(..., p_i, codec=c).total_us`` is the
    i-th feature of the codec-aware model (launch, latency, inv wire bw,
    inv reduce bw, inv codec bw).  The α-β entries pin ``codec_bw`` to
    "infinite" so their features stay pure."""
    from .calibrate import _params_basis

    big = 1e30
    base = [
        dataclasses.replace(p, codec_bw_GBps=big) for p in _params_basis()
    ]
    codec_one = dataclasses.replace(
        base[0], launch_us=0.0, codec_bw_GBps=1e-3
    )
    return base + [codec_one]


def _refit_codec(samples, fitted, points) -> tuple[TpuCostParams, dict]:
    """Joint wire-split + codec-throughput solve from compressed samples.

    The f32 α-β fit identifies launch, latency, and the COMBINED byte
    slope ``q = c·inv_bw + inv_rbw`` (wire and reduce features are
    structurally collinear on an f32 wire, ``c`` their fixed ratio) — but
    not the split, and the split is exactly what prices a compressed
    wire: int8 moves ``ratio``× the wire bytes while reducing and
    en/decoding full f32 bytes.  Each compressed sample therefore gives

        meas − launch·A_launch − lat·A_lat − q·A_rbw
            = inv_bw·(A_bw − c·A_rbw) + inv_codec·A_codec

    with the A's evaluated by the SAME cost model at one-hot basis params
    (:func:`_codec_feature_basis`).  Two unknowns, relative-weighted
    least squares, ``inv_bw`` clamped to ``[0, q/c]`` so the implied
    reduce bandwidth stays non-negative.  Refuses (returns the params
    untouched plus a ``codec_refit: skipped`` note) on < 3 usable
    samples, a rank-deficient system (one shape at one size cannot
    separate wire savings from codec work), or a non-positive codec
    inverse — measured compressed time at/below the α-β floor, the
    memcpy-wire case where codec time is unattributable."""
    lossy = [s for s in samples if s.codec != "f32" and not s.sharded]
    if not lossy:
        return fitted, {}
    from ..ops.quantize import get_codec

    basis = _codec_feature_basis()
    rows, meas = [], []
    for s in lossy:
        if s.world is None:
            continue
        widths, lonely = _parse_spec(s.topo)
        if widths is None or lonely:
            continue
        try:
            codec_obj = get_codec(s.codec)
        except (KeyError, ValueError):
            continue
        topo = (
            Topology.ring(s.world)
            if widths == (1,)
            else Topology(s.world, widths)
        )
        rows.append(
            np.array(
                [
                    allreduce_cost(topo, s.nbytes, p, codec=codec_obj).total_us
                    for p in basis
                ]
            )
        )
        meas.append(s.measured_us)

    def skipped(reason: str) -> tuple[TpuCostParams, dict]:
        return fitted, {
            "codec_refit": (
                f"skipped: {reason} — codec time unattributable on this wire"
            )
        }

    if len(rows) < 3:
        return skipped(
            f"{len(rows)}/{len(lossy)} usable compressed sample(s) (< 3)"
        )
    A = np.stack(rows)
    y = np.array(meas)
    # the f32-identified constants and combined byte slope
    tiny = 1e-12
    launch = fitted.launch_us
    lat = fitted.ici.latency_us
    inv_bw0 = 1.0 / max(fitted.ici.bandwidth_GBps * 1e3, tiny)
    inv_rbw0 = 1.0 / max(fitted.reduce_bw_GBps * 1e3, tiny)
    p0 = points[0]
    fv = feature_vector(p0.widths, p0.num_nodes, p0.nbytes)
    if fv[3] <= tiny:
        return skipped("reduce feature empty")
    c = float(fv[2] / fv[3])
    q = c * inv_bw0 + inv_rbw0
    rhs = y - launch * A[:, 0] - lat * A[:, 1] - q * A[:, 3]
    M = np.stack([A[:, 2] - c * A[:, 3], A[:, 4]], axis=1)
    w = 1.0 / np.maximum(y, 1e-9)
    Mw, rhsw = M * w[:, None], rhs * w
    sv = np.linalg.svd(Mw, compute_uv=False)
    if sv.size < 2 or sv[1] < sv[0] * 1e-8:
        return skipped(
            "degenerate compressed set (wire-saving and codec columns "
            "collinear; add shapes/sizes)"
        )
    (inv_bw, inv_cod), *_ = np.linalg.lstsq(Mw, rhsw, rcond=None)
    hi = q / c if c > tiny else float("inf")
    if not (0.0 <= inv_bw <= hi):
        # clamp the wire split and re-solve the codec inverse alone
        inv_bw = float(np.clip(inv_bw, 0.0, hi))
        col = Mw[:, 1]
        denom = float(col @ col)
        inv_cod = (
            float(col @ (rhsw - inv_bw * Mw[:, 0])) / denom
            if denom > tiny
            else 0.0
        )
    if not np.isfinite(inv_cod) or inv_cod <= tiny:
        return skipped("non-positive codec excess")
    inv_rbw = max(q - c * inv_bw, tiny)
    bw = 1.0 / max(inv_bw, tiny) / 1e3
    fitted = dataclasses.replace(
        fitted,
        ici=LinkParams(bandwidth_GBps=bw, latency_us=fitted.ici.latency_us),
        dcn=LinkParams(bandwidth_GBps=bw, latency_us=fitted.dcn.latency_us),
        reduce_bw_GBps=1.0 / inv_rbw / 1e3,
        codec_bw_GBps=1.0 / inv_cod / 1e3,
    )
    return fitted, {
        "codec_samples": len(rows),
        "codec_bw_GBps": round(fitted.codec_bw_GBps, 3),
        "wire_bw_GBps": round(fitted.ici.bandwidth_GBps, 3),
    }


# ---------------------------------------------------------- per-phase fit
#
# The α-β solve above needs point-wise measured collectives at varied
# (shape, world, nbytes) geometry — the probe path's currency.  Per-step
# span-clock samples (obs/stepclock.py) and thin fleet records carry a
# different kind of information: each sample's predicted CostBreakdown
# splits into three independently-scalable phases (fixed = launch +
# hop-latency + control; bytes = wire bandwidth + reduce, structurally
# collinear on an f32 wire so they scale together and keep the base
# calibration's split; codec = en/decode work), and the measurement
# constrains a LINEAR COMBINATION of those phases.  Solving for per-phase
# scale factors s_k in  measured ≈ floor + Σ_k s_k · predicted_k  is the
# component-wise residual consumption: it both *attributes*
# drift to a phase and *corrects* the live constants
# (:func:`scale_params`) without a single dedicated probe.


_PHASE_ORDER = ("fixed", "bytes", "codec")


def _sample_phase_row(s: ResidualSample):
    """(fixed_us, bytes_us, codec_us, measured_us) of one sample, or None
    when it carries no breakdown."""
    ph = s.phases
    if ph is None:
        return None
    return (ph["fixed"], ph["bytes"], ph["codec"], s.measured_us)


def fit_phase_scales(
    rows,
    *,
    floor_us: float = 0.0,
    max_condition: float = 1e6,
) -> tuple[dict, dict]:
    """Solve per-phase scale factors from ``(fixed_us, bytes_us,
    codec_us, measured_us[, weight])`` rows.

    Relative-weighted least squares over the phase columns that actually
    vary; ``floor_us`` is subtracted from every measurement first (the
    per-step fit passes the compute floor; bucket-level fits pass 0).
    Guards, raising :class:`FeedbackRefused`: fewer rows than unknowns, a
    column-normalized condition number past ``max_condition`` (the rows
    don't separate the phases — e.g. one plan re-measured many times), or
    a non-positive / non-finite fitted scale.  A codec column collinear
    with the bytes column (codec work is byte-proportional, so bucket-size
    variation alone cannot split them) folds into it: the codec scale
    then FOLLOWS the bytes scale, noted in ``meta``.

    Returns ``(scales, meta)``: ``scales`` maps phase -> factor (``None``
    for a phase with no predicted mass in any row), ``meta`` carries the
    conditioning trail.
    """
    mat, ys, ws = [], [], []
    for row in rows:
        f, b, c, meas = row[:4]
        w = float(row[4]) if len(row) > 4 else 1.0
        if meas <= 0 or w <= 0:
            continue
        mat.append([float(f), float(b), float(c)])
        ys.append(float(meas) - float(floor_us))
        ws.append(w)
    if not mat:
        raise FeedbackRefused("no usable phase rows (no breakdowns?)")
    A = np.asarray(mat)
    y = np.asarray(ys)
    # relative weighting (same convention as fit_cost_params), times the
    # caller's row weight (step counts behind a plan-aggregate row)
    w = np.sqrt(np.asarray(ws)) / np.maximum(y + floor_us, 1e-9)
    # a phase whose predicted contribution is negligible RELATIVE to the
    # measurements cannot be fitted from them: unresolved, base kept
    tiny = 1e-9 * float(np.abs(y).max() + floor_us)
    unresolved: list[str] = []
    live = []
    for i in range(3):
        if np.abs(A[:, i]).max() > max(tiny, 1e-12):
            live.append(i)
        elif np.abs(A[:, i]).max() > 1e-12:
            unresolved.append(_PHASE_ORDER[i])
    if not live:
        raise FeedbackRefused("every phase column is empty")
    codec_follows_bytes = False
    if 1 in live and 2 in live:
        # codec ∝ bytes across bucket-size variation: drop the codec
        # column when it adds no independent direction
        sub = A[:, [1, 2]] / np.abs(A[:, [1, 2]]).max(axis=0)
        sv = np.linalg.svd(sub * w[:, None], compute_uv=False)
        if sv.size < 2 or sv[-1] < sv[0] * 1e-6:
            live.remove(2)
            codec_follows_bytes = True
    X = A[:, live] * w[:, None]
    if X.shape[0] < len(live):
        raise FeedbackRefused(
            f"{X.shape[0]} phase row(s) cannot pin {len(live)} phase "
            "scale(s) — sample more plans"
        )
    col = np.abs(X).max(axis=0)
    if (col <= 1e-12).any():
        raise FeedbackRefused("a live phase column vanished under weighting")
    sv = np.linalg.svd(X / col, compute_uv=False)
    cond = float(sv[0] / sv[-1]) if sv[-1] > 0 else float("inf")
    if cond > max_condition:
        raise FeedbackRefused(
            f"phase columns are near-collinear (condition {cond:.3g} > "
            f"{max_condition:.3g}) — the sampled plans don't vary the "
            "phase mix; rotate bucket sizes or pool more runs"
        )
    # active-set solve: a phase whose fitted scale comes out non-positive
    # is UNIDENTIFIABLE from these rows (its predicted contribution is
    # below the noise) — drop its column and keep the base constants for
    # that phase rather than inventing a sign-flipped correction.  Refuse
    # only when nothing identifiable remains.
    while True:
        sol, *_ = np.linalg.lstsq(X, y * w, rcond=None)
        bad = [
            (s, i) for s, i in zip(sol, live)
            if not np.isfinite(s) or s <= 0
        ]
        if not bad:
            break
        worst = min(bad)[1]
        unresolved.append(_PHASE_ORDER[worst])
        live.remove(worst)
        if not live:
            raise FeedbackRefused(
                "no phase scale is identifiable from these rows — every "
                "fitted scale came out non-positive (noise dominated the "
                "window, or the floor is too high)"
            )
        X = A[:, live] * w[:, None]
    scales: dict = {p: None for p in _PHASE_ORDER}
    for i, s in zip(live, sol):
        scales[_PHASE_ORDER[i]] = float(s)
    if codec_follows_bytes and scales["bytes"] is not None:
        scales["codec"] = scales["bytes"]
    meta = {
        "phase_condition": round(cond, 3),
        "phase_rows": int(X.shape[0]),
    }
    if codec_follows_bytes:
        meta["codec_follows_bytes"] = True
    if unresolved:
        meta["unresolved_phases"] = unresolved
    return scales, meta


def drifted_phase(scales: dict) -> str | None:
    """The phase whose fitted scale deviates most from 1 (log scale),
    rendered ``"bytes×2.91"`` — the headline of a per-phase drift
    report.  None when nothing was fitted."""
    best, best_dev = None, 0.0
    for p in _PHASE_ORDER:
        s = scales.get(p)
        if s is None or s <= 0:
            continue
        dev = abs(float(np.log(s)))
        if dev > best_dev:
            best, best_dev = p, dev
    if best is None:
        return None
    return f"{best}×{scales[best]:.2f}"


def scale_params(base: TpuCostParams, scales: dict) -> TpuCostParams:
    """Apply fitted per-phase scales to the live constants: fixed-phase
    constants (launch, hop latency, control) multiply by ``fixed``;
    byte-phase bandwidths (wire + reduce) divide by ``bytes`` — scaling
    both preserves the base calibration's wire/reduce split, the one
    direction phase data cannot see (same argument as ``_resplit_bytes``);
    codec throughput divides by ``codec``.  ``None`` scales leave the
    phase untouched."""
    s_fixed = scales.get("fixed")
    s_bytes = scales.get("bytes")
    s_codec = scales.get("codec")
    out = base
    if s_fixed is not None:
        out = dataclasses.replace(
            out,
            launch_us=out.launch_us * s_fixed,
            control_us_per_width=out.control_us_per_width * s_fixed,
            ici=LinkParams(
                bandwidth_GBps=out.ici.bandwidth_GBps,
                latency_us=out.ici.latency_us * s_fixed,
            ),
            dcn=LinkParams(
                bandwidth_GBps=out.dcn.bandwidth_GBps,
                latency_us=out.dcn.latency_us * s_fixed,
            ),
        )
    if s_bytes is not None:
        out = dataclasses.replace(
            out,
            ici=LinkParams(
                bandwidth_GBps=out.ici.bandwidth_GBps / s_bytes,
                latency_us=out.ici.latency_us,
            ),
            dcn=LinkParams(
                bandwidth_GBps=out.dcn.bandwidth_GBps / s_bytes,
                latency_us=out.dcn.latency_us,
            ),
            reduce_bw_GBps=out.reduce_bw_GBps / s_bytes,
        )
    if s_codec is not None:
        out = dataclasses.replace(
            out, codec_bw_GBps=out.codec_bw_GBps / s_codec
        )
    return out


def fit_phase_scales_from_residuals(
    samples,
    *,
    base_params: TpuCostParams | None = None,
    min_samples: int = 6,
    max_condition: float = 1e6,
) -> tuple[TpuCostParams, dict]:
    """Per-phase scale fit over bucket-level residual samples (probe or
    per-step) that carry predicted breakdowns — the fallback when the
    sample geometry cannot support the point-wise α-β solve (fleet
    pooling of thin runs, single-plan records).  Returns ``(params,
    meta)`` like :func:`fit_from_samples`."""
    if base_params is None:
        base_params = default_params()
    rows = []
    for s in samples:
        row = _sample_phase_row(s)
        if row is not None:
            rows.append(row)
    if len(rows) < min_samples:
        raise FeedbackRefused(
            f"starved phase-residual set: {len(rows)} sample(s) with "
            f"breakdowns < min_samples={min_samples}"
        )
    scales, meta = fit_phase_scales(
        rows, floor_us=0.0, max_condition=max_condition
    )
    meta = {
        "mode": "phase-scales",
        "points": len(rows),
        "phase_scales": {
            k: (round(v, 4) if v is not None else None)
            for k, v in scales.items()
        },
        "drifted_phase": drifted_phase(scales),
        "condition": meta["phase_condition"],
        **meta,
    }
    return scale_params(base_params, scales), meta


def fit_probe_free(
    step_samples,
    *,
    base_params: TpuCostParams | None = None,
    compute_floor_us: float,
    min_plans: int = 2,
    min_steps_per_plan: int = 2,
    max_condition: float = 1e6,
) -> tuple[TpuCostParams, dict]:
    """The probe-free refit: per-phase scales from host-timed STEP
    samples spanning several bucket plans (``obs.stepclock.StepSample``).

    Each plan contributes one aggregate row — the MINIMUM step time over
    its (non-compiling) steps against the plan's predicted per-phase
    totals: host contention only ever adds time, so the min over samples
    interleaved across the run's windows is the plan's quiet-host time
    (the bench harness's min-of-reps argument), and contention-spiked
    individual steps cannot steer the solve.

    Identifiability, honestly: total gradient bytes are plan-invariant,
    so across a bucket-size rotation the byte-phase column is CONSTANT
    (the model's telescoping identity — bandwidth does not distinguish
    shapes) while the fixed-phase column varies with the bucket count.
    The solve therefore runs in two regimes:

    - **intercept mode** (the common case — byte column spread < 5%):
      fit ``step = I + s_fixed·F_plan`` directly.  The fixed scale comes
      from paired in-regime step differences (robust even on a noisy
      host); the intercept lumps ``floor + s_bytes·B``, and
      ``compute_floor_us`` (a sync-free twin timing — zero collectives)
      is used ONLY to split that lump: ``bytes ≈ clamp(I − floor, 1µs,
      I)``.  A noisy floor thus bounds the byte-scale error without
      touching the fixed-phase fit, and the IMPLIED floor ``I − bytes``
      is returned in ``meta["floor_implied_us"]`` — the controller
      adopts it for post-refit drift judgement (it is measured in-regime,
      unlike the twin).
    - **direct mode** (byte column varies — e.g. pooled worlds): the
      plain per-phase solve with ``compute_floor_us`` subtracted.

    Plans with fewer than ``min_steps_per_plan`` usable steps are
    dropped; :class:`FeedbackRefused` when fewer than ``min_plans``
    plans remain, the fixed column doesn't vary, or a fitted scale is
    not positive.
    """
    if base_params is None:
        base_params = default_params()
    if compute_floor_us is None:
        raise FeedbackRefused(
            "probe-free refit needs compute_floor_us (time a sync-free "
            "twin — zero collectives — or calibrate the compute estimate)"
        )
    by_plan: dict[str, list] = {}
    for s in step_samples:
        by_plan.setdefault(s.plan_sig, []).append(s)
    rows = []
    plans_meta = {}
    for sig, grp in sorted(by_plan.items()):
        if len(grp) < min_steps_per_plan:
            continue
        # min, not median: host contention is one-sided (it only ever
        # ADDS time), so the minimum over samples interleaved across the
        # run's windows is the plan's quiet-host time — the same
        # min-of-reps argument the bench harness runs on
        quiet_us = float(np.min([s.step_us for s in grp]))
        g0 = grp[0]
        rows.append(
            (g0.fixed_us, g0.bytes_us, g0.codec_us, quiet_us, float(len(grp)))
        )
        plans_meta[sig] = {
            "steps": len(grp),
            "step_us": round(quiet_us, 1),
            "fixed_us": round(g0.fixed_us, 1),
            "bytes_us": round(g0.bytes_us + g0.codec_us, 1),
        }
    if len(rows) < min_plans:
        raise FeedbackRefused(
            f"probe-free fit needs >= {min_plans} plans with >= "
            f"{min_steps_per_plan} steps each; have {len(rows)} "
            "(rotate bucket sizes to vary the phase mix)"
        )
    F = np.array([r[0] for r in rows])
    BC = np.array([r[1] + r[2] for r in rows])  # bytes + codec lump
    Y = np.array([r[3] for r in rows])
    W = np.sqrt(np.array([r[4] for r in rows])) / np.maximum(Y, 1e-9)
    has_codec = any(r[2] > 1e-12 for r in rows)
    bc_spread = (
        (BC.max() - BC.min()) / BC.max() if BC.max() > 1e-12 else 0.0
    )
    floor = float(compute_floor_us)
    meta: dict = {
        "mode": "probe-free",
        "plans": len(rows),
        "steps": int(sum(len(g) for g in by_plan.values())),
        "floor_us": round(floor, 1),
        "plan_rows": plans_meta,
    }
    if bc_spread >= 0.05:
        # byte column varies: the generic per-phase solve identifies it
        try:
            scales, smeta = fit_phase_scales(
                rows, floor_us=floor, max_condition=max_condition
            )
        except FeedbackRefused as e:
            raise FeedbackRefused(f"{e} [plans={plans_meta}]") from e
        meta.update(submode="direct", condition=smeta["phase_condition"],
                    **smeta)
    else:
        # intercept mode: I + s_fixed·F
        if F.max() <= 1e-12 or (F.max() - F.min()) / F.max() < 0.05:
            raise FeedbackRefused(
                "fixed-phase column does not vary across the sampled "
                f"plans (F={np.round(F, 2).tolist()}) — rotation did not "
                "change the bucket count"
            )
        X = np.stack([np.ones_like(F), F], axis=1) * W[:, None]
        col = np.abs(X).max(axis=0)
        sv = np.linalg.svd(X / col, compute_uv=False)
        cond = float(sv[0] / sv[-1]) if sv[-1] > 0 else float("inf")
        if cond > max_condition:
            raise FeedbackRefused(
                f"intercept solve ill-conditioned ({cond:.3g}) — plans "
                "too similar"
            )
        (intercept, s_fixed), *_ = np.linalg.lstsq(X, Y * W, rcond=None)
        if not np.isfinite(s_fixed) or s_fixed <= 0:
            raise FeedbackRefused(
                f"fitted fixed scale {s_fixed:.4g} not positive — step "
                "times do not grow with the bucket count (noise dominated "
                f"the window; plans={plans_meta})"
            )
        intercept = float(max(intercept, 1.0))
        # split the intercept: bytes = I − floor, clamped into [1µs,
        # max(I−1µs, 1µs)] so a noisy twin floor can neither produce
        # negative bytes (s_bytes must stay > 0 — scale_params divides
        # by it) nor a negative implied floor even when the intercept
        # itself collapses to the 1µs clamp
        hi = max(intercept - 1.0, 1.0)
        bytes_lump = float(np.clip(intercept - floor, 1.0, hi))
        s_bytes = bytes_lump / max(float(BC.mean()), 1e-9)
        scales = {
            "fixed": float(s_fixed),
            "bytes": float(s_bytes),
            "codec": float(s_bytes) if has_codec else None,
        }
        meta.update(
            submode="intercept",
            condition=round(cond, 3),
            intercept_us=round(intercept, 1),
            bytes_lump_us=round(bytes_lump, 1),
            floor_implied_us=round(intercept - bytes_lump, 1),
        )
        if has_codec:
            meta["codec_follows_bytes"] = True
    meta["phase_scales"] = {
        k: (round(v, 6) if v is not None else None) for k, v in scales.items()
    }
    meta["drifted_phase"] = drifted_phase(scales)
    return scale_params(base_params, scales), meta


def fit_residuals_auto(
    samples,
    *,
    base_params: TpuCostParams | None = None,
    min_samples: int = 8,
    **kw,
) -> tuple[TpuCostParams, dict]:
    """Fit whatever the residual set supports: the point-wise α-β solve
    when the geometry allows it, else the per-phase scale fit.  The fleet
    pooling pass and the residuals CLI use this so a thin single-plan
    record still yields an honest (phase-level) answer instead of a
    refusal, with ``meta["mode"]`` saying which solve ran."""
    try:
        params, meta = fit_from_samples(
            samples, base_params=base_params, min_samples=min_samples, **kw
        )
        meta.setdefault("mode", "alpha-beta")
        return params, meta
    except FeedbackRefused as ab_err:
        try:
            params, meta = fit_phase_scales_from_residuals(
                samples, base_params=base_params
            )
        except FeedbackRefused as ph_err:
            raise FeedbackRefused(
                f"alpha-beta: {ab_err}; phase-scales: {ph_err}"
            ) from ph_err
        meta["alpha_beta_refused"] = str(ab_err)[:200]
        return params, meta


def attribute_groups(samples) -> dict[tuple, str]:
    """Per-(topo, codec, tier) drift attribution for the residuals CLI:
    run the per-phase solve on each group's samples; where the group's
    geometry cannot split phases (one size, apportioned per-step
    samples), fall back to the overall measured/predicted scale so the
    table still says HOW FAR the group drifted.  Keys match
    ``obs.timeline.residual_group_key``."""
    groups: dict[tuple, list] = {}
    for s in samples:
        groups.setdefault(residual_group_key(s), []).append(s)
    out: dict[tuple, str] = {}
    for key, grp in groups.items():
        rows = [r for r in (_sample_phase_row(s) for s in grp) if r]
        label = None
        if len(rows) >= 2:
            try:
                scales, _meta = fit_phase_scales(rows, floor_us=0.0)
                label = drifted_phase(scales)
            except FeedbackRefused:
                label = None
        if label is None:
            ratios = [
                s.measured_us / s.predicted_us
                for s in grp
                if s.predicted_us > 0
            ]
            if ratios:
                r = float(np.median(ratios))
                label = f"total×{r:.2f}" if abs(r - 1) > 0.1 else "-"
        out[key] = label or "-"
    return out


# ------------------------------------------------------------------- drift


class DriftDetector:
    """Per-key sliding windows of relative residuals |pred-meas|/meas.

    Key: (fingerprint, world, topo family, codec, sharded).  A key
    *breaches* when its window holds at least ``min_window`` samples and
    their median exceeds ``band``.  The median
    (not the mean, not the last sample) so one contention-spiked probe on
    a timeshared host cannot trigger a replan storm; ``reset()`` after a
    refit so residuals are re-judged against the NEW constants."""

    def __init__(
        self, band: float = 0.5, window: int = 16, min_window: int = 4
    ):
        if band <= 0:
            raise ValueError(f"band must be > 0, got {band}")
        if min_window < 1 or window < min_window:
            raise ValueError(
                f"need window >= min_window >= 1, got {window}/{min_window}"
            )
        self.band = float(band)
        self.window = int(window)
        self.min_window = int(min_window)
        self._windows: dict[tuple, deque] = {}

    def key(self, sample: ResidualSample) -> tuple:
        return (
            sample.fingerprint,
            sample.world,
            sample_family(sample),
            sample.codec,
            sample.sharded,
        )

    def observe(self, sample: ResidualSample) -> None:
        self._windows.setdefault(
            self.key(sample), deque(maxlen=self.window)
        ).append(sample.rel_residual)

    def breaches(self) -> dict[tuple, float]:
        """{key: median rel residual} for every key past the band."""
        out = {}
        for key, win in self._windows.items():
            if len(win) < self.min_window:
                continue
            med = float(np.median(list(win)))
            if med > self.band:
                out[key] = med
        return out

    @property
    def drifted(self) -> bool:
        return bool(self.breaches())

    def reset(self) -> None:
        self._windows.clear()

    # -- cross-rank pooling (follower drift contribution) ---------------

    @staticmethod
    def key_str(key: tuple) -> str:
        """The JSON-safe serialization of a detector key — the same
        ``|``-joined form the controller's drift logs use."""
        return "|".join(str(p) for p in key)

    def summary(self) -> dict:
        """JSON-safe per-key window summary ``{key: {median, count}}`` —
        what a follower ships in its coordination acks so the
        coordinator's propose decision sees pooled cross-rank skew, not
        just its own wire view (the coordinated control plane is not
        ported; :meth:`pooled_breaches` reads such summaries)."""
        out: dict = {}
        for key, win in self._windows.items():
            if not win:
                continue
            out[self.key_str(key)] = {
                "median": round(float(np.median(list(win))), 4),
                "count": len(win),
            }
        return out

    def pooled_breaches(self, peer_summaries=None) -> dict[str, float]:
        """Band breaches over the POOLED view: this rank's windows merged
        with peers' summaries (``{rank: summary-dict}``).  Per key, ranks'
        medians combine count-weighted (the median of rank medians, each
        weighted by its window size) and a key breaches when the pooled
        statistic exceeds the band with at least ``min_window`` samples
        in total — so a skew only ONE follower's wire sees still breaches
        once its window is heavy enough, and a single noisy rank cannot
        out-vote a quiet majority."""
        per_key: dict[str, list] = {}
        for key, win in self._windows.items():
            if win:
                per_key.setdefault(self.key_str(key), []).append(
                    (float(np.median(list(win))), len(win))
                )
        for summ in (peer_summaries or {}).values():
            if not isinstance(summ, dict):
                continue
            for key, ent in summ.items():
                try:
                    med, count = float(ent["median"]), int(ent["count"])
                except (KeyError, TypeError, ValueError):
                    continue
                if count > 0:
                    per_key.setdefault(str(key), []).append((med, count))
        out: dict[str, float] = {}
        for key, entries in per_key.items():
            total = sum(c for _m, c in entries)
            if total < self.min_window:
                continue
            # count-weighted median of rank medians
            entries.sort(key=lambda e: e[0])
            half, acc, pooled = total / 2.0, 0, entries[-1][0]
            for med, count in entries:
                acc += count
                if acc >= half:
                    pooled = med
                    break
            if pooled > self.band:
                out[key] = pooled
        return out


def cache_invalidation_predicate(
    fingerprint: str | None, world: int | None = None
) -> Callable[[str, dict], bool]:
    """The standard drift predicate for ``autotune.invalidate_plan_cache``:
    match entries measured under ``fingerprint`` (the stored entry field —
    the key string embeds the fingerprint but ``|``-splitting it is
    ambiguous because fingerprints contain ``|``), optionally narrowed to
    one world size via the key's ``n{world}`` component.  The world check
    strips the fingerprint prefix first: the fingerprint itself carries an
    ``n{device_count}`` part, and a bare substring match would make
    ``world == device_count`` (the common case) match EVERY same-host key.

    The port's fingerprints carry a rank count (``r8``, or ``r?`` outside
    a process group, ``calibrate.backend_fingerprint``): a ``r?``
    fingerprint, the process's own, matches this backend's entries at
    every rank count, since the autotuner keys its in-process mesh's
    entries with the mesh's."""

    any_ranks = _ranks_free(fingerprint)
    if any_ranks is not None and fingerprint.split("|")[4] != "r?":
        any_ranks = None  # a known rank count matches itself only

    def same_backend(fp) -> bool:
        return fp == fingerprint or (any_ranks is not None
                                     and _ranks_free(fp) == any_ranks)

    def predicate(key: str, entry: dict) -> bool:
        fp = entry.get("fingerprint")
        if not same_backend(fp):
            return False
        if world is None:
            return True
        rest = key
        # a None fingerprint serializes as plan_cache_key's "~" sentinel
        prefix = "~" if fp is None else fp
        if key.startswith(prefix + "|"):
            rest = key[len(prefix) + 1 :]
        return rest.startswith(f"n{world}|")

    return predicate


def _ranks_free(fingerprint) -> str | None:
    """A port fingerprint with its rank-count field blanked, else None
    (not the port's ``device|name|nN|transport|rR|torchV`` format)."""
    if not isinstance(fingerprint, str):
        return None
    parts = fingerprint.split("|")
    if len(parts) != 6 or not parts[4].startswith("r"):
        return None
    return "|".join(parts[:4] + ["r"] + parts[5:])


# -------------------------------------------------------------- controller


@dataclass(frozen=True)
class ProbePoint:
    """One feedback probe: time the collective at (spec, nbytes, codec)."""

    spec: str
    nbytes: int
    codec: str = "f32"


def default_probe_points(n: int, nbytes: int) -> tuple[ProbePoint, ...]:
    """A small well-conditioned probe set for world ``n``: the flat tree,
    the first multi-stage factorization (when one exists), and the ring,
    each at two payload sizes — 4-6 distinct points covering the launch /
    latency / bandwidth axes, so two ticks clear the default
    ``min_samples`` without ever measuring one shape alone."""
    from .factorize import ordered_factorizations

    specs = [str(n)]
    for widths in ordered_factorizations(n):
        if len(widths) >= 2:
            specs.append(",".join(map(str, widths)))
            break
    if n >= 2:
        specs.append("ring")
    big = max(min(int(nbytes), 4 << 20), 1 << 15)
    small = max(big // 8, 1 << 14)
    sizes = [big] if small >= big else [big, small]
    return tuple(ProbePoint(s, nb) for s in specs for nb in sizes)


@dataclass
class FeedbackConfig:
    """Knobs for the in-run feedback loop (:class:`FeedbackController`).

    ``every_k``: tick cadence in steps.  ``band``/``window``/
    ``min_window``: the drift detector's parameters — breach = replan
    trigger.  ``min_samples``: the fitter's starvation floor.
    ``probes``: explicit :class:`ProbePoint` set (None derives
    :func:`default_probe_points`).  ``repeat``: timed reps per probe per
    tick (shuffled-interleaved, the harness protocol).
    ``calibration_path``: where refits are written back
    (``save_calibration(source="feedback")``); None skips persistence.
    ``plan_cache_path``: the autotune cache to drift-invalidate (None =
    the ambient ``FLEXTREE_PLAN_CACHE``/default).  ``on_replan(plan,
    params)``: rebuild hook — return None to keep the current step, or
    the same 3-/5-tuple ``Supervision.on_shrink`` returns; ``fit`` swaps
    the step through the identical path.  ``max_refits`` bounds how many
    times one run may refit (a loop that refits every tick is chasing
    noise, not drift).  ``max_samples`` bounds the controller's residual
    buffer to the most RECENT measurements — a refit must solve from the
    regime that breached the band, not a run-long mix the old regime
    dominates, and a healthy run must not grow the buffer forever.
    ``run_id`` stamps the calibration provenance.

    Probe-free mode (``probe_free=True``): no dedicated probe
    collectives ever run.  Every step is host-timed, waited for on the
    card, against its bucket plan (``obs.stepclock``); drift detection
    rides the per-step spans, and a refit solves per-phase scale factors
    across PLANS — on a breach the controller rotates the step through
    ``rotation_factors``-scaled bucket sizes via ``on_rotate(bucket_bytes)
    -> rebuilt-tuple`` (bucket size is bitwise-invariant, so a rotation
    step is free production training, not a probe), then fits
    :func:`fit_probe_free` over the accumulated step samples.
    ``compute_floor_us`` is the step's non-comm floor (time a sync-free
    twin: zero collectives) — required for the refit, optional for
    detection (the provisional floor catches over-predicted comm).
    ``rotation_ticks`` = controller ticks spent per rotation plan (each
    tick is ``every_k`` steps of samples); ``min_steps_per_plan`` gates
    the fit; ``step_sample_every`` thins the per-step event stream.
    """

    every_k: int = 50
    band: float = 0.5
    window: int = 16
    min_window: int = 4
    min_samples: int = 8
    max_samples: int = 64
    probes: tuple = ()
    repeat: int = 3
    calibration_path: str | None = None
    backend: str | None = None
    plan_cache_path: str | None = None
    on_replan: Callable | None = None
    max_refits: int = 4
    run_id: str | None = None
    # -- probe-free mode -------------------------------------------------
    probe_free: bool = False
    compute_floor_us: float | None = None
    on_rotate: Callable | None = None
    rotation_factors: tuple = (0.25, 4.0)
    rotation_ticks: int = 1
    # full passes over the variant set (variants + the base size, so the
    # base is re-sampled in later windows too).  >1 interleaves each
    # plan's samples across the run's whole wall-clock window — the step
    # -scale version of the bench harness's shuffled-interleaved rounds:
    # a timeshared host's contention drifts over seconds, and a plan
    # sampled only in one window would absorb that drift as phase signal
    rotation_cycles: int = 2
    min_steps_per_plan: int = 2
    step_sample_every: int = 1


@dataclass
class ReplanDecision:
    """What one drift-triggered refit did — ``fit`` records it and applies
    ``rebuilt`` through the shrink-path swap.  ``rotation=True`` marks a
    probe-free plan-rotation swap (a bucket-size variant of the SAME
    plan, bitwise-invariant — applied like a replan but not counted as
    one; ``plan`` is then None)."""

    plan: Any  # planner.choose.Plan under the refitted constants
    params: TpuCostParams
    drift: dict  # breached detector keys -> median rel residual
    invalidated: int  # plan-cache entries dropped
    fit_meta: dict
    rebuilt: Any = None  # on_replan's 3-/5-tuple, or None
    rotation: bool = False


class FeedbackController:
    """The in-run half of the loop: probe, detect, refit, replan.

    ``n``/``nbytes``: the sync world size and gradient-bytes hint the
    replan prices (the same pair ``replan_for_survivors`` takes).
    ``params``: the constants the RUNNING plan was priced with (defaults
    to ``default_params()`` — i.e. whatever calibration the run started
    from); residuals are judged against these until a refit replaces
    them.  ``timer(probes, n) -> [seconds]`` and ``clock`` are
    injectable for tests; the default timer (:meth:`_default_timer`) runs
    each probe's allreduce on an in-process mesh of ``device`` (default
    ``cuda``) with the bench harness's interleaved rounds, building and
    warming each probe once and keeping it across ticks.

    :meth:`maybe_tick` is the ``fit`` hook.  Its recorder-off cost is
    ONE ``current_recorder() is None`` check — the exact check
    ``record_event`` makes — so un-instrumented runs pay nothing
    (measured by ``python -m flextree_tpu_torch.tools.feedback_convergence``).

    ``coordination``: a ``runtime.CoordinationHandle`` for a
    multi-process group (module docstring).
    """

    def __init__(
        self,
        n: int,
        nbytes: int,
        cfg: FeedbackConfig | None = None,
        *,
        params: TpuCostParams | None = None,
        coordination=None,
        timer: Callable | None = None,
        clock: Callable[[], float] = time.perf_counter,
        device=None,
    ):
        import torch

        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        self.n = int(n)
        self.nbytes = int(nbytes)
        self.cfg = cfg or FeedbackConfig()
        self.device = torch.device(device if device is not None else "cuda")
        self.params = (params if params is not None
                       else default_params(self._backend_name()))
        # multi-process groups: a refit becomes a proposal that every rank
        # applies from the committed epoch (apply_committed); each rank's
        # acks ship its detector's window summary (drift_provider), so the
        # coordinator decides on the pooled cross-rank view
        self.coordination = coordination
        if coordination is not None and hasattr(coordination,
                                                "drift_provider"):
            coordination.drift_provider = self._detector_summary
        self._timer = timer
        self._clock = clock
        # the process's own fingerprint: what default_params compares the
        # written-back section against (module docstring)
        self._fingerprint = backend_fingerprint(self.device)
        self._detector = DriftDetector(
            self.cfg.band, self.cfg.window, self.cfg.min_window
        )
        # bounded to the recent regime: a drift refit fits from the
        # measurements that breached the band, not run-long history
        self.samples: deque[ResidualSample] = deque(
            maxlen=max(self.cfg.max_samples, self.cfg.min_samples)
        )
        self._fns: dict = {}  # warm probe calls: point -> fn
        self._inputs: dict = {}  # device probe inputs, shared by (n, size)
        self._last_step: int | None = None
        self._budget_logged = False
        self._starved_logged = False
        self.ticks = 0
        self.refits = 0
        self.refusals = 0
        # -- probe-free state (cfg.probe_free): the per-step span clock
        # and the plan-rotation cycle
        self.step_clock: StepSpanClock | None = (
            StepSpanClock(
                compute_floor_us=self.cfg.compute_floor_us,
                sample_every=self.cfg.step_sample_every,
                fingerprint=self._fingerprint,
            )
            if self.cfg.probe_free
            else None
        )
        self._rotation: dict | None = None
        self._rotation_logged = False
        self.rotations = 0

    # -- resolution helpers --------------------------------------------

    @property
    def probes(self) -> tuple[ProbePoint, ...]:
        return tuple(self.cfg.probes) or default_probe_points(
            self.n, self.nbytes
        )

    def _backend_name(self) -> str:
        """The calibration section refits go to: ``cfg.backend``, else
        ``FLEXTREE_CALIBRATION_BACKEND``, else the device's type (the
        section ``default_params`` reads on it)."""
        return (self.cfg.backend
                or os.environ.get("FLEXTREE_CALIBRATION_BACKEND")
                or self.device.type)

    # -- the fit hook ---------------------------------------------------

    def maybe_tick(self, step: int) -> ReplanDecision | None:
        """The per-step hook ``fit`` calls.  Recorder off -> one ``None``
        check and out (zero overhead); otherwise tick on the ``every_k``
        cadence."""
        if current_recorder() is None:
            return None
        if self.refits >= self.cfg.max_refits:
            # the refit budget is spent: no tick can ever refit or replan
            # again, so stop paying probe wall-time for the rest of the
            # run (warn once, not per cadence tick)
            if not self._budget_logged:
                self._budget_logged = True
                self._fns.clear()  # warm probes + device inputs: dead
                self._inputs.clear()
                log.warning(
                    "feedback refit budget (%d) exhausted; probing "
                    "disabled for the rest of the run",
                    self.cfg.max_refits,
                )
            return None
        k = max(1, self.cfg.every_k)
        if step == 0 or step % k != 0 or step == self._last_step:
            return None
        if (self.coordination is not None
                and not self.coordination.is_coordinator):
            # a coordinated follower: the replan arrives as a committed
            # group decision; probing would spend wall time on a decision
            # this rank has no authority to make (checked on the cadence,
            # not every step: is_coordinator reads the membership files;
            # in probe-free mode the detector still fills from the spans)
            return None
        self._last_step = step
        if self.cfg.probe_free:
            return self.tick_probe_free(step)
        return self.tick(step)

    # -- the probe-free per-step hooks -----------------------------------

    def wants_step_spans(self) -> bool:
        """True when ``fit`` should host-time each step (waited for on
        the card) and feed :meth:`observe_step` — probe-free mode with
        the recorder on.  Recorder off -> one ``None`` check, the same
        contract as :meth:`maybe_tick`."""
        return self.step_clock is not None and current_recorder() is not None

    def set_step_plan(self, captured) -> None:
        """Adopt the bucket plan ``fit`` captured around a step
        (``utils.profiling.plan_capture``; every step hands it in, and
        the clock keeps a plan of the same signature)."""
        if self.step_clock is not None:
            self.step_clock.set_plan(captured)

    def observe_step(self, step: int, dur_s: float) -> None:
        """Fold one materialized step's wall time into the span clock,
        the drift detector, and the residual buffer (probe-free mode)."""
        clock = self.step_clock
        if clock is None or current_recorder() is None:
            return
        sample = clock.observe_step(step, dur_s)
        if sample is None:
            return
        plan = clock.plan
        comm = clock.comm_us(sample)
        if plan is None or comm is None or plan.predicted_us <= 0:
            return
        for b in plan.buckets:
            share = b.predicted_us / plan.predicted_us
            rs = ResidualSample(
                topo=b.topo,
                world=b.world,
                codec=b.codec,
                sharded=b.sharded,
                nbytes=b.nbytes,
                predicted_us=b.predicted_us,
                measured_us=max(comm * share, 1e-3),
                fingerprint=self._fingerprint,
                step=int(step),
                source="step",
                predicted_breakdown=b.predicted,
            )
            self.samples.append(rs)
            self._detector.observe(rs)

    def _detector_summary(self) -> dict:
        return self._detector.summary()

    def _pooled_breaches(self) -> dict[str, float]:
        """Band breaches over the pooled cross-rank view when coordinated
        (the followers' ack-shipped summaries), else this controller's
        windows, keyed as the JAX controller keys them
        (``DriftDetector.key_str``)."""
        peers = None
        if self.coordination is not None and hasattr(self.coordination,
                                                     "peer_drift"):
            try:
                # only summaries written since the last applied decision:
                # an ack is written before the apply, so older acks carry
                # the breach the group already corrected
                applied = getattr(self.coordination, "applied_epoch", -1)
                peers = self.coordination.peer_drift(min_epoch=applied + 1)
            except Exception:  # noqa: BLE001 — pooling never kills a tick
                peers = None
        if peers:
            return self._detector.pooled_breaches(peers)
        return {
            DriftDetector.key_str(k): v
            for k, v in self._detector.breaches().items()
        }

    def tick_probe_free(self, step: int) -> ReplanDecision | None:
        """One probe-free feedback round: no collectives — advance the
        rotation cycle if one is running, else check the (pooled) drift
        band over the per-step spans and start one on a breach."""
        self.ticks += 1
        clock = self.step_clock
        record_event(
            "feedback_tick", step=int(step), probes=0, probe_free=True,
            step_samples=len(clock.samples) if clock else 0,
        )
        if clock is None:
            return None
        if self._rotation is not None:
            return self._advance_rotation(step)
        if clock.plan is None:
            return None
        breaches = self._pooled_breaches()
        if not breaches:
            return None
        if self.refits >= self.cfg.max_refits:
            log.warning(
                "feedback drift persists after %d refit(s); refit budget "
                "exhausted — holding the current plan", self.refits,
            )
            return None
        return self._start_rotation(step, breaches)

    def _rotation_sizes(self) -> list[int]:
        """Bucket-size variants to rotate through: the current plan's
        largest bucket scaled by ``rotation_factors``, clamped to
        [4 KiB, the device's bucket cap] and deduplicated against the
        current size.  The upper clamp matters: past the cap (CPU:
        ``CPU_MAX_BUCKET_BYTES``) a bigger bucket gets SLOWER in-step
        from cache pressure — the α-β model's documented blind spot
        (``parallel/bucketing.py``) — and a rotation sample from that
        regime feeds the fixed-phase fit a contradiction (fewer
        dispatches, more time) that refuses or poisons the solve."""
        from ..parallel.bucketing import (
            CPU_MAX_BUCKET_BYTES,
            DEFAULT_MAX_BUCKET_BYTES,
        )

        plan = self.step_clock.plan
        base = max(b.nbytes for b in plan.buckets)
        cap = (DEFAULT_MAX_BUCKET_BYTES if self.device.type == "cuda"
               else CPU_MAX_BUCKET_BYTES)
        out = []
        for f in self.cfg.rotation_factors:
            bb = min(max(int(base * float(f)), 4096), cap)
            if bb != base and bb not in out:
                out.append(bb)
        return out

    def _start_rotation(self, step: int, breaches: dict):
        if self.cfg.on_rotate is None:
            if not self._rotation_logged:
                self._rotation_logged = True
                self.refusals += 1
                record_event(
                    "feedback_refused", step=int(step),
                    reason="probe-free drift breached but no on_rotate "
                    "hook: cannot vary the plan to attribute phases",
                )
                log.warning(
                    "probe-free drift detected at step %d but no "
                    "on_rotate hook is configured; cannot refit "
                    "(drift: %s)", step, breaches,
                )
            return None
        sizes = self._rotation_sizes()
        if not sizes:
            return None
        base = max(b.nbytes for b in self.step_clock.plan.buckets)
        # interleave: each cycle visits every variant AND re-visits the
        # base size, so every plan's sample median spans the run's whole
        # wall-clock window instead of one contention regime
        queue: list[int] = []
        for _ in range(max(1, self.cfg.rotation_cycles)):
            queue.extend([*sizes, base])
        self._rotation = {
            "queue": queue,
            "breaches": dict(breaches),
            "ticks_left": max(1, self.cfg.rotation_ticks),
        }
        return self._swap_rotation_plan(step)

    def _swap_rotation_plan(self, step: int) -> ReplanDecision | None:
        rot = self._rotation
        bb = rot["queue"].pop(0)
        rot["ticks_left"] = max(1, self.cfg.rotation_ticks)
        rebuilt = self.cfg.on_rotate(bb)
        if rebuilt is None:
            # the hook declined: no way to vary the plan — abandon
            self._rotation = None
            log.warning(
                "probe-free rotation aborted at step %d: on_rotate "
                "declined bucket_bytes=%d", step, bb,
            )
            return None
        self.rotations += 1
        # drop the old plan until the swapped step's capture arrives: a
        # rebuilt step whose spans carry no plan must leave the clock
        # blind, never mis-attributing its steps to the previous plan
        self.step_clock.plan = None
        record_event(
            "feedback_rotate", step=int(step), bucket_bytes=int(bb),
            remaining=len(rot["queue"]),
        )
        log.warning(
            "probe-free rotation at step %d: sampling bucket_bytes=%d "
            "(%d variant(s) left)", step, bb, len(rot["queue"]),
        )
        return ReplanDecision(
            plan=None,
            params=self.params,
            drift=dict(rot["breaches"]),
            invalidated=0,
            fit_meta={"rotation_bucket_bytes": int(bb)},
            rebuilt=rebuilt,
            rotation=True,
        )

    def _advance_rotation(self, step: int) -> ReplanDecision | None:
        rot = self._rotation
        rot["ticks_left"] -= 1
        if rot["ticks_left"] > 0:
            return None
        if rot["queue"]:
            return self._swap_rotation_plan(step)
        # every variant sampled: fit per-phase scales across the plans
        self._rotation = None
        return self._refit_probe_free(step, rot["breaches"])

    def _refit_probe_free(self, step: int, drift: dict) -> ReplanDecision | None:
        floor = self.cfg.compute_floor_us
        if floor is None:
            floor = self.step_clock.floor_us
        try:
            if floor is None:
                raise FeedbackRefused(
                    "no compute floor available (set "
                    "FeedbackConfig.compute_floor_us — a sync-free twin "
                    "timing, zero collectives)"
                )
            new_params, meta = fit_probe_free(
                self.step_clock.samples,
                base_params=self.params,
                compute_floor_us=floor,
                min_steps_per_plan=self.cfg.min_steps_per_plan,
            )
        except FeedbackRefused as e:
            self.refusals += 1
            record_event(
                "feedback_refused", step=int(step), reason=str(e)[:300],
                probe_free=True,
            )
            log.warning(
                "probe-free refit refused at step %d: %s", step, e
            )
            # keep accumulating under the rotated plans; a later breach
            # restarts the cycle with more samples per plan
            return None
        drift = {str(k): round(float(v), 4) for k, v in drift.items()}
        implied = meta.get("floor_implied_us")
        if implied is not None:
            # the fit's in-regime floor beats the twin measurement (same
            # loop, same donation pattern, same recorder overhead): adopt
            # it for post-refit drift judgement
            self.step_clock.compute_floor_us = float(implied)
        if self.coordination is not None:
            decision = self._propose_replan(step, new_params, meta, drift)
        else:
            decision = self._apply_refit(step, new_params, meta, drift)
        # post-refit steps run a rebuilt plan priced by NEW constants:
        # both the step-sample buffer and the plan signature restart
        self.step_clock.samples.clear()
        self.step_clock.plan = None
        return decision

    def tick(self, step: int) -> ReplanDecision | None:
        """One feedback round: probe, record, detect; refit + replan on a
        band breach.  Returns the :class:`ReplanDecision` when drift
        fired (even if ``on_replan`` declined a rebuild), else None."""
        self.ticks += 1
        probes = self.probes
        t0 = self._clock()
        secs = (self._timer or self._default_timer)(probes, self.n)
        if len(secs) != len(probes):
            raise ValueError(
                f"probe timer returned {len(secs)} times for "
                f"{len(probes)} probes"
            )
        for p, s in zip(probes, secs):
            measured_us = float(s) * 1e6
            cost = predict_spec_cost(
                p.spec, self.n, p.nbytes, self.params, codec=p.codec
            )
            if cost is None:
                continue
            predicted = cost.total_us
            breakdown = {
                k: round(v, 3) for k, v in dataclasses.asdict(cost).items()
            }
            record_event(
                "bucket_measured",
                name=f"ftfb_probe_{p.spec.replace(',', 'x')}_{p.nbytes}B",
                axis="ftfb",
                topo={"ftfb": p.spec},
                world={"ftfb": self.n},
                nbytes=int(p.nbytes),
                codec=p.codec,
                sharded=False,
                measured_us=round(measured_us, 3),
                predicted_us=round(predicted, 3),
                predicted=breakdown,
                fingerprint=self._fingerprint,
                step=int(step),
            )
            sample = ResidualSample(
                topo="ring" if p.spec in ("1", "ring") else p.spec,
                world=self.n,
                codec=p.codec,
                sharded=False,
                nbytes=int(p.nbytes),
                predicted_us=predicted,
                measured_us=measured_us,
                fingerprint=self._fingerprint,
                step=int(step),
                source="self",
                predicted_breakdown=breakdown,
            )
            self.samples.append(sample)
            self._detector.observe(sample)
        record_event(
            "feedback_tick",
            step=int(step),
            probes=len(probes),
            elapsed_ms=round((self._clock() - t0) * 1e3, 3),
        )
        breaches = self._detector.breaches()
        if not breaches:
            return None
        if len(samples_to_points(self.samples)) < self.cfg.min_samples:
            # the band can breach on the very first tick (a grossly
            # mis-calibrated start) before enough points exist to fit —
            # keep accumulating rather than burn a loud refusal on warm-up.
            # Count ELIGIBLE points (the fitter's own currency), not raw
            # samples: a probe set mixing codecs under a tight max_samples
            # would otherwise pass this gate while the fit can never see
            # min_samples f32 points — a refuse-every-tick livelock
            if (
                len(self.samples) == self.samples.maxlen
                and not self._starved_logged
            ):
                # the buffer is FULL and still short of eligible points:
                # accumulation can never get there — say so once instead
                # of warming up silently forever
                self._starved_logged = True
                log.warning(
                    "feedback sample buffer full (%d) with fewer than "
                    "min_samples=%d eligible f32 points; this probe set "
                    "cannot feed a refit — widen max_samples or add "
                    "identity-codec probes", len(self.samples),
                    self.cfg.min_samples,
                )
            return None
        if self.refits >= self.cfg.max_refits:
            log.warning(
                "feedback drift persists after %d refit(s); refit budget "
                "exhausted — holding the current plan", self.refits,
            )
            return None
        return self._refit_and_replan(step, breaches)

    def _refit_and_replan(self, step: int, breaches: dict) -> ReplanDecision | None:
        drift = {
            "|".join(str(p) for p in key): round(med, 4)
            for key, med in breaches.items()
        }
        try:
            new_params, meta = fit_from_samples(
                self.samples,
                base_params=self.params,
                min_samples=self.cfg.min_samples,
            )
        except FeedbackRefused as e:
            self.refusals += 1
            record_event(
                "feedback_refused", step=int(step), reason=str(e)[:300]
            )
            log.warning("feedback refit refused at step %d: %s", step, e)
            return None
        if self.coordination is not None:
            return self._propose_replan(step, new_params, meta, drift)
        return self._apply_refit(step, new_params, meta, drift)

    def _apply_refit(
        self, step: int, new_params: TpuCostParams, meta: dict, drift: dict
    ) -> ReplanDecision:
        """The local (uncoordinated) refit tail, shared by the probe path
        and the probe-free path: persist, invalidate, replan, rebuild."""
        self.refits += 1
        if self.cfg.calibration_path:
            save_calibration(
                self.cfg.calibration_path,
                new_params,
                backend=self._backend_name(),
                fingerprint=self._fingerprint,
                source="feedback",
                meta={
                    "samples": len(self.samples),
                    "run_id": self.cfg.run_id or f"step{step}",
                    "step": int(step),
                    "fit": meta,
                    "drift": drift,
                },
            )
        removed = invalidate_plan_cache(
            # world=None: the refit replaced the CONSTANTS, which priced
            # every shortlist this backend ever measured — a multi-axis
            # run's other sync worlds (tp beside dp) are exactly as stale
            # as the probed axis, and a surviving entry would cache-hit
            # the rebuilt step straight back onto the stale winner
            cache_invalidation_predicate(self._fingerprint, None),
            cache_path=self.cfg.plan_cache_path,
        )
        plan = choose_topology(self.n, self.nbytes, params=new_params)
        self.params = new_params
        self._detector.reset()  # re-judge residuals against the refit
        record_event(
            "feedback_refit",
            step=int(step),
            topo=plan.to_ft_topo(),
            invalidated=removed,
            drift=drift,
            samples=len(self.samples),
        )
        log.warning(
            "feedback refit at step %d: drift %s; replanned topo %s, "
            "%d plan-cache entr%s invalidated",
            step, drift, plan.to_ft_topo(), removed,
            "y" if removed == 1 else "ies",
        )
        # drop the consumed samples: a LATER refit (a genuine mid-run
        # regime change) must solve from post-refit measurements, not a
        # mix the old regime dominates; the warm-up guard in tick() makes
        # the next breach re-accumulate min_samples before fitting
        self.samples.clear()
        rebuilt = (
            self.cfg.on_replan(plan, new_params)
            if self.cfg.on_replan is not None
            else None
        )
        return ReplanDecision(plan, new_params, drift, removed, meta, rebuilt)

    # -- the coordinated (multi-process) replan path ---------------------

    def _propose_replan(self, step: int, new_params: TpuCostParams,
                        meta: dict, drift: dict) -> None:
        """Publish the refit as a group decision instead of applying it.
        The payload carries what a peer needs to apply identically: the
        refitted constants (the calibration schema's dict form) and the
        topology the coordinator's chooser picked under them.  Every
        rank, this one included, applies it in :meth:`apply_committed`
        when ``fit``'s coordination gate delivers the commit."""
        payload = {
            "params": _params_to_dict(new_params),
            "topo": choose_topology(self.n, self.nbytes,
                                    params=new_params).to_ft_topo(),
            "drift": drift,
            "fit_meta": meta,
            "samples": len(self.samples),
        }
        epoch = self.coordination.propose(
            "replan", payload,
            apply_step=self.coordination.suggest_apply_step())
        if epoch is None:
            # another decision is mid-handshake (or coordinatorship just
            # moved): keep the samples, breach again on a later tick
            log.warning("feedback refit at step %d could not propose "
                        "(control slot busy); retrying on a later tick",
                        step)
            return None
        self.refits += 1
        self._detector.reset()
        self.samples.clear()
        record_event("feedback_refit", step=int(step), topo=payload["topo"],
                     invalidated=0, drift=drift, samples=payload["samples"],
                     control_epoch=epoch, proposed=True)
        log.warning("feedback refit at step %d proposed as control epoch %d "
                    "(topo %s); group-wide apply on commit", step, epoch,
                    payload["topo"])
        return None

    def apply_committed(self, payload: dict, step: int | None = None):
        """Apply a committed group replan on this rank: rebuild the
        constants, persist and invalidate, replan, and hand back the
        :class:`ReplanDecision` a local refit would — ``fit`` swaps the
        step through the same path.  It depends on the payload alone, so
        every rank lands on one plan; a chooser that disagrees with the
        broadcast topology follows the group and says so."""
        new_params = _params_from_dict(dict(payload["params"]))
        if self.cfg.calibration_path:
            save_calibration(
                self.cfg.calibration_path,
                new_params,
                backend=self._backend_name(),
                fingerprint=self._fingerprint,
                source="feedback",
                meta={
                    "samples": payload.get("samples"),
                    "run_id": self.cfg.run_id or f"step{step}",
                    "step": step,
                    "fit": payload.get("fit_meta", {}),
                    "drift": payload.get("drift", {}),
                    "coordinated": True,
                },
            )
        removed = invalidate_plan_cache(
            cache_invalidation_predicate(self._fingerprint, None),
            cache_path=self.cfg.plan_cache_path,
        )
        from ..runtime.coordination import apply_spec_override

        plan = apply_spec_override(
            choose_topology(self.n, self.nbytes, params=new_params),
            payload.get("topo"), self.n)
        self.params = new_params
        self._detector.reset()
        self.samples.clear()
        rebuilt = (self.cfg.on_replan(plan, new_params)
                   if self.cfg.on_replan is not None else None)
        return ReplanDecision(plan, new_params,
                              dict(payload.get("drift", {})), removed,
                              dict(payload.get("fit_meta", {})), rebuilt)

    # -- the default probe timer -----------------------------------------

    def _default_timer(self, probes, n):
        """Seconds a probe, aligned with ``probes``: each probe's
        ``compressed_allreduce`` on an in-process ``flat_mesh(n)`` of the
        controller's device over seeded rows of ``nbytes // 4`` float32 a
        rank (the JAX timer's seed, one input a ``(n, size)`` shared by
        every spec and codec probing it), built and warmed once and kept
        across ticks, then timed with the bench harness's
        shuffled-interleaved rounds (``bench.harness._interleaved_times``,
        each call waited for on the card); the min of ``repeat``
        rounds."""
        import torch

        from ..bench.harness import _interleaved_times
        from ..parallel.compressed import compressed_allreduce
        from ..parallel.mesh import flat_mesh

        calls = {}
        for i, p in enumerate(probes):
            fn = self._fns.get(p)
            if fn is None:
                mesh = flat_mesh(n, self.device, "ftfb")
                size = max(1, p.nbytes // 4)
                rows = self._inputs.get((n, size))
                if rows is None:
                    rng = np.random.default_rng((n * 1000003 + size) & 0xFFFF)
                    rows = list(torch.as_tensor(
                        rng.standard_normal((n, size)).astype(np.float32),
                        device=self.device).unbind(0))
                    self._inputs[(n, size)] = rows
                wire_spec = "1" if p.spec == "ring" else p.spec

                def fn(rows=rows, mesh=mesh, spec=wire_spec, codec=p.codec):
                    return compressed_allreduce(rows, mesh, topo=spec,
                                                codec=codec)

                fn()  # warm outside the timed rounds
                self._fns[p] = fn
            calls[str(i)] = fn
        times = _interleaved_times(calls, max(1, self.cfg.repeat),
                                   self.device)
        return [times[str(i)]["min_ms"] * 1e-3 for i in range(len(probes))]
