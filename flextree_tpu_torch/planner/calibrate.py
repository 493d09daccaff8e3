"""Cost-model calibration: fit ``TpuCostParams`` from measurements.

PyTorch counterpart of ``flextree_tpu/planner/calibrate.py``: the fit, the
file format (schema 4) and the loaders are copies; the measurement runs on
the port's benchmark harness and the fingerprint names the torch backend
the constants were measured on.

The reference's constants were calibrated on its cluster
(``cost_model/CostModel.h:1-30``: lo/co/bo/o fitted to a 16-host Ethernet
fabric).  This module closes the loop the reference never automated: run
the real collective at a few (topology, size) points on the *current*
backend, then least-squares fit the model's constants so the planner's
argmin tracks measured orderings.

The fit exploits the model's linearity: ``allreduce_cost`` is linear in
(launch_us, latency_us, 1/bandwidth, 1/reduce_bw), so evaluating it with
one-hot "basis" parameter settings yields the feature matrix directly from
the model's own code — the fit can never drift out of sync with the cost
formulas.

Main entry points:

- ``measure_points(topos, sizes, ...)`` — time the collective per point
  (in-place chained protocol, ``bench.harness.run_allreduce_bench``).
- ``fit_cost_params(points)`` — non-negative least-squares fit.
- ``spearman(a, b)`` — rank correlation used to validate a fit.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass

import numpy as np

from ..schedule.stages import Topology
from .cost_model import LinkParams, TpuCostParams, allreduce_cost

__all__ = [
    "MeasuredPoint",
    "measure_points",
    "feature_vector",
    "fit_cost_params",
    "predict_us",
    "spearman",
    "save_calibration",
    "load_calibration",
    "default_params",
    "backend_fingerprint",
    "plan_cache_key",
    "CALIBRATION_SCHEMA",
]

#: Schema version written into every calibration section (the JAX
#: package's, so the two packages share one format).  Bump when the
#: on-disk format changes; loaders refuse sections from a NEWER schema
#: rather than misparse them.  Schema 3 adds the split-collective
#: per-phase bandwidth scales (``rs_bw_scale``/``ag_bw_scale``,
#: arXiv:2409.04202's two-halves costing); schema 4 adds the provenance
#: ``source`` stamp ("measured" = the direct measurement protocol of
#: ``python -m flextree_tpu_torch.tools.calibrate_host``, "feedback" = the
#: JAX package's closed-loop refit from flight-record residuals — with
#: sample count and source-run id in ``meta``).
#: Older sections still load, with the neutral defaults and a logged
#: notice (never silently).
CALIBRATION_SCHEMA = 4


def backend_fingerprint(device=None, *, ranks: int | None = None,
                        transport: str | None = None) -> str:
    """Stable identity of the measuring backend: the device's platform and
    name, the device count, the transport (``mesh`` for an in-process
    mesh, else the process group's backend), the rank count and the torch
    version — the key that keeps constants measured on one backend from
    silently pricing another (an 8-rank in-process mesh must not price a
    gloo group or four cards, and no JAX-written section, ``cpu|cpu|n8|
    jax…``, ever matches).

    ``device``: ``"cuda"``/``"cpu"`` (or a ``torch.device``); None reads
    the backend this process already uses, ``cuda`` when CUDA is
    initialized, else ``cpu`` — like ``default_params`` this never
    initializes CUDA itself (an explicit ``"cuda"`` does).  ``transport``
    and ``ranks`` default to the default process group's backend and size
    when one is initialized, else to ``mesh`` and an unknown rank count
    (``r?``), which matches no measured section.
    """
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_initialized() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        name = torch.cuda.get_device_name(dev)
        count = torch.cuda.device_count()
    else:
        name, count = dev.type, 1
    group = torch.distributed.is_available() and \
        torch.distributed.is_initialized()
    if transport is None:
        transport = torch.distributed.get_backend() if group else "mesh"
    if ranks is None and group:
        ranks = torch.distributed.get_world_size()
    return "|".join([dev.type, name, f"n{count}", str(transport),
                     f"r{ranks if ranks else '?'}",
                     f"torch{torch.__version__}"])


def plan_cache_key(*parts) -> str:
    """Join key components into the flat string key both the calibration
    fingerprint check and the autotune plan cache use — one helper so the
    two caches cannot diverge in how they identify a measurement context."""
    return "|".join("~" if p is None else str(p) for p in parts)


@dataclass(frozen=True)
class MeasuredPoint:
    widths: tuple[int, ...]  # (1,) = ring
    num_nodes: int
    nbytes: int  # per chip
    measured_us: float
    # full per-repetition sample (µs) when available, so validation can
    # compare fitted-prediction spread against measurement noise instead of
    # asserting rank order on indistinguishable points
    times_us: tuple[float, ...] = ()

    @property
    def noise_us(self) -> float:
        """Half the inter-quartile spread of the sample — 0 if unknown."""
        if len(self.times_us) < 4:
            return 0.0
        q1, q3 = np.percentile(self.times_us, [25, 75])
        return 0.5 * float(q3 - q1)


def _params_basis() -> list[TpuCostParams]:
    """One-hot parameter settings s.t. ``cost(p_i)`` is the i-th feature.

    Order: [launch_us, latency_us, inv_link_bw (us/byte), inv_reduce_bw].
    ``bandwidth_GBps=1e-3`` makes ``time_us(nbytes) == nbytes`` (the
    model divides by ``bw*1e3``), i.e. a unit inverse-bandwidth feature.
    """
    big = 1e30  # "infinite" bandwidth: zero contribution
    return [
        TpuCostParams(ici=LinkParams(big, 0.0), dcn=LinkParams(big, 0.0),
                      reduce_bw_GBps=big, control_us_per_width=0.0, launch_us=1.0),
        TpuCostParams(ici=LinkParams(big, 1.0), dcn=LinkParams(big, 1.0),
                      reduce_bw_GBps=big, control_us_per_width=0.0, launch_us=0.0),
        TpuCostParams(ici=LinkParams(1e-3, 0.0), dcn=LinkParams(1e-3, 0.0),
                      reduce_bw_GBps=big, control_us_per_width=0.0, launch_us=0.0),
        TpuCostParams(ici=LinkParams(big, 0.0), dcn=LinkParams(big, 0.0),
                      reduce_bw_GBps=1e-3, control_us_per_width=0.0, launch_us=0.0),
    ]


def feature_vector(widths: tuple[int, ...], n: int, nbytes: int) -> np.ndarray:
    topo = Topology.ring(n) if widths == (1,) else Topology(n, widths)
    return np.array(
        [allreduce_cost(topo, nbytes, p).total_us for p in _params_basis()],
        dtype=np.float64,
    )


def measure_points(
    topos,
    sizes,
    *,
    repeat: int = 10,
    devices: int | None = None,
    stat: str = "median",
    device=None,
    device_time: bool = False,
) -> list[MeasuredPoint]:
    """Time the FlexTree collective at each (topo, size-in-elements) point
    via the benchmark harness's in-place protocol
    (``bench.harness.run_allreduce_bench``): on an in-process mesh of
    ``devices`` ranks (8 when None) on ``device`` (``cuda`` unless
    ``"cpu"``), or, with ``devices=None`` in a process of an initialized
    default process group, over that group.  A point whose result is not
    correct raises.  ``device_time``: on the card, time each call's device
    work alone, enqueued ahead of the card (``BenchConfig.device_time``),
    not the host's dispatch of it.

    ``stat``: summary statistic over the ``repeat`` reps — ``"median"``
    (default; robust on a timeshared host where min-of-few is noise-bound)
    or ``"min"`` (the reference harness's headline, ``benchmark.cpp:215``).
    The full sample is kept on each point.
    """
    import torch.distributed as dist

    from ..bench.harness import BenchConfig, run_allreduce_bench

    if stat not in ("median", "min"):
        raise ValueError(f"stat must be 'median' or 'min', got {stat!r}")
    group = devices is None and dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if group else devices or 8
    points = []
    for size in sizes:
        for spec in topos:
            rep = run_allreduce_bench(
                BenchConfig(size=size, repeat=repeat, comm_type="flextree",
                            topo=spec, devices=None if group else n,
                            device=None if device is None else str(device),
                            dist=group, device_time=device_time)
            )
            if not rep.correct:
                raise AssertionError(f"allreduce {spec} of {size} elements "
                                     f"on {n} ranks is not correct")
            widths = (1,) if rep.topo == "1" else tuple(
                int(w) for w in rep.topo.split("*")
            )
            summary = (
                rep.result.median_s if stat == "median" else rep.result.min_s
            )
            points.append(
                MeasuredPoint(
                    widths, n, size * 4, summary * 1e6,
                    tuple(t * 1e6 for t in rep.result.times_s),
                )
            )
    return points


def fit_cost_params(
    points: list[MeasuredPoint], *, relative: bool = True
) -> TpuCostParams:
    """Non-negative least-squares fit of the 4 model constants.

    Plain ``lstsq`` with negative coefficients clipped to ~0 and refit on
    the surviving features (no scipy dependency); 4 parameters over >=8
    points keeps this well-posed.

    ``relative=True`` (default) fits *relative* residuals — each row is
    scaled by ``1/measured`` — so a 20% error on a fast small-payload point
    weighs the same as a 20% error on a slow large-payload one.  The
    planner's job is rank ordering across shapes, and absolute least
    squares lets the largest-payload points dominate and zero out the
    shape-discriminating launch/latency features (the degenerate
    "predictions are shape-independent" fit).
    """
    if len(points) < 4:
        raise ValueError(f"need >= 4 measured points, got {len(points)}")
    X = np.stack([feature_vector(p.widths, p.num_nodes, p.nbytes) for p in points])
    y = np.array([p.measured_us for p in points])
    if relative:
        w = 1.0 / np.maximum(y, 1e-9)
        Xw = X * w[:, None]
        yw = np.ones_like(y)
    else:
        Xw, yw = X, y
    active = list(range(X.shape[1]))
    theta = np.zeros(X.shape[1])
    for _ in range(X.shape[1]):
        sol, *_ = np.linalg.lstsq(Xw[:, active], yw, rcond=None)
        if (sol >= 0).all():
            theta[:] = 0.0
            theta[active] = sol
            break
        active = [a for a, s in zip(active, sol) if s > 0]
        if not active:
            # every refit round produced negative coefficients: the
            # measurements contradict the model everywhere.  Returning the
            # silent all-zero fit would hand the planner a meaningless
            # ranking — fail loudly instead.
            raise RuntimeError(
                "cost-param fit degenerated: NNLS active set is empty "
                "(all coefficients negative). The measurements are "
                "inconsistent with the cost model; re-measure with more "
                "repeats or check the timing protocol."
            )
    launch, lat, inv_bw, inv_rbw = theta
    tiny = 1e-12
    bw = 1.0 / max(inv_bw, tiny) / 1e3  # us/byte -> GB/s
    rbw = 1.0 / max(inv_rbw, tiny) / 1e3
    return TpuCostParams(
        ici=LinkParams(bandwidth_GBps=bw, latency_us=float(lat)),
        dcn=LinkParams(bandwidth_GBps=bw, latency_us=float(lat)),
        reduce_bw_GBps=rbw,
        control_us_per_width=0.0,
        launch_us=float(launch),
    )


# ---------------------------------------------------------------------------
# persistence: the calibration file
#
# The reference's constants are compiled in (CostModel.h:1-30); ours are
# fitted at runtime, so they need a place to live between runs.  The file
# holds one section per backend ("cpu", "cuda", ...) because constants
# measured on a CPU host must never silently price a GPU.  The port writes
# its own file (FLEXTREE_CALIBRATION, --calibration); the format is the
# JAX package's, so either package reads the other's sections under a
# matching fingerprint.
# Loading is EXPLICIT (path argument, FLEXTREE_CALIBRATION env var, or the
# planner CLI's --calibration flag) rather than an ambient cwd lookup, so
# library behavior — including the golden tests pinning the invented
# defaults — never depends on what directory you happen to run from.
# ---------------------------------------------------------------------------


def _params_to_dict(p: TpuCostParams) -> dict:
    return {
        "ici_bandwidth_GBps": p.ici.bandwidth_GBps,
        "ici_latency_us": p.ici.latency_us,
        "dcn_bandwidth_GBps": p.dcn.bandwidth_GBps,
        "dcn_latency_us": p.dcn.latency_us,
        "reduce_bw_GBps": p.reduce_bw_GBps,
        "control_us_per_width": p.control_us_per_width,
        "launch_us": p.launch_us,
        "codec_bw_GBps": p.codec_bw_GBps,
        "bwd_GFLOPs": p.bwd_GFLOPs,
        "rs_bw_scale": p.rs_bw_scale,
        "ag_bw_scale": p.ag_bw_scale,
    }


def _params_from_dict(d: dict) -> TpuCostParams:
    if "rs_bw_scale" not in d or "ag_bw_scale" not in d:
        # pre-schema-3 section: the split-collective per-phase scales were
        # not measured — load with the neutral 1.0 (the fused costing),
        # and say so rather than defaulting silently
        logging.getLogger("flextree.planner").info(
            "calibration section predates the split-collective constants "
            "(schema < 3); rs_bw_scale/ag_bw_scale default to 1.0 — "
            "re-run python -m flextree_tpu_torch.tools.calibrate_host to "
            "measure them"
        )
    return TpuCostParams(
        ici=LinkParams(d["ici_bandwidth_GBps"], d["ici_latency_us"]),
        dcn=LinkParams(d["dcn_bandwidth_GBps"], d["dcn_latency_us"]),
        reduce_bw_GBps=d["reduce_bw_GBps"],
        control_us_per_width=d["control_us_per_width"],
        launch_us=d["launch_us"],
        # schema-1 files predate the codec term: fall back to the default
        codec_bw_GBps=d.get("codec_bw_GBps", TpuCostParams.codec_bw_GBps),
        # files written before the overlap planner lack the backward-compute
        # constant: 0.0 keeps the backend-resolved default in force
        bwd_GFLOPs=d.get("bwd_GFLOPs", TpuCostParams.bwd_GFLOPs),
        rs_bw_scale=d.get("rs_bw_scale", TpuCostParams.rs_bw_scale),
        ag_bw_scale=d.get("ag_bw_scale", TpuCostParams.ag_bw_scale),
    )


def save_calibration(
    path,
    params: TpuCostParams,
    *,
    backend: str,
    meta: dict | None = None,
    fingerprint: str | None = None,
    source: str = "measured",
) -> None:
    """Write/merge the ``backend`` section of a CALIBRATION.json file.

    ``meta`` should say where the numbers came from (protocol, host,
    measured points, date) — the file is a committed artifact and each
    constant must be traceable to a measurement or labeled as a default.

    Every section is stamped with ``schema`` (:data:`CALIBRATION_SCHEMA`),
    the measuring backend's ``fingerprint``
    (:func:`backend_fingerprint` unless given explicitly) so a fit from
    one host is never silently reused on another — ``load_calibration``
    rejects mismatches — and a provenance ``source``: ``"measured"`` (the
    direct-measurement protocol of ``python -m
    flextree_tpu_torch.tools.calibrate_host``) or ``"feedback"`` (the JAX
    package's closed-loop refit from flight-record residuals — its
    ``meta`` carries the sample count and the source-run id).
    """
    import json
    import os

    doc = {}
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
    doc[backend] = {
        "schema": CALIBRATION_SCHEMA,
        "fingerprint": fingerprint or backend_fingerprint(),
        "source": source,
        "params": _params_to_dict(params),
        "meta": meta or {},
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)


def load_calibration(
    path, *, backend: str, fingerprint: str | None = None
) -> TpuCostParams | None:
    """Load the ``backend`` section; None if the file/section is absent.

    Section names may be more specific than platform names (a file may
    say ``cuda_h100`` where the platform is ``cuda``), so a miss on the
    exact name falls back to the unique section with the platform as a
    prefix — measured constants must not be silently dropped because of a
    naming-granularity mismatch.  Ambiguity (two ``cuda_*`` sections)
    stays a miss: guessing between cards would be worse.

    Fingerprint check: when the section carries one AND the current
    backend's fingerprint is determinable (``fingerprint`` argument, else
    :func:`backend_fingerprint`), a mismatch is a **miss** — constants
    fitted on another host/chip must not silently price this one.
    Sections written before the fingerprint era (no ``fingerprint`` key)
    load with a warning: not silent, and the committed per-backend section
    names still gate the platform.  Sections from a NEWER schema are
    rejected outright rather than misparsed.
    """
    import json
    import os

    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        doc = json.load(f)
    sec = doc.get(backend)
    if sec is None:
        prefixed = [k for k in doc if k.startswith(backend + "_")]
        if len(prefixed) == 1:
            sec = doc[prefixed[0]]
    if not sec:
        return None
    log = logging.getLogger("flextree.planner")
    if sec.get("schema", 1) > CALIBRATION_SCHEMA:
        log.warning(
            "calibration %s section %r has schema %s > supported %s; ignoring",
            path, backend, sec.get("schema"), CALIBRATION_SCHEMA,
        )
        return None
    # provenance source stamp (schema 4): pre-stamp sections load — the
    # established older-sections-load-non-silently contract — but say so,
    # and every mismatch warning below names where the constants came from
    source = sec.get("source")
    if source is None:
        log.info(
            "calibration %s section %r predates source stamping "
            "(schema < 4); re-run python -m "
            "flextree_tpu_torch.tools.calibrate_host to record whether "
            "these constants are measured or feedback-fitted",
            path, backend,
        )
        source = "unstamped"
    saved_fp = sec.get("fingerprint")
    if saved_fp is None:
        log.warning(
            "calibration %s section %r (source=%s) predates fingerprinting; "
            "loading unverified (re-run python -m "
            "flextree_tpu_torch.tools.calibrate_host to stamp it)",
            path, backend, source,
        )
    else:
        current_fp = fingerprint or backend_fingerprint()
        if current_fp is not None and current_fp != saved_fp:
            log.warning(
                "calibration %s section %r (source=%s) was fitted on %r but "
                "this backend is %r; ignoring it (re-run python -m "
                "flextree_tpu_torch.tools.calibrate_host on this host)",
                path, backend, source, saved_fp, current_fp,
            )
            return None
    return _params_from_dict(sec["params"])


def default_params(backend: str | None = None) -> TpuCostParams:
    """The planner's default constants: the ``FLEXTREE_CALIBRATION`` file's
    section for ``backend`` when both exist and its fingerprint is this
    process's (:func:`backend_fingerprint`), else the ``TpuCostParams()``
    defaults (fitted on an H100, ``cost_model.py``).

    ``backend=None`` resolves from ``FLEXTREE_CALIBRATION_BACKEND`` or, if
    CUDA is already initialized, ``"cuda"`` — it will NOT initialize CUDA
    itself, and the planner stays usable on a host without a card.
    """
    import os

    import torch

    path = os.environ.get("FLEXTREE_CALIBRATION")
    if not path:
        return TpuCostParams()
    if backend is None:
        backend = os.environ.get("FLEXTREE_CALIBRATION_BACKEND")
    if backend is None and torch.cuda.is_initialized():
        backend = "cuda"
    if backend is None:
        # UNRESOLVABLE backend: fall back to the defaults, not to some
        # section — guessing (e.g. "cpu") would let a CPU host's constants
        # silently price a GPU, the exact failure the per-backend sections
        # exist to prevent
        return TpuCostParams()
    return load_calibration(path, backend=backend) or TpuCostParams()


def predict_us(params: TpuCostParams, widths, n: int, nbytes: int) -> float:
    topo = Topology.ring(n) if tuple(widths) == (1,) else Topology(n, tuple(widths))
    return allreduce_cost(topo, nbytes, params).total_us


def spearman(a, b) -> float:
    """Spearman rank correlation (ties -> average rank; no scipy)."""

    def rankdata(v):
        v = np.asarray(v, dtype=np.float64)
        order = np.argsort(v, kind="stable")
        ranks = np.empty(len(v))
        ranks[order] = np.arange(1, len(v) + 1)
        for val in np.unique(v):
            m = v == val
            if m.sum() > 1:
                ranks[m] = ranks[m].mean()
        return ranks

    ra, rb = rankdata(a), rankdata(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = math.sqrt((ra**2).sum() * (rb**2).sum())
    return float((ra * rb).sum() / denom) if denom else 0.0
