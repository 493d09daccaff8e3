"""Offline planner: candidate enumeration + cost model + chooser.

The port's copy of ``flextree_tpu/planner``, the rebuild of the
reference's ``cost_model/`` + ``topo_count/`` subsystems.  Unlike the
reference (where the planner is a separate binary whose printed width
vector a human pastes into ``FT_TOPO``, SURVEY §1), it is importable by
the runtime — ``choose_topology(...).topology`` drops straight into
``parallel.allreduce.allreduce(topo=...)`` — while remaining usable
offline via ``python -m flextree_tpu_torch.planner``.  Its constants are
fitted on the card by ``python -m flextree_tpu_torch.tools.calibrate_host``
(:mod:`.calibrate`); the measured autotuner (:mod:`.autotune`) times the
analytic shortlist on the card and caches the winner; the closed-loop
feedback (:mod:`.feedback`) refits the constants from a run's flight
records, detects drift and replans in-run, alone or, given a
``runtime.CoordinationHandle``, as a group decision every rank applies.

Not ported: the native C++ core (ROADMAP.md, Queue 1:
'``schedule/native.py``').
"""

from .cost_model import (
    CostBreakdown,
    DCN_DEFAULT,
    ICI_DEFAULT,
    LinkParams,
    TpuCostParams,
    allreduce_cost,
    bus_bandwidth_GBps,
    ring_cost,
)
from .calibrate import (
    CALIBRATION_SCHEMA,
    MeasuredPoint,
    backend_fingerprint,
    default_params,
    feature_vector,
    fit_cost_params,
    load_calibration,
    measure_points,
    plan_cache_key,
    predict_us,
    save_calibration,
    spearman,
)
from .autotune import (
    PLAN_CACHE_SCHEMA,
    TunedPlan,
    analytic_shortlist,
    autotune_plan,
    invalidate_plan_cache,
)
from .feedback import (
    DriftDetector,
    FeedbackConfig,
    FeedbackController,
    FeedbackRefused,
    ProbePoint,
    ReplanDecision,
    cache_invalidation_predicate,
    extract_residuals,
    fit_from_samples,
)
from .choose import (
    Candidate,
    Plan,
    candidate_topologies,
    choose_bucket_bytes,
    choose_topology,
    replan_for_survivors,
)
from .factorize import (
    count_ordered_factorizations,
    is_prime,
    ordered_factorizations,
    ordered_factorizations_combinatoric,
    prime_factors,
)
from .shapes import format_shape, parse_shape, shape_taxonomy

__all__ = [
    "CostBreakdown",
    "LinkParams",
    "TpuCostParams",
    "ICI_DEFAULT",
    "DCN_DEFAULT",
    "allreduce_cost",
    "ring_cost",
    "bus_bandwidth_GBps",
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
    "PLAN_CACHE_SCHEMA",
    "TunedPlan",
    "analytic_shortlist",
    "autotune_plan",
    "invalidate_plan_cache",
    "DriftDetector",
    "FeedbackConfig",
    "FeedbackController",
    "FeedbackRefused",
    "ProbePoint",
    "ReplanDecision",
    "cache_invalidation_predicate",
    "extract_residuals",
    "fit_from_samples",
    "Candidate",
    "Plan",
    "candidate_topologies",
    "choose_bucket_bytes",
    "choose_topology",
    "replan_for_survivors",
    "count_ordered_factorizations",
    "is_prime",
    "ordered_factorizations",
    "ordered_factorizations_combinatoric",
    "prime_factors",
    "format_shape",
    "parse_shape",
    "shape_taxonomy",
]
