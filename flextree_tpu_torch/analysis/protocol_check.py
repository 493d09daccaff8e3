"""Explicit-state model checking of the control-plane protocols.

The port's copy of ``flextree_tpu/analysis/protocol_check.py``.  The
chaos tests *sample* interleavings of the host-side control plane; this
layer *enumerates* them.  Extracted transition models — each living
beside its implementation and pinned to it by shared constants plus the
conformance tests in ``tests/test_torch_protocol_check.py`` — are
explored exhaustively over small worlds with faults injectable at every
transition:

- :class:`~flextree_tpu_torch.runtime.coord_model.CoordModel` — the
  propose→ack→commit handshake at 2/3/4 ranks, coordinator crash at
  every transition, stalled followers, duplicate acks, lost races;
- :class:`~flextree_tpu_torch.runtime.lease_model.LeaseModel` — the
  revoke→ack→grant chip handoff with tenant restart mid-handoff;
- :class:`~flextree_tpu_torch.serving.rpc_model.RpcModel` — one rid's
  retry/hedge/re-route lifecycle against the replica idempotency store;
- :class:`~flextree_tpu_torch.serving.rpc_model.MigrationModel` — the
  disaggregated KV-migration handshake (export → ship → admit-or-refuse
  → release) with the decode replica crashing at every phase: a crash
  mid-migration never loses the request or leaks the prefill-side
  export.

Invariants checked in EVERY reachable state (write-time rules, per-state
predicates, and quiescence checks): at most one commit per control
epoch, commits byte-identical to their proposals, control and lease
epochs strictly increasing, fenced ranks never applying, no chip
granted to (or in active use by) two holders, every rid landing in
exactly one of {completed-once, shed, failed} with no re-execution of a
completed rid, and no migration export left held.

The search is bounded EXPLICITLY: each model carries fault/decision
budgets (reported per model), memoization is the visited-state set, and
a ``max_states`` overflow or a budget-limited quiescent frontier is
reported as ``truncated`` — never silently absorbed into "clean".
A violation's report line carries a minimal witness trace (the label
path from the initial state), which is also how the mutation self-test
proves the seeded protocol corruptions produce *reachable* violations.
"""

from __future__ import annotations

import time
from collections import deque

from .base import Violation

__all__ = ["explore", "run_protocol_check", "default_models"]

# hard cap on any single model's visited set (the JAX package's: its
# coordination model at 4 ranks explores ~10^4-10^5 states); anything past
# this cap is a model regression, reported as truncation, not silently
# dropped
MAX_STATES = 400_000


class ExploreResult:
    def __init__(self, name):
        self.name = name
        self.states = 0
        self.transitions = 0
        self.fault_transitions = 0
        self.truncated = False  # hard cap hit: the search is NOT exhaustive
        # quiescent states whose only blocked successor was a documented
        # model budget (reported, distinct from truncation: the budgets
        # are the explicit small-world bound, not a search failure)
        self.bounded_frontier = 0
        self.elapsed_ms = 0.0
        # kind -> (count, witness, first_detail)
        self.violations: dict[str, tuple[int, str, str]] = {}

    def add_violation(self, kind, detail, witness):
        count, w, d = self.violations.get(kind, (0, witness, detail))
        self.violations[kind] = (count + 1, w, d)

    def to_detail(self) -> dict:
        return {
            "states": self.states,
            "transitions": self.transitions,
            "fault_transitions": self.fault_transitions,
            "truncated": self.truncated,
            "bounded_frontier": self.bounded_frontier,
            "violations": sum(c for c, _, _ in self.violations.values()),
        }


def explore(model, max_states: int = MAX_STATES) -> ExploreResult:
    """Exhaustive BFS over ``model``'s reachable states.

    The model contract: ``initial()``, ``transitions(state) ->
    [(label, next_state, [(kind, detail), ...])]``, optional
    ``state_violations(state)`` (per-state predicates) and
    ``quiescent_violations(state) -> ([(kind, detail)], truncated)``
    (terminal-state checks, with budget-truncation reported
    separately), plus ``is_fault_label(label)`` for the fault-injection
    accounting.  BFS keeps witness traces minimal (first hit = shortest
    path in transitions).
    """
    t0 = time.perf_counter()
    res = ExploreResult(model.name)
    init = model.initial()
    parent: dict = {init: None}  # state -> (prev_state, label)
    queue = deque([init])
    res.states = 1
    check_state = getattr(model, "state_violations", None)
    if check_state is not None:
        for kind, detail in check_state(init):
            res.add_violation(kind, detail, "<initial>")
    while queue:
        s = queue.popleft()
        succs = model.transitions(s)
        if not succs:
            viols, bounded = model.quiescent_violations(s)
            if bounded:
                res.bounded_frontier += 1
            for kind, detail in viols:
                res.add_violation(kind, detail, _witness(parent, s))
            continue
        for label, ns, viols in succs:
            res.transitions += 1
            if model.is_fault_label(label):
                res.fault_transitions += 1
            for kind, detail in viols:
                res.add_violation(kind, detail,
                                  _witness(parent, s, extra=label))
            if ns in parent:
                continue
            if res.states >= max_states:
                res.truncated = True
                continue
            parent[ns] = (s, label)
            res.states += 1
            if check_state is not None:
                for kind, detail in check_state(ns):
                    res.add_violation(kind, detail,
                                      _witness(parent, s, extra=label))
            queue.append(ns)
    res.elapsed_ms = round((time.perf_counter() - t0) * 1e3, 1)
    return res


def _witness(parent, state, extra=None, cap: int = 24) -> str:
    labels = [] if extra is None else [extra]
    while parent.get(state) is not None:
        state, label = parent[state]
        labels.append(label)
    labels.reverse()
    if len(labels) > cap:
        labels = ["..."] + labels[-cap:]
    return " -> ".join(labels)


def default_models():
    """The committed matrix, the JAX package's: coordination at every
    small-world width (crash injected at every transition of each), one
    lease world, one RPC world, one KV-migration world."""
    from ..runtime.coord_model import CoordModel
    from ..runtime.lease_model import LeaseModel
    from ..serving.rpc_model import MigrationModel, RpcModel

    return [
        CoordModel(2),
        CoordModel(3),
        CoordModel(4),
        LeaseModel(),
        RpcModel(),
        MigrationModel(),
    ]


def run_protocol_check(
    programs=None, times: dict | None = None, models=None
):
    """Explore every model; return ``(violations, detail)``.

    ``programs`` filters by model-name substring (the CLI's
    ``--programs`` hook); ``times`` collects per-model wall-times in ms
    keyed by model name, like every other layer.  A clean tree reports
    zero violations and zero truncation; EITHER is a red report (a
    truncated search is not a verified search).
    """
    if models is None:
        models = default_models()
    violations: list[Violation] = []
    detail: dict = {"models": {}}
    for model in models:
        if programs and not any(p in model.name for p in programs):
            continue
        res = explore(model)
        detail["models"][model.name] = res.to_detail()
        if times is not None:
            times[model.name] = res.elapsed_ms
        for kind, (count, witness, vdetail) in sorted(res.violations.items()):
            violations.append(Violation(
                layer="protocol",
                kind=kind,
                where=model.name,
                detail=f"{vdetail} [{count} reachable; witness: {witness}]",
            ))
        if res.truncated:
            violations.append(Violation(
                layer="protocol",
                kind="search-truncated",
                where=model.name,
                detail=(
                    f"state-space search truncated at {res.states} states "
                    "— a truncated search is not a verified search; raise "
                    "MAX_STATES or shrink the model's budgets"
                ),
            ))
    detail["states"] = sum(
        m["states"] for m in detail["models"].values()
    )
    detail["transitions"] = sum(
        m["transitions"] for m in detail["models"].values()
    )
    return violations, detail
