"""Extracted transition model of the RPC request lifecycle.

The port's copy of ``flextree_tpu/serving/rpc_model.py``, pinned to the
port's own error taxonomy (:mod:`.rpc`, :mod:`.migration`).

The front-door request path of :mod:`.frontdoor` + :mod:`.replica_main`
reduced to an explicit-state machine for `analysis/protocol_check.py`:
one rid's life across retries, a hedge, drain re-routing, replica
crashes and the replica idempotency store, enumerated exhaustively so
the exactly-once claims the RPC chaos tests spot-check hold in EVERY
interleaving of the small world, not
just the sampled ones.

Pinned to the implementation:

- terminal classification uses the production error taxonomy — a failed
  rid carries :class:`~.rpc.RpcTimeout`'s / :class:`~.rpc.RpcShed`'s /
  :class:`~.rpc.RpcConnRefused`'s pinned ``.code`` strings (imported,
  not restated), and ``tests/test_torch_protocol_check.py`` pins the
  model's code set against the classes;
- the replica intake mirrors ``ReplicaServer._handle``'s order: drain
  refusal → idempotency-store replay (``engine.completed``) → execute;
  the ``"replay_miss"`` mutation skips exactly the store check, which
  is what makes re-execution of a completed rid reachable;
- delivery is the front door's first-writer-wins ``_deliver``: the
  first usable result resolves the rid, a hedge loser is a wasted RPC,
  never a second delivery.

Honest limits: one rid and two replicas (the lifecycle invariants are
per-rid; hedging needs exactly two parties), bounded attempts, the
wire abstracted to {result, refusal, loss} (framing/CRC tears are the
ctrlfile trailer's proven layer — a torn frame surfaces here as the
``lost`` outcome), and deadlines as a nondeterministically-enabled
expiry transition.

Mutation: ``"replay_miss"`` (the idempotency store misses on replay —
a retried rid re-executes on the same replica).

:class:`MigrationModel` is the disaggregation twin: one rid's KV
migration handshake (export → ship → admit-or-refuse → release) between
a prefill replica and a decode replica, with the decode crash injectable
at every phase.  Its invariants are the handoff's two safety claims — a
crash mid-migration never LOSES the request (every quiescent state is a
loud terminal) and never LEAKS the prefill-side export (the exported
blocks are released on exactly the ack/abort edges
``replica_main._handle_migrate`` releases them on).  Mutation:
``"skip_release"`` (the abort paths — decode refusal, ship failure —
skip ``engine.release_exported``, which is what makes the block leak
reachable).
"""

from __future__ import annotations

from .migration import MigrationError
from .rpc import RpcConnRefused, RpcShed, RpcTimeout

__all__ = [
    "RpcModel",
    "RPC_MUTATIONS",
    "TERMINAL_STATUSES",
    "FAIL_CODES",
    "MigrationModel",
    "MIGRATION_MUTATIONS",
]

RPC_MUTATIONS = ("replay_miss",)
MIGRATION_MUTATIONS = ("skip_release",)

# the exactly-one-of terminal set ("every rid lands in exactly one of
# completed-once / shed / failed")
TERMINAL_STATUSES = ("completed", "shed", "failed")
INFLIGHT = "inflight"
# a failed rid's classification comes from the production taxonomy
FAIL_CODES = (RpcTimeout.code, RpcConnRefused.code, RpcShed.code)

_N_REPLICAS = 2


class RpcModel:
    """State = (fd, replicas, attempts, budgets).

    ``fd``: ``(status, delivered)`` — the front door's terminal record
    for the rid and how many results were delivered to the caller.
    ``replicas``: per replica ``(alive, draining, in_store, execs)`` —
    ``in_store`` is ``engine.completed``'s verdict for the rid,
    ``execs`` counts actual engine executions (the quantity the
    no-re-execution invariant bounds).  ``attempts``: in-flight
    ``(replica, outcome)`` pairs, outcome in {sent, result, drain,
    shed, error}.  ``budgets``: ``(dispatches, crashes, drains)``.
    """

    name_prefix = "rpc"

    def __init__(self, *, dispatches: int = 3, crashes: int = 1,
                 drains: int = 1, mutation: str | None = None):
        if mutation is not None and mutation not in RPC_MUTATIONS:
            raise ValueError(f"unknown rpc mutation: {mutation}")
        self.mutation = mutation
        self.budget0 = (dispatches, crashes, drains)
        self.name = f"{self.name_prefix}@{_N_REPLICAS}replicas"
        if mutation:
            self.name += f"+{mutation}"

    def initial(self):
        replicas = tuple((True, False, False, 0) for _ in range(_N_REPLICAS))
        return ((INFLIGHT, 0), replicas, (), self.budget0)

    def is_fault_label(self, label: str) -> bool:
        return label.startswith(("crash", "drain"))

    # ---- transitions -------------------------------------------------------

    def transitions(self, state):
        fd, replicas, attempts, budgets = state
        status, delivered = fd
        dispatches, crashes, drains = budgets
        out = []

        # -- intake shed: the front door refuses at the door (only
        #    before any attempt exists — shed_outstanding at submit)
        if status == INFLIGHT and not attempts and dispatches == \
                self.budget0[0]:
            out.append((f"shed_intake({RpcShed.code})",
                        (("shed", delivered), replicas, attempts, budgets),
                        []))

        # -- dispatch an attempt (retry after a failed one, or a hedge
        #    beside an outstanding one — at most 2 concurrent, distinct
        #    replicas, mirroring max_hedges=1)
        if status == INFLIGHT and dispatches > 0 and len(attempts) < 2:
            used = {r for r, _ in attempts}
            for r in range(_N_REPLICAS):
                if r in used:
                    continue  # a hedge goes to a DIFFERENT replica
                alive = replicas[r][0]
                na = attempts + ((r, "sent" if alive else "error"),)
                out.append((f"dispatch(rep{r})",
                            (fd, replicas, na,
                             (dispatches - 1, crashes, drains)), []))

        # -- replica processes a sent attempt: ReplicaServer._handle's
        #    order — drain refusal, then the idempotency store, then
        #    execute
        for i, (r, phase) in enumerate(attempts):
            if phase != "sent":
                continue
            alive, draining, in_store, execs = replicas[r]
            if not alive:
                continue  # crash transition already failed its attempts
            if draining:
                out.append((f"refuse_drain(rep{r})",
                            (fd, replicas,
                             _set(attempts, i, (r, "drain")), budgets), []))
                continue
            # backlog shed: max_pending reached at intake (the backlog
            # itself is other rids' traffic, abstracted to the refusal)
            out.append((f"refuse_shed(rep{r})",
                        (fd, replicas, _set(attempts, i, (r, "shed")),
                         budgets), []))
            viol = []
            if in_store and self.mutation != "replay_miss":
                # dedup replay: answered from the store, no execution
                nr = replicas
            else:
                if in_store:
                    viol.append((
                        "completed-rid-reexecuted",
                        f"rid re-executed on replica {r} with its result "
                        "already in the idempotency store (store check "
                        "skipped) — exactly-once is now at-least-twice",
                    ))
                nr = _set(replicas, r, (alive, draining, True, execs + 1))
            out.append((f"execute(rep{r})",
                        (fd, nr, _set(attempts, i, (r, "result")), budgets),
                        viol))
            # the response can also be lost in flight (torn frame, reset
            # mid-reply): the replica DID execute, the caller sees error
            out.append((f"respond_lost(rep{r})",
                        (fd, nr, _set(attempts, i, (r, "error")), budgets),
                        viol))

        # -- front door harvests a finished attempt
        for i, (r, phase) in enumerate(attempts):
            if phase == "sent":
                continue
            na = attempts[:i] + attempts[i + 1:]
            if phase == "result":
                if status == INFLIGHT:
                    nfd = ("completed", delivered + 1)
                else:
                    nfd = fd  # late/hedge-loser result: dropped, never a
                    # second delivery (first-writer-wins _deliver)
                out.append((f"deliver(rep{r})", (nfd, replicas, na, budgets),
                            []))
            else:  # drain / shed / error → retry elsewhere or give up
                out.append((f"drop_attempt(rep{r},{phase})",
                            (fd, replicas, na, budgets), []))
                if status == INFLIGHT and not na and dispatches == 0:
                    code = (RpcShed.code if phase == "shed"
                            else RpcConnRefused.code)
                    out.append((f"fail({code})",
                                (("failed", delivered), replicas, na,
                                 budgets), []))

        # -- deadline expiry: always possible while unresolved (the
        #    budget the caller stops waiting at) — outstanding attempts
        #    keep running as waste, their results are dropped above
        if status == INFLIGHT:
            out.append((f"deadline({RpcTimeout.code})",
                        (("failed", delivered), replicas, attempts, budgets),
                        []))

        # -- fault injection at every transition: replica crash (its
        #    in-flight attempts all error at once — _fail_all) and
        #    SIGTERM drain
        if crashes > 0:
            for r in range(_N_REPLICAS):
                alive, draining, in_store, execs = replicas[r]
                if not alive:
                    continue
                nr = _set(replicas, r, (False, draining, in_store, execs))
                na = tuple((ar, "error" if (ar == r and ph == "sent") else ph)
                           for ar, ph in attempts)
                out.append((f"crash(rep{r})",
                            (fd, nr, na, (dispatches, crashes - 1, drains)),
                            []))
        if drains > 0:
            for r in range(_N_REPLICAS):
                alive, draining, in_store, execs = replicas[r]
                if not alive or draining:
                    continue
                nr = _set(replicas, r, (alive, True, in_store, execs))
                out.append((f"drain(rep{r})",
                            (fd, nr, attempts,
                             (dispatches, crashes, drains - 1)), []))
        return out

    # ---- invariants --------------------------------------------------------

    def state_violations(self, state):
        """Every reachable state: delivery and execution bounds."""
        (status, delivered), replicas, attempts, budgets = state
        viols = []
        if delivered > 1:
            viols.append((
                "double-delivery",
                f"rid delivered {delivered} times — completed-once means "
                "exactly once",
            ))
        if delivered and status != "completed":
            viols.append((
                "terminal-mismatch",
                f"rid delivered a result yet terminal status is {status}",
            ))
        for r, (alive, draining, in_store, execs) in enumerate(replicas):
            if execs > 1:
                viols.append((
                    "completed-rid-reexecuted",
                    f"rid executed {execs} times on replica {r} — the "
                    "idempotency store must answer replays",
                ))
        return viols

    def quiescent_violations(self, state):
        (status, delivered), replicas, attempts, budgets = state
        viols, truncated = [], False
        if status not in TERMINAL_STATUSES:
            viols.append((
                "unresolved-rid",
                f"quiescent with rid status {status} — every rid must land "
                f"in exactly one of {TERMINAL_STATUSES}",
            ))
        if status == "completed" and delivered != 1:
            viols.append((
                "terminal-mismatch",
                f"completed rid delivered {delivered} results",
            ))
        return viols, truncated


class MigrationModel:
    """State = ``(status, exported, decode_alive, decode_has_seq,
    attempts, crashes)``.

    ``status`` is the front door's view of the rid: ``inflight`` (no
    handoff running — the colocated fallback and the deadline live
    here), ``exported`` (prefill done, blocks parked in
    ``engine._exported``, ship unresolved), ``admitted`` (decode
    verified + admitted, ack delivered to the prefill side),
    ``handed_off`` (export released on ack; the sequence lives on the
    decode replica), and the terminals ``completed`` / ``failed``.
    ``exported`` tracks the prefill-side blocks the release handshake
    must free exactly once; ``decode_has_seq`` tracks whether the decode
    replica holds the migrated sequence (dies with the process — paged
    blocks are process memory, so a crash frees them and is never a
    leak).  Budgets: ``attempts`` bounds front-door launches (export,
    local fallback, collect re-route), ``crashes`` bounds decode-replica
    deaths.

    Honest limits: one rid, one prefill and one decode replica, the wire
    abstracted to {ack, refuse, lost} (CRC/shape refusals of a poisoned
    payload surface as ``refuse`` — the byte-level checks are
    ``unpack_kv``'s tested layer), and the deadline only fires between
    handoff rounds (the front door abandons between rounds; the replica
    halves of a mid-flight handshake still run to their release edges,
    which is exactly what the implementation's synchronous
    ``_handle_migrate`` does)."""

    name_prefix = "migration"

    def __init__(self, *, attempts: int = 3, crashes: int = 2,
                 mutation: str | None = None):
        if mutation is not None and mutation not in MIGRATION_MUTATIONS:
            raise ValueError(f"unknown migration mutation: {mutation}")
        self.mutation = mutation
        self.budget0 = (attempts, crashes)
        self.name = f"{self.name_prefix}@1hop"
        if mutation:
            self.name += f"+{mutation}"

    def initial(self):
        return ("inflight", False, True, False) + self.budget0

    def is_fault_label(self, label: str) -> bool:
        return label.startswith(("crash", "drain"))

    # ---- transitions -------------------------------------------------------

    def transitions(self, state):
        status, exported, alive, has_seq, attempts, crashes = state
        out = []

        def _abort(label, *, seq=has_seq):
            # release_exported(acked=False) — the edge the
            # ``skip_release`` mutation deletes
            freed = exported if self.mutation == "skip_release" else False
            out.append((label,
                        ("inflight", freed, alive, seq, attempts, crashes),
                        []))

        if status == "inflight":
            if attempts > 0 and not exported:
                # prefill_for_migration: prefill + first token + export
                out.append(("export",
                            ("exported", True, alive, has_seq,
                             attempts - 1, crashes), []))
            if attempts > 0:
                # the migrate-vs-local fallback: a colocated (or other
                # decode-tier) replica serves the rid without the hop
                out.append(("complete_local",
                            ("completed", exported, alive, has_seq,
                             attempts - 1, crashes), []))
            # deadline expiry: the caller stops waiting
            out.append((f"deadline({RpcTimeout.code})",
                        ("failed", exported, alive, has_seq, attempts,
                         crashes), []))

        elif status == "exported":
            if alive:
                # admit-or-refuse, plus the ack lost in flight AFTER the
                # decode side already admitted (reply torn mid-stream):
                # the prefill side aborts either way, the decode side
                # keeps the sequence it admitted
                out.append(("admit_ack",
                            ("admitted", exported, alive, True, attempts,
                             crashes), []))
                _abort(f"refuse({MigrationError.code})")
                _abort("ship_lost_after_admit", seq=True)
            else:
                # receiver unreachable / died mid-stream
                _abort(f"ship_fail({RpcConnRefused.code})")

        elif status == "admitted":
            # the ack already landed: release_exported(acked=True) is
            # unconditional, crash or no crash on the decode side
            out.append(("release_ack",
                        ("handed_off", False, alive, has_seq, attempts,
                         crashes), []))

        elif status == "handed_off":
            if alive:
                out.append(("complete_remote",
                            ("completed", exported, alive, has_seq,
                             attempts, crashes), []))
            elif attempts > 0:
                # decode died holding the sequence: the collect attempt
                # errors and the front door re-routes (the sequence died
                # with the process — greedy decode recomputes bitwise)
                out.append(("collect_retry",
                            ("inflight", exported, alive, False,
                             attempts - 1, crashes), []))
            else:
                out.append((f"deadline({RpcTimeout.code})",
                            ("failed", exported, alive, has_seq, attempts,
                             crashes), []))

        # -- fault injection: the decode replica can crash at any phase;
        #    its admitted sequence (and blocks) die with the process
        if crashes > 0 and alive and status not in ("completed", "failed"):
            out.append(("crash(decode)",
                        (status, exported, False, False, attempts,
                         crashes - 1), []))
        return out

    # ---- invariants --------------------------------------------------------

    def state_violations(self, state):
        return []

    def quiescent_violations(self, state):
        status, exported, alive, has_seq, attempts, crashes = state
        viols = []
        if status not in ("completed", "failed"):
            viols.append((
                "unresolved-rid",
                f"quiescent with rid status {status} — a crash mid-"
                "migration must resolve to a loud terminal, never lose "
                "the request",
            ))
        if exported:
            viols.append((
                "migration-block-leak",
                "quiescent with the prefill-side export still held — "
                "release_exported must run on every ack AND abort edge, "
                "or each failed handoff leaks blocks_for(prompt) blocks "
                "until the pool starves",
            ))
        return viols, False


def _set(tup, i, row):
    return tup[:i] + (row,) + tup[i + 1:]
