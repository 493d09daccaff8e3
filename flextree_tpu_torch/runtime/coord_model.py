"""Extracted transition model of the coordination handshake.

The port's copy of ``flextree_tpu/runtime/coord_model.py``: the same
states, transitions, violation kinds and mutations.

This is the propose→ack→commit protocol of :mod:`.coordination` reduced
to an explicit-state machine the analysis layer can exhaustively
enumerate (`analysis/protocol_check.py`): small worlds of 2–4 ranks,
with a coordinator crash injectable at EVERY transition, stalled
followers, duplicate acks (absorbed by state identity), and lost
proposal/commit races (the ledger's epoch-floor and idempotent-commit
rules are encoded as the write-time checks below, verbatim from
``CoordLedger.publish_proposal`` / ``publish_commit``).

The model is pinned to the implementation, not a parallel truth:

- decision identity IS :func:`~.coordination.decision_fingerprint` over
  a kind from :data:`~.coordination.DECISION_KINDS` — the same sha256
  the chaos floors compare across survivors;
- the re-propose survivor rule is the production line verbatim
  (``acks.get(r, -1) >= epoch or r == self.rank``) — the mutated model
  that drops the ``or r == self.rank`` clause reproduces the
  self-ack-held coordinator interleaving as a reachable violation;
- the commit rules mirror ``publish_commit``: idempotent no-op on a
  byte-identical re-commit, a protocol violation on a divergent
  decision at the same epoch, back-off on a lost race;
- ``tests/test_torch_protocol_check.py`` drives the REAL
  ``CoordLedger`` through model-derived traces and asserts the same
  accept/refuse outcomes.

What the model abstracts (honest limits): the filesystem (control-file
writes are atomic state updates — tears are `ctrlfile`'s CRC layer's
problem, proven separately), wall-clock deadlines (the ack deadline is
the nondeterministic enabling of the re-propose transition, gated on
every missing rank being faulted), and membership lag (the driver's
health view is exact; the lost-race write rules cover the stale-view
overlap).

Mutations (`mutation=` kwarg) re-introduce historical bug classes so
the checker can prove it would have caught them:

- ``"commit_without_all_acks"``: the driver may seal with acks missing;
- ``"drop_survivor_self"``: re-propose survivors lose the
  ``or r == self.rank`` clause (the self-ack-held interleaving);
- ``"diverge_commit"``: the commit writes a different fingerprint than
  the proposal (breaks byte-identical commit-vs-proposal);
- ``"fenced_apply"``: a fenced rank applies anyway.
"""

from __future__ import annotations

from .coordination import DECISION_KINDS, decision_fingerprint

__all__ = ["CoordModel", "COORD_MUTATIONS"]

COORD_MUTATIONS = (
    "commit_without_all_acks",
    "drop_survivor_self",
    "diverge_commit",
    "fenced_apply",
)

# rank status codes (status, acked, applied, ever_faulted) per rank
LIVE, STALLED, CRASHED, FENCED = 0, 1, 2, 3
_STATUS_NAMES = {LIVE: "live", STALLED: "stalled", CRASHED: "crashed",
                 FENCED: "fenced"}


class CoordModel:
    """State = (ranks, prop, commit, commits_log, props_log, budgets).

    ``ranks``: per-rank ``(status, acked_epoch, applied_epoch, faulted)``.
    ``prop``/``commit``: ``None`` or ``(epoch, fp, participants, owner)``
    — the two ledger slots.  ``commits_log``/``props_log``: every write
    ever made to each slot (the slots are overwritten; the invariants
    quantify over history).  ``budgets``: ``(decisions, reproposals,
    crashes, stalls)`` remaining — explicit bounds, reported as
    truncation rather than silently absorbed (see
    :meth:`quiescent_violations`).
    """

    name_prefix = "coordination"

    def __init__(self, n_ranks: int = 3, *, decisions: int = 1,
                 reproposals: int = 2, crashes: int | None = None,
                 stalls: int = 1, mutation: str | None = None):
        if mutation is not None and mutation not in COORD_MUTATIONS:
            raise ValueError(f"unknown coordination mutation: {mutation}")
        self.n = int(n_ranks)
        self.mutation = mutation
        if crashes is None:
            crashes = min(2, self.n - 1)
        self.budget0 = (decisions, reproposals, min(crashes, self.n - 1),
                        stalls)
        # decision identity comes from the production fingerprint over a
        # production kind — one fresh decision per budget slot
        self.kind = DECISION_KINDS[0]
        self.fps = tuple(
            decision_fingerprint(self.kind, {"seq": i})
            for i in range(decisions)
        )
        self.name = f"{self.name_prefix}@{self.n}ranks"
        if mutation:
            self.name += f"+{mutation}"

    # ---- state helpers -----------------------------------------------------

    def initial(self):
        ranks = tuple((LIVE, -1, -1, False) for _ in range(self.n))
        return (ranks, None, None, (), frozenset(), self.budget0)

    @staticmethod
    def _coordinator(ranks):
        """Lowest live non-stalled rank — ``is_coordinator``'s
        lowest-healthy rule (a stalled rank's beat is stale, so it is a
        straggler, not healthy).  None when nobody can drive."""
        for r, (st, _, _, _) in enumerate(ranks):
            if st == LIVE:
                return r
        return None

    @staticmethod
    def _slot_floor(prop, commit):
        return max(prop[0] if prop else -1, commit[0] if commit else -1)

    def is_fault_label(self, label: str) -> bool:
        return label.startswith(("crash", "stall", "resume"))

    # ---- transitions -------------------------------------------------------

    def transitions(self, state):
        """All enabled ``(label, next_state, violations)`` triples.
        Violations are write-time invariant breaches (only reachable in
        mutated models); the explorer attaches the witness path."""
        ranks, prop, commit, clog, plog, budgets = state
        decisions, reproposals, crashes, stalls = budgets
        out = []
        coord = self._coordinator(ranks)
        ce = commit[0] if commit else -1

        # -- propose: coordinator only, one decision at a time, applied
        #    floor respected (CoordinationHandle.propose verbatim)
        if (coord is not None and decisions > 0
                and not (prop is not None and prop[0] > ce)
                and ce <= ranks[coord][2]):
            epoch = 1 + self._slot_floor(prop, commit)
            fp = self.fps[len(self.fps) - decisions]
            participants = tuple(
                r for r, (st, _, _, _) in enumerate(ranks) if st != CRASHED
            )  # _alive_ranks: everything not dead, stragglers included
            newp = (epoch, fp, participants, coord)
            out.append((
                f"propose(r{coord},e{epoch})",
                (ranks, newp, commit, clog, plog | {newp},
                 (decisions - 1, reproposals, crashes, stalls)),
                [],
            ))

        # -- ack: any live participant with a newer proposal (the
        #    proposer's own immediate self-ack is this same transition —
        #    modelling it separately is what lets a crash land between
        #    publish and self-ack).  A duplicate ack rewrites the same
        #    file: the successor state is identical, so the explorer's
        #    memoization absorbs it — replayed acks cannot change the
        #    reachable set.
        if prop is not None and prop[0] > ce:
            epoch, fp, participants, owner = prop
            for r in participants:
                st, acked, applied, faulted = ranks[r]
                if st == LIVE and epoch > max(acked, applied):
                    nr = _set(ranks, r, (st, epoch, applied, faulted))
                    out.append((f"ack(r{r},e{epoch})",
                                (nr, prop, commit, clog, plog, budgets), []))

        # -- commit: the driver seals when every participant promised
        if prop is not None and prop[0] > ce and coord is not None:
            epoch, fp, participants, owner = prop
            acks_in = [r for r in participants if ranks[r][1] >= epoch]
            missing = [r for r in participants if ranks[r][1] < epoch]
            can_seal = not missing
            if (self.mutation == "commit_without_all_acks" and missing
                    and acks_in):
                can_seal = True  # the seeded corruption: seal on a quorum<all
            if can_seal:
                wfp = fp + "-x" if self.mutation == "diverge_commit" else fp
                t = self._commit_write(
                    state, coord, (epoch, wfp, participants, owner))
                if t is not None:  # None = lost race / idempotent no-op
                    out.append(t)

        # -- re-propose: deadline passed (abstracted: every missing rank
        #    is faulted — a live rank's ack is still in flight) →
        #    exclude the silent ranks, keep the decision content
        if (prop is not None and prop[0] > ce and coord is not None
                and reproposals > 0):
            epoch, fp, participants, owner = prop
            missing = [r for r in participants if ranks[r][1] < epoch]
            # deadline abstraction: the window closes once every missing
            # rank OTHER than the driver is faulted — the driver's own
            # ack may be absent at its own deadline (it inherited the
            # proposal, or crashed between publish and self-ack), which
            # is exactly the case the production survivor rule's
            # `or r == self.rank` clause exists for
            if missing and all(
                    ranks[r][0] != LIVE for r in missing if r != coord):
                # production survivor rule (coordination._drive):
                #   acks.get(r, -1) >= epoch or r == self.rank
                survivors = tuple(
                    r for r in participants
                    if ranks[r][1] >= epoch
                    or (r == coord and self.mutation != "drop_survivor_self")
                )
                viol = []
                if coord in participants and coord not in survivors:
                    viol.append((
                        "coordinator-self-excluded",
                        f"rank {coord} re-proposed epoch excluding ITSELF "
                        f"(its own ack for epoch {epoch} was still in "
                        "flight) — the driver's commit will fence the "
                        "driver (the self-ack-held interleaving)",
                    ))
                ne = 1 + self._slot_floor(prop, commit)
                newp = (ne, fp, survivors, coord)
                out.append((
                    f"repropose(r{coord},e{ne},excl={missing})",
                    (ranks, newp, commit, clog, plog | {newp},
                     (decisions, reproposals - 1, crashes, stalls)),
                    viol,
                ))

        # -- observe commit: deliver (apply) or fence
        if commit is not None:
            epoch, fp, participants, owner = commit
            for r in range(self.n):
                st, acked, applied, faulted = ranks[r]
                mutant = (st == FENCED and self.mutation == "fenced_apply"
                          and epoch > applied)
                if not mutant and (st != LIVE or epoch <= applied):
                    continue  # crashed/stalled/fenced ranks observe nothing
                if r not in participants and st != FENCED:
                    nr = _set(ranks, r, (FENCED, acked, applied, faulted))
                    viol = []
                    if not faulted:
                        viol.append((
                            "clean-rank-fenced",
                            f"rank {r} is live and never faulted yet the "
                            f"commit at epoch {epoch} excludes it — the "
                            "re-propose survivor rule dropped a healthy "
                            "driver (the self-ack-held interleaving)",
                        ))
                    out.append((f"fence(r{r},e{epoch})",
                                (nr, prop, commit, clog, plog, budgets),
                                viol))
                    continue
                viol = []
                if st == FENCED:
                    viol.append((
                        "fenced-apply",
                        f"fenced rank {r} applied epoch {epoch} — a fenced "
                        "rank must exit, never apply",
                    ))
                nr = _set(ranks, r, (st, acked, epoch, faulted))
                out.append((f"apply(r{r},e{epoch})",
                            (nr, prop, commit, clog, plog, budgets), viol))

        # -- fault injection: crash / stall / resume at every state —
        #    which is to say, between (before/after) every protocol
        #    transition above
        if crashes > 0:
            alive = [r for r, (st, _, _, _) in enumerate(ranks)
                     if st in (LIVE, STALLED)]
            if len(alive) >= 2:
                for r in alive:
                    st, acked, applied, _ = ranks[r]
                    nr = _set(ranks, r, (CRASHED, acked, applied, True))
                    out.append((f"crash(r{r})",
                                (nr, prop, commit, clog, plog,
                                 (decisions, reproposals, crashes - 1,
                                  stalls)), []))
        for r, (st, acked, applied, faulted) in enumerate(ranks):
            if st == LIVE and stalls > 0:
                nr = _set(ranks, r, (STALLED, acked, applied, True))
                out.append((f"stall(r{r})",
                            (nr, prop, commit, clog, plog,
                             (decisions, reproposals, crashes, stalls - 1)),
                            []))
            elif st == STALLED:
                nr = _set(ranks, r, (LIVE, acked, applied, True))
                out.append((f"resume(r{r})",
                            (nr, prop, commit, clog, plog, budgets), []))
        return out

    def _commit_write(self, state, driver, decision):
        """``CoordLedger.publish_commit``'s rules as one transition:
        idempotent no-op on identical re-commit, violation on divergence
        at the same epoch or a backwards epoch, plus the quorum and
        byte-identity invariants the checker exists to quantify."""
        ranks, prop, commit, clog, plog, budgets = state
        epoch, fp, participants, owner = decision
        viol = []
        if commit is not None:
            cepoch, cfp = commit[0], commit[1]
            if cepoch > epoch:
                # production backs off (coord_commit_race) — lost race,
                # no write, no state change: not a transition
                return None
            if cepoch == epoch:
                if cfp != fp:
                    viol.append((
                        "epoch-double-commit",
                        f"two decisions at epoch {epoch}: committed {cfp}, "
                        f"now {fp} — >1 commit per control epoch",
                    ))
                else:
                    return None  # idempotent failover no-op
        # invariant: the sealed decision must be byte-identical to a
        # published proposal at that epoch (fingerprint + participants)
        if (epoch, fp, participants, owner) not in plog:
            viol.append((
                "commit-proposal-divergence",
                f"commit at epoch {epoch} (fp {fp}) matches no published "
                "proposal — commit must be byte-identical to its proposal",
            ))
        # invariant: a seal requires every participant's promise
        missing = [r for r in participants if ranks[r][1] < epoch]
        if missing:
            viol.append((
                "commit-quorum",
                f"commit at epoch {epoch} sealed with no ack from ranks "
                f"{missing} — a participant can apply a plan it never "
                "promised a boundary for",
            ))
        if clog and epoch <= clog[-1][0] and not any(
                v[0] == "epoch-double-commit" for v in viol):
            viol.append((
                "epoch-regression",
                f"commit epoch {epoch} after {clog[-1][0]} — control epochs "
                "must strictly increase",
            ))
        ns = (ranks, prop, decision, clog + ((epoch, fp),), plog, budgets)
        return (f"commit(r{driver},e{epoch})", ns, viol)

    # ---- quiescence --------------------------------------------------------

    def quiescent_violations(self, state):
        """Checks on states with no outgoing transitions.  A quiescent
        state with an unresolved proposal and a live driver is a wedged
        handshake — unless only a budget bound stops progress, which is
        truncation (counted, not a violation): the bound is explicit."""
        ranks, prop, commit, clog, plog, budgets = state
        ce = commit[0] if commit else -1
        viols, truncated = [], False
        if prop is not None and prop[0] > ce:
            coord = self._coordinator(ranks)
            if coord is not None:
                epoch, fp, participants, owner = prop
                missing = [r for r in participants if ranks[r][1] < epoch]
                if missing and all(ranks[r][0] != LIVE for r in missing):
                    if budgets[1] == 0:
                        truncated = True  # re-propose only blocked by budget
                    else:
                        viols.append((
                            "wedged-handshake",
                            f"proposal epoch {epoch} unresolved at "
                            f"quiescence: missing acks {missing}, driver "
                            f"r{coord} live",
                        ))
                elif missing:
                    viols.append((
                        "wedged-handshake",
                        f"proposal epoch {epoch} unresolved at quiescence "
                        f"with live non-acking ranks {missing}",
                    ))
        # a sealed decision must reach every live participant
        if commit is not None:
            epoch, fp, participants, owner = commit
            lagging = [
                r for r in participants
                if ranks[r][0] == LIVE and ranks[r][2] < epoch
            ]
            if lagging:
                viols.append((
                    "unapplied-commit",
                    f"quiescent with live participants {lagging} never "
                    f"applying committed epoch {epoch}",
                ))
        return viols, truncated


def _set(ranks, r, row):
    return ranks[:r] + (row,) + ranks[r + 1:]
