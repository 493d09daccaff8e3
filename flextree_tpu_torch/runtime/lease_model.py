"""Extracted transition model of the lease ledger's revoke→ack→grant.

The port's copy of ``flextree_tpu/runtime/lease_model.py``: the same
states, transitions, violation kinds and mutations.

The two-phase chip handoff of :mod:`.leases` + :mod:`..arbiter.core`
reduced to an explicit-state machine for `analysis/protocol_check.py`:
an arbiter revokes chips from a tenant (parking them on the
:data:`~.leases.ARBITER` holder), waits for the SOURCE tenant's ack,
then grants the parked chips to the destination — in BOTH directions:
train→serve (the SLO-breach preempt) and serve→train (the burst-drained
return, a real handshake since serving became a lease tenant with its
own ack file).  A tenant restart is injectable mid-handoff at every
transition.

Pinned to the implementation:

- the three holders ARE :data:`~.leases.TRAIN` / :data:`~.leases.SERVE`
  / :data:`~.leases.ARBITER` (imported, not restated);
- the publish-time rules mirror ``LeaseLedger.publish``: epochs
  strictly increase, a chip in two holders is refused at the write —
  the ``"double_grant"`` mutation skips exactly that validation;
- the grant gate mirrors ``PoolArbiter._maybe_complete_handoff``: ONE
  ack read of the handoff's SOURCE holder serves both the epoch and
  the control stamp.  The ``"torn_ack_read"`` mutation re-introduces
  the older two-reads version (one ``read_ack`` returning the whole
  doc avoids it): the epoch is read from the newest ack version and
  the control stamp from the previous one, and the checker flags any
  consumed pair that no single ack version ever contained;
- serving's ack is DOUBLE-FENCED like ``ServeLeaseClient.ack``: the
  revocation ack may only be written after the replicas on the revoked
  chips have drained their in-flight requests.  The
  ``"serve_ack_before_drain"`` mutation removes that fence — serving
  acks while requests are still decoding on the revoked chips, the
  arbiter grants them to training, and the effective-exclusion
  invariant (``dual-holder-use``) becomes reachable;
- ``tests/test_torch_leases.py`` drives the REAL
  ``LeaseLedger`` (and ``ServeLeaseClient``) through model-derived
  traces (double-grant refused at the write, epoch floor enforced, the
  drain fence raising) to pin the shared rules.

Honest limits: control files are atomic state (CRC tears are proven at
the ctrlfile layer), the SLO reading that *triggers* a preempt is
abstracted into a budget (the protocol is what's being checked, not the
policy), and "in flight" is one bit per tenant, not a request count —
the drain fence's contract is zero-vs-nonzero, which one bit carries.

Mutations: ``"double_grant"`` (publish skips the one-holder-per-chip
validation), ``"grant_before_ack"`` (phase 2 fires without the source
tenant's ack — the revoked chips reach the destination while the source
still runs on them), ``"torn_ack_read"`` (see above),
``"serve_ack_before_drain"`` (serving's drain fence removed).
"""

from __future__ import annotations

from .leases import ARBITER, SERVE, TRAIN

__all__ = ["LeaseModel", "LEASE_MUTATIONS"]

LEASE_MUTATIONS = (
    "double_grant",
    "grant_before_ack",
    "torn_ack_read",
    "serve_ack_before_drain",
)

_CHIPS = ("c0", "c1")


class LeaseModel:
    """State = (epoch, grants, tenants, pending, acks, budgets).

    ``grants``: per-holder chip frozensets (the ledger document).
    ``tenants``: ``(t_use, t_seen)`` for TRAIN and ``(s_use, s_seen,
    s_busy)`` for SERVE — what each tenant actually runs on vs what it
    has observed, plus serving's in-flight bit (requests decoding on
    its chips).  ``pending``: in-flight handoff ``(chips, revoke_epoch,
    src_holder)`` or None — the destination is the other tenant.
    ``acks``: per-tenant ack-file version histories (newest last,
    bounded) of ``(epoch, control_stamp)`` pairs — history, because the
    torn-read class is precisely about pairing fields across versions.
    ``budgets``: ``(preempts, returns, restarts)`` remaining.
    """

    name_prefix = "lease"

    def __init__(self, *, preempts: int = 2, returns: int = 1,
                 restarts: int = 1, mutation: str | None = None):
        if mutation is not None and mutation not in LEASE_MUTATIONS:
            raise ValueError(f"unknown lease mutation: {mutation}")
        self.mutation = mutation
        self.budget0 = (preempts, returns, restarts)
        self.name = f"{self.name_prefix}@{len(_CHIPS)}chips"
        if mutation:
            self.name += f"+{mutation}"

    def initial(self):
        grants = ((TRAIN, frozenset(_CHIPS)), (SERVE, frozenset()),
                  (ARBITER, frozenset()))
        tenants = ((frozenset(_CHIPS), 0), (frozenset(), 0, False))
        acks = (((0, 0),), ((0, 0),))  # train history, serve history
        return (0, grants, tenants, None, acks, self.budget0)

    def is_fault_label(self, label: str) -> bool:
        return label.startswith("restart")

    # ---- transitions -------------------------------------------------------

    def transitions(self, state):
        epoch, grants, tenants, pending, acks, budgets = state
        preempts, returns, restarts = budgets
        g = dict(grants)
        (t_use, t_seen), (s_use, s_seen, s_busy) = tenants
        t_acks, s_acks = acks
        out = []

        # -- phase 1 forward: revoke (preempt) — park a nonempty subset
        #    of training's chips on the arbiter holder
        if pending is None and preempts > 0 and g[TRAIN]:
            for chips in _subsets(g[TRAIN]):
                ng = dict(g)
                ng[TRAIN] = g[TRAIN] - chips
                ng[ARBITER] = g[ARBITER] | chips
                t = self._publish(state, epoch + 1, ng,
                                  label=f"revoke({sorted(chips)},e{epoch+1})",
                                  pending=(chips, epoch + 1, TRAIN),
                                  budgets=(preempts - 1, returns, restarts))
                out.append(t)

        # -- phase 1 reverse: the burst drained — park ALL of serving's
        #    chips for the return handoff (``PoolArbiter._return`` in
        #    tenant mode); serving's replicas keep running until serving
        #    observes the revocation, drains, and acks
        if pending is None and returns > 0 and g[SERVE]:
            chips = g[SERVE]
            ng = dict(g)
            ng[SERVE] = frozenset()
            ng[ARBITER] = g[ARBITER] | chips
            t = self._publish(
                state, epoch + 1, ng,
                label=f"return({sorted(chips)},e{epoch+1})",
                pending=(chips, epoch + 1, SERVE),
                budgets=(preempts, returns - 1, restarts))
            out.append(t)

        # -- tenants observe a newer ledger — the lease clients' poll.
        #    Training adopts instantly (the step boundary is the only
        #    sync point it needs).  Serving with traffic in flight keeps
        #    USING its chips until the drain transition: observation is
        #    a read, drain is what actually stops the replicas.
        if t_seen < epoch:
            nt = ((g[TRAIN], epoch), (s_use, s_seen, s_busy))
            out.append((f"observe(train,e{epoch})",
                        (epoch, grants, nt, pending, acks, budgets), []))
        if s_seen < epoch:
            new_use = (s_use | g[SERVE]) if s_busy else g[SERVE]
            new_busy = s_busy or bool(g[SERVE])  # a grant brings traffic
            nt = ((t_use, t_seen), (new_use, epoch, new_busy))
            out.append((f"observe(serve,e{epoch})",
                        (epoch, grants, nt, pending, acks, budgets), []))

        # -- serving drains: every in-flight request on a revoked chip
        #    is answered/refused; replicas on revoked chips terminate,
        #    so use shrinks to the currently granted set
        if s_busy:
            nt = ((t_use, t_seen), (s_use & g[SERVE], s_seen, False))
            out.append(("drain(serve)",
                        (epoch, grants, nt, pending, acks, budgets), []))

        # -- training acks what it observed (the ack file carries the
        #    lease epoch + the control stamp of the group decision it
        #    applied the revocation under — ONE document)
        if t_seen > t_acks[-1][0]:
            stamp = t_seen  # the control stamp advances with each applied
            # revocation epoch; modelling it as the seen epoch keeps the
            # two fields distinct across versions without a second counter
            nacks = ((t_acks + ((t_seen, stamp),))[-3:], s_acks)
            out.append((f"ack(train,e{t_seen})",
                        (epoch, grants, tenants, pending, nacks, budgets),
                        []))

        # -- serving acks what it observed — DOUBLE-FENCED like
        #    ``ServeLeaseClient.ack``: the ack that releases revoked
        #    chips may only be written once no revoked chip is still in
        #    use (drain completed).  The mutation removes the fence.
        if s_seen > s_acks[-1][0]:
            drained = s_use <= g[SERVE]
            if drained or self.mutation == "serve_ack_before_drain":
                nacks = (t_acks, (s_acks + ((s_seen, s_seen),))[-3:])
                out.append((f"ack(serve,e{s_seen})",
                            (epoch, grants, tenants, pending, nacks,
                             budgets), []))

        # -- phase 2: grant — the arbiter hands parked chips to the
        #    destination once the SOURCE tenant's ack covers the revoke
        #    epoch (one gate, both directions)
        if pending is not None and g[ARBITER] >= pending[0]:
            chips, revoke_epoch, src = pending
            src_acks = t_acks if src == TRAIN else s_acks
            dst = SERVE if src == TRAIN else TRAIN
            viol = []
            if self.mutation == "torn_ack_read" and src == TRAIN and \
                    len(src_acks) >= 2:
                # the seeded two-reads bug: epoch from the newest ack
                # version, control stamp from the previous one
                consumed = (src_acks[-1][0], src_acks[-2][1])
                if consumed not in src_acks:
                    viol.append((
                        "torn-ack-read",
                        f"arbiter consumed ack pair {consumed} that no "
                        f"single ack version ever contained "
                        f"({list(src_acks)}) — epoch and control stamp "
                        "read from different versions",
                    ))
                acked = consumed[0]
            else:
                acked = src_acks[-1][0]
            if acked >= revoke_epoch or self.mutation == "grant_before_ack":
                ng = dict(g)
                ng[ARBITER] = g[ARBITER] - chips
                ng[dst] = g[dst] | chips
                t = self._publish(
                    state, epoch + 1, ng,
                    label=f"grant({sorted(chips)},e{epoch+1},to={dst})",
                    pending=None, budgets=budgets, extra_viol=viol)
                out.append(t)

        # -- fault injection: tenant restart at every transition — the
        #    restarted tenant re-reads the ledger (first observation
        #    adopts), its ack files survive on disk, and a restarted
        #    serving fleet comes up with NO in-flight requests (fresh
        #    processes) — which is why restart-mid-handoff is safe
        if restarts > 0:
            nb = (preempts, returns, restarts - 1)
            nt = ((g[TRAIN], epoch), (s_use, s_seen, s_busy))
            out.append(("restart(train)",
                        (epoch, grants, nt, pending, acks, nb), []))
            nt = ((t_use, t_seen), (g[SERVE], epoch, False))
            out.append(("restart(serve)",
                        (epoch, grants, nt, pending, acks, nb), []))
        return out

    def _publish(self, state, new_epoch, new_grants, *, label, pending,
                 budgets, tenants=None, extra_viol=None):
        """``LeaseLedger.publish``'s write-time rules: strictly
        increasing epoch, every chip in exactly one holder — skipped by
        the ``double_grant`` mutation, which is what makes the
        invariant's violation reachable."""
        epoch, grants, old_tenants, _, acks, _ = state
        viol = list(extra_viol or [])
        if new_epoch <= epoch:
            viol.append((
                "epoch-regression",
                f"lease epoch {new_epoch} published after {epoch}",
            ))
        if self.mutation == "double_grant" and pending is None and \
                new_grants[SERVE]:
            # the seeded corruption: the grant ALSO leaves the chips in
            # the training set (validation skipped)
            new_grants = dict(new_grants)
            new_grants[TRAIN] = new_grants[TRAIN] | new_grants[SERVE]
        seen: dict = {}
        for holder in (TRAIN, SERVE, ARBITER):
            for chip in new_grants[holder]:
                if chip in seen:
                    viol.append((
                        "double-grant",
                        f"chip {chip} granted to both {seen[chip]} and "
                        f"{holder} at epoch {new_epoch}",
                    ))
                seen[chip] = holder
        for chip in _CHIPS:
            if chip not in seen:
                viol.append((
                    "lost-chip",
                    f"chip {chip} granted to nobody at epoch {new_epoch}",
                ))
        ng = tuple((h, frozenset(new_grants[h]))
                   for h in (TRAIN, SERVE, ARBITER))
        return (label,
                (new_epoch, ng, tenants or old_tenants, pending, acks,
                 budgets),
                viol)

    # ---- reachable-state invariants ---------------------------------------

    def state_violations(self, state):
        """Checked at EVERY reachable state (not just writes): the
        effective-exclusion invariant — no chip in active use by two
        tenants — which the ack-before-grant handshake (and serving's
        drain-before-ack fence) exists to hold."""
        epoch, grants, tenants, pending, acks, budgets = state
        (t_use, _), (s_use, _, _) = tenants
        both = t_use & s_use
        if both:
            return [(
                "dual-holder-use",
                f"chips {sorted(both)} in active use by train AND serve "
                f"at lease epoch {epoch} — the grant outran the "
                "revocation ack (or the ack outran the drain)",
            )]
        return []

    def quiescent_violations(self, state):
        epoch, grants, tenants, pending, acks, budgets = state
        viols, truncated = [], False
        if pending is not None:
            # a handoff whose grant is enabled would not be quiescent;
            # pending at quiescence means the ack gate can never open
            viols.append((
                "wedged-handoff",
                f"handoff of {sorted(pending[0])} (revoke epoch "
                f"{pending[1]}, from {pending[2]}) never completed",
            ))
        return viols, truncated


def _subsets(chips):
    chips = sorted(chips)
    out = []
    for mask in range(1, 1 << len(chips)):
        out.append(frozenset(
            c for i, c in enumerate(chips) if mask & (1 << i)
        ))
    return out
