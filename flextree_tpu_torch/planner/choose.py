"""Topology chooser: enumerate candidate tree shapes, cost each, pick argmin.

A copy of ``flextree_tpu/planner/choose.py`` (the port imports nothing of
the JAX package): pure arithmetic over the cost model.

The rebuild of ``cost_model/ChooseWidth.h`` + ``CostModel.h:82-119``'s
main loop: enumerate ordered factorizations, evaluate the cost model,
return the cheapest shape (the reference prints it; we return a structured
plan whose ``widths`` drop straight into ``parallel.allreduce.allreduce(topo=...)``
or the ``FT_TOPO`` env var).

Prime/odd device counts: the reference's planner proposes shapes for N±1
(``ChooseWidth.h:16-21`` — the disabled "lonely node" idea), but its runtime
aborts unless the width product equals N (``mpi_mod.hpp:914-918``).  Ours
goes further: lonely shapes are EXECUTABLE (``"3,2+1"`` runs through
``parallel.allreduce.lonely_allreduce``), so for prime N every
factorization of N-1 plus one lonely rank joins the candidate table as a
real choice, alongside the flat tree and the ring; the N±1 *resize*
suggestions remain as advisory strings, matching the reference's printed
``+1``/``-1`` notation.

Torus-aware mode: given a mesh shape (e.g. ``(16, 16)``), only
factorizations whose widths tile the torus axes in order are physical —
each stage's groups then ride a single ICI axis.  ``choose_topology``
prefers those when a mesh shape is provided.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from ..schedule.ir import IRFamilySpec
from ..schedule.stages import LonelyTopology, Topology
from .cost_model import (
    CostBreakdown,
    TpuCostParams,
    all_gather_cost,
    allreduce_cost,
    generalized_cost,
    lonely_allreduce_cost,
    reduce_scatter_cost,
    sharded_sync_cost,
    swing_cost,
)
from .factorize import is_prime, ordered_factorizations

__all__ = [
    "Candidate",
    "Plan",
    "choose_topology",
    "candidate_topologies",
    "choose_bucket_bytes",
    "choose_overlap_boundaries",
    "predict_overlap_schedule",
    "overlap_comm_us",
    "WIRE_PESSIMISM_BAND",
    "replan_for_survivors",
]


@dataclass(frozen=True)
class Candidate:
    widths: tuple[int, ...]
    cost: CostBreakdown
    torus_aligned: bool = False
    lonely: int = 0  # ranks outside the tree (executable "+k" shapes)
    # IR families: "tree" covers every legacy shape (the ring
    # rides widths=(1,)); "swing"/"generalized" are schedule-IR families
    # executed through schedule.ir.compile_ir.  ``ports`` is the
    # generalized construction's per-round port count.
    family: str = "tree"
    ports: int = 0

    @property
    def total_us(self) -> float:
        return self.cost.total_us

    def shape_label(self) -> str:
        if self.family == "swing":
            return "swing"
        if self.family == "generalized":
            return f"gen:{','.join(map(str, self.widths))}@{self.ports}"
        label = "ring" if self.widths == (1,) else "*".join(map(str, self.widths))
        if self.lonely:
            label += f"+{self.lonely}"
        return label


@dataclass(frozen=True)
class Plan:
    """Chooser output: the winning topology plus the full ranked table."""

    num_nodes: int
    nbytes: int
    topology: Topology
    candidates: tuple[Candidate, ...]  # ranked, cheapest first
    advisory: tuple[str, ...] = ()  # e.g. prime-N resize suggestions

    @property
    def widths(self) -> tuple[int, ...]:
        return self.topology.widths

    def to_ft_topo(self) -> str:
        """The ``FT_TOPO`` env value selecting this plan (IR families
        return their own spec grammar: ``"swing"`` / ``"gen:4,2@2"``)."""
        if isinstance(self.topology, IRFamilySpec):
            return self.topology.spec
        spec = ",".join(map(str, self.topology.widths))
        if isinstance(self.topology, LonelyTopology):
            spec += f"+{self.topology.lonely}"
        return spec

    def summary(self) -> str:
        lines = [
            f"plan for N={self.num_nodes}, {self.nbytes} bytes: "
            f"topo {self.topology} ({self.candidates[0].total_us:.1f} µs predicted)"
        ]
        for c in self.candidates[:8]:
            mark = " torus" if c.torus_aligned else ""
            shape = c.shape_label()
            lines.append(
                f"  {shape:>12}: {c.total_us:9.1f} µs "
                f"(lat {c.cost.latency_us:.1f} + bw {c.cost.bandwidth_us:.1f} "
                f"+ red {c.cost.reduce_us:.1f} + ctl {c.cost.control_us:.1f}){mark}"
            )
        for a in self.advisory:
            lines.append(f"  advisory: {a}")
        return "\n".join(lines)


def _stage_axes(
    widths: tuple[int, ...], mesh_shape: tuple[int, ...]
) -> tuple[int, ...] | None:
    """Map each stage to the mesh axis its groups ride, or None if the
    widths don't tile ``mesh_shape`` axis by axis in order.

    Aligned means: each mesh axis is covered by a contiguous run of widths
    whose product equals the axis size (so every stage's groups span exactly
    one physical axis).  The per-stage axis indices are returned so DCN
    stages can be identified by the same traversal that decides alignment.
    """
    ai = 0
    acc = 1
    axes: list[int] = []
    for w in widths:
        if ai >= len(mesh_shape):
            return None
        axes.append(ai)
        acc *= w
        if acc == mesh_shape[ai]:
            ai += 1
            acc = 1
        elif mesh_shape[ai] % acc != 0:
            return None
    if ai == len(mesh_shape) and acc == 1:
        return tuple(axes)
    return None


def candidate_topologies(n: int) -> list[tuple[int, ...]]:
    """All usable stage-width vectors for ``n`` devices: every ordered
    factorization plus the ring sentinel ``(1,)`` (the reference appends
    flat/ring sentinels in ``GetWidth.h:214-219``)."""
    shapes: list[tuple[int, ...]] = list(ordered_factorizations(n))
    shapes.append((1,))
    return shapes


def choose_topology(
    n: int,
    nbytes: int,
    params: TpuCostParams | None = None,
    mesh_shape: tuple[int, ...] | None = None,
    dcn_axes: tuple[int, ...] = (),
    codec=None,
    collective: str = "allreduce",
    ir_families: tuple[str, ...] = (),
) -> Plan:
    """Pick the cheapest topology for ``n`` devices and ``nbytes``/chip.

    ``mesh_shape``: physical torus shape, e.g. ``(16, 16)`` for a v5e-256
    slice; when given, torus-aligned shapes get exact per-axis costing and
    non-aligned shapes are penalized implicitly (their stages still cost as
    single-axis rings, which is optimistic — alignment is reported so the
    caller can filter).  ``dcn_axes``: indices of mesh axes that are DCN
    (multi-slice outer axes).

    ``codec``: wire codec for the collective (``ops/quantize.py``); the
    argmin then trades shape against the codec's wire ratio and per-hop
    encode/decode cost.  ``None``/``"f32"`` reproduces the uncompressed
    costing exactly.  The codec x shape product is searched by
    ``planner.autotune.autotune_plan``, which measures the analytic
    shortlist instead of trusting it.

    ``collective`` selects what is being planned: ``"allreduce"`` (the
    default, historical behavior), ``"reduce_scatter"`` / ``"all_gather"``
    (one phase alone, per-phase bandwidth scales applied), or
    ``"sharded"`` — one ZeRO-1 sync round (quantized grad reduce-scatter
    + quantized param all-gather, ``cost_model.sharded_sync_cost``).
    Split collectives have no lonely candidates (lonely ranks own no
    block — the runtime falls back to the flat tree there too).

    ``ir_families``: opt-in schedule-IR families for the candidate table
    (``("swing", "generalized")``).  Only meaningful for the
    fused ``"allreduce"`` collective (the IR families have no split-phase
    or compressed lowering yet); the default keeps the historical
    candidate set byte-for-byte, and ``planner.autotune.autotune_plan``
    passes the full set so measurement, not the model, gets the final
    word on the wider space.  IR candidates never win a cost TIE against
    a legacy shape (the sort prefers proven grouped-collective lowerings
    at equal predicted time).
    """
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if collective not in ("allreduce", "reduce_scatter", "all_gather", "sharded"):
        raise ValueError(f"unknown collective {collective!r}")

    def cost_fn(topo, dcn_stages=()):
        if collective == "allreduce":
            return allreduce_cost(topo, nbytes, params, dcn_stages=dcn_stages, codec=codec)
        if collective == "reduce_scatter":
            return reduce_scatter_cost(topo, nbytes, params, dcn_stages=dcn_stages, codec=codec)
        if collective == "all_gather":
            return all_gather_cost(topo, nbytes, params, dcn_stages=dcn_stages, codec=codec)
        return sharded_sync_cost(topo, nbytes, params, dcn_stages=dcn_stages, codec=codec)
    if params is None:
        # measured constants from $FLEXTREE_CALIBRATION when present
        # (per-backend CALIBRATION.json, see planner/calibrate.py), else
        # the documented v5e-flavored defaults
        from .calibrate import default_params

        params = default_params()
    if dcn_axes and not mesh_shape:
        raise ValueError("dcn_axes requires mesh_shape (which axes are DCN?)")
    if mesh_shape:
        if math.prod(mesh_shape) != n:
            raise ValueError(
                f"mesh_shape {mesh_shape} has {math.prod(mesh_shape)} devices, "
                f"but n is {n}"
            )
        # drop degenerate size-1 axes, remapping dcn_axes indices to match
        keep = [i for i, s in enumerate(mesh_shape) if s > 1]
        dcn_axes = tuple(keep.index(a) for a in dcn_axes if a in keep)
        mesh_shape = tuple(mesh_shape[i] for i in keep) or None
    if n == 1:
        t = Topology.flat(1)
        return Plan(
            1, nbytes, t,
            (Candidate((1,), allreduce_cost(t, nbytes, params, codec=codec)),),
        )

    cands: list[Candidate] = []
    for widths in candidate_topologies(n):
        if widths == (1,):
            if collective == "allreduce":
                from .cost_model import ring_cost

                cost = ring_cost(
                    n, nbytes, params, crosses_dcn=bool(dcn_axes), codec=codec
                )
            else:
                cost = cost_fn(
                    Topology.ring(n), dcn_stages=(0,) if dcn_axes else ()
                )
            cands.append(Candidate((1,), cost, False))
            continue
        topo = Topology(n, widths)
        stage_axes = _stage_axes(widths, mesh_shape) if mesh_shape else None
        aligned = stage_axes is not None
        dcn_stages: tuple[int, ...] = ()
        if dcn_axes:
            if aligned:
                # stages whose mesh axis is DCN pay DCN constants
                dcn_stages = tuple(
                    i for i, a in enumerate(stage_axes) if a in set(dcn_axes)
                )
            else:
                # a shape that doesn't tile the torus axes has groups
                # straddling the DCN boundary: price every stage at DCN
                # (pessimistic) so misaligned shapes can't win on an
                # optimistic ICI-only estimate
                dcn_stages = tuple(range(len(widths)))
        cost = cost_fn(topo, dcn_stages=dcn_stages)
        cands.append(Candidate(widths, cost, aligned))

    if ir_families and collective == "allreduce" and n >= 2:
        if "swing" in ir_families:
            core = 1 << (n.bit_length() - 1)
            cands.append(
                Candidate(
                    (2,) * (core.bit_length() - 1),
                    swing_cost(
                        n, nbytes, params, crosses_dcn=bool(dcn_axes),
                        codec=codec,
                    ),
                    False,
                    family="swing",
                )
            )
        if "generalized" in ir_families:
            for widths in ordered_factorizations(n):
                # the construction's interesting ports corners: fully
                # serial rounds and fully parallel (tree-pattern) rounds
                for p in sorted({1, max(widths) - 1}):
                    if p < 1:
                        continue
                    dcn_gen = (
                        tuple(range(len(widths))) if dcn_axes else ()
                    )
                    cands.append(
                        Candidate(
                            widths,
                            generalized_cost(
                                widths, p, nbytes, params,
                                dcn_stages=dcn_gen, codec=codec,
                            ),
                            False,
                            family="generalized",
                            ports=p,
                        )
                    )

    advisory: tuple[str, ...] = ()
    if is_prime(n) and n > 3 and collective == "allreduce":
        # Prime N: the reference could only *advise* resizing to N±1
        # (ChooseWidth.h:16-21; its runtime aborts on product != N).  Our
        # runtime executes lonely shapes (schedule.stages.LonelyTopology),
        # so every factorization of N-1 plus one lonely rank enters the
        # candidate table for real.  Lonely candidates are priced
        # fabric-uniform (a +1 world doesn't tile a torus; the tree part's
        # stages still ride ICI, the buddy hop is rank-adjacent).
        for widths in ordered_factorizations(n - 1):
            tree = Topology(n - 1, widths)
            # like misaligned shapes: when a DCN boundary exists, a +1
            # world can't tile the torus, so price every tree stage at DCN
            # (pessimistic) rather than let an optimistic ICI-only estimate
            # win
            dcn_lonely = tuple(range(len(widths))) if dcn_axes else ()
            cost = lonely_allreduce_cost(
                tree, 1, nbytes, params, dcn_stages=dcn_lonely,
                buddy_crosses_dcn=bool(dcn_axes), codec=codec,
            )
            cands.append(Candidate(widths, cost, False, lonely=1))
        near = []
        from .shapes import format_shape

        for m, delta in ((n - 1, +1), (n + 1, -1)):
            alt = choose_topology(m, nbytes, params)
            near.append(
                f"N={n} is prime; resizing to {m} would allow "
                f"topo {format_shape(alt.widths, delta)}"
            )
        advisory = tuple(near)

    # prefer torus-aligned shapes at equal cost, then legacy grouped
    # lowerings over IR families, then in-tree over lonely, then fewer
    # stages
    cands.sort(
        key=lambda c: (
            c.total_us,
            not c.torus_aligned,
            c.family != "tree",
            c.lonely,
            len(c.widths),
        )
    )
    best = cands[0]
    if best.family == "swing":
        topo = IRFamilySpec("swing", n)
    elif best.family == "generalized":
        topo = IRFamilySpec("generalized", n, best.widths, best.ports)
    elif best.lonely:
        topo = LonelyTopology(n, Topology(n - best.lonely, best.widths), best.lonely)
    elif best.widths == (1,):
        topo = Topology.ring(n)
    else:
        topo = Topology(n, best.widths)

    return Plan(n, nbytes, topo, tuple(cands), advisory)


def choose_bucket_bytes(
    nbytes: int,
    topos,
    *,
    n_leaves: int | None = None,
    params: TpuCostParams | None = None,
    max_buckets: int = 64,
    codec=None,
    sharded: bool = False,
) -> int:
    """Cost-model-driven gradient-bucket size: the fused-sync bucket cap
    that minimizes predicted sync time for ``nbytes`` of gradients.

    With ``k`` buckets the sync pays the per-collective fixed overhead
    (launch + per-hop latency + control — every byte-independent term of
    :func:`allreduce_cost`) ``k`` times, while consecutive buckets give the
    compiler pipelining slack: bucket ``i``'s phase-2 allgather can overlap
    bucket ``i+1``'s phase-1 reduce-scatter, which at the model level turns
    the byte-proportional terms from ``B`` into ``B * (k+1) / (2k)`` (the
    classic α-β chunking tradeoff — arXiv:2409.04202's latency-vs-bandwidth
    decomposition; perfect overlap halves the exposed byte time as k grows).
    So

        T(k) = k * fixed + byte_terms(nbytes) * (k + 1) / (2 * k)

    is evaluated for ``k`` in 1..min(max_buckets, n_leaves) and the argmin's
    ``ceil(nbytes / k)`` is returned.  ``topos`` is one resolved
    ``Topology`` (or a sequence of them, one per replication axis the sync
    loops over — the fixed and byte terms then sum across axes).  ``params``
    defaults to the calibrated constants (``FLEXTREE_CALIBRATION``) like
    every other chooser entry point; on hosts where calibration measured a
    large launch overhead the argmin lands on few, large buckets, and on
    fabrics where bandwidth dominates it shrinks them toward the pipelined
    regime.  Interior optimum: ``dT/dk = 0`` at ``k* = sqrt(byte/(2*fixed))``.
    """
    if nbytes < 0:
        raise ValueError(f"nbytes must be >= 0, got {nbytes}")
    if params is None:
        from .calibrate import default_params

        params = default_params()
    topo_list = (
        [topos] if isinstance(topos, (Topology, LonelyTopology)) else list(topos)
    )
    if not topo_list:
        raise ValueError("choose_bucket_bytes needs at least one topology")
    if nbytes == 0:
        return 1

    def cost(t, nb):
        if isinstance(t, LonelyTopology):
            return lonely_allreduce_cost(t.tree, t.lonely, nb, params, codec=codec)
        return allreduce_cost(t, nb, params, codec=codec)

    def sharded_cost(nb):
        # the ZeRO split schedule per bucket: grad reduce-scatter + param
        # all-gather on the FIRST (shard) topology, shard-sized allreduce
        # on the rest — cost_model.sharded_sync_cost prices exactly the
        # collectives zero_sync_and_update issues
        first = topo_list[0]
        shard_topo = (
            Topology.flat(first.num_nodes)
            if isinstance(first, LonelyTopology)
            else first
        )
        return sharded_sync_cost(
            shard_topo, nb, params, codec=codec,
            secondary_topos=tuple(
                Topology.flat(t.num_nodes) if isinstance(t, LonelyTopology) else t
                for t in topo_list[1:]
            ),
        )

    fixed = byte_us = 0.0
    if sharded:
        fixed = sharded_cost(0).total_us
        full = sharded_cost(nbytes)
        byte_us = full.bandwidth_us + full.reduce_us + full.codec_us
    else:
        for t in topo_list:
            fixed += cost(t, 0).total_us
            full = cost(t, nbytes)
            # codec_us is byte-proportional (encode/decode passes), so a
            # compressed sync amortizes it across buckets exactly like
            # bandwidth — the argmin shifts toward fewer, larger buckets as
            # the wire gets cheaper relative to the fixed launch cost
            byte_us += full.bandwidth_us + full.reduce_us + full.codec_us
    k_max = max(1, min(max_buckets, n_leaves or max_buckets))
    best_k, best_t = 1, float("inf")
    for k in range(1, k_max + 1):
        t_k = k * fixed + byte_us * (k + 1) / (2 * k)
        if t_k < best_t:
            best_k, best_t = k, t_k
    return -(-nbytes // best_k)  # ceil


#: Wire pessimism band for the overlap boundary argmin: candidate
#: partitions are scored by the sum of predicted makespans with comm
#: scaled by each factor.  1x is the calibrated capability estimate; the
#: inflated points model in-step contention (collectives share memory
#: bandwidth and cores with the backward), which hurts late-firing plans
#: far more than early-firing ones.
WIRE_PESSIMISM_BAND = (1.0, 2.0, 4.0)


def overlap_comm_us(
    nbytes: int,
    topos,
    params: TpuCostParams | None = None,
    codec=None,
) -> float:
    """Predicted wall time (µs) of ONE fired overlap bucket of ``nbytes``:
    one allreduce sequence per replication-axis topology in ``topos``
    (launch + wire + reduce + codec terms, summed across axes) — the unit
    the boundary chooser's wire-serial schedule model is built from."""
    if params is None:
        from .calibrate import default_params

        params = default_params()
    topo_list = (
        [topos] if isinstance(topos, (Topology, LonelyTopology)) else list(topos)
    )
    total = 0.0
    for t in topo_list:
        if isinstance(t, LonelyTopology):
            total += lonely_allreduce_cost(
                t.tree, t.lonely, nbytes, params, codec=codec
            ).total_us
        else:
            total += allreduce_cost(t, nbytes, params, codec=codec).total_us
    return total


def predict_overlap_schedule(
    boundaries,
    seg_bytes,
    seg_compute_us,
    topos,
    params: TpuCostParams | None = None,
    codec=None,
) -> tuple[float, float]:
    """(total_us, exposed_us) of a readiness-ordered overlap schedule.

    Model: backward segments run in readiness order (segment ``i`` of
    ``seg_compute_us`` finishes at ``cum[i]``); a bucket — a group of
    consecutive segment indices in ``boundaries`` — is *issued* when its
    last segment's grads exist, and the wire is serial: a bucket's
    collective starts at ``max(issue_time, wire_free)`` and holds the wire
    for its :func:`overlap_comm_us`.  ``total`` is when the last collective
    drains; ``exposed = total - total_backward_compute`` is the sync time
    NOT hidden behind remaining backward compute — the quantity the
    train-step bench measures as the step-time delta over a sync-free
    step.  The last bucket always issues at backward end, so its comm is
    always exposed: overlap shrinks exposure, never to zero.
    """
    if params is None:
        from .calibrate import default_params

        params = default_params()
    cum = [0.0]
    for c in seg_compute_us:
        cum.append(cum[-1] + float(c))
    wire_free = 0.0
    for bucket in boundaries:
        nbytes = sum(seg_bytes[i] for i in bucket)
        issue = cum[bucket[-1] + 1]
        start = max(issue, wire_free)
        wire_free = start + overlap_comm_us(nbytes, topos, params, codec)
    total = max(cum[-1], wire_free)
    return total, total - cum[-1]


def choose_overlap_boundaries(
    seg_bytes,
    seg_compute_us,
    topos,
    *,
    params: TpuCostParams | None = None,
    codec=None,
    max_enum_segments: int = 12,
) -> tuple[tuple[int, ...], ...]:
    """Compute-equalized bucket boundaries for readiness-ordered overlap.

    ``seg_bytes[i]`` / ``seg_compute_us[i]`` describe backward segment
    ``i`` in READINESS order (loss head first, then layers last-to-first,
    then the embedding, whose grad completes only at backward end).  The
    returned boundaries partition ``range(len(seg_bytes))`` into
    consecutive groups; each group syncs as one fired bucket (one
    allreduce sequence per replication axis).

    This is NOT ``choose_bucket_bytes``'s sync-time argmin: a bucket here
    trades the launch amortization of growing against the *hiding budget*
    of closing early — a bucket that closes after segment ``j`` can hide
    its wire time under the backward compute of segments ``j+1..``, so the
    chooser equalizes each bucket's predicted comm against the remaining
    compute below it by minimizing the :func:`predict_overlap_schedule`
    makespan.  Robustness to wire-model error: the calibrated wire
    constants are a capability estimate, and IN-STEP comm is slower
    (collectives contend with the backward for memory bandwidth and
    cores) — an error that punishes asymmetrically, because an
    underestimated wire makes a late-firing plan queue its whole tail
    past backward end while an early-firing plan just hides less.  The
    argmin therefore scores each candidate partition by the SUM of its
    predicted makespans under a pessimism band (comm scaled by
    :data:`WIRE_PESSIMISM_BAND`), which biases near-ties toward earlier
    firing; ties break toward fewer buckets (launch amortization).  Up
    to ``max_enum_segments`` segments every contiguous partition is
    enumerated exactly (span comm costs memoized, so this is a few
    thousand table lookups); beyond that a greedy pass closes a bucket as
    soon as extending it would push its comm past the remaining-compute
    hiding budget.
    """
    if params is None:
        from .calibrate import default_params

        params = default_params()
    s = len(seg_bytes)
    if s == 0:
        return ()
    if len(seg_compute_us) != s:
        raise ValueError(
            f"seg_bytes has {s} segments, seg_compute_us {len(seg_compute_us)}"
        )
    if s == 1:
        return ((0,),)

    # memoize comm cost per contiguous span [i, j]
    span_us: dict[tuple[int, int], float] = {}
    for i in range(s):
        nbytes = 0
        for j in range(i, s):
            nbytes += seg_bytes[j]
            span_us[(i, j)] = overlap_comm_us(nbytes, topos, params, codec)

    cum = [0.0]
    for c in seg_compute_us:
        cum.append(cum[-1] + float(c))

    def simulate(bounds, scale: float = 1.0) -> tuple[float, float]:
        wire_free = 0.0
        for i, j in bounds:
            start = max(cum[j + 1], wire_free)
            wire_free = start + scale * span_us[(i, j)]
        total = max(cum[-1], wire_free)
        return total, total - cum[-1]

    if s <= max_enum_segments:
        best = None
        # a partition of s segments = a subset of the s-1 interior cuts
        for mask in range(1 << (s - 1)):
            bounds = []
            start = 0
            for cut in range(s - 1):
                if mask >> cut & 1:
                    bounds.append((start, cut))
                    start = cut + 1
            bounds.append((start, s - 1))
            score = sum(
                simulate(bounds, scale)[0] for scale in WIRE_PESSIMISM_BAND
            )
            key = (score, len(bounds))
            if best is None or key < best[0]:
                best = (key, bounds)
        bounds = best[1]
    else:
        # greedy fallback (> max_enum_segments): close a bucket as soon
        # as it has amortized its fixed launch cost — early firing is the
        # robust default (see the pessimism rationale above) and a bucket
        # only grows while launches still dominate its wire time.  Two
        # boundary conditions mirror the exhaustive path's limits: while
        # hiding budget remains (compute left below the close), fire
        # amortized buckets eagerly; once none remains (the unhideable
        # tail) stop splitting entirely — every further cut would add a
        # fully-exposed launch for nothing.
        fixed_us = overlap_comm_us(0, topos, params, codec)
        bounds = []
        start = 0
        for j in range(s - 1):
            remaining_after_next = cum[-1] - cum[j + 2]
            if (
                remaining_after_next > 0
                and span_us[(start, j)] >= 4.0 * fixed_us
            ):
                bounds.append((start, j))
                start = j + 1
        bounds.append((start, s - 1))
    return tuple(tuple(range(i, j + 1)) for i, j in bounds)


def replan_for_survivors(
    n_alive: int,
    nbytes: int,
    params: TpuCostParams | None = None,
    configured: int | None = None,
) -> Plan:
    """Degrade-to-survivors replanning: the cheapest *executable* topology
    for the ranks that actually joined (docs/FAILURE_MODEL.md §replanning).

    When a configured world never assembles (a host never joins before the
    bring-up deadline, ``parallel.launch.init_distributed_or_degrade``),
    the job can run on the survivors instead of aborting — but the planned
    topology no longer fits: widths must factor ``n_alive``, not the
    configured count.  This re-runs the chooser for ``n_alive``; awkward
    survivor counts get real shapes because the candidate table already
    includes the ring and, for prime counts, executable lonely ``+1``
    topologies (7 of 8 alive runs ``3,2+1`` rather than idling a rank).

    Survivor worlds are priced fabric-uniform (no ``mesh_shape``): losing
    arbitrary ranks breaks torus alignment, so axis-exact costing would be
    optimistic about shapes that no longer tile anything.

    ``configured``: the originally requested world size — recorded in the
    plan's advisory so artifacts show the degradation.
    """
    if n_alive < 1:
        raise ValueError(f"n_alive must be >= 1, got {n_alive}")
    if configured is not None and n_alive > configured:
        raise ValueError(
            f"n_alive {n_alive} exceeds the configured world {configured}"
        )
    plan = choose_topology(n_alive, nbytes, params=params)
    if configured is not None and n_alive < configured:
        note = (
            f"DEGRADED WORLD: {n_alive}/{configured} ranks alive; "
            f"replanned to topo {plan.to_ft_topo()}"
        )
        plan = dataclasses.replace(plan, advisory=(note,) + plan.advisory)
    return plan
