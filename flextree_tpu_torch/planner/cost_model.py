"""Analytical cost model for topology-parameterized allreduce.

A copy of ``flextree_tpu/planner/cost_model.py`` (the port imports nothing
of the JAX package), with two differences: the default constants are the
ones fitted on an H100 (:data:`ICI_DEFAULT`, :class:`TpuCostParams`).
The class and field names stay the JAX package's, so
both packages read one calibration file format.  On a GPU, ``ici`` is the
intra-node link (device copies on the in-process mesh, NVLink across
cards) and ``dcn`` the network.

Retargets the reference's 3-term model (``cost_model/CostModel.h``:
latency+control, memory read/write, bandwidth+compute — constants calibrated
for an Ethernet MPI cluster):

- **latency/control**: each stage-``w`` group exchange is ``w-1`` hops,
  each paying the link latency; wide groups add control overhead — the
  analog of the reference's ``co*(width-9)`` wide-group penalty
  (``CostModel.h:7-10``).
- **bandwidth**: stage ``i`` moves ``(w_i-1)/w_i * S/g_i`` bytes per rank
  over that stage's link.  A telescoping identity makes the *sum* over
  stages equal ``(N-1)/N * S`` for every factorization — on a uniform
  fabric, bandwidth does not distinguish shapes (same conclusion as the
  reference's shape-independent ``bandwidth_calculation_overhead``,
  ``CostModel.h:22-30``); shapes win on latency and on per-link
  bandwidth differences (``ici`` vs ``dcn``).
- **reduce/memory**: phase-1 accumulation writes ``(w_i-1)/(g_i w_i) * S``
  bytes per stage at the fold's memory-bound throughput — the analog of
  ``memory_read_write_overhead`` (``CostModel.h:32-79``) without its
  per-height unrolled formulas (and without its uninitialized-``cost`` and
  ignored-``Chunk_size`` bugs, SURVEY §8).

All times in microseconds, sizes in bytes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..schedule.ir import swing_rho
from ..schedule.stages import Topology

__all__ = [
    "LinkParams",
    "TpuCostParams",
    "CostBreakdown",
    "allreduce_cost",
    "lonely_allreduce_cost",
    "ring_cost",
    "swing_cost",
    "generalized_cost",
    "reduce_scatter_cost",
    "all_gather_cost",
    "sharded_sync_cost",
]


@dataclass(frozen=True)
class LinkParams:
    """One communication domain (``ici``: the intra-node link; ``dcn``: the
    network)."""

    bandwidth_GBps: float  # per-chip injection bandwidth on this domain
    latency_us: float  # per neighbor-hop / per-message latency

    def time_us(self, nbytes: float) -> float:
        return nbytes / (self.bandwidth_GBps * 1e3)  # GB/s -> bytes/µs


#: The defaults are what ``fit_cost_params`` fitted on an in-process mesh
#: of 8 ranks on one NVIDIA H100 80GB HBM3 at a 700 W power limit, timing
#: the card's work (``python -m flextree_tpu_torch.tools.calibrate_host``
#: with its default matrix; ``chip_smoke.py`` phase 15 repeats the fit):
#: the link is the card's device copies.  The fit has one link, so ``dcn``
#: is ``ici``: no network was measured.
ICI_DEFAULT = LinkParams(bandwidth_GBps=176.08382310095362,
                         latency_us=9.086911458072194)
DCN_DEFAULT = ICI_DEFAULT


@dataclass(frozen=True)
class TpuCostParams:
    """Fabric + chip constants for the model."""

    ici: LinkParams = ICI_DEFAULT
    dcn: LinkParams = DCN_DEFAULT
    # memory-bound accumulate throughput for the local reduction (read w
    # copies, write one): the fold kernel's rate as the fit sees it
    reduce_bw_GBps: float = 352.1983604430778
    # extra control/software overhead per unit of group width beyond 2 —
    # wide groups put more messages in flight per step (the analog of
    # CostModel.h:7-10's width>9 penalty, smooth instead of a cliff); the
    # fit does not measure it and sets it to 0
    control_us_per_width: float = 0.0
    # fixed per-collective launch overhead (the host's dispatch of a stage)
    launch_us: float = 2.6289864287439917
    # wire-codec encode/decode throughput, a pass over the f32 bytes: the
    # int8 encode+decode of 16,781,824 f32 on one NVIDIA H100 80GB HBM3 at
    # a 700 W power limit, two passes in 2.2673 ms (``chip_smoke.py`` phase
    # 17(b), CUDA events, a cold L2; a later run read 2.2500 ms, 59.67
    # GB/s); the fit does not measure it
    codec_bw_GBps: float = 59.21
    # achievable dense-matmul throughput (GFLOP/s) for the backward-compute
    # estimate the overlap boundary equalizer uses
    # (planner.choose.choose_overlap_boundaries): comm can only hide under
    # compute, so the equalizer needs an absolute compute scale, not just
    # wire terms.  0.0 (the default) = resolve per backend at use time
    # (parallel/overlap.py: a CPU host is GFLOP/s-scale, an accelerator
    # TFLOP/s-scale); calibratable like every other constant.
    bwd_GFLOPs: float = 0.0
    # split-collective bandwidth scales ("Revisiting the Time Cost Model of
    # AllReduce", arXiv:2409.04202: the two halves of an allreduce do NOT
    # share one α-β term — the reduce-scatter's critical path carries the
    # fold arithmetic while the allgather is pure forwarding, so their
    # achieved bandwidths differ and a fused fit mis-ranks split
    # schedules).  Achieved-bandwidth multipliers on the link term: 1.0
    # (the default) reproduces the fused costing exactly; calibration can
    # set them per backend (CALIBRATION_SCHEMA 3 round-trips both; older
    # files load with the neutral defaults, non-silently).
    rs_bw_scale: float = 1.0
    ag_bw_scale: float = 1.0


@dataclass(frozen=True)
class CostBreakdown:
    """Predicted time (µs) for one allreduce, by term."""

    latency_us: float
    bandwidth_us: float
    reduce_us: float
    control_us: float
    # wire-codec term: per-hop encode/decode work (0 for identity/bf16 —
    # a dtype cast fuses into the surrounding elementwise work)
    codec_us: float = 0.0

    @property
    def total_us(self) -> float:
        return (
            self.latency_us
            + self.bandwidth_us
            + self.reduce_us
            + self.control_us
            + self.codec_us
        )


def _stage_links(topo: Topology, params: TpuCostParams, dcn_stages=()) -> list[LinkParams]:
    return [
        params.dcn if i in set(dcn_stages) else params.ici
        for i in range(topo.num_stages)
    ]


def _codec_props(codec) -> tuple[float, bool]:
    """(wire_ratio, pays_hop_cost) for ``codec`` (None, a name or a
    ``Codec``; ``ops/quantize.py``)."""
    if codec is None:
        return 1.0, False
    from ..ops.quantize import get_codec

    c = get_codec(codec)
    return c.wire_ratio, c.hop_cost


def allreduce_cost(
    topo: Topology,
    nbytes: int,
    params: TpuCostParams = TpuCostParams(),
    dcn_stages: tuple[int, ...] = (),
    codec=None,
) -> CostBreakdown:
    """Predicted wall time of one allreduce of ``nbytes``/chip with ``topo``.

    ``dcn_stages`` marks stages whose groups cross the DCN (multi-slice):
    on a 2-slice system with widths ``(16, 2)``, stage 1 rides DCN.

    ``codec`` (``ops/quantize.py``) scales the wire bytes by the codec's
    ratio and, for codecs with per-hop encode/decode work (int8
    block-scale), adds a codec term: each phase-1 stage encodes its full
    per-chip buffer and decodes the received tiles (~2 passes over
    ``nbytes/g`` at ``codec_bw_GBps``), phase 2 encodes the final tile
    once and decodes the gathered result (~``nbytes`` once).
    """
    ratio, hop_cost = _codec_props(codec)
    if topo.is_ring:
        return ring_cost(topo.num_nodes, nbytes, params, codec=codec)
    links = _stage_links(topo, params, dcn_stages)
    lat = bw = red = ctl = cod = 0.0
    for i, w in enumerate(topo.widths):
        g = topo.gaps[i]
        link = links[i]
        stage_bytes = (w - 1) / w * (nbytes / g)  # per chip, per phase
        hops = w - 1  # ring lowering on the stage's axis
        # two phases: reduce-scatter down, all-gather back up
        lat += 2 * (hops * link.latency_us + params.launch_us)
        bw += 2 * link.time_us(stage_bytes * ratio)
        red += stage_bytes / (params.reduce_bw_GBps * 1e3)  # phase 1 only
        ctl += 2 * params.control_us_per_width * max(0, w - 2)
        if hop_cost:
            # phase-1 per stage: encode nbytes/g, decode ~the same
            cod += 2 * (nbytes / g) / (params.codec_bw_GBps * 1e3)
    if hop_cost:
        # phase 2: one tile encode + one full-output decode
        cod += (nbytes / topo.num_nodes + nbytes) / (params.codec_bw_GBps * 1e3)
    return CostBreakdown(lat, bw, red, ctl, cod)


def lonely_allreduce_cost(
    tree_topo: Topology,
    lonely: int,
    nbytes: int,
    params: TpuCostParams = TpuCostParams(),
    dcn_stages: tuple[int, ...] = (),
    buddy_crosses_dcn: bool = False,
    codec=None,
) -> CostBreakdown:
    """Cost of a ``tree+lonely`` shape (``schedule.stages.LonelyTopology``).

    The tree allreduce over ``m = tree_topo.num_nodes`` ranks plus two
    buddy ``ppermute`` exchanges moving the FULL payload (lonely -> buddy
    fold, buddy -> lonely restore) and one extra fold at the buddy.  Buddy
    pairs span ``m`` ranks (lonely rank ``m+i`` pairs with rank ``i``), so
    on a multi-slice system the hop can cross the DCN boundary — pass
    ``buddy_crosses_dcn=True`` to price the two full-payload exchanges at
    DCN constants (the chooser does whenever ``dcn_axes`` is set; billing
    the dominant 2·S term at ICI would let lonely shapes win on an
    underestimate).  Implementation note: the runtime's lonely tree stages
    ride the ppermute-ring machinery rather than fused grouped collectives
    (``parallel/allreduce.py::lonely_allreduce``), which this model does
    not surcharge — the per-stage traffic is identical and the launch term
    already counts per stage.
    """
    base = allreduce_cost(tree_topo, nbytes, params, dcn_stages=dcn_stages, codec=codec)
    if lonely <= 0:
        return base
    ratio, hop_cost = _codec_props(codec)
    link = params.dcn if buddy_crosses_dcn else params.ici
    lat = base.latency_us + 2 * (link.latency_us + params.launch_us)
    bw = base.bandwidth_us + 2 * link.time_us(nbytes * ratio)
    red = base.reduce_us + nbytes / (params.reduce_bw_GBps * 1e3)
    cod = base.codec_us
    if hop_cost:
        # buddy fold + restore: two extra full-payload encode/decode pairs
        cod += 4 * nbytes / (params.codec_bw_GBps * 1e3)
    return CostBreakdown(lat, bw, red, base.control_us, cod)


def ring_cost(
    n: int,
    nbytes: int,
    params: TpuCostParams = TpuCostParams(),
    crosses_dcn: bool = False,
    codec=None,
) -> CostBreakdown:
    """Ring algorithm: 2(N-1) neighbor steps, each carrying ``S/N`` bytes
    (``mpi_mod.hpp:1113-1163``).  Bandwidth-optimal, latency-heaviest.

    ``crosses_dcn``: a ring spanning multiple slices has cross-DCN neighbor
    links, and every lock-step ring step is gated by its slowest link — so
    the whole ring prices at DCN constants.

    Launch overhead is paid **per step**: the walker
    (``parallel/allreduce.py``) dispatches each of the 2(N-1) steps on its
    own.  (Charging the ring only 2 launches would make flat-N and ring-N
    feature vectors identical and the fit degenerate.)"""
    if n <= 1:
        return CostBreakdown(0.0, 0.0, 0.0, 0.0)
    ratio, hop_cost = _codec_props(codec)
    link = params.dcn if crosses_dcn else params.ici
    steps = 2 * (n - 1)
    per_step_bytes = nbytes / n
    lat = steps * (link.latency_us + params.launch_us)
    bw = steps * link.time_us(per_step_bytes * ratio)
    red = (n - 1) / n * nbytes / (params.reduce_bw_GBps * 1e3)
    cod = 0.0
    if hop_cost:
        # (n-1) fold hops each encode+decode one block; phase 2 encodes the
        # owned block once and decodes the full assembled output
        cod = (2 * (n - 1) * per_step_bytes + per_step_bytes + nbytes) / (
            params.codec_bw_GBps * 1e3
        )
    return CostBreakdown(lat, bw, red, 0.0, cod)


# ---------------------------------------------------------------------------
# IR-family costs: swing short-cut rings, generalized allreduce
# ---------------------------------------------------------------------------


def swing_cost(
    n: int,
    nbytes: int,
    params: TpuCostParams = TpuCostParams(),
    crosses_dcn: bool = False,
    codec=None,
) -> CostBreakdown:
    """Swing short-cut ring (arXiv:2401.09356, ``schedule.ir.swing_ir``):
    ``log2(P)`` pairwise steps per phase over the largest power-of-two
    core ``P``, step ``s`` moving ``S / 2^(s+1)`` bytes to a peer at ring
    distance ``|rho_s|`` (1, 1, 3, 5, 11, ...).

    Bandwidth term per arXiv:2409.04202's treatment: an alpha-beta model
    that ignores WHERE the bytes go mis-ranks multi-hop algorithms, so
    each step's wire time is weighted by its link occupancy — a
    distance-``d`` permute on a ring fabric holds ``d`` links for the
    whole transfer, so the effective per-chip wire time scales by ``d``
    (min of the two ring directions).  This is what makes the model
    honest about swing vs the tree on a torus: swing's total weighted
    distance ``sum_s d_s / 2^(s+1)`` beats RHD's doubling distances but
    still pays more than a one-axis grouped collective; it wins where
    per-step latency dominates or the fabric is switch-like (calibration
    can flatten the distance penalty via link constants).

    Non-power-of-two ``n``: the ``n - P`` extras pay the lonely buddy
    protocol (two full-payload hops + one fold), same terms as
    :func:`lonely_allreduce_cost`.
    """
    if n <= 1:
        return CostBreakdown(0.0, 0.0, 0.0, 0.0)
    ratio, hop_cost = _codec_props(codec)
    link = params.dcn if crosses_dcn else params.ici
    core = 1 << (n.bit_length() - 1)
    extras = n - core
    k = core.bit_length() - 1
    lat = bw = red = cod = 0.0
    for s in range(k):
        # the canonical displacement sequence the emitter executes
        # (schedule.ir.swing_rho) — never a re-derived copy
        rho = abs(swing_rho(s))
        dist = min(rho % core, core - rho % core) or 1
        step_bytes = nbytes / (1 << (s + 1))
        # two phases (reduce-scatter down, all-gather back)
        lat += 2 * (dist * link.latency_us + params.launch_us)
        bw += 2 * dist * link.time_us(step_bytes * ratio)
        red += step_bytes / (params.reduce_bw_GBps * 1e3)  # phase-1 fold
        if hop_cost:
            cod += 2 * 2 * step_bytes / (params.codec_bw_GBps * 1e3)
    if extras:
        lat += 2 * (link.latency_us + params.launch_us)
        bw += 2 * link.time_us(nbytes * ratio)
        red += nbytes / (params.reduce_bw_GBps * 1e3)
        if hop_cost:
            cod += 4 * nbytes / (params.codec_bw_GBps * 1e3)
    return CostBreakdown(lat, bw, red, 0.0, cod)


def generalized_cost(
    widths: tuple[int, ...],
    ports: int,
    nbytes: int,
    params: TpuCostParams = TpuCostParams(),
    dcn_stages: tuple[int, ...] = (),
    codec=None,
) -> CostBreakdown:
    """The generalized construction (arXiv:2004.09362,
    ``schedule.ir.generalized_ir``): tree-shaped stages executed as
    ``ceil((w-1)/ports)`` pairwise rounds each.  Per stage the byte
    profile equals the tree's (``(w-1)/w * S/g`` per phase — the
    telescoping identity holds for any execution of the same block-map),
    so the family trades on LATENCY: each round pays a launch, and
    ``ports`` rounds-in-flight trade launch count against per-round
    control overhead.  ``widths=(N,), ports=N-1`` prices like the flat
    tree message pattern; ``widths=(2,..,2), ports=1`` like RHD over
    permutes."""
    topo = Topology(math.prod(widths), tuple(widths))
    ratio, hop_cost = _codec_props(codec)
    links = _stage_links(topo, params, dcn_stages)
    lat = bw = red = ctl = cod = 0.0
    for i, w in enumerate(topo.widths):
        g = topo.gaps[i]
        link = links[i]
        p = min(ports, w - 1)
        rounds = -(-(w - 1) // p)
        stage_bytes = (w - 1) / w * (nbytes / g)
        lat += 2 * (rounds * params.launch_us + (w - 1) * link.latency_us)
        bw += 2 * link.time_us(stage_bytes * ratio)
        red += stage_bytes / (params.reduce_bw_GBps * 1e3)
        ctl += 2 * rounds * params.control_us_per_width * max(0, p - 1)
        if hop_cost:
            cod += 2 * (nbytes / g) / (params.codec_bw_GBps * 1e3)
    if hop_cost:
        cod += (nbytes / topo.num_nodes + nbytes) / (params.codec_bw_GBps * 1e3)
    return CostBreakdown(lat, bw, red, ctl, cod)


# ---------------------------------------------------------------------------
# split-collective costs: the two phases priced separately
# ---------------------------------------------------------------------------


def _phase_cost(
    topo: Topology,
    nbytes: int,
    params: TpuCostParams,
    phase: str,  # "rs" | "ag"
    dcn_stages: tuple[int, ...] = (),
    codec=None,
) -> CostBreakdown:
    """One phase of the tree/ring schedule: ``reduce_scatter_us`` /
    ``all_gather_us`` as arXiv:2409.04202 argues they should be costed —
    per-phase achieved bandwidth (``rs_bw_scale``/``ag_bw_scale``), the
    fold arithmetic charged to phase 1 only, and the codec term split the
    way ``parallel/compressed.py`` actually spends it (per-stage re-encode
    on the accumulation path vs encode-once + forward + one decode)."""
    ratio, hop_cost = _codec_props(codec)
    scale = params.rs_bw_scale if phase == "rs" else params.ag_bw_scale
    cbw = params.codec_bw_GBps * 1e3
    if topo.is_ring:
        n = topo.num_nodes
        if n <= 1:
            return CostBreakdown(0.0, 0.0, 0.0, 0.0)
        link = params.dcn if dcn_stages else params.ici
        steps = n - 1
        per_step = nbytes / n
        lat = steps * (link.latency_us + params.launch_us)
        bw = steps * link.time_us(per_step * ratio) / max(scale, 1e-9)
        red = (n - 1) / n * nbytes / (params.reduce_bw_GBps * 1e3) if phase == "rs" else 0.0
        cod = 0.0
        if hop_cost:
            cod = (
                2 * steps * per_step / cbw
                if phase == "rs"
                else (per_step + nbytes) / cbw
            )
        return CostBreakdown(lat, bw, red, 0.0, cod)
    links = _stage_links(topo, params, dcn_stages)
    lat = bw = red = ctl = cod = 0.0
    for i, w in enumerate(topo.widths):
        g = topo.gaps[i]
        link = links[i]
        stage_bytes = (w - 1) / w * (nbytes / g)
        hops = w - 1
        lat += hops * link.latency_us + params.launch_us
        bw += link.time_us(stage_bytes * ratio) / max(scale, 1e-9)
        ctl += params.control_us_per_width * max(0, w - 2)
        if phase == "rs":
            red += stage_bytes / (params.reduce_bw_GBps * 1e3)
            if hop_cost:
                cod += 2 * (nbytes / g) / cbw
    if phase == "ag" and hop_cost:
        cod += (nbytes / topo.num_nodes + nbytes) / cbw
    return CostBreakdown(lat, bw, red, ctl, cod)


def reduce_scatter_cost(
    topo: Topology,
    nbytes: int,
    params: TpuCostParams = TpuCostParams(),
    dcn_stages: tuple[int, ...] = (),
    codec=None,
) -> CostBreakdown:
    """Predicted wall time of phase 1 alone (``reduce_scatter_us``):
    ``nbytes``/chip in, a 1/N owned shard out.  With the neutral
    per-phase scales, ``reduce_scatter_cost + all_gather_cost`` matches
    :func:`allreduce_cost` term for term."""
    return _phase_cost(topo, nbytes, params, "rs", dcn_stages, codec)


def all_gather_cost(
    topo: Topology,
    nbytes: int,
    params: TpuCostParams = TpuCostParams(),
    dcn_stages: tuple[int, ...] = (),
    codec=None,
) -> CostBreakdown:
    """Predicted wall time of phase 2 alone (``all_gather_us``): 1/N
    shards in, the full ``nbytes`` buffer out on every chip."""
    return _phase_cost(topo, nbytes, params, "ag", dcn_stages, codec)


def sharded_sync_cost(
    topo: Topology,
    nbytes: int,
    params: TpuCostParams = TpuCostParams(),
    dcn_stages: tuple[int, ...] = (),
    codec=None,
    secondary_topos: tuple = (),
) -> CostBreakdown:
    """One ZeRO-1 sharded sync round on the shard axis: quantized gradient
    reduce-scatter down + quantized parameter all-gather up (same byte
    profile per phase; the codec pays on BOTH wires), plus a shard-sized
    allreduce per secondary replication topology."""
    rs = _phase_cost(topo, nbytes, params, "rs", dcn_stages, codec)
    ag = _phase_cost(topo, nbytes, params, "ag", dcn_stages, codec)
    lat = rs.latency_us + ag.latency_us
    bw = rs.bandwidth_us + ag.bandwidth_us
    red = rs.reduce_us + ag.reduce_us
    ctl = rs.control_us + ag.control_us
    cod = rs.codec_us + ag.codec_us
    shard_bytes = nbytes / max(topo.num_nodes, 1)
    for t2 in secondary_topos:
        sec = allreduce_cost(t2, shard_bytes, params, codec=codec)
        lat += sec.latency_us
        bw += sec.bandwidth_us
        red += sec.reduce_us
        ctl += sec.control_us
        cod += sec.codec_us
    return CostBreakdown(lat, bw, red, ctl, cod)


def bus_bandwidth_GBps(n: int, nbytes: int, time_us: float) -> float:
    """Algorithmic (bus) bandwidth ``2(N-1)/N * S / t`` — the reporting
    metric of BASELINE.md."""
    if time_us <= 0 or n < 1:
        return 0.0
    return (2 * (n - 1) / n) * nbytes / (time_us * 1e3)
