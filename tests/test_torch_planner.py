"""The port's planner (``flextree_tpu_torch.planner``) against the JAX
package's, on the same inputs and the same explicit constants (the two
packages' defaults differ: the port's are fitted on an H100, so every
comparison passes both packages one ``TpuCostParams``).  Held, exactly:
the ordered factorizations and their counts for n = 1..64; every cost
function on a matrix of shapes x sizes x two parameter sets;
``choose_topology`` (widths, lonely count, candidate order and totals,
advisories) for n = 2..64 at three sizes, with and without the IR
families, and on a (4, 4) mesh with a DCN axis; ``choose_bucket_bytes``;
and the CLI's printed lines."""

import dataclasses
import io
from contextlib import redirect_stdout

import pytest

from flextree_tpu.planner import __main__ as j_main
from flextree_tpu.planner import choose as j_choose
from flextree_tpu.planner import cost_model as j_cost
from flextree_tpu.planner import factorize as j_fact
from flextree_tpu.schedule.stages import LonelyTopology as JLonely
from flextree_tpu.schedule.stages import Topology as JTopology
from flextree_tpu_torch.planner import __main__ as p_main
from flextree_tpu_torch.planner import choose, cost_model, factorize
from flextree_tpu_torch.planner.shapes import format_shape, parse_shape
from flextree_tpu_torch.schedule.stages import LonelyTopology, Topology

# the JAX package's defaults, and a second set, as explicit test inputs
CONSTANTS = (
    dict(ici=(45.0, 1.0), dcn=(6.0, 25.0), reduce_bw_GBps=400.0,
         control_us_per_width=0.05, launch_us=2.0, codec_bw_GBps=200.0),
    dict(ici=(176.0, 9.1), dcn=(12.5, 40.0), reduce_bw_GBps=352.2,
         control_us_per_width=0.3, launch_us=2.6, codec_bw_GBps=350.0,
         rs_bw_scale=0.8, ag_bw_scale=1.2),
)
SIZES = (1 << 12, 1 << 20, 256 << 20)
SHAPES = ((8, (8,)), (8, (4, 2)), (8, (2, 2, 2)), (12, (3, 4)), (16, (4, 4)),
          (16, (2, 8)), (6, (3, 2)), (8, (1,)))


def params(mod, c):
    link = mod.LinkParams
    kw = {k: v for k, v in c.items() if k not in ("ici", "dcn")}
    return mod.TpuCostParams(ici=link(*c["ici"]), dcn=link(*c["dcn"]), **kw)


def both(c):
    return params(cost_model, c), params(j_cost, c)


def fields(cost):
    return dataclasses.astuple(cost) + (cost.total_us,)


@pytest.mark.parametrize("n", range(1, 65))
def test_factorizations_equal_jax(n):
    assert factorize.ordered_factorizations(n) == \
        j_fact.ordered_factorizations(n)
    assert factorize.count_ordered_factorizations(n) == \
        j_fact.count_ordered_factorizations(n)
    assert sorted(factorize.ordered_factorizations_combinatoric(n)) == \
        sorted(j_fact.ordered_factorizations_combinatoric(n))
    assert factorize.prime_factors(n) == j_fact.prime_factors(n)
    assert factorize.is_prime(n) == j_fact.is_prime(n)


@pytest.mark.parametrize("c", CONSTANTS, ids=("jax-defaults", "other"))
@pytest.mark.parametrize("nbytes", SIZES)
def test_every_cost_equals_jax(c, nbytes):
    ours, theirs = both(c)
    for n, widths in SHAPES:
        t, jt = Topology(n, widths), JTopology(n, widths)
        for dcn in ((), (0,)):
            if widths == (1,):
                continue
            assert fields(cost_model.allreduce_cost(t, nbytes, ours, dcn)) == \
                fields(j_cost.allreduce_cost(jt, nbytes, theirs, dcn))
            for phase in ("reduce_scatter_cost", "all_gather_cost",
                          "sharded_sync_cost"):
                assert fields(getattr(cost_model, phase)(t, nbytes, ours,
                                                         dcn)) == \
                    fields(getattr(j_cost, phase)(jt, nbytes, theirs, dcn))
            for ports in sorted({1, max(widths) - 1}):
                assert fields(cost_model.generalized_cost(
                    widths, ports, nbytes, ours, dcn)) == fields(
                    j_cost.generalized_cost(widths, ports, nbytes, theirs,
                                            dcn))
        for lonely in (1, 2):
            for cross in (False, True):
                assert fields(cost_model.lonely_allreduce_cost(
                    t, lonely, nbytes, ours, buddy_crosses_dcn=cross)) == \
                    fields(j_cost.lonely_allreduce_cost(
                        jt, lonely, nbytes, theirs, buddy_crosses_dcn=cross))
    for n in (2, 3, 6, 7, 8, 12, 16, 31):
        for cross in (False, True):
            assert fields(cost_model.ring_cost(n, nbytes, ours, cross)) == \
                fields(j_cost.ring_cost(n, nbytes, theirs, cross))
            assert fields(cost_model.swing_cost(n, nbytes, ours, cross)) == \
                fields(j_cost.swing_cost(n, nbytes, theirs, cross))
    t, jt = Topology(8, (4, 2)), JTopology(8, (4, 2))
    for codec in (None, "f32", "bf16", "int8"):
        assert fields(cost_model.allreduce_cost(t, nbytes, ours,
                                                codec=codec)) == \
            fields(j_cost.allreduce_cost(jt, nbytes, theirs, codec=codec))
    assert cost_model.bus_bandwidth_GBps(8, nbytes, 123.0) == \
        j_cost.bus_bandwidth_GBps(8, nbytes, 123.0)


def test_a_lossy_codec_names_its_roadmap_item():
    """The codec term is ported: every cost function prices ``bf16`` and
    ``int8`` as the JAX one does, field for field, for equal params; an
    unknown codec raises."""
    jp = j_cost.TpuCostParams()
    tp = cost_model.TpuCostParams(
        ici=cost_model.LinkParams(**dataclasses.asdict(jp.ici)),
        dcn=cost_model.LinkParams(**dataclasses.asdict(jp.dcn)),
        **{k: v for k, v in dataclasses.asdict(jp).items()
           if k not in ("ici", "dcn")})
    nbytes = 1 << 22
    for codec in ("bf16", "int8"):
        for t, jt in ((Topology(8, w), JTopology(8, w))
                      for w in ((8,), (4, 2), (2, 2, 2))):
            for name in ("allreduce_cost", "reduce_scatter_cost",
                         "all_gather_cost", "sharded_sync_cost"):
                assert fields(getattr(cost_model, name)(
                    t, nbytes, tp, codec=codec)) == fields(getattr(
                        j_cost, name)(jt, nbytes, jp, codec=codec)), name
        assert fields(cost_model.ring_cost(8, nbytes, tp, codec=codec)) == \
            fields(j_cost.ring_cost(8, nbytes, jp, codec=codec))
        assert fields(cost_model.lonely_allreduce_cost(
            Topology(6, (3, 2)), 1, nbytes, tp, codec=codec)) == \
            fields(j_cost.lonely_allreduce_cost(
                JTopology(6, (3, 2)), 1, nbytes, jp, codec=codec))
        assert fields(cost_model.sharded_sync_cost(
            Topology(4, (4,)), nbytes, tp, codec=codec,
            secondary_topos=(Topology(2, (2,)),))) == \
            fields(j_cost.sharded_sync_cost(
                JTopology(4, (4,)), nbytes, jp, codec=codec,
                secondary_topos=(JTopology(2, (2,)),)))
    with pytest.raises(ValueError, match="unsupported codec"):
        cost_model.allreduce_cost(Topology(8, (4, 2)), 1 << 20, codec="fp4")


def plan_view(plan):
    topo = plan.topology
    return (str(topo), plan.to_ft_topo(), plan.widths,
            getattr(topo, "lonely", 0), plan.advisory, plan.summary(),
            [(c.shape_label(), c.family, c.ports, c.lonely, c.torus_aligned,
              fields(c.cost)) for c in plan.candidates])


@pytest.mark.parametrize("n", range(2, 65))
def test_choose_topology_equals_jax(n):
    ours, theirs = both(CONSTANTS[n % 2])
    for nbytes in SIZES:
        for fams in ((), ("swing", "generalized")):
            assert plan_view(choose.choose_topology(
                n, nbytes, ours, ir_families=fams)) == plan_view(
                j_choose.choose_topology(n, nbytes, theirs,
                                         ir_families=fams))


@pytest.mark.parametrize("collective", ("allreduce", "reduce_scatter",
                                        "all_gather", "sharded"))
def test_choose_on_a_mesh_with_a_dcn_axis_equals_jax(collective):
    for c in CONSTANTS:
        ours, theirs = both(c)
        for nbytes in SIZES:
            assert plan_view(choose.choose_topology(
                16, nbytes, ours, mesh_shape=(4, 4), dcn_axes=(0,),
                collective=collective, ir_families=("swing", "generalized"))
            ) == plan_view(j_choose.choose_topology(
                16, nbytes, theirs, mesh_shape=(4, 4), dcn_axes=(0,),
                collective=collective, ir_families=("swing", "generalized")))


def test_bucket_bytes_and_replanning_equal_jax():
    for c in CONSTANTS:
        ours, theirs = both(c)
        for nbytes in (0,) + SIZES:
            for topos, jtopos in (
                    (Topology(8, (4, 2)), JTopology(8, (4, 2))),
                    ((Topology(8, (8,)), LonelyTopology(
                        7, Topology(6, (3, 2)), 1)),
                     (JTopology(8, (8,)), JLonely(
                         7, JTopology(6, (3, 2)), 1)))):
                for kw in ({}, {"n_leaves": 5}, {"sharded": True},
                           {"max_buckets": 3, "codec": "f32"}):
                    assert choose.choose_bucket_bytes(
                        nbytes, topos, params=ours, **kw) == \
                        j_choose.choose_bucket_bytes(
                            nbytes, jtopos, params=theirs, **kw)
        for alive in (5, 7, 8):
            assert plan_view(choose.replan_for_survivors(
                alive, 1 << 20, ours, configured=8)) == plan_view(
                j_choose.replan_for_survivors(alive, 1 << 20, theirs,
                                              configured=8))
        segs, compute = [1 << 20, 4 << 20, 2 << 20, 8 << 20], [50, 80, 20, 10]
        topos, jtopos = Topology(8, (4, 2)), JTopology(8, (4, 2))
        bounds = choose.choose_overlap_boundaries(segs, compute, topos,
                                                  params=ours)
        assert bounds == j_choose.choose_overlap_boundaries(
            segs, compute, jtopos, params=theirs)
        assert choose.predict_overlap_schedule(
            bounds, segs, compute, topos, ours) == \
            j_choose.predict_overlap_schedule(bounds, segs, compute, jtopos,
                                              theirs)


def test_shapes_round_trip():
    for widths, delta in (((2, 3), 1), ((1,), 0), ((2, 2, 2), -1)):
        assert parse_shape(format_shape(widths, delta)) == (widths, delta)


def cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def test_cli_prints_the_jax_lines(monkeypatch):
    """The CLI's defaults are the port's; with the JAX defaults passed in
    (through the class the CLI builds its constants with), the lines are
    JAX's."""
    jax_defaults = {f.name: getattr(j_cost.TpuCostParams(), f.name)
                    for f in dataclasses.fields(j_cost.TpuCostParams)}
    jax_defaults["dcn"] = cost_model.LinkParams(*dataclasses.astuple(
        jax_defaults["dcn"]))

    def with_jax_defaults(**kw):
        return cost_model.TpuCostParams(**{**jax_defaults, **kw})

    monkeypatch.setattr(p_main, "TpuCostParams", with_jax_defaults)
    argv = ["--n", "16", "--size-mb", "256", "--ici-gbps", "45",
            "--ici-latency-us", "1"]
    assert cli(p_main.main, argv) == cli(j_main.main, argv)
    for extra in (["--mesh-shape", "4,4", "--dcn-axes", "0"], ["--n", "13"]):
        assert cli(p_main.main, argv + extra) == cli(j_main.main,
                                                     argv + extra)
    sweep = ["--sweep", "12", "--size-mb", "64"]
    strip = [ln.rsplit(",", 1)[0] for ln in cli(p_main.main, sweep)]
    assert strip == [ln.rsplit(",", 1)[0] for ln in cli(j_main.main, sweep)]


def test_cli_ranks_the_ir_families_and_refuses_native():
    lines = cli(p_main.main, ["--n", "8", "--size-mb", "67.1",
                              "--ir-families"])
    assert lines[-1].startswith("FT_TOPO=")
    assert any("gen:" in ln or "swing" in ln for ln in lines)
    with pytest.raises(NotImplementedError, match="native"):
        p_main.main(["--n", "8", "--native"])
