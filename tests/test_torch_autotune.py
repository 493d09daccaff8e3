"""The port's measured plan autotuner against the JAX package's
(``planner/autotune.py``), and its train-step knob.

With the JAX package's cost constants handed to both, the analytic
shortlists are equal row for row, and one fake timer gives both packages
the same winner and the same cache entry under the same key, apart from
the measuring backend's fingerprint.  The JAX ``tests/test_autotune.py``
cases (a hit, a miss, a foreign fingerprint, the knob a no-op) and the
no-alias guards (``tests/test_sharded.py``, ``tests/test_overlap.py``) run
on the port; the default timer runs on the CPU at a tiny size.
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from flextree_tpu.planner import autotune as jat
from flextree_tpu.planner.cost_model import TpuCostParams as JParams
from flextree_tpu.schedule.ir import IRFamilySpec as JIR
from flextree_tpu_torch.planner import autotune as tat
from flextree_tpu_torch.planner.cost_model import LinkParams as TLink
from flextree_tpu_torch.planner.cost_model import TpuCostParams as TParams
from flextree_tpu_torch.schedule.ir import IRFamilySpec as TIR
from flextree_tpu_torch.schedule.ir import resolve_collective

JP = JParams()
# the JAX package's default constants in the port's type
TP = TParams(**{f.name: getattr(JP, f.name) for f in dataclasses.fields(JP)
                if f.name not in ("ici", "dcn")},
             ici=TLink(JP.ici.bandwidth_GBps, JP.ici.latency_us),
             dcn=TLink(JP.dcn.bandwidth_GBps, JP.dcn.latency_us))

SETTINGS = [  # (n, nbytes, codecs, sharded, top_k)
    (8, 1 << 20, ("f32", "bf16", "int8"), False, 6),
    (8, 67_127_296, ("f32",), False, 4),
    (8, 67_127_296, ("f32",), True, 3),
    (6, 1 << 16, ("f32", "int8"), False, 8),
    (7, 4 << 20, ("int8",), True, 4),
    (5, 1 << 12, ("f32", "bf16"), False, 5),
    (4, 1 << 20, ("bf16",), True, 2),
]


def _row(r):
    shape = r[0]
    if isinstance(shape, (JIR, TIR)):
        shape = shape.spec
    return (shape, r[1], r[2], r[3])


def make_fake_timer(log, fastest_index=-1):
    """The JAX tests' injected timer: records the calls, makes the
    candidate at ``fastest_index`` the measured winner."""

    def timer(cands, n, nbytes, dtype, repeat):
        log.append([tuple(c[:3]) for c in cands])
        base = [0.010 + 0.001 * i for i in range(len(cands))]
        base[fastest_index] = 0.001
        return base

    return timer


@pytest.mark.parametrize("n,nbytes,codecs,sharded,top_k", SETTINGS)
def test_shortlist_matches_jax(n, nbytes, codecs, sharded, top_k):
    want = jat.analytic_shortlist(n, nbytes, codecs, params=JP, top_k=top_k,
                                  sharded=sharded)
    got = tat.analytic_shortlist(n, nbytes, codecs, params=TP, top_k=top_k,
                                 sharded=sharded)
    assert [_row(r) for r in got] == [_row(r) for r in want]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("n,nbytes,codecs,sharded,top_k", SETTINGS[:5])
def test_fake_timer_gives_jax_winner_and_entry(n, nbytes, codecs, sharded,
                                               top_k, overlap, tmp_path):
    import jax

    jax.devices()  # the JAX fingerprint names an initialized backend
    paths = {k: tmp_path / f"{k}.json" for k in ("jax", "port")}
    kw = dict(codecs=codecs, top_k=top_k, sharded=sharded, overlap=overlap)
    j = jat.autotune_plan(n, nbytes, params=JP, cache_path=paths["jax"],
                          timer=make_fake_timer([], fastest_index=1), **kw)
    t = tat.autotune_plan(n, nbytes, params=TP, cache_path=paths["port"],
                          timer=make_fake_timer([], fastest_index=1),
                          device="cpu", **kw)
    assert (t.widths, t.lonely, t.codec, t.family, t.ports) == \
        (j.widths, j.lonely, j.codec, j.family, j.ports)
    assert (t.predicted_us, t.measured_us, t.table, t.to_ft_topo()) == \
        (j.predicted_us, j.measured_us, j.table, j.to_ft_topo())
    (jkey, jentry), = json.loads(paths["jax"].read_text())["entries"].items()
    (tkey, tentry), = json.loads(paths["port"].read_text())["entries"].items()
    jfp, tfp = jentry.pop("fingerprint"), tentry.pop("fingerprint")
    assert tfp.startswith("cpu|") and tfp != jfp
    assert tkey[len(tfp):] == jkey[len(jfp):]
    assert tentry == jentry


def test_first_run_measures_second_is_cache_hit(tmp_path):
    path = str(tmp_path / "plans.json")
    log = []
    t1 = tat.autotune_plan(8, 1 << 20, timer=make_fake_timer(log),
                           cache_path=path, top_k=3, device="cpu")
    assert t1.source == "measured" and len(log) == 1 and len(log[0]) == 3
    # the analytic argmin is in the shortlist: the winner is never slower
    assert t1.measured_us <= t1.table[0][4]
    t2 = tat.autotune_plan(8, 1 << 20, timer=make_fake_timer(log),
                           cache_path=path, top_k=3, device="cpu")
    assert t2.source == "cache" and len(log) == 1
    assert (t2.widths, t2.lonely, t2.codec, t2.measured_us) == \
        (t1.widths, t1.lonely, t1.codec, t1.measured_us)


def test_cache_key_separates_contexts(tmp_path):
    path = str(tmp_path / "plans.json")
    log = []

    def tune(**kw):
        return tat.autotune_plan(8, kw.pop("nbytes", 1 << 20),
                                 timer=make_fake_timer(log), cache_path=path,
                                 device="cpu", **kw)

    tune()
    tune(nbytes=1 << 18)
    tune(dtype="bfloat16")
    tune(codecs=("f32",))
    tune(sharded=True)
    tune(overlap=True)
    assert len(log) == 6  # each context keys separately
    assert tune().source == tune(sharded=True).source == \
        tune(overlap=True).source == "cache"
    assert len(log) == 6


def test_fingerprint_mismatch_is_a_miss(tmp_path):
    path = str(tmp_path / "plans.json")
    log = []
    tat.autotune_plan(8, 1 << 20, timer=make_fake_timer(log),
                      cache_path=path, device="cpu")
    with open(path) as f:
        doc = json.load(f)
    for entry in doc["entries"].values():
        entry["fingerprint"] = "cuda|another card|n8|mesh|r8|torch0"
    with open(path, "w") as f:
        json.dump(doc, f)
    tat.autotune_plan(8, 1 << 20, timer=make_fake_timer(log),
                      cache_path=path, device="cpu")
    assert len(log) == 2  # measured again, not replayed


def test_default_path_and_env(tmp_path, monkeypatch):
    assert tat.DEFAULT_CACHE_PATH != jat.DEFAULT_CACHE_PATH
    assert tat.DEFAULT_CACHE_PATH.endswith(
        "flextree_tpu_torch/plan_cache.json")
    path = tmp_path / "env.json"
    monkeypatch.setenv("FLEXTREE_PLAN_CACHE", str(path))
    tat.autotune_plan(4, 1 << 16, timer=make_fake_timer([]), device="cpu")
    assert json.loads(path.read_text())["schema"] == tat.PLAN_CACHE_SCHEMA
    assert tat.invalidate_plan_cache(lambda k, e: True) == 1
    assert json.loads(path.read_text())["entries"] == {}
    assert tat.invalidate_plan_cache(lambda k, e: True) == 0


@pytest.mark.parametrize("fastest", [0, 1, 2, 3])
def test_winner_is_executable(fastest, tmp_path):
    t = tat.autotune_plan(8, 1 << 20,
                          timer=make_fake_timer([], fastest_index=fastest),
                          cache_path=str(tmp_path / "p.json"), device="cpu")
    assert resolve_collective(8, t.to_ft_topo()) == t.topology


@pytest.mark.parametrize("sharded,codecs", [(False, ("f32", "int8")),
                                            (True, ("f32", "bf16"))])
def test_default_timer_runs_the_collectives(sharded, codecs):
    """The live protocol on the CPU: every candidate's collective warmed
    and timed in turns, a measured winner."""
    t = tat.autotune_plan(4, 1 << 12, top_k=3, repeat=2, codecs=codecs,
                          use_cache=False, sharded=sharded, device="cpu")
    assert t.source == "measured" and t.measured_us > 0
    assert len(t.table) == 3 and all(r[4] > 0 for r in t.table)


# ------------------------------------------------------------- the knob


def _calls(monkeypatch, module):
    """Record each ``autotune_plan`` call of ``module`` and answer with a
    fixed plan per world size."""
    calls = []

    def fake(n, nbytes, **kw):
        calls.append((n, nbytes, kw["dtype"], kw["codecs"], kw["top_k"],
                      kw["repeat"], kw["overlap"], kw["sharded"],
                      tuple(kw["ir_families"])))
        return tat.TunedPlan(n, nbytes, "float32", (n,), 0, "f32", 1.0, 1.0,
                             "measured")

    monkeypatch.setattr(module, "autotune_plan", fake)
    return calls


@pytest.mark.parametrize("family", ["dense", "pipeline", "moe"])
@pytest.mark.parametrize("tc_kw", [dict(), dict(codec="int8", overlap=True),
                                   dict(shard_optimizer=True)])
def test_knob_times_what_jax_times(family, tc_kw, monkeypatch):
    """The port's ``maybe_autotune_grad_topo`` asks the autotuner what the
    JAX one asks (the same parameter bytes, axes, codec, keys, no IR
    family) and pins the same ``grad_topo``."""
    from flextree_tpu.models import moe as jmoe
    from flextree_tpu.models import transformer as jt
    from flextree_tpu.parallel import pipeline as jpipe
    from flextree_tpu.parallel import train as jtrain
    from flextree_tpu_torch.models import moe as tmoe
    from flextree_tpu_torch.models import transformer as tt
    from flextree_tpu_torch.parallel import pipeline as tpipe
    from flextree_tpu_torch.parallel import train as ttrain
    from flextree_tpu_torch.parallel.mesh import Mesh

    jcalls, tcalls = _calls(monkeypatch, jat), _calls(monkeypatch, tat)
    dims = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
    if family == "dense":
        axes, shape = ("dp", "sp", "tp"), (2, 2, 2)
        jcfg, tcfg = jt.TransformerConfig(**dims), tt.TransformerConfig(**dims)
        jinit, tinit = None, None
    elif family == "pipeline":
        axes, shape = ("dp", "pp", "sp", "tp"), (2, 2, 1, 2)
        jcfg, tcfg = jt.TransformerConfig(**dims), tt.TransformerConfig(**dims)

        def jinit(k, cfg):
            return jpipe.stack_layer_params(jt.init_params(k, cfg))

        def tinit(cfg, gen, device):
            return tpipe.stack_layer_params(tt.init_params(cfg, gen, device))
    else:
        axes, shape = ("dp", "ep", "sp", "tp"), (2, 2, 1, 2)
        moe = dict(n_experts=4, top_k=2)
        jcfg, tcfg = jmoe.MoEConfig(**dims, **moe), tmoe.MoEConfig(**dims,
                                                                   **moe)
        jinit, tinit = jmoe.init_moe_params, tmoe.init_moe_params
    jtc = jtrain.maybe_autotune_grad_topo(
        jtrain.make_mesh_nd(8, shape, axes), jcfg,
        jtrain.TrainConfig(autotune=True, **tc_kw), axes, init_fn=jinit)
    ttc = ttrain.maybe_autotune_grad_topo(
        Mesh((torch.device("cpu"),) * 8, axes, shape), tcfg,
        ttrain.TrainConfig(autotune=True, **tc_kw), axes, init_fn=tinit)
    assert tcalls == jcalls and len(tcalls) == sum(s > 1 for s in shape)
    assert ttc.grad_topo == jtc.grad_topo and not ttc.autotune


def test_knob_is_a_noop_without_flag_or_with_explicit_topo(monkeypatch):
    from flextree_tpu_torch.models.transformer import TransformerConfig
    from flextree_tpu_torch.parallel import train as ttrain
    from flextree_tpu_torch.parallel.mesh import Mesh

    calls = _calls(monkeypatch, tat)
    mesh = Mesh((torch.device("cpu"),) * 8, ("dp", "sp", "tp"), (2, 2, 2))
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                            d_ff=64)
    tc = ttrain.TrainConfig()
    assert ttrain.maybe_autotune_grad_topo(mesh, cfg, tc) is tc
    tc2 = ttrain.TrainConfig(autotune=True, grad_topo="2,2,2")
    assert ttrain.maybe_autotune_grad_topo(mesh, cfg, tc2) is tc2
    assert calls == []


def test_builders_resolve_through_the_plan_cache(tmp_path, monkeypatch):
    """``TrainConfig(autotune=True)`` builds and runs all three families
    on 2 data-parallel ranks: the first build measures (the default timer
    on the CPU), every later build is a cache hit, and the step is the
    step of the resolved topology, bitwise."""
    import numpy as np

    from flextree_tpu_torch.models.moe import MoEConfig
    from flextree_tpu_torch.models.transformer import TransformerConfig
    from flextree_tpu_torch.parallel import moe_train, pipeline
    from flextree_tpu_torch.parallel import train as ttrain
    from flextree_tpu_torch.parallel.mesh import flat_mesh

    path = tmp_path / "plans.json"
    monkeypatch.setenv("FLEXTREE_PLAN_CACHE", str(path))
    dims = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
    rng = np.random.default_rng(0)
    toks, tgts = (rng.integers(0, 64, (4, 16)).astype(np.int32)
                  for _ in range(2))
    tc = ttrain.TrainConfig(autotune=True)
    for family in ("dense", "pipeline", "moe"):
        gen = torch.Generator().manual_seed(0)
        if family == "dense":
            cfg = TransformerConfig(**dims)
            comm = flat_mesh(2, "cpu", "dp")
            state = ttrain.init_train_state(cfg, gen, tc, device="cpu",
                                            comm=comm)

            def build(t):
                return ttrain.make_train_step(cfg, t, device="cpu",
                                              comm=comm)
        elif family == "pipeline":
            cfg = TransformerConfig(**dims)
            comm = pipeline.make_mesh_4d(shape=(2, 1, 1, 1), device="cpu")
            state = pipeline.init_pipeline_train_state(cfg, gen, tc,
                                                       device="cpu",
                                                       comm=comm)

            def build(t):
                return pipeline.make_pipeline_train_step(cfg, t, 2,
                                                         comm=comm)
        else:
            cfg = MoEConfig(**dims, n_experts=4, top_k=2)
            comm = moe_train.make_mesh_moe(shape=(2, 1, 1, 1), device="cpu")
            state = moe_train.init_moe_train_state(cfg, gen, tc, device="cpu",
                                                   comm=comm)

            def build(t):
                return moe_train.make_moe_train_step(cfg, t, comm=comm)

        got, _ = build(tc)(state, toks, tgts)
        entries = json.loads(path.read_text())["entries"]
        assert any("|n2|" in k for k in entries)
        (entry,) = [e for k, e in entries.items() if "|n2|" in k
                    and k.split("|")[-5] == f"{_bytes(family, cfg)}B"]
        spec = ",".join(map(str, entry["widths"]))
        want, _ = build(dataclasses.replace(
            tc, autotune=False, grad_topo={"dp": spec}))(state, toks, tgts)
        for a, b in zip(ttrain.tree_leaves(got), ttrain.tree_leaves(want)):
            assert torch.equal(a, b)
    assert len(json.loads(path.read_text())["entries"]) == 2  # dense=pipe


def _bytes(family, cfg) -> int:
    from flextree_tpu_torch.models.moe import init_moe_params
    from flextree_tpu_torch.models.transformer import init_params
    from flextree_tpu_torch.parallel.train import tree_leaves

    init = init_moe_params if family == "moe" else init_params
    with torch.device("meta"):
        tree = init(cfg, torch.Generator(), device="meta")
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def test_autotune_over_a_process_group_refuses_on_every_rank():
    """Over a ``torch.distributed`` group each process would time its own
    in-process mesh and could pin another winner than its peers (the
    two-stage shapes trade places between calls on the card), so the
    knob refuses there on every rank, naming its ROADMAP item, before any
    timing; an explicit ``grad_topo`` still builds (2 gloo processes)."""
    from flextree_tpu_torch.parallel import launch

    got = launch.spawn(_autotune_on_group, 2, backend="gloo", timeout=120)
    assert got == [("refused", True)] * 2


def _autotune_on_group(rank, world):
    import torch.distributed as dist

    from flextree_tpu_torch.models.transformer import TransformerConfig
    from flextree_tpu_torch.parallel import train as ttrain

    def timed(*a, **k):
        raise AssertionError("autotune timed a candidate over a group")

    tat.autotune_plan = timed
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                            d_ff=64)
    group = dist.group.WORLD
    pinned = ttrain.TrainConfig(autotune=True, grad_topo="2")
    assert ttrain.maybe_autotune_grad_topo(group, cfg, pinned) is pinned
    ttrain.make_train_step(cfg, pinned, device="cpu", comm=group)
    try:
        ttrain.make_train_step(cfg, ttrain.TrainConfig(autotune=True),
                               device="cpu", comm=group)
    except NotImplementedError as e:
        return ("refused", "Sequence, pipeline and expert parallelism"
                in str(e) and "torch.distributed group" in str(e))
    return ("built", False)
