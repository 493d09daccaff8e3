"""The port's readiness-ordered overlap (``parallel/overlap.py``) against
the JAX package's, and its three steps against each other.

- The planning is the JAX package's, field for field: the readiness
  segments, each segment's FLOPs and ``plan_overlap``'s boundaries, bytes,
  compute and prediction, at the flagship's shapes (from shapes only: the
  port's are ``"meta"`` tensors) and a small model's, for codec None and
  int8, with one explicit cost-parameter set on both sides.
- The overlapped step fires each bucket as soon as every rank has run
  its last segment's backward, before the next segment's; the twin fires
  after the whole backward.
- Inside the port, bitwise after two steps on in-process CPU ranks: the
  overlapped step, its serialized twin and the production step (no
  overlap) in float32 over ``grad_topo`` None, ``"4,2"`` and the ring on 8
  ranks, ``"3,2+1"`` on 7, clipping with ``grad_chunks=2``, and bf16
  compute with the flash path; for the bf16 and int8 codecs the
  overlapped step and its twin, ``ef`` included (and ``ef`` non-zero).
- The overlapped step against the JAX overlapped step on a (4, 1, 1)
  mesh: the losses within rtol 1e-6 and the parameters within atol 1e-5,
  except where the step-1 gradient is below 1e-7, which are held to
  AdamW's update bound as ``test_torch_train_dp.py`` holds them.
- Two gloo processes with ``overlap=True`` end in the mesh's state,
  bitwise; the ``ft_overlap_bucket`` spans count every gradient byte
  once; ``exposed_split``'s cases; ``run_train_step_bench``'s six rows,
  and its ZeRO-1 rows; a ZeRO fire's shards against the serialized
  reduce-scatter's.

The suite runs JAX with ``jax_enable_x64``: every input is an explicit
float32 / int32 array.
"""

import dataclasses
import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flextree_tpu_torch.bench.harness import (
    TrainStepBenchConfig,
    digest,
    dist_train_steps,
    run_train_step_bench,
)
from flextree_tpu_torch.convert import (
    train_state_from_numpy,
    train_state_to_numpy,
)
from flextree_tpu_torch.models import transformer as tt
from flextree_tpu_torch.obs import flight_recorder
from flextree_tpu_torch.parallel import launch
from flextree_tpu_torch.parallel import overlap as tov
from flextree_tpu_torch.parallel import train as ttrain
from flextree_tpu_torch.parallel.mesh import flat_mesh
from flextree_tpu_torch.planner.cost_model import LinkParams as TLink
from flextree_tpu_torch.planner.cost_model import TpuCostParams as TParams
from flextree_tpu_torch.schedule.stages import Topology as TTopology
from flextree_tpu_torch.utils import profiling as tprof

jt = importlib.import_module("flextree_tpu.models.transformer")
jtrain = importlib.import_module("flextree_tpu.parallel.train")
jov = importlib.import_module("flextree_tpu.parallel.overlap")
jcost = importlib.import_module("flextree_tpu.planner.cost_model")
jstages = importlib.import_module("flextree_tpu.schedule.stages")

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
FLAGSHIP = dict(vocab_size=8192, d_model=512, n_heads=8, n_layers=4,
                d_ff=2048)
KW = dict(lr=1e-3, grad_clip_norm=1.0, schedule="warmup_cosine",
          warmup_steps=1, total_steps=3)
# one cost-parameter set for both packages (the port's H100 defaults, with
# the backward throughput set)
COST = dict(link=(176.08382310095362, 9.086911458072194),
            reduce_bw_GBps=352.1983604430778, control_us_per_width=0.0,
            launch_us=2.6289864287439917, codec_bw_GBps=59.21,
            bwd_GFLOPs=21_000.0)


def _params(mod, link_cls):
    link = link_cls(*COST["link"])
    rest = {k: v for k, v in COST.items() if k != "link"}
    return mod(ici=link, dcn=link, **rest)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol)


def _batch(seed, shape=(8, 16)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, DIMS["vocab_size"], shape).astype(np.int32),
            rng.integers(0, DIMS["vocab_size"], shape).astype(np.int32))


def _same(a, b):
    la, lb = ttrain.tree_leaves(a), ttrain.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ------------------------------------------------------------ planning


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("dims,n,topo,rows,seq", [
    (FLAGSHIP, 8, None, 1, 1024),
    (FLAGSHIP, 8, "4,2", 1, 1024),
    (DIMS, 8, None, 1, 16),
    (DIMS, 7, "3,2+1", 2, 16),
], ids=["flagship-8", "flagship-4,2", "small-8", "small-3,2+1"])
def test_plan_overlap_matches_jax(dims, n, topo, rows, seq, codec):
    jshapes = jax.eval_shape(lambda k: jt.init_params(k, jt.TransformerConfig(
        **dims)), jax.random.PRNGKey(0))
    tshapes = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                           jshapes)
    jsegs = jov.readiness_segments(jshapes)
    assert tov.readiness_segments(tshapes) == jsegs
    n_tokens = rows * seq
    for _, path in jsegs:
        assert tov.segment_flops(path, tshapes, n_tokens, dims["d_model"],
                                 seq) == jov.segment_flops(
            path, jshapes, n_tokens, dims["d_model"], seq)
    axes = ("dp", "sp", "tp")
    sizes = {"dp": n, "sp": 1, "tp": 1}
    jtopos = {"dp": jstages.Topology.resolve(n, topo), "sp": None,
              "tp": None}
    ttopos = {"dp": TTopology.resolve(n, topo), "sp": None, "tp": None}
    want = jov.plan_overlap(
        jshapes, jt.param_specs(jt.TransformerConfig(**dims), "tp"), axes,
        jtopos, sizes, n_tokens=n_tokens, t_local=seq,
        d_model=dims["d_model"],
        cost_params=_params(jcost.TpuCostParams, jcost.LinkParams),
        codec=codec)
    got = tov.plan_overlap(
        tshapes, tt.param_specs(tt.TransformerConfig(**dims)), axes, ttopos,
        sizes, n_tokens=n_tokens, t_local=seq, d_model=dims["d_model"],
        cost_params=_params(TParams, TLink), codec=codec)
    assert got.labels == want.labels
    assert got.boundaries == want.boundaries
    assert got.seg_bytes == want.seg_bytes
    assert got.seg_compute_us == pytest.approx(want.seg_compute_us,
                                               rel=1e-12)
    assert got.predicted_total_us == pytest.approx(want.predicted_total_us,
                                                   rel=1e-12)
    assert got.predicted_exposed_us == pytest.approx(
        want.predicted_exposed_us, rel=1e-12, abs=1e-9)


def test_resolve_bwd_gflops():
    assert tov.resolve_bwd_GFLOPs(TParams(bwd_GFLOPs=123.0), "cpu") == 123.0
    assert tov.resolve_bwd_GFLOPs(TParams(), "cpu") == 8.0
    assert tov.resolve_bwd_GFLOPs(None, torch.device("cpu")) == 8.0
    card = tov.resolve_bwd_GFLOPs(None, "cuda")
    assert card > 1000.0 and card != jov._BWD_GFLOPS_ACCEL
    with pytest.raises(ValueError, match="calibrate"):
        tov.resolve_bwd_GFLOPs(None, "meta")


# --------------------------------------------- bitwise inside the port


def _run(n, tc, *, serialize=False, steps=2, cfg=None, rows=1):
    cfg = cfg or tt.TransformerConfig(**DIMS)
    state = ttrain.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    tc, device="cpu")
    step = ttrain.make_train_step(cfg, tc, comm=flat_mesh(n, "cpu", "dp"),
                                  serialize_overlap=serialize)
    losses = []
    for i in range(steps):
        state, m = step(state, *_batch(30 + i, (n * rows, 16)))
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("n,tc,cfg", [
    (8, dict(), None),
    (8, dict(grad_topo="4,2"), None),
    (8, dict(grad_topo="1"), None),
    (7, dict(grad_topo="3,2+1"), None),
    (8, dict(grad_clip_norm=0.5, grad_chunks=2), None),
    (4, dict(grad_topo="2,2"),
     dict(DIMS, dtype=torch.bfloat16, attn_impl="flash")),
], ids=["flat", "4,2", "ring", "3,2+1", "clip-chunks", "bf16-flash"])
def test_f32_overlap_equals_twin_and_production(n, tc, cfg):
    cfg = tt.TransformerConfig(**cfg) if cfg else None
    prod_cfg = ttrain.TrainConfig(**tc)
    ovl_cfg = dataclasses.replace(prod_cfg, overlap=True)
    prod, prod_losses = _run(n, prod_cfg, cfg=cfg)
    ovl, ovl_losses = _run(n, ovl_cfg, cfg=cfg)
    twin, _ = _run(n, ovl_cfg, serialize=True, cfg=cfg)
    assert _same(ovl, twin)
    assert _same(ovl, prod) and ovl_losses == prod_losses


@pytest.mark.parametrize("boundaries", [None, ((0,), (1, 2), (3,))],
                         ids=["planned", "three-buckets"])
@pytest.mark.parametrize("serialize", [False, True],
                         ids=["overlapped", "twin"])
def test_buckets_fire_as_their_last_segment_finishes(monkeypatch,
                                                     serialize, boundaries):
    """The overlapped step fires bucket ``b`` after every rank has run
    segment ``b[-1]``'s backward and before any rank starts segment
    ``b[-1] + 1``'s; its twin fires every bucket after the whole
    backward.  Both run every rank's forward first (lock-step): the cut
    graphs cover every rank at once, so one forward runs them all and
    each segment's backward runs on every rank in one call."""
    events, plans = [], []
    real_plan, real_graphs = tov.plan_overlap, tov._segment_graphs
    real_fire = tov._sync_fired_bucket

    def plan_overlap(*args, **kw):
        plan = real_plan(*args, **kw)
        if boundaries is not None:
            plan = dataclasses.replace(plan, boundaries=boundaries)
        plans.append(plan)
        return plan

    def segment_graphs(*args, **kw):
        segs, loss = real_graphs(*args, **kw)
        events.append(("forward", None))

        def walk():  # each segment's backward runs inside next()
            for i in itertools.count():
                events.append(("start", i))
                try:
                    grads = next(segs)
                except StopIteration:
                    return
                events.append(("done", i))
                yield grads

        return walk(), loss

    def fire(*args, **kw):
        name = args[7]  # ft_overlap_bucket{bi}_...
        events.append(("fire", int(name.split("_")[2][len("bucket"):])))
        return real_fire(*args, **kw)

    monkeypatch.setattr(tov, "plan_overlap", plan_overlap)
    monkeypatch.setattr(tov, "_segment_graphs", segment_graphs)
    monkeypatch.setattr(tov, "_sync_fired_bucket", fire)
    n = 4
    _run(n, ttrain.TrainConfig(overlap=True), serialize=serialize, steps=1,
         rows=2)
    (plan,) = plans
    assert plan.n_buckets >= 2
    kinds = [k for k, _ in events]
    assert kinds[:1] == ["forward"] and kinds.count("forward") == 1
    assert [e for e in events if e[0] == "done"] == [
        ("done", i) for i in range(len(plans[0].labels))]
    fires = [(pos, bi) for pos, (k, bi) in enumerate(events) if k == "fire"]
    assert [bi for _, bi in fires] == list(range(plan.n_buckets))
    last = len(plan.labels) - 1

    def at(kind, seg):
        return [pos for pos, e in enumerate(events) if e == (kind, seg)]

    for pos, bi in fires:
        closing = plan.boundaries[bi][-1]
        if serialize:
            assert pos > max(at("done", last))
            continue
        assert len(at("done", closing)) == 1 and pos > max(at("done",
                                                              closing))
        if closing < last:
            assert pos < min(at("start", closing + 1))


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_lossy_overlap_equals_twin_with_ef(codec):
    """Each fired bucket quantizes as one payload, so the production step
    (other buckets) is only bounded-close; the twin, with the same
    buckets, is bitwise, residuals included."""
    tc = ttrain.TrainConfig(codec=codec, overlap=True)
    ovl, _ = _run(8, tc)
    twin, _ = _run(8, tc, serialize=True)
    assert _same(ovl, twin)
    assert len(ovl["ef"]) == 8
    assert all(any(e.any() for e in ttrain.tree_leaves(ef))
               for ef in ovl["ef"])


@pytest.mark.parametrize("codec", [None, "int8"])
def test_zero_fire_shards_equal_the_serialized_reduce_scatter(codec):
    """With a ZeRO layout each fired bucket reduce-scatters: the engine's
    shards (and, int8, residuals), assembled over the buckets, are bitwise
    ``zero_reduce_scatter_grads`` of the whole backward's gradients for
    the identity codec, and the twin's for int8 (whose buckets quantize as
    the fired payloads), on 4 ranks of the ring."""
    from flextree_tpu_torch.parallel import zero as tz

    cfg = tt.TransformerConfig(**DIMS)
    n = 4
    comm = flat_mesh(n, "cpu", "dp")
    tc = ttrain.TrainConfig(grad_topo="1", overlap=True,
                            shard_optimizer=True, codec=codec or "f32")
    state = ttrain.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    tc, device="cpu", comm=comm)
    tokens, targets = (torch.as_tensor(a) for a in _batch(0, (n, 16)))
    toks, tgts = list(tokens.split(1)), list(targets.split(1))
    axes = ttrain.AXIS_NAMES
    pspecs = tt.param_specs(cfg)
    sizes = {"dp": n, "sp": 1, "tp": 1}
    topos = ttrain.resolve_axis_topos(sizes, axes, "1")
    plan = tov.plan_overlap(state["params"], pspecs, axes, topos, sizes,
                            n_tokens=16, t_local=16, d_model=cfg.d_model,
                            codec=codec)
    plan = dataclasses.replace(plan, boundaries=((0,), (1, 2), (3,)))
    layout = ttrain.zero_layout_for(comm, state["params"], pspecs)
    if codec:
        state = dict(state, ef=[state["ef"]] * n)

    def engine(serialize):
        return tov.dense_overlap_step_grads(
            state, toks, tgts, cfg, tc, plan, pspecs, axes, topos,
            tokens.numel(), serialize=serialize, zero_layout=layout,
            comm=comm)

    _, shards, res = engine(False)
    assert all(isinstance(g, tz.ZeroShard) for t in shards
               for g in ttrain.tree_leaves(t))
    if codec:
        _, twin, twin_res = engine(True)
        want, want_res = twin, twin_res
        assert len(res) == n and _same(res, want_res)
    else:
        assert res is None
        grads = [ttrain.make_loss_and_grads(cfg, ttrain.TrainConfig(),
                                            device="cpu")(
            state["params"], t, y)[1] for t, y in zip(toks, tgts)]
        # each rank's loss over the global token count, as the step's
        grads = [ttrain.tree_map(lambda g: g / n, g) for g in grads]
        want = tz.zero_reduce_scatter_grads(grads, pspecs, axes, topos,
                                            comm=comm)
    for a, b in zip(shards, want):
        for x, y in zip(ttrain.tree_leaves(a), ttrain.tree_leaves(b)):
            assert torch.equal(x.tile, y.tile) and torch.equal(x.tail, y.tail)


# ----------------------------------------------- against the JAX step


@pytest.fixture(scope="module")
def jax_state():
    return _np(jtrain.init_train_state(jax.random.PRNGKey(0),
                                       jt.TransformerConfig(**DIMS)))


def test_overlapped_step_matches_jax(jax_state):
    kw = dict(KW, overlap=True)
    mesh = jtrain.make_mesh_3d(4, (4, 1, 1))
    jstep = jtrain.make_train_step(mesh, jt.TransformerConfig(**DIMS),
                                   jtrain.TrainConfig(**kw))
    tstep = ttrain.make_train_step(tt.TransformerConfig(**DIMS),
                                   ttrain.TrainConfig(**kw),
                                   comm=flat_mesh(4, "cpu", "dp"))
    jstate = jax.tree.map(jnp.asarray, jax_state)
    tstate = train_state_from_numpy(jax_state, device="cpu")
    cfg = jt.TransformerConfig(**DIMS)

    def grads(params, tokens, targets):
        """The JAX gradient of the step's loss, on host copies."""
        def loss(p):
            total, _ = jt.cross_entropy_loss(jt.forward(p, tokens, cfg),
                                             targets)
            return total / tokens.size

        params = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), params)
        return jax.tree.leaves(_np(jax.grad(loss)(params)))

    steps, gs = 2, []
    for i in range(steps):
        tokens, targets = _batch(20 + i, (4, 16))
        gs.append(grads(jstate["params"], tokens, targets))
        jstate, jm = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets))
        tstate, tm = tstep(tstate, tokens, targets)
        _close(tm["loss"].item(), float(jm["loss"]), 0, rtol=1e-6)
    want = _np(jstate)
    got = train_state_to_numpy(tstate)
    assert int(got["step"]) == int(want["step"]) == steps
    for a, b, g1, g2 in zip(jax.tree.leaves(want["params"]),
                            jax.tree.leaves(got["params"]), *gs):
        # AdamW divides step 1's update by |g1| + eps and step 2's by its
        # second moment's root, ~|(g1, g2)| / sqrt(2).  The JAX and port
        # gradients differ by up to ~1e-7 here (their summation orders),
        # which moves an update by up to lr * eps * gap / (|g1| + eps)**2
        # on step 1 and ~lr * gap / |(g1, g2)| on step 2: past the 1e-5
        # bar where |g1| < 1e-6 or |(g1, g2)| < 1e-5.  Those elements are
        # held to the most two updates can move a parameter apart.
        tiny = (np.abs(g1) < 1e-6) | (np.hypot(g1, g2) < 1e-5)
        _close(b[~tiny], a[~tiny], 1e-5)
        _close(b[tiny], a[tiny], 2 * KW["lr"] * steps)


# ------------------------------------------------ transports, records


def test_gloo_overlap_ranks_end_in_the_mesh_state():
    tc = dict(KW, grad_topo="1", overlap=True)
    batches = [_batch(30 + i, (2, 16)) for i in range(2)]  # as _run steps
    got = launch.spawn(dist_train_steps, 2, (DIMS, tc, batches, 0),
                       backend="gloo", timeout=120)
    state, losses = _run(2, ttrain.TrainConfig(**tc))
    want = [digest(t) for t in ttrain.tree_leaves(state)]
    for digests, rank_losses in got:
        assert digests == want and rank_losses == losses


def test_overlap_spans_count_every_gradient_byte_once():
    tc = ttrain.TrainConfig(overlap=True)
    cfg = tt.TransformerConfig(**DIMS)
    state = ttrain.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    step = ttrain.make_train_step(cfg, tc, comm=flat_mesh(8, "cpu", "dp"))
    with tprof.span_ledger() as ledger, flight_recorder(None), \
            tprof.plan_capture() as cap:
        step(state, *_batch(0))
    fired = [n for n in ledger.names if n.startswith("ft_overlap_bucket")]
    assert fired
    expect = sum(p.numel() * 4 for p in ttrain.tree_leaves(state["params"]))
    assert ledger.total_bytes("ft_overlap_bucket") == expect
    provs = [p for name, p in cap if name.startswith("ft_overlap_bucket")]
    assert len(provs) == len(fired)
    assert all(p["fired"] and not p["sharded"] for p in provs)
    # the inner bucketed syncs are not fired buckets
    assert all(not p["fired"] for name, p in cap
               if name.startswith("ft_bucket"))


def test_exposed_split():
    exp, hid = tprof.exposed_split(12.0, 10.0, 5.0)
    assert exp == pytest.approx(2.0) and hid == pytest.approx(3.0)
    exp, hid = tprof.exposed_split(9.0, 10.0, 5.0)  # noise: clamped
    assert exp == 0.0 and hid == 5.0
    exp, hid = tprof.exposed_split(20.0, 10.0, 5.0)  # nothing hidden
    assert exp == 10.0 and hid == 0.0


def test_train_step_bench_has_the_six_rows():
    out = run_train_step_bench(TrainStepBenchConfig(
        n_layers=2, d_model=32, d_ff=64, vocab_size=64, batch=4, seq_len=16,
        devices=4, repeat=2, overlap=True, device="cpu"))
    rows = out["rows"]
    assert set(rows) == {"per_leaf", "ours_fused", "ours_chunked", "no_sync",
                         "ours_overlapped", "ours_overlap_serialized"}
    assert out["identical"] and out["device"]["type"] == "cpu"
    for name, row in rows.items():
        if name == "no_sync":
            continue
        for key in ("sync_ms", "exposed_comm_ms", "hidden_comm_ms",
                    "exposed_vs_serialized"):
            assert np.isfinite(row[key]) and row[key] >= 0, (name, key)
    plan = out["overlap_plan"]
    assert [i for b in plan["boundaries"] for i in b] == \
        list(range(len(plan["labels"])))
    # the ZeRO-1 rows run now: ours_sharded bitwise the per-leaf step
    # (``identical``), each with its per-rank optimizer-state ratio, the
    # live buffers' bytes a rank equal to zero_shard_bytes
    out = run_train_step_bench(TrainStepBenchConfig(
        n_layers=1, d_model=32, d_ff=64, vocab_size=64, batch=4, seq_len=16,
        devices=4, repeat=1, sharded=True, device="cpu"))
    rows = out["rows"]
    assert out["identical"]
    for name, ratio in (("ours_sharded", 0.25), ("ours_sharded_int8", 0.375)):
        assert set(rows[name]) == {"train_step_ms", "train_step_avg_ms",
                                   "train_step_median_ms", "vs_per_leaf",
                                   "opt_state_bytes_ratio"}
        assert rows[name]["opt_state_bytes_ratio"] == ratio
        acct = out["opt_state_bytes"][name]
        assert acct["live_bytes_per_rank"] == acct["sharded_bytes_per_rank"]
    for flag, item in (("supervised", "supervision"),
                       ("recorder", "supervision")):
        with pytest.raises(NotImplementedError, match=item):
            run_train_step_bench(TrainStepBenchConfig(**{flag: True},
                                                      device="cpu"))
