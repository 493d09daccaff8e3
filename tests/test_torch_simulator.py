"""The port's copy of the NumPy simulator (``flextree_tpu_torch.backends.
simulator``) is the JAX package's oracle: bitwise the same results on
seeded inputs over tree, ring and lonely shapes, and the same detected and
recovered events and diagnostics under fault plans."""

import ml_dtypes
import numpy as np
import pytest

from flextree_tpu.backends import simulator as jsim
from flextree_tpu_torch.backends import simulator as tsim

SHAPES = [(2, "2"), (4, "2,2"), (4, "1"), (6, "3,2"), (7, "3,2+1"),
          (8, "4,2"), (8, "2,2,2"), (8, "1"), (3, "2+1"), (5, None)]
CASES = [("sum", np.float32), ("sum", ml_dtypes.bfloat16), ("prod", np.float64),
         ("max", np.float16), ("band", np.int32), ("bxor", np.uint64),
         ("min", np.int8), ("bor", np.bool_)]


def rows(n, count, dtype, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind in "iu":
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, (n, count), dtype=dtype,
                            endpoint=True)
    if dtype == np.bool_:
        return rng.integers(0, 2, (n, count)).astype(np.bool_)
    return rng.standard_normal((n, count)).astype(np.float32).astype(dtype)


@pytest.mark.parametrize("n,spec", SHAPES)
def test_results_bitwise_equal(n, spec):
    for count in (1, 8, 35, 64):
        for op, dtype in CASES:
            x = rows(n, count, dtype, seed=count + n)
            want = jsim.simulate_allreduce(x, spec, op)
            got = tsim.simulate_allreduce(x, spec, op)
            assert got.dtype == want.dtype
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
                (op, np.dtype(dtype).name, count)


PLANS = [
    dict(faults=({"kind": "drop", "stage": 0, "src": 1, "dst": 0},)),
    dict(faults=({"kind": "duplicate"},)),
    dict(faults=({"kind": "reorder", "stage": 1},)),
    dict(faults=({"kind": "corrupt", "src": 2},)),
    dict(faults=({"kind": "delay", "phase": 2},)),
    dict(faults=({"kind": "hang", "stage": 0, "src": 3},), recv_timeout=2.0),
    dict(faults=({"kind": "hang", "stage": 0, "src": 3},)),
    dict(kill={2: 1}),
    dict(kill={6: 0}),
]


def outcome(sim, x, spec, plan_kw):
    plan = sim.FaultPlan(**plan_kw)
    try:
        res = ("ok", sim.simulate_allreduce(x, spec, "sum", faults=plan).tobytes())
    except AssertionError as e:  # FaultDetected, StageTimeout, violations
        res = (type(e).__name__, str(e), getattr(e, "kind", None),
               getattr(e, "stage", None), getattr(e, "src", None),
               getattr(e, "dst", None))
    events = [(e.kind, e.action, e.phase, e.stage, e.src, e.dst, e.block,
               e.note) for e in plan.events]
    return res, events


@pytest.mark.parametrize("plan_kw", PLANS, ids=lambda p: repr(p)[:40])
@pytest.mark.parametrize("n,spec", [(8, "4,2"), (8, "1"), (7, "3,2+1")])
def test_fault_plans_detect_and_recover_alike(n, spec, plan_kw):
    x = rows(n, 35, np.int32, seed=3)
    assert outcome(tsim, x, spec, plan_kw) == outcome(jsim, x, spec, plan_kw)
