"""The port's spike load generator (``flextree_tpu_torch/serving/
workload.py``) against the JAX package's: the same seed gives the same
request stream byte for byte — rids, prompt bytes, ``max_new_tokens``,
``arrival_s`` and the spike bounds — with and without shared prefixes."""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from flextree_tpu_torch.serving import Request
from flextree_tpu_torch.serving import workload as twl

jwl = importlib.import_module("flextree_tpu.serving.workload")

PREFIXES = (np.arange(5, dtype=np.int32), np.arange(10, 22, dtype=np.int32))


def _stream(reqs):
    return [(r.rid, r.prompt.dtype.str, r.prompt.tobytes(), r.max_new_tokens,
             r.arrival_s) for r in reqs]


@pytest.mark.parametrize("seed", [0, 1, 7, 2024])
@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
def test_stream_is_the_jax_stream(seed, prefix):
    args = (seed, 8.0, 40.0, 1.5, 1.0, 1.5)
    kw = dict(prefix_pool=PREFIXES, prefix_frac=0.5) if prefix else {}
    treqs, ts, te = twl.build_spike_workload(*args, rid_base=100, **kw)
    jreqs, js, je = jwl.build_spike_workload(*args, rid_base=100, **kw)
    assert (ts, te) == (js, je) == (1.5, 2.5)
    assert len(treqs) == len(jreqs) > 10
    assert _stream(treqs) == _stream(jreqs)
    assert all(isinstance(r, Request) for r in treqs)
    assert all(r.prompt.dtype == np.int32 for r in treqs)
    arrivals = [r.arrival_s for r in treqs]
    assert arrivals == sorted(arrivals)
    assert [r.rid for r in treqs] == list(range(100, 100 + len(treqs)))
    if prefix:  # some prompts carry a shared prefix
        assert any(len(r.prompt) > max(twl.PROMPT_LENS) for r in treqs)


def test_no_prefix_draws_nothing_extra():
    """With the prefix pool off the stream is the plain generator's: an
    empty pool with a non-zero fraction draws the same as no pool."""
    a, *_ = twl.build_spike_workload(3, 10.0, 30.0, 1.0, 1.0, 1.0)
    b, *_ = twl.build_spike_workload(3, 10.0, 30.0, 1.0, 1.0, 1.0,
                                     prefix_pool=(), prefix_frac=0.9)
    assert _stream(a) == _stream(b)


def test_scaled_mix_and_constants_match_jax():
    assert (twl.PROMPT_LENS, twl.OUT_LENS, twl.OUT_PROBS) == \
        (jwl.PROMPT_LENS, jwl.OUT_LENS, jwl.OUT_PROBS)
    kw = dict(prompt_lens=(64, 96, 128), out_lens=(32, 64, 96), vocab=8192)
    t, *tb = twl.build_spike_workload(5, 20.0, 100.0, 0.5, 0.4, 0.5, **kw)
    j, *jb = jwl.build_spike_workload(5, 20.0, 100.0, 0.5, 0.4, 0.5, **kw)
    assert tb == jb and _stream(t) == _stream(j)
    assert {len(r.prompt) for r in t} <= {64, 96, 128}
    assert {r.max_new_tokens for r in t} <= {32, 64, 96}
