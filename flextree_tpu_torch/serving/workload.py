"""Spike workload generator for the elastic-serving benches.

The port's copy of ``flextree_tpu/serving/workload.py``: a three-phase
open-loop Poisson arrival process — baseline → spike → baseline — with a
decode-heavy output mix.  The same ``numpy.random.default_rng`` draws in
the same order, so a seed gives the JAX package's request stream byte
for byte (rids, prompt bytes, ``max_new_tokens``, ``arrival_s``).

Arrivals are open-loop: each request carries an ``arrival_s`` offset
from the run start and lands on the wall clock whether or not the
serving side keeps up — that is what makes an under-provisioned phase
actually breach the SLO instead of self-throttling.

``prefix_pool`` / ``prefix_frac`` opt a fraction of prompts into shared
token prefixes (drawn per-request from the pool) — the prefix-cache /
affinity-handoff workloads need hot prefixes; the plain spike leaves
them off.  Disabled, the RNG draw sequence is the plain generator's (no
extra draws), so existing seeds replay the same stream.
"""

from __future__ import annotations

import numpy as np

from .batcher import Request

__all__ = [
    "PROMPT_LENS",
    "OUT_LENS",
    "OUT_PROBS",
    "build_spike_workload",
]

PROMPT_LENS = (4, 6, 8)
# decode-heavy mixed outputs: mean ~29 tokens a request
OUT_LENS = (16, 32, 48)
OUT_PROBS = (0.4, 0.35, 0.25)


def _poisson_phase(rng, rate: float, duration_s: float, offset_s: float):
    """Arrival offsets of one open-loop Poisson phase."""
    out = []
    t = 0.0
    while t < duration_s:
        t += rng.exponential(1.0 / rate)
        if t < duration_s:
            out.append(offset_s + t)
    return out


def build_spike_workload(
    seed,
    base_rate,
    spike_rate,
    t_base,
    t_spike,
    t_tail,
    *,
    prompt_lens=PROMPT_LENS,
    out_lens=OUT_LENS,
    out_probs=OUT_PROBS,
    vocab: int = 128,
    prefix_pool=(),
    prefix_frac: float = 0.0,
    rid_base: int = 0,
):
    """Requests with ``arrival_s`` offsets covering baseline → spike →
    baseline; returns ``(requests, spike_start_s, spike_end_s)``.

    With ``prefix_pool`` non-empty, each request is prefix-shared with
    probability ``prefix_frac``: a prefix (an int32 token array) drawn
    uniformly from the pool is prepended to its random suffix of
    ``prompt_lens`` tokens — the shape a prefix cache (and the front
    door's affinity routing) can actually exploit.
    """
    rng = np.random.default_rng(seed)
    arrivals = _poisson_phase(rng, base_rate, t_base, 0.0)
    spike_start = float(t_base)
    arrivals += _poisson_phase(rng, spike_rate, t_spike, spike_start)
    spike_end = spike_start + float(t_spike)
    arrivals += _poisson_phase(rng, base_rate, t_tail, spike_end)
    requests = []
    for i, a in enumerate(sorted(arrivals)):
        p = int(rng.choice(prompt_lens))
        m = int(rng.choice(out_lens, p=out_probs))
        prompt = rng.integers(0, vocab, (p,)).astype(np.int32)
        if prefix_pool and rng.random() < prefix_frac:
            pre = np.asarray(
                prefix_pool[int(rng.integers(0, len(prefix_pool)))],
                np.int32,
            )
            prompt = np.concatenate([pre, prompt])
        requests.append(
            Request(
                rid=rid_base + i,
                prompt=prompt,
                max_new_tokens=m,
                arrival_s=float(a),
            )
        )
    return requests, spike_start, spike_end
