"""Paged-decode cost estimates: the serving planner's predicted side.

The port's copy of ``flextree_tpu/serving/costs.py``: the same formulas,
priced from the port's calibratable constants
(``planner.calibrate.default_params``: ``bwd_GFLOPs`` as the achievable
compute throughput, ``reduce_bw_GBps`` as the memory-bound byte rate,
``dcn`` and ``codec_bw_GBps`` for a migration hop).  Under the same
``TpuCostParams`` values every function returns what the JAX package's
returns.  Two differences of the port: the compute rate's default comes
from the device's type (``parallel.overlap.resolve_bwd_GFLOPs(params,
device)``; ``device=None`` is the card when one is present, as JAX's
default backend is), and the pool's item size from ``cfg.dtype``, a
``torch.dtype``.

The estimate is deliberately first-order: dense projection FLOPs per
decoded token plus the attention walk's K/V byte traffic over the batch
causal frontier.  It does not model dispatch or sampling-host time; that
is what the residual loop is for — the engine's ``serve.round_residual``
histogram holds each measured decode round against this prediction, with
the compute-bound and byte-bound terms as separate fields.
"""

from __future__ import annotations

import torch

__all__ = [
    "decode_round_flops",
    "decode_round_bytes",
    "predict_decode_round_us",
    "predict_prefill_us",
    "kv_migration_elems",
    "predict_migration_us",
    "plan_migration",
    "migration_crossover_tokens",
]


def _device(device):
    """The device whose compute rate prices a prediction: ``device``, or
    the card when one is present (JAX prices for its default backend)."""
    if device is not None:
        return device
    return "cuda" if torch.cuda.is_available() else "cpu"


def _dense_flops_per_token(cfg) -> float:
    """Dense (projection + MLP + LM head) multiply-accumulate FLOPs to
    decode one token: 2·weights touched."""
    d, ff = cfg.d_model, cfg.d_ff
    per_layer = 4 * d * d + 2 * d * ff  # qkvo + in/out MLP
    return 2.0 * (cfg.n_layers * per_layer + d * cfg.vocab_size)


def decode_round_flops(cfg, n_active: int, max_len: int) -> float:
    """FLOPs for one decode round over ``n_active`` slots attending up to
    ``max_len`` positions (the batched walk runs to the batch frontier)."""
    attn = 4.0 * max_len * cfg.d_model * cfg.n_layers  # QK^T + AV per token
    return n_active * (_dense_flops_per_token(cfg) + attn)


def decode_round_bytes(cfg, pcfg, n_active: int, frontier_blocks: int) -> float:
    """K/V pool bytes streamed in one decode round: every active slot
    reads the pools up to the batch frontier (blocks × block_size
    positions × K and V × heads × head_dim × itemsize × layers)."""
    itemsize = torch.finfo(cfg.dtype).bits // 8
    per_pos = 2 * cfg.n_heads * cfg.head_dim * itemsize * cfg.n_layers
    return float(n_active * frontier_blocks * pcfg.block_size * per_pos)


def predict_decode_round_us(
    cfg, pcfg, n_active: int, max_len: int, params=None, device=None
) -> dict:
    """Predicted decode-round time, split into the two attributable
    phases: ``compute_us`` (dense+attention FLOPs over the calibrated
    achievable throughput) and ``bytes_us`` (K/V streaming at the
    HBM-bound byte rate).  Returns ``{"predicted_us", "compute_us",
    "bytes_us"}`` — the per-term decomposition the serving residual
    stream attributes drift against."""
    from ..parallel.overlap import resolve_bwd_GFLOPs
    from ..planner.calibrate import default_params

    if params is None:
        params = default_params()
    if n_active <= 0:
        return {"predicted_us": 0.0, "compute_us": 0.0, "bytes_us": 0.0}
    frontier_blocks = min(
        (max(int(max_len), 1) + pcfg.block_size - 1) // pcfg.block_size,
        pcfg.blocks_per_seq,
    )
    gflops = max(resolve_bwd_GFLOPs(params, _device(device)), 1e-6)
    compute_us = decode_round_flops(cfg, n_active, max_len) / (gflops * 1e3)
    bytes_us = decode_round_bytes(cfg, pcfg, n_active, frontier_blocks) / (
        max(params.reduce_bw_GBps, 1e-6) * 1e3
    )
    return {
        "predicted_us": compute_us + bytes_us,
        "compute_us": compute_us,
        "bytes_us": bytes_us,
    }


def predict_prefill_us(cfg, prompt_len: int, params=None,
                       cached_tokens: int = 0, device=None) -> float:
    """Predicted prefill compute time for one prompt (the TTFT floor a
    non-queued request could hit): dense FLOPs for every prompt token
    plus the causal attention triangle.

    ``cached_tokens`` is the prefix-cache hit length: those tokens pay
    neither dense FLOPs nor their attention rows, but the suffix still
    attends over the FULL prefix — so the attention term is the triangle
    minus the cached sub-triangle (``t² − c²``), not ``(t − c)²``.
    Pricing a hit as a full prefill would poison the serving residual
    stream the feedback loop pools."""
    from ..parallel.overlap import resolve_bwd_GFLOPs
    from ..planner.calibrate import default_params

    if params is None:
        params = default_params()
    t = max(int(prompt_len), 1)
    c = min(max(int(cached_tokens), 0), t - 1)
    dense = _dense_flops_per_token(cfg) * (t - c)
    attn = 2.0 * (t * t - c * c) * cfg.d_model * cfg.n_layers
    gflops = max(resolve_bwd_GFLOPs(params, _device(device)), 1e-6)
    return (dense + attn) / (gflops * 1e3)


def kv_migration_elems(cfg, pcfg, prompt_len: int) -> int:
    """f32 elements per K-or-V tensor of one migrated sequence: the block
    footprint of the prompt (``blocks_for``, whole blocks — migration
    ships the tail block too) × block positions × heads × head_dim.  One
    sequence ships ``2 * n_layers`` such tensors."""
    n_blocks = pcfg.blocks_for(max(int(prompt_len), 1))
    return n_blocks * pcfg.block_size * cfg.n_heads * cfg.head_dim


def predict_migration_us(cfg, pcfg, prompt_len: int, codec="f32",
                         params=None) -> dict:
    """Predicted time to ship one sequence's KV to a decode replica: the
    α–β wire term (DCN latency + codec wire bytes over DCN bandwidth)
    plus, for lossy codecs, the encode+decode pass over the f32 payload
    at the calibrated codec throughput.  Returns ``{"predicted_us",
    "wire_us", "codec_us", "bytes_on_wire"}`` — the same per-term
    decomposition style as :func:`predict_decode_round_us`, so migration
    residuals stay phase-attributable."""
    from ..ops.quantize import get_codec
    from ..planner.calibrate import default_params

    if params is None:
        params = default_params()
    c = get_codec(codec)
    elems = kv_migration_elems(cfg, pcfg, prompt_len)
    n_tensors = 2 * cfg.n_layers
    bytes_on_wire = n_tensors * c.wire_bytes(elems)
    wire_us = params.dcn.latency_us + bytes_on_wire / (
        max(params.dcn.bandwidth_GBps, 1e-6) * 1e3
    )
    codec_us = 0.0
    if c.hop_cost:
        codec_us = 2.0 * (n_tensors * elems * 4) / (
            max(params.codec_bw_GBps, 1e-6) * 1e3
        )
    return {
        "predicted_us": wire_us + codec_us,
        "wire_us": wire_us,
        "codec_us": codec_us,
        "bytes_on_wire": bytes_on_wire,
    }


def plan_migration(cfg, pcfg, prompt_len: int, codec="f32",
                   params=None, device=None) -> dict:
    """The migrate-vs-local decision for one request: ship the quantized
    KV (``predict_migration_us``) or recompute the prefill on the decode
    replica (``predict_prefill_us``)?  Prefill FLOPs grow quadratically
    in the prompt while the wire term grows linearly, so short prompts
    recompute (never pay the hop) and long prompts ship.  Returns
    ``{"migrate", "migrate_us", "recompute_us", "bytes_on_wire"}``."""
    mig = predict_migration_us(cfg, pcfg, prompt_len, codec, params)
    recompute_us = predict_prefill_us(cfg, prompt_len, params,
                                      device=device)
    return {
        "migrate": mig["predicted_us"] < recompute_us,
        "migrate_us": mig["predicted_us"],
        "recompute_us": recompute_us,
        "bytes_on_wire": mig["bytes_on_wire"],
    }


def migration_crossover_tokens(cfg, pcfg, codec="f32", params=None,
                               device=None):
    """Smallest prompt length at which shipping the KV beats recomputing
    the prefill (``None`` if no prompt admissible under ``pcfg.max_len``
    ever crosses).  The front door uses this as its routing threshold so
    the per-request decision is one integer compare."""
    from ..planner.calibrate import default_params

    if params is None:
        params = default_params()
    for t in range(1, pcfg.max_len + 1):
        if plan_migration(cfg, pcfg, t, codec, params, device)["migrate"]:
            return t
    return None
