"""Autoregressive generation with a contiguous KV cache.

PyTorch counterpart of ``flextree_tpu/models/generate.py``: prefill runs
the full forward once while recording every layer's K/V; decode then
advances one token at a time, attending over the cache.  The cache is
allocated at ``max_len`` up front and the causal bound is a mask on cached
positions, exactly as in the JAX module, so the serving path's paged
decode can be held against it.

Differences from the JAX module, all forced by the framework:

- the cache is updated **in place** (``_forward_cached`` writes the new
  K/V into the tensors it was given and returns the same dict); JAX
  returns fresh arrays;
- ``lax.scan`` / ``lax.while_loop`` are Python loops;
- sampling takes a ``torch.Generator``.  Its draws are not
  ``jax.random``'s, so the two packages agree token for token only when
  greedy.
"""

from __future__ import annotations

import torch

from .transformer import (
    TransformerConfig,
    apply_rope,
    final_logits,
    mlp_block,
    rms_norm,
)

__all__ = [
    "init_kv_cache",
    "prefill",
    "prefill_suffix",
    "prefill_ragged",
    "decode_step",
    "generate",
    "sample_token",
    "cached_attention",
]

_NEG_INF = -1e30


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  device) -> dict:
    """Per-layer (B, max_len, H, Dh) K/V buffers in the compute dtype.
    ``length`` is per sequence (B,) so ragged batches can share a cache."""
    shape = (batch, max_len, cfg.n_heads, cfg.head_dim)
    return {
        "k": [torch.zeros(shape, dtype=cfg.dtype, device=device)
              for _ in range(cfg.n_layers)],
        "v": [torch.zeros(shape, dtype=cfg.dtype, device=device)
              for _ in range(cfg.n_layers)],
        "length": torch.zeros(batch, dtype=torch.int32, device=device),
    }


def _qkv(layer, h, cfg: TransformerConfig):
    b, t = h.shape[:2]
    shape = (b, t, cfg.n_heads, cfg.head_dim)
    q = (h @ layer["wq"].to(cfg.dtype)).reshape(shape)
    k = (h @ layer["wk"].to(cfg.dtype)).reshape(shape)
    v = (h @ layer["wv"].to(cfg.dtype)).reshape(shape)
    return q, k, v


def cached_attention(q, k_cache, v_cache, q_pos):
    """Attend (B, Tq, H, D) queries over cached positions ``<= q_pos``
    (global query positions, (Tq,) shared or (B, Tq) per sequence).  The
    causal bound alone masks every not-yet-written cache slot: masked
    scores go to ``-1e30`` and softmax to exactly 0.0 in float32, so
    whatever a masked slot holds contributes nothing.  Scores are taken in
    the compute dtype, then float32, as in the JAX module."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).float() * scale
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    if q_pos.dim() == 1:  # shared positions: (Tq, K) mask over all rows
        mask = (kpos[None, :] <= q_pos[:, None])[None, None]
    else:  # per-sequence positions: (B, 1, Tq, K)
        mask = (kpos[None, None, :] <= q_pos[:, :, None])[:, None]
    s = torch.where(mask, s, torch.tensor(_NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v_cache.float())
    return out.to(q.dtype)


def _forward_cached(params, tokens, cache, start_pos, cfg: TransformerConfig):
    """Forward ``tokens`` (B, T) writing K/V at ``start_pos ..
    start_pos+T`` of ``cache`` in place; returns ``(logits, cache)``.
    ``start_pos`` is an int (every row at the same offset — prefill) or a
    (B,) tensor (ragged decode); ``cache["length"]`` becomes (B,)."""
    b, t = tokens.shape
    dev = tokens.device
    steps = torch.arange(t, device=dev)
    ragged = torch.is_tensor(start_pos) and start_pos.dim() == 1
    if ragged:
        start = start_pos.to(device=dev, dtype=torch.long)
        positions = start[:, None] + steps  # (B, T)
        rows = torch.arange(b, device=dev)[:, None]
    else:
        start = int(start_pos)
        positions = start + steps  # (T,)
    x = params["embed"][tokens].to(cfg.dtype)
    for layer, kc, vc in zip(params["layers"], cache["k"], cache["v"]):
        h = rms_norm(x, layer["ln1"])
        q, k, v = _qkv(layer, h, cfg)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if ragged:
            kc[rows, positions] = k
            vc[rows, positions] = v
        else:
            kc[:, start:start + t] = k
            vc[:, start:start + t] = v
        attn = cached_attention(q, kc, vc, positions)
        x = x + attn.reshape(b, t, -1) @ layer["wo"].to(cfg.dtype)
        x = mlp_block(layer, x, cfg)
    logits = final_logits(params["embed"], params["ln_f"], x)
    end = start + t
    cache["length"] = (
        end.to(torch.int32) if ragged
        else torch.full((b,), end, dtype=torch.int32, device=dev)
    )
    return logits, cache


def prefill(params, tokens, cfg: TransformerConfig, max_len: int):
    """Run the prompt through the model once.  Returns
    ``(last_logits, cache)`` with a fresh cache filled for ``tokens``."""
    b, t = tokens.shape
    if t > max_len:
        raise ValueError(f"prompt length {t} exceeds max_len {max_len}")
    cache = init_kv_cache(cfg, b, max_len, tokens.device)
    logits, cache = _forward_cached(params, tokens, cache, 0, cfg)
    return logits[:, -1], cache


def prefill_suffix(params, tokens, prefix_kv, cfg: TransformerConfig,
                   max_len: int):
    """Suffix-only prefill over an already-computed prefix: run only the
    ``tokens`` (B, Ts) that follow a cached prefix whose per-layer K/V is
    ``prefix_kv = {"k": [(B, C, H, Dh)], "v": [...]}``.  Returns
    ``(last_logits, cache)`` as :func:`prefill` of the whole ``C + Ts``
    prompt would: RoPE positions and the causal mask start at ``C`` and
    the cached positions are never rewritten."""
    b, t = tokens.shape
    ks = prefix_kv["k"]
    if len(ks) != cfg.n_layers or len(prefix_kv["v"]) != cfg.n_layers:
        raise ValueError(
            f"prefix_kv holds {len(ks)} layers, model has {cfg.n_layers}"
        )
    c = int(ks[0].shape[1])
    if t < 1:
        raise ValueError("prefill_suffix needs at least one suffix token "
                         "(the last prompt token's logits come from it)")
    if c + t > max_len:
        raise ValueError(f"cached {c} + suffix {t} exceeds max_len {max_len}")
    cache = init_kv_cache(cfg, b, max_len, tokens.device)
    for kc, vc, pk, pv in zip(cache["k"], cache["v"], prefix_kv["k"],
                              prefix_kv["v"]):
        kc[:, :c] = pk
        vc[:, :c] = pv
    logits, cache = _forward_cached(params, tokens, cache, c, cfg)
    return logits[:, -1], cache


def prefill_ragged(params, tokens, lengths, cfg: TransformerConfig,
                   max_len: int):
    """Right-padded batched prefill: row ``b`` of ``tokens`` (B, T) is
    real up to ``lengths[b]`` and padding after.  Returns ``(logits,
    cache)`` with ``logits[b]`` taken at row ``b``'s LAST REAL token and
    ``cache["length"] = lengths`` — so the first decode write lands at
    each row's own length, progressively overwriting the pad K/V, and
    the causal mask keeps not-yet-overwritten pad entries invisible
    (every attended position <= q_pos has been written by then).  Decoded
    continuations are therefore exactly what each row would produce
    alone."""
    b, t = tokens.shape
    if t > max_len:
        raise ValueError(f"padded prompt length {t} exceeds max_len {max_len}")
    cache = init_kv_cache(cfg, b, max_len, tokens.device)
    logits, cache = _forward_cached(params, tokens, cache, 0, cfg)
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=tokens.device)
    last = logits[torch.arange(b, device=tokens.device), lengths.long() - 1]
    cache["length"] = lengths
    return last, cache


def decode_step(params, cache, token, cfg: TransformerConfig):
    """One decode step: ``token`` (B,) int, each row at its own position
    ``cache["length"][b]``.  Returns ``(logits, cache)`` for the next
    position; the cache is updated in place."""
    logits, cache = _forward_cached(
        params, token[:, None], cache, cache["length"], cfg
    )
    return logits[:, 0], cache


def sample_token(logits, *, temperature: float = 0.0, top_k: int | None = None,
                 generator: torch.Generator | None = None):
    """Next-token choice from (B, vocab) float32 logits.

    ``temperature <= 0`` is greedy argmax (the default; ``generator``
    unused).  Otherwise ``generator`` is required: logits are scaled by
    ``1/temperature``, optionally cut to the ``top_k`` highest (ties at the
    k-th value are all kept), and one token is drawn per row.  The same
    ``(logits, generator state)`` always yields the same token."""
    if temperature <= 0:
        if top_k is not None:
            raise ValueError("top_k requires temperature > 0")
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("temperature > 0 requires an explicit generator=")
    scaled = logits.float() / temperature
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        kth = torch.topk(scaled, min(top_k, scaled.shape[-1]), dim=-1)[0][..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(
    params,
    prompt,
    cfg: TransformerConfig,
    *,
    max_new_tokens: int,
    max_len: int | None = None,
    temperature: float = 0.0,
    top_k: int | None = None,
    generator: torch.Generator | None = None,
    stop_tokens=None,
    pad_token: int = 0,
):
    """Greedy (``temperature=0``) or sampled continuation of ``prompt``
    (B, T) -> (B, max_new_tokens) int32.  Sampling requires
    ``generator=``.

    With ``stop_tokens`` the loop ends as soon as every row has emitted a
    stop token: rows that already stopped emit ``pad_token``, and the
    return value becomes ``(tokens, lengths)`` with ``lengths`` (B,)
    counting each row's real tokens (stop token included)."""
    b, t = prompt.shape
    if max_len is None:
        max_len = t + max_new_tokens
    if t + max_new_tokens > max_len:
        raise ValueError(
            f"prompt ({t}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_len ({max_len})"
        )
    if temperature > 0 and generator is None:
        raise ValueError("temperature > 0 requires an explicit generator=")
    dev = prompt.device

    def pick(logits):
        return sample_token(logits, temperature=temperature, top_k=top_k,
                            generator=generator).to(torch.int32)

    logits, cache = prefill(params, prompt, cfg, max_len)
    tok = pick(logits)
    out = torch.full((b, max_new_tokens), pad_token, dtype=torch.int32,
                     device=dev)
    out[:, 0] = tok
    if stop_tokens is None:
        for i in range(1, max_new_tokens):
            logits, cache = decode_step(params, cache, tok, cfg)
            tok = pick(logits)
            out[:, i] = tok
        return out

    stop = torch.as_tensor(tuple(stop_tokens), dtype=torch.int32,
                           device=dev).reshape(-1)

    def hit(tok):  # (B,) bool: did this token retire its row?
        return (tok[:, None] == stop[None, :]).any(dim=1)

    done = hit(tok)
    lens = torch.ones(b, dtype=torch.int32, device=dev)
    for i in range(1, max_new_tokens):
        if bool(done.all()):
            break
        logits, cache = decode_step(params, cache, tok, cfg)
        nxt = torch.where(done, torch.full_like(tok, pad_token), pick(logits))
        out[:, i] = nxt
        lens = lens + (~done).to(torch.int32)
        done = done | hit(nxt)
        tok = nxt
    return out, lens
