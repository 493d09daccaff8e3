"""The dense LM and its generation loop (serving half of the JAX package's
``flextree_tpu.models``)."""

from .generate import (
    cached_attention,
    decode_step,
    generate,
    init_kv_cache,
    prefill,
    prefill_suffix,
    sample_token,
)
from .transformer import (
    TransformerConfig,
    apply_rope,
    cast_params,
    final_logits,
    forward,
    init_params,
    mlp_block,
    rms_norm,
)

__all__ = [
    "TransformerConfig",
    "init_params",
    "cast_params",
    "rms_norm",
    "apply_rope",
    "mlp_block",
    "final_logits",
    "forward",
    "init_kv_cache",
    "cached_attention",
    "prefill",
    "prefill_suffix",
    "decode_step",
    "sample_token",
    "generate",
]
