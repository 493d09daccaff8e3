"""The dense LM, its loss and its generation loop (the JAX package's
``flextree_tpu.models`` without the MoE model)."""

from .generate import (
    cached_attention,
    decode_step,
    generate,
    init_kv_cache,
    prefill,
    prefill_ragged,
    prefill_suffix,
    sample_token,
)
from .transformer import (
    TransformerConfig,
    apply_rope,
    attention_block,
    cast_params,
    cross_entropy_loss,
    final_logits,
    forward,
    init_params,
    layer_forward,
    mlp_block,
    param_specs,
    rms_norm,
)

__all__ = [
    "TransformerConfig",
    "init_params",
    "param_specs",
    "cast_params",
    "rms_norm",
    "apply_rope",
    "attention_block",
    "layer_forward",
    "mlp_block",
    "final_logits",
    "forward",
    "cross_entropy_loss",
    "init_kv_cache",
    "cached_attention",
    "prefill",
    "prefill_suffix",
    "prefill_ragged",
    "decode_step",
    "sample_token",
    "generate",
]
