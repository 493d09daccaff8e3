"""Full-sequence-local attention and its implementation switch.

The part of ``flextree_tpu/parallel/ring_attention.py`` that one device
runs: :func:`local_attention`, the single switch between the full-matrix
reference and the flash kernels that the model forward shares, and
:func:`attention_reference`, the full-matrix oracle.  The ring itself
(K/V blocks walking a sequence-parallel axis) waits on the collectives
and comes with sequence parallelism (ROADMAP.md, Queue 1: "Sequence,
pipeline and expert parallelism").
"""

from __future__ import annotations

import torch

__all__ = ["attention_reference", "local_attention"]


def attention_reference(q, k, v, *, causal: bool = True,
                        scale: float | None = None):
    """Single-device full-matrix causal attention on (B, T, H, D) at the
    default ``1/sqrt(D)`` scale: ``models.generate.cached_attention`` over
    the sequence's own positions.  The model calls nothing else; a
    non-causal call or a custom scale raises."""
    from ..models.generate import cached_attention

    if not causal or scale is not None:
        raise NotImplementedError(
            f"attention_reference is causal at the default scale; got "
            f"causal={causal}, scale={scale}"
        )
    return cached_attention(q, k, v, torch.arange(q.shape[1],
                                                  device=q.device))


def local_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, impl: str = "reference",
                    **flash_kwargs):
    """Full-sequence-local attention by implementation name:
    ``"reference"`` (:func:`attention_reference`) or ``"flash"``
    (:func:`..ops.flash_attention.flash_attention`, the CUDA kernels on a
    CUDA tensor).  ``flash_kwargs`` (``block_q``, ``block_k``,
    ``variant``, ...) go to the flash kernel; the reference impl has no
    such knobs and rejects them."""
    if impl == "flash":
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, scale=scale,
                               **flash_kwargs)
    if flash_kwargs:
        raise TypeError(
            f"attention impl {impl!r} takes no flash kwargs: "
            f"{sorted(flash_kwargs)}"
        )
    if impl == "reference":
        return attention_reference(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")
