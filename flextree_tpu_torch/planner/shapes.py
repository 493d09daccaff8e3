"""Shape pretty-printing: the ``2*3+1`` / ``2*2*2-1`` notation of the
reference's ``cost_model/PrintTreeStructure.h`` (and its README taxonomy),
where a trailing ``+1``/``-1`` records that the shape factorizes N∓1 and one
node is treated as extra/missing (the prime-N strategy).

A copy of ``flextree_tpu/planner/shapes.py`` (the port imports nothing of
the JAX package)."""

from __future__ import annotations

from typing import Sequence

__all__ = ["format_shape", "parse_shape", "shape_taxonomy"]


def format_shape(widths: Sequence[int], delta: int = 0) -> str:
    """``(2, 3)`` -> ``"2*3"``; with ``delta=+1`` -> ``"2*3+1"``."""
    if tuple(widths) == (1,):
        core = "ring"
    else:
        core = "*".join(str(w) for w in widths)
    if delta > 0:
        return f"{core}+{delta}"
    if delta < 0:
        return f"{core}{delta}"
    return core


def parse_shape(text: str) -> tuple[tuple[int, ...], int]:
    """Inverse of :func:`format_shape`: ``"2*3+1"`` -> ``((2, 3), 1)``."""
    text = text.strip()
    delta = 0
    for sign in ("+", "-"):
        # a trailing signed integer after the factor list
        idx = text.rfind(sign)
        if idx > 0 and text[idx + 1 :].isdigit():
            delta = int(text[idx:])
            text = text[:idx]
            break
    if text == "ring":
        return (1,), delta
    widths = tuple(int(tok) for tok in text.split("*"))
    return widths, delta


def shape_taxonomy(n: int) -> list[str]:
    """Worked-example listing for ``n`` in the reference README's style
    (``cost_model/README.md:13-71``): non-prime N lists its factorizations;
    prime N lists the factorizations of N±1 with ``+1``/``-1`` suffixes."""
    from .factorize import is_prime, ordered_factorizations

    if n < 2:
        return []
    if not is_prime(n):
        return [format_shape(w) for w in ordered_factorizations(n)]
    out = [format_shape(w, +1) for w in ordered_factorizations(n - 1)]
    out += [format_shape(w, -1) for w in ordered_factorizations(n + 1)]
    return out
