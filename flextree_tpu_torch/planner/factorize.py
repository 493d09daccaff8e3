"""Candidate tree-shape enumeration: ordered factorizations of N.

A copy of ``flextree_tpu/planner/factorize.py`` (the port imports nothing
of the JAX package).

Rebuilds the reference planner's enumeration layer
(``cost_model/GetWidth.h:7-47`` ``getWidth`` — DFS over divisors — and
``topo_count/factor_count.py`` — the search-space counter) without its
global mutable accumulators (``GetWidth.h:7-8``, known-bug list SURVEY §8).

The reference's legacy second enumerator (``getWidth2``,
``GetWidth.h:51-227``: candidates as products of prime-factor subsets, 9
nested loop levels, and a ``d[p]*d[q]`` typo at ``:198`` that corrupts the
last factor) is rebuilt here as
:func:`ordered_factorizations_combinatoric` — the same combinatoric route
(multiset factorizations from the prime decomposition, then distinct
permutations), depth-unlimited and typo-free, cross-validated against the
DFS enumerator in the JAX package's ``tests/test_planner.py``.

Also provides primality / prime-factorization utilities
(``cost_model/IsPrimeNumber.h``, ``GetPrimeFactor.h``), fixing the
reference's ``is_prime(1) == True`` bug.
"""

from __future__ import annotations

import functools


__all__ = [
    "is_prime",
    "prime_factors",
    "ordered_factorizations",
    "ordered_factorizations_combinatoric",
    "count_ordered_factorizations",
]


def is_prime(n: int) -> bool:
    """Primality by trial division (``IsPrimeNumber.h:4-21``); unlike the
    reference, 1 is correctly not prime."""
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    f = 3
    while f * f <= n:
        if n % f == 0:
            return False
        f += 2
    return True


def prime_factors(n: int) -> list[int]:
    """Multiset of prime factors in ascending order
    (``GetPrimeFactor.h:5-19``)."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    out = []
    f = 2
    while f * f <= n:
        while n % f == 0:
            out.append(f)
            n //= f
        f += 1 if f == 2 else 2
    if n > 1:
        out.append(n)
    return out


def ordered_factorizations(n: int, min_factor: int = 2) -> list[tuple[int, ...]]:
    """All ordered factorizations of ``n`` into factors >= ``min_factor``,
    including the single-factor shape ``(n,)`` — the candidate stage-width
    vectors for ``n`` devices (``GetWidth.h:7-47``).

    Order matters: ``(2, 4)`` and ``(4, 2)`` are distinct tree shapes (a
    wide-then-narrow tree communicates differently than narrow-then-wide).
    """
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if n == 1:
        return []
    out: list[tuple[int, ...]] = []

    def dfs(rest: int, prefix: tuple[int, ...]):
        # every proper divisor d (min_factor <= d < rest) can lead; collect
        # both members of each divisor pair around sqrt(rest)
        divs = set()
        d = min_factor
        while d * d <= rest:
            if rest % d == 0:
                divs.add(d)
                divs.add(rest // d)
            d += 1
        divs.discard(rest)
        for d in sorted(divs):
            dfs(rest // d, prefix + (d,))
        out.append(prefix + (rest,))

    dfs(n, ())
    return out


def ordered_factorizations_combinatoric(
    n: int, min_factor: int = 2
) -> list[tuple[int, ...]]:
    """The P2 rebuild: the same candidate set as
    :func:`ordered_factorizations`, derived the way the reference's legacy
    ``getWidth2`` tried to (``GetWidth.h:51-227``) — *unordered* multiset
    factorizations built from the prime decomposition, expanded into their
    distinct orderings — rather than by divisor DFS.

    Differences from the reference, on purpose: depth-unlimited (theirs
    hardcoded 9 nested subset levels), no ``d[p]*d[q]`` typo
    (``GetWidth.h:198`` draws the final factor from the wrong array,
    corrupting candidates once >= 3 factor groups are in play), and no
    flat/ring sentinel rows (``{1,N}``/``{N,1}``, ``:207-225``) — sentinel
    handling lives in :class:`~..schedule.stages.Topology`
    parsing, not in the enumeration.  Returns a sorted list (deterministic,
    unlike the reference's insertion order); equality with the DFS
    enumerator is pinned by ``tests/test_planner.py``.
    """
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if n == 1:
        return []

    def multisets(rest: int, max_f: int) -> list[tuple[int, ...]]:
        """Non-increasing factorizations of ``rest`` with factors
        <= ``max_f`` (each a multiset of divisors >= min_factor)."""
        out = []
        if min_factor <= rest <= max_f:
            out.append((rest,))
        d = min(max_f, rest // min_factor)
        while d >= min_factor:
            if rest % d == 0:
                for tail in multisets(rest // d, d):
                    out.append((d,) + tail)
            d -= 1
        return out

    def distinct_orderings(counts: dict[int, int], length: int):
        """All distinct permutations of a factor multiset, generated
        directly from its counts — multinomial cost, not the factorial
        blow-up of ``itertools.permutations`` on repeated factors (at
        n=4096 the (2,)*12 multiset has ONE ordering, not 12! duplicates
        to dedup)."""
        if length == 0:
            yield ()
            return
        for f in counts:
            if counts[f]:
                counts[f] -= 1
                for tail in distinct_orderings(counts, length - 1):
                    yield (f,) + tail
                counts[f] += 1

    shapes: list[tuple[int, ...]] = []
    for ms in multisets(n, n):
        counts: dict[int, int] = {}
        for f in ms:
            counts[f] = counts.get(f, 0) + 1
        shapes.extend(distinct_orderings(counts, len(ms)))
    return sorted(shapes)


@functools.lru_cache(maxsize=4096)
def count_ordered_factorizations(n: int) -> int:
    """Search-space size — the analog of
    ``topo_count/factor_count.py:1-11``, memoized instead of exponential."""
    if n <= 1:
        return 0

    # f(n) = 1 + sum over divisors d of n (2 <= d < n) of f(n/d):
    # pick the first stage width d, recurse on the rest.  Divisor pairs
    # (d, n/d) around sqrt(n) cover the whole divisor set.
    @functools.lru_cache(maxsize=None)
    def f(rest: int) -> int:
        total = 1  # the single-stage shape (rest,)
        d = 2
        while d * d <= rest:
            if rest % d == 0:
                total += f(rest // d)  # first factor d
                if d != rest // d:
                    total += f(d)  # first factor rest//d
            d += 1
        return total

    return f(n)
