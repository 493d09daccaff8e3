"""Stage-width ("topology") handling for hierarchical allreduce.

A copy of ``flextree_tpu/schedule/stages.py`` (the port imports nothing of
the JAX package).

A *topology* is a vector of per-level tree widths ``[w0, w1, ..., wk]`` with
``prod(wi) == N`` devices.  Each level performs a width-``wi`` grouped
reduce-scatter; the levels then unwind in reverse as an allgather.

Special cases (mirroring the reference semantics of
``allreduce_over_mpi/mpi_mod.hpp:882-929`` / ``get_stages``):

- width vector ``[N]``        -> flat one-stage allreduce (the default)
- ``[2, 2, ..., 2]``          -> recursive halving-doubling
- any width ``1`` anywhere    -> collapse to ``[1]`` = use the ring algorithm
- product != N                -> hard error (the reference aborts;
                                 ``mpi_mod.hpp:914-918``) — UNLESS the spec
                                 carries a ``+k`` suffix, which resolves to
                                 a ``LonelyTopology`` (tree over N-k ranks
                                 plus k buddy-folded lonely ranks; the
                                 reference's disabled design, executable
                                 here)

The environment variable ``FT_TOPO`` (comma-separated widths, e.g. ``"4,2"``)
is honoured for drop-in compatibility with the reference
(``mpi_mod.hpp:885``).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

__all__ = [
    "Topology",
    "LonelyTopology",
    "TopologyError",
    "parse_topo",
    "split_lonely_spec",
    "get_stages",
    "FT_TOPO_ENV",
]

FT_TOPO_ENV = "FT_TOPO"


class TopologyError(ValueError):
    """Raised for invalid stage-width vectors (product mismatch, bad values)."""


def parse_topo(spec: str) -> tuple[int, ...]:
    """Parse a comma-separated width spec like ``"4,2"`` into ``(4, 2)``.

    Mirrors the reference's tokenizer (``mpi_mod.hpp:888-907``): whitespace is
    tolerated, empty string yields an empty tuple (meaning "flat default").
    """
    spec = spec.strip()
    if not spec:
        return ()
    out = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        try:
            out.append(int(tok))
        except ValueError as e:
            raise TopologyError(f"bad width token {tok!r} in topo spec {spec!r}") from e
    return tuple(out)


def split_lonely_spec(spec: str) -> tuple[str, int]:
    """Split a ``"4,2+1"``-style spec into (``"4,2"``, 1).

    The ``+k`` suffix is the reference planner's own notation for shapes
    with ``k`` nodes outside the factorized tree
    (``cost_model/PrintTreeStructure.h``: ``2*3+1``); the reference runtime
    never executed them (its lonely-node code is commented out,
    ``mpi_mod.hpp:983-1086``) — ours does (``LonelyTopology``).
    """
    spec = spec.strip()
    if "+" not in spec:
        return spec, 0
    base, _, tail = spec.rpartition("+")
    try:
        lonely = int(tail.strip())
    except ValueError as e:
        raise TopologyError(f"bad lonely count {tail!r} in spec {spec!r}") from e
    if lonely < 0:
        raise TopologyError(f"lonely count must be >= 0, got {lonely}")
    return base.strip(), lonely


def get_stages(num_nodes: int, spec: str | None = None) -> tuple[int, ...]:
    """Resolve the stage widths for ``num_nodes`` devices.

    ``spec`` defaults to the ``FT_TOPO`` environment variable.  Reference
    semantics (``mpi_mod.hpp:882-929``):

    - empty / unset -> ``(num_nodes,)`` (flat, single stage)
    - any ``1`` in the vector -> ``(1,)``  (ring algorithm sentinel)
    - otherwise the product must equal ``num_nodes`` or we raise.
    """
    if num_nodes < 1:
        raise TopologyError(f"num_nodes must be >= 1, got {num_nodes}")
    if spec is None:
        spec = os.environ.get(FT_TOPO_ENV, "")
    widths = parse_topo(spec) if isinstance(spec, str) else tuple(spec)
    if not widths:
        return (num_nodes,)
    if any(w < 1 for w in widths):
        raise TopologyError(f"widths must be positive, got {widths}")
    if any(w == 1 for w in widths):
        return (1,)
    if math.prod(widths) != num_nodes:
        raise TopologyError(
            f"product of widths {widths} is {math.prod(widths)}, "
            f"but num_nodes is {num_nodes}"
        )
    return widths


@dataclass(frozen=True)
class Topology:
    """A validated hierarchical-allreduce tree shape over ``num_nodes`` devices.

    ``widths[i]`` is the group width at stage ``i``; ``gaps[i]`` is the rank
    stride between members of a stage-``i`` group, i.e. ``prod(widths[:i])``
    (the reference's running ``gap`` in ``Send_Ops::generate_ops``,
    ``mpi_mod.hpp:158-170``).

    ``is_ring`` marks the sentinel shape ``(1,)`` which selects the ring
    algorithm instead of the tree (``mpi_mod.hpp:1194``).
    """

    num_nodes: int
    widths: tuple[int, ...]
    gaps: tuple[int, ...] = field(init=False)

    def __post_init__(self):
        widths = tuple(int(w) for w in self.widths)
        object.__setattr__(self, "widths", widths)
        if self.num_nodes < 1:
            raise TopologyError(f"num_nodes must be >= 1, got {self.num_nodes}")
        if widths == (1,):
            object.__setattr__(self, "gaps", (1,))
            return
        if not widths:
            raise TopologyError("widths must be non-empty")
        if any(w < 2 for w in widths):
            raise TopologyError(
                f"tree widths must all be >= 2 (got {widths}); "
                "use widths=(1,) for the ring algorithm"
            )
        if math.prod(widths) != self.num_nodes:
            raise TopologyError(
                f"product of widths {widths} is {math.prod(widths)}, "
                f"but num_nodes is {self.num_nodes}"
            )
        gaps, g = [], 1
        for w in widths:
            gaps.append(g)
            g *= w
        object.__setattr__(self, "gaps", tuple(gaps))

    # -- constructors ------------------------------------------------------

    @classmethod
    def flat(cls, num_nodes: int) -> "Topology":
        """Single-stage all-to-all-blocks allreduce (reference default)."""
        return cls(num_nodes, (num_nodes,))

    @classmethod
    def ring(cls, num_nodes: int) -> "Topology":
        """Ring-algorithm sentinel, the reference's ``FT_TOPO`` containing 1."""
        return cls(num_nodes, (1,))

    @classmethod
    def halving_doubling(cls, num_nodes: int) -> "Topology":
        """Recursive halving-doubling: widths ``(2, 2, ..., 2)``."""
        widths = []
        n = num_nodes
        while n % 2 == 0 and n > 1:
            widths.append(2)
            n //= 2
        if n != 1:
            raise TopologyError(
                f"halving-doubling needs a power-of-2 device count, got {num_nodes}"
            )
        return cls(num_nodes, tuple(widths))

    @classmethod
    def from_env(cls, num_nodes: int, spec: str | None = None) -> "Topology":
        """Build from an ``FT_TOPO``-style spec (default: the env var)."""
        return cls(num_nodes, get_stages(num_nodes, spec))

    @classmethod
    def resolve(cls, num_nodes: int, topo=None):
        """Coerce ``topo`` (None | Topology | LonelyTopology | width
        sequence | spec string) — specs with a ``+k`` suffix (``"4,2+1"``)
        resolve to a ``LonelyTopology``."""
        if topo is None:
            topo = os.environ.get(FT_TOPO_ENV, "")
        if isinstance(topo, LonelyTopology):
            if topo.num_nodes != num_nodes:
                raise TopologyError(
                    f"topology is for {topo.num_nodes} nodes, mesh has {num_nodes}"
                )
            return topo
        if isinstance(topo, Topology):
            if topo.num_nodes != num_nodes:
                raise TopologyError(
                    f"topology is for {topo.num_nodes} nodes, mesh has {num_nodes}"
                )
            return topo
        if isinstance(topo, str):
            base, lonely = split_lonely_spec(topo)
            if lonely:
                tree = cls(
                    num_nodes - lonely, get_stages(num_nodes - lonely, base)
                )
                return LonelyTopology(num_nodes, tree, lonely)
            return cls(num_nodes, get_stages(num_nodes, base))
        widths = tuple(int(w) for w in topo)
        if any(w == 1 for w in widths):
            return cls.ring(num_nodes)
        return cls(num_nodes, widths)

    # -- properties --------------------------------------------------------

    @property
    def is_ring(self) -> bool:
        return self.widths == (1,)

    @property
    def num_stages(self) -> int:
        return len(self.widths)

    @property
    def message_steps(self) -> int:
        """Point-to-point rounds: ``2*sum(wi-1)`` for the tree, ``2(N-1)`` ring."""
        if self.is_ring:
            return 2 * (self.num_nodes - 1)
        return 2 * sum(w - 1 for w in self.widths)

    def group_members(self, stage: int, rank: int) -> tuple[int, ...]:
        """Ranks in ``rank``'s stage-``stage`` group.

        The group of rank ``r`` at stage ``i`` with width ``w`` and gap ``g``
        is ``{base + j*g : j in [0, w)}`` where
        ``base = (r // (g*w)) * (g*w) + r % g`` (``mpi_mod.hpp:162, 198``).
        """
        g, w = self.gaps[stage], self.widths[stage]
        base = (rank // (g * w)) * (g * w) + rank % g
        return tuple(base + j * g for j in range(w))

    def groups(self, stage: int) -> list[list[int]]:
        """All stage-``stage`` groups, each a sorted list of ranks.

        This is exactly the ``axis_index_groups`` argument that
        ``lax.psum_scatter`` / ``lax.all_gather`` expect for this stage.
        """
        out = []
        for r in range(self.num_nodes):
            m = self.group_members(stage, r)
            if m[0] == r:  # emit once, from the group's minimum member
                out.append(list(m))
        return out

    def __str__(self) -> str:
        return "*".join(str(w) for w in self.widths)


@dataclass(frozen=True)
class LonelyTopology:
    """A tree over ``num_nodes - lonely`` ranks plus ``lonely`` ranks
    outside it — the reference's conceived-but-disabled lonely-node design
    (``mpi_mod.hpp:77``: nodes beyond the factorized tree "sync in parallel
    with the tree"; all its call sites are commented out, SURVEY §2.1)
    made executable, TPU-style:

    - each lonely rank ``m + i`` pairs with buddy rank ``i`` in the tree;
    - pre-phase: one ``ppermute`` moves every lonely payload to its buddy,
      which folds it in (so the tree reduces all ``num_nodes``
      contributions);
    - the tree allreduce runs over the first ``m`` ranks (via the
      ppermute-ring stage machinery — XLA's grouped collectives demand
      equal-size groups, which lonely ranks would break);
    - post-phase: one ``ppermute`` hands each buddy's full result back.

    This is what turns the planner's prime-N "resize to N±1" *advisory*
    (``ChooseWidth.h:16-21``) into a runnable shape: N=7 can execute
    ``"3,2+1"`` instead of being told to use 6 chips.
    """

    num_nodes: int
    tree: Topology
    lonely: int

    def __post_init__(self):
        if self.lonely < 1:
            raise TopologyError(
                f"lonely must be >= 1, got {self.lonely} (use Topology)"
            )
        if self.tree.is_ring:
            raise TopologyError("lonely ranks require a tree, not the ring")
        if self.tree.num_nodes + self.lonely != self.num_nodes:
            raise TopologyError(
                f"tree over {self.tree.num_nodes} + {self.lonely} lonely "
                f"!= {self.num_nodes} nodes"
            )
        if self.lonely > self.tree.num_nodes:
            raise TopologyError(
                f"{self.lonely} lonely ranks need {self.lonely} distinct "
                f"buddies but the tree has only {self.tree.num_nodes}"
            )

    @property
    def is_ring(self) -> bool:
        return False

    @property
    def widths(self) -> tuple[int, ...]:
        return self.tree.widths

    @property
    def num_stages(self) -> int:
        return self.tree.num_stages

    @property
    def message_steps(self) -> int:
        """Tree rounds plus the two buddy exchanges."""
        return self.tree.message_steps + 2

    def __str__(self) -> str:
        return f"{self.tree}+{self.lonely}"
