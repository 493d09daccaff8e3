"""Device inventory: which chips exist, who holds each one.

The port's copy of ``flextree_tpu/arbiter/inventory.py``.

The inventory is the arbiter's in-memory model of the machine's chips —
a chip is an opaque id (a device index, an in-process mesh rank or a
serving replica's slot; any stable token works) with exactly one holder at a time: ``"train"``,
``"serve"``, or ``"arbiter"`` (parked mid-handoff).  Every mutation is a
whole-set move with loud failure on a chip that is not where the caller
thinks it is — the single-assignment invariant is what the lease ledger
publishes, so it must be impossible to corrupt here first.
"""

from __future__ import annotations

from ..runtime.leases import ARBITER, SERVE, TRAIN

__all__ = ["DeviceInventory"]

_HOLDERS = (TRAIN, SERVE, ARBITER)


class DeviceInventory:
    """Single-assignment chip ownership with whole-set moves.

    ``grants()`` is the ledger-shaped view (holder → sorted chip tuple);
    :meth:`move` relocates a specific chip set and refuses partial or
    misattributed moves, so a bookkeeping bug surfaces as a raise, never
    as a chip silently counted twice.
    """

    def __init__(self, chips, *, train=None):
        chips = tuple(chips)
        if len(set(chips)) != len(chips):
            raise ValueError(f"duplicate chip ids in inventory: {chips}")
        if not chips:
            raise ValueError("an inventory needs at least one chip")
        train = tuple(chips if train is None else train)
        unknown = [c for c in train if c not in chips]
        if unknown:
            raise ValueError(f"train grant names unknown chips: {unknown}")
        self._holder = {c: (TRAIN if c in train else SERVE) for c in chips}

    @classmethod
    def from_grants(cls, grants: dict) -> "DeviceInventory":
        """Rebuild an inventory from a ledger-shaped grants dict (holder
        → chip iterable) — the arbiter-restart path: the last published
        ledger IS the surviving truth about who holds what, parked
        (``"arbiter"``) chips included, which the ``train=`` constructor
        cannot express."""
        holder: dict = {}
        for h, chips in grants.items():
            if h not in _HOLDERS:
                raise ValueError(f"unknown holder {h!r} in grants")
            for c in chips:
                if c in holder:
                    raise ValueError(
                        f"chip {c!r} granted to both {holder[c]!r} and {h!r}"
                    )
                holder[c] = h
        if not holder:
            raise ValueError("an inventory needs at least one chip")
        inv = cls.__new__(cls)
        inv._holder = holder
        return inv

    @property
    def chips(self) -> tuple:
        return tuple(sorted(self._holder))

    def held_by(self, holder: str) -> tuple:
        if holder not in _HOLDERS:
            raise ValueError(f"unknown holder {holder!r}")
        return tuple(sorted(c for c, h in self._holder.items() if h == holder))

    def holder_of(self, chip) -> str:
        try:
            return self._holder[chip]
        except KeyError:
            raise ValueError(f"chip {chip!r} is not in the inventory") from None

    def move(self, chips, src: str, dst: str) -> tuple:
        """Move ``chips`` from ``src`` to ``dst`` — all or nothing."""
        if src not in _HOLDERS or dst not in _HOLDERS:
            raise ValueError(f"unknown holder in move {src!r} -> {dst!r}")
        chips = tuple(chips)
        for c in chips:
            h = self.holder_of(c)
            if h != src:
                raise ValueError(
                    f"chip {c!r} is held by {h!r}, not {src!r} — refusing "
                    "the whole move"
                )
        for c in chips:
            self._holder[c] = dst
        return tuple(sorted(chips))

    def take(self, holder: str, k: int, *, keep: int = 0) -> tuple:
        """Park up to ``k`` of ``holder``'s chips on the arbiter (the
        revocation half of a handoff), never leaving fewer than ``keep``.
        Returns the chips actually taken (possibly empty)."""
        held = self.held_by(holder)
        k = max(0, min(k, len(held) - keep))
        taken = held[len(held) - k:]  # take from the tail: stable ids keep
        return self.move(taken, holder, ARBITER) if taken else ()

    def grants(self) -> dict:
        """The ledger-shaped view: holder → sorted chip tuple (holders
        with no chips included, so a reader sees explicit emptiness)."""
        return {h: self.held_by(h) for h in _HOLDERS}
