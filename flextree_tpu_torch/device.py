"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Asking for ``cuda`` (explicitly or by default) on a
    machine without a GPU raises — the port never falls back to the CPU
    on its own; pass ``device="cpu"`` to run there.  A CUDA device comes
    back with its index (``cuda`` is the current device), as the tensors
    made on it report theirs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --cpu) "
            "to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
