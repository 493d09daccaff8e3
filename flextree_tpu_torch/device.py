"""Device selection for the port's entry points, and the data-sheet peaks
of the cards it measures on."""

from __future__ import annotations

import torch

__all__ = ["CARDS", "card_peaks", "chip_peak_tflops", "memory_rate",
           "resolve_device"]

#: Per card, by a key of the name ``torch.cuda.get_device_name`` reports
#: (the first key found in the name wins, so the longer names come
#: first): the memory rate (bytes/s), the float32 peak off the tensor
#: cores and the bf16 tensor-core peak (FLOP/s), from NVIDIA's data
#: sheets (dense, the full power limit).
CARDS = (
    ("H200", 4.8e12, 67e12, 989e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100", 3.35e12, 67e12, 989e12),
)


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


def _lookup(name: str) -> tuple[float, float, float] | None:
    return next((tuple(p) for key, *p in CARDS if key in name), None)


def card_peaks(name: str) -> tuple[float, float, float]:
    """``(memory rate, float32 peak, bf16 tensor-core peak)`` of the card
    named ``name``; raises for a card not in :data:`CARDS`."""
    peaks = _lookup(name)
    if peaks is None:
        raise RuntimeError(f"no peak rates recorded for card {name!r}")
    return peaks


def _peaks(device) -> tuple[float, float, float] | None:
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return _lookup(torch.cuda.get_device_name(device))


def memory_rate(device) -> float | None:
    """The memory rate (bytes/s) of ``device``'s card, or None on the CPU
    or for a card not in :data:`CARDS`."""
    peaks = _peaks(device)
    return peaks[0] if peaks else None


def chip_peak_tflops(dtype, device) -> float | None:
    """Peak TFLOP/s of the units the port's kernels run on in ``dtype``:
    bf16 on the tensor cores, float32 on the float32 cores (the flash
    kernels' routes, ``ops/flash_attention.py``).  None on the CPU or for
    a card not in :data:`CARDS`, so an MFU is then not reported (as the
    JAX package reports none off a TPU)."""
    peaks = _peaks(device)
    if peaks is None:
        return None
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype == torch.bfloat16:
        return peaks[2] / 1e12
    if dtype == torch.float32:
        return peaks[1] / 1e12
    return None
