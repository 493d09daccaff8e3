"""Host-level convenience wrappers: run FlexTree collectives over a mesh of
ranks in one process.

PyTorch counterpart of ``flextree_tpu/parallel/mesh.py``.  The reference's
benchmark takes per-rank buffers already living on N processes
(``benchmark.cpp:119-153``); the JAX package stands in for that with a
stacked ``(N, ...)`` array laid out one row per device of a mesh, reduced
under ``shard_map``.  The port does the same with a :class:`Mesh`: an
ordered tuple of N devices, one per rank, in one process.  Ranks may share
a device — on one card every rank is ``cuda:0`` — so a mesh of N ranks
runs anywhere; messages between ranks become device copies (see
:mod:`.allreduce`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..schedule.stages import Topology

__all__ = ["Mesh", "flat_mesh", "allreduce_over_mesh", "topology_from_mesh"]


@dataclass(frozen=True)
class Mesh:
    """N ranks in one process: ``devices[r]`` holds rank ``r``'s buffers.

    ``shape``/``axis_names`` describe a logical multi-axis layout of the
    ranks (row-major, the last axis fastest), as a JAX mesh does; a flat
    mesh has one axis of size N.
    """

    devices: tuple
    axis_names: tuple = ("ft",)
    shape: tuple | None = None

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        object.__setattr__(self, "devices", devs)
        if not devs:
            raise ValueError("a mesh needs at least one rank")
        shape = (len(devs),) if self.shape is None else tuple(self.shape)
        object.__setattr__(self, "shape", shape)
        if math.prod(shape) != len(devs) or len(shape) != len(self.axis_names):
            raise ValueError(
                f"mesh shape {shape} with axes {self.axis_names} does not "
                f"fit {len(devs)} ranks")

    @property
    def size(self) -> int:
        return len(self.devices)


def flat_mesh(n: int, device=None, axis_name: str = "ft") -> Mesh:
    """A 1-D mesh of ``n`` ranks.  ``device`` is one device that every rank
    shares (default ``cuda``; ``"cpu"`` to run on the host) or a sequence
    of ``n`` devices, one per rank."""
    if n < 1:
        raise ValueError(f"asked for {n} ranks")
    if isinstance(device, (list, tuple)):
        if len(device) != n:
            raise ValueError(f"{len(device)} devices for {n} ranks")
        devs = tuple(resolve_device(d) for d in device)
    else:
        devs = (resolve_device(device),) * n
    return Mesh(devs, (axis_name,))


def topology_from_mesh(mesh: Mesh, axis_name=None) -> Topology:
    """Derive stage widths from the mesh's shape: one stage per mesh axis,
    width = axis size (axes of size 1 dropped); a 1-D mesh gives the flat
    topology.  ``axis_name`` restricts to one axis or a tuple of axes."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    if axis_name is not None:
        names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        widths = tuple(sizes[a] for a in names)
    else:
        widths = tuple(mesh.shape)
    n = math.prod(widths)
    if n == 1:
        return Topology.flat(1)
    widths = tuple(w for w in widths if w > 1) or (n,)
    return Topology(n, widths)


def allreduce_over_mesh(stacked: torch.Tensor, mesh: Mesh, topo=None,
                        op="sum", in_place: bool = False, chunks: int = 1
                        ) -> torch.Tensor:
    """Allreduce a stacked ``(N, ...)`` tensor: row ``i`` is rank ``i``'s
    buffer; every output row is the full reduction.

    The analog of the reference benchmark calling ``MPI_Allreduce_FT`` on
    each rank's local buffer (``benchmark.cpp:153``).  Every rank's
    device must be ``stacked``'s device.  ``in_place=True`` writes the
    result into ``stacked`` and returns it — the ``MPI_IN_PLACE`` path
    (``mpi_mod.hpp:1193-1215``): the input is consumed and no output is
    allocated; otherwise the result goes into a new tensor.
    """
    from .allreduce import allreduce

    n = mesh.size
    if stacked.dim() < 1 or stacked.shape[0] != n:
        raise ValueError(
            f"stacked.shape[0]={stacked.shape[0] if stacked.dim() else None}"
            f" must equal the mesh's {n} ranks")
    if any(d != stacked.device for d in mesh.devices):
        raise ValueError(f"stacked lives on {stacked.device}; the mesh's "
                         f"ranks on {sorted(set(map(str, mesh.devices)))}")
    if in_place and not stacked.is_contiguous():
        raise ValueError("in_place=True needs a contiguous stacked tensor")
    out = stacked if in_place else torch.empty_like(
        stacked, memory_format=torch.contiguous_format)
    rows = list(stacked.unbind(0))
    allreduce(rows, mesh, topo=topo, op=op, chunks=chunks,
              out=list(out.unbind(0)))
    return out
