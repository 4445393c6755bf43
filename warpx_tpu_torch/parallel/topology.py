"""Rank-mesh spatial decomposition.

The counterpart of ``warpx_tpu.parallel.topology`` (the reference's
BoxArray + DistributionMapping, Source/Parallelization/): the ranks of a
``torch.distributed`` process group laid out as a mesh whose axes are
spatial dimensions, one equal-size block of the grid per rank.  Rank ``r``
sits at the C-order position ``r`` of the mesh in the order of the mesh
dict, as device ``r`` of ``np.array(devices).reshape(...)`` does in the
JAX package; halos and particles move between face neighbours by
point-to-point messages (``parallel/halo.py``, ``parallel/particles.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["SpatialMesh", "rank_device"]


@dataclasses.dataclass(frozen=True)
class SpatialMesh:
    """A mesh of ranks over a subset of the spatial axes.

    ``axis_shards`` lists (axis name 'x'/'y'/'z', number of shards) in the
    mesh's order; unlisted axes are unsharded.  ``rank`` is this process's
    rank in ``group`` (None: the default group); ``global_ranks[r]`` is the
    default group's rank of the group's rank ``r``, which point-to-point
    messages address.
    """

    axis_shards: Tuple[Tuple[str, int], ...]
    rank: int = 0
    group: Optional[object] = None
    global_ranks: Tuple[int, ...] = (0,)

    @classmethod
    def create(cls, shape: Dict[str, int], group=None) -> "SpatialMesh":
        """The mesh ``shape`` over the ranks of ``group`` (the default
        group when None), whose size must be the mesh's."""
        if not dist.is_initialized():
            raise RuntimeError(
                "SpatialMesh needs an initialized torch.distributed process "
                "group (one rank per device)")
        items = tuple((str(a), int(s)) for a, s in shape.items())
        n = int(np.prod([s for _, s in items])) if items else 1
        world = dist.get_world_size(group)
        if n != world:
            raise ValueError(f"mesh {shape} needs {n} ranks, the process "
                             f"group has {world}")
        ranks = tuple(dist.get_global_rank(group, r) if group is not None
                      else r for r in range(world))
        return cls(axis_shards=items, rank=dist.get_rank(group), group=group,
                   global_ranks=ranks)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axis_shards)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.axis_shards) or (1,)

    def n_shards(self, axis: str) -> int:
        for a, s in self.axis_shards:
            if a == axis:
                return s
        return 1

    @property
    def total_shards(self) -> int:
        return (int(np.prod([s for _, s in self.axis_shards]))
                if self.axis_shards else 1)

    def coords(self, rank: int | None = None) -> Dict[str, int]:
        """The mesh coordinate of ``rank`` (default: this rank) per axis."""
        r = self.rank if rank is None else rank
        idx = np.unravel_index(r, self.shape)
        return {a: int(i) for (a, _), i in zip(self.axis_shards, idx)}

    def rank_of(self, coords: Dict[str, int]) -> int:
        return int(np.ravel_multi_index(
            [coords[a] for a in self.axis_names] or [0], self.shape))

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 when unsharded), the
        counterpart of ``lax.axis_index``."""
        return self.coords().get(axis, 0)

    def neighbor(self, axis: str, shift: int) -> int:
        """The group rank ``shift`` places along ``axis`` (a ring)."""
        c = self.coords()
        c[axis] = (c[axis] + shift) % self.n_shards(axis)
        return self.rank_of(c)

    def local_n_cell(self, geom) -> Tuple[int, ...]:
        out = []
        for d, ax in enumerate(geom.axis_names):
            s = self.n_shards(ax)
            if geom.n_cell[d] % s:
                raise ValueError(
                    f"n_cell[{ax}]={geom.n_cell[d]} not divisible by {s} shards"
                )
            out.append(geom.n_cell[d] // s)
        return tuple(out)

    def block_slices(self, geom, rank: int | None = None):
        """The slices of the global grid that ``rank``'s block covers."""
        local = self.local_n_cell(geom)
        c = self.coords(rank)
        return tuple(slice(c.get(ax, 0) * n, (c.get(ax, 0) + 1) * n)
                     for ax, n in zip(geom.axis_names, local))


def rank_device(device=None, group=None):
    """The device of this rank's simulation: ``device`` as given, else
    ``cuda:$LOCAL_RANK`` (the rank modulo the card count when LOCAL_RANK is
    unset); a card becomes the process's current device, as NCCL's
    point-to-point calls need.  Raises with no card, and where the group's
    backend cannot carry the device's tensors (NCCL for CUDA, gloo for the
    CPU): a CUDA run never moves its tensors to the host to
    communicate."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "ranks on the CPU over gloo")
        local = os.environ.get("LOCAL_RANK")
        idx = (int(local) if local is not None
               else dist.get_rank() if dist.is_initialized() else 0)
        device = torch.device("cuda", idx % torch.cuda.device_count())
    device = torch.device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "the distributed simulations need an initialized "
            "torch.distributed process group (one rank per device)")
    backend = str(dist.get_backend(group)).lower()
    need = "nccl" if device.type == "cuda" else "gloo"
    if need not in backend:
        raise RuntimeError(
            f"a {device.type} rank needs a process group with the {need} "
            f"backend, this one has {backend!r}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device
