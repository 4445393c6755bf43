"""Guard-cell halo exchange and guard accumulation between rank blocks.

The counterpart of ``warpx_tpu.parallel.halo``: the reference's
FillBoundary (halo copy, Source/Parallelization/WarpXComm.cpp:645-1059)
fetches the neighbours' edge slabs into guard cells; SumBoundary (the
additive fold of deposited guard charge and current, WarpXComm.cpp:1074
SyncCurrent) adds the guards back into the neighbours' edge cells.  Where
the JAX package shifts a slab around the ring of a mesh axis with
``lax.ppermute``, each rank here sends its two slabs to its two neighbours
along the axis and receives theirs, point to point.  An axis the mesh does
not shard wraps in place with no message, the single-box periodic case.

The arrays are a rank's local blocks; the last ``len(mesh_axes)``
dimensions are spatial and any before them are a batch (several
components exchanged in one message).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from .topology import SpatialMesh

__all__ = ["exchange_halos", "accumulate_guards", "axis_ring", "swap_slabs"]


def axis_ring(n: int, shift: int):
    """The (source, destination) pairs of a shift by ``shift`` around a ring
    of ``n`` ranks (``lax.ppermute``'s permutation in the JAX package):
    shift=+1 sends data to the right (higher index) neighbour."""
    return [(i, (i + shift) % n) for i in range(n)]


def swap_slabs(smesh: SpatialMesh, axis: str, to_right: torch.Tensor,
               to_left: torch.Tensor):
    """Send ``to_right`` to the right neighbour along ``axis`` and
    ``to_left`` to the left one; return (from_left, from_right), what the
    left neighbour sent rightwards and the right one leftwards.

    The four messages are posted in one fixed order on every rank: on a
    two-rank axis both neighbours are one rank and NCCL ignores tags, so
    the order alone pairs each send with its receive."""
    left = smesh.global_ranks[smesh.neighbor(axis, -1)]
    right = smesh.global_ranks[smesh.neighbor(axis, +1)]
    to_right = to_right.contiguous()
    to_left = to_left.contiguous()
    from_left = torch.empty_like(to_right)
    from_right = torch.empty_like(to_left)
    g = smesh.group
    ops = [dist.P2POp(dist.isend, to_right, right, g, 0),
           dist.P2POp(dist.isend, to_left, left, g, 1),
           dist.P2POp(dist.irecv, from_left, left, g, 0),
           dist.P2POp(dist.irecv, from_right, right, g, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_left, from_right


def exchange_halos(
    arr: torch.Tensor,
    ng: int,
    mesh_axes: Sequence[str | None],
    smesh: SpatialMesh | None = None,
) -> torch.Tensor:
    """Pad a local block with ``ng`` guard cells per side on every spatial
    dimension.

    ``mesh_axes[d]`` is the mesh axis sharding spatial dim d, or None if
    dim d is unsharded (periodic wrap within the block).  Guards carry the
    periodic neighbour's data.  Dimensions go in ascending order, each
    exchanging slabs of the block already padded along the earlier ones,
    so the corners travel too.
    """
    out = arr
    nb = arr.ndim - len(mesh_axes)
    for d, ax in enumerate(mesh_axes):
        dim = nb + d
        low_slab = out.narrow(dim, 0, ng)
        high_slab = out.narrow(dim, out.shape[dim] - ng, ng)
        if ax is None:
            left_guard, right_guard = high_slab, low_slab
        else:
            # my low guard = the left neighbour's high slab, and so on
            left_guard, right_guard = swap_slabs(smesh, ax, high_slab,
                                                 low_slab)
        out = torch.cat([left_guard, out, right_guard], dim=dim)
    return out


def accumulate_guards(
    padded: torch.Tensor,
    ng: int,
    mesh_axes: Sequence[str | None],
    smesh: SpatialMesh | None = None,
) -> torch.Tensor:
    """Fold deposited guard values back into the neighbours' valid cells.

    The inverse of ``exchange_halos`` for additive quantities (J, rho): the
    low guard slab is added to the left neighbour's top valid cells and
    vice versa.  Dimensions go in descending order, so each strips the
    guards of the later ones first.  Returns the valid region.
    """
    out = padded
    nb = padded.ndim - len(mesh_axes)
    for d in reversed(range(len(mesh_axes))):
        ax = mesh_axes[d]
        dim = nb + d
        n_tot = out.shape[dim]
        low_guard = out.narrow(dim, 0, ng)
        high_guard = out.narrow(dim, n_tot - ng, ng)
        valid = out.narrow(dim, ng, n_tot - 2 * ng).clone()
        if ax is None:
            from_right = low_guard  # the low guard wraps onto my top cells
            from_left = high_guard
        else:
            # the right neighbour's low guard overlaps my top valid cells
            from_left, from_right = swap_slabs(smesh, ax, high_guard,
                                               low_guard)
        nv = valid.shape[dim]
        valid.narrow(dim, nv - ng, ng).add_(from_right)
        valid.narrow(dim, 0, ng).add_(from_left)
        out = valid
    return out
