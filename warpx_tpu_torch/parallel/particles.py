"""Particle redistribution between face-neighbour ranks.

The counterpart of ``warpx_tpu.parallel.particles`` (amrex
ParticleContainer::Redistribute after the push, Source/Evolve/
WarpXEvolve.cpp:540-564: an explicit EM particle moves at most about a
cell a step, so only face neighbours trade): fixed-capacity buffers of
``K`` particles per face, sent along each sharded axis in turn, so that a
diagonal mover reaches its owner in two hops.

The buffers mirror the JAX package's exactly: the first ``K`` movers of a
face in slot order, the rest counted in ``lost`` and dropped; the arrivals
from the right, then those from the left, each buffer's ``K`` entries in
order, go into this rank's first free slots in slot order; an arrival past
the last free slot is counted in ``lost`` too.  Only the weight, the
momenta and the positions travel (the JAX package's ``_pack``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..core.state import ParticleState
from .halo import swap_slabs
from .topology import SpatialMesh

__all__ = ["exchange_particles", "first_k"]


def _pack(sp: ParticleState) -> Tuple[torch.Tensor, List[str]]:
    names = ["w", "ux", "uy", "uz"]
    arrays = [sp.w, sp.ux, sp.uy, sp.uz]
    for nm, arr in zip(("x", "y", "z"), (sp.x, sp.y, sp.z)):
        if arr is not None:
            names.append(nm)
            arrays.append(arr)
    return torch.stack(arrays, dim=0), names  # (F, cap)


def first_k(mask: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """The indices of the first ``k`` set entries of ``mask`` in order,
    ``fill`` past the last (``jnp.nonzero(mask, size=k, fill_value=fill)``)
    without a wait for the device."""
    n = mask.shape[0]
    order = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (order < k), order,
                       torch.full_like(order, k))
    out = torch.full((k + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(n, device=mask.device))
    return out[:k]


def exchange_particles(
    sp: ParticleState,
    ndim: int,
    dim_axis_names,  # per active dim: mesh axis name or None
    local_lo,  # per dim
    local_hi,
    K: int,
    smesh: SpatialMesh | None = None,
) -> Tuple[ParticleState, torch.Tensor]:
    """Send the particles that left the local block to the face neighbour.

    Returns (new_state, lost_count) with the count an int32 tensor.
    Unsharded dims need no exchange (the periodic wrap applied afterwards
    keeps them in the block).
    """
    alive = sp.alive
    dev = alive.device
    lost = torch.zeros((), dtype=torch.int32, device=dev)
    if all(ax is None for ax in dim_axis_names):
        return sp, lost
    data, names = _pack(sp)
    cap = alive.shape[0]
    pos_index = {nm: i for i, nm in enumerate(names)}
    dim_pos_names = {1: ["z"], 2: ["x", "z"], 3: ["x", "y", "z"]}[ndim]
    ar = torch.arange(K, device=dev)

    for d in range(ndim):
        ax = dim_axis_names[d]
        if ax is None:
            continue
        p = data[pos_index[dim_pos_names[d]]]
        out_left = alive & (p < local_lo[d])
        out_right = alive & (p >= local_hi[d])

        def make_buffer(mask):
            idx = first_k(mask, K, 0)
            n_out = mask.sum()
            valid = ar < n_out
            buf = data[:, idx]  # (F, K)
            return buf, valid, torch.clamp(n_out - K, min=0)

        buf_l, valid_l, over_l = make_buffer(out_left)
        buf_r, valid_r, over_r = make_buffer(out_right)
        lost = lost + over_l.to(torch.int32) + over_r.to(torch.int32)
        # drop the movers here (the overflow past K too: counted above)
        alive = alive & ~(out_left | out_right)

        # the left buffer to the left neighbour, the right one to the right
        recv_from_left, recv_from_right = swap_slabs(
            smesh, ax,
            torch.cat([buf_r, valid_r[None].to(buf_r.dtype)], dim=0),
            torch.cat([buf_l, valid_l[None].to(buf_l.dtype)], dim=0))
        recv = torch.cat([recv_from_right, recv_from_left], dim=1)  # (F+1, 2K)
        recv_data = recv[:-1]
        recv_alive = recv[-1] > 0.5

        free_idx = first_k(~alive, 2 * K, cap)
        placeable = recv_alive & (free_idx < cap)
        lost = lost + (recv_alive & ~placeable).sum().to(torch.int32)
        # an arrival with no slot lands in one spare column, then dropped
        tgt = torch.where(placeable, free_idx, torch.full_like(free_idx, cap))
        data = torch.cat([data, data.new_zeros(data.shape[0], 1)], dim=1)
        data[:, tgt] = recv_data
        data = data[:, :cap]
        alive = torch.cat([alive, alive.new_zeros(1)])
        alive[tgt] = True
        alive = alive[:cap]

    kw = {nm: data[i] for i, nm in enumerate(names)}
    return sp.replace(alive=alive, **kw), lost
