"""Distribute an initial ``SimState`` over a ``SpatialMesh``.

The counterpart of ``warpx_tpu.parallel.distribute`` (the reference's
initial DistributionMapping): on the host, particles are binned by the
spatial block that owns them and packed into equal fixed-capacity
segments, one per rank, of one global slot axis (segment ``s`` holds rank
``s``'s particles, in their global order); ``distribute_state`` then leaves
each rank its field block and its own segment on its device.  The numpy
helpers are the JAX package's, line for line.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.state import ParticleState, SimState
from .topology import SpatialMesh

__all__ = ["distribute_state", "distribute_particles", "shard_capacity",
           "pack_by_owner", "local_segment", "gather_particles"]


def shard_capacity(count_max: int, headroom: float = 1.5, multiple: int = 8) -> int:
    cap = int(np.ceil(count_max * headroom / multiple) * multiple)
    return max(cap, multiple)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _owner_index(pos_active: np.ndarray, geom, smesh: SpatialMesh):
    """Flattened shard index (C-order over mesh axes) per particle."""
    idx = np.zeros(pos_active.shape[0], dtype=np.int64)
    for ax, s in smesh.axis_shards:
        d = geom.axis_names.index(ax)
        ext = (geom.prob_hi[d] - geom.prob_lo[d]) / s
        block = np.clip(
            ((pos_active[:, d] - geom.prob_lo[d]) // ext).astype(np.int64), 0, s - 1
        )
        idx = idx * s + block
    return idx


def pack_by_owner(
    ps: ParticleState, owner: np.ndarray, n_shards: int, cap: int, geom,
) -> ParticleState:
    """Repack particles into per-shard segments of width ``cap`` by the
    given owner index (-1 = dead slot, dropped), on the host; the result
    lies on ``ps``'s device.  The host form of a Redistribute after a new
    DistributionMapping is adopted (reference: WarpXRegrid.cpp:146
    RemakeLevel -> Redistribute)."""
    ndim = geom.ndim
    counts = np.bincount(owner[owner >= 0], minlength=n_shards)
    if counts.size and int(counts.max()) > cap:
        raise RuntimeError(
            f"load-balance repack overflow: a chip was assigned "
            f"{int(counts.max())} particles > segment capacity {cap}; "
            "increase headroom"
        )
    pos = np.stack([_host(p) for p in ps.positions(ndim)], axis=-1)

    def pack(arr, fill=0.0):
        arr = _host(arr)
        out = np.full((n_shards * cap,) + arr.shape[1:], fill, dtype=arr.dtype)
        for s in range(n_shards):
            sel = np.nonzero(owner == s)[0]
            out[s * cap : s * cap + sel.size] = arr[sel]
        return out

    new_alive = np.zeros(n_shards * cap, dtype=bool)
    for s in range(n_shards):
        new_alive[s * cap : s * cap + counts[s]] = True

    kw = dict(
        w=pack(ps.w),
        ux=pack(ps.ux),
        uy=pack(ps.uy),
        uz=pack(ps.uz),
        alive=new_alive,
        extra={k: pack(v) for k, v in ps.extra.items()},
    )
    pos_names = {1: ["z"], 2: ["x", "z"], 3: ["x", "y", "z"]}[ndim]
    # park dead slots mid-domain; the sharded step re-parks per-block anyway
    for d, nm in enumerate(pos_names):
        center = 0.5 * (geom.prob_lo[d] + geom.prob_hi[d])
        kw[nm] = pack(pos[:, d], fill=center)
    dev = ps.w.device
    kw["extra"] = {k: torch.from_numpy(v).to(dev)
                   for k, v in kw["extra"].items()}
    return ParticleState(**{k: (torch.from_numpy(v).to(dev) if k != "extra"
                                else v) for k, v in kw.items()})


def distribute_particles(
    ps: ParticleState, geom, smesh: SpatialMesh, headroom: float = 1.5
) -> ParticleState:
    """The global slot axis of ``ps`` packed by owning block (all
    segments)."""
    ndim = geom.ndim
    n_shards = smesh.total_shards
    pos = np.stack([_host(p) for p in ps.positions(ndim)], axis=-1)
    alive = _host(ps.alive)
    owner = _owner_index(pos, geom, smesh)
    owner = np.where(alive, owner, -1)

    counts = np.bincount(owner[owner >= 0], minlength=n_shards)
    cap = shard_capacity(int(counts.max()) if counts.size else 0, headroom)
    return pack_by_owner(ps, owner, n_shards, cap, geom)


def local_segment(ps: ParticleState, rank: int, n_shards: int) -> ParticleState:
    """Segment ``rank`` of a slot axis split into ``n_shards`` equal ones."""
    cap = ps.capacity // n_shards
    sl = slice(rank * cap, (rank + 1) * cap)

    def cut(t):
        return None if t is None else t[sl].contiguous()

    return ps.replace(w=cut(ps.w), ux=cut(ps.ux), uy=cut(ps.uy),
                      uz=cut(ps.uz), alive=cut(ps.alive), x=cut(ps.x),
                      y=cut(ps.y), z=cut(ps.z),
                      extra={k: cut(v) for k, v in ps.extra.items()})


def distribute_state(
    state: SimState, geom, smesh: SpatialMesh, headroom: float = 1.5
) -> SimState:
    """The global ``state`` re-laid out: this rank keeps its block of every
    field and its own segment of every species, on the state's device."""
    blk = smesh.block_slices(geom)
    fields = state.fields.replace(**{
        nm: getattr(state.fields, nm)[blk].contiguous()
        for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")})
    species = {
        name: local_segment(distribute_particles(sp, geom, smesh, headroom),
                            smesh.rank, smesh.total_shards)
        for name, sp in state.species.items()
    }
    return state.replace(fields=fields, species=species)


def gather_particles(ps: ParticleState, group, world: int) -> ParticleState:
    """The global slot axis from every rank's equal segment, in rank order
    (one all-gather a column)."""
    if world == 1:
        return ps

    def cat(t):
        if t is None:
            return None
        # a mask travels as bytes (not every backend reduces bools)
        src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(world)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts)
        return out.bool() if t.dtype == torch.bool else out

    return ps.replace(w=cat(ps.w), ux=cat(ps.ux), uy=cat(ps.uy),
                      uz=cat(ps.uz), alive=cat(ps.alive), x=cat(ps.x),
                      y=cat(ps.y), z=cat(ps.z),
                      extra={k: cat(v) for k, v in ps.extra.items()})
