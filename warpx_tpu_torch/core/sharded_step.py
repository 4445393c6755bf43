"""The PIC step of one rank of a spatially decomposed run.

The counterpart of ``warpx_tpu.core.sharded_step`` (the reference's one
step with its communication, OneStep_nosub with FillBoundary, SyncCurrent
and Redistribute, Source/Evolve/WarpXEvolve.cpp:354, Source/
Parallelization/WarpXComm.cpp): each rank owns one spatial block of the
fields and the particles inside it; the guard cells are filled each step
from the face neighbours (``parallel/halo.py``), the deposited guards
folded back additively, and the particles that left the block ride
fixed-size buffers to the neighbour (``parallel/particles.py``).  Gather
and deposit run per particle (``ops/gather.py``, ``ops/deposit.py``), as
the JAX package runs them here: the tile-binned layout is off.

The guard width ng = shape order + 3 covers the widest stencil: the
Esirkepov window plus one cell of CFL drift (cf. guardCellManager::Init,
reference: Source/Parallelization/GuardCellManager.cpp:38-210).

The balanced variants (after a dynamic load balance) gather from the whole
grid, all-gathered, and deposit a whole-grid J that one all-reduce sums;
each rank keeps its slab.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from ..ops.deposit import deposit_current_direct, deposit_current_esirkepov
from ..ops.gather import gather_eb
from ..ops.push import PUSHERS, position_step
from ..parallel.halo import accumulate_guards, exchange_halos
from ..parallel.particles import exchange_particles
from ..parallel.topology import SpatialMesh
from ..solvers.yee_padded import evolve_b_padded, evolve_e_padded
from .config import SimConfig
from .state import SimState

__all__ = [
    "make_sharded_step", "make_balanced_step", "make_balanced_half_push",
    "make_sharded_half_push", "guard_cells_for", "all_gather_grid",
]

_EB = ("Ex", "Ey", "Ez", "Bx", "By", "Bz")


def guard_cells_for(order: int) -> int:
    return order + 3


def _dim_axes(geom, smesh: SpatialMesh):
    """The mesh axis sharding each array dim (None: unsharded, wrapped in
    the block)."""
    return [ax if smesh.n_shards(ax) > 1 else None
            for ax in geom.axis_names]


def _local_domain(geom, smesh: SpatialMesh, local_nc):
    lo, hi = [], []
    for d, ax in enumerate(geom.axis_names):
        idx = smesh.axis_index(ax) if smesh.n_shards(ax) > 1 else 0
        ext = local_nc[d] * geom.dx[d]
        lo.append(geom.prob_lo[d] + idx * ext)
        hi.append(geom.prob_lo[d] + (idx + 1) * ext)
    return lo, hi


def _padded(arrays, ng, dim_axes, smesh):
    """The blocks padded with ``ng`` guards, exchanged in one message a
    face for all of them."""
    return torch.unbind(exchange_halos(torch.stack(arrays), ng, dim_axes,
                                       smesh))


def all_gather_grid(arr: torch.Tensor, geom, smesh: SpatialMesh):
    """The whole grid from every rank's block (``lax.all_gather`` along
    each sharded axis in the JAX package): one all-gather over the group."""
    if smesh.total_shards == 1:
        return arr
    blocks = [torch.empty_like(arr) for _ in range(smesh.total_shards)]
    dist.all_gather(blocks, arr.contiguous(), group=smesh.group)
    out = arr.new_empty(geom.n_cell)
    for r, blk in enumerate(blocks):
        out[smesh.block_slices(geom, r)] = blk
    return out


def _leapfrog_fields(fields, j3, geom, dt, dim_axes, smesh):
    """B half, E full with J, B half over one-cell halos."""
    ndim = geom.ndim

    def pad1(arrs):
        return _padded(list(arrs), 1, dim_axes, smesh)

    Bx, By, Bz = evolve_b_padded(fields.b(), pad1(fields.e()), geom.dx, ndim,
                                 0.5 * dt)
    Ex, Ey, Ez = evolve_e_padded(fields.e(), pad1((Bx, By, Bz)), j3, geom.dx,
                                 ndim, dt)
    Bx, By, Bz = evolve_b_padded((Bx, By, Bz), pad1((Ex, Ey, Ez)), geom.dx,
                                 ndim, 0.5 * dt)
    return fields.replace(Ex=Ex, Ey=Ey, Ez=Ez, Bx=Bx, By=By, Bz=Bz,
                          jx=j3[0], jy=j3[1], jz=j3[2])


def _push(sp_cfg, sp, pos, e6, dt, ndim):
    """(u, new positions) of the pusher, or unchanged for do_not_push."""
    if sp_cfg.do_not_push:
        return (sp.ux, sp.uy, sp.uz), pos
    u3 = PUSHERS[sp_cfg.pusher](sp.ux, sp.uy, sp.uz, *e6, sp_cfg.charge,
                                sp_cfg.mass, dt)
    return u3, position_step(pos, *u3, dt, ndim)


def _deposit_live(cfg, staggering, sp_cfg, sp, new_pos, u3, j_total, **kw):
    """The J of the species' live slots, added into ``j_total`` (None: a
    new block).  The JAX package deposits every slot, the dead ones with
    zero weight: the same sums.  Here the dead slots, all parked at one
    point, would add their zeros to the same few cells and serialize
    ``index_add_``'s atomics on the card (7.8x the step's time at
    uniform-128 with the headroom's third of the slots dead)."""
    live = torch.nonzero(sp.alive).squeeze(1)
    pos = [p[live] for p in new_pos]
    ux, uy, uz = (u[live] for u in u3)
    args = (pos, ux, uy, uz, sp.w[live], sp_cfg.charge, cfg.geometry)
    kw.update(chunk_size=cfg.deposit_chunk_size, out=j_total)
    if cfg.current_deposition == "esirkepov":
        return deposit_current_esirkepov(*args, cfg.dt, cfg.particle_shape,
                                         **kw)
    return deposit_current_direct(*args, staggering, cfg.dt,
                                  cfg.particle_shape, **kw)


def make_sharded_step(cfg: SimConfig, staggering: Dict, smesh: SpatialMesh):
    """The step of this rank: state -> state."""
    geom = cfg.geometry
    ndim = geom.ndim
    dt = cfg.dt
    order = cfg.particle_shape
    ng = guard_cells_for(order)
    local_nc = smesh.local_n_cell(geom)
    for nc in local_nc:
        if nc < ng:
            raise ValueError(
                f"local block {local_nc} smaller than guard width {ng}"
            )
    dim_axes = _dim_axes(geom, smesh)
    padded_shape = tuple(n + 2 * ng for n in local_nc)
    exchange_K = max(64, (max(local_nc) ** (ndim - 1)) * 4)
    local_lo, local_hi = _local_domain(geom, smesh, local_nc)
    # dead slots parked at the block's center (safe indices)
    center = [0.5 * (local_lo[d] + local_hi[d]) for d in range(ndim)]

    def step(state: SimState) -> SimState:
        fields = state.fields
        # E and B once with ng guards: the gather's blocks
        farr_pad = dict(zip(_EB, _padded(
            [getattr(fields, nm) for nm in _EB], ng, dim_axes, smesh)))

        j_total = None
        new_species = {}
        total_lost = torch.zeros((), dtype=torch.int32,
                                 device=fields.Ex.device)
        for sp_cfg in cfg.species:
            sp = state.species[sp_cfg.name]
            if sp.capacity == 0:
                new_species[sp_cfg.name] = sp
                continue
            pos = [torch.where(sp.alive, p, torch.full_like(p, center[d]))
                   for d, p in enumerate(sp.positions(ndim))]
            if sp_cfg.do_not_gather:
                e6 = (torch.zeros_like(sp.ux),) * 6
            else:
                e6 = gather_eb(pos, farr_pad, staggering, geom, order,
                               cfg.galerkin, origin=local_lo, wrap=False,
                               offset=ng)
            (ux, uy, uz), new_pos = _push(sp_cfg, sp, pos, e6, dt, ndim)

            if not sp_cfg.do_not_deposit:
                j_total = _deposit_live(
                    cfg, staggering, sp_cfg, sp, new_pos, (ux, uy, uz),
                    j_total, origin=local_lo, wrap=False, offset=ng,
                    out_shape=padded_shape)

            sp_new = sp.replace(ux=ux, uy=uy, uz=uz).with_positions(
                ndim, new_pos)
            # the neighbour exchange on the unwrapped positions, then the
            # global wrap
            sp_new, lost = exchange_particles(
                sp_new, ndim, dim_axes, local_lo, local_hi, exchange_K,
                smesh)
            total_lost = total_lost + lost
            wrapped = []
            for d in range(ndim):
                lo_g, hi_g = geom.prob_lo[d], geom.prob_hi[d]
                wrapped.append(lo_g + torch.remainder(
                    sp_new.positions(ndim)[d] - lo_g, hi_g - lo_g))
            new_species[sp_cfg.name] = sp_new.with_positions(ndim, wrapped)

        if j_total is None:
            j3 = tuple(torch.zeros_like(fields.Ex) for _ in range(3))
        else:
            j3 = torch.unbind(accumulate_guards(torch.stack(j_total), ng,
                                                dim_axes, smesh))
        fields = _leapfrog_fields(fields, j3, geom, dt, dim_axes, smesh)

        # the exchange buffers' overflow: a cumulative count, the same on
        # every rank, that the host asserts on (parallel/particles.py)
        dist.all_reduce(total_lost, group=smesh.group)
        aux = dict(state.aux)
        aux["lost"] = aux.get("lost", torch.zeros_like(total_lost)) \
            + total_lost
        return state.replace(fields=fields, species=new_species,
                             step=state.step + 1, time=state.time + dt,
                             aux=aux)

    return step


def make_sharded_half_push(cfg: SimConfig, staggering: Dict,
                           smesh: SpatialMesh):
    """PushP of this rank (the synchronization half momentum push):
    (state, dt_half) -> state."""
    geom = cfg.geometry
    ndim = geom.ndim
    order = cfg.particle_shape
    ng = guard_cells_for(order)
    local_nc = smesh.local_n_cell(geom)
    dim_axes = _dim_axes(geom, smesh)
    lo, hi = _local_domain(geom, smesh, local_nc)
    center = [0.5 * (lo[d] + hi[d]) for d in range(ndim)]

    def half_push(state: SimState, dt_half: float) -> SimState:
        fields = state.fields
        farr_pad = dict(zip(_EB, _padded(
            [getattr(fields, nm) for nm in _EB], ng, dim_axes, smesh)))
        new_species = {}
        for sp_cfg in cfg.species:
            sp = state.species[sp_cfg.name]
            if sp_cfg.do_not_push or sp.capacity == 0:
                new_species[sp_cfg.name] = sp
                continue
            pos = [torch.where(sp.alive, p, torch.full_like(p, center[d]))
                   for d, p in enumerate(sp.positions(ndim))]
            e6 = gather_eb(pos, farr_pad, staggering, geom, order,
                           cfg.galerkin, origin=lo, wrap=False, offset=ng)
            ux, uy, uz = PUSHERS[sp_cfg.pusher](
                sp.ux, sp.uy, sp.uz, *e6, sp_cfg.charge, sp_cfg.mass,
                dt_half)
            new_species[sp_cfg.name] = sp.replace(ux=ux, uy=uy, uz=uz)
        return state.replace(species=new_species)

    return half_push


def make_balanced_step(cfg: SimConfig, staggering: Dict, smesh: SpatialMesh):
    """The balanced step: particles ride their ASSIGNED rank.

    After a dynamic load balance (parallel/load_balance.py, the analog of
    WarpXRegrid.cpp:74-160 makeKnapSack/makeSFC + RemakeLevel) particles no
    longer live with their slab owner, so the gather reads the whole E and
    B (all-gathered) and the deposit makes a whole-grid J that one
    all-reduce sums; each rank keeps its slab of it.  The field work stays
    on the even slabs.  The all-gather and the all-reduce are the price of
    balance, paid only when the measured efficiency gain beats
    load_balance_efficiency_ratio_threshold (WarpXRegrid.cpp:119-124).
    """
    geom = cfg.geometry
    ndim = geom.ndim
    dt = cfg.dt
    order = cfg.particle_shape
    dim_axes = _dim_axes(geom, smesh)
    sharded = any(ax is not None for ax in dim_axes)
    slab = smesh.block_slices(geom)
    center = [0.5 * (geom.prob_lo[d] + geom.prob_hi[d]) for d in range(ndim)]

    def step(state: SimState) -> SimState:
        fields = state.fields
        farr = {nm: all_gather_grid(getattr(fields, nm), geom, smesh)
                for nm in _EB}
        j_total = None
        new_species = {}
        for sp_cfg in cfg.species:
            sp = state.species[sp_cfg.name]
            if sp.capacity == 0:
                new_species[sp_cfg.name] = sp
                continue
            pos = [torch.where(sp.alive, p, torch.full_like(p, center[d]))
                   for d, p in enumerate(sp.positions(ndim))]
            if sp_cfg.do_not_gather:
                e6 = (torch.zeros_like(sp.ux),) * 6
            else:
                e6 = gather_eb(pos, farr, staggering, geom, order,
                               cfg.galerkin)
            (ux, uy, uz), new_pos = _push(sp_cfg, sp, pos, e6, dt, ndim)

            if not sp_cfg.do_not_deposit:
                j_total = _deposit_live(cfg, staggering, sp_cfg, sp, new_pos,
                                        (ux, uy, uz), j_total)

            wrapped = []
            for d in range(ndim):
                lo_g, hi_g = geom.prob_lo[d], geom.prob_hi[d]
                wrapped.append(lo_g + torch.remainder(new_pos[d] - lo_g,
                                                      hi_g - lo_g))
            new_species[sp_cfg.name] = sp.replace(
                ux=ux, uy=uy, uz=uz).with_positions(ndim, wrapped)

        if j_total is None:
            j3 = tuple(torch.zeros_like(fields.Ex) for _ in range(3))
        else:
            j_all = torch.stack(j_total)
            if sharded:
                dist.all_reduce(j_all, group=smesh.group)
            j3 = tuple(a[slab].contiguous() for a in j_all)
        fields = _leapfrog_fields(fields, j3, geom, dt, dim_axes, smesh)
        return state.replace(fields=fields, species=new_species,
                             step=state.step + 1, time=state.time + dt)

    return step


def make_balanced_half_push(cfg: SimConfig, staggering: Dict,
                            smesh: SpatialMesh):
    """PushP for balanced mode: the gather reads the all-gathered fields,
    so that particles off their rank's slab see the right E and B."""
    geom = cfg.geometry
    ndim = geom.ndim
    order = cfg.particle_shape
    center = [0.5 * (geom.prob_lo[d] + geom.prob_hi[d]) for d in range(ndim)]

    def half_push(state: SimState, dt_half: float) -> SimState:
        fields = state.fields
        farr = {nm: all_gather_grid(getattr(fields, nm), geom, smesh)
                for nm in _EB}
        new_species = {}
        for sp_cfg in cfg.species:
            sp = state.species[sp_cfg.name]
            if sp_cfg.do_not_push or sp.capacity == 0:
                new_species[sp_cfg.name] = sp
                continue
            pos = [torch.where(sp.alive, p, torch.full_like(p, center[d]))
                   for d, p in enumerate(sp.positions(ndim))]
            e6 = gather_eb(pos, farr, staggering, geom, order, cfg.galerkin)
            ux, uy, uz = PUSHERS[sp_cfg.pusher](
                sp.ux, sp.uy, sp.uz, *e6, sp_cfg.charge, sp_cfg.mass,
                dt_half)
            new_species[sp_cfg.name] = sp.replace(ux=ux, uy=uy, uz=uz)
        return state.replace(species=new_species)

    return half_push
