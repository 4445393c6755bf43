"""Pieces of the explicit electromagnetic PIC step shared by the drivers.

The counterpart of the parts of ``warpx_tpu.core.step`` that the tile-binned
periodic path runs: ``advance_fields`` (vacuum FDTD branch of the tail of
OneStep_nosub, WarpXEvolve.cpp:373-450), ``push_momenta_half`` (PushP,
WarpXEvolve.cpp:65,493) and ``wrap_positions`` (periodic Redistribute,
WarpXEvolve.cpp:540-564).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.gather import gather_eb
from ..ops.push import PUSHERS
from ..solvers import yee
from .config import SimConfig
from .state import FieldState, ParticleState, SimState

__all__ = ["advance_fields", "push_momenta_half", "wrap_positions"]


def _add_ext(e6, cfg):
    """Add the constant external particle fields (GetExternalEBField)."""
    ex, ey, ez, bx, by, bz = e6
    Ee = cfg.e_ext_particle
    Be = cfg.b_ext_particle
    if any(Ee) or any(Be):
        ex, ey, ez = ex + Ee[0], ey + Ee[1], ez + Ee[2]
        bx, by, bz = bx + Be[0], by + Be[1], bz + Be[2]
    return (ex, ey, ez, bx, by, bz)


def _field_dict(fields: FieldState):
    return {nm: getattr(fields, nm)
            for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")}


def wrap_positions(sp: ParticleState, geom) -> ParticleState:
    """Periodic particle boundary: wrap into [lo, hi) on every axis.
    ``torch.remainder`` takes the divisor's sign, like ``jnp.mod``."""
    pos = sp.positions(geom.ndim)
    wrapped = []
    for d in range(geom.ndim):
        lo, hi = geom.prob_lo[d], geom.prob_hi[d]
        wrapped.append(lo + torch.remainder(pos[d] - lo, hi - lo))
    return sp.with_positions(geom.ndim, wrapped)


def push_momenta_half(
    state: SimState, cfg: SimConfig, staggering: Dict, dt_half: float
) -> SimState:
    """Gather at the current positions and push the momenta by ``dt_half``
    only: -dt/2 desynchronizes at startup, +dt/2 synchronizes for output."""
    geom = cfg.geometry
    if cfg.field_gathering == "momentum-conserving":
        raise NotImplementedError(
            "momentum-conserving gathering (ROADMAP.md Queue A 11)"
        )
    farr = _field_dict(state.fields)
    new_species = {}
    for sp_cfg in cfg.species:
        sp = state.species[sp_cfg.name]
        if sp_cfg.do_not_push or sp.capacity == 0:
            new_species[sp_cfg.name] = sp
            continue
        ex, ey, ez, bx, by, bz = _add_ext(
            gather_eb(sp.positions(geom.ndim), farr, staggering, geom,
                      cfg.particle_shape, cfg.galerkin),
            cfg,
        )
        ux, uy, uz = PUSHERS[sp_cfg.pusher](
            sp.ux, sp.uy, sp.uz, ex, ey, ez, bx, by, bz,
            sp_cfg.charge, sp_cfg.mass, dt_half,
        )
        new_species[sp_cfg.name] = sp.replace(ux=ux, uy=uy, uz=uz)
    return state.replace(species=new_species)


def advance_fields(fields: FieldState, cfg: SimConfig,
                   j_total) -> FieldState:
    """Store J and advance the Maxwell fields one step: B half, E full,
    B half (WarpXEvolve.cpp:418-446)."""
    if cfg.use_filter:
        raise NotImplementedError("current filter (ROADMAP.md Queue A 9)")
    if cfg.do_dive_cleaning or cfg.do_divb_cleaning:
        raise NotImplementedError(
            "divergence cleaning (ROADMAP.md Queue A 11)"
        )
    if cfg.em_solver_medium != "vacuum":
        raise NotImplementedError(
            "macroscopic medium (ROADMAP.md Queue A 11)"
        )
    if cfg.em_solver not in ("yee", "ckc", "none"):
        raise NotImplementedError(
            f"em_solver {cfg.em_solver!r} (ROADMAP.md Queue A 10)"
        )
    geom = cfg.geometry
    dt = cfg.dt
    fields = fields.replace(jx=j_total[0], jy=j_total[1], jz=j_total[2])
    if cfg.em_solver == "none":
        return fields
    fields = yee.evolve_b(fields, geom, 0.5 * dt, cfg.em_solver)
    fields = yee.evolve_e(fields, geom, dt, cfg.em_solver)
    return yee.evolve_b(fields, geom, 0.5 * dt, cfg.em_solver)
