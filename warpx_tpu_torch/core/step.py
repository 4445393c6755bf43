"""The periodic explicit electromagnetic PIC step and its shared pieces.

The counterpart of ``warpx_tpu.core.step`` for the periodic explicit case:
``pic_step`` (the per-particle OneStep_nosub, WarpXEvolve.cpp:354-460:
gather, push, Esirkepov deposit, field advance; 2D XZ and 3D),
``advance_fields`` (current filter and the vacuum FDTD branch of the tail
of OneStep_nosub, WarpXEvolve.cpp:373-450), ``push_momenta_half`` (PushP,
WarpXEvolve.cpp:65,493) and ``wrap_positions`` (periodic Redistribute,
WarpXEvolve.cpp:540-564).  ``pic_step`` is the port's own oracle for the
tile-binned step, as it is in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.deposit import deposit_current_esirkepov
from ..ops.gather import gather_eb
from ..ops.push import PUSHERS, position_step
from ..solvers import yee
from ..solvers.filter import bilinear_filter
from .config import SimConfig
from .state import FieldState, ParticleState, SimState

__all__ = ["pic_step", "advance_fields", "push_momenta_half",
           "wrap_positions"]


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


def _check_pic_step(cfg: SimConfig):
    """Refuse what ``pic_step`` does not cover yet, naming where it waits."""
    if not cfg.geometry.all_periodic:
        raise NotImplementedError(
            "non-periodic boundaries: the bounded step (ROADMAP.md Queue A 9)"
        )
    if cfg.current_deposition != "esirkepov":
        raise NotImplementedError(
            f"current deposition {cfg.current_deposition!r} "
            "(ROADMAP.md Queue A 3)"
        )
    if cfg.grid_type != "staggered":
        raise NotImplementedError(
            f"grid type {cfg.grid_type!r} (ROADMAP.md Queue A 11)"
        )
    if cfg.field_gathering == "momentum-conserving":
        raise NotImplementedError(
            "momentum-conserving gathering (ROADMAP.md Queue A 11)"
        )
    if cfg.use_nci_corr:
        raise NotImplementedError(
            "Godfrey NCI corrector (ROADMAP.md Queue A 11.3)"
        )
    for sp_cfg in cfg.species:
        if sp_cfg.species_type == "photon" or sp_cfg.mass == 0.0:
            raise NotImplementedError(
                f"massless species {sp_cfg.name!r} (ROADMAP.md Queue A 11)"
            )


def pic_step(state: SimState, cfg: SimConfig, staggering: Dict) -> SimState:
    """One explicit electromagnetic PIC step, particle by particle, on the
    periodic domain: gather at x^n, push u and x, deposit J^{n+1/2}
    (Esirkepov), wrap, advance the fields.  Collisions, ionization, QED,
    Galilean and multi-J PSATD, rho deposits and fluids of the JAX
    package's ``pic_step`` have no configuration fields here yet
    (ROADMAP.md Queue A 10-11)."""
    _check_pic_step(cfg)
    geom = cfg.geometry
    dt = cfg.dt
    farr = _field_dict(state.fields)
    j_total = None
    new_species = {}
    for sp_cfg in cfg.species:
        sp = state.species[sp_cfg.name]
        if sp.capacity == 0:
            new_species[sp_cfg.name] = sp
            continue
        pos = sp.positions(geom.ndim)
        if sp_cfg.do_not_gather:
            e6 = (torch.zeros_like(sp.ux),) * 6
        else:
            e6 = _add_ext(
                gather_eb(pos, farr, staggering, geom, cfg.particle_shape,
                          cfg.galerkin),
                cfg,
            )
        if sp_cfg.do_not_push:
            ux, uy, uz = sp.ux, sp.uy, sp.uz
            new_pos = pos
        else:
            ux, uy, uz = PUSHERS[sp_cfg.pusher](
                sp.ux, sp.uy, sp.uz, *e6, sp_cfg.charge, sp_cfg.mass, dt,
            )
            new_pos = position_step(pos, ux, uy, uz, dt, geom.ndim)
        if not sp_cfg.do_not_deposit:
            w_eff = torch.where(sp.alive, sp.w, torch.zeros_like(sp.w))
            j3 = deposit_current_esirkepov(
                new_pos, ux, uy, uz, w_eff, sp_cfg.charge, geom, dt,
                cfg.particle_shape,
            )
            j_total = j3 if j_total is None else tuple(
                a + b for a, b in zip(j_total, j3)
            )
        new_species[sp_cfg.name] = wrap_positions(
            sp.replace(ux=ux, uy=uy, uz=uz).with_positions(geom.ndim,
                                                           new_pos),
            geom,
        )
    if j_total is None:
        j_total = tuple(torch.zeros_like(state.fields.Ex) for _ in range(3))
    return state.replace(
        fields=advance_fields(state.fields, cfg, j_total),
        species=new_species,
        step=state.step + 1,
        time=state.time + dt,
    )


def advance_fields(fields: FieldState, cfg: SimConfig,
                   j_total) -> FieldState:
    """Filter and store J, then advance the Maxwell fields one step: B half,
    E full, B half (WarpXEvolve.cpp:373-446)."""
    if cfg.use_filter:
        npass = cfg.filter_npass_each_dir or (1,) * cfg.geometry.ndim
        j_total = tuple(bilinear_filter(a, npass) for a in j_total)
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
