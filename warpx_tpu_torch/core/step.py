"""The periodic explicit electromagnetic PIC step and its shared pieces.

The counterpart of ``warpx_tpu.core.step`` for the periodic explicit case:
``pic_step`` (the per-particle OneStep_nosub, WarpXEvolve.cpp:354-460:
gather, push, Esirkepov deposit, field advance; 2D XZ and 3D),
``advance_fields`` (current filter and the vacuum FDTD or standard PSATD
branch of the tail of OneStep_nosub, WarpXEvolve.cpp:373-450),
``push_momenta_half`` (PushP, WarpXEvolve.cpp:65,493) and
``wrap_positions`` (periodic Redistribute, WarpXEvolve.cpp:540-564).
``pic_step`` is the port's own oracle for the tile-binned step, as it is
in the JAX package.
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
           "wrap_positions", "check_psatd", "psatd_ported"]

_FIELDS = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")


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


def _psatd_unported(cfg: SimConfig):
    """What of a PSATD configuration waits for ROADMAP.md Queue A 10.2 (the
    standard J-constant-in-time family is ported), or None."""
    if cfg.psatd_solution_type != "second-order":
        return f"psatd.solution_type = {cfg.psatd_solution_type}"
    if cfg.psatd_j_in_time != "constant" or cfg.multi_j_n_depositions > 1:
        return "multi-J (psatd.J_in_time = linear)"
    if cfg.psatd_rho_in_time != "linear":
        return f"psatd.rho_in_time = {cfg.psatd_rho_in_time}"
    if cfg.psatd_update_with_rho:
        return "psatd.update_with_rho"
    if cfg.psatd_current_correction:
        return "current correction"
    if any(cfg.psatd_v_galilean):
        return "the Galilean grid drift (psatd.v_galilean)"
    if any(cfg.psatd_v_comoving):
        return "comoving PSATD (psatd.v_comoving)"
    if cfg.psatd_time_averaging:
        return "time averaging"
    if cfg.current_deposition == "vay":
        return "Vay deposition"
    if cfg.do_dive_cleaning or cfg.do_divb_cleaning:
        return "divergence cleaning in the domain"
    return None


def psatd_ported(cfg: SimConfig) -> bool:
    """Whether a PSATD configuration is in the ported standard family."""
    return _psatd_unported(cfg) is None


def check_psatd(cfg: SimConfig) -> None:
    """Refuse a PSATD family that is not ported, naming where it waits."""
    what = _psatd_unported(cfg)
    if what is not None:
        raise NotImplementedError(
            f"PSATD with {what} (ROADMAP.md Queue A 10.2)")


def _check_pic_step(cfg: SimConfig):
    """Refuse what ``pic_step`` does not cover yet, naming where it waits."""
    if cfg.em_solver == "psatd":
        check_psatd(cfg)
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


def pic_step(state: SimState, cfg: SimConfig, staggering: Dict,
             psatd=None) -> SimState:
    """One explicit electromagnetic PIC step, particle by particle, on the
    periodic domain: gather at x^n, push u and x, deposit J^{n+1/2}
    (Esirkepov), wrap, advance the fields (``psatd``, a
    ``solvers.psatd.PsatdSolver``, under em_solver = psatd).  Galilean and
    multi-J PSATD and rho deposits wait for ROADMAP.md Queue A 10.2;
    collisions, ionization, QED and fluids of the JAX package's
    ``pic_step`` have no configuration fields here yet (Queue A 11)."""
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
        fields=advance_fields(state.fields, cfg, j_total, psatd),
        species=new_species,
        step=state.step + 1,
        time=state.time + dt,
    )


def advance_fields(fields: FieldState, cfg: SimConfig,
                   j_total, psatd=None) -> FieldState:
    """Filter and store J, then advance the Maxwell fields one step: B half,
    E full, B half (WarpXEvolve.cpp:373-446), or the analytic k-space
    advance of ``psatd`` (PushPSATD, WarpXPushFieldsEM.cpp:717)."""
    if cfg.use_filter:
        npass = cfg.filter_npass_each_dir or (1,) * cfg.geometry.ndim
        j_total = tuple(bilinear_filter(a, npass) for a in j_total)
    if cfg.em_solver == "psatd":
        check_psatd(cfg)
    if cfg.do_dive_cleaning or cfg.do_divb_cleaning:
        raise NotImplementedError(
            "divergence cleaning (ROADMAP.md Queue A 11)"
        )
    if cfg.em_solver_medium != "vacuum":
        raise NotImplementedError(
            "macroscopic medium (ROADMAP.md Queue A 11)"
        )
    if cfg.em_solver not in ("yee", "ckc", "psatd", "none"):
        raise NotImplementedError(
            f"em_solver {cfg.em_solver!r} (ROADMAP.md Queue A 11)"
        )
    geom = cfg.geometry
    dt = cfg.dt
    fields = fields.replace(jx=j_total[0], jy=j_total[1], jz=j_total[2])
    if cfg.em_solver == "none":
        return fields
    if cfg.em_solver == "psatd":
        new = psatd.push({nm: getattr(fields, nm) for nm in _FIELDS})
        return fields.replace(**{nm: new[nm] for nm in _FIELDS})
    fields = yee.evolve_b(fields, geom, 0.5 * dt, cfg.em_solver)
    fields = yee.evolve_e(fields, geom, dt, cfg.em_solver)
    return yee.evolve_b(fields, geom, 0.5 * dt, cfg.em_solver)
