"""The periodic explicit electromagnetic PIC step and its shared pieces.

The counterpart of ``warpx_tpu.core.step`` for the periodic explicit case:
``pic_step`` (the per-particle OneStep_nosub, WarpXEvolve.cpp:354-460:
gather, push, deposit, field advance; 2D XZ and 3D; Esirkepov, direct or
Vay deposition; the rho deposits, Galilean origins and multi-J sampling of
the PSATD families, and OneStep_multiJ's first-order sub-step loop),
``advance_fields`` (current filter and the vacuum FDTD or PSATD branch of
the tail of OneStep_nosub, WarpXEvolve.cpp:373-450), ``push_momenta_half``
(PushP, WarpXEvolve.cpp:65,493) and ``wrap_positions`` (periodic
Redistribute, WarpXEvolve.cpp:540-564).  Before the push ``pic_step`` runs
the binary collisions, field ionization, the QED events and Schwinger pair
creation (WarpXEvolve.cpp:157-166 doCollisions, doFieldIonization,
doQEDEvents, doQEDSchwinger) on the numbers of a ``utils.draws`` source;
photon species stream at c, and the QED optical depths fall by dN/dt dt
after the push.  Collocated grids take the centered curls and, under
PSATD, the collocated spectral solver with the hybrid QED correction
around its push; momentum-conserving gathering reads the fields averaged
to the nodes (``_nodal_aux``, Fornberg order ``field_centering_no``);
``_add_ext`` adds the accelerator lattice's hard-edged fields in 3D and
``rigid_push`` the rigid injection of a beam.  ``pic_step`` is the
port's own oracle for the tile-binned step, as it is in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..constants import c as _c
from ..ops.deposit import (deposit_current_direct, deposit_current_esirkepov,
                           deposit_current_vay, deposit_rho)
from ..ops.gather import gather_eb
from ..ops.push import (PUSHERS, inv_gamma, photon_position_step,
                        position_step)
from ..solvers import yee
from ..solvers.filter import bilinear_filter
from ..solvers.hybrid_qed import hybrid_qed_push
from .config import SimConfig
from .state import FieldState, ParticleState, SimState

__all__ = ["pic_step", "advance_fields", "push_momenta_half",
           "wrap_positions", "galilean_velocity"]

_FIELDS = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")
_ACTIVE = {1: (2,), 2: (0, 2), 3: (0, 1, 2)}


def _add_ext(e6, cfg, pos=None, u3=None):
    """Add the constant external particle fields (GetExternalEBField) and,
    given the positions and momenta in 3D, the accelerator lattice's
    hard-edged quadrupoles and plasma lenses with the residence-fraction
    correction (HardEdged_K.H:25-46; JAX core/step.py:29-70).  The JAX
    package adds the lattice in 3D only and not in the half-pushes; the
    port refuses a lattice in 2D (``check_lattice``)."""
    ex, ey, ez, bx, by, bz = e6
    Ee = cfg.e_ext_particle
    Be = cfg.b_ext_particle
    if any(Ee) or any(Be):
        ex, ey, ez = ex + Ee[0], ey + Ee[1], ez + Ee[2]
        bx, by, bz = bx + Be[0], by + Be[1], bz + Be[2]
    if cfg.lattice_elements and pos is not None and len(pos) == 3:
        x, y, z = pos
        zpvdt = z + u3[2] * inv_gamma(*u3) * cfg.dt
        zl = torch.minimum(z, zpvdt)
        zr = torch.maximum(z, zpvdt)
        same = zr == zl
        denom = torch.where(same, torch.ones_like(zr), zr - zl)
        for kind, zs, ze, dEdx, dBdx in cfg.lattice_elements:
            inside = ((z >= zs) & (z < ze)).to(z.dtype)
            frac = torch.where(same, inside,
                               (torch.clamp(zr, zs, ze)
                                - torch.clamp(zl, zs, ze)) / denom)
            fe = frac * dEdx
            fb = frac * dBdx
            if kind == "quad":
                ex, ey = ex + x * fe, ey - y * fe
                bx, by = bx + y * fb, by + x * fb
            else:  # plasmalens
                ex, ey = ex + x * fe, ey + y * fe
                bx, by = bx + y * fb, by - x * fb
    return (ex, ey, ez, bx, by, bz)


def check_lattice(cfg: SimConfig) -> None:
    """The JAX package adds the lattice's fields in 3D only and drops them
    silently in 2D: the port refuses a 2D lattice."""
    if cfg.lattice_elements and cfg.geometry.ndim != 3:
        raise NotImplementedError(
            "an accelerator lattice in 2D (the JAX package adds its fields "
            "in 3D only; ROADMAP.md Queue C)")


def fornberg_centering_coeffs(n_order: int):
    """The half-cell Fornberg interpolation coefficients, one side, j = 0 ..
    m-1; each sample weighs c_j / 2 (WarpX::getFornbergStencilCoefficients,
    WarpX.cpp:3119; JAX core/step.py:73-88)."""
    m = n_order // 2
    prod = 1.0
    for k in range(1, m + 1):
        prod *= (m + k) / (4.0 * k)
    c = [0.0] * m
    c[0] = 4.0 * m * prod * prod
    for n in range(1, m):
        c[n] = -((2 * n - 1) * (m - n)) / ((2 * n + 1) * (m + n)) * c[n - 1]
    return c


def center_periodic(a, d: int, order: int):
    """A staggered array centered to the nodes along periodic axis ``d``:
    the two-point average, or Fornberg centering of ``order`` > 2."""
    if order <= 2:
        return 0.5 * (a + torch.roll(a, 1, d))
    acc = 0.0
    for j, cj in enumerate(fornberg_centering_coeffs(order)):
        # node i from the samples at i + j + 1/2 and i - j - 1/2
        acc = acc + 0.5 * cj * (torch.roll(a, -j, d)
                                + torch.roll(a, j + 1, d))
    return acc


def _nodal_aux(farr: Dict, staggering: Dict, orders=None) -> Dict:
    """The staggered fields interpolated to the nodes for
    momentum-conserving gathering (UpdateAuxilaryDataStagToNodal,
    WarpXComm.cpp; JAX core/step.py:91-135), on the periodic grid, at the
    centering order ``orders[d]`` of each axis (warpx.field_centering_no*;
    2 by default)."""
    out = {}
    for name, a in farr.items():
        for d, flag in enumerate(staggering[name]):
            if flag == 0:
                a = center_periodic(a, d, orders[d] if orders else 2)
        out[name] = a
    return out


def nodal_staggering(ndim: int, staggering: Dict) -> Dict:
    return {k: (1,) * ndim for k in staggering}


def rigid_planes(state, sp_cfg, cfg: SimConfig):
    """(plane at t^n, plane at t^{n+1}, mean v_z, boost speed) of a
    rigid-injected species: the plane moves at -v_boost in the boosted
    frame (RigidInjectedParticleContainer.cpp:76, 105); host numbers in
    the state's precision."""
    f = type(state.aux[f"vzave:{sp_cfg.name}"])
    v_boost = (math.sqrt(1.0 - 1.0 / cfg.gamma_boost ** 2) * _c
               if cfg.gamma_boost > 1.0 else 0.0)
    zp_prev = state.aux[f"zinject:{sp_cfg.name}"]
    return (zp_prev, f(zp_prev - cfg.dt * v_boost),
            state.aux[f"vzave:{sp_cfg.name}"], v_boost)


def rigid_scale_fields(e6, z, z_plane_prev, vz_ave, v_boost, dt):
    """Scale the gathered fields of the particles about to cross the
    injection plane (ScaleFields.H:50: dtscale approximates a fractional
    push; JAX core/step.py:137-145)."""
    denom = float(vz_ave + v_boost) or 1.0
    dtscale = 1.0 - (float(z_plane_prev) - z) / denom / dt
    s = torch.where((dtscale > 0.0) & (dtscale < 1.0), dtscale,
                    torch.ones_like(dtscale))
    return tuple(fv * s for fv in e6)


def rigid_undo_push(pos_old, u_old3, pos_new, u_new3, z_plane_new,
                    vz_ave, dt, rigid_advance, ndim):
    """Undo the push of the particles that have not crossed the plane yet
    (RigidInjectedParticleContainer.cpp:250-290; JAX core/step.py:148-175):
    u and the transverse positions stay, z advances at the mean v_z (or
    ballistically without rigid_advance).  Returns (positions, u3)."""
    zax = ndim - 1
    not_inj = pos_new[zax] <= float(z_plane_new)
    u3 = tuple(torch.where(not_inj, uo, un)
               for uo, un in zip(u_old3, u_new3))
    if rigid_advance:
        z_rigid = pos_old[zax] + dt * float(vz_ave)
    else:
        z_rigid = pos_old[zax] + dt * u_old3[2] * inv_gamma(*u_old3)
    pos = [torch.where(not_inj, po, pn)
           for po, pn in zip(pos_old[:zax], pos_new[:zax])]
    pos.append(torch.where(not_inj, z_rigid, pos_new[zax]))
    return pos, u3


def rigid_push(state, sp_cfg, cfg: SimConfig, pos, sp, e6, dt, ndim):
    """The push of a species: Boris (or its pusher) on ``e6``, and for a
    rigid-injected species the field scaling before and the undo after it.
    Returns (u3, new positions, aux updates)."""
    rigid = sp_cfg.zinject_plane is not None
    if rigid:
        zp_prev, zp_new, vz_ave, v_boost = rigid_planes(state, sp_cfg, cfg)
        e6 = rigid_scale_fields(e6, pos[ndim - 1], zp_prev, vz_ave, v_boost,
                                dt)
    ux, uy, uz = PUSHERS[sp_cfg.pusher](
        sp.ux, sp.uy, sp.uz, *e6, sp_cfg.charge, sp_cfg.mass, dt)
    new_pos = position_step(pos, ux, uy, uz, dt, ndim)
    if not rigid:
        return (ux, uy, uz), new_pos, {}
    new_pos, u3 = rigid_undo_push(pos, (sp.ux, sp.uy, sp.uz), new_pos,
                                  (ux, uy, uz), zp_new, vz_ave, dt,
                                  sp_cfg.rigid_advance, ndim)
    return u3, new_pos, {f"zinject:{sp_cfg.name}": zp_new}


def _field_dict(fields: FieldState, use_avg: bool = False):
    """The gather's source fields; averaged PSATD gathers from the
    time-averaged ones (Efield_avg_aux, WarpXComm.cpp aux selection)."""
    suffix = "_avg" if use_avg and fields.Ex_avg is not None else ""
    return {nm: getattr(fields, nm + suffix)
            for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")}


def _filter(a, cfg):
    npass = cfg.filter_npass_each_dir or (1,) * cfg.geometry.ndim
    return bilinear_filter(a, npass)


def _sum3(acc, j3):
    return j3 if acc is None else tuple(a + b for a, b in zip(acc, j3))


def galilean_velocity(cfg: SimConfig):
    """psatd.v_galilean on the active axes, or None without a drift."""
    if not any(cfg.psatd_v_galilean):
        return None
    return [cfg.psatd_v_galilean[a] for a in _ACTIVE[cfg.geometry.ndim]]


def wrap_positions(sp: ParticleState, geom, shift=None) -> ParticleState:
    """Periodic particle boundary: wrap into [lo, hi) on every axis.
    ``shift`` (per active dim) wraps into the drifted domain
    [lo + shift, hi + shift) of a Galilean run, whose box moves with
    ShiftGalileanBoundary.  ``torch.remainder`` takes the divisor's sign,
    like ``jnp.mod``."""
    pos = sp.positions(geom.ndim)
    wrapped = []
    for d in range(geom.ndim):
        lo, hi = geom.prob_lo[d], geom.prob_hi[d]
        if shift is not None:
            lo = lo + shift[d]
            hi = hi + shift[d]
        wrapped.append(lo + torch.remainder(pos[d] - lo, hi - lo))
    return sp.with_positions(geom.ndim, wrapped)


def push_momenta_half(
    state: SimState, cfg: SimConfig, staggering: Dict, dt_half: float
) -> SimState:
    """Gather at the current positions and push the momenta by ``dt_half``
    only: -dt/2 desynchronizes at startup, +dt/2 synchronizes for output."""
    geom = cfg.geometry
    farr = _field_dict(state.fields, use_avg=cfg.psatd_time_averaging)
    stag = staggering
    if cfg.field_gathering == "momentum-conserving":
        farr = _nodal_aux(farr, staggering, cfg.field_centering_no or None)
        stag = nodal_staggering(geom.ndim, staggering)
    new_species = {}
    for sp_cfg in cfg.species:
        sp = state.species[sp_cfg.name]
        if (sp_cfg.do_not_push or sp.capacity == 0
                or sp_cfg.species_type == "photon" or sp_cfg.mass == 0.0):
            new_species[sp_cfg.name] = sp
            continue
        # the JAX package's half-pushes add no lattice (core/step.py:217)
        ex, ey, ez, bx, by, bz = _add_ext(
            gather_eb(sp.positions(geom.ndim), farr, stag, geom,
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
        raise ValueError(
            "a bounded configuration was handed to pic_step, the periodic "
            "step: Simulation runs it through core/bounded_step.py")
    if cfg.current_deposition not in ("esirkepov", "direct", "vay",
                                      "villasenor"):
        # villasenor is deposited directly, with the Galerkin gather on, as
        # the JAX package runs it (step.py:593-614, config.py:499-514)
        raise NotImplementedError(
            f"current deposition {cfg.current_deposition!r}")
    if cfg.current_deposition == "vay" and cfg.em_solver != "psatd":
        # the deposited D arrays become J only in the spectral solver
        raise NotImplementedError(
            "Vay deposition requires the PSATD solver")
    if cfg.grid_type not in ("staggered", "collocated", "hybrid"):
        raise ValueError(f"grid type {cfg.grid_type!r}")
    check_lattice(cfg)
    if cfg.use_hybrid_qed and not (cfg.em_solver == "psatd"
                                   and cfg.grid_type == "collocated"):
        # the JAX reader's refusal (warpx_tpu/core/deck.py:456-463)
        raise NotImplementedError(
            "hybrid QED Maxwell requires PSATD + collocated grid (the JAX "
            "reader refuses it too; ROADMAP.md Queue C)")
    if cfg.em_solver == "ect" or cfg.eb_implicit_function:
        # the JAX package's periodic step has no embedded boundary and
        # runs plain Yee curls for "ect": it would drop both silently
        raise NotImplementedError(
            "an embedded boundary or the ECT solver on the periodic step "
            "(the JAX package's periodic step drops them; give the box a "
            "pec face: ROADMAP.md Queue C)")
    if cfg.fluids and cfg.em_solver == "psatd" and (
            cfg.psatd_solution_type == "first-order"):
        # the JAX package's refusal (core/step.py:670-672)
        raise NotImplementedError("fluid species with multi-J PSATD")
    if cfg.evolve_scheme != "explicit":
        raise ValueError("an implicit configuration was handed to pic_step: "
                         "Simulation runs it through solvers/implicit.py")
    for sp_cfg in cfg.species:
        if sp_cfg.mass == 0.0 and sp_cfg.species_type != "photon":
            # the JAX package divides by the zero mass in its pusher
            # (ZeroDivisionError in push_momentum_boris)
            raise NotImplementedError(
                f"massless species {sp_cfg.name!r} that is not a photon "
                "(the JAX package's pusher divides by its mass; ROADMAP.md "
                "Queue C)")


def _apply_nci(farr, cfg: SimConfig):
    """The Godfrey NCI corrector on the gather's fields along z
    (UpdateAuxilaryData applies nci_godfrey_filter_exeybz / _bxbyez to the
    aux fields; JAX core/step.py:232-250): Ex, Ey, Bz through one
    stencil, Bx, By, Ez through the other.  On a guard-padded block the
    stencil's wrap lands in guards the gather never reads."""
    from ..constants import c as _c
    from ..solvers.filter import apply_z_stencil, nci_godfrey_stencil

    geom = cfg.geometry
    zax = geom.ndim - 1
    cdtodz = _c * cfg.dt / geom.dx[zax]
    nodal = cfg.field_gathering == "momentum-conserving"
    s1 = nci_godfrey_stencil(cdtodz, "ExEyBz", nodal)
    s2 = nci_godfrey_stencil(cdtodz, "BxByEz", nodal)
    out = dict(farr)
    for nm in ("Ex", "Ey", "Bz"):
        out[nm] = apply_z_stencil(out[nm], s1, zax)
    for nm in ("Bx", "By", "Ez"):
        out[nm] = apply_z_stencil(out[nm], s2, zax)
    return out


def has_stochastic(cfg: SimConfig) -> bool:
    """Whether the step, the plane emission, the resampling after it, the
    thermal walls or the Gaussian continuous injection draw random numbers
    (every collision kind but background stopping draws)."""
    thermal = "thermal" in tuple(cfg.particle_bc_lo) + tuple(
        cfg.particle_bc_hi)
    return cfg.do_qed_schwinger or thermal or any(
        s.do_field_ionization or s.do_qed_quantum_sync
        or s.do_qed_breit_wheeler or s.do_resampling
        or s.injection_style == "nfluxpercell"
        or (s.do_continuous_injection
            and s.momentum_distribution == "gaussian")
        for s in cfg.species
    ) or any(c.kind != "background_stopping" for c in cfg.collisions)


def collisions_substep(state: SimState, cfg: SimConfig, draws):
    """The binary collisions before the push, grouped by kind
    as the JAX package runs them (``core/step.py:296-386``): every
    pairwise-Coulomb collision in the configuration's order, then every
    fusion, every DSMC, the MCC collisions, the stopping.  A collision
    with ``ndt`` > 1 runs with dt ndt when step % ndt == 0 and still takes
    its split on the other steps, as ``jax.lax.cond`` does there
    (CollisionHandler.cpp:89-91)."""
    from ..ops.collisions import inter_species_coulomb, intra_species_coulomb
    from ..ops.dsmc import dsmc_collision_update
    from ..ops.fusion import fusion_collision_update
    from ..ops.mcc import mcc_collision_update
    from ..ops.stopping import stopping_collision_update

    def coulomb(state, col, dt_coll, sub):
        species = dict(state.species)
        c1, c2 = by_name[col.species[0]], by_name[col.species[1]]
        if c1.name == c2.name:
            species[c1.name] = intra_species_coulomb(
                species[c1.name], c1.charge, c1.mass, cfg.geometry, dt_coll,
                sub, coulomb_log=col.coulomb_log)
        else:
            species[c1.name], species[c2.name] = inter_species_coulomb(
                species[c1.name], c1.charge, c1.mass, species[c2.name],
                c2.charge, c2.mass, cfg.geometry, dt_coll, sub,
                coulomb_log=col.coulomb_log)
        return state.replace(species=species)

    by_name = {s.name: s for s in cfg.species}
    pairwise = {
        "pairwisecoulomb": coulomb,
        "nuclearfusion": lambda s, c, d, k: fusion_collision_update(
            s, cfg, c, d, k),
        "dsmc": lambda s, c, d, k: dsmc_collision_update(s, cfg, c, d, k),
    }
    for kind, update in pairwise.items():
        for col in cfg.collisions:
            if col.kind != kind:
                continue
            (sub,) = draws.split(1)
            if state.step % col.ndt == 0:
                state = update(state, col, cfg.dt * col.ndt, sub)
    kinds = {c.kind for c in cfg.collisions}
    if "background_mcc" in kinds:
        state = mcc_collision_update(state, cfg, cfg.dt, draws)
    if "background_stopping" in kinds:
        state = stopping_collision_update(state, cfg, cfg.dt)
    return state


def ionization_substep(state: SimState, cfg: SimConfig, gather, draws):
    """Field ionization of every ionizable species, in the configuration's
    order (doFieldIonization, WarpXEvolve.cpp:157, on the fields at t^n);
    ``gather(positions)`` gives (ex..bz) there."""
    from ..ops.ionization import (IONIZATION_ENERGIES, adk_coefficients,
                                  apply_ionization)

    species = dict(state.species)
    for sp_cfg in cfg.species:
        if not sp_cfg.do_field_ionization:
            continue
        ion = species[sp_cfg.name]
        name_p = sp_cfg.ionization_product_species
        species[sp_cfg.name], species[name_p] = apply_ionization(
            draws, ion, species[name_p],
            gather(ion.positions(cfg.geometry.ndim)),
            adk_coefficients(sp_cfg.physical_element, cfg.dt),
            len(IONIZATION_ENERGIES[sp_cfg.physical_element]),
            cfg.geometry.ndim)
    return state.replace(species=species)


def evolve_optical_depth(sp, sp_cfg, u3, e6, dt):
    """The QED optical depth lowered by dN/dt dt with the pushed momenta
    and the fields at x^n (PushPX evolve_opt_depth; the events run at the
    start of the next step)."""
    from ..ops.qed import bw_dndt, qs_dndt

    if sp_cfg.do_qed_quantum_sync:
        key, rate = "opticalDepthQSR", qs_dndt
    elif sp_cfg.do_qed_breit_wheeler:
        key, rate = "opticalDepthBW", bw_dndt
    else:
        return sp
    return sp.replace(extra={**sp.extra,
                             key: sp.extra[key] - dt * rate(*u3, *e6)})


def pic_step(state: SimState, cfg: SimConfig, staggering: Dict,
             psatd=None, draws=None, medium=None) -> SimState:
    """One explicit electromagnetic PIC step, particle by particle, on the
    periodic domain: binary collisions, field ionization, QED events and
    Schwinger pairs on the numbers of ``draws`` (a ``utils.draws``
    source), gather at x^n, push
    u and x (photons stream at c), lower the QED optical depths, deposit J
    (and rho where the PSATD family needs it), wrap, advance the fields
    (``psatd``, a ``solvers.psatd.PsatdSolver``, or a ``PsatdFirstOrder``
    built with the multi-J sub-step, under em_solver = psatd; the Ohm's-law
    hybrid advance under em_solver = hybrid, with the rho pair; the E
    update of ``medium``, a ``solvers.macroscopic.MacroscopicMedium``, in a
    macroscopic medium).  The gather reads the fields through the Godfrey
    NCI corrector under use_nci_corr.  The cold fluid species deposit
    their rho^n, push and advect on the fields at t^n, then deposit rho^{n+1}
    and J (``solvers/fluids.py``; WarpXFluidContainer::Evolve's order)."""
    _check_pic_step(cfg)
    if draws is None and has_stochastic(cfg):
        raise ValueError("this configuration draws random numbers: pass "
                         "pic_step a utils.draws source")
    geom = cfg.geometry
    ndim = geom.ndim
    dt = cfg.dt
    farr = _field_dict(state.fields, use_avg=cfg.psatd_time_averaging)
    if cfg.use_nci_corr:
        farr = _apply_nci(farr, cfg)
    gather_stag = staggering
    if cfg.field_gathering == "momentum-conserving":
        farr = _nodal_aux(farr, staggering, cfg.field_centering_no or None)
        gather_stag = nodal_staggering(ndim, staggering)

    def gather_at(pos):
        return gather_eb(pos, farr, gather_stag, geom, cfg.particle_shape,
                         cfg.galerkin)

    if cfg.collisions:
        state = collisions_substep(state, cfg, draws)
    if any(s.do_field_ionization for s in cfg.species):
        state = ionization_substep(state, cfg, gather_at, draws)
    if any(s.do_qed_quantum_sync or s.do_qed_breit_wheeler
           for s in cfg.species):
        from ..ops.qed import qed_update

        before = state.species

        def qed_fields(nm):
            sp = before[nm]
            pos = sp.positions(ndim)
            return _add_ext(gather_at(pos), cfg, pos=pos,
                            u3=(sp.ux, sp.uy, sp.uz))

        state = qed_update(state, cfg, qed_fields, draws)
    if cfg.do_qed_schwinger:
        from ..ops.qed import schwinger_update

        state = schwinger_update(state, cfg, dt, draws)

    # Galilean PSATD: the grid drifts at v_galilean (ShiftGalileanBoundary,
    # WarpXEvolve.cpp:234), a time-dependent deposition and gather origin.
    # Each source takes the origin at its own time: J at t^{n+1/2}, rho_new
    # at t^{n+1}, the gather and rho_old at t^n (WarpX::LowerCorner's
    # time_shift_delta, WarpXParticleContainer.cpp:479, 992, 1161); a
    # uniform origin breaks the scheme's Galilean continuity identity and
    # turns the NCI cancellation into a strong instability (the JAX
    # package's core/step.py says more).
    v_act = galilean_velocity(cfg)
    gal_origin = gal_origin_half = gal_origin_new = None
    if v_act is not None:
        gal_origin = [geom.prob_lo[d] + v_act[d] * state.time
                      for d in range(ndim)]
        gal_origin_half = [o + v * (0.5 * dt)
                           for o, v in zip(gal_origin, v_act)]
        gal_origin_new = [o + v * dt for o, v in zip(gal_origin, v_act)]

    is_psatd = cfg.em_solver == "psatd"
    first_order = is_psatd and cfg.psatd_solution_type == "first-order"
    multi_j = (is_psatd and cfg.psatd_j_in_time == "linear"
               and not first_order)
    need_rho = not first_order and (
        (is_psatd and (cfg.psatd_current_correction
                       or cfg.psatd_update_with_rho))
        or cfg.do_dive_cleaning or multi_j or cfg.em_solver == "hybrid")
    mj_parts = []
    rho_old = rho_new = None
    if need_rho:
        kw = dict(dtype=state.fields.Ex.dtype, device=state.fields.Ex.device)
        rho_old = torch.zeros(geom.n_cell, **kw)
        rho_new = torch.zeros(geom.n_cell, **kw)
    chunk = cfg.deposit_chunk_size

    j_total = j_old_total = None
    new_species = {}
    aux = state.aux
    for sp_cfg in cfg.species:
        sp = state.species[sp_cfg.name]
        if sp.capacity == 0:
            new_species[sp_cfg.name] = sp
            continue
        pos = sp.positions(ndim)
        # a species without charge (photons) adds nothing to J or rho
        deposits = not sp_cfg.do_not_deposit and sp_cfg.charge != 0.0
        if need_rho and deposits and not multi_j:
            w_eff0 = torch.where(sp.alive, sp.w, torch.zeros_like(sp.w))
            rho_old = deposit_rho(pos, w_eff0, sp_cfg.charge, geom,
                                  cfg.particle_shape, out=rho_old,
                                  origin=gal_origin, chunk_size=chunk)
        if sp_cfg.do_not_gather:
            e6 = (torch.zeros_like(sp.ux),) * 6
        else:
            e6 = _add_ext(
                gather_eb(pos, farr, gather_stag, geom, cfg.particle_shape,
                          cfg.galerkin, origin=gal_origin),
                cfg, pos=pos, u3=(sp.ux, sp.uy, sp.uz),
            )
        if sp_cfg.do_not_push:
            ux, uy, uz = sp.ux, sp.uy, sp.uz
            new_pos = pos
        elif sp_cfg.species_type == "photon":
            # massless: streaming at c along u, momentum unchanged
            # (PhotonParticleContainer::PushPX)
            ux, uy, uz = sp.ux, sp.uy, sp.uz
            new_pos = photon_position_step(pos, ux, uy, uz, dt, ndim)
        else:
            (ux, uy, uz), new_pos, upd = rigid_push(state, sp_cfg, cfg, pos,
                                                    sp, e6, dt, ndim)
            if upd:
                aux = {**aux, **upd}
        sp = evolve_optical_depth(sp, sp_cfg, (ux, uy, uz), e6, dt)
        w_eff = torch.where(sp.alive, sp.w, torch.zeros_like(sp.w))
        if first_order and deposits:
            # OneStep_multiJ's deposits happen in the sub-step loop
            mj_parts.append((new_pos, (ux, uy, uz), w_eff, sp_cfg))
        elif multi_j and deposits:
            # multi-J (one deposition): J and rho sampled at integer times
            # (OneStep_multiJ, WarpXEvolve.cpp:660-780): J_old and rho_old
            # at relative time -dt (ballistic back from x^{n+1}), J_new
            # and rho_new at the new positions
            args = (new_pos, ux, uy, uz, w_eff, sp_cfg.charge, geom,
                    staggering, dt, cfg.particle_shape)
            j_old_total = _sum3(j_old_total, deposit_current_direct(
                *args, relative_time=-dt, origin=gal_origin_half,
                chunk_size=chunk))
            j_total = _sum3(j_total, deposit_current_direct(
                *args, relative_time=0.0, origin=gal_origin_half,
                chunk_size=chunk))
            ig = inv_gamma(ux, uy, uz)
            vel_act = {3: (ux, uy, uz), 2: (ux, uz), 1: (uz,)}[ndim]
            pos_ball = [p - v * ig * dt for p, v in zip(new_pos, vel_act)]
            rho_old = deposit_rho(pos_ball, w_eff, sp_cfg.charge, geom,
                                  cfg.particle_shape, out=rho_old,
                                  origin=gal_origin, chunk_size=chunk)
        elif deposits:
            if cfg.current_deposition == "esirkepov":
                j3 = deposit_current_esirkepov(
                    new_pos, ux, uy, uz, w_eff, sp_cfg.charge, geom, dt,
                    cfg.particle_shape, chunk_size=chunk,
                    origin=gal_origin_half)
            elif cfg.current_deposition == "vay":
                j3 = deposit_current_vay(
                    new_pos, ux, uy, uz, w_eff, sp_cfg.charge, geom, dt,
                    cfg.particle_shape, chunk_size=chunk,
                    origin=gal_origin_half)
            else:
                j3 = deposit_current_direct(
                    new_pos, ux, uy, uz, w_eff, sp_cfg.charge, geom,
                    staggering, dt, cfg.particle_shape,
                    origin=gal_origin_half, chunk_size=chunk)
            j_total = _sum3(j_total, j3)
        if need_rho and deposits:
            rho_new = deposit_rho(new_pos, w_eff, sp_cfg.charge, geom,
                                  cfg.particle_shape, out=rho_new,
                                  origin=gal_origin_new, chunk_size=chunk)
        shift_new = (None if v_act is None
                     else [v * (state.time + dt) for v in v_act])
        new_species[sp_cfg.name] = wrap_positions(
            sp.replace(ux=ux, uy=uy, uz=uz).with_positions(ndim, new_pos),
            geom, shift=shift_new,
        )

    if cfg.fluids:
        from ..solvers.fluids import (fluid_current, fluid_evolve,
                                      fluid_keys, fluid_rho)

        aux = dict(aux)
        for fl in cfg.fluids:
            keys = fluid_keys(fl.name)
            Nf, NU3 = state.aux[keys[0]], tuple(state.aux[k]
                                                for k in keys[1:])
            if need_rho and not fl.do_not_deposit:
                rho_old = rho_old + fluid_rho(Nf, fl.charge)
            Nf, NU3 = fluid_evolve(Nf, NU3, state.fields, geom, staggering,
                                   fl, dt)
            if need_rho and not fl.do_not_deposit:
                rho_new = rho_new + fluid_rho(Nf, fl.charge)
            if not fl.do_not_deposit:
                j_total = _sum3(j_total, fluid_current(
                    Nf, NU3, geom, staggering, fl.charge))
            aux.update(zip(keys, (Nf,) + tuple(NU3)))

    if first_order:
        fields = _first_order_multi_j(state.fields, cfg, staggering, psatd,
                                      mj_parts)
    else:
        if j_total is None:
            j_total = tuple(torch.zeros_like(state.fields.Ex)
                            for _ in range(3))
        fields = advance_fields(
            state.fields, cfg, j_total, rho_old, rho_new,
            (j_old_total if j_old_total is not None else j_total)
            if multi_j else None,
            psatd, medium)
    return state.replace(
        fields=fields,
        species=new_species,
        step=state.step + 1,
        time=state.time + dt,
        aux=aux,
    )


def _first_order_multi_j(fields, cfg, staggering, solver, parts):
    """The multi-J sub-deposition loop with the first-order PSATD push
    (OneStep_multiJ, WarpXEvolve.cpp:655-840): the particles were pushed to
    x^{n+1}; each of the n_depositions sub-intervals deposits J (and rho
    with cleaning) at ballistic relative times and advances the fields by
    dt / n_depositions (``solver``, a ``PsatdFirstOrder`` built with that
    sub-step, WarpX.cpp:2750).  J of the diagnostics is the last
    sub-deposit."""
    geom = cfg.geometry
    dt = cfg.dt
    n_dep = max(1, cfg.multi_j_n_depositions)
    sub_dt = dt / n_dep
    j_lin = cfg.psatd_j_in_time == "linear"
    rho_lin = cfg.psatd_rho_in_time == "linear"
    div_clean = solver.div_cleaning
    chunk = cfg.deposit_chunk_size

    def active_vel(u3, ig):
        return {3: tuple(u * ig for u in u3),
                2: (u3[0] * ig, u3[2] * ig),
                1: (u3[2] * ig,)}[geom.ndim]

    def dep_j(t_rel):
        tot = tuple(torch.zeros_like(fields.Ex) for _ in range(3))
        for pos, u3, w, sp_cfg in parts:
            if cfg.current_deposition == "esirkepov":
                ig = inv_gamma(*u3)
                pos_s = [p + v * t_rel
                         for p, v in zip(pos, active_vel(u3, ig))]
                j3 = deposit_current_esirkepov(
                    pos_s, *u3, w, sp_cfg.charge, geom, dt,
                    cfg.particle_shape, chunk_size=chunk)
            else:
                j3 = deposit_current_direct(
                    pos, *u3, w, sp_cfg.charge, geom, staggering, dt,
                    cfg.particle_shape, relative_time=t_rel,
                    chunk_size=chunk)
            tot = tuple(a + b for a, b in zip(tot, j3))
        return tuple(_filter(a, cfg) for a in tot) if cfg.use_filter else tot

    def dep_rho(t_rel):
        tot = torch.zeros_like(fields.Ex)
        for pos, u3, w, sp_cfg in parts:
            ig = inv_gamma(*u3)
            pos_s = [p + v * t_rel for p, v in zip(pos, active_vel(u3, ig))]
            tot = deposit_rho(pos_s, w, sp_cfg.charge, geom,
                              cfg.particle_shape, out=tot, chunk_size=chunk)
        return _filter(tot, cfg) if cfg.use_filter else tot

    fmap = {nm: getattr(fields, nm)
            for nm in _FIELDS + (("F", "G") if div_clean else ())}
    j_old = dep_j(-dt) if j_lin else None
    rho_old = dep_rho(-dt) if (div_clean and rho_lin) else None
    j_diag = None
    for i in range(n_dep):
        if j_lin:
            j_new = dep_j((i - n_dep + 1) * sub_dt)
            j_c0 = j_old
            j_c1 = tuple((a - b) / sub_dt for a, b in zip(j_new, j_old))
            j_diag = j_old = j_new
        else:
            j_c0 = dep_j((i - n_dep + 0.5) * sub_dt)
            j_c1 = None
            j_diag = j_c0
        rho_c0 = rho_c1 = None
        if div_clean:
            if rho_lin:
                rho_new = dep_rho((i - n_dep + 1) * sub_dt)
                rho_c0 = rho_old
                rho_c1 = (rho_new - rho_old) / sub_dt
                rho_old = rho_new
            else:
                rho_c0 = dep_rho((i - n_dep + 0.5) * sub_dt)
        fmap = solver.push_first_order(fmap, j_c0, j_c1, rho_c0, rho_c1)
    fmap.update(zip(("jx", "jy", "jz"), j_diag))
    return fields.replace(**fmap)


def advance_fields(fields: FieldState, cfg: SimConfig, j_total,
                   rho_old=None, rho_new=None, j_old_total=None,
                   psatd=None, medium=None) -> FieldState:
    """Filter and store J, then advance the Maxwell fields one step: B half,
    E full (through ``medium`` in a macroscopic medium), B half
    (WarpXEvolve.cpp:373-446; with the F/G cleaning scalars around them,
    from the unfiltered rho pair), or the analytic k-space advance of
    ``psatd`` (PushPSATD, WarpXPushFieldsEM.cpp:717) with the filtered rho
    pair and, for multi-J, J at the start of the step, or the Ohm's-law
    hybrid advance with the filtered rho pair, which carries rho^{n+1} and
    J_i^{n+1/2} to the next step in ``hrho`` and ``hj*``
    (WarpXPushFieldsHybridPIC.cpp:24)."""
    if cfg.em_solver_medium not in ("vacuum", "macroscopic"):
        raise ValueError(f"em_solver_medium {cfg.em_solver_medium!r}")
    if cfg.em_solver_medium == "macroscopic" and medium is None:
        raise ValueError("a macroscopic medium needs its MacroscopicMedium")
    if cfg.em_solver not in ("yee", "ckc", "psatd", "hybrid", "none"):
        # ECT runs on the bounded step's cut cells
        # (core/bounded_step.py::BoundedStepper.advance_b)
        raise NotImplementedError(
            f"em_solver {cfg.em_solver!r} on the periodic field advance (the "
            "JAX package runs plain Yee curls for it; ROADMAP.md Queue C)"
        )
    geom = cfg.geometry
    dt = cfg.dt
    if cfg.use_filter:
        j_total = tuple(_filter(a, cfg) for a in j_total)
    fields = fields.replace(jx=j_total[0], jy=j_total[1], jz=j_total[2])
    if cfg.em_solver == "none":
        return fields
    if cfg.em_solver == "hybrid":
        from ..solvers.hybrid import hybrid_evolve_fields, resistivity
        from .grid import yee_staggering

        if cfg.use_filter:
            rho_old = _filter(rho_old, cfg)
            rho_new = _filter(rho_new, cfg)
        fields = hybrid_evolve_fields(
            fields, rho_old, rho_new, (fields.hjx, fields.hjy, fields.hjz),
            j_total, geom, yee_staggering(geom.ndim), cfg, resistivity(cfg),
            dt)
        return fields.replace(hrho=rho_new, hjx=j_total[0], hjy=j_total[1],
                              hjz=j_total[2])
    if cfg.em_solver == "psatd":
        need_rho = rho_old is not None
        if need_rho and cfg.use_filter:
            rho_old = _filter(rho_old, cfg)
            rho_new = _filter(rho_new, cfg)
        if j_old_total is not None and cfg.use_filter:
            j_old_total = tuple(_filter(a, cfg) for a in j_old_total)
        if cfg.use_hybrid_qed:
            # the Heisenberg-Euler half-correction before and after the
            # spectral push (WarpXEvolve.cpp:386-402 Hybrid_QED_Push)
            fields = hybrid_qed_push(fields, geom, dt, cfg.quantum_xi_c2)
        names = _FIELDS + tuple(nm for nm in ("F", "G")
                                if getattr(fields, nm) is not None)
        new = psatd.push({nm: getattr(fields, nm) for nm in names},
                         (rho_old, rho_new) if need_rho else None,
                         j_old=j_old_total)
        fields = fields.replace(**{nm: new[nm] for nm in new
                                   if nm in names or nm.endswith("_avg")})
        if cfg.use_hybrid_qed:
            fields = hybrid_qed_push(fields, geom, dt, cfg.quantum_xi_c2)
        return fields
    # with divergence cleaning the scalars advance half steps around the B
    # pushes: F,G | B (+grad G) | E (+grad F) | F,G | B (+grad G)
    # (WarpXEvolve.cpp:416-437); a collocated grid takes the centered
    # differences (CartesianNodalAlgorithm)
    algo = "nodal" if cfg.grid_type == "collocated" else cfg.em_solver
    dive, divb = cfg.do_dive_cleaning, cfg.do_divb_cleaning
    F, G = fields.F, fields.G
    if dive:
        F = yee.evolve_f(F, fields, rho_old, geom, 0.5 * dt, algo)
    if divb:
        G = yee.evolve_g(G, fields, geom, 0.5 * dt, algo)
    fields = yee.evolve_b(fields, geom, 0.5 * dt, algo)
    if divb:
        fields = yee.add_grad_g(fields, G, geom, 0.5 * dt, algo)
    if medium is not None:
        from ..solvers.macroscopic import evolve_e_macroscopic

        fields = evolve_e_macroscopic(fields, medium, geom, dt)
    else:
        fields = yee.evolve_e(fields, geom, dt, algo)
    if dive:
        fields = yee.add_grad_f(fields, F, geom, dt, algo)
        F = yee.evolve_f(F, fields, rho_new, geom, 0.5 * dt, algo)
    if divb:
        G = yee.evolve_g(G, fields, geom, 0.5 * dt, algo)
    fields = yee.evolve_b(fields, geom, 0.5 * dt, algo)
    if divb:
        fields = yee.add_grad_g(fields, G, geom, 0.5 * dt, algo)
    return fields.replace(F=F, G=G)
