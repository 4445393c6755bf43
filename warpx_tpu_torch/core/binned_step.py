"""Tile-binned explicit EM PIC step (2D XZ and 3D periodic) -- the port's
hot path.

The counterpart of ``warpx_tpu.core.binned_step``: the explicit step
(OneStep_nosub, WarpXEvolve.cpp:354-460) restricted to its hot core
(periodic, Yee/CKC or rho-free PSATD, Boris/Vay/HC push, Esirkepov
deposition, no particle creation), run through the tile-binned layout
(``ops/tiling.py``) and the fused kernel (``ops/fused_pic.py``):

  rebin every ``interval`` steps (kernel K3) -> guard-pad the fields ->
  fused gather + push + deposit per pusher group (kernel K1 in 3D, K2 in
  2D) -> fold the J windows -> Maxwell advance (``advance_fields``).

Positions stay unwrapped between rebins so window-relative coordinates are
continuous across the periodic boundary; rebin wraps them.
``state.aux['tile_overflow']`` and ``state.aux['tile_violations']``
accumulate the layout-safety counters that the host must find zero.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..constants import c as _c
from ..ops.fused_pic import binned_push_deposit, pad_fields
from ..ops.tiling import TileSpec, fold_windows, rebin
from .config import SimConfig
from .state import SimState
from .step import advance_fields

__all__ = ["binned_supported", "bounded_binned_supported", "make_tile_spec",
           "binned_capacity", "binned_pic_step", "pusher_params",
           "pusher_groups"]

# per-component window-axis order emitted by the fused kernels
_FOLD_AXES = {3: ((0, 1, 2), (1, 0, 2), (2, 0, 1)),
              2: ((0, 1), (0, 1), (0, 1))}


def binned_supported(cfg: SimConfig) -> bool:
    """Whether the port's tile-binned path covers this configuration (the
    JAX package's ``binned_supported``)."""
    geom = cfg.geometry
    if cfg.tiled_particles == "off":
        return False
    if geom.ndim not in (2, 3) or not geom.all_periodic:
        return False
    # mesh refinement runs per particle (core/mr.py)
    if cfg.max_level > 0:
        return False
    if cfg.em_solver not in ("yee", "ckc", "psatd", "none"):
        return False
    if cfg.em_solver_medium != "vacuum":
        return False
    # implicit schemes and embedded boundaries have steps of their own;
    # fluids run in the per-particle step (the JAX package's periodic gate
    # passes them, and its binned step has no fluid code: ROADMAP.md
    # Queue C)
    if (cfg.evolve_scheme != "explicit" or cfg.fluids
            or cfg.eb_implicit_function):
        return False
    if cfg.em_solver == "psatd":
        # rho-free standard PSATD only (current correction and multi-J need
        # rho deposits the kernels do not make)
        if (cfg.psatd_current_correction or cfg.psatd_update_with_rho
                or cfg.psatd_j_in_time != "constant"
                or any(cfg.psatd_v_galilean)):
            return False
    if cfg.current_deposition != "esirkepov":
        return False
    if cfg.grid_type != "staggered":
        return False
    # the JAX package's periodic gate passes momentum-conserving gathering,
    # the lattice and rigid injection, and its kernel then gathers the
    # staggered fields, adds only the constant external fields and pushes
    # every particle: here they go per particle (ROADMAP.md Queue C)
    if cfg.field_gathering == "momentum-conserving" or cfg.lattice_elements:
        return False
    if any(sp.zinject_plane is not None for sp in cfg.species):
        return False
    if not (1 <= cfg.particle_shape <= 3):
        return False
    if cfg.do_dive_cleaning or cfg.do_divb_cleaning:
        return False
    if cfg.use_nci_corr:
        return False
    if any(n % t for n, t in zip(geom.n_cell, cfg.tile_size[-geom.ndim:])):
        return False
    # the JAX package's periodic gate passes QED species and Schwinger,
    # but its binned step runs neither: here they go per particle, where
    # both packages run them (ROADMAP.md Queue C); resampling runs on the
    # binned layout after the step
    if cfg.do_qed_schwinger:
        return False
    # the JAX package's binned gates refuse every collision
    # (``binned_step.py:70``): collision decks run per particle
    if cfg.collisions:
        return False
    for sp in cfg.species:
        # a plane-emitting species goes per particle as on the JAX
        # package's bounded gate (``binned_step.py:144``): its new
        # particles would land in free slots of tiles they are not in
        # (the JAX package's periodic gate passes it; ROADMAP.md Queue C)
        if (sp.do_not_push or sp.do_not_deposit or sp.do_not_gather
                or sp.species_type == "photon" or sp.mass == 0.0
                or sp.do_field_ionization or sp.do_qed_quantum_sync
                or sp.do_qed_breit_wheeler
                or sp.injection_style == "nfluxpercell"
                or sp.pusher not in ("boris", "vay", "higuera")):
            return False
    return True


def bounded_binned_supported(cfg: SimConfig) -> bool:
    """Whether the tile-binned step covers this bounded configuration
    (non-periodic faces, moving window, lasers:
    ``core/bounded_step.py::step_binned``): the JAX package's
    ``bounded_binned_supported``.  Only the gather + push + deposit block
    moves onto the fused kernels; guard fills, J filter and fold, field
    advance (FDTD or PSATD, Silver-Mueller faces), PML, particle boundaries
    (thermal walls, scraping buffers) and continuous injection (Gaussian
    momenta) are the per-particle step's."""
    geom = cfg.geometry
    if cfg.tiled_particles == "off":
        return False
    if geom.ndim not in (2, 3) or geom.rz:
        return False
    # the bounded step carries mesh refinement per particle only (the JAX
    # package's simulation.py:126)
    if cfg.max_level > 0:
        return False
    if cfg.em_solver not in ("yee", "ckc", "psatd"):
        return False
    if cfg.em_solver_medium != "vacuum":
        return False
    # the JAX package's gate refuses embedded boundaries
    # (binned_step.py:129) and implicit schemes
    if cfg.eb_implicit_function or cfg.evolve_scheme != "explicit":
        return False
    if cfg.em_solver == "psatd":
        if (cfg.psatd_current_correction or cfg.psatd_update_with_rho
                or cfg.psatd_j_in_time != "constant"
                or cfg.psatd_time_averaging
                or cfg.multi_j_n_depositions > 1
                or any(cfg.psatd_v_galilean) or any(cfg.psatd_v_comoving)):
            return False
    if cfg.current_deposition != "esirkepov":
        return False
    if cfg.grid_type != "staggered":
        return False
    if cfg.field_gathering == "momentum-conserving":
        return False
    if not (1 <= cfg.particle_shape <= 3):
        return False
    if cfg.do_dive_cleaning or cfg.do_divb_cleaning:
        return False
    if cfg.do_moving_window and cfg.moving_window_dir != geom.ndim - 1:
        return False
    # the JAX package's ``binned_step.py:127``
    if cfg.collisions or cfg.lattice_elements:
        return False
    if any(n % t for n, t in zip(geom.n_cell, cfg.tile_size[-geom.ndim:])):
        return False
    for sp in cfg.species:
        if sp.injection_style == "laser":
            continue  # the antenna deposits on the per-particle path
        if (sp.do_not_push or sp.do_not_deposit or sp.do_not_gather
                or sp.species_type == "photon" or sp.mass == 0.0
                or sp.do_field_ionization or sp.do_resampling
                or sp.do_qed_quantum_sync or sp.do_qed_breit_wheeler
                or sp.zinject_plane is not None
                or sp.injection_style == "nfluxpercell"
                or sp.pusher not in ("boris", "vay", "higuera")):
            return False
    return True


def make_tile_spec(cfg: SimConfig, n_particles: int) -> TileSpec:
    geom = cfg.geometry
    margin = cfg.sort_margin
    if margin <= 0:
        # worst-case drift: c*dt/dx cells per step, for sort_interval steps
        per_step = max(_c * cfg.dt / d for d in geom.dx)
        margin = max(1, int(math.ceil(cfg.sort_interval * per_step)))
    return TileSpec.create(
        geom.n_cell,
        order=cfg.particle_shape,
        n_particles=n_particles,
        tile=cfg.tile_size,
        margin=margin,
        interval=cfg.sort_interval,
        headroom=cfg.tile_headroom,
    )


def binned_capacity(cfg: SimConfig, n_particles: int) -> int:
    return make_tile_spec(cfg, n_particles).capacity


def pusher_params(cfg: SimConfig, dtype: torch.dtype, device: torch.device,
                  species=None) -> Dict[str, Tuple[tuple, torch.Tensor]]:
    """Per pusher, its species' configs and their fused-kernel params
    (n_sp, 8): charge, mass, external E, external B.  Built once per
    simulation, so no step copies them to the device.  ``species`` (default
    all of ``cfg.species``) are the species laid out in tiles."""
    groups: Dict[str, list] = {}
    for sp_cfg in (cfg.species if species is None else species):
        groups.setdefault(sp_cfg.pusher, []).append(sp_cfg)
    return {
        name: (tuple(sps), torch.tensor(
            [[s.charge, s.mass, *cfg.e_ext_particle, *cfg.b_ext_particle]
             for s in sps], dtype=dtype, device=device))
        for name, sps in groups.items()
    }


def pusher_groups(state: SimState, spec: TileSpec, params: Dict):
    """The fused kernel's inputs, one launch per pusher: yields
    (pusher_name, species configs, params (n_sp, 8), parts7, counts), with
    ``params`` from ``pusher_params``.  ``parts7`` is (x, y, z, ux, uy, uz,
    w) in 3D and (x, z, ux, uy, uz, w) in 2D."""
    nt, pmax = spec.n_tiles, spec.p_max
    for pusher_name, (sps, p) in params.items():
        cols = [[] for _ in range(spec.ndim + 4)]
        cnts = []
        for sp_cfg in sps:
            sp = state.species[sp_cfg.name]
            w_eff = torch.where(sp.alive, sp.w, torch.zeros((), dtype=p.dtype,
                                                             device=p.device))
            for ci, a in enumerate((*sp.positions(spec.ndim), sp.ux, sp.uy,
                                    sp.uz, w_eff)):
                cols[ci].append(a.reshape(nt, pmax))
            cnts.append(sp.alive.reshape(nt, pmax).sum(dim=1,
                                                       dtype=torch.int32))
        parts7 = tuple(torch.cat(c, dim=0) for c in cols)
        yield pusher_name, sps, p, parts7, torch.cat(cnts)


def binned_pic_step(state: SimState, cfg: SimConfig, staggering: Dict,
                    spec: TileSpec, params: Dict, psatd=None) -> SimState:
    """One fused explicit EM PIC step over the tile-binned layout;
    ``params`` is ``pusher_params(cfg, ...)`` on the state's device,
    ``psatd`` the spectral solver under em_solver = psatd."""
    geom = cfg.geometry
    ndim = geom.ndim
    dt = cfg.dt
    nt = spec.n_tiles
    stag_items = tuple(sorted((k, tuple(v)) for k, v in staggering.items()))

    # --- rebin (every spec.interval steps) --------------------------------
    species = dict(state.species)
    overflow = state.aux["tile_overflow"]
    if state.step % spec.interval == 0:
        for sp_cfg in cfg.species:
            species[sp_cfg.name], ovf = rebin(species[sp_cfg.name], geom,
                                              spec)
            overflow = overflow + ovf
    state = state.replace(species=species)

    # --- guard-padded fields (FillBoundary analog) ------------------------
    farr = state.fields
    fields6 = pad_fields(
        (farr.Ex, farr.Ey, farr.Ez, farr.Bx, farr.By, farr.Bz), spec
    )

    # --- fused gather + push + deposit: one launch per pusher -------------
    jw_tot = None
    violations = state.aux["tile_violations"]
    new_species = {}
    for pusher_name, sps, params, parts7, counts in pusher_groups(
            state, spec, params):
        newp, jw, viol = binned_push_deposit(
            params, fields6, parts7, counts=counts,
            spec=spec, geom=geom, order=cfg.particle_shape,
            galerkin=cfg.galerkin, pusher_name=pusher_name, dt=dt,
            stag_items=stag_items, mxu=cfg.tile_mxu,
        )
        jw_tot = jw if jw_tot is None else tuple(
            a + b for a, b in zip(jw_tot, jw)
        )
        violations = violations + viol.sum(dtype=torch.int32)
        for k, sp_cfg in enumerate(sps):
            sl = slice(k * nt, (k + 1) * nt)
            flat = [a[sl].reshape(-1) for a in newp]
            new_species[sp_cfg.name] = species[sp_cfg.name].replace(
                ux=flat[ndim], uy=flat[ndim + 1], uz=flat[ndim + 2],
            ).with_positions(ndim, flat[:ndim])

    # --- fold J windows (SumBoundary analog) ------------------------------
    f = farr.Ex
    if jw_tot is None:
        j_total = tuple(torch.zeros(geom.n_cell, dtype=f.dtype,
                                    device=f.device) for _ in range(3))
    else:
        j_total = tuple(
            fold_windows(jw_tot[i], spec, geom.n_cell,
                         axes=_FOLD_AXES[ndim][i])
            for i in range(3)
        )

    fields = advance_fields(state.fields, cfg, j_total, psatd=psatd)
    aux = dict(state.aux)
    aux["tile_overflow"] = overflow
    aux["tile_violations"] = violations
    return state.replace(
        fields=fields,
        species=new_species,
        step=state.step + 1,
        time=state.time + dt,
        aux=aux,
    )
