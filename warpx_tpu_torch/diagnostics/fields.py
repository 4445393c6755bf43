"""Field diagnostics: cell-centered output arrays (staggered grids).

The counterpart of ``warpx_tpu.diagnostics.fields`` for the staggered
electromagnetic case, periodic and bounded: every staggered field is
interpolated to cell centers as the reference's full diagnostics do
(CellCenterFunctor -> ablastr::coarsen::sample::Interp: the value at cell i
averages the two surrounding points along every nodal dimension).  On a
bounded domain the PML strips are cropped away first, rho is deposited on a
guard-padded block at the moving window's origin, filtered there and its
guards folded, and divE/divB are exact differences on the physical region.
On the periodic domain under PSATD divE is the solver's spectral i k.E.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.config import SimConfig
from ..core.domain import DomainLayout
from ..core.state import SimState
from ..ops.deposit import count_particles_per_cell, deposit_rho
from ..solvers import yee
from ..solvers.filter import bilinear_filter, bilinear_filter_padded

__all__ = ["cell_center", "cell_centered_output", "deposit_total_rho",
           "current_origin"]


def cell_center(arr: torch.Tensor, nodal_flags, n_cell=None) -> torch.Tensor:
    """Average the nodal dims to cell centers.  A nodal dim stored with n+1
    values (bounded: both wall nodes) averages adjacent nodes; one stored
    with n values is periodic and wraps."""
    out = arr
    for d, flag in enumerate(nodal_flags):
        if flag != 1:
            continue
        if n_cell is not None and out.shape[d] == n_cell[d] + 1:
            n = n_cell[d]
            out = 0.5 * (out.narrow(d, 0, n) + out.narrow(d, 1, n))
        else:
            out = 0.5 * (out + torch.roll(out, -1, dims=d))
    return out


def current_origin(state: SimState, cfg: SimConfig):
    """Coordinate of array index 0 of the physical region per dim (the
    moving window's lower edge on its axis)."""
    origin = list(cfg.geometry.prob_lo)
    if cfg.do_moving_window and "window_lo" in state.aux:
        origin[cfg.moving_window_dir] = state.aux["window_lo"]
    return origin


def _slice(ndim, d, a, b):
    idx = [slice(None)] * ndim
    idx[d] = slice(a, b)
    return tuple(idx)


def deposit_total_rho(state: SimState, cfg: SimConfig) -> torch.Tensor:
    """Nodal charge density summed over species (lasers included) at the
    current positions (RhoFunctor -> GetChargeDensity, then
    ApplyFilterandSumBoundaryRho: filter with guards, fold the periodic
    guards, fold the images at the other faces; WarpXComm.cpp:1552)."""
    geom = cfg.geometry
    ndim = geom.ndim
    f = state.fields.Ex
    origin = current_origin(state, cfg)
    bc_lo = cfg.field_bc_lo or ("periodic",) * ndim
    all_periodic = all(bc == "periodic" for bc in bc_lo)
    npass = cfg.filter_npass_each_dir or (1,) * ndim
    ng = cfg.particle_shape + 3 + (max(npass) if cfg.use_filter else 0)
    if all_periodic:
        shape, kw = geom.n_cell, dict(origin=origin)
    else:
        shape = tuple(geom.n_cell[d] + (0 if bc_lo[d] == "periodic" else 1)
                      + 2 * ng for d in range(ndim))
        kw = dict(origin=origin, wrap=False, offset=ng, out_shape=shape)
    rho = torch.zeros(shape, dtype=f.dtype, device=f.device)
    for sp_cfg in cfg.species:
        sp = state.species[sp_cfg.name]
        if sp.capacity == 0 or sp_cfg.do_not_deposit:
            continue
        w_eff = torch.where(sp.alive, sp.w, torch.zeros_like(sp.w))
        rho = deposit_rho(sp.positions(ndim), w_eff, sp_cfg.charge, geom,
                          cfg.particle_shape, out=rho,
                          chunk_size=cfg.deposit_chunk_size, **kw)
    if all_periodic:
        return bilinear_filter(rho, npass) if cfg.use_filter else rho
    if cfg.use_filter:
        rho = bilinear_filter_padded(rho, npass)
    # fold the guards: periodic wrap-add, or the PEC image fold with sign -1
    # and zeroed wall nodes (ApplyRhofieldBoundary -> SetRhoOrJfieldFromPEC,
    # WarpX_PEC.cpp:355-406, after the filter)
    for d in reversed(range(ndim)):
        n_tot = rho.shape[d]
        n = geom.n_cell[d]
        if bc_lo[d] == "periodic":
            valid = rho[_slice(ndim, d, ng, n_tot - ng)].clone()
            valid[_slice(ndim, d, n - ng, n)] += rho[_slice(ndim, d, 0, ng)]
            valid[_slice(ndim, d, 0, ng)] += \
                rho[_slice(ndim, d, n_tot - ng, n_tot)]
            rho = valid
        else:
            rho = rho.clone()
            for k in range(1, ng + 1):
                rho.select(d, ng + n - k).sub_(rho.select(d, ng + n + k))
                rho.select(d, ng + k).sub_(rho.select(d, ng - k))
            rho.select(d, ng + n).zero_()
            rho.select(d, ng).zero_()
            rho = rho[_slice(ndim, d, ng, ng + n + 1)]
    return rho.contiguous()


def _bounded_div(comp, cfg):
    """divE (nodal) and divB (cell-centered) on a bounded staggered grid:
    exact differences on the physical region (a nodal dim holds n+1 values,
    wall nodes included); divE at a wall takes a zero exterior."""
    geom = cfg.geometry
    ndim = geom.ndim
    bc_lo = cfg.field_bc_lo or ("periodic",) * ndim
    div_b = div_e = None
    for d, axn in enumerate(geom.axis_names):
        b_arr = comp("B" + axn)
        if b_arr.shape[d] == geom.n_cell[d] + 1:
            tb = torch.diff(b_arr, dim=d) / geom.dx[d]
        else:
            tb = (torch.roll(b_arr, -1, dims=d) - b_arr) / geom.dx[d]
        div_b = tb if div_b is None else div_b + tb
        e_arr = comp("E" + axn)
        if bc_lo[d] != "periodic":
            pad = [0, 0] * ndim
            pad[2 * (ndim - 1 - d)] = pad[2 * (ndim - 1 - d) + 1] = 1
            te = torch.diff(torch.nn.functional.pad(e_arr, pad), dim=d) \
                / geom.dx[d]
        else:
            te = (e_arr - torch.roll(e_arr, 1, dims=d)) / geom.dx[d]
        div_e = te if div_e is None else div_e + te
    return div_e, div_b


def cell_centered_output(state: SimState, cfg: SimConfig, staggering: Dict,
                         names=None, psatd=None) -> Dict[str, torch.Tensor]:
    """E, B, j, rho, divE, divB and part_per_cell at cell centers (those of
    ``names`` only, when given); ``psatd`` is the periodic spectral solver
    under em_solver = psatd."""
    geom = cfg.geometry
    if cfg.field_gathering == "momentum-conserving":
        raise NotImplementedError(
            "momentum-conserving gathering's output fields "
            "(ROADMAP.md Queue A 11.4)"
        )

    def want(name):
        return names is None or name in names

    f = state.fields
    layout = DomainLayout.from_config(cfg)
    crops = ({name: layout.phys_slice(flags)
              for name, flags in staggering.items()}
             if layout.has_ext else None)

    def comp(name):
        # averaged PSATD: the E/B diagnostics read the time-averaged fields
        # (Efield_avg_fp)
        if (cfg.psatd_time_averaging and name[0] in "EB"
                and getattr(f, name + "_avg", None) is not None):
            arr = getattr(f, name + "_avg")
        else:
            arr = getattr(f, name)
        return arr if crops is None else arr[crops[name]]

    # Vay deposition stores the nodal J that the solver derived from D
    flags = dict(staggering)
    if cfg.current_deposition == "vay":
        flags.update({nm: (1,) * geom.ndim for nm in ("jx", "jy", "jz")})
    out = {}
    for name in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"):
        if want(name):
            out[name] = cell_center(comp(name), flags[name], geom.n_cell)
    if want("rho"):
        out["rho"] = cell_center(deposit_total_rho(state, cfg),
                                 staggering["rho"], geom.n_cell)
    for name in ("F", "G"):
        # the divergence-cleaning scalars, where the run carries them
        if getattr(f, name) is not None and want(name):
            out[name] = cell_center(comp(name), staggering[name],
                                    geom.n_cell)
    if want("divE") or want("divB"):
        bc_lo = cfg.field_bc_lo or ("periodic",) * geom.ndim
        if all(bc == "periodic" for bc in bc_lo):
            # spectral i k.E under PSATD (DivEFunctor -> ComputeDivE)
            if cfg.em_solver == "psatd" and psatd is not None:
                div_e = psatd.spectral_div_e(
                    {nm: getattr(f, nm) for nm in ("Ex", "Ey", "Ez")})
            else:
                div_e = yee.compute_div_e(f, geom)
            div_b = yee.compute_div_b(f, geom)
        else:
            div_e, div_b = _bounded_div(comp, cfg)
        if want("divE"):
            out["divE"] = cell_center(div_e, (1,) * geom.ndim, geom.n_cell)
        if want("divB"):
            out["divB"] = div_b
    if want("part_per_cell"):
        origin = current_origin(state, cfg)
        ppc = torch.zeros(geom.n_cell, dtype=f.Ex.dtype, device=f.Ex.device)
        for sp_cfg in cfg.species:
            sp = state.species[sp_cfg.name]
            if sp.capacity:
                ppc = ppc + count_particles_per_cell(
                    sp.positions(geom.ndim), sp.alive, geom, origin=origin
                )
        out["part_per_cell"] = ppc
    return out
