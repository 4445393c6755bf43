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

``cell_centered_slice`` gives the same values on one cell plane across the
last axis (the back-transformed diagnostics' slice), with rho deposited by
the particles whose cell lies in a slab around that plane only: the same
sums, in the same order, for a fraction of the particles.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.config import SimConfig
from ..core.domain import DomainLayout
from ..core.state import SimState
from ..ops.deposit import (count_particles_per_cell, deposit_current_direct,
                           deposit_current_esirkepov, deposit_rho)
from ..solvers import yee
from ..solvers.filter import bilinear_filter, bilinear_filter_padded

__all__ = ["cell_center", "cell_centered_output", "cell_centered_slice",
           "deposit_total_rho", "current_origin", "slab_reach"]


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


def _slab_select(state, cfg, sp, k_lo, k_hi, cap):
    """The particles of ``sp`` whose cell along the last axis (from the
    current origin) lies in [k_lo, k_hi], in slot order: (idx, w_eff,
    overflow).  A compaction of static size ``cap`` with no wait for the
    device: the j-th selected slot is the first whose running count of
    selected slots reaches j; room past the selected count takes the last
    slot at zero weight, and ``overflow`` (a device int) counts the
    selected particles beyond ``cap``."""
    geom = cfg.geometry
    zd = geom.ndim - 1
    z = sp.positions(geom.ndim)[zd]
    iz = torch.floor((z - current_origin(state, cfg)[zd])
                     * (1.0 / geom.dx[zd]))
    mask = sp.alive & (iz >= k_lo) & (iz <= k_hi)
    rank = torch.cumsum(mask, 0)
    count = rank[-1]
    want = torch.arange(1, cap + 1, device=z.device)
    idx = torch.searchsorted(rank, want).clamp_(max=mask.shape[0] - 1)
    w_eff = torch.where(want <= count, sp.w[idx],
                        torch.zeros((), dtype=sp.w.dtype, device=z.device))
    return idx, w_eff, torch.clamp(count - cap, min=0)


def slab_reach(cfg: SimConfig) -> int:
    """Cells from a plane to the particles its cell-centered rho reaches
    back to (the cell-center average, the filter's passes, the stencil):
    also the guard width of the bounded rho deposit."""
    npass = cfg.filter_npass_each_dir or (1,) * cfg.geometry.ndim
    return (cfg.particle_shape + 3
            + (max(npass) if cfg.use_filter else 0))


def _patch_exclusion(state: SimState, cfg: SimConfig):
    """Under mesh refinement with a patch short of the whole domain, the
    mask of the particles deep in the patch (at the window's offset), as a
    function of the positions; None otherwise."""
    if cfg.max_level <= 0:
        return None
    from ..core.grid import yee_staggering
    from ..core.mr import MRLayout

    ndim = cfg.geometry.ndim
    lay = MRLayout(cfg, yee_staggering(ndim))
    if lay.full_domain:
        return None
    patch_lo = list(lay.patch_lo)
    if cfg.do_moving_window and "window_lo" in state.aux:
        wd = cfg.moving_window_dir
        patch_lo[wd] = patch_lo[wd] + (state.aux["window_lo"]
                                       - cfg.geometry.prob_lo[wd])
    return lambda pos: lay.fine_mask(pos, lay.dep_buf, patch_lo)


def deposit_total_rho(state: SimState, cfg: SimConfig,
                      slab=None, only=None) -> torch.Tensor:
    """Nodal charge density summed over species (lasers included) at the
    current positions (RhoFunctor -> GetChargeDensity, then
    ApplyFilterandSumBoundaryRho: filter with guards, fold the periodic
    guards, fold the images at the other faces; WarpXComm.cpp:1552).

    ``slab`` = (k_lo, k_hi, plan, overflow): a species named in ``plan``
    deposits only some of its slots, in slot order: ``("slots", idx)``
    those of ``idx`` (the caller knows that no particle near the slab is
    elsewhere), ``("room", cap)`` those whose cell along the last axis lies
    in [k_lo, k_hi], selected by ``_slab_select`` into ``cap`` places, each
    species' device count of the selected particles without a place
    appended to ``overflow`` (a list).  The other species deposit whole.
    ``only`` (species names) keeps the others out, as a relativistic
    electrostatic solve deposits one species at a time."""
    geom = cfg.geometry
    ndim = geom.ndim
    f = state.fields.Ex
    origin = current_origin(state, cfg)
    bc_lo = cfg.field_bc_lo or ("periodic",) * ndim
    all_periodic = all(bc == "periodic" for bc in bc_lo)
    npass = cfg.filter_npass_each_dir or (1,) * ndim
    ng = slab_reach(cfg)
    if all_periodic:
        shape, kw = geom.n_cell, dict(origin=origin)
    else:
        shape = tuple(geom.n_cell[d] + (0 if bc_lo[d] == "periodic" else 1)
                      + 2 * ng for d in range(ndim))
        kw = dict(origin=origin, wrap=False, offset=ng, out_shape=shape)
    rho = torch.zeros(shape, dtype=f.dtype, device=f.device)
    patch_excl = _patch_exclusion(state, cfg)
    for sp_cfg in cfg.species:
        sp = state.species[sp_cfg.name]
        if sp.capacity == 0 or sp_cfg.do_not_deposit:
            continue
        if only is not None and sp_cfg.name not in only:
            continue
        pos = sp.positions(ndim)
        if patch_excl is not None:
            # mesh refinement: the particles deep in the fine patch live
            # on level 1, so level 0's rho leaves them out (GetChargeDensity
            # (0) deposits level 0's particles; JAX fields.py:68-103)
            sp = sp.replace(alive=sp.alive & ~patch_excl(pos))
        how, arg = (None, None) if slab is None else slab[2].get(
            sp_cfg.name, (None, None))
        if how == "slots":
            pos = [p[arg] for p in pos]
            w_eff = torch.where(sp.alive[arg], sp.w[arg],
                                torch.zeros((), dtype=sp.w.dtype,
                                            device=sp.w.device))
        elif how == "room" and arg < sp.capacity:
            idx, w_eff, ovf = _slab_select(state, cfg, sp, slab[0],
                                           slab[1], arg)
            slab[3].append(ovf)
            pos = [p[idx] for p in pos]
        else:
            w_eff = torch.where(sp.alive, sp.w, torch.zeros_like(sp.w))
        rho = deposit_rho(pos, w_eff, sp_cfg.charge, geom,
                          cfg.particle_shape, out=rho,
                          chunk_size=cfg.deposit_chunk_size, **kw)
    if all_periodic:
        if cfg.use_filter:
            rho = bilinear_filter(rho, npass)
        if cfg.fluids and only is None:
            # the cold fluids' nodal q N, unfiltered (JAX fields.py:104-136)
            from ..solvers.fluids import fluid_rho

            for fl in cfg.fluids:
                if not fl.do_not_deposit:
                    rho = rho + fluid_rho(state.aux[f"fluid_N:{fl.name}"],
                                          fl.charge)
        return rho
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


def _nodal_aux_bounded(f, staggering: Dict, cfg: SimConfig) -> Dict:
    """E and B averaged to the nodes, as momentum-conserving gathering
    reads them (the aux fields; JAX diagnostics/fields.py:203-245): on a
    periodic axis the two-point average or the Fornberg centering of order
    ``field_centering_no``; on a bounded one the two-point average inside,
    and half the edge value at either end (the unfilled zero guard)."""
    from ..core.step import center_periodic

    ndim = cfg.geometry.ndim
    bc_lo = cfg.field_bc_lo or ("periodic",) * ndim
    orders = cfg.field_centering_no or (2,) * ndim
    out = {}
    for name in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
        a = getattr(f, name)
        for d, flag in enumerate(staggering[name]):
            if flag != 0:
                continue
            if bc_lo[d] != "periodic":
                n = a.shape[d]
                core = 0.5 * (a.narrow(d, 0, n - 1) + a.narrow(d, 1, n - 1))
                a = torch.cat([0.5 * a.narrow(d, 0, 1), core,
                               0.5 * a.narrow(d, n - 1, 1)], dim=d)
            else:
                a = center_periodic(a, d, orders[d])
        out[name] = a
    return out


def _components(state: SimState, cfg: SimConfig, staggering: Dict,
                aux: bool = True):
    """(comp, flags): ``comp(name)`` is a field on the physical region
    (the PML strips cropped away; the time-averaged E/B of averaged PSATD,
    Efield_avg_fp; with ``aux`` under momentum-conserving gathering the
    nodal E/B the gather reads, which the outputs show,
    CellCenterFunctor on Efield_aux), ``flags`` its nodal flags (Vay
    deposition stores the nodal J that the solver derived from D)."""
    f = state.fields
    layout = DomainLayout.from_config(cfg)
    crops = ({name: layout.phys_slice(flags)
              for name, flags in staggering.items()}
             if layout.has_ext else None)
    mc = (_nodal_aux_bounded(f, staggering, cfg)
          if aux and cfg.field_gathering == "momentum-conserving" else {})

    def comp(name):
        if name in mc:
            arr = mc[name]
        elif (cfg.psatd_time_averaging and name[0] in "EB"
                and getattr(f, name + "_avg", None) is not None):
            arr = getattr(f, name + "_avg")
        else:
            arr = getattr(f, name)
        return arr if crops is None else arr[crops[name]]

    flags = dict(staggering)
    flags.update({nm: (1,) * cfg.geometry.ndim for nm in mc})
    if cfg.current_deposition == "vay":
        flags.update({nm: (1,) * cfg.geometry.ndim
                      for nm in ("jx", "jy", "jz")})
    return comp, flags


def _center_plane(arr, nodal_flags, n_cell, k):
    """``cell_center(arr, nodal_flags, n_cell)`` at index ``k`` of the last
    axis only, with the same arithmetic in the same order."""
    zd = len(n_cell) - 1
    if nodal_flags[zd] != 1:
        part = arr.narrow(zd, k, 1)
    elif arr.shape[zd] == n_cell[zd] + 1:
        part = arr.narrow(zd, k, 2)
    else:  # periodic: the next node wraps
        part = arr.index_select(zd, torch.tensor(
            [k, (k + 1) % n_cell[zd]], device=arr.device))
    sub = list(n_cell)
    sub[zd] = part.shape[zd] - nodal_flags[zd]
    return cell_center(part, nodal_flags, sub).select(zd, 0)


def cell_centered_slice(state: SimState, cfg: SimConfig, staggering: Dict,
                        names, k: int, overflow=None, plan=None) -> Dict:
    """The values ``cell_centered_output(..., names=names)`` holds at index
    ``k`` of the last axis, for E, B, j, rho, F and G.  With ``plan`` (per
    species, the slots that hold every particle within ``slab_reach``
    cells of the plane, or the room to select them into:
    ``deposit_total_rho``'s ``slab``) rho is deposited by those only,
    unless the slab comes near a bounded face along that axis (the guard
    fold there mixes in the images) or that axis is periodic; ``overflow``
    (a list) then receives the selection's device counts of particles
    without room."""
    geom = cfg.geometry
    zd = geom.ndim - 1
    comp, flags = _components(state, cfg, staggering)
    out = {}
    for name in names:
        if name == "rho":
            continue
        out[name] = _center_plane(comp(name), flags[name], geom.n_cell, k)
    if "rho" in names:
        reach = ng = slab_reach(cfg)
        n = geom.n_cell[zd]
        bc = (cfg.field_bc_lo or ("periodic",) * geom.ndim)[zd]
        slab = None
        if (plan and bc != "periodic" and k - reach > 2 * ng
                and k + reach < n - 2 * ng):
            slab = (k - reach, k + 1 + reach, plan,
                    overflow if overflow is not None else [])
        out["rho"] = _center_plane(deposit_total_rho(state, cfg, slab),
                                   staggering["rho"], geom.n_cell, k)
    return out


def _es_current(state: SimState, cfg: SimConfig, staggering: Dict):
    """J of an electrostatic run, which deposits none in its step: the
    output deposits it afresh at relative time 0 on the periodic grid's
    shape (JFunctor.cpp:41-49 deposit_current = true; JAX
    diagnostics/fields.py:331-360).  Esirkepov takes the positions half a
    step ahead, which is where its -dt/2 default puts x^n."""
    from ..ops.push import inv_gamma

    geom = cfg.geometry
    ndim = geom.ndim
    f = state.fields.Ex
    j3 = [torch.zeros(geom.n_cell, dtype=f.dtype, device=f.device)
          for _ in range(3)]
    for sp_cfg in cfg.species:
        sp = state.species[sp_cfg.name]
        if sp_cfg.do_not_deposit or sp.capacity == 0:
            continue
        w_eff = torch.where(sp.alive, sp.w, torch.zeros_like(sp.w))
        pos = sp.positions(ndim)
        if cfg.current_deposition == "esirkepov":
            g = inv_gamma(sp.ux, sp.uy, sp.uz)
            vel = {1: (sp.uz,), 2: (sp.ux, sp.uz),
                   3: (sp.ux, sp.uy, sp.uz)}[ndim]
            pos = [p + (0.5 * cfg.dt) * (v * g) for p, v in zip(pos, vel)]
            deposit_current_esirkepov(pos, sp.ux, sp.uy, sp.uz, w_eff,
                                      sp_cfg.charge, geom, cfg.dt,
                                      cfg.particle_shape, out=j3,
                                      chunk_size=cfg.deposit_chunk_size)
        else:
            deposit_current_direct(pos, sp.ux, sp.uy, sp.uz, w_eff,
                                   sp_cfg.charge, geom, staggering, cfg.dt,
                                   cfg.particle_shape, relative_time=0.0,
                                   out=j3,
                                   chunk_size=cfg.deposit_chunk_size)
    return dict(zip(("jx", "jy", "jz"), j3))


def cell_centered_output(state: SimState, cfg: SimConfig, staggering: Dict,
                         names=None, psatd=None) -> Dict[str, torch.Tensor]:
    """E, B, j, rho, divE, divB and part_per_cell at cell centers (those of
    ``names`` only, when given); ``psatd`` is the periodic spectral solver
    under em_solver = psatd."""
    geom = cfg.geometry

    def want(name):
        return names is None or name in names

    f = state.fields
    comp, flags = _components(state, cfg, staggering)
    out = {}
    j_now = (_es_current(state, cfg, staggering)
             if cfg.electrostatic != "none"
             and any(want(nm) for nm in ("jx", "jy", "jz")) else {})
    for name in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"):
        if want(name):
            out[name] = cell_center(j_now[name] if name in j_now
                                    else comp(name), flags[name],
                                    geom.n_cell)
    if want("rho"):
        out["rho"] = cell_center(deposit_total_rho(state, cfg),
                                 staggering["rho"], geom.n_cell)
    if f.phi is not None and want("phi"):
        # the nodal potential of the last Poisson solve (diagnostic "phi")
        out["phi"] = cell_center(f.phi, (1,) * geom.ndim, geom.n_cell)
    for name in ("F", "G"):
        # the divergence-cleaning scalars, where the run carries them
        if getattr(f, name) is not None and want(name):
            out[name] = cell_center(comp(name), staggering[name],
                                    geom.n_cell)
    if want("divE") or want("divB"):
        bc_lo = cfg.field_bc_lo or ("periodic",) * geom.ndim
        div_e = div_b = None
        if all(bc == "periodic" for bc in bc_lo):
            # spectral i k.E under PSATD (DivEFunctor -> ComputeDivE)
            if cfg.em_solver == "psatd" and psatd is not None:
                div_e = psatd.spectral_div_e(
                    {nm: getattr(f, nm) for nm in ("Ex", "Ey", "Ez")})
            else:
                div_e = yee.compute_div_e(f, geom)
            div_b = yee.compute_div_b(f, geom)
        elif cfg.grid_type == "staggered":
            div_e, div_b = _bounded_div(
                _components(state, cfg, staggering, aux=False)[0], cfg)
        # a bounded grid of another type has neither, as in the JAX
        # package (diagnostics/fields.py:407)
        if want("divE") and div_e is not None:
            out["divE"] = cell_center(div_e, (1,) * geom.ndim, geom.n_cell)
        if want("divB") and div_b is not None:
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
