"""Reduced diagnostics: scalar time series and their CSV writer.

The counterpart of ``warpx_tpu.diagnostics.reduced`` (reference:
Source/Diagnostics/ReducedDiags/): the same kinds, the same column names
and the reference's CSV-with-header format.  Each kind computes its values
as tensors on the state's device, and ``compute_reduced`` moves them to the
host in one transfer; no species is copied to the host whole.  The
``ChargeOnEB`` kind needs an embedded boundary.
"""

from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np
import torch

from .. import constants
from ..core.config import SimConfig
from ..core.state import SimState
from ..ops.deposit import deposit_rho
from ..utils.expression import compile_expression
from .fields import cell_centered_output, current_origin, deposit_total_rho

_AXES3 = {1: (2,), 2: (0, 2), 3: (0, 1, 2)}

__all__ = ["REDUCED_DIAGS", "ReducedDiagWriter", "compute_reduced"]

_PVARS = ("t", "x", "y", "z", "ux", "uy", "uz")


def field_energy(state: SimState, cfg: SimConfig, staggering):
    """Integrated field energy (ReducedDiags/FieldEnergy.cpp):
    E_E = eps0/2 int E^2 dV ; E_B = 1/(2 mu0) int B^2 dV."""
    f = state.fields
    dv = cfg.geometry.cell_volume
    e2 = sum(torch.sum(a * a).double() for a in f.e())
    b2 = sum(torch.sum(a * a).double() for a in f.b())
    ee = 0.5 * constants.ep0 * e2 * dv
    eb = 0.5 / constants.mu0 * b2 * dv
    return {"total_lev0(J)": ee + eb, "E_lev0(J)": ee, "B_lev0(J)": eb}


def _cell_centered_eb(state, cfg, staggering):
    """E and B at the cell centers of the physical region."""
    fields = cell_centered_output(state, cfg, staggering, names=_EB)
    return {nm: fields[nm] for nm in _EB}


_EB = ("Ex", "Ey", "Ez", "Bx", "By", "Bz")


def field_maximum(state: SimState, cfg: SimConfig, staggering):
    """The largest |component| of each array and the largest |E|, |B|
    (FieldMaximum.cpp).  Where the six arrays share a shape (periodic) |E|
    and |B| combine them point by point, as the JAX package does; on a
    bounded block, whose staggered arrays differ in shape, they combine the
    physical region's cell-centered values, as the reference does
    (Interp to cell centers), where the JAX package raises."""
    f = state.fields
    out = {f"max_{nm}_lev0": getattr(f, nm).abs().max() for nm in _EB}
    arrs = {nm: getattr(f, nm) for nm in _EB}
    if len({a.shape for a in arrs.values()}) > 1:
        arrs = _cell_centered_eb(state, cfg, staggering)
    out["max_|E|_lev0"] = torch.sqrt(
        arrs["Ex"]**2 + arrs["Ey"]**2 + arrs["Ez"]**2).max()
    out["max_|B|_lev0"] = torch.sqrt(
        arrs["Bx"]**2 + arrs["By"]**2 + arrs["Bz"]**2).max()
    return out


def field_momentum(state: SimState, cfg: SimConfig, staggering):
    """eps0 int (E x B) dV (FieldMomentum.cpp) over the cell-centered
    physical region (on a bounded block, where the JAX package raises, the
    PML strips are left out, as the reference's valid region leaves
    them)."""
    cc = _cell_centered_eb(state, cfg, staggering)
    k = constants.ep0 * cfg.geometry.cell_volume
    px = torch.sum(cc["Ey"] * cc["Bz"] - cc["Ez"] * cc["By"]).double()
    py = torch.sum(cc["Ez"] * cc["Bx"] - cc["Ex"] * cc["Bz"]).double()
    pz = torch.sum(cc["Ex"] * cc["By"] - cc["Ey"] * cc["Bx"]).double()
    return {
        "momentum_x_lev0(kg*m/s)": k * px,
        "momentum_y_lev0(kg*m/s)": k * py,
        "momentum_z_lev0(kg*m/s)": k * pz,
    }


def _species_iter(state: SimState, cfg: SimConfig):
    for sp_cfg in cfg.species:
        if sp_cfg.injection_style == "laser":
            continue
        sp = state.species[sp_cfg.name]
        if sp.capacity == 0:
            continue
        yield sp_cfg, sp


def _masked(sp, arr, fill=0.0):
    """``arr`` with ``fill`` in the dead slots (a fill beyond the dtype's
    range becomes an infinity, as a cast would make it)."""
    if abs(fill) > torch.finfo(arr.dtype).max:
        fill = math.copysign(math.inf, fill)
    return torch.where(sp.alive, arr, torch.full_like(arr, fill))


def particle_energy(state: SimState, cfg: SimConfig, staggering):
    """Sum of w m c^2 (gamma - 1) per species (ParticleEnergy.cpp), in the
    stable u^2/(1 + gamma) form (Particles/Algorithms/KineticEnergy.H:
    44-47)."""
    out = {}
    total = 0.0
    c2 = constants.c**2
    for sp_cfg, sp in _species_iter(state, cfg):
        u2 = sp.ux**2 + sp.uy**2 + sp.uz**2
        gamma = torch.sqrt(1.0 + u2 / c2)
        val = torch.sum(_masked(sp, sp.w * sp_cfg.mass * u2 / (1.0 + gamma))
                        ).double()
        out[f"{sp_cfg.name}(J)"] = val
        total = total + val
    out["total(J)"] = total
    return out


def particle_momentum(state: SimState, cfg: SimConfig, staggering):
    out = {}
    tot = [0.0, 0.0, 0.0]
    for sp_cfg, sp in _species_iter(state, cfg):
        for i, (ax, u) in enumerate((("x", sp.ux), ("y", sp.uy),
                                     ("z", sp.uz))):
            val = torch.sum(_masked(sp, sp.w * sp_cfg.mass * u)).double()
            out[f"{sp_cfg.name}_momentum_{ax}(kg*m/s)"] = val
            tot[i] = tot[i] + val
    for i, ax in enumerate("xyz"):
        out[f"total_momentum_{ax}(kg*m/s)"] = tot[i]
    return out


def particle_number(state: SimState, cfg: SimConfig, staggering):
    out = {}
    total = 0.0
    total_w = 0.0
    for sp_cfg, sp in _species_iter(state, cfg):
        n = sp.alive.sum().double()
        w = torch.sum(_masked(sp, sp.w)).double()
        out[f"{sp_cfg.name}_macroparticles()"] = n
        out[f"{sp_cfg.name}_weight()"] = w
        total = total + n
        total_w = total_w + w
    out["total_macroparticles()"] = total
    out["total_weight()"] = total_w
    return out


def particle_extrema(state: SimState, cfg: SimConfig, staggering):
    out = {}
    big = 1e300
    ndim = cfg.geometry.ndim
    names = {1: ["z"], 2: ["x", "z"], 3: ["x", "y", "z"]}[ndim]
    for sp_cfg, sp in _species_iter(state, cfg):
        for nm, arr in list(zip(names, sp.positions(ndim))) + [
                ("ux", sp.ux), ("uy", sp.uy), ("uz", sp.uz), ("w", sp.w)]:
            out[f"{sp_cfg.name}_{nm}min"] = _masked(sp, arr, big).min()
            out[f"{sp_cfg.name}_{nm}max"] = _masked(sp, arr, -big).max()
    return out


def rho_maximum(state: SimState, cfg: SimConfig, staggering):
    rho = deposit_total_rho(state, cfg)
    return {"max_rho_lev0(C/m^3)": rho.max(), "min_rho_lev0(C/m^3)": rho.min()}


def load_balance_efficiency(state, cfg, staggering):
    """Average-over-max per-device cost (LoadBalanceEfficiency.cpp:44):
    one device is balanced by construction."""
    eff = state.aux.get("lb_efficiency")
    return {"lev0_efficiency()": eff if eff is not None else 1.0}


class ReducedDiagWriter:
    """CSV time-series writer in the reference's ReducedDiags format
    (a header row of '#', then step, time, columns)."""

    def __init__(self, path: str, name: str, kind: str):
        self.path = os.path.join(path, f"{name}.txt")
        self.kind = kind
        self._wrote_header = False
        os.makedirs(path, exist_ok=True)

    def write(self, step: int, time: float, values: Dict[str, float]):
        if not self._wrote_header:
            cols = ["step()", "time(s)"] + list(values.keys())
            header = "#" + ",".join(f"[{i}]{c}" for i, c in enumerate(cols))
            with open(self.path, "w") as fh:
                fh.write(header + "\n")
            self._wrote_header = True
        row = [str(step), repr(time)] + [repr(v) for v in values.values()]
        with open(self.path, "a") as fh:
            fh.write(",".join(row) + "\n")


def _particle_args(state, cfg, sp, with_w=False):
    """(t, x, y, z, ux, uy, uz[, w]) of every slot for a parsed particle
    function (u in units of c, zero positions on the inactive axes)."""
    ndim = cfg.geometry.ndim
    zero = torch.zeros_like(sp.w)
    xyz = [zero] * 3
    for d, a in enumerate({1: (2,), 2: (0, 2), 3: (0, 1, 2)}[ndim]):
        xyz[a] = sp.positions(ndim)[d]
    u = [getattr(sp, "u" + c) / constants.c for c in "xyz"]
    return [float(state.time), *xyz, *u] + ([sp.w] if with_w else [])


def _bin_index(vals, keep, lo, hi, nbin):
    """np.histogram's bin of each value on ``nbin`` equal bins of [lo, hi]
    (the last bin holds its right edge) and the mask of values inside."""
    vals = vals.double()
    keep = keep & (vals >= lo) & (vals <= hi)
    edges = torch.from_numpy(np.linspace(lo, hi, nbin + 1)).to(vals.device)
    f = torch.where(keep, (vals - lo) / (hi - lo) * nbin,
                    torch.zeros_like(vals))
    idx = f.long()
    idx = torch.where(idx == nbin, idx - 1, idx)
    idx = torch.where(vals < edges[idx], idx - 1, idx)
    idx = torch.where((vals >= edges[(idx + 1).clamp_max(nbin)])
                      & (idx != nbin - 1), idx + 1, idx)
    return torch.where(keep, idx, torch.zeros_like(idx)), keep


def _histogram(idx, keep, weights, nbin):
    w = torch.where(keep, weights.double(), torch.zeros_like(weights.double()))
    return torch.zeros(nbin, dtype=torch.float64,
                       device=w.device).index_add_(0, idx, w)


def beam_relevant(state, cfg, staggering, params):
    """Weighted beam moments (BeamRelevant.cpp:40-300): means of position
    and momentum, gamma, rms sizes, normalized emittances, charge."""
    name = params["species"]
    sp_cfg = next(s for s in cfg.species if s.name == name)
    sp = state.species[name]
    ndim = cfg.geometry.ndim
    w = _masked(sp, sp.w)
    n_alive = sp.alive.sum()
    wsum = w.sum()
    wsum = torch.where(wsum == 0, torch.ones_like(wsum), wsum)
    pos = sp.positions(ndim)
    xyz = {1: {"z": 0}, 2: {"x": 0, "z": 1}, 3: {"x": 0, "y": 1, "z": 2}}[ndim]
    m = sp_cfg.mass
    u = {c: getattr(sp, "u" + c) for c in "xyz"}
    gam = torch.sqrt(1 + (u["x"]**2 + u["y"]**2 + u["z"]**2) / constants.c**2)

    def mean(a):
        return (w * a).sum() / wsum

    out = {}
    for c in "xyz":
        if c in xyz:
            out[f"{c}_mean(m)"] = mean(pos[xyz[c]])
    for c in "xyz":
        out[f"p{c}_mean(kg*m/s)"] = mean(m * u[c])
    out["gamma_mean()"] = mean(gam)
    dpos = {c: pos[xyz[c]] - out[f"{c}_mean(m)"] for c in "xyz" if c in xyz}
    dmom = {c: m * u[c] - out[f"p{c}_mean(kg*m/s)"] for c in "xyz"}
    for c, d in dpos.items():
        out[f"{c}_rms(m)"] = torch.sqrt(mean(d * d))
    for c in "xyz":
        out[f"p{c}_rms(kg*m/s)"] = torch.sqrt(mean(dmom[c] * dmom[c]))
    dg = gam - out["gamma_mean()"]
    out["gamma_rms()"] = torch.sqrt(mean(dg * dg))
    for c, d in dpos.items():
        x2, p2, xp = mean(d * d), mean(dmom[c] * dmom[c]), mean(d * dmom[c])
        out[f"emittance_{c}(m)"] = torch.sqrt(
            (x2.double() * p2.double() - xp.double() * xp.double()
             ).clamp_min(0.0)) / (m * constants.c)
    out["charge(C)"] = torch.where(n_alive > 0, sp_cfg.charge * wsum.double(),
                                   torch.zeros_like(wsum.double()))
    return out


def particle_histogram(state, cfg, staggering, params):
    """Weighted histogram of a parsed particle function (ParticleHistogram.
    cpp: a function of (t,x,y,z,ux,uy,uz), u in units of c, an optional
    filter)."""
    sp = state.species[params["species"]]
    args = _particle_args(state, cfg, sp)
    vals = compile_expression(params["histogram_function"], _PVARS)(*args)
    keep = sp.alive
    if params.get("filter_function"):
        keep = keep & (compile_expression(params["filter_function"], _PVARS)(
            *args) > 0)
    nbin = int(params.get("bin_number", 10))
    lo = float(params.get("bin_min", 0.0))
    hi = float(params.get("bin_max", 1.0))
    idx, keep = _bin_index(vals, keep, lo, hi, nbin)
    weights = (torch.ones_like(sp.w)
               if params.get("normalization") == "unity_particle_weight"
               else sp.w)
    hist = _histogram(idx, keep, weights, nbin)
    return {f"bin{i + 1}()": hist[i] for i in range(nbin)}


def field_probe(state, cfg, staggering, params):
    """Point probe of the cell-centered E/B (FieldProbe.cpp,
    probe_geometry = Point, the nearest cell center)."""
    fields = cell_centered_output(state, cfg, staggering)
    geom = cfg.geometry
    origin = current_origin(state, cfg)
    act = {1: ("z",), 2: ("x", "z"), 3: ("x", "y", "z")}[geom.ndim]
    idx = []
    for d, c in enumerate(act):
        p = float(params.get(f"{c}_probe", 0.0))
        i = (p - float(origin[d])) / geom.dx[d] - 0.5
        idx.append(int(np.clip(round(i), 0, geom.n_cell[d] - 1)))
    idx = tuple(idx)
    out = {}
    for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
        unit = "(V/m)" if nm[0] == "E" else "(T)"
        out[f"part_{nm}_lev0-{unit}"] = fields[nm][idx]
    e2 = sum(fields[n][idx] ** 2 for n in ("Ex", "Ey", "Ez"))
    out["part_S_lev0-(W/m^2)"] = e2.double().sqrt()  # |E| magnitude proxy
    return out


def _cell_coords(state, cfg, device):
    """(x, y, z) of every cell center, zero on the inactive axes."""
    geom = cfg.geometry
    origin = current_origin(state, cfg)
    coords = [float(origin[d]) + (torch.arange(
        geom.n_cell[d], dtype=torch.float64, device=device) + 0.5)
        * geom.dx[d] for d in range(geom.ndim)]
    mesh = torch.meshgrid(*coords, indexing="ij")
    xyz = [torch.zeros(geom.n_cell, dtype=torch.float64, device=device)] * 3
    for d, a in enumerate({1: (2,), 2: (0, 2), 3: (0, 1, 2)}[geom.ndim]):
        xyz[a] = mesh[d]
    return xyz


def field_reduction(state, cfg, staggering, params):
    """A parsed reduction over the cell-centered fields (FieldReduction.
    cpp: reduced_function(x,y,z,Ex..Bz,jx..jz), reduction_type
    Maximum|Minimum|Integral)."""
    fields = cell_centered_output(state, cfg, staggering)
    xyz = _cell_coords(state, cfg, state.fields.Ex.device)
    names = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")
    fn = compile_expression(params["reduced_function"],
                            ("x", "y", "z") + names)
    vals = fn(*xyz, *[fields[n] for n in names])
    rt = (params.get("reduction_type") or "Maximum").lower()
    if rt == "maximum":
        v = vals.max()
    elif rt == "minimum":
        v = vals.min()
    else:  # integral
        v = vals.sum().double() * cfg.geometry.cell_volume
    return {"value()": v}


def timestep(state, cfg, staggering):
    """The simulation's dt (ReducedDiags/Timestep.cpp)."""
    return {"timestep_lev0(s)": float(cfg.dt)}


def _bin_index_2d(vals, keep, lo, hi, nbin):
    """np.histogramdd's bin along one axis: searchsorted on the edges, a
    value on the last edge in the last bin."""
    vals = vals.double()
    edges = torch.from_numpy(np.linspace(lo, hi, nbin + 1)).to(vals.device)
    idx = torch.searchsorted(edges, vals, right=True)
    idx = torch.where(vals == edges[-1], idx - 1, idx)
    keep = keep & (idx >= 1) & (idx <= nbin)
    return torch.where(keep, idx - 1, torch.zeros_like(idx)), keep


def particle_histogram2d(state, cfg, staggering, params):
    """2D weighted histogram of two parsed particle functions
    (ParticleHistogram2D.cpp: abscissa and ordinate functions of
    (t,x,y,z,ux,uy,uz,w), an optional value function and filter; bins
    written row-major as bin(i,j))."""
    sp = state.species[params["species"]]
    args = _particle_args(state, cfg, sp, with_w=True)
    vnames = _PVARS + ("w",)
    va = compile_expression(params["histogram_function_abscissa"],
                            vnames)(*args)
    vo = compile_expression(params["histogram_function_ordinate"],
                            vnames)(*args)
    wv = sp.w
    if params.get("value_function"):
        wv = sp.w * compile_expression(params["value_function"], vnames)(*args)
    keep = sp.alive
    if params.get("filter_function"):
        keep = keep & (compile_expression(params["filter_function"], vnames)(
            *args) > 0)
    na = int(params.get("bin_number_abs", 10))
    no = int(params.get("bin_number_ord", 10))
    ia, keep = _bin_index_2d(va, keep, float(params.get("bin_min_abs", 0.0)),
                             float(params.get("bin_max_abs", 1.0)), na)
    io, keep = _bin_index_2d(vo, keep, float(params.get("bin_min_ord", 0.0)),
                             float(params.get("bin_max_ord", 1.0)), no)
    hist = _histogram(ia * no + io, keep, wv, na * no).reshape(na, no)
    return {f"bin({i},{j})": hist[i, j] for i in range(na) for j in range(no)}


def _deposit_number_density(state, cfg, name):
    """The weight density of one species on the nodes [m^-3] (charge 1;
    ColliderRelevant's GetChargeDensity/|q|)."""
    geom = cfg.geometry
    sp = state.species[name]
    return deposit_rho(sp.positions(geom.ndim), _masked(sp, sp.w), 1.0, geom,
                       cfg.particle_shape)


def _beams(params):
    beams = params.get("species", [])
    return beams.split() if isinstance(beams, str) else list(beams)


def collider_relevant(state, cfg, staggering, params):
    """ColliderRelevant.cpp: dL_dt = 2 c sum_cells n1 n2 dV and per beam the
    transverse position and angle statistics.  Its chi columns exist for
    QED species only, which the port does not run."""
    beams = _beams(params)
    if len(beams) != 2:
        raise ValueError("ColliderRelevant needs exactly 2 species")
    geom = cfg.geometry
    n1 = _deposit_number_density(state, cfg, beams[0])
    n2 = _deposit_number_density(state, cfg, beams[1])
    out = {"dL_dt": 2.0 * constants.c * torch.sum(n1 * n2).double()
           * geom.cell_volume}
    for nm in beams:
        sp = state.species[nm]
        w = _masked(sp, sp.w)
        wsum = torch.clamp_min(w.sum(), 1e-300)

        def wavg(a):
            return torch.sum(w * a) / wsum

        for lbl, arr in (("x", sp.x), ("y", sp.y)):
            if arr is not None:
                ave = wavg(arr)
                out[f"{lbl}_ave_{nm}"] = ave
                out[f"{lbl}_std_{nm}"] = torch.sqrt(
                    torch.clamp_min(wavg((arr - ave) ** 2), 0.0))
        safe_uz = torch.where(sp.uz == 0, torch.ones_like(sp.uz), sp.uz)
        pairs = [("thetax", sp.ux)] + ([("thetay", sp.uy)]
                                       if geom.ndim == 3 else [])
        for lbl, u_t in pairs:
            th = torch.atan2(u_t, safe_uz)
            tha = wavg(th)
            out[f"{lbl}_min_{nm}"] = _masked(sp, th, math.inf).min()
            out[f"{lbl}_ave_{nm}"] = tha
            out[f"{lbl}_max_{nm}"] = _masked(sp, th, -math.inf).max()
            out[f"{lbl}_std_{nm}"] = torch.sqrt(
                torch.clamp_min(wavg((th - tha) ** 2), 0.0))
    return out


def _cell_of(sp, geom, n_cells_tot):
    """Flat cell index per particle; dead particles at ``n_cells_tot``."""
    ndim = geom.ndim
    cell = torch.zeros(sp.capacity, dtype=torch.int64, device=sp.w.device)
    for d, pos in enumerate(sp.positions(ndim)):
        idx = torch.floor((pos - geom.prob_lo[d]) / geom.dx[d]).long()
        cell = cell * geom.n_cell[d] + idx.clamp(0, geom.n_cell[d] - 1)
    return torch.where(sp.alive, cell, torch.full_like(cell, n_cells_tot))


def _shuffled_by_cell(cell, generator):
    """Slots sorted by cell, in random order within a cell."""
    perm = torch.argsort(torch.rand(cell.shape[0], generator=generator,
                                    device=cell.device))
    return perm[torch.argsort(cell[perm], stable=True)]


def differential_luminosity(state, cfg, staggering, params):
    """DifferentialLuminosity.cpp: the d^2L/(dE_com dt) histogram,
    accumulated step by step into ``state.aux['dluminosity:<names>']``.

    As in the JAX package, pairs are drawn by the strided in-cell pairing
    of the collision machinery (each of max(N1, N2) pairs carries the
    min(N1, N2) multiplicity), an unbiased estimator of the reference's sum
    over all same-cell pairs.  The in-cell shuffle draws from a
    ``torch.Generator`` seeded with the step (the JAX package draws from
    ``jax.random``); where a cell holds at most one particle of the second
    beam the estimate does not depend on the shuffle."""
    beams = _beams(params)
    nbin = int(params.get("bin_number", 100))
    bmin = float(params.get("bin_min", 0.0))
    bmax = float(params.get("bin_max", 1.0))
    bsize = (bmax - bmin) / nbin
    geom = cfg.geometry
    by_name = {s.name: s for s in cfg.species}
    sp1, sp2 = state.species[beams[0]], state.species[beams[1]]
    c1, c2 = by_name[beams[0]], by_name[beams[1]]
    n_tot = int(np.prod(geom.n_cell))
    dev = sp1.w.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(state.step))
    cell1 = _cell_of(sp1, geom, n_tot)
    cell2 = _cell_of(sp2, geom, n_tot)
    o1 = _shuffled_by_cell(cell1, gen)
    o2 = _shuffled_by_cell(cell2, gen)

    def counts_starts(cell, alive):
        counts = torch.zeros(n_tot + 1, dtype=torch.int64,
                             device=dev).index_add_(0, cell, alive.long())
        return counts, torch.cumsum(counts, 0) - counts

    counts1, starts1 = counts_starts(cell1, sp1.alive)
    counts2, starts2 = counts_starts(cell2, sp2.alive)
    cl = cell1[o1].clamp(0, n_tot)
    rank = torch.arange(sp1.capacity, device=dev) - starts1[cl]
    n2c = counts2[cl]
    ok = sp1.alive[o1] & (cell1[o1] < n_tot) & (n2c > 0)
    slot2 = (starts2[cl] + rank % n2c.clamp_min(1)).clamp(0, sp2.capacity - 1)
    i1, i2 = o1, o2[slot2]
    ok = ok & sp2.alive[i2]
    mult = torch.minimum(counts1, counts2)[cl]

    def four_mom(sp, c, idx):
        ux, uy, uz = sp.ux[idx], sp.uy[idx], sp.uz[idx]
        u_sq = ux**2 + uy**2 + uz**2
        if c.species_type == "photon":
            pt, m = constants.m_e * torch.sqrt(u_sq), 0.0
        else:
            pt, m = c.mass * torch.sqrt(constants.c**2 + u_sq), c.mass
        return pt, c.mass * ux, c.mass * uy, c.mass * uz, m

    p1t, p1x, p1y, p1z, m1 = four_mom(sp1, c1, i1)
    p2t, p2x, p2y, p2z, m2 = four_mom(sp2, c2, i2)
    cl2 = constants.c**2
    e_com = (constants.c / constants.q_e) * torch.sqrt(torch.clamp_min(
        m1 * m1 * cl2 + m2 * m2 * cl2
        + 2 * (p1t * p2t - p1x * p2x - p1y * p2y - p1z * p2z), 0.0))
    ip1 = 1.0 / torch.clamp_min(p1t, 1e-300)
    ip2 = 1.0 / torch.clamp_min(p2t, 1e-300)
    b1sq = (p1x**2 + p1y**2 + p1z**2) * ip1 * ip1
    b2sq = (p2x**2 + p2y**2 + p2z**2) * ip2 * ip2
    b12 = (p1x * p2x + p1y * p2y + p1z * p2z) * ip1 * ip2
    radicand = torch.clamp_min(b1sq + b2sq - 2 * b12 - b1sq * b2sq + b12**2,
                               0.0)
    w1, w2 = sp1.w[i1], sp2.w[i2]
    val = (constants.c * torch.sqrt(radicand) * w1 * w2 * mult.to(w1.dtype)
           / geom.cell_volume / bsize * cfg.dt)
    bins = torch.floor((e_com - bmin) / bsize).long()
    inb = ok & (bins >= 0) & (bins < nbin)
    hist = torch.zeros(nbin, dtype=w1.dtype, device=dev).index_add_(
        0, torch.where(inb, bins, torch.zeros_like(bins)),
        torch.where(inb, val, torch.zeros_like(val)))
    key = "dluminosity:" + "_".join(beams)
    if key in state.aux:
        hist = hist + state.aux[key]
    state.aux[key] = hist  # accumulated across steps, as the reference does
    return {f"bin{i + 1}={bmin + bsize * (i + 0.5):.6e}(m^-2/eV)": hist[i]
            for i in range(nbin)}


def charge_on_eb(state, cfg, staggering, params):
    """ChargeOnEB.cpp: the charge inside the embedded boundary by Gauss,
    Q = eps0 sum over covered cells of div(E) dV (the staircase form of
    the reference's surface integral of eps0 E.n; JAX reduced.py:595-651),
    each covered cell weighted by ``params["weighting_function"]`` w(x,
    y, z) where given.  On a bounded box div(E) takes one-sided
    differences with a zero exterior along the bounded axes, then moves to
    the cell centers."""
    from ..solvers.yee import compute_div_e
    from .fields import cell_center

    if not cfg.eb_implicit_function:
        raise ValueError("ChargeOnEB requires an embedded boundary")
    geom = cfg.geometry
    ndim = geom.ndim
    bcl = cfg.field_bc_lo or ("periodic",) * ndim
    f = state.fields
    if all(b == "periodic" for b in bcl):
        dive = compute_div_e(f, geom)
    else:
        dive = None
        for d, axn in enumerate(geom.axis_names):
            e_arr = getattr(f, "E" + axn)
            if bcl[d] != "periodic":
                pad = [0, 0] * ndim
                pad[2 * (ndim - 1 - d)] = pad[2 * (ndim - 1 - d) + 1] = 1
                te = torch.diff(torch.nn.functional.pad(e_arr, pad),
                                dim=d) / geom.dx[d]
            else:
                te = (e_arr - torch.roll(e_arr, 1, d)) / geom.dx[d]
            dive = te if dive is None else dive + te
        dive = cell_center(dive, (1,) * ndim, geom.n_cell)
    consts = dict(cfg.user_constants or ())
    fn = compile_expression(cfg.eb_implicit_function, ("x", "y", "z"),
                            consts)
    mesh = torch.meshgrid(*[torch.from_numpy(geom.cell_centers(d))
                            for d in range(ndim)], indexing="ij")
    xyz = [torch.zeros_like(mesh[0])] * 3
    for d in range(ndim):
        xyz[_AXES3[ndim][d]] = mesh[d]
    covered = torch.as_tensor(fn(*xyz) > 0.0, device=dive.device)
    weight = 1.0
    wexpr = params.get("weighting_function", "")
    if wexpr:
        weight = torch.as_tensor(
            compile_expression(wexpr, ("x", "y", "z"), consts)(*xyz),
            dtype=dive.dtype, device=dive.device)
    if dive.shape != covered.shape:
        dive = dive[: covered.shape[0]]
    zero = torch.zeros((), dtype=dive.dtype, device=dive.device)
    q = constants.ep0 * torch.sum(torch.where(covered, dive, zero)
                                  * weight) * geom.cell_volume
    return {"Charge (C)": q}


def load_balance_costs(state, cfg, staggering):
    """LoadBalanceCosts.cpp: the heuristic cost of the one box of a single
    device (costs_heuristic_particles_wt * particles + cells_wt * cells,
    the reference's GPU weights, WarpXRegrid.cpp:316)."""
    n_parts = sum(sp.alive.sum() for sp in state.species.values()).double()
    n_cells = float(np.prod(cfg.geometry.n_cell))
    part_wt, cell_wt = 0.9, 0.1
    return {
        "cost_box_0": part_wt * n_parts + cell_wt * n_cells,
        "proc_box_0": 0.0,
        "lev_box_0": 0.0,
        "i_low_box_0": 0.0,
        "num_cells_box_0": n_cells,
        "num_macro_particles_box_0": n_parts,
    }


REDUCED_DIAGS = {
    "BeamRelevant": beam_relevant,
    "ParticleHistogram": particle_histogram,
    "FieldProbe": field_probe,
    "FieldReduction": field_reduction,
    "FieldEnergy": field_energy,
    "FieldMaximum": field_maximum,
    "FieldMomentum": field_momentum,
    "ParticleEnergy": particle_energy,
    "ParticleMomentum": particle_momentum,
    "ParticleNumber": particle_number,
    "ParticleExtrema": particle_extrema,
    "RhoMaximum": rho_maximum,
    "LoadBalanceEfficiency": load_balance_efficiency,
    "Timestep": timestep,
    "ParticleHistogram2D": particle_histogram2d,
    "ColliderRelevant": collider_relevant,
    "DifferentialLuminosity": differential_luminosity,
    "ChargeOnEB": charge_on_eb,
    "LoadBalanceCosts": load_balance_costs,
}

_PARAM_KINDS = {
    "BeamRelevant", "ParticleHistogram", "FieldProbe", "FieldReduction",
    "ParticleHistogram2D", "ColliderRelevant", "DifferentialLuminosity",
    "ChargeOnEB",
}


def _to_host(values) -> Dict[str, float]:
    """The values as Python floats, the tensors among them moved to the
    host in one transfer."""
    keys = [k for k, v in values.items() if isinstance(v, torch.Tensor)]
    out = {k: (None if k in keys else float(v)) for k, v in values.items()}
    if keys:
        got = torch.stack([values[k].double().reshape(()) for k in keys])
        out.update(zip(keys, got.tolist()))
    return out


def compute_reduced(kind: str, state, cfg, staggering,
                    params=None) -> Dict[str, float]:
    if kind in _PARAM_KINDS:
        vals = REDUCED_DIAGS[kind](state, cfg, staggering, params or {})
    else:
        vals = REDUCED_DIAGS[kind](state, cfg, staggering)
    return _to_host(vals)
