"""Strong-field QED: quantum synchrotron, Breit-Wheeler, Schwinger.

The counterpart of ``warpx_tpu.ops.qed`` (reference: the PICSAR-QED
integration, Source/Particles/ElementaryProcess/QEDInternals/
{QuantumSyncEngineWrapper,BreitWheelerEngineWrapper,
SchwingerProcessWrapper}.H).  The lookup tables are built on the host with
numpy and scipy at first use, once per process (``functools.lru_cache``),
from the strong-field rates the reference's own analyses use:

  quantum synchrotron:  dN/dt = (2/3) (alpha m c^2 / hbar) G(chi_e)/gamma
  Breit-Wheeler:        dN/dt = alpha (m c^2/hbar) T(chi_g) chi_g/gamma_g
  Schwinger:            dN/dVdt from the field invariants

Each QED particle carries an exponentially distributed optical depth
(``opticalDepthQSR`` / ``opticalDepthBW``), lowered by dN/dt dt each step
after the push; a depth at or below zero at the start of a step emits (or
converts) and draws a fresh depth.  Products take the free slots of their
species in event order (``ops/emit.py``).

Each update is a deterministic core that takes its random numbers as
tensors and a wrapper that draws them from a ``utils.draws`` source in the
JAX package's pattern (splits, shapes and order of ``qed.py:340-388,
447-452``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import c as _c, m_e as _m_e, q_e as _q_e
from .emit import emit_targets, put_rows

# exact h/(2 pi) rather than the rounded CODATA listing: the Schwinger
# Gaussian-regime gate resolves relative differences of ~1e-9
_hbar = 6.62607015e-34 / (2.0 * np.pi)

__all__ = [
    "E_SCHWINGER", "qs_tables", "bw_tables", "particle_chi", "photon_chi",
    "qs_dndt", "bw_dndt", "sample_frac", "schwinger_pair_number",
    "qed_update", "schwinger_update",
]

_alpha = 7.2973525693e-3  # fine-structure constant
E_SCHWINGER = _m_e**2 * _c**3 / (_q_e * _hbar)  # Schwinger field [V/m]


# --------------------------------------------------------------------------
# host-side tables (numpy/scipy, vectorized quadrature)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def qs_tables(chi_min: float = 1e-3, chi_max: float = 1e3,
              n_chi: int = 128, n_frac: int = 256,
              frac_min: float = 1e-12):
    """Quantum-synchrotron tables: (chi grid, G(chi), fraction grid,
    cumulative photon-energy distribution P(chi_g < f chi_e | chi_e)), the
    reference's qed_qs.tab_* defaults."""
    import scipy.special as spe

    chis = np.logspace(np.log10(chi_min), np.log10(chi_max), n_chi)
    # inner(Y) = (1/sqrt3) int_0^inf exp(-Y(1+4x^2/3)sqrt(1+x^2/3))
    #            (9+36x^2+16x^4)/((3+4x^2)sqrt(1+x^2/3)) dx on a log Y grid
    ygrid = np.logspace(-10, 5, 1024)
    x = np.concatenate(
        [np.linspace(0.0, 2.0, 4001)[:-1], np.logspace(
            np.log10(2.0), np.log10(2000.0), 4000)]
    )[None, :]
    yv = ygrid[:, None]
    integrand = (
        np.exp(-yv * (1 + 4 * x**2 / 3) * np.sqrt(1 + x * x / 3))
        * (9 + 36 * x**2 + 16 * x**4)
        / (3 + 4 * x**2) / np.sqrt(1 + x**2 / 3)
    )
    inner_tab = np.trapezoid(integrand, x[0], axis=1) / np.sqrt(3)

    def inner(Y):
        return np.interp(Y, ygrid, inner_tab, left=inner_tab[0], right=0.0)

    # fractions: log-spaced at the soft end plus points clustered toward
    # xi -> 1 (the K_{2/3} tail dominates there at large chi)
    f_soft = np.logspace(np.log10(frac_min), np.log10(0.5), n_frac - 96)
    f_hard = 1.0 - np.logspace(np.log10(0.5), -9, 96)
    fracs = np.unique(np.concatenate([f_soft, f_hard]))
    xi = np.clip(fracs, 0.0, 1.0 - 1e-12)[None, :]
    chi2 = chis[:, None]
    Y = (2.0 / 3.0) * xi / (chi2 * (1.0 - xi))
    S = (np.sqrt(3.0) / (2 * np.pi)) * xi * (
        inner(Y) + xi**2 / (1.0 - xi) * spe.kv(2.0 / 3.0, Y)
    )
    S = np.nan_to_num(S, nan=0.0, posinf=0.0)
    dNdxi = S / xi
    G = np.trapezoid(dNdxi, fracs, axis=1)
    cum = np.concatenate(
        [np.zeros((n_chi, 1)),
         np.cumsum(0.5 * (dNdxi[:, 1:] + dNdxi[:, :-1])
                   * np.diff(fracs)[None, :], axis=1)],
        axis=1,
    )
    cum /= np.maximum(cum[:, -1:], 1e-300)
    return (chis.astype(np.float64), G.astype(np.float64),
            fracs.astype(np.float64), cum.astype(np.float64))


@functools.lru_cache(maxsize=4)
def bw_tables(chi_min: float = 1e-2, chi_max: float = 1e3,
              n_chi: int = 128, n_frac: int = 256):
    """Breit-Wheeler tables: (chi grid, T(chi), fraction grid, cumulative
    pair electron-energy distribution P(chi_e < f chi_g | chi_g))."""
    import scipy.special as spe

    chis = np.logspace(np.log10(chi_min), np.log10(chi_max), n_chi)
    # BW_inner(x) = int_x^inf sqrt(s) K_{1/3}((2/3)s^{3/2}) ds by a
    # reversed cumulative trapezoid on a wide grid
    sgrid = np.logspace(-6, 3, 4000)
    vals = np.sqrt(sgrid) * spe.kv(1.0 / 3.0, (2.0 / 3.0) * sgrid**1.5)
    vals = np.nan_to_num(vals, nan=0.0, posinf=0.0)
    seg = 0.5 * (vals[1:] + vals[:-1]) * np.diff(sgrid)
    tail = np.concatenate([np.cumsum(seg[::-1])[::-1], [0.0]])

    def bw_inner(X):
        return np.interp(X, sgrid, tail, left=tail[0], right=0.0)

    # chi_e/chi_g on a symmetric grid clustered near 0 and 1
    n2 = n_frac // 2
    half = np.logspace(-6, np.log10(0.5), n2)
    fracs = np.unique(np.concatenate([half, 1.0 - half[::-1]]))
    f = fracs[None, :]
    chi2 = chis[:, None]
    chi_e = f * chi2
    chi_p = chi2 - chi_e
    with np.errstate(divide="ignore", invalid="ignore"):
        X = (chi2 / (chi_e * chi_p)) ** (2.0 / 3.0)
        F = bw_inner(X) - (2.0 - chi2 * X**1.5) * spe.kv(
            2.0 / 3.0, (2.0 / 3.0) * X**1.5
        )
    F = np.nan_to_num(F, nan=0.0, posinf=0.0, neginf=0.0)
    F = np.maximum(F, 0.0)
    T = np.trapezoid(F, chi_e, axis=1) / (np.pi * np.sqrt(3.0) * chis**2)
    cum = np.concatenate(
        [np.zeros((chis.size, 1)),
         np.cumsum(0.5 * (F[:, 1:] + F[:, :-1]) * np.diff(fracs)[None, :],
                   axis=1)],
        axis=1,
    )
    cum /= np.maximum(cum[:, -1:], 1e-300)
    return (chis.astype(np.float64), T.astype(np.float64),
            fracs.astype(np.float64), cum.astype(np.float64))


@functools.lru_cache(maxsize=16)
def _device_table(which: str, dtype: torch.dtype, device: torch.device):
    """The tables of ``which`` ('qs' or 'bw') as tensors on ``device``."""
    tabs = qs_tables() if which == "qs" else bw_tables()
    return tuple(torch.as_tensor(t, dtype=dtype, device=device)
                 for t in tabs)


# --------------------------------------------------------------------------
# chi, rates and sampling on the device
# --------------------------------------------------------------------------

def particle_chi(ux, uy, uz, ex, ey, ez, bx, by, bz):
    """chi of a massive lepton: gamma |F.v| / E_s (QedChiFunctions.H
    chi_ele_pos; u = gamma v in m/s)."""
    gam = torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz) / (_c * _c))
    vx, vy, vz = ux / gam, uy / gam, uz / gam
    fx = ex + vy * bz - vz * by
    fy = ey + vz * bx - vx * bz
    fz = ez + vx * by - vy * bx
    vde = (vx * ex + vy * ey + vz * ez) / _c
    ff2 = torch.clamp(fx * fx + fy * fy + fz * fz - vde * vde, min=0.0)
    return gam * torch.sqrt(ff2) / E_SCHWINGER


def photon_chi(ux, uy, uz, ex, ey, ez, bx, by, bz):
    """chi of a photon: (p/mc) |F.n| / E_s (QedChiFunctions.H chi_photon;
    a photon's u holds p/m_e in m/s, so p/(m_e c) = |u|/c)."""
    pn = torch.sqrt(ux * ux + uy * uy + uz * uz)
    pns = torch.where(pn == 0.0, torch.ones_like(pn), pn)
    nx, ny, nz = ux / pns, uy / pns, uz / pns
    fx = ex + _c * (ny * bz - nz * by)
    fy = ey + _c * (nz * bx - nx * bz)
    fz = ez + _c * (nx * by - ny * bx)
    nde = nx * ex + ny * ey + nz * ez
    ff2 = torch.clamp(fx * fx + fy * fy + fz * fz - nde * nde, min=0.0)
    return (pn / _c) * torch.sqrt(ff2) / E_SCHWINGER


def _log_grid(chis_np):
    l0 = float(np.log(chis_np[0]))
    dl = float(np.log(chis_np[-1] / chis_np[0]) / (len(chis_np) - 1))
    return l0, dl


def _interp_log(chi, chis_np, vals):
    """Linear interpolation of ``vals`` (a tensor) on the log-spaced chi
    table (clamped)."""
    lc = torch.log(torch.clamp(chi, float(chis_np[0]), float(chis_np[-1])))
    l0, dl = _log_grid(chis_np)
    t = (lc - l0) / dl
    i0 = torch.clamp(torch.floor(t).to(torch.int64), 0, len(chis_np) - 2)
    fr = t - i0
    return vals[i0] * (1 - fr) + vals[i0 + 1] * fr


def _frac_row(chi, chis_np):
    lc = torch.log(torch.clamp(chi, float(chis_np[0]), float(chis_np[-1])))
    l0, dl = _log_grid(chis_np)
    return torch.clamp(torch.round((lc - l0) / dl).to(torch.int64), 0,
                       len(chis_np) - 1)


def frac_index_search(cum, row, r):
    """The table index of the JAX package's ``_sample_frac`` (how many
    entries of the row are below ``r``, clamped to [1, n_frac - 1]) by a
    binary search of each non-decreasing row: the count of entries below
    ``r`` is the first position whose entry is not below it; memory
    O(capacity), where the JAX package's count builds the capacity x n_frac
    matrix of rows."""
    n = cum.shape[1]
    flat = cum.reshape(-1)
    base = row * n
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, n)
    for _ in range(max(1, (n).bit_length())):
        mid = (lo + hi) // 2
        below = flat[base + torch.clamp(mid, max=n - 1)] < r
        go = below & (mid < hi)
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    return torch.clamp(lo, 1, n - 1)


def sample_frac(r, chi, which: str, dtype: torch.dtype):
    """Inverse-CDF sample of the product's share of the parent given its
    chi, on the uniform draws ``r`` (the JAX package's ``_sample_frac``
    with its draw made outside)."""
    chis_np = (qs_tables() if which == "qs" else bw_tables())[0]
    _, _, fracs, cum = _device_table(which, dtype, r.device)
    row = _frac_row(chi, chis_np)
    idx = frac_index_search(cum, row, r)
    flat = cum.reshape(-1)
    base = row * cum.shape[1]
    c0 = flat[base + idx - 1]
    c1 = flat[base + idx]
    # the where keeps 1e-300 (0 in float32) from selecting a NaN
    fr = torch.where(c1 > c0, (r - c0) / torch.clamp(c1 - c0, min=1e-300),
                     torch.zeros_like(r))
    return fracs[idx - 1] * (1 - fr) + fracs[idx] * fr


def qs_dndt(ux, uy, uz, ex, ey, ez, bx, by, bz):
    """Quantum-synchrotron emission rate dN/dt of leptons
    ((2/3) alpha m c^2/hbar G(chi)/gamma)."""
    chis_np = qs_tables()[0]
    _, G, _, _ = _device_table("qs", ux.dtype, ux.device)
    chi = particle_chi(ux, uy, uz, ex, ey, ez, bx, by, bz)
    gam = torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz) / (_c * _c))
    return (2.0 / 3.0) * _alpha * _m_e * _c * _c / _hbar * \
        _interp_log(chi, chis_np, G) / gam


def bw_dndt(ux, uy, uz, ex, ey, ez, bx, by, bz):
    """Breit-Wheeler pair-production rate dN/dt of photons
    (alpha m c^2/hbar T(chi) chi/gamma_photon)."""
    chis_np = bw_tables()[0]
    _, T, _, _ = _device_table("bw", ux.dtype, ux.device)
    chi = photon_chi(ux, uy, uz, ex, ey, ez, bx, by, bz)
    gph = torch.sqrt(ux * ux + uy * uy + uz * uz) / _c
    gphs = torch.where(gph == 0.0, torch.ones_like(gph), gph)
    return _alpha * _m_e * _c * _c / _hbar * \
        _interp_log(chi, chis_np, T) * chi / gphs


def schwinger_pair_number(ex, ey, ez, bx, by, bz, dV, dt):
    """Expected Schwinger pairs per cell (SchwingerProcessWrapper.H; the
    rate of the reference's analysis_schwinger.py).  The field invariants
    are formed in units of the Schwinger field and the prefactor (~3e56
    m^-3 s^-1) is multiplied by dV dt before it meets a tensor: the same
    function as the JAX package's, whose F^2 (~1e71 at 1e18 V/m) and
    prefactor overflow float32."""
    inv_es = 1.0 / E_SCHWINGER
    e = [f * inv_es for f in (ex, ey, ez)]
    h = [f * (_c * inv_es) for f in (bx, by, bz)]
    E2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
    H2 = h[0] * h[0] + h[1] * h[1] + h[2] * h[2]
    F = 0.5 * (E2 - H2)
    G = e[0] * h[0] + e[1] * h[1] + e[2] * h[2]
    root = torch.sqrt(F * F + G * G)
    eps = torch.sqrt(torch.clamp(root + F, min=0.0))
    eta = torch.sqrt(torch.clamp(root - F, min=0.0))
    coef = (_q_e**2 * E_SCHWINGER**2 / (4 * np.pi**2 * _c * _hbar**2)
            * dV * dt)
    safe_eps = torch.where(eps > 0, eps, torch.ones_like(eps))
    # eps eta coth(pi eta/eps) -> eps^2/pi as eta -> 0
    arg = np.pi * eta / safe_eps
    coth_term = torch.where(
        arg > 1e-8, eps * eta / torch.tanh(torch.clamp(arg, min=1e-30)),
        safe_eps**2 / np.pi)
    return torch.where(eps > 0.0,
                       coef * coth_term * torch.exp(-np.pi / safe_eps),
                       torch.zeros_like(eps))


# --------------------------------------------------------------------------
# step-level updates
# --------------------------------------------------------------------------

def emit_products(parent_w, parent_pos, mask, prod, ndim, u3,
                  tau_new=None, tau_attr=None):
    """``prod`` with one product per event of ``mask`` placed in its free
    slots, at the parent's position and weight (``parent_w``) with momentum
    ``u3``; runtime attributes 0, except ``tau_attr``, which takes
    ``tau_new`` (one per parent slot)."""
    tgt, placeable = emit_targets(mask, ~prod.alive)
    out = prod.replace(
        w=put_rows(prod.w, tgt, parent_w),
        ux=put_rows(prod.ux, tgt, u3[0]),
        uy=put_rows(prod.uy, tgt, u3[1]),
        uz=put_rows(prod.uz, tgt, u3[2]),
        alive=put_rows(prod.alive, tgt, placeable),
    ).with_positions(ndim, [put_rows(p, tgt, q) for p, q in
                            zip(prod.positions(ndim), parent_pos)])
    if out.extra:
        out = out.replace(extra={
            k: put_rows(v, tgt, tau_new if (k == tau_attr
                                             and tau_new is not None) else 0)
            for k, v in out.extra.items()})
    return out


def quantum_sync_event(sp, prod, e6, r_frac, tau_new, tau_prod, ndim):
    """One species' quantum-synchrotron emission on given draws, one per
    parent slot: uniform ``r_frac`` (the photon's share), exponential
    ``tau_new`` (the emitters' new optical depths) and ``tau_prod`` (the
    photons' Breit-Wheeler depths).  Returns (parent, photon species)."""
    dtype = sp.ux.dtype
    chis_np = qs_tables()[0]
    chi = particle_chi(sp.ux, sp.uy, sp.uz, *e6)
    tau = sp.extra["opticalDepthQSR"]
    event = sp.alive & (tau <= 0.0) & (chi > float(chis_np[0]))
    f = sample_frac(r_frac, chi, "qs", dtype)
    # photon momentum = f times the parent's (collinear emission)
    ph_u = (f * sp.ux, f * sp.uy, f * sp.uz)
    new_u = tuple(torch.where(event, (1.0 - f) * u, u)
                  for u in (sp.ux, sp.uy, sp.uz))
    tau = torch.where(event, tau_new, tau)
    sp = sp.replace(ux=new_u[0], uy=new_u[1], uz=new_u[2],
                    extra={**sp.extra, "opticalDepthQSR": tau})
    prod = emit_products(sp.w, sp.positions(ndim), event, prod, ndim, ph_u,
                         tau_new=tau_prod, tau_attr="opticalDepthBW")
    return sp, prod


def breit_wheeler_event(sp, ele, pos, e6, r_frac, tau_e, tau_p, ndim):
    """One photon species' pair creation on given draws, one per photon
    slot: uniform ``r_frac`` (the electron's share), exponential ``tau_e``
    and ``tau_p`` (the electrons' and positrons' quantum-synchrotron
    depths).  Returns (photons, electron species, positron species)."""
    dtype = sp.ux.dtype
    chis_np = bw_tables()[0]
    chi = photon_chi(sp.ux, sp.uy, sp.uz, *e6)
    event = (sp.alive & (sp.extra["opticalDepthBW"] <= 0.0)
             & (chi > float(chis_np[0])))
    f = sample_frac(r_frac, chi, "bw", dtype)
    ele_u = (f * sp.ux, f * sp.uy, f * sp.uz)
    pos_u = ((1 - f) * sp.ux, (1 - f) * sp.uy, (1 - f) * sp.uz)
    sp = sp.replace(alive=sp.alive & ~event)
    at = sp.positions(ndim)
    ele = emit_products(sp.w, at, event, ele, ndim, ele_u, tau_new=tau_e,
                        tau_attr="opticalDepthQSR")
    pos = emit_products(sp.w, at, event, pos, ndim, pos_u, tau_new=tau_p,
                        tau_attr="opticalDepthQSR")
    return sp, ele, pos


def qed_update(state, cfg, e6_of, draws):
    """Quantum-synchrotron emission, then Breit-Wheeler pair creation, of
    every species that does them (the doQEDEvents slot of the step), on the
    numbers of ``draws``.  ``e6_of(name)`` gives (ex..bz) at that species'
    particles."""
    ndim = cfg.geometry.ndim
    dtype = state.fields.Ex.dtype
    species = dict(state.species)
    for sp_cfg in cfg.species:
        if not sp_cfg.do_qed_quantum_sync or sp_cfg.qed_product == "":
            continue
        sp = species[sp_cfg.name]
        if sp.capacity == 0:
            continue
        e6 = e6_of(sp_cfg.name)
        k1, k2 = draws.split(2)
        r_frac = k1.uniform((sp.capacity,), dtype)
        tau_new = k2.exponential((sp.capacity,), dtype)
        (k3,) = draws.split(1)
        tau_prod = k3.exponential((sp.capacity,), dtype)
        species[sp_cfg.name], species[sp_cfg.qed_product] = \
            quantum_sync_event(sp, species[sp_cfg.qed_product], e6, r_frac,
                               tau_new, tau_prod, ndim)
    for sp_cfg in cfg.species:
        if not sp_cfg.do_qed_breit_wheeler:
            continue
        sp = species[sp_cfg.name]
        if sp.capacity == 0:
            continue
        e6 = e6_of(sp_cfg.name)
        k1, k2, k3 = draws.split(3)
        r_frac = k1.uniform((sp.capacity,), dtype)
        tau_e = k2.exponential((sp.capacity,), dtype)
        tau_p = k3.exponential((sp.capacity,), dtype)
        ne, npos = sp_cfg.qed_bw_ele_product, sp_cfg.qed_bw_pos_product
        species[sp_cfg.name], species[ne], species[npos] = \
            breit_wheeler_event(sp, species[ne], species[npos], e6, r_frac,
                                tau_e, tau_p, ndim)
    return state.replace(species=species)


def schwinger_expected_pairs(fields, cfg, dt):
    """The expected pairs per cell (of the domain's shape) from the fields
    averaged to the cell centers, zero outside the activation region
    (qed_schwinger.{x,y,z}{min,max})."""
    from ..core.grid import yee_staggering

    geom = cfg.geometry
    ndim = geom.ndim
    stag = yee_staggering(ndim)

    def cc(arr, name):
        out = arr
        for d in range(ndim):
            if stag[name][d] == 0:
                continue
            out = 0.5 * (out + torch.roll(out, -1, dims=d))
        return out

    e6 = [cc(getattr(fields, n), n)
          for n in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")]
    dV = float(np.prod(geom.dx))
    if ndim == 2:
        dV *= cfg.qed_schwinger_y_size
    exp_pairs = schwinger_pair_number(*e6, dV, dt)
    axes_xyz = {1: (2,), 2: (0, 2), 3: (0, 1, 2)}[ndim]
    region = torch.ones(geom.n_cell, dtype=torch.bool,
                        device=exp_pairs.device)
    for d, ax in enumerate(axes_xyz):
        lo = cfg.qed_schwinger_bounds_lo[ax]
        hi = cfg.qed_schwinger_bounds_hi[ax]
        if lo == float("-inf") and hi == float("inf"):
            continue
        g = geom.prob_lo[d] + (torch.arange(
            geom.n_cell[d], dtype=exp_pairs.dtype,
            device=exp_pairs.device) + 0.5) * geom.dx[d]
        shape = [1] * ndim
        shape[d] = geom.n_cell[d]
        region = region & ((g >= lo) & (g <= hi)).reshape(shape)
    return torch.where(region, exp_pairs, torch.zeros_like(exp_pairs))


def schwinger_pairs(exp_pairs, pois, gauss_std, thresh):
    """Pairs per cell: the Poisson draw ``pois`` (of min(expected,
    threshold)) up to the threshold, the Gaussian expected + sqrt(expected)
    ``gauss_std`` above it."""
    gauss = exp_pairs + torch.sqrt(torch.clamp(exp_pairs, min=0.0)) \
        * gauss_std
    return torch.where(exp_pairs <= thresh, pois,
                       torch.clamp(gauss, min=0.0))


def schwinger_emit(state, cfg, npairs):
    """One macro-pair at rest at the center of each producing cell, of
    weight the pair count, into the electron and positron product
    species."""
    geom = cfg.geometry
    ndim = geom.ndim
    flat = npairs.reshape(-1)
    mask = flat > 0.0
    centers = []
    for d in range(ndim):
        g = geom.prob_lo[d] + (torch.arange(
            geom.n_cell[d], dtype=flat.dtype, device=flat.device) + 0.5) \
            * geom.dx[d]
        shape = [1] * ndim
        shape[d] = geom.n_cell[d]
        centers.append(g.reshape(shape).expand(*geom.n_cell).reshape(-1))
    zeros = torch.zeros_like(flat)
    species = dict(state.species)
    for name in (cfg.qed_schwinger_ele, cfg.qed_schwinger_pos):
        species[name] = emit_products(flat, centers, mask, species[name],
                                      ndim, (zeros, zeros, zeros))
    return state.replace(species=species)


def schwinger_update(state, cfg, dt, draws):
    """Schwinger pair production (MultiParticleContainer::doQEDSchwinger,
    QEDSchwingerProcess.H) on the numbers of ``draws``: the expected pairs
    per cell, Poisson below the threshold and Gaussian above it."""
    exp_pairs = schwinger_expected_pairs(state.fields, cfg, dt)
    thresh = cfg.qed_schwinger_threshold
    k1, k2 = draws.split(2)
    pois = k1.poisson(torch.clamp(exp_pairs, max=thresh)).to(
        exp_pairs.dtype)
    gauss_std = k2.normal(exp_pairs.shape, exp_pairs.dtype)
    return schwinger_emit(state, cfg,
                          schwinger_pairs(exp_pairs, pois, gauss_std, thresh))
