"""RZ (quasi-cylindrical) PIC: multi-mode fields, the cylindrical Yee
step and the RZ particle operations.

The counterpart of ``warpx_tpu.rz.core`` (reference: the compile-time
WARPX_DIM_RZ geometry):

  * fields carry 2 n_modes - 1 real components per quantity: mode 0, then
    the (re, im) pair of each azimuthal mode m >= 1 (Source/WarpX.H:316
    n_rz_azimuthal_modes); arrays are (C, NR, NZ) with the 2D XZ Yee
    staggering (x -> r);
  * the cylindrical Yee curls with their 1/r metric terms and on-axis rules
    (FiniteDifferenceAlgorithms/CylindricalYeeAlgorithm.H; EvolveB.cpp,
    EvolveE.cpp, EvolveF.cpp cylindrical branches);
  * particles live in 3D Cartesian (x, y, z) and are pushed by the standard
    pushers; the gather interpolates each mode at (r, z) with its
    cos/sin(m theta) phase and rotates to Cartesian (FieldGather.H RZ
    branch); Esirkepov deposition runs on the radii with the theta
    velocity at the mid position (CurrentDeposition.H RZ branch);
  * deposited J and rho get the below-axis folds and the 1/(2 pi r) ring
    volume scaling with the Verboncoeur axis factor
    (WarpXPushFieldsEM.cpp ApplyInverseVolumeScaling*);
  * the axis guard rows of the gather take the per-mode parity
    (WarpXFieldBoundaries.cpp:191 ApplyFieldBoundaryOnAxis).

Every function keeps the JAX function's name and arguments, with tensors on
one device in place of JAX arrays.  The per-particle scatters are
``index_add_`` and the gathers ``index_select``, one per shape tap, as the
JAX package's ``.at[].add`` and fancy indexing; no fused kernel lies on
these paths.  Host tables (radii, ring-volume scales, parities) are built
once per geometry and device.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict

import numpy as np
import torch

from .. import constants
from ..constants import c as _c, ep0 as _ep0, mu0 as _mu0
from ..core.boundaries import fill_guards_pec
from ..core.injection import attribute_values, columns_to_state
from ..core.laser import fill_amplitude, polarization_p_x
from ..core.state import FieldState, SimState
from ..ops.push import PUSHERS
from ..ops.shapes import esirkepov_weights, shape_weights
from ..utils.expression import compile_expression

__all__ = [
    "RZ_STAGGER", "rz_stagger", "compute_dt_rz", "field_shape",
    "rz_zero_fields", "rz_inject_species", "rz_inject_gaussian_beam",
    "rz_antenna_particles", "update_antenna_rz", "gather_rz",
    "deposit_rho_rz", "deposit_current_rz", "evolve_b_rz", "evolve_e_rz",
    "evolve_f_rz", "apply_silver_mueller_rz", "enforce_walls_rz",
    "RZStepper", "rz_diag_rho", "rz_cell_centered_output", "rz_checksums",
    "check_rz_supported", "rz_init_state",
]

# (r, z) nodal flags, the 2D XZ Yee staggering with x -> r (JAX core.py:52)
RZ_STAGGER = {
    "Er": (0, 1), "Et": (1, 1), "Ez": (1, 0),
    "Br": (1, 0), "Bt": (0, 0), "Bz": (0, 1),
    "jr": (0, 1), "jt": (1, 1), "jz": (1, 0),
    "rho": (1, 1), "F": (1, 1),
}


def rz_stagger(cfg, name):
    """Component nodal flags: the spectral solver stores every component
    cell-centered (WarpX.cpp:2153-2160), FDTD the cylindrical Yee
    staggering."""
    if cfg.em_solver == "psatd":
        return (0, 0)
    return RZ_STAGGER[name]


_GALERKIN_R = {"Er": ("r",), "Et": (), "Ez": ("z",),
               "Br": ("z",), "Bt": ("r", "z"), "Bz": ("r",)}
# below-axis guard parity of mode 0 (r/theta components odd, z and scalars
# even; JAX core.py:72)
_AXIS_PARITY0 = {"Er": -1, "Et": -1, "Br": -1, "Bt": -1,
                 "Ez": +1, "Bz": +1, "F": +1, "rho": +1}
# the Cartesian field names that hold the RZ components
_ATTR = {"Er": "Ex", "Et": "Ey", "Ez": "Ez", "Br": "Bx", "Bt": "By",
         "Bz": "Bz"}


def compute_dt_rz(dr, dz, n_modes, cfl):
    """Semi-analytic RZ CFL (CylindricalYeeAlgorithm.H:46-63)."""
    coeffs = (0.2105, 1.0, 3.5234, 8.5104, 15.5059, 24.5037)
    alpha = (coeffs[n_modes - 1] if n_modes < 7
             else (n_modes - 1.0) ** 2 - 0.4)
    return cfl / (_c * math.sqrt((1.0 + alpha) / (dr * dr) + 1.0 / (dz * dz)))


def _shape(cfg):
    geom = cfg.geometry
    return geom.n_cell[0], geom.n_cell[1], 2 * cfg.n_rz_modes - 1


def _z_bcs(cfg):
    """(periodic, bc_lo, bc_hi) of the z dimension."""
    per = cfg.geometry.periodic[1]
    bc_lo = (tuple(cfg.field_bc_lo or ()) + ("none", "periodic"))[1]
    bc_hi = (tuple(cfg.field_bc_hi or ()) + ("none", "periodic"))[1]
    return per, bc_lo, bc_hi


def field_shape(cfg, name):
    """(C, NR(+1), NZ(+1)): a component nodal in bounded z stores nz + 1
    values (both walls)."""
    nr, nz, ncomp = _shape(cfg)
    fr, fz = rz_stagger(cfg, name)
    nzv = nz + (1 if (fz and not cfg.geometry.periodic[1]) else 0)
    return (ncomp, nr + 1 if fr else nr, nzv)


# a component tangential to a z wall (r and theta); z and scalars normal
_Z_TANG = {"Er": True, "Et": True, "Br": True, "Bt": True,
           "Ez": False, "Bz": False}


def _extend_z(arr, name, cfg, ng):
    """``ng`` z guard layers filled per the z faces: the periodic wrap, or
    the PEC mirror rules (WarpX_PEC.cpp: E tangential odd with a zero wall,
    E normal even; B tangential even, B normal odd with a zero wall)."""
    per, bc_lo, bc_hi = _z_bcs(cfg)
    if per:
        return torch.cat([arr[..., -ng:], arr, arr[..., :ng]], dim=-1)
    nz = cfg.geometry.n_cell[1]
    nodal = rz_stagger(cfg, name)[1] == 1
    zeros = arr.new_zeros(arr.shape[:-1] + (ng,))
    out = torch.cat([zeros, arr, zeros], dim=-1)
    tang = _Z_TANG[name]
    if name[0] == "E":
        mirror_neg, zero_wall = tang, tang and nodal
    else:
        mirror_neg, zero_wall = not tang, (not tang) and nodal
    for side, bc in (("lo", bc_lo), ("hi", bc_hi)):
        if bc == "pec":
            out = fill_guards_pec(out, out.ndim - 1, ng, nz, nodal,
                                  mirror_neg, side, zero_wall)
    return out


def _sm_bcs(cfg):
    """(sm_zlo, sm_zhi, sm_rhi): the absorbing Silver-Mueller faces."""
    per, bc_lo, bc_hi = _z_bcs(cfg)
    bc_rhi = (tuple(cfg.field_bc_hi or ()) + ("none", "periodic"))[0]
    sm = "absorbing_silver_mueller"
    return (not per and bc_lo == sm, not per and bc_hi == sm, bc_rhi == sm)


def rz_zero_fields(cfg, dtype, device) -> FieldState:
    """A FieldState of the RZ layouts (r -> x, theta -> y), with the
    Silver-Mueller guard rings ``smg`` where a face absorbs."""
    def z(nm):
        return torch.zeros(field_shape(cfg, nm), dtype=dtype, device=device)

    sm_zlo, sm_zhi, sm_rhi = _sm_bcs(cfg)
    smg = None
    if sm_zlo or sm_zhi or sm_rhi:
        nr, nz, ncomp = _shape(cfg)
        nzn = field_shape(cfg, "Et")[2]
        kw = dict(dtype=dtype, device=device)
        smg = {}
        for side, on in (("zlo", sm_zlo), ("zhi", sm_zhi)):
            if on:
                smg["br_" + side] = torch.zeros((ncomp, nr + 1), **kw)
                smg["bt_" + side] = torch.zeros((ncomp, nr), **kw)
        if sm_rhi:
            smg["bt_rhi"] = torch.zeros((ncomp, nz), **kw)
            smg["bz_rhi"] = torch.zeros((ncomp, nzn), **kw)
    return FieldState(
        Ex=z("Er"), Ey=z("Et"), Ez=z("Ez"),
        Bx=z("Br"), By=z("Bt"), Bz=z("Bz"),
        jx=z("jr"), jy=z("jt"), jz=z("jz"),
        F=z("F") if cfg.do_dive_cleaning else None,
        smg=smg,
    )


# --------------------------------------------------------------- injection
def rz_inject_gaussian_beam(sp_cfg, cfg, np_dtype, rng):
    """AddGaussianBeam in RZ (PhysicalParticleContainer.cpp:503-680): 3D
    Cartesian normal positions, weight q_tot / (q npart); numpy columns."""
    n = sp_cfg.npart
    x = rng.normal(sp_cfg.x_m, sp_cfg.x_rms, n)
    y = rng.normal(sp_cfg.y_m, sp_cfg.y_rms, n)
    z = rng.normal(sp_cfg.z_m, sp_cfg.z_rms, n)
    keep = np.abs(z - sp_cfg.z_m) <= sp_cfg.z_cut * (
        sp_cfg.z_rms if sp_cfg.z_rms else np.inf)
    if sp_cfg.momentum_distribution == "gaussian":
        u3 = [rng.normal(m, th or 0.0, n) * _c
              for m, th in ((sp_cfg.ux, sp_cfg.ux_th),
                            (sp_cfg.uy, sp_cfg.uy_th),
                            (sp_cfg.uz, sp_cfg.uz_th))]
    elif sp_cfg.momentum_distribution == "constant":
        u3 = [np.full(n, v * _c) for v in (sp_cfg.ux, sp_cfg.uy, sp_cfg.uz)]
    else:
        u3 = [np.zeros(n)] * 3
    w = np.where(keep, sp_cfg.q_tot / (sp_cfg.charge * n), 0.0
                 ).astype(np_dtype)
    extra = attribute_values(sp_cfg, (x, y, z), *u3, 0.0, np_dtype)
    extra["theta"] = np.arctan2(y, x).astype(np_dtype)
    return dict(w=w, ux=u3[0].astype(np_dtype), uy=u3[1].astype(np_dtype),
                uz=u3[2].astype(np_dtype), alive=keep,
                x=x.astype(np_dtype), y=y.astype(np_dtype),
                z=z.astype(np_dtype), extra=extra)


def rz_inject_species(sp_cfg, cfg, np_dtype, rng):
    """NUniformPerCell in RZ (PhysicalParticleContainer.cpp:1120-1305), as
    numpy columns: per cell (ir, iz) n_r x n_theta x n_z particles at
    theta = 2 pi (it + 1/2) / n_theta plus a per-cell random offset under
    ``random_theta``; weight density (dr dz / ppc) 2 pi r.  The raw theta
    is kept as the ``theta`` attribute (PIdx::theta); a species that
    injects behind a moving window gets its run's columns of free slots.
    The draws are the JAX package's, in its order (JAX core.py:234-309)."""
    if sp_cfg.injection_style == "gaussian_beam":
        return rz_inject_gaussian_beam(sp_cfg, cfg, np_dtype, rng)
    geom = cfg.geometry
    nr, nz = geom.n_cell
    dr, dz = geom.dx
    rmin, zmin = geom.prob_lo
    ppc = sp_cfg.num_particles_per_cell_each_dim or (1, 1, 1)
    n_r, n_t, n_z = (tuple(ppc) + (1, 1, 1))[:3]
    ppc_tot = n_r * n_t * n_z

    # the (ir, iz, a, t, b) lattice: each coordinate from the axes it
    # depends on, broadcast (the JAX package's meshgrid, elementwise the
    # same operations)
    shape = (nr, nz, n_r, n_t, n_z)

    def axis(n, d):
        return np.arange(n).reshape([n if k == d else 1 for k in range(5)])

    r = rmin + (axis(nr, 0) + (axis(n_r, 2) + 0.5) / n_r) * dr
    z = zmin + (axis(nz, 1) + (axis(n_z, 4) + 0.5) / n_z) * dz
    theta = 2.0 * np.pi * (axis(n_t, 3) + 0.5) / n_t
    if sp_cfg.random_theta:
        theta = theta + rng.uniform(0.0, 2.0 * np.pi, (nr, nz, 1, 1, 1))
    r, z, theta = [np.broadcast_to(q.astype(np_dtype), shape).ravel()
                   for q in (r, z, theta)]
    x = r * np.cos(theta)
    y = r * np.sin(theta)

    # the species bounds: xmin/xmax bound the radius
    lo = sp_cfg.bounds_lo or (-np.inf, -np.inf)
    hi = sp_cfg.bounds_hi or (np.inf, np.inf)
    inside = (r >= lo[0]) & (r <= hi[0]) & (z >= lo[1]) & (z <= hi[1])

    dens = _density_at(sp_cfg, x, y, z, np_dtype)
    u3 = _momentum_at(sp_cfg, x, y, z, np_dtype, rng)
    alive = inside & (dens > 0)
    w = np.where(alive, dens * (dr * dz / ppc_tot) * 2.0 * np.pi * r, 0.0
                 ).astype(np_dtype)
    extra = attribute_values(sp_cfg, (x, y, z), *u3, 0.0, np_dtype)
    extra["theta"] = theta
    cols = dict(
        w=w,
        ux=np.where(alive, u3[0], 0.0).astype(np_dtype),
        uy=np.where(alive, u3[1], 0.0).astype(np_dtype),
        uz=np.where(alive, u3[2], 0.0).astype(np_dtype),
        alive=alive, x=x, y=y, z=z, extra=extra)
    if sp_cfg.do_continuous_injection and cfg.do_moving_window:
        # headroom for the whole run's window motion, in whole columns
        v = abs(cfg.moving_window_v) * _c
        ncols = int(math.ceil(v * cfg.dt * max(cfg.max_step, 1) / dz)) + 2
        pad = ncols * nr * ppc_tot

        def _pad(arr):
            return np.concatenate([arr, np.zeros(pad, arr.dtype)])

        cols = {k: _pad(v_) for k, v_ in cols.items() if k != "extra"}
        cols["extra"] = {k: _pad(v_) for k, v_ in extra.items()}
    return cols


def _density_at(sp_cfg, x, y, z, np_dtype):
    if sp_cfg.profile == "constant":
        return np.full(x.shape, sp_cfg.density, np_dtype)
    if sp_cfg.profile in ("parse", "parse_density_function"):
        fn = compile_expression(sp_cfg.density_expr, ["x", "y", "z"],
                                dict(sp_cfg.user_constants))
        return np.asarray(fn(x, y, z).numpy(), np_dtype)
    raise NotImplementedError(f"RZ density profile {sp_cfg.profile}")


def _momentum_at(sp_cfg, x, y, z, np_dtype, rng):
    n = x.shape[0]
    md = sp_cfg.momentum_distribution
    if md in ("at_rest", "none"):
        u3 = [np.zeros(n, np_dtype)] * 3
    elif md == "constant":
        u3 = [np.full(n, v, np_dtype)
              for v in (sp_cfg.ux, sp_cfg.uy, sp_cfg.uz)]
    elif md == "gaussian":
        u3 = [rng.normal(m, th or 0.0, n).astype(np_dtype)
              for m, th in ((sp_cfg.ux, sp_cfg.ux_th),
                            (sp_cfg.uy, sp_cfg.uy_th),
                            (sp_cfg.uz, sp_cfg.uz_th))]
    elif md == "parse_momentum_function":
        u3 = [np.asarray(compile_expression(
            e, ["x", "y", "z"], dict(sp_cfg.user_constants))(x, y, z).numpy(),
            np_dtype) * np.ones(n, np_dtype)
            for e in sp_cfg.momentum_exprs]
    else:
        raise NotImplementedError(f"RZ momentum distribution {md}")
    return [u * _c for u in u3]


# ---------------------------------------------------------- laser antenna
def rz_antenna_particles(laser, cfg, np_dtype):
    """The RZ antenna (LaserParticleContainer.cpp:524-537): a radial lattice
    r_i = position_r + dr (i + 1/2) fanned into (n_modes - 1) 4 theta
    spokes, two particles (+-w) a point with ring weight
    (ep0 / mobility) dr 2 pi r / n_spokes.  Returns (columns, mobility)."""
    geom = cfg.geometry
    dr = geom.dx[0]
    mobility = 0.05 / laser.e_max
    w0 = constants.ep0 / mobility * dr
    n_spokes = max(1, (cfg.n_rz_modes - 1) * 4)
    r0, z0 = laser.position[0], laser.position[2]
    imin = int((geom.prob_lo[0] - r0) / dr)
    imax = int((geom.prob_hi[0] - r0) / dr)
    pts = []
    for i in range(imin, imax + 1):
        r = r0 + dr * (i + 0.5)
        if not (geom.prob_lo[0] <= r <= geom.prob_hi[0]):
            continue
        if not (geom.prob_lo[1] <= z0 <= geom.prob_hi[1]):
            continue
        for s in range(n_spokes):
            phase = 2.0 * np.pi * s / n_spokes
            rw = w0 * 2.0 * np.pi * r / n_spokes
            pts.append((r * np.cos(phase), r * np.sin(phase), z0, rw))
            pts.append((r * np.cos(phase), r * np.sin(phase), z0, -rw))
    n = len(pts)
    arr = np.array(pts, dtype=np_dtype).reshape(n, 4)
    zeros = np.zeros(n, dtype=np_dtype)
    return dict(w=arr[:, 3].copy(), ux=zeros.copy(), uy=zeros.copy(),
                uz=zeros.copy(), alive=np.ones(n, dtype=bool),
                x=arr[:, 0].copy(), y=arr[:, 1].copy(),
                z=arr[:, 2].copy()), mobility


def update_antenna_rz(sp, laser, mobility, t, dt):
    """The antenna's prescribed motion in RZ (update_laser_particle with the
    3D plane vectors u_X = p_X, u_Y = n x p_X, LaserParticleContainer.cpp:
    210; the Gaussian profile with the 3D diffraction prefactor)."""
    nvec = np.array(laser.direction, float)
    nvec = nvec / np.linalg.norm(nvec)
    p_X = polarization_p_x(laser)
    u_Y = np.cross(nvec, p_X)
    px, py, pz = (float(v) for v in p_X)
    qx, qy, qz = (float(v) for v in u_Y)
    x0, y0, z0 = laser.position
    Xp = px * (sp.x - x0) + py * (sp.y - y0) + pz * (sp.z - z0)
    Yp = qx * (sp.x - x0) + qy * (sp.y - y0) + qz * (sp.z - z0)
    amplitude = fill_amplitude(laser, 3, Xp, Yp, t)
    sign_charge = torch.where(sp.w > 0, -1.0, 1.0).to(sp.w.dtype)
    v_over_c = sign_charge * mobility * amplitude
    vx = _c * v_over_c * px
    vy = _c * v_over_c * py
    vz = _c * v_over_c * pz
    gamma = 1.0 / torch.sqrt(1.0 - v_over_c * v_over_c)
    return sp.replace(ux=gamma * vx, uy=gamma * vy, uz=gamma * vz,
                      x=sp.x + vx * dt, y=sp.y + vy * dt, z=sp.z + vz * dt)


# ------------------------------------------------------------ host tables
@functools.lru_cache(maxsize=64)
def _axis_signs(name, ncomp, dtype, device):
    """Below-axis mirror sign per mode component (JAX core.py:436-451:
    mode 0 the component's parity; mode m, (-1)^(m+1) for r/theta
    components and its negative for z and scalars)."""
    base = _AXIS_PARITY0[name]
    signs = []
    for ci in range(ncomp):
        m = (ci + 1) // 2
        if ci == 0:
            signs.append(float(base))
        else:
            sgn = (-1.0) ** (m + 1)
            signs.append(sgn if base < 0 else -sgn)
    return torch.tensor(signs, dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def _radii(geom, nodal, dtype, device):
    """The radii of the nodal (nr + 1) or cell-centered (nr) rows."""
    nr = geom.n_cell[0]
    dr = geom.dx[0]
    if nodal:
        r = geom.prob_lo[0] + np.arange(nr + 1) * dr
    else:
        r = geom.prob_lo[0] + (np.arange(nr) + 0.5) * dr
    return torch.from_numpy(r).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=64)
def _ring_scale(geom, nodal, kind, dtype, device):
    """1 / (2 pi r) per valid row, with the axis rule: 0 for r/theta
    components, 1 / (pi dr / 3) (the Verboncoeur factor) for z and rho
    (JAX core.py:566-580)."""
    dr = geom.dx[0]
    rmin = geom.prob_lo[0]
    nr_valid = geom.n_cell[0] + (1 if nodal else 0)
    off = 0.0 if nodal else 0.5
    rrow = np.abs(rmin + (np.arange(nr_valid) + off) * dr)
    on_axis = rrow == 0.0
    avf = 1.0 / 3.0
    inv = 1.0 / (2.0 * np.pi * np.where(on_axis, 1.0, rrow))
    if kind in ("r", "t"):
        scale = np.where(on_axis, 0.0, inv)
    else:
        scale = np.where(on_axis, 1.0 / (np.pi * dr * avf), inv)
    return torch.from_numpy(scale).to(device=device, dtype=dtype)


def _trig(x, y, r):
    """(cos, sin) of the azimuth, (1, 0) on the axis."""
    ok = r > 0
    safe = torch.where(ok, r, torch.ones_like(r))
    return (torch.where(ok, x / safe, torch.ones_like(r)),
            torch.where(ok, y / safe, torch.zeros_like(r)))


def _phases(c0, s0, nmodes):
    """(cos m theta, sin m theta) for m < nmodes by the recurrence."""
    out = [(torch.ones_like(c0), torch.zeros_like(s0))]
    for _ in range(1, nmodes):
        pc, ps = out[-1]
        out.append((pc * c0 - ps * s0, pc * s0 + ps * c0))
    return out


# ------------------------------------------------------------------ gather
def _extend_axis(arr, name, ng, nr_valid=None, nodal_r=None):
    """``ng`` mirrored rows below the axis (the mode parity) and ``ng``
    zero rows beyond rmax (JAX core.py:426-452)."""
    ncomp = arr.shape[0]
    if nodal_r is None:
        nodal_r = RZ_STAGGER[name][0] == 1
    if ng == 0:
        return arr
    srcs = [min(g if nodal_r else g - 1, arr.shape[1] - 1)
            for g in range(ng, 0, -1)]
    signs = _axis_signs(name, ncomp, arr.dtype, arr.device)
    below = arr[:, srcs] * signs[:, None, None]
    above = arr.new_zeros((ncomp, ng, arr.shape[2]))
    return torch.cat([below, arr, above], dim=1)


def _idx(i):
    """Grid indices as int32, the index type of ``index_add_`` and
    ``index_select`` here (every RZ array is far below 2^31 cells)."""
    return i.to(torch.int32)


def gather_rz(pos3, farr: Dict[str, torch.Tensor], cfg, order, ng,
              z_origin=None):
    """(Ex, Ey, Ez, Bx, By, Bz) in Cartesian at the particles: each mode at
    (r, z) with its cos/sin(m theta) phase, rotated from (r, theta) to
    (x, y) (FieldGather.H:1522-1560).  ``farr`` maps the RZ names to
    (C, NR, NZ) arrays; ``z_origin`` replaces the z grid origin.  The
    components that share a staggering and a shape order (Er and Bz, Ez and
    Br under Galerkin) share their weights and indices and are read by one
    ``index_select`` a tap; each sum runs in the JAX package's order."""
    geom = cfg.geometry
    dr, dz = geom.dx
    rmin, zmin = geom.prob_lo
    if z_origin is not None:
        zmin = z_origin
    nz = geom.n_cell[1]
    x, y, z = pos3
    r = torch.sqrt(x * x + y * y)
    cost, sint = _trig(x, y, r)
    rg = (r - rmin) / dr
    zg = (z - zmin) / dz
    nmodes = cfg.n_rz_modes
    phases = _phases(cost, sint, nmodes)

    bounded_z = not geom.periodic[1]
    groups = {}
    for name in ("Er", "Et", "Ez", "Br", "Bt", "Bz"):
        fr, fz = rz_stagger(cfg, name)
        o_r = order - 1 if (cfg.galerkin and "r" in _GALERKIN_R[name]) \
            else order
        o_z = order - 1 if (cfg.galerkin and "z" in _GALERKIN_R[name]) \
            else order
        groups.setdefault((fr, fz, o_r, o_z), []).append(name)
    out = {}
    for (fr, fz, o_r, o_z), names in groups.items():
        arrs = []
        for name in names:
            arr = _extend_axis(farr[name], name, ng, nodal_r=(fr == 1))
            if bounded_z:
                arr = _extend_z(arr, name, cfg, ng)
            arrs.append(arr)
        ncomp, nre, nze = arrs[0].shape
        flat = torch.cat(arrs).reshape(len(names) * ncomp, nre * nze)
        xr = rg - (0.5 if fr == 0 else 0.0)
        xz = zg - (0.5 if fz == 0 else 0.0)
        i0, wr = shape_weights(xr, o_r)
        k0, wz = shape_weights(xz, o_z)
        zcols = [(torch.clamp(k0 + (b + ng), 0, nze - 1) if bounded_z
                  else torch.remainder(k0 + b, nz)) for b in range(o_z + 1)]
        vals_of = [None] * len(names)
        for a, wa in enumerate(wr):
            rbase = torch.clamp(i0 + (a + ng), 0, nre - 1) * nze
            for b, wb in enumerate(wz):
                vals = flat.index_select(1, _idx(rbase + zcols[b]))
                wab = wa * wb
                for j in range(len(names)):
                    v = vals[j * ncomp:(j + 1) * ncomp]
                    contrib = v[0]
                    for m in range(1, nmodes):
                        pc, ps = phases[m]
                        # the stored components are the cos/sin
                        # coefficients (FieldGather.H:322)
                        contrib = contrib + (v[2 * m - 1] * pc
                                             + v[2 * m] * ps)
                    term = wab * contrib
                    vals_of[j] = term if vals_of[j] is None \
                        else vals_of[j] + term
        out.update(zip(names, vals_of))

    ex = cost * out["Er"] - sint * out["Et"]
    ey = sint * out["Er"] + cost * out["Et"]
    bx = cost * out["Br"] - sint * out["Bt"]
    by = sint * out["Br"] + cost * out["Bt"]
    return ex, ey, out["Ez"], bx, by, out["Bz"]


# ----------------------------------------------------------------- deposit
def _scatter_rz(target, lin, vals, alpha=1.0):
    """``target`` (NR_e, NZ_e) plus ``alpha`` ``vals`` at the flat indices
    ``lin`` (row NZ_e + column), in place and returned."""
    target.view(-1).index_add_(0, lin, vals, alpha=alpha)
    return target


def _fold_and_scale_modes(ext, name, cfg, ng, kind):
    """Per-mode below-axis folds and ring-volume scaling of a deposited
    (C, NR + 2 ng, NZ) array (WarpXPushFieldsEM.cpp
    ApplyInverseVolumeScaling*; JAX core.py:535-580, 785-797): the guard
    row at -(g + 1) folds onto row g + 1 (nodal) or g (cell-centered) with
    the kind's sign ('r', 't': -1; 'z', 'rho': +1) times (-1)^m for mode
    m, then every row takes 1 / (2 pi r) with the axis rule."""
    geom = cfg.geometry
    nodal_r = rz_stagger(cfg, name)[0] == 1
    ncomp = ext.shape[0]
    nr_valid = ext.shape[1] - 2 * ng
    arr = ext[:, ng:ng + nr_valid].clone()
    if geom.prob_lo[0] == 0.0:
        base = {"r": -1.0, "t": -1.0, "z": +1.0, "rho": +1.0}[kind]
        sgn = torch.tensor([base * (-1.0) ** ((ci + 1) // 2)
                            for ci in range(ncomp)],
                           dtype=ext.dtype, device=ext.device)[:, None]
        for gi in range(ng):
            tgt = gi + 1 if nodal_r else gi
            if tgt >= nr_valid:
                continue
            arr[:, tgt] += sgn * ext[:, ng - 1 - gi]
    scale = _ring_scale(geom, nodal_r, kind, ext.dtype, ext.device)
    return arr * scale[None, :, None]


def deposit_rho_rz(pos3, w, q, cfg, order, ng, dtype, z_origin=None):
    """Nodal rho of every azimuthal mode (ChargeDeposition.H RZ: a factor
    2 e^{i m theta} a mode) with the ring-volume scaling.  Bounded z
    scatters into z guards that are then dropped (JAX core.py:583-631)."""
    geom = cfg.geometry
    dr, dz = geom.dx
    rmin, zmin = geom.prob_lo
    if z_origin is not None:
        zmin = z_origin
    nr, nz = geom.n_cell
    bounded_z = not geom.periodic[1]
    nzv = nz + (1 if bounded_z else 0)
    ngz = ng if bounded_z else 0
    nmodes = cfg.n_rz_modes
    ncomp = 2 * nmodes - 1
    x, y, z = pos3
    r = torch.sqrt(x * x + y * y)
    c0, s0 = _trig(x, y, r)
    # 2 e^{i m theta}: the factor 2 scales exactly
    phases2 = [(2.0 * pc, 2.0 * ps) for pc, ps in _phases(c0, s0, nmodes)]
    rg = (r - rmin) / dr
    zg = (z - zmin) / dz
    i0, wr = shape_weights(rg, order)
    k0, wz = shape_weights(zg, order)
    ext = torch.zeros((ncomp, nr + 1 + 2 * ng, nzv + 2 * ngz), dtype=dtype,
                      device=w.device)
    nre, nze = ext.shape[1:]
    zcols = [(torch.clamp(k0 + (b + ngz), 0, nze - 1) if bounded_z
              else torch.remainder(k0 + b, nz)) for b in range(order + 1)]
    wq = (q / (dr * dz)) * w
    for a, wa in enumerate(wr):
        rbase = torch.clamp(i0 + (a + ng), 0, nre - 1) * nze
        wqa = wq * wa
        for b, wb in enumerate(wz):
            lin = _idx(rbase + zcols[b])
            val = wqa * wb
            _scatter_rz(ext[0], lin, val)
            for m in range(1, nmodes):
                pc2, ps2 = phases2[m]
                _scatter_rz(ext[2 * m - 1], lin, val * pc2)
                _scatter_rz(ext[2 * m], lin, val * ps2)
    if bounded_z:
        ext = ext[..., ngz:ngz + nzv]
    return _fold_and_scale_modes(ext, "rho", cfg, ng, "rho")


def deposit_current_rz(pos_new3, ux, uy, uz, w, q, cfg, dt, order, ng,
                       dtype, z_origin=None):
    """Esirkepov RZ current deposition of every azimuthal mode
    (CurrentDeposition.H:826-890 RZ branch; JAX core.py:634-782): the old
    position is reconstructed ballistically, the deposit runs on the
    radii; J_theta is direct with the theta velocity at the mid position
    for mode 0 and the charge-conserving theta-displacement form for m >= 1
    (-2i r wq / (m dt dz) [S_new (xy_new - xy_mid) + S_old (xy_mid -
    xy_old)], CurrentDeposition.H:218).  Returns the scaled (jr, jt, jz).
    The factors that depend on one tap index only are formed once; each
    value is the JAX package's product up to exact scalings by 2 and 1/2."""
    geom = cfg.geometry
    dr, dz = geom.dx
    rmin, zmin = geom.prob_lo
    if z_origin is not None:
        zmin = z_origin
    nr, nz = geom.n_cell
    bounded_z = not geom.periodic[1]
    ngz = ng if bounded_z else 0
    nz_nod = nz + (1 if bounded_z else 0)
    nmodes = cfg.n_rz_modes
    ncomp = 2 * nmodes - 1
    inv_c2 = 1.0 / (_c * _c)
    gaminv = 1.0 / torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz) * inv_c2)
    xn, yn, zn = pos_new3
    xm = xn - 0.5 * dt * ux * gaminv
    ym = yn - 0.5 * dt * uy * gaminv
    xo = xn - dt * ux * gaminv
    yo = yn - dt * uy * gaminv
    zo = zn - dt * uz * gaminv
    rp_new = torch.sqrt(xn * xn + yn * yn)
    rp_mid = torch.sqrt(xm * xm + ym * ym)
    rp_old = torch.sqrt(xo * xo + yo * yo)
    cnew, snew = _trig(xn, yn, rp_new)
    cmid, smid = _trig(xm, ym, rp_mid)
    cold, sold = _trig(xo, yo, rp_old)
    vt = (-ux * smid + uy * cmid) * gaminv
    del xm, ym, xo, yo
    # per mode m >= 1: 2 e^{i m theta_mid} for jr and jz, and the theta
    # displacements (new - mid, mid - old) for jt
    modes = []
    for (pcn, psn), (pcm, psm), (pco, pso) in zip(
            _phases(cnew, snew, nmodes)[1:], _phases(cmid, smid, nmodes)[1:],
            _phases(cold, sold, nmodes)[1:]):
        modes.append((2.0 * pcm, 2.0 * psm, pcn - pcm, pcm - pco,
                      psn - psm, psm - pso))
    del cnew, snew, cmid, smid, cold, sold

    r_new = (rp_new - rmin) / dr
    r_old = (rp_old - rmin) / dr
    z_new = (zn - zmin) / dz
    z_old = (zo - zmin) / dz
    del rp_new, rp_old, zo
    i0, sr_n, sr_o = esirkepov_weights(r_new, r_old, order)
    k0, sz_n, sz_o = esirkepov_weights(z_new, z_old, order)
    T = order + 3
    wq = q * w
    invdtd_r = 1.0 / (dt * dz)
    invdtd_z = 1.0 / (dt * dr)
    invvol = 1.0 / (dr * dz)
    third, sixth = 1.0 / 3.0, 1.0 / 6.0

    kw = dict(dtype=dtype, device=w.device)
    ext_r = torch.zeros((ncomp, nr + 2 * ng, nz_nod + 2 * ngz), **kw)
    ext_t = torch.zeros((ncomp, nr + 1 + 2 * ng, nz_nod + 2 * ngz), **kw)
    ext_z = torch.zeros((ncomp, nr + 1 + 2 * ng, nz + 2 * ngz), **kw)
    nze, nze_z = ext_r.shape[2], ext_z.shape[2]

    # jr: cumulative in r times the averaged z shapes; jz the converse
    wq_r = wq * invdtd_r
    wq_z = wq * invdtd_z
    wq_t = wq * vt * invvol
    acc, a_r = 0.0, []
    for a in range(T):
        acc = acc + (sr_o[a] - sr_n[a])
        a_r.append(wq_r * acc)
    acc, b_z = 0.0, []
    for b in range(T):
        acc = acc + (sz_o[b] - sz_n[b])
        b_z.append(wq_z * acc)
    h_z = [0.5 * (sz_n[b] + sz_o[b]) for b in range(T)]
    if bounded_z:
        zcols = [torch.clamp(k0 + (b + ngz), 0, nze - 1) for b in range(T)]
        # jz's cell-centered rows: the JAX package indexes them with the
        # nodal clip, which differs only past z_hi + ng cells, where no live
        # particle deposits
        zcols_cc = [torch.clamp(k0 + (b + ngz), 0, nze_z - 1)
                    for b in range(T)]
    else:
        zcols = zcols_cc = [torch.remainder(k0 + b, nz) for b in range(T)]

    for a in range(T):
        rbase_r = torch.clamp(i0 + (a + ng), 0, ext_r.shape[1] - 1) * nze
        ridx_tz = torch.clamp(i0 + (a + ng), 0, ext_t.shape[1] - 1)
        rbase_t = ridx_tz * nze
        rbase_z = ridx_tz * nze_z
        del ridx_tz
        h_r = 0.5 * (sr_n[a] + sr_o[a])
        # this tap's radius in units of dr (CurrentDeposition.H:218) and
        # the jt factor 2 r_tap wq / (m dt dz) of each mode
        r_tap = (i0 + a).to(dtype) + rmin / dr
        k_m = [2.0 * r_tap * wq * invdtd_r / m for m in range(1, nmodes)]
        del r_tap
        for b in range(T):
            lin_r = _idx(rbase_r + zcols[b])
            lin_t = _idx(rbase_t + zcols[b])
            lin_z = _idx(rbase_z + zcols_cc[b])
            val_r = a_r[a] * h_z[b]
            val_z = b_z[b] * h_r
            sn_ab = sr_n[a] * sz_n[b]
            so_ab = sr_o[a] * sz_o[b]
            # jt mode 0: direct with the Esirkepov transverse mix
            mix = (third * (sn_ab + so_ab)
                   + sixth * (sr_n[a] * sz_o[b] + sr_o[a] * sz_n[b]))
            _scatter_rz(ext_r[0], lin_r, val_r)
            _scatter_rz(ext_t[0], lin_t, wq_t * mix)
            _scatter_rz(ext_z[0], lin_z, val_z)
            for m, (pcm2, psm2, dcn, dco, dsn, dso) in enumerate(modes, 1):
                _scatter_rz(ext_r[2 * m - 1], lin_r, val_r * pcm2)
                _scatter_rz(ext_r[2 * m], lin_r, val_r * psm2)
                _scatter_rz(ext_z[2 * m - 1], lin_z, val_z * pcm2)
                _scatter_rz(ext_z[2 * m], lin_z, val_z * psm2)
                # jt: -2i r_tap wq / (m dt dz) [Sn (xy_n - xy_m)
                #                                + So (xy_m - xy_o)]
                K = k_m[m - 1]
                _scatter_rz(ext_t[2 * m - 1], lin_t,
                            K * (sn_ab * dsn + so_ab * dso))
                _scatter_rz(ext_t[2 * m], lin_t,
                            K * (sn_ab * dcn + so_ab * dco), alpha=-1.0)

    if bounded_z:
        # the z guard scatters are dropped (only periodic axes fold)
        ext_r = ext_r[..., ngz:ngz + nz_nod]
        ext_t = ext_t[..., ngz:ngz + nz_nod]
        ext_z = ext_z[..., ngz:ngz + nz]
    jr = _fold_and_scale_modes(ext_r, "jr", cfg, ng, "r")
    jt = _fold_and_scale_modes(ext_t, "jt", cfg, ng, "t")
    jz = _fold_and_scale_modes(ext_z, "jz", cfg, ng, "z")
    return jr, jt, jz


# ------------------------------------------------------------- field solve
def _r_nodal(cfg, like):
    return _radii(cfg.geometry, True, like.dtype, like.device)


def _r_cc(cfg, like):
    return _radii(cfg.geometry, False, like.dtype, like.device)


def _dz_up(a):
    """f[j+1] - f[j] with periodic z (the last axis)."""
    return torch.roll(a, -1, dims=-1) - a


def _dz_dn(a):
    return a - torch.roll(a, 1, dims=-1)


def _dz_nod_to_cc(a, cfg):
    """d/dz of a z-nodal array at the nz cell centers (periodic storage
    wraps; bounded storage holds nz + 1 values)."""
    if cfg.geometry.periodic[1]:
        return _dz_up(a)
    return a[..., 1:] - a[..., :-1]


def _dz_cc_to_nod(a, name, cfg):
    """d/dz of a z-cell-centered array at the nodal z points (bounded z
    pads one PEC or zero guard a side)."""
    if cfg.geometry.periodic[1]:
        return _dz_dn(a)
    p = _extend_z(a, name, cfg, 1)
    return p[..., 1:] - p[..., :-1]


def evolve_b_rz(fields: FieldState, cfg, dt) -> FieldState:
    """EvolveBCylindrical (EvolveB.cpp), mode 0 and the higher modes (JAX
    core.py:844-900)."""
    geom = cfg.geometry
    dr, dz = geom.dx
    inv_dr, inv_dz = 1.0 / dr, 1.0 / dz
    Er, Et, Ez = fields.Ex, fields.Ey, fields.Ez
    Br, Bt, Bz = fields.Bx, fields.By, fields.Bz
    r_nod = _r_nodal(cfg, Er)
    r_cc = _r_cc(cfg, Er)
    on_axis = geom.prob_lo[0] == 0.0
    nmodes = cfg.n_rz_modes

    # Br (nodal r, cc z): dBr/dt = dEt/dz (m = 0) and the m terms
    dEt = _dz_nod_to_cc(Et, cfg)
    br = Br + dt * dEt * inv_dz
    dEtz = dEt * inv_dz
    if on_axis:
        br[0, 0, :] = 0.0
        for m in range(1, nmodes):
            if m == 1:
                br[2 * m - 1, 0, :] = Br[2 * m - 1, 0, :] + dt * (
                    dEtz[2 * m - 1, 0, :] - m * Ez[2 * m, 1, :] / dr)
                br[2 * m, 0, :] = Br[2 * m, 0, :] + dt * (
                    dEtz[2 * m, 0, :] + m * Ez[2 * m - 1, 1, :] / dr)
            else:
                br[2 * m - 1, 0, :] = 0.0
                br[2 * m, 0, :] = 0.0
    if nmodes > 1:
        # off the axis: the -/+ m Ez / r terms
        s = 1 if on_axis else 0
        rr = r_nod[s:, None]
        for m in range(1, nmodes):
            br[2 * m - 1, s:, :] += dt * (-m) * Ez[2 * m, s:, :] / rr
            br[2 * m, s:, :] += dt * m * Ez[2 * m - 1, s:, :] / rr

    # Bt (cc r, cc z): dBt/dt = dEz/dr - dEr/dz
    bt = Bt + dt * ((Ez[:, 1:, :] - Ez[:, :-1, :]) * inv_dr
                    - _dz_nod_to_cc(Er, cfg) * inv_dz)

    # Bz (cc r, nodal z): dBz/dt = -(1/r) d(r Et)/dr and the m Er / r terms
    rEt = r_nod[None, :, None] * Et
    bz = Bz + dt * (-(rEt[:, 1:, :] - rEt[:, :-1, :]) * inv_dr
                    / r_cc[None, :, None])
    for m in range(1, nmodes):
        bz[2 * m - 1] += dt * m * Er[2 * m] / r_cc[:, None]
        bz[2 * m] += dt * (-m) * Er[2 * m - 1] / r_cc[:, None]
    return fields.replace(Bx=br, By=bt, Bz=bz)


def evolve_e_rz(fields: FieldState, cfg, dt, F=None) -> FieldState:
    """EvolveECylindrical (EvolveE.cpp), mode 0 and the higher modes (JAX
    core.py:903-978)."""
    geom = cfg.geometry
    dr, dz = geom.dx
    inv_dr, inv_dz = 1.0 / dr, 1.0 / dz
    c2 = _c * _c
    Er, Et, Ez = fields.Ex, fields.Ey, fields.Ez
    Br, Bt, Bz = fields.Bx, fields.By, fields.Bz
    jr, jt, jz = fields.jx, fields.jy, fields.jz
    r_nod = _r_nodal(cfg, Er)
    r_cc = _r_cc(cfg, Er)
    on_axis = geom.prob_lo[0] == 0.0
    nmodes = cfg.n_rz_modes

    # Er (cc r, nodal z): dEr/dt = c^2 (-dBt/dz - mu0 jr) and m Bz / r
    er = Er + c2 * dt * (-_dz_cc_to_nod(Bt, "Bt", cfg) * inv_dz - _mu0 * jr)
    for m in range(1, nmodes):
        er[2 * m - 1] += c2 * dt * m * Bz[2 * m] / r_cc[:, None]
        er[2 * m] += c2 * dt * (-m) * Bz[2 * m - 1] / r_cc[:, None]

    # Et (nodal r, nodal z): dEt/dt = c^2 (-dBz/dr + dBr/dz - mu0 jt); the
    # axis row and row nr read zero guards
    zero_r = torch.zeros_like(Bz[:, :1, :])
    bz_ext = torch.cat([zero_r, Bz, zero_r], dim=1)
    dBz_dr = (bz_ext[:, 1:, :] - bz_ext[:, :-1, :]) * inv_dr
    et = Et + c2 * dt * (-dBz_dr + _dz_cc_to_nod(Br, "Br", cfg) * inv_dz
                         - _mu0 * jt)
    if on_axis:
        et[0, 0, :] = 0.0
        for m in range(1, nmodes):
            if m == 1:
                et[2 * m - 1, 0, :] = er[2 * m, 0, :]
                et[2 * m, 0, :] = -er[2 * m - 1, 0, :]
            else:
                et[2 * m - 1, 0, :] = 0.0
                et[2 * m, 0, :] = 0.0

    # Ez (nodal r, cc z): dEz/dt = c^2 ((1/r) d(r Bt)/dr - mu0 jz)
    rBt = r_cc[None, :, None] * Bt
    zero_t = torch.zeros_like(rBt[:, :1, :])
    rbt_ext = torch.cat([zero_t, rBt, zero_t], dim=1)
    dr_rbt = (rbt_ext[:, 1:, :] - rbt_ext[:, :-1, :]) * inv_dr
    r_div = torch.where(r_nod == 0.0, torch.ones_like(r_nod), r_nod
                        )[None, :, None]
    ez = Ez + c2 * dt * (dr_rbt / r_div - _mu0 * jz)
    if on_axis:
        # the axis rule: dEz/dt = c^2 (4 Bt[0] / dr - mu0 jz)
        ez[0, 0, :] = Ez[0, 0, :] + c2 * dt * (4.0 * Bt[0, 0, :] / dr
                                               - _mu0 * jz[0, 0, :])
        for m in range(1, nmodes):
            ez[2 * m - 1, 0, :] = 0.0
            ez[2 * m, 0, :] = 0.0
        # the higher modes' -/+ m Br / r terms off the axis
        rr = r_nod[1:, None]
        for m in range(1, nmodes):
            ez[2 * m - 1, 1:, :] += c2 * dt * (-m) * Br[2 * m, 1:, :] / rr
            ez[2 * m, 1:, :] += c2 * dt * m * Br[2 * m - 1, 1:, :] / rr

    if F is not None:
        # E += c^2 dt grad F (EvolveE.cpp's F block)
        er = er + c2 * dt * (F[:, 1:, :] - F[:, :-1, :]) * inv_dr
        ez = ez + c2 * dt * _dz_nod_to_cc(F, cfg) * inv_dz
        rr = torch.where(r_nod == 0.0, torch.ones_like(r_nod), r_nod
                         )[:, None]
        for m in range(1, nmodes):
            et[2 * m - 1] += c2 * dt * m * F[2 * m] / rr
            et[2 * m] += c2 * dt * (-m) * F[2 * m - 1] / rr
    return fields.replace(Ex=er, Ey=et, Ez=ez)


def apply_silver_mueller_rz(fields: FieldState, cfg, dt) -> FieldState:
    """The first-order absorbing (Silver-Mueller) recurrence on the guard
    B rings (ApplySilverMuellerBoundary.cpp RZ branch :57-175), once a step
    after the first half B push with full-dt coefficients
    (WarpXFieldBoundaries.cpp:133-146); the r-guard Er terms of the
    reference vanish identically (JAX core.py:981-1020)."""
    sm_zlo, sm_zhi, sm_rhi = _sm_bcs(cfg)
    smg = dict(fields.smg)
    dr, dz = cfg.geometry.dx
    cdt_dz = _c * dt / dz
    c1z = (1.0 - cdt_dz) / (1.0 + cdt_dz)
    c2z = 2.0 * cdt_dz / (1.0 + cdt_dz) / _c
    Er, Et, Ez = fields.Ex, fields.Ey, fields.Ez
    if sm_zhi:
        smg["br_zhi"] = c1z * smg["br_zhi"] - c2z * Et[:, :, -1]
        smg["bt_zhi"] = c1z * smg["bt_zhi"] + c2z * Er[:, :, -1]
    if sm_zlo:
        smg["br_zlo"] = c1z * smg["br_zlo"] + c2z * Et[:, :, 0]
        smg["bt_zlo"] = c1z * smg["bt_zlo"] - c2z * Er[:, :, 0]
    if sm_rhi:
        cdt_dr = _c * dt / dr
        c1r = (1.0 - cdt_dr) / (1.0 + cdt_dr)
        c2r = 2.0 * cdt_dr / (1.0 + cdt_dr) / _c
        c3r = _c * dt / (1.0 + cdt_dr) / _c
        nr = cfg.geometry.n_cell[0]
        r_g = cfg.geometry.prob_lo[0] + (nr + 0.5) * dr
        smg["bt_rhi"] = c1r * smg["bt_rhi"] - c2r * Ez[:, -1, :]
        smg["bz_rhi"] = c1r * smg["bz_rhi"] + (c2r - c3r / r_g) * Et[:, -1, :]
    return fields.replace(smg=smg)


def _sm_wall_e_fix(fields: FieldState, cfg, dt) -> FieldState:
    """The guard-B contributions that ``evolve_e_rz``'s zero-guard wall
    stencils dropped, read from ``fields.smg``, then the on-axis Et rules
    again on the wall columns (JAX core.py:1023-1061)."""
    sm_zlo, sm_zhi, sm_rhi = _sm_bcs(cfg)
    smg = fields.smg
    dr, dz = cfg.geometry.dx
    c2dt = _c * _c * dt
    er, et, ez = fields.Ex.clone(), fields.Ey.clone(), fields.Ez.clone()
    if sm_zlo:
        er[:, :, 0] += c2dt / dz * smg["bt_zlo"]
        et[:, :, 0] += -c2dt / dz * smg["br_zlo"]
    if sm_zhi:
        er[:, :, -1] += -c2dt / dz * smg["bt_zhi"]
        et[:, :, -1] += c2dt / dz * smg["br_zhi"]
    if sm_rhi:
        nr = cfg.geometry.n_cell[0]
        r_g = cfg.geometry.prob_lo[0] + (nr + 0.5) * dr
        r_w = _r_nodal(cfg, er)[-1]
        et[:, -1, :] += -c2dt / dr * smg["bz_rhi"]
        ez[:, -1, :] += c2dt / dr * r_g * smg["bt_rhi"] / r_w
    if cfg.geometry.prob_lo[0] == 0.0:
        cols = ([0] if sm_zlo else []) + ([-1] if sm_zhi else [])
        for zi in cols:
            et[0, 0, zi] = 0.0
            for m in range(1, cfg.n_rz_modes):
                if m == 1:
                    et[2 * m - 1, 0, zi] = er[2 * m, 0, zi]
                    et[2 * m, 0, zi] = -er[2 * m - 1, 0, zi]
                else:
                    et[2 * m - 1, 0, zi] = 0.0
                    et[2 * m, 0, zi] = 0.0
    return fields.replace(Ex=er, Ey=et, Ez=ez)


def evolve_f_rz(F, fields: FieldState, rho, cfg, dt):
    """EvolveFCylindrical: dF/dt = div E - rho / eps0 with the 1/r terms
    (JAX core.py:1064-1092)."""
    geom = cfg.geometry
    dr, dz = geom.dx
    inv_dr, inv_dz = 1.0 / dr, 1.0 / dz
    Er, Ez = fields.Ex, fields.Ez
    r_nod = _r_nodal(cfg, Er)
    r_cc = _r_cc(cfg, Er)
    on_axis = geom.prob_lo[0] == 0.0
    rEr = r_cc[None, :, None] * Er
    zero = torch.zeros_like(rEr[:, :1, :])
    rer_ext = torch.cat([zero, rEr, zero], dim=1)
    dr_rer = (rer_ext[:, 1:, :] - rer_ext[:, :-1, :]) * inv_dr
    r_div = torch.where(r_nod == 0.0, torch.ones_like(r_nod), r_nod
                        )[None, :, None]
    dEz = _dz_cc_to_nod(Ez, "Ez", cfg) * inv_dz
    newF = F + dt * (-rho / _ep0 + dr_rer / r_div + dEz)
    if on_axis:
        newF[0, 0, :] = F[0, 0, :] + dt * (
            -rho[0, 0, :] / _ep0 + 4.0 * Er[0, 0, :] / dr + dEz[0, 0, :])
        for m in range(1, cfg.n_rz_modes):
            newF[2 * m - 1, 0, :] = 0.0
            newF[2 * m, 0, :] = 0.0
    return newF


def enforce_walls_rz(fields: FieldState, cfg) -> FieldState:
    """Zero tangential E and normal B on the PEC faces (WarpX_PEC.cpp:
    118-340): z walls Er, Et, Bz; the r = rmax wall Et, Ez, Br."""
    per, bc_lo, bc_hi = _z_bcs(cfg)
    Er, Et, Ez = fields.Ex, fields.Ey, fields.Ez
    Br, Bt, Bz = fields.Bx, fields.By, fields.Bz
    bc_r_hi = (tuple(cfg.field_bc_hi or ()) + ("none", "periodic"))[0]
    z_walls = [i for i, bc in ((0, bc_lo), (-1, bc_hi))
               if not per and bc == "pec"]
    if z_walls:
        Er, Et, Bz = Er.clone(), Et.clone(), Bz.clone()
        for i in z_walls:
            Er[..., i] = 0.0
            Et[..., i] = 0.0
            Bz[..., i] = 0.0
    if bc_r_hi == "pec":
        Et, Ez, Br = Et.clone(), Ez.clone(), Br.clone()
        Et[:, -1, :] = 0.0
        Ez[:, -1, :] = 0.0
        Br[:, -1, :] = 0.0
    return fields.replace(Ex=Er, Ey=Et, Ez=Ez, Bx=Br, By=Bt, Bz=Bz)


# -------------------------------------------------------------------- step
def _shift_z(arr, num_shift):
    """``arr`` moved ``num_shift`` cells down z, zeros entering at the top
    (the JAX package's roll-and-zero, core.py:1220-1224)."""
    if num_shift == 0:
        return arr
    out = torch.zeros_like(arr)
    n = arr.shape[-1]
    if num_shift < n:
        out[..., :n - num_shift] = arr[..., num_shift:]
    return out


class RZStepper:
    """The RZ explicit EM loop (the JAX package's ``make_rz_step_fns``,
    core.py:1124-1554): bounded z with PEC, none or Silver-Mueller faces,
    the moving window along z with continuous injection (the fields shift
    by whole cells, the z origin rides in ``aux['window_lo']``), laser
    antennas, the staircase embedded boundary and F cleaning.  ``step``
    ends with the window's move; ``half_push`` is the leapfrog's momentum
    half push."""

    def __init__(self, cfg, dtype, device):
        geom = cfg.geometry
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self._f = torch.empty((), dtype=dtype).numpy().dtype.type
        self.dt = cfg.dt
        self.order = cfg.particle_shape
        self.ng = self.order + 2
        self.per_z = geom.periodic[1]
        self.lasers = {las.name: las for las in cfg.lasers}
        self.is_laser = {sp.name: sp.injection_style == "laser"
                         for sp in cfg.species}
        self.zext = geom.prob_hi[1] - geom.prob_lo[1]
        self.max_shift = (
            int(math.ceil(abs(cfg.moving_window_v) * _c * self.dt
                          / geom.dx[1])) + 1
            if cfg.do_moving_window else 0)
        self.any_sm = any(_sm_bcs(cfg))
        self.eb_masks = None
        if cfg.eb_implicit_function:
            self.eb_masks = self._eb_masks()

    def _eb_masks(self):
        """The staircase embedded boundary's masks (JAX core.py:1147-1200):
        a component stays frozen at zero where its whole edge (E) or face
        (B) is covered; the implicit function is sampled at each
        component's staggered (r, z) points with x = r, y = 0 (phi > 0
        covered), on the host."""
        cfg = self.cfg
        geom = cfg.geometry
        if cfg.do_moving_window:
            raise NotImplementedError("RZ embedded boundary with a moving "
                                      "window")
        if any(not self.is_laser[sp.name] for sp in cfg.species):
            raise NotImplementedError(
                "RZ embedded boundary with particles (EB scraping is "
                "implemented on the Cartesian bounded path only)")
        dr, dz = geom.dx
        fn = compile_expression(cfg.eb_implicit_function, ("x", "y", "z"),
                                dict(cfg.user_constants or ()))
        nr = geom.n_cell[0]
        r_nodv = geom.prob_lo[0] + np.arange(nr + 1) * dr
        r_ccv = geom.prob_lo[0] + (np.arange(nr) + 0.5) * dr
        extent = {"Er": ("r",), "Et": (), "Ez": ("z",),
                  "Br": ("z",), "Bt": ("r", "z"), "Bz": ("r",)}
        masks = {}
        for nm, attr in _ATTR.items():
            fr, fz = rz_stagger(cfg, nm)
            rc = r_nodv if fr else r_ccv
            shp = field_shape(cfg, nm)
            zc = geom.prob_lo[1] + (np.arange(shp[2]) + (0.0 if fz else 0.5)
                                    ) * dz
            rr, zz = np.meshgrid(rc, zc, indexing="ij")
            dr_off = (-0.5 * dr, 0.0, 0.5 * dr) if "r" in extent[nm] \
                else (0.0,)
            dz_off = (-0.5 * dz, 0.0, 0.5 * dz) if "z" in extent[nm] \
                else (0.0,)
            phi_min = None
            for ro in dr_off:
                for zo in dz_off:
                    p = fn(rr + ro, np.zeros_like(rr), zz + zo).numpy()
                    phi_min = p if phi_min is None else np.minimum(phi_min, p)
            masks[attr] = torch.from_numpy(
                (phi_min <= 0.0)[None, :, :]).to(device=self.device,
                                                 dtype=self.dtype)
        return masks

    def apply_eb(self, fields):
        return fields.replace(**{attr: getattr(fields, attr) * m
                                 for attr, m in self.eb_masks.items()})

    def z_origin_of(self, state):
        if self.cfg.do_moving_window:
            return state.aux["window_lo"]
        return None

    def gather_all(self, state, pos3, z0):
        farr = {nm: getattr(state.fields, attr)
                for nm, attr in _ATTR.items()}
        return gather_rz(pos3, farr, self.cfg, self.order, self.ng,
                         z_origin=z0)

    # ------------------------------------------------------------- window
    def continuous_injection(self, state, sp_cfg, sp, window_lo, draws):
        """Plasma into the newly uncovered whole cells at the window's top
        (JAX core.py:1226-1361): the top K columns' lattice, random per-cell
        theta offsets from ``draws`` folded with the step and
        hash(name + ':theta'), Gaussian momenta from ':u', into the first
        free slots (what finds no slot is dropped, as in the JAX
        package)."""
        cfg = self.cfg
        geom = cfg.geometry
        f = self._f
        dtype = self.dtype
        kw = dict(dtype=dtype, device=self.device)
        nr, nz = geom.n_cell
        dr, dz = geom.dx
        key = f"inject_pos:{sp_cfg.name}"
        cur_pos = state.aux[key]
        window_hi = f(window_lo + f(self.zext))
        # a whole number of cells for an at-rest plasma; the nudge keeps
        # float accumulation from dropping the newest column for a step
        new_pos = f(cur_pos + f(np.floor(f(f(window_hi - cur_pos) / f(dz))
                                         + f(1e-9)) * f(dz)))

        ppc = sp_cfg.num_particles_per_cell_each_dim or (1, 1, 1)
        n_r, n_t, n_z = (tuple(ppc) + (1, 1, 1))[:3]
        ppc_tot = n_r * n_t * n_z
        K = max(2 * self.max_shift, 4)
        col = torch.arange(nz - K, nz, **kw)
        zcol = float(window_lo) + col * dz
        # the lattice's integer coordinates, exact in the run's type
        ir, icol, a, t, b = torch.meshgrid(
            *(torch.arange(n, **kw) for n in (nr, K, n_r, n_t, n_z)),
            indexing="ij")
        r = geom.prob_lo[0] + (ir + (a + 0.5) / n_r) * dr
        z = zcol[icol.to(torch.int64)] + ((b + 0.5) / n_z) * dz
        theta = 2.0 * math.pi * (t + 0.5) / n_t
        if sp_cfg.random_theta:
            off = draws.fold_in(state.step).fold_in(
                abs(hash(sp_cfg.name + ":theta")) % (2 ** 31)).uniform(
                    (nr, K, 1, 1, 1), dtype, 0.0, 2.0 * math.pi)
            theta = theta + off
        theta = torch.broadcast_to(theta, r.shape)
        npart = nr * K * ppc_tot
        r, z, theta = (q.reshape(npart) for q in (r, z, theta))
        x = r * torch.cos(theta)
        y = r * torch.sin(theta)

        sel = (z > float(cur_pos)) & (z < float(new_pos))
        lo = sp_cfg.bounds_lo or (-np.inf, -np.inf)
        hi = sp_cfg.bounds_hi or (np.inf, np.inf)
        sel &= (r >= lo[0]) & (r <= hi[0]) & (z >= lo[1]) & (z <= hi[1])
        if sp_cfg.profile == "constant":
            dens = torch.full((npart,), sp_cfg.density, **kw)
        else:
            dens = compile_expression(
                sp_cfg.density_expr, ["x", "y", "z"],
                dict(sp_cfg.user_constants))(x, y, z).to(dtype)
        w_new = torch.where(sel, dens * (dr * dz / ppc_tot) * 2.0 * math.pi
                            * r, torch.zeros_like(r))
        sel &= w_new > 0

        md = sp_cfg.momentum_distribution
        if md in ("at_rest", "none"):
            u_new = [torch.zeros(npart, **kw)] * 3
        elif md == "constant":
            u_new = [torch.full((npart,), v * _c, **kw)
                     for v in (sp_cfg.ux, sp_cfg.uy, sp_cfg.uz)]
        elif md == "gaussian":
            ks = draws.fold_in(state.step).fold_in(
                abs(hash(sp_cfg.name + ":u")) % (2 ** 31)).split(3)
            u_new = [(mu + (th or 0.0) * k.normal((npart,), dtype)) * _c
                     for mu, th, k in zip(
                         (sp_cfg.ux, sp_cfg.uy, sp_cfg.uz),
                         (sp_cfg.ux_th, sp_cfg.uy_th, sp_cfg.uz_th), ks)]
        else:
            raise NotImplementedError(f"RZ continuous injection with {md}")

        # the raw injection theta, as at the initial injection
        extra_new = {"theta": theta}
        if sp_cfg.attributes:
            extra_new.update(attribute_values(
                sp_cfg, (x, y, z), *u_new, float(state.time), dtype))

        src = torch.nonzero(sel).reshape(-1)
        free = torch.nonzero(~sp.alive).reshape(-1)
        n_put = min(src.numel(), free.numel())
        src, tgt = src[:n_put], free[:n_put]

        def put(arr, vals):
            out = arr.clone()
            out[tgt] = vals[src].to(arr.dtype)
            return out

        alive = sp.alive.clone()
        alive[tgt] = True
        sp = sp.replace(w=put(sp.w, w_new), ux=put(sp.ux, u_new[0]),
                        uy=put(sp.uy, u_new[1]), uz=put(sp.uz, u_new[2]),
                        alive=alive, x=put(sp.x, x), y=put(sp.y, y),
                        z=put(sp.z, z))
        extra = dict(sp.extra)
        for aname, vals in extra_new.items():
            if aname in extra:
                extra[aname] = put(extra[aname], vals)
        sp = sp.replace(extra=extra)
        aux = dict(state.aux)
        aux[key] = new_pos
        return state.replace(aux=aux), sp

    def step_window(self, state: SimState, draws=None) -> SimState:
        """The window's move after a step (JAX core.py:1363-1408): the
        fields, F and the r-wall guard rings shift by whole cells, the
        z-wall rings reset on a shift, then continuous injection."""
        cfg = self.cfg
        if not cfg.do_moving_window:
            return state
        f = self._f
        dz = f(cfg.geometry.dx[1])
        aux = dict(state.aux)
        window_x = f(aux["window_x"] + f(cfg.moving_window_v * _c * self.dt))
        num_shift = int(np.floor(f(f(window_x - aux["window_lo"]) / dz)))
        num_shift = min(max(num_shift, 0), self.max_shift)
        aux["window_x"] = window_x
        aux["window_lo"] = f(aux["window_lo"] + f(f(num_shift) * dz))

        fl = state.fields
        upd = {nm: _shift_z(getattr(fl, nm), num_shift)
               for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")}
        if fl.F is not None:
            upd["F"] = _shift_z(fl.F, num_shift)
        if fl.smg is not None:
            # the z-resolved r-wall rings ride the window; the z-wall rings
            # beyond the shifted wall reset to the vacuum on a shift
            smg = dict(fl.smg)
            for k in ("bt_rhi", "bz_rhi"):
                if k in smg:
                    smg[k] = _shift_z(smg[k], num_shift)
            if num_shift > 0:
                for k in ("br_zlo", "bt_zlo", "br_zhi", "bt_zhi"):
                    if k in smg:
                        smg[k] = torch.zeros_like(smg[k])
            upd["smg"] = smg
        state = state.replace(fields=fl.replace(**upd), aux=aux)

        new_species = dict(state.species)
        for sp_cfg in cfg.species:
            if not sp_cfg.do_continuous_injection or \
                    self.is_laser[sp_cfg.name]:
                continue
            state, sp = self.continuous_injection(
                state, sp_cfg, new_species[sp_cfg.name],
                state.aux["window_lo"], draws)
            new_species[sp_cfg.name] = sp
        return state.replace(species=new_species)

    # --------------------------------------------------------------- step
    def step(self, state: SimState, draws=None) -> SimState:
        """One step in the JAX package's order (core.py:1410-1535): rho
        old, the antenna or gather and push, the z wrap or wall loss, the
        r > rmax loss, J, rho new, the filter, F/B/E/F/B with
        Silver-Mueller and the embedded boundary, the walls, the window."""
        cfg = self.cfg
        geom = cfg.geometry
        dt, order, ng, dtype = self.dt, self.order, self.ng, self.dtype
        kw = dict(dtype=dtype, device=self.device)
        z0 = self.z_origin_of(state)
        zlo = float(z0) if z0 is not None else geom.prob_lo[1]
        zhi = zlo + self.zext
        need_rho = cfg.do_dive_cleaning
        rho_old = rho_new = None
        if need_rho:
            rho_old = torch.zeros(field_shape(cfg, "rho"), **kw)
            rho_new = torch.zeros(field_shape(cfg, "rho"), **kw)
        z0f = None if z0 is None else float(z0)
        j3 = None
        new_species = {}
        for sp_cfg in cfg.species:
            sp = state.species[sp_cfg.name]
            pos3 = (sp.x, sp.y, sp.z)
            laser = self.is_laser[sp_cfg.name]
            if need_rho and not sp_cfg.do_not_deposit and not laser:
                w_eff = torch.where(sp.alive, sp.w, torch.zeros_like(sp.w))
                rho_old = rho_old + deposit_rho_rz(
                    pos3, w_eff, sp_cfg.charge, cfg, order, ng, dtype,
                    z_origin=z0f)
            if laser:
                las = self.lasers[sp_cfg.name]
                sp_new = update_antenna_rz(sp, las, 0.05 / las.e_max,
                                           state.time, dt)
                ux, uy, uz = sp_new.ux, sp_new.uy, sp_new.uz
                xn, yn, zn = sp_new.x, sp_new.y, sp_new.z
            else:
                e6 = self.gather_all(state, pos3, z0f)
                ux, uy, uz = PUSHERS[sp_cfg.pusher](
                    sp.ux, sp.uy, sp.uz, *e6, sp_cfg.charge, sp_cfg.mass, dt)
                del e6
                gi = 1.0 / torch.sqrt(
                    1.0 + (ux * ux + uy * uy + uz * uz) / (_c * _c))
                xn = sp.x + ux * gi * dt
                yn = sp.y + uy * gi * dt
                zn = sp.z + uz * gi * dt
                del gi
            if self.per_z:
                zn = zlo + torch.remainder(zn - zlo, self.zext)
                in_z = None
            else:
                in_z = (zn > zlo) & (zn < zhi)
            rnew = torch.sqrt(xn * xn + yn * yn)
            alive = sp.alive & (rnew < geom.prob_hi[0])
            if in_z is not None:
                alive = alive & in_z
            del rnew
            zero = torch.zeros_like(sp.w)
            if not sp_cfg.do_not_deposit:
                w_dep = torch.where(sp.alive, sp.w, zero)
                jr, jt, jz = deposit_current_rz(
                    (xn, yn, zn), ux, uy, uz, w_dep, sp_cfg.charge, cfg, dt,
                    order, ng, dtype, z_origin=z0f)
                j3 = (jr, jt, jz) if j3 is None else (
                    j3[0] + jr, j3[1] + jt, j3[2] + jz)
            if need_rho and not sp_cfg.do_not_deposit and not laser:
                w_al = torch.where(alive, sp.w, zero)
                rho_new = rho_new + deposit_rho_rz(
                    (xn, yn, zn), w_al, sp_cfg.charge, cfg, order, ng,
                    dtype, z_origin=z0f)
            sp_out = sp.replace(x=xn, y=yn, z=zn, ux=ux, uy=uy, uz=uz,
                                alive=alive,
                                w=torch.where(alive, sp.w, zero))
            if "theta" in sp.extra:
                # SetParticlePosition stores theta = atan2(y, x) after every
                # push (GetAndSetPosition.H:213)
                sp_out = sp_out.replace(extra={
                    **sp_out.extra,
                    "theta": torch.where(sp.alive, torch.atan2(yn, xn),
                                         sp.extra["theta"])})
            new_species[sp_cfg.name] = sp_out
        if j3 is None:
            j3 = tuple(torch.zeros(field_shape(cfg, nm), **kw)
                       for nm in ("jr", "jt", "jz"))
        if cfg.use_filter:
            from .spectral import bilinear_filter_rz

            npe = tuple(cfg.filter_npass_each_dir or (1, 1))
            j3 = tuple(bilinear_filter_rz(a, nm, cfg, npass_each=npe)
                       for a, nm in zip(j3, ("jr", "jt", "jz")))
            if need_rho:
                rho_old = bilinear_filter_rz(rho_old, "rho", cfg,
                                             npass_each=npe)
                rho_new = bilinear_filter_rz(rho_new, "rho", cfg,
                                             npass_each=npe)
        fields = state.fields.replace(jx=j3[0], jy=j3[1], jz=j3[2])
        F = fields.F
        if need_rho:
            F = evolve_f_rz(F, fields, rho_old, cfg, 0.5 * dt)
        fields = evolve_b_rz(fields, cfg, 0.5 * dt)
        if self.eb_masks is not None:
            fields = self.apply_eb(fields)
        if self.any_sm:
            # the guard-B recurrence once a step, full-dt coefficients
            fields = apply_silver_mueller_rz(fields, cfg, dt)
        fields = evolve_e_rz(fields, cfg, dt, F=F)
        if self.any_sm:
            fields = _sm_wall_e_fix(fields, cfg, dt)
        if self.eb_masks is not None:
            fields = self.apply_eb(fields)
        if need_rho:
            F = evolve_f_rz(F, fields, rho_new, cfg, 0.5 * dt)
        fields = evolve_b_rz(fields, cfg, 0.5 * dt)
        if self.eb_masks is not None:
            fields = self.apply_eb(fields)
        fields = fields.replace(F=F)
        if not self.per_z:
            fields = enforce_walls_rz(fields, cfg)
        state = state.replace(fields=fields, species=new_species,
                              step=state.step + 1, time=state.time + dt)
        return self.step_window(state, draws)

    def half_push(self, state: SimState, dt_half) -> SimState:
        """The momenta pushed by ``dt_half`` in the current fields (not the
        antennas nor a massless species)."""
        cfg = self.cfg
        z0 = self.z_origin_of(state)
        z0f = None if z0 is None else float(z0)
        new_species = {}
        for sp_cfg in cfg.species:
            sp = state.species[sp_cfg.name]
            if self.is_laser[sp_cfg.name] or sp_cfg.mass == 0.0:
                new_species[sp_cfg.name] = sp
                continue
            e6 = self.gather_all(state, (sp.x, sp.y, sp.z), z0f)
            ux, uy, uz = PUSHERS[sp_cfg.pusher](
                sp.ux, sp.uy, sp.uz, *e6, sp_cfg.charge, sp_cfg.mass,
                dt_half)
            new_species[sp_cfg.name] = sp.replace(ux=ux, uy=uy, uz=uz)
        return state.replace(species=new_species)


# ------------------------------------------------------------------- init
def rz_init_state(cfg, dtype, device, rng) -> SimState:
    """The initial RZ state (JAX simulation.py:746-778): the species from
    ``rng`` in the configuration's order (the antennas' spokes for the
    lasers), the injection fronts and the window's scalars in ``aux``."""
    geom = cfg.geometry
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    f = np_dtype.type
    species = {}
    aux = {}
    for sp_cfg in cfg.species:
        if sp_cfg.injection_style == "laser":
            laser = next(las for las in cfg.lasers if las.name == sp_cfg.name)
            cols, _ = rz_antenna_particles(laser, cfg, np_dtype)
        else:
            cols = rz_inject_species(sp_cfg, cfg, np_dtype, rng)
        species[sp_cfg.name] = columns_to_state(cols, device)
        del cols
        if sp_cfg.do_continuous_injection and cfg.do_moving_window:
            aux[f"inject_pos:{sp_cfg.name}"] = f(
                geom.prob_hi[1] if cfg.moving_window_v > 0
                else geom.prob_lo[1])
    if cfg.do_moving_window:
        aux["window_x"] = f(geom.prob_lo[1])
        aux["window_lo"] = f(geom.prob_lo[1])
    return SimState(fields=rz_zero_fields(cfg, dtype, device),
                    species=species, step=0, time=0.0, aux=aux)


# ------------------------------------------------------------- diagnostics
_RZ_MODE_BASE = {"Er": "Er", "Et": "Etheta", "Ez": "Ez",
                 "Br": "Br", "Bt": "Btheta", "Bz": "Bz",
                 "jr": "Jr", "jt": "Jtheta", "jz": "Jz", "rho": "rho"}


def _rz_center(a, name, cfg):
    """A (nr?, nz?) mode slice averaged to the cell centers."""
    fr, fz = rz_stagger(cfg, name)
    if fr == 1:
        a = 0.5 * (a[1:, :] + a[:-1, :])
    if fz == 1:
        if cfg.geometry.periodic[1]:
            a = 0.5 * (a + torch.roll(a, -1, dims=1))
        else:
            a = 0.5 * (a[:, 1:] + a[:, :-1])
    return a


def rz_diag_rho(state: SimState, cfg, ng=None) -> torch.Tensor:
    """The modes of rho deposited from the live species, the antennas
    included (the rho functor; JAX core.py:1576-1616): cell-centered under
    PSATD, nodal under FDTD, filtered as the deposit is."""
    order = cfg.particle_shape
    ng = ng if ng is not None else order + 2
    z0 = state.aux.get("window_lo") if cfg.do_moving_window else None
    z0 = None if z0 is None else float(z0)
    ref = state.fields.Ex
    rho = torch.zeros(field_shape(cfg, "rho"), dtype=ref.dtype,
                      device=ref.device)
    if cfg.em_solver == "psatd":
        from .spectral import deposit_cc_rz

        def _dep(pos3, w_eff, q):
            return deposit_cc_rz(pos3, w_eff, q, cfg, order, ng, rho.dtype,
                                 z_origin=z0)
    else:
        def _dep(pos3, w_eff, q):
            return deposit_rho_rz(pos3, w_eff, q, cfg, order, ng, rho.dtype,
                                  z_origin=z0)
    for sp_cfg in cfg.species:
        if sp_cfg.do_not_deposit:
            continue
        sp = state.species[sp_cfg.name]
        w_eff = torch.where(sp.alive, sp.w, torch.zeros_like(sp.w))
        rho = rho + _dep((sp.x, sp.y, sp.z), w_eff, sp_cfg.charge)
    if cfg.use_filter:
        from .spectral import bilinear_filter_rz

        npass = max(cfg.filter_npass_each_dir or (1,))
        rho = bilinear_filter_rz(rho, "rho", cfg, npass)
    return rho


def rz_cell_centered_output(state: SimState, cfg, solver=None
                            ) -> Dict[str, torch.Tensor]:
    """The cell-centered (nr, nz) fields at theta = 0 (the mode sum), each
    mode's components (Er_0_real, Etheta_1_imag, ...) and the deposited
    rho, the RZ plotfile's layout (JAX core.py:1619-1648); under PSATD also
    rho and div E of ``spectral.rz_spectral_aux_fields`` (``solver``: the
    run's ``PsatdRZ``, built here when None)."""
    out = {}
    f = state.fields
    quans = [("Er", f.Ex), ("Et", f.Ey), ("Ez", f.Ez), ("Br", f.Bx),
             ("Bt", f.By), ("Bz", f.Bz), ("jr", f.jx), ("jt", f.jy),
             ("jz", f.jz), ("rho", rz_diag_rho(state, cfg))]
    for name, arr in quans:
        a = arr[0]
        for m in range(1, cfg.n_rz_modes):
            a = a + arr[2 * m - 1]
        out[name] = _rz_center(a, name, cfg)
        base = _RZ_MODE_BASE[name]
        out[f"{base}_0_real"] = _rz_center(arr[0], name, cfg)
        for m in range(1, cfg.n_rz_modes):
            out[f"{base}_{m}_real"] = _rz_center(arr[2 * m - 1], name, cfg)
            out[f"{base}_{m}_imag"] = _rz_center(arr[2 * m], name, cfg)
    if cfg.em_solver == "psatd":
        from .spectral import rz_spectral_aux_fields

        for name, arr in rz_spectral_aux_fields(state, cfg, solver).items():
            a = arr[0]
            for m in range(1, cfg.n_rz_modes):
                a = a + arr[2 * m - 1]
            out[name] = a
    return out


def rz_checksums(state: SimState, cfg, solver=None
                 ) -> Dict[str, Dict[str, float]]:
    """sum |Q| per quantity in the reference's checksum vocabulary (JAX
    core.py:1651-1682): the plotfile fields, then each species' momenta,
    radius (particle_position_x), z (particle_position_y), theta and
    weight over its live particles."""
    out = {"lev=0": {}}
    for k, v in rz_cell_centered_output(state, cfg, solver).items():
        out["lev=0"][k] = float(torch.sum(torch.abs(v)))
    for sp_cfg in cfg.species:
        if sp_cfg.injection_style == "laser":
            continue
        sp = state.species[sp_cfg.name]
        m = sp_cfg.mass
        alive = sp.alive
        r = torch.sqrt(sp.x ** 2 + sp.y ** 2)
        theta = sp.extra.get("theta")
        if theta is None:
            theta = torch.atan2(sp.y, sp.x)
        qd = {
            "particle_momentum_x": torch.abs(m * sp.ux),
            "particle_momentum_y": torch.abs(m * sp.uy),
            "particle_momentum_z": torch.abs(m * sp.uz),
            "particle_position_x": torch.abs(r),
            "particle_position_y": torch.abs(sp.z),
            "particle_theta": torch.abs(theta),
            "particle_weight": torch.abs(sp.w),
        }
        for aname, arr in sp.extra.items():
            if aname != "theta":
                qd[f"particle_{aname}"] = torch.abs(arr)
        out[sp_cfg.name] = {
            k: float(torch.sum(torch.where(alive, v, torch.zeros_like(v))))
            for k, v in qd.items()}
    return out


# --------------------------------------------------------------- the gate
# the configuration fields the RZ steps read (the JAX package's RZ reader,
# warpx_tpu/core/deck.py:1074-1230, sets no other); any other at a
# non-default value would be dropped
_RZ_SIM_FIELDS = frozenset((
    "geometry", "max_step", "dt", "particle_shape", "em_solver",
    "current_deposition", "field_gathering", "grid_type", "use_filter",
    "filter_npass_each_dir", "species", "cfl", "seed", "deposit_chunk_size",
    "field_bc_lo", "field_bc_hi", "do_moving_window", "moving_window_dir",
    "moving_window_v", "lasers", "eb_implicit_function", "do_dive_cleaning",
    "psatd_order", "psatd_update_with_rho", "psatd_current_correction",
    "psatd_v_galilean", "tiled_particles", "user_constants", "verbose",
    "n_rz_modes",
))
# the species fields the RZ injection and steps read (JAX core.py:200-355,
# 1226-1552)
_RZ_SPECIES_FIELDS = frozenset((
    "name", "charge", "mass", "injection_style",
    "num_particles_per_cell_each_dim", "profile", "density", "density_expr",
    "momentum_distribution", "momentum_exprs", "ux", "uy", "uz", "ux_th",
    "uy_th", "uz_th", "bounds_lo", "bounds_hi", "do_not_deposit", "pusher",
    "do_continuous_injection", "x_rms", "y_rms", "z_rms", "x_m", "y_m",
    "z_m", "npart", "q_tot", "z_cut", "attributes", "species_type",
    "user_constants", "random_theta",
))
_RZ_STYLES = ("nuniformpercell", "gaussian_beam", "laser", "none")


def _defaults(cls):
    """The fields of dataclass ``cls`` that have a default, with it."""
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
    return out


def check_rz_supported(cfg) -> None:
    """Refuse what the JAX package's RZ steps do not run, or run with a
    part dropped (ROADMAP.md Queue C): every configuration and species
    field they never read at a value other than its default, and the values
    they read but run differently: a current deposition other than
    Esirkepov under FDTD (the FDTD step deposits Esirkepov whatever it
    says), momentum-conserving gathering, a collocated or hybrid grid under
    FDTD, a plasma style other than NUniformPerCell (the RZ injection lays
    any other out as one), a Gaussian beam's parsed momenta, an antenna's
    continuous injection, antennas and embedded boundaries under PSATD, and
    the profiles and momenta the RZ injection raises on."""
    from ..core.config import SimConfig, SpeciesConfig

    def no(what):
        raise NotImplementedError(f"RZ geometry: {what} (ROADMAP.md Queue C)")

    for name, dflt in _defaults(SimConfig).items():
        if name not in _RZ_SIM_FIELDS and getattr(cfg, name) != dflt:
            no(f"{name} = {getattr(cfg, name)!r} (the JAX package's RZ "
               "steps never read it)")
    if cfg.tiled_particles == "on":
        no("tiled_particles = on (the JAX package runs RZ per particle)")
    if cfg.n_rz_modes < 1:
        raise ValueError(f"warpx.n_rz_azimuthal_modes = {cfg.n_rz_modes}")
    fdtd = cfg.em_solver != "psatd"
    if cfg.em_solver not in ("yee", "psatd"):
        raise NotImplementedError(f"RZ maxwell solver {cfg.em_solver}")
    if fdtd and cfg.current_deposition != "esirkepov":
        no(f"algo.current_deposition = {cfg.current_deposition} under FDTD "
           "(the JAX package's RZ FDTD step deposits Esirkepov whatever it "
           "says)")
    if cfg.field_gathering != "energy-conserving":
        no(f"algo.field_gathering = {cfg.field_gathering} (the JAX "
           "package's RZ gather interpolates the staggered fields)")
    if fdtd and cfg.grid_type != "staggered":
        no(f"warpx.grid_type = {cfg.grid_type} under FDTD (the JAX "
           "package's cylindrical Yee step runs the staggered grid)")
    if not fdtd:
        if cfg.lasers:
            no("laser antennas under RZ PSATD (the JAX package's spectral "
               "step pushes an antenna as a massless particle)")
        if cfg.eb_implicit_function:
            no("an embedded boundary under RZ PSATD (the JAX package's "
               "spectral step has none)")
    sp_defaults = _defaults(SpeciesConfig)
    for sp in cfg.species:
        for name, dflt in sp_defaults.items():
            if name not in _RZ_SPECIES_FIELDS and getattr(sp, name) != dflt:
                no(f"species {sp.name!r}: {name} = {getattr(sp, name)!r} "
                   "(the JAX package's RZ steps never read it)")
        style = sp.injection_style
        if style not in _RZ_STYLES:
            no(f"species {sp.name!r}: injection_style = {style} (the JAX "
               "package's RZ injection lays it out as NUniformPerCell)")
        if style == "laser":
            continue
        if style == "gaussian_beam":
            if sp.momentum_distribution not in ("at_rest", "none",
                                                "constant", "gaussian"):
                no(f"species {sp.name!r}: a Gaussian beam with "
                   f"{sp.momentum_distribution} momenta (the JAX package's "
                   "RZ beam starts them at rest)")
            continue
        if sp.profile not in ("constant", "parse", "parse_density_function"):
            raise NotImplementedError(f"RZ density profile {sp.profile}")
        md = sp.momentum_distribution
        if md not in ("at_rest", "none", "constant", "gaussian",
                      "parse_momentum_function"):
            raise NotImplementedError(f"RZ momentum distribution {md}")
        if (sp.do_continuous_injection and cfg.do_moving_window
                and md == "parse_momentum_function"):
            raise NotImplementedError(f"RZ continuous injection with {md}")
    for las in cfg.lasers:
        if las.do_continuous_injection:
            no(f"laser {las.name!r}: do_continuous_injection (the JAX "
               "package's RZ antenna stays where it starts)")
