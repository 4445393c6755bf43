"""Laser antenna: profile evaluation and antenna-particle update.

The counterpart of ``warpx_tpu.core.laser`` for the Gaussian profile and
the lasy file (``profile = from_file``, ``core/laser_file.py``), in the lab
frame and in a Lorentz-boosted one: the antenna's layout is made on the
host in numpy, its update runs on tensors.

The reference injects lasers through an antenna of macro-particles on a plane
whose prescribed oscillation deposits the source current
(Source/Particles/LaserParticleContainer.cpp: InitData antenna layout,
ComputeWeightMobility:760-777 weight = ep0/mobility, mobility = 0.05/e_max;
update_laser_particle: v = -sign(w) * mobility * amplitude * c along the
polarization; Source/Laser/LaserProfilesImpl/LaserProfileGaussian.cpp
fill_amplitude for the Gaussian envelope with Gouy phase / diffraction).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .. import constants
from .config import LaserConfig
from .grid import Geometry
from .state import ParticleState

__all__ = [
    "gaussian_amplitude",
    "gaussian_field",
    "fill_amplitude",
    "antenna_particles",
    "update_antenna",
    "antenna_unit_vectors",
    "polarization_p_x",
    "boost_laser_position",
]


def antenna_unit_vectors(laser: LaserConfig, ndim: int = 3):
    """Plane-lattice vectors (u_X, u_Y), mirroring LaserParticleContainer
    :205-218: 3D uses the projected polarization p_X and n x p_X; 2D (XZ)
    uses the in-plane y-hat x n and y-hat; 1D uses x-hat/y-hat.  The antenna
    VELOCITY is always along p_X (use polarization_p_x for that)."""
    nvec = np.array(laser.direction, dtype=float)
    nvec = nvec / np.linalg.norm(nvec)
    if ndim == 3:
        u_X = polarization_p_x(laser)
        u_Y = np.cross(nvec, u_X)
    elif ndim == 2:
        u_X = np.cross(np.array([0.0, 1.0, 0.0]), nvec)
        u_X /= np.linalg.norm(u_X)
        u_Y = np.array([0.0, 1.0, 0.0])
    else:
        u_X = np.array([1.0, 0.0, 0.0])
        u_Y = np.array([0.0, 1.0, 0.0])
    return nvec, u_X, u_Y


def polarization_p_x(laser: LaserConfig):
    """The projected, normalized polarization p_X (the antenna velocity
    direction, LaserParticleContainer:904-906)."""
    nvec = np.array(laser.direction, dtype=float)
    nvec = nvec / np.linalg.norm(nvec)
    p = np.array(laser.polarization, dtype=float)
    p = p / np.linalg.norm(p)
    u_X = p - np.dot(p, nvec) * nvec
    u_X /= np.linalg.norm(u_X)
    return u_X


def gaussian_amplitude(laser: LaserConfig, Xp, Yp, t):
    """E-field amplitude at laser-plane coordinates (Xp, Yp) at time t.

    1:1 with GaussianLaserProfile::fill_amplitude (zeta/beta/phi2 STC terms
    included; ndim-dependent Gouy prefactor handled by the caller's ndim).
    """
    k0 = 2.0 * math.pi / laser.wavelength
    inv_tau2 = 1.0 / (laser.profile_duration**2)
    osc = k0 * constants.c * (t - laser.profile_t_peak) + laser.phi0
    diffract = 1.0 + 1j * laser.profile_focal_distance * 2.0 / (
        k0 * laser.profile_waist**2
    )
    inv_cw2 = 1.0 / (laser.profile_waist**2 * diffract)
    stretch = (
        1.0
        + 4.0
        * (laser.zeta + laser.beta * laser.profile_focal_distance * inv_tau2)
        * (laser.zeta + laser.beta * laser.profile_focal_distance * inv_cw2)
        + 2j * (laser.phi2 - laser.beta**2 * k0 * laser.profile_focal_distance) * inv_tau2
    )
    return k0, inv_tau2, osc, diffract, inv_cw2, stretch


def fill_amplitude(laser: LaserConfig, ndim: int, Xp, Yp, t):
    """Amplitude at the antenna particles' plane coordinates ``Xp``, ``Yp``
    (tensors) at the host time ``t``: the Gaussian profile's, or the lasy
    file's at t_env = t + t_min - delay (LaserProfileFromFile.cpp)."""
    if laser.profile == "from_file":
        from .laser_file import lasy_amplitude, load_lasy

        ld = load_lasy(laser.lasy_file_name)
        return lasy_amplitude(ld, laser, Xp, Yp,
                              float(t) + ld.t_min - laser.delay)
    if laser.profile != "gaussian":
        raise NotImplementedError(
            f"laser profile {laser.profile!r} (the JAX package refuses it "
            "too; ROADMAP.md Queue C)")
    return gaussian_field(laser, ndim, Xp, Yp, t).real


def gaussian_field(laser: LaserConfig, ndim: int, Xp, Yp, t):
    """The Gaussian profile's complex field, whose real part is the
    amplitude (GaussianLaserProfile::fill_amplitude); the factors that
    depend on ``t`` alone are host complex numbers."""
    t = float(t)
    k0, inv_tau2, osc, diffract, inv_cw2, stretch = gaussian_amplitude(
        laser, Xp, Yp, t)
    t_prefactor = laser.e_max * np.exp(1j * osc)
    if ndim == 3:
        prefactor = t_prefactor / diffract
    elif ndim == 2:
        prefactor = t_prefactor / np.sqrt(complex(diffract))
    else:
        prefactor = t_prefactor
    ct, st = math.cos(laser.theta_stc), math.sin(laser.theta_stc)
    XY = Xp * ct + Yp * st
    stc_exponent = (
        complex((1.0 / stretch) * inv_tau2)
        * (
            (t - laser.profile_t_peak)
            - laser.beta * k0 * XY
            - complex(2j * (laser.zeta - laser.beta
                            * laser.profile_focal_distance) * inv_cw2) * XY
        )
        ** 2
    )
    stcfactor = complex(prefactor) * torch.exp(-stc_exponent)
    exp_argument = -(Xp * Xp + Yp * Yp) * complex(inv_cw2)
    return stcfactor * torch.exp(exp_argument)


def boost_laser_position(laser: LaserConfig, gamma_boost: float):
    """The antenna plane's position in the boosted frame
    (LaserParticleContainer.cpp:183-196): Z0_boost = Z0_lab / gamma along
    the propagation normal.  Returns (position3, Z0_lab)."""
    nvec = np.array(laser.direction, float)
    nvec = nvec / np.linalg.norm(nvec)
    pos = np.array(laser.position, float)
    z0_lab = float(nvec @ pos)
    if gamma_boost > 1.0:
        pos = pos + (z0_lab / gamma_boost - z0_lab) * nvec
    return tuple(pos), z0_lab


def antenna_particles(
    laser: LaserConfig, geom: Geometry, dtype, capacity_extra: int = 0
) -> Tuple[dict, float, float]:
    """Create antenna particle pairs on the host.

    Returns (columns, weight, mobility): ``columns`` maps the
    ``ParticleState`` field names to numpy arrays of the numpy ``dtype``.
    Layout per InitData: particles at
    plane-lattice points with spacing S (min cell size projected on the plane),
    two per point with weights +-w; w = ep0/mobility * S_X * S_Y.
    """
    ndim = geom.ndim
    nvec, u_X, u_Y = antenna_unit_vectors(laser, ndim)
    mobility = 0.05 / laser.e_max
    dxs = geom.dx
    eps = dxs[0] * 1e-50

    if ndim == 1:
        S_X = S_Y = 1.0
        points = [np.array([0.0, 0.0, laser.position[2]])]
    elif ndim == 2:
        S_X = min(
            dxs[0] / (abs(u_X[0]) + eps), dxs[1] / (abs(u_X[2]) + eps)
        )
        S_Y = 1.0
        lo = (geom.prob_lo[0], 0.0, geom.prob_lo[1])
        hi = (geom.prob_hi[0], 0.0, geom.prob_hi[1])
        pos3 = np.array(laser.position)
        imin, imax = _plane_range_2d(pos3, u_X, lo, hi, S_X)
        points = [
            pos3 + (S_X * (i + 0.5)) * np.array([u_X[0], 0.0, u_X[2]])
            for i in range(imin, imax + 1)
        ]
        points = [
            p for p in points
            if lo[0] <= p[0] <= hi[0] and lo[2] <= p[2] <= hi[2]
        ]
    else:
        S_X = min(
            dxs[0] / (abs(u_X[0]) + eps),
            dxs[1] / (abs(u_X[1]) + eps),
            dxs[2] / (abs(u_X[2]) + eps),
        )
        S_Y = min(
            dxs[0] / (abs(u_Y[0]) + eps),
            dxs[1] / (abs(u_Y[1]) + eps),
            dxs[2] / (abs(u_Y[2]) + eps),
        )
        pos3 = np.array(laser.position)
        lo = (geom.prob_lo[0], geom.prob_lo[1], geom.prob_lo[2])
        hi = (geom.prob_hi[0], geom.prob_hi[1], geom.prob_hi[2])
        (imin, imax), (jmin, jmax) = _plane_range_3d(pos3, u_X, u_Y, lo, hi, S_X, S_Y)
        points = []
        for i in range(imin, imax + 1):
            for j in range(jmin, jmax + 1):
                p = pos3 + (S_X * (i + 0.5)) * u_X + (S_Y * (j + 0.5)) * u_Y
                if all(lo[d] <= p[d] <= hi[d] for d in range(3)):
                    points.append(p)

    weight = constants.ep0 / mobility * S_X * S_Y

    n_pts = len(points)
    n = 2 * n_pts + capacity_extra
    w = np.zeros(n, dtype=dtype)
    xyz = np.zeros((n, 3), dtype=dtype)
    for ip, p in enumerate(points):
        for k in range(2):
            xyz[2 * ip + k] = p
        w[2 * ip] = weight
        w[2 * ip + 1] = -weight
    alive = np.zeros(n, dtype=bool)
    alive[: 2 * n_pts] = True
    zeros = np.zeros(n, dtype=dtype)
    cols = dict(w=w, ux=zeros.copy(), uy=zeros.copy(), uz=zeros.copy(),
                alive=alive)
    if ndim == 1:
        cols.update(z=xyz[:, 2].copy())
    elif ndim == 2:
        cols.update(x=xyz[:, 0].copy(), z=xyz[:, 2].copy())
    else:
        cols.update(x=xyz[:, 0].copy(), y=xyz[:, 1].copy(),
                    z=xyz[:, 2].copy())
    return cols, weight, mobility


def _plane_range_2d(pos3, u_X, lo, hi, S_X):
    vals = []
    for x, z in ((lo[0], lo[2]), (hi[0], lo[2]), (lo[0], hi[2]), (hi[0], hi[2])):
        proj = u_X[0] * (x - pos3[0]) + u_X[2] * (z - pos3[2])
        vals.append(int(proj / S_X))
    return min(vals), max(vals)


def _plane_range_3d(pos3, u_X, u_Y, lo, hi, S_X, S_Y):
    ivals, jvals = [], []
    import itertools

    for corner in itertools.product(*[(lo[d], hi[d]) for d in range(3)]):
        dp = np.array(corner) - pos3
        ivals.append(int(np.dot(u_X, dp) / S_X))
        jvals.append(int(np.dot(u_Y, dp) / S_Y))
    return (min(ivals), max(ivals)), (min(jvals), max(jvals))


def update_antenna(
    sp: ParticleState,
    laser: LaserConfig,
    geom: Geometry,
    mobility: float,
    t,
    dt: float,
    gamma_boost: float = 1.0,
    z0_lab: float = 0.0,
) -> ParticleState:
    """Prescribed antenna motion for one step (update_laser_particle).

    Sets u from the profile amplitude at the host time ``t`` and advances
    the positions by v*dt; the caller then runs the ordinary current
    deposition over these particles.  In a boosted frame the antenna
    oscillates at the lab time of its plane and recedes at -beta_boost c
    along the normal (LaserParticleContainer.cpp:574-580, 908-911); the
    caller divides the mobility by gamma_boost.
    """
    ndim = geom.ndim
    nvec, u_X, u_Y = antenna_unit_vectors(laser, ndim)
    p_X = polarization_p_x(laser)
    u_X = [float(v) for v in u_X]
    u_Y = [float(v) for v in u_Y]
    pos = sp.positions(ndim)
    # laser-plane coordinates
    if ndim == 1:
        Xp = torch.zeros_like(pos[0])
        Yp = torch.zeros_like(pos[0])
    elif ndim == 2:
        Xp = u_X[0] * (pos[0] - laser.position[0]) + u_X[2] * (
            pos[1] - laser.position[2]
        )
        Yp = torch.zeros_like(Xp)
    else:
        Xp = (
            u_X[0] * (pos[0] - laser.position[0])
            + u_X[1] * (pos[1] - laser.position[1])
            + u_X[2] * (pos[2] - laser.position[2])
        )
        Yp = (
            u_Y[0] * (pos[0] - laser.position[0])
            + u_Y[1] * (pos[1] - laser.position[1])
            + u_Y[2] * (pos[2] - laser.position[2])
        )
    beta_boost = 0.0
    if gamma_boost > 1.0:
        beta_boost = math.sqrt(1.0 - 1.0 / gamma_boost**2)
        t = t / gamma_boost + beta_boost * z0_lab / constants.c
    amplitude = fill_amplitude(laser, ndim, Xp, Yp, t)
    sign_charge = torch.where(sp.w > 0, -1.0, 1.0).to(sp.w.dtype)
    v_over_c = sign_charge * mobility * amplitude
    # velocity is along p_X: the polarization projected orthogonal to the
    # propagation direction (LaserParticleContainer.cpp:904-906 tmp_p_X)
    vx = constants.c * v_over_c * float(p_X[0])
    vy = constants.c * v_over_c * float(p_X[1])
    vz = constants.c * v_over_c * float(p_X[2])
    if gamma_boost > 1.0:
        vx = vx - beta_boost * constants.c * float(nvec[0])
        vy = vy - beta_boost * constants.c * float(nvec[1])
        vz = vz - beta_boost * constants.c * float(nvec[2])
    gamma = gamma_boost / torch.sqrt(1.0 - v_over_c * v_over_c)
    if ndim == 1:
        new_pos = [pos[0] + vz * dt]
    elif ndim == 2:
        new_pos = [pos[0] + vx * dt, pos[1] + vz * dt]
    else:
        new_pos = [pos[0] + vx * dt, pos[1] + vy * dt, pos[2] + vz * dt]
    out = sp.replace(ux=gamma * vx, uy=gamma * vy, uz=gamma * vz)
    return out.with_positions(ndim, new_pos)
