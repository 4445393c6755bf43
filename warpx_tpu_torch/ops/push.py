"""Relativistic particle pushers (elementwise functions on tensors).

The counterpart of ``warpx_tpu.ops.push``.  Momentum is proper velocity
u = gamma*v [m/s], as in the reference:
  Boris:        Source/Particles/Pusher/UpdateMomentumBoris.H:16-53
  Vay:          Source/Particles/Pusher/UpdateMomentumVay.H:20
  Higuera-Cary: Source/Particles/Pusher/UpdateMomentumHigueraCary.H:22
  Boris with classical radiation reaction:
    Source/Particles/Pusher/UpdateMomentumBorisWithRadiationReaction.H
  Position:     Source/Particles/Pusher/UpdatePosition.H:25
  Photons:      PhotonParticleContainer::PushPX
The CUDA kernel in ``csrc/fused_pic.cu`` repeats the Boris, Vay,
Higuera-Cary and position formulas line for line; keep them in step (the
tile-binned gates keep radiation reaction and photons per particle).
"""

from __future__ import annotations

import torch

from .. import constants

_inv_c2 = constants.inv_c2

__all__ = [
    "push_momentum_boris",
    "push_momentum_vay",
    "push_momentum_higuera_cary",
    "push_momentum_boris_rr",
    "inv_gamma",
    "position_step",
    "photon_position_step",
    "PUSHERS",
]


def inv_gamma(ux, uy, uz):
    return 1.0 / torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz) * _inv_c2)


def push_momentum_boris(ux, uy, uz, Ex, Ey, Ez, Bx, By, Bz, q, m, dt):
    """Boris rotation push: half E kick, B rotation, half E kick."""
    econst = 0.5 * q * dt / m
    ux = ux + econst * Ex
    uy = uy + econst * Ey
    uz = uz + econst * Ez
    invg = inv_gamma(ux, uy, uz)
    tx = econst * invg * Bx
    ty = econst * invg * By
    tz = econst * invg * Bz
    tsqi = 2.0 / (1.0 + tx * tx + ty * ty + tz * tz)
    sx = tx * tsqi
    sy = ty * tsqi
    sz = tz * tsqi
    uxp = ux + uy * tz - uz * ty
    uyp = uy + uz * tx - ux * tz
    uzp = uz + ux * ty - uy * tx
    ux = ux + uyp * sz - uzp * sy
    uy = uy + uzp * sx - uxp * sz
    uz = uz + uxp * sy - uyp * sx
    ux = ux + econst * Ex
    uy = uy + econst * Ey
    uz = uz + econst * Ez
    return ux, uy, uz


def push_momentum_vay(ux, uy, uz, Ex, Ey, Ez, Bx, By, Bz, q, m, dt):
    """Vay (2008) push: full-step E plus half-step magnetic rotation solved
    in closed form (UpdateMomentumVay.H)."""
    econst = q * dt / m
    bconst = 0.5 * q * dt / m
    invg = inv_gamma(ux, uy, uz)
    taux = bconst * Bx
    tauy = bconst * By
    tauz = bconst * Bz
    uxh = ux + econst * Ex + invg * (uy * tauz - uz * tauy)
    uyh = uy + econst * Ey + invg * (uz * taux - ux * tauz)
    uzh = uz + econst * Ez + invg * (ux * tauy - uy * taux)
    tausq = taux * taux + tauy * tauy + tauz * tauz
    ust = (uxh * taux + uyh * tauy + uzh * tauz) / constants.c
    gprsq = (1.0 + (uxh * uxh + uyh * uyh + uzh * uzh) * _inv_c2)
    sigma = gprsq - tausq
    invgp = torch.sqrt(
        2.0 / (sigma + torch.sqrt(sigma * sigma + 4.0 * (tausq + ust * ust)))
    )
    tx = taux * invgp
    ty = tauy * invgp
    tz = tauz * invgp
    s = 1.0 / (1.0 + tausq * invgp * invgp)
    ut = uxh * tx + uyh * ty + uzh * tz
    ux_new = s * (uxh + ut * tx + uyh * tz - uzh * ty)
    uy_new = s * (uyh + ut * ty + uzh * tx - uxh * tz)
    uz_new = s * (uzh + ut * tz + uxh * ty - uyh * tx)
    return ux_new, uy_new, uz_new


def push_momentum_higuera_cary(ux, uy, uz, Ex, Ey, Ez, Bx, By, Bz, q, m, dt):
    """Higuera-Cary (2017) volume-preserving push
    (UpdateMomentumHigueraCary.H:22-90)."""
    qmt = 0.5 * q * dt / m
    umx = ux + qmt * Ex
    umy = uy + qmt * Ey
    umz = uz + qmt * Ez
    gsq = 1.0 + (umx * umx + umy * umy + umz * umz) * _inv_c2
    betax = qmt * Bx
    betay = qmt * By
    betaz = qmt * Bz
    betam = betax * betax + betay * betay + betaz * betaz
    sigma = gsq - betam
    ust = (umx * betax + umy * betay + umz * betaz) * (1.0 / constants.c)
    invg = 1.0 / torch.sqrt(
        0.5 * (sigma + torch.sqrt(sigma * sigma + 4.0 * (betam + ust * ust)))
    )
    tx = invg * betax
    ty = invg * betay
    tz = invg * betaz
    s = 1.0 / (1.0 + (tx * tx + ty * ty + tz * tz))
    umt = umx * tx + umy * ty + umz * tz
    upx = s * (umx + umt * tx + umy * tz - umz * ty)
    upy = s * (umy + umt * ty + umz * tx - umx * tz)
    upz = s * (umz + umt * tz + umx * ty - umy * tx)
    ux_new = upx + qmt * Ex + upy * tz - upz * ty
    uy_new = upy + qmt * Ey + upz * tx - upx * tz
    uz_new = upz + qmt * Ez + upx * ty - upy * tx
    return ux_new, uy_new, uz_new


def push_momentum_boris_rr(ux, uy, uz, Ex, Ey, Ez, Bx, By, Bz, q, m, dt):
    """Boris push with classical (Landau-Lifshitz) radiation reaction
    (Tamburini et al., NJP 12 123005): the Boris push, then the
    radiation-reaction force at the time-centered momentum."""
    ux_n0, uy_n0, uz_n0 = ux, uy, uz
    ux, uy, uz = push_momentum_boris(ux, uy, uz, Ex, Ey, Ez, Bx, By, Bz,
                                     q, m, dt)
    uxn = 0.5 * (ux + ux_n0)
    uyn = 0.5 * (uy + uy_n0)
    uzn = 0.5 * (uz + uz_n0)
    gam = torch.sqrt(1.0 + (uxn * uxn + uyn * uyn + uzn * uzn) * _inv_c2)
    inv_g = 1.0 / gam
    vx, vy, vz = uxn * inv_g, uyn * inv_g, uzn * inv_g
    bx_n = vx / constants.c
    by_n = vy / constants.c
    bz_n = vz / constants.c
    flx = Ex + vy * Bz - vz * By
    fly = Ey + vz * Bx - vx * Bz
    flz = Ez + vx * By - vy * Bx
    fl2 = flx * flx + fly * fly + flz * flz
    bdotE = bx_n * Ex + by_n * Ey + bz_n * Ez
    coeff = gam * gam * (fl2 - bdotE * bdotE)
    q_over_mc = q / (m * constants.c)
    rr = (2.0 / 3.0) * constants.r_e * q_over_mc * q_over_mc
    frx = rr * (constants.c * (fly * Bz - flz * By) + bdotE * Ex
                - coeff * bx_n)
    fry = rr * (constants.c * (flz * Bx - flx * Bz) + bdotE * Ey
                - coeff * by_n)
    frz = rr * (constants.c * (flx * By - fly * Bx) + bdotE * Ez
                - coeff * bz_n)
    return ux + frx * dt, uy + fry * dt, uz + frz * dt


PUSHERS = {
    "boris": push_momentum_boris,
    "vay": push_momentum_vay,
    "higuera": push_momentum_higuera_cary,
    "boris_rr": push_momentum_boris_rr,
}


def position_step(pos, ux, uy, uz, dt, ndim):
    """Leapfrog position update x += dt * u/gamma on the active axes
    ``pos`` = (z,), (x, z) or (x, y, z)."""
    invg = inv_gamma(ux, uy, uz)
    vel = {1: (uz,), 2: (ux, uz), 3: (ux, uy, uz)}[ndim]
    return tuple(p + v * invg * dt for p, v in zip(pos, vel))


def photon_position_step(pos, ux, uy, uz, dt, ndim):
    """Photon free streaming x += dt * c * u/|u| on the active axes
    (massless: the speed is c along u)."""
    umag = torch.sqrt(ux * ux + uy * uy + uz * uz)
    # a photon without momentum (a dead slot) stays where it is; the JAX
    # package's c / max(|u|, 1e-300) overflows to inf (c / 1e-300 is past
    # float64's largest number) and makes such a slot's position NaN
    # (ROADMAP.md Queue C)
    inv = torch.where(umag > 0.0,
                      constants.c / torch.where(umag > 0.0, umag,
                                                torch.ones_like(umag)),
                      torch.zeros_like(umag))
    vel = {1: (uz,), 2: (ux, uz), 3: (ux, uy, uz)}[ndim]
    return tuple(p + v * inv * dt for p, v in zip(pos, vel))
