"""The hybrid QED Maxwell solver: the Heisenberg-Euler vacuum
nonlinearity as a correction of E.

The counterpart of ``warpx_tpu.solvers.hybrid_qed`` (reference:
Source/FieldSolver/WarpX_QED_Field_Pushers.cpp, WarpX_QED_K.H): a half-step
correction dE that solves the implicit 3x3 system

    A(E, B) dE = -Omega(E, B, curl E, curl B, curl M, J)

at every node of the collocated grid, applied before and after the PSATD
push (WarpXEvolve.cpp:386-402).  M is the Heisenberg-Euler magnetization;
xi_c2 = xi c^2 with xi the nonlinearity parameter (ablastr/constant.H:
64-67), which warpx.quantum_xi overrides.  The curls are the centered
differences of WarpX_QED_K.H on the periodic grid (d/dy = 0 in 2D).

The diagonal of A is eps0 plus a xi term, so its determinant is about
eps0^3 ~ 7e-34: within float32's range, four decades above its smallest
normal number.
"""

from __future__ import annotations

import torch

from ..constants import c as _c
from ..constants import ep0 as _ep0
from ..constants import mu0 as _mu0

__all__ = ["hybrid_qed_push", "XI_C2_DEFAULT"]

XI_C2_DEFAULT = 1.1728865132395492e-35  # ablastr constant::SI::xi * c^2

_c2 = _c * _c
_c2i = 1.0 / _c2


def _calc_m(e3, b3, xi_c2):
    """The Heisenberg-Euler magnetization M (WarpX_QED_K.H calc_M)."""
    ex, ey, ez = e3
    bx, by, bz = b3
    ee = ex * ex + ey * ey + ez * ez
    bb_c2 = _c2 * (bx * bx + by * by + bz * bz)
    eb = ex * bx + ey * by + ez * bz
    return tuple(-2.0 * xi_c2 * (2.0 * b * (ee - bb_c2) - 7.0 * e * eb)
                 for e, b in zip(e3, b3))


def _sum3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def hybrid_qed_push(fields, geom, dt: float, xi_c2: float):
    """E += dt/2 dE_QED on the collocated periodic grid; B unchanged."""
    ndim = geom.ndim
    e3 = (fields.Ex, fields.Ey, fields.Ez)
    b3 = (fields.Bx, fields.By, fields.Bz)
    j3 = (fields.jx, fields.jy, fields.jz)
    # the array axis of an xyz axis (None: inactive, d/dy = 0 in 2D)
    axis_of = {1: {2: 0}, 2: {0: 0, 2: 1}, 3: {0: 0, 1: 1, 2: 2}}[ndim]

    def dc(arr, a_xyz):
        d = axis_of.get(a_xyz)
        if d is None:
            return torch.zeros_like(arr)
        inv = 1.0 / geom.dx[d]
        return 0.5 * inv * (torch.roll(arr, -1, d) - torch.roll(arr, 1, d))

    def curl(v3):
        return (dc(v3[2], 1) - dc(v3[1], 2),
                dc(v3[0], 2) - dc(v3[2], 0),
                dc(v3[1], 0) - dc(v3[0], 1))

    vxm = curl(_calc_m(e3, b3, xi_c2))
    vxe = curl(e3)
    vxb = curl(b3)

    ex, ey, ez = e3
    bx, by, bz = b3
    mu0j = tuple(_mu0 * j for j in j3)
    ee = _sum3(e3, e3)
    bb = _sum3(b3, b3)
    eb = _sum3(e3, b3)
    EVxE = _sum3(e3, vxe)
    BVxE = _sum3(b3, vxe)
    EVxB = _sum3(e3, vxb)
    BVxB = _sum3(b3, vxb)
    Emu0J = _sum3(e3, mu0j)
    Bmu0J = _sum3(b3, mu0j)

    beta = 4.0 * xi_c2 * (_c2i * ee - bb) + _ep0
    alpha = tuple(
        2.0 * xi_c2 * (-7.0 * b * EVxE - 7.0 * v * eb + 4.0 * e * BVxE) + m
        for e, b, v, m in zip(e3, b3, vxe, vxm))
    omega = tuple(
        al + 2.0 * xi_c2 * (4.0 * e * (EVxB + Emu0J)
                            + 2.0 * (v + j) * (ee - _c2 * bb)
                            + 7.0 * _c2 * b * (BVxB + Bmu0J))
        for al, e, b, v, j in zip(alpha, e3, b3, vxb, mu0j))

    a00 = beta + xi_c2 * (8.0 * _c2i * ex * ex + 14.0 * bx * bx)
    a11 = beta + xi_c2 * (8.0 * _c2i * ey * ey + 14.0 * by * by)
    a22 = beta + xi_c2 * (8.0 * _c2i * ez * ez + 14.0 * bz * bz)
    a01 = xi_c2 * (2.0 * _c2i * ex * ey + 14.0 * bx * by)
    a02 = xi_c2 * (2.0 * _c2i * ex * ez + 14.0 * bx * bz)
    a12 = xi_c2 * (2.0 * _c2i * ez * ey + 14.0 * bz * by)
    det = (a00 * (a11 * a22 - a12 * a12)
           - a01 * (a01 * a22 - a02 * a12)
           + a02 * (a01 * a12 - a02 * a11))
    inv_ax = (a22 * a11 - a12 * a12, a12 * a02 - a22 * a01,
              a12 * a01 - a11 * a02)
    inv_ay = (a02 * a12 - a22 * a01, a00 * a22 - a02 * a02,
              a01 * a02 - a12 * a00)
    inv_az = (a12 * a01 - a02 * a11, a02 * a01 - a12 * a00,
              a11 * a00 - a01 * a01)
    inv_det = -1.0 / det
    dEx = inv_det * _sum3(inv_ax, omega)
    dEy = inv_det * _sum3(inv_ay, omega)
    dEz = inv_det * _sum3(inv_az, omega)
    return fields.replace(Ex=ex + 0.5 * dt * dEx, Ey=ey + 0.5 * dt * dEy,
                          Ez=ez + 0.5 * dt * dEz)
