"""Yee curl updates on guard-padded local rank blocks.

The counterpart of ``warpx_tpu.solvers.yee_padded``: the physics of
``solvers/yee.py`` (reference: EvolveB.cpp/EvolveE.cpp Yee stencils) on
blocks padded with 1 guard cell per side, as ``parallel.halo.
exchange_halos`` produces them: FillBoundary, then the update.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..constants import c as _c
from ..constants import mu0 as _mu0

__all__ = ["evolve_b_padded", "evolve_e_padded"]

_c2 = _c * _c


def _sl(F: torch.Tensor, axis: int, off: int) -> torch.Tensor:
    """Valid-region slice of a 1-padded array, shifted by ``off`` along ``axis``."""
    idx = []
    for d in range(F.ndim):
        if d == axis:
            idx.append(slice(1 + off, F.shape[d] - 1 + off))
        else:
            idx.append(slice(1, F.shape[d] - 1))
    return F[tuple(idx)]


def _up(Fp, axis, inv_d):
    return (_sl(Fp, axis, 1) - _sl(Fp, axis, 0)) * inv_d


def _down(Fp, axis, inv_d):
    return (_sl(Fp, axis, 0) - _sl(Fp, axis, -1)) * inv_d


def evolve_b_padded(
    B: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    E_pad: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    dx: Sequence[float],
    ndim: int,
    dt: float,
):
    Exp, Eyp, Ezp = E_pad
    Bx, By, Bz = B
    if ndim == 3:
        idx, idy, idz = (1.0 / d for d in dx)
        Bx = Bx + dt * (_up(Eyp, 2, idz) - _up(Ezp, 1, idy))
        By = By + dt * (_up(Ezp, 0, idx) - _up(Exp, 2, idz))
        Bz = Bz + dt * (_up(Exp, 1, idy) - _up(Eyp, 0, idx))
    elif ndim == 2:
        idx, idz = (1.0 / d for d in dx)
        Bx = Bx + dt * _up(Eyp, 1, idz)
        By = By + dt * (_up(Ezp, 0, idx) - _up(Exp, 1, idz))
        Bz = Bz - dt * _up(Eyp, 0, idx)
    else:
        idz = 1.0 / dx[0]
        Bx = Bx + dt * _up(Eyp, 0, idz)
        By = By - dt * _up(Exp, 0, idz)
    return Bx, By, Bz


def evolve_e_padded(
    E: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    B_pad: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    J: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    dx: Sequence[float],
    ndim: int,
    dt: float,
):
    Bxp, Byp, Bzp = B_pad
    Ex, Ey, Ez = E
    jx, jy, jz = J
    k = _c2 * dt
    if ndim == 3:
        idx, idy, idz = (1.0 / d for d in dx)
        Ex = Ex + k * (_down(Bzp, 1, idy) - _down(Byp, 2, idz) - _mu0 * jx)
        Ey = Ey + k * (_down(Bxp, 2, idz) - _down(Bzp, 0, idx) - _mu0 * jy)
        Ez = Ez + k * (_down(Byp, 0, idx) - _down(Bxp, 1, idy) - _mu0 * jz)
    elif ndim == 2:
        idx, idz = (1.0 / d for d in dx)
        Ex = Ex + k * (-_down(Byp, 1, idz) - _mu0 * jx)
        Ey = Ey + k * (_down(Bxp, 1, idz) - _down(Bzp, 0, idx) - _mu0 * jy)
        Ez = Ez + k * (_down(Byp, 0, idx) - _mu0 * jz)
    else:
        idz = 1.0 / dx[0]
        Ex = Ex + k * (-_down(Byp, 0, idz) - _mu0 * jx)
        Ey = Ey + k * (_down(Bxp, 0, idz) - _mu0 * jy)
        Ez = Ez + k * (-_mu0 * jz)
    return Ex, Ey, Ez
