"""Charge and current deposition (particles -> grid) by scatter-add.

The counterpart of ``warpx_tpu.ops.deposit`` on the periodic torus: the
per-particle tap weights become (taps, n) tensors and the reference's
atomicAdd becomes ``index_add_`` with modular indices (the SumBoundary
guard-cell fold is implicit in the wrap).

* ``deposit_rho``: nodal charge density (ChargeDeposition.H shape-N);
* ``count_particles_per_cell``: the ``part_per_cell`` diagnostic;
* ``deposit_current_esirkepov``: charge-conserving current, 2D XZ and 3D
  (CurrentDeposition.H:643-900).  The per-particle step ``pic_step`` runs
  it; the binned step does not, so it is also the port's own slow-path
  oracle for the fused kernels in ``fused_pic``.
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import torch

from ..constants import inv_c2
from .shapes import esirkepov_weights, shape_weights

__all__ = [
    "deposit_rho",
    "deposit_current_esirkepov",
    "count_particles_per_cell",
]


def _scatter_add(target: torch.Tensor, idx_per_dim, values: torch.Tensor):
    """target[ravel(idx)] += values with C-order linearization."""
    n = target.shape
    lin = idx_per_dim[0]
    for d in range(1, len(n)):
        lin = lin * n[d] + idx_per_dim[d]
    flat = target.reshape(-1).clone()
    flat.index_add_(0, lin.reshape(-1), values.reshape(-1))
    return flat.reshape(n)


def _tap_idx(i0, taps, n):
    # tap axis first: (taps, np)
    ar = torch.arange(taps, device=i0.device, dtype=torch.int64)
    return torch.remainder(i0.long()[None, :] + ar[:, None], n)


def deposit_rho(
    positions: Sequence[torch.Tensor],
    w: torch.Tensor,
    q: float,
    geom,
    order: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Deposit nodal charge density rho [C/m^3] on the periodic grid."""
    ndim = geom.ndim
    invvol = 1.0 / geom.cell_volume
    coords = [
        (positions[d] - geom.prob_lo[d]) / geom.dx[d] for d in range(ndim)
    ]
    starts, weights = [], []
    for d in range(ndim):
        i0, ws = shape_weights(coords[d], order)
        starts.append(i0.long())
        weights.append(ws)
    wq = q * w * invvol
    rho = (torch.zeros(geom.n_cell, dtype=w.dtype, device=w.device)
           if out is None else out)
    vals, idxs = [], []
    for taps in itertools.product(*[range(order + 1)] * ndim):
        val = wq
        for d in range(ndim):
            val = val * weights[d][taps[d]]
        vals.append(val)
        idxs.append([torch.remainder(starts[d] + taps[d], geom.n_cell[d])
                     for d in range(ndim)])
    values = torch.stack(vals, dim=0)  # (ntaps, np)
    idx_per_dim = [
        torch.stack([ix[d] for ix in idxs], dim=0) for d in range(ndim)
    ]
    return _scatter_add(rho, idx_per_dim, values)


def count_particles_per_cell(positions, alive, geom) -> torch.Tensor:
    """Particle count per cell (diagnostic 'part_per_cell')."""
    idx = [
        torch.clamp(
            torch.floor(
                (positions[d] - geom.prob_lo[d]) / geom.dx[d]
            ).long(),
            0,
            geom.n_cell[d] - 1,
        )
        for d in range(geom.ndim)
    ]
    target = torch.zeros(geom.n_cell, dtype=positions[0].dtype,
                         device=positions[0].device)
    return _scatter_add(target, idx, alive.to(target.dtype))


def deposit_current_esirkepov(
    positions: Sequence[torch.Tensor],
    ux, uy, uz, w,
    q: float,
    geom,
    dt: float,
    order: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Charge-conserving current deposition of ``warpx_tpu.ops.deposit.
    _esirkepov_body`` at the default relative time -dt/2 (2D XZ and 3D).

    ``positions`` are the already-pushed x^{n+1}; the old position is
    reconstructed as x^{n+1} - dt*v (CurrentDeposition.H:725-738), and the
    deposited J is the Yee-staggered J^{n+1/2}.
    """
    if geom.ndim not in (2, 3):
        raise NotImplementedError(
            "1D Esirkepov deposition (ROADMAP.md Queue A 3)"
        )
    n_cell = geom.n_cell
    gaminv = 1.0 / torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz) * inv_c2)
    wq = q * w
    dtype = w.dtype
    taps = order + 3
    dxs = geom.dx

    def zeros():
        return torch.zeros(n_cell, dtype=dtype, device=w.device)

    if geom.ndim == 2:  # XZ plane: Jx, Jz cumulative, Jy direct
        return _esirkepov_2d(positions, (ux * gaminv, uy * gaminv,
                                         uz * gaminv), wq, geom, dt, order,
                             zeros)
    invdtd = (
        1.0 / (dt * dxs[1] * dxs[2]),
        1.0 / (dt * dxs[0] * dxs[2]),
        1.0 / (dt * dxs[0] * dxs[1]),
    )
    vel = (ux * gaminv, uy * gaminv, uz * gaminv)
    i0s, SN, SO = [], [], []
    for d in range(3):
        xn = (positions[d] - geom.prob_lo[d]) / dxs[d]
        xo = xn - dt / dxs[d] * vel[d]
        i0, s_new, s_old = esirkepov_weights(xn, xo, order)
        i0s.append(i0)
        SN.append(torch.stack(s_new, dim=0))
        SO.append(torch.stack(s_old, dim=0))
    CUM = [torch.cumsum(SO[d] - SN[d], dim=0) for d in range(3)]

    def tmix(a, b):
        # (Ta, Tb, np)
        return (
            (SN[a][:, None] * SN[b][None, :] + SO[a][:, None] * SO[b][None, :])
            / 3.0
            + (SN[a][:, None] * SO[b][None, :] + SO[a][:, None] * SN[b][None, :])
            / 6.0
        )

    valx = (wq * invdtd[0]) * CUM[0][:, None, None] * tmix(1, 2)[None, :, :]
    valy = (wq * invdtd[1]) * CUM[1][None, :, None] * tmix(0, 2)[:, None, :]
    valz = (wq * invdtd[2]) * CUM[2][None, None, :] * tmix(0, 1)[:, :, None]

    ix, iy, iz = (_tap_idx(i0s[d], taps, n_cell[d]) for d in range(3))
    IX = torch.broadcast_to(ix[:, None, None], valx.shape)
    IY = torch.broadcast_to(iy[None, :, None], valx.shape)
    IZ = torch.broadcast_to(iz[None, None, :], valx.shape)
    jx = _scatter_add(zeros(), [IX, IY, IZ], valx)
    jy = _scatter_add(zeros(), [IX, IY, IZ], valy)
    jz = _scatter_add(zeros(), [IX, IY, IZ], valz)
    return jx, jy, jz


def _esirkepov_2d(positions, vel, wq, geom, dt, order, zeros):
    """The 2D branch (CurrentDeposition.H, WARPX_DIM_XZ): the in-plane
    components are running sums weighted by the half-sum of the other axis'
    old and new shapes; the out-of-plane Jy is wq*vy times the 1/3-1/6 mix."""
    dx, dz = geom.dx
    vx, vy, vz = vel
    invvol = 1.0 / (dx * dz)
    xn = (positions[0] - geom.prob_lo[0]) / dx
    zn = (positions[1] - geom.prob_lo[1]) / dz
    xo = xn - dt / dx * vx
    zo = zn - dt / dz * vz
    taps = order + 3
    i0x, snx, sox = esirkepov_weights(xn, xo, order)
    i0z, snz, soz = esirkepov_weights(zn, zo, order)
    SNx, SOx = torch.stack(snx, dim=0), torch.stack(sox, dim=0)
    SNz, SOz = torch.stack(snz, dim=0), torch.stack(soz, dim=0)
    CUMx = torch.cumsum(SOx - SNx, dim=0)
    CUMz = torch.cumsum(SOz - SNz, dim=0)
    mixxz = (
        (SNx[:, None] * SNz[None, :] + SOx[:, None] * SOz[None, :]) / 3.0
        + (SNx[:, None] * SOz[None, :] + SOx[:, None] * SNz[None, :]) / 6.0
    )
    valx = (wq * (1.0 / (dt * dz))) * CUMx[:, None] \
        * (0.5 * (SNz + SOz))[None, :]
    valy = (wq * vy * invvol) * mixxz
    valz = (wq * (1.0 / (dt * dx))) * CUMz[None, :] \
        * (0.5 * (SNx + SOx))[:, None]
    ix = _tap_idx(i0x, taps, geom.n_cell[0])
    iz = _tap_idx(i0z, taps, geom.n_cell[1])
    IX = torch.broadcast_to(ix[:, None], valx.shape)
    IZ = torch.broadcast_to(iz[None, :], valx.shape)
    return tuple(_scatter_add(zeros(), [IX, IZ], v)
                 for v in (valx, valy, valz))
