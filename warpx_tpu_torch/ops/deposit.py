"""Charge and current deposition (particles -> grid) by scatter-add.

The counterpart of ``warpx_tpu.ops.deposit`` on the periodic torus: the
per-particle tap weights become (taps, n) tensors and the reference's
atomicAdd becomes ``index_add_`` with modular indices (the SumBoundary
guard-cell fold is implicit in the wrap).

* ``deposit_rho``: nodal charge density (ChargeDeposition.H shape-N);
* ``count_particles_per_cell``: the ``part_per_cell`` diagnostic;
* ``deposit_current_esirkepov``: charge-conserving 3D current
  (CurrentDeposition.H:643-900).  The binned step does not call it; it is
  the port's own slow-path oracle for the fused kernel in ``fused_pic``.
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
    """Charge-conserving 3D current deposition of ``warpx_tpu.ops.deposit.
    _esirkepov_body`` at the default relative time -dt/2.

    ``positions`` are the already-pushed x^{n+1}; the old position is
    reconstructed as x^{n+1} - dt*v (CurrentDeposition.H:725-738), and the
    deposited J is the Yee-staggered J^{n+1/2}.
    """
    if geom.ndim != 3:
        raise NotImplementedError(
            "1D/2D Esirkepov deposition (ROADMAP.md Queue A 3)"
        )
    n_cell = geom.n_cell
    gaminv = 1.0 / torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz) * inv_c2)
    wq = q * w
    dtype = w.dtype
    taps = order + 3
    dxs = geom.dx
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

    def zeros():
        return torch.zeros(n_cell, dtype=dtype, device=w.device)

    jx = _scatter_add(zeros(), [IX, IY, IZ], valx)
    jy = _scatter_add(zeros(), [IX, IY, IZ], valy)
    jz = _scatter_add(zeros(), [IX, IY, IZ], valz)
    return jx, jy, jz
