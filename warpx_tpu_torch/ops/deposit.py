"""Charge and current deposition (particles -> grid) by scatter-add.

The counterpart of ``warpx_tpu.ops.deposit``: the per-particle tap weights
become (taps, n) tensors and the reference's atomicAdd becomes
``index_add_``.  Two index modes:

* ``wrap=True``: the periodic torus, modular indices (the SumBoundary
  guard-cell fold is implicit in the wrap);
* ``wrap=False``: a block of shape ``out_shape`` padded with ``offset``
  guard cells per side whose index 0 sits at ``origin``; the caller folds or
  drops the guards.  Taps past the block land on its edge: only a dead slot
  (weight 0) that the moving window left behind reaches there.

* ``deposit_rho``: nodal charge density (ChargeDeposition.H shape-N);
* ``count_particles_per_cell``: the ``part_per_cell`` diagnostic;
* ``deposit_current_esirkepov``: charge-conserving current, 1D Z, 2D XZ
  and 3D (CurrentDeposition.H:643-900).  The per-particle steps run it; the binned
  steps run it only for laser antennas and small compact species, so it is
  also the port's own slow-path oracle for the fused kernels in
  ``fused_pic``;
* ``deposit_current_direct``: J = q w v at the Yee J sites from the
  position at ``relative_time`` (CurrentDeposition.H:274, PSATD's default
  and multi-J's sampler);
* ``deposit_current_vay``: the nodal D arrays of Vay deposition
  (CurrentDeposition.H:1857-2135) that the PSATD solver turns into J.

``chunk_size`` bounds the (taps, n) intermediates: the particles are
deposited that many at a time into the same block.
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import torch

from .push import inv_gamma
from .shapes import esirkepov_weights, shape_weights

__all__ = [
    "deposit_rho",
    "deposit_current_esirkepov",
    "deposit_current_direct",
    "deposit_current_vay",
    "count_particles_per_cell",
]


def _scatter_add_(target: torch.Tensor, idx_per_dim, values: torch.Tensor):
    """target[ravel(idx)] += values in place, C-order linearization."""
    n = target.shape
    lin = idx_per_dim[0]
    for d in range(1, len(n)):
        lin = lin * n[d] + idx_per_dim[d]
    target.view(-1).index_add_(0, lin.reshape(-1), values.reshape(-1))


def _tap_idx(i0, taps, n, wrap=True, offset=0):
    # tap axis first: (taps, np)
    ar = torch.arange(taps, device=i0.device, dtype=torch.int64)
    idx = i0.long()[None, :] + ar[:, None] + offset
    return torch.remainder(idx, n) if wrap else torch.clamp(idx, 0, n - 1)


def _chunks(n, chunk_size):
    if not chunk_size or n <= chunk_size:
        return [slice(0, n)]
    return [slice(a, min(n, a + chunk_size))
            for a in range(0, n, chunk_size)]


def deposit_rho(
    positions: Sequence[torch.Tensor],
    w: torch.Tensor,
    q: float,
    geom,
    order: int,
    out: torch.Tensor | None = None,
    origin=None,
    wrap: bool = True,
    offset: int = 0,
    out_shape=None,
    chunk_size: int | None = None,
) -> torch.Tensor:
    """Deposit nodal charge density rho [C/m^3]; ``out`` (if given) is
    left as it was and the sum returned."""
    ndim = geom.ndim
    shape = tuple(out_shape or geom.n_cell)
    invvol = 1.0 / geom.cell_volume
    lo = geom.prob_lo if origin is None else origin
    rho = (torch.zeros(shape, dtype=w.dtype, device=w.device)
           if out is None else out.clone())
    for sl in _chunks(w.shape[0], chunk_size):
        starts, weights = [], []
        for d in range(ndim):
            i0, ws = shape_weights((positions[d][sl] - lo[d]) / geom.dx[d],
                                   order)
            starts.append(i0.long())
            weights.append(ws)
        wq = q * w[sl] * invvol
        idx1 = [_tap_idx(starts[d], order + 1, shape[d], wrap, offset)
                for d in range(ndim)]
        vals, idxs = [], []
        for taps in itertools.product(*[range(order + 1)] * ndim):
            val = wq
            for d in range(ndim):
                val = val * weights[d][taps[d]]
            vals.append(val)
            idxs.append([idx1[d][taps[d]] for d in range(ndim)])
        values = torch.stack(vals, dim=0)  # (ntaps, np)
        idx_per_dim = [
            torch.stack([ix[d] for ix in idxs], dim=0) for d in range(ndim)
        ]
        _scatter_add_(rho, idx_per_dim, values)
    return rho


def count_particles_per_cell(positions, alive, geom,
                             origin=None) -> torch.Tensor:
    """Particle count per cell (diagnostic 'part_per_cell')."""
    lo = geom.prob_lo if origin is None else origin
    idx = [
        torch.clamp(
            torch.floor((positions[d] - lo[d]) / geom.dx[d]).long(),
            0,
            geom.n_cell[d] - 1,
        )
        for d in range(geom.ndim)
    ]
    target = torch.zeros(geom.n_cell, dtype=positions[0].dtype,
                         device=positions[0].device)
    _scatter_add_(target, idx, alive.to(target.dtype))
    return target


def deposit_current_esirkepov(
    positions: Sequence[torch.Tensor],
    ux, uy, uz, w,
    q: float,
    geom,
    dt: float,
    order: int,
    origin=None,
    wrap: bool = True,
    offset: int = 0,
    out_shape=None,
    chunk_size: int | None = None,
    out=None,
    positions_old=None,
    gaminv_override=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Charge-conserving current deposition of ``warpx_tpu.ops.deposit.
    _esirkepov_body`` at the default relative time -dt/2 (1D Z, 2D XZ and
    3D).

    ``positions`` are the already-pushed x^{n+1}; the old position is
    reconstructed as x^{n+1} - dt*v (CurrentDeposition.H:725-738), and the
    deposited J is the Yee-staggered J^{n+1/2}.  ``out`` (three blocks of
    the deposit's shape) is added to in place and returned.  The implicit
    schemes pass x^n as ``positions_old`` and 2/(gamma^n + gamma^{n+1}) as
    ``gaminv_override`` with u = u^{n+1/2}
    (doChargeConservingDepositionShapeNImplicit, CurrentDeposition.H:934).
    """
    shape = tuple(out_shape or geom.n_cell)
    lo = geom.prob_lo if origin is None else origin
    j3 = out if out is not None else tuple(
        torch.zeros(shape, dtype=w.dtype, device=w.device) for _ in range(3))
    body = {1: _esirkepov_1d, 2: _esirkepov_2d, 3: _esirkepov_3d}[geom.ndim]
    for sl in _chunks(w.shape[0], chunk_size):
        u = (ux[sl], uy[sl], uz[sl])
        gaminv = (inv_gamma(*u) if gaminv_override is None
                  else gaminv_override[sl])
        old = (None if positions_old is None
               else [p[sl] for p in positions_old])
        body([p[sl] for p in positions], tuple(a * gaminv for a in u),
             q * w[sl], geom, dt, order, lo, wrap, offset, j3, old)
    return j3


def _esirkepov_3d(positions, vel, wq, geom, dt, order, lo, wrap, offset, j3,
                  positions_old=None):
    shape = j3[0].shape
    taps = order + 3
    dxs = geom.dx
    invdtd = (
        1.0 / (dt * dxs[1] * dxs[2]),
        1.0 / (dt * dxs[0] * dxs[2]),
        1.0 / (dt * dxs[0] * dxs[1]),
    )
    i0s, SN, SO = [], [], []
    for d in range(3):
        xn = (positions[d] - lo[d]) / dxs[d]
        xo = (xn - dt / dxs[d] * vel[d] if positions_old is None
              else (positions_old[d] - lo[d]) / dxs[d])
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

    ix, iy, iz = (_tap_idx(i0s[d], taps, shape[d], wrap, offset)
                  for d in range(3))
    idx = [torch.broadcast_to(ix[:, None, None], valx.shape),
           torch.broadcast_to(iy[None, :, None], valx.shape),
           torch.broadcast_to(iz[None, None, :], valx.shape)]
    for j, v in zip(j3, (valx, valy, valz)):
        _scatter_add_(j, idx, v)


def _esirkepov_2d(positions, vel, wq, geom, dt, order, lo, wrap, offset, j3,
                  positions_old=None):
    """The 2D branch (CurrentDeposition.H, WARPX_DIM_XZ): the in-plane
    components are running sums weighted by the half-sum of the other axis'
    old and new shapes; the out-of-plane Jy is wq*vy times the 1/3-1/6 mix."""
    shape = j3[0].shape
    dx, dz = geom.dx
    vx, vy, vz = vel
    invvol = 1.0 / (dx * dz)
    xn = (positions[0] - lo[0]) / dx
    zn = (positions[1] - lo[1]) / dz
    if positions_old is None:
        xo = xn - dt / dx * vx
        zo = zn - dt / dz * vz
    else:
        xo = (positions_old[0] - lo[0]) / dx
        zo = (positions_old[1] - lo[1]) / dz
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
    ix = _tap_idx(i0x, taps, shape[0], wrap, offset)
    iz = _tap_idx(i0z, taps, shape[1], wrap, offset)
    idx = [torch.broadcast_to(ix[:, None], valx.shape),
           torch.broadcast_to(iz[None, :], valx.shape)]
    for j, v in zip(j3, (valx, valy, valz)):
        _scatter_add_(j, idx, v)


def _esirkepov_1d(positions, vel, wq, geom, dt, order, lo, wrap, offset, j3,
                  positions_old=None):
    """The 1D branch (CurrentDeposition.H, WARPX_DIM_1D_Z; JAX
    deposit.py:328-348): the transverse currents are direct, wq v on the
    half-sum of the old and new shapes; Jz is the charge-conserving running
    sum."""
    shape = j3[0].shape
    (dz,) = geom.dx
    vx, vy, vz = vel
    invvol = 1.0 / dz
    zn = (positions[0] - lo[0]) / dz
    if positions_old is None:
        zo = zn - dt / dz * vz
    else:
        zo = (positions_old[0] - lo[0]) / dz
    i0z, snz, soz = esirkepov_weights(zn, zo, order)
    SNz, SOz = torch.stack(snz, dim=0), torch.stack(soz, dim=0)
    CUMz = torch.cumsum(SOz - SNz, dim=0)
    valx = (wq * vx * invvol) * 0.5 * (SOz + SNz)
    valy = (wq * vy * invvol) * 0.5 * (SOz + SNz)
    valz = (wq / dt) * CUMz
    iz = _tap_idx(i0z, order + 3, shape[0], wrap, offset)
    for j, v in zip(j3, (valx, valy, valz)):
        _scatter_add_(j, [iz], v)


def _blocks(j3, shape, like):
    return j3 if j3 is not None else tuple(
        torch.zeros(shape, dtype=like.dtype, device=like.device)
        for _ in range(3))


def deposit_current_direct(
    positions: Sequence[torch.Tensor],
    ux, uy, uz, w,
    q: float,
    geom,
    staggering: dict,
    dt: float,
    order: int,
    relative_time: float | None = None,
    origin=None,
    wrap: bool = True,
    offset: int = 0,
    out_shape=None,
    chunk_size: int | None = None,
    out=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Direct deposition of J = q w v onto the staggered Yee J sites from
    the position x + relative_time * v (``warpx_tpu.ops.deposit.
    deposit_current_direct``; the default -dt/2 is the midpoint of the step
    just pushed).  ``out`` is added to in place and returned."""
    if relative_time is None:
        relative_time = -0.5 * dt
    ndim = geom.ndim
    shape = tuple(out_shape or geom.n_cell)
    lo = geom.prob_lo if origin is None else origin
    invvol = 1.0 / geom.cell_volume
    j3 = _blocks(out, shape, w)
    for sl in _chunks(w.shape[0], chunk_size):
        gaminv = inv_gamma(ux[sl], uy[sl], uz[sl])
        vels = (ux[sl] * gaminv, uy[sl] * gaminv, uz[sl] * gaminv)
        active_v = {3: vels, 2: (vels[0], vels[2]), 1: (vels[2],)}[ndim]
        coords = [(positions[d][sl] - lo[d] + relative_time * active_v[d])
                  / geom.dx[d] for d in range(ndim)]
        for target, comp, vcomp in zip(j3, ("jx", "jy", "jz"), vels):
            flags = staggering[comp]
            idx1, weights = [], []
            for d in range(ndim):
                xd = coords[d] - 0.5 if flags[d] == 0 else coords[d]
                i0, ws = shape_weights(xd, order)
                idx1.append(_tap_idx(i0, order + 1, shape[d], wrap, offset))
                weights.append(ws)
            wqv = q * w[sl] * vcomp * invvol
            vals, idxs = [], []
            for taps in itertools.product(*[range(order + 1)] * ndim):
                val = wqv
                for d in range(ndim):
                    val = val * weights[d][taps[d]]
                vals.append(val)
                idxs.append([idx1[d][taps[d]] for d in range(ndim)])
            _scatter_add_(
                target,
                [torch.stack([ix[d] for ix in idxs], dim=0)
                 for d in range(ndim)],
                torch.stack(vals, dim=0))
    return j3


def deposit_current_vay(
    positions: Sequence[torch.Tensor],
    ux, uy, uz, w,
    q: float,
    geom,
    dt: float,
    order: int,
    origin=None,
    wrap: bool = True,
    offset: int = 0,
    out_shape=None,
    chunk_size: int | None = None,
    out=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vay deposition (PSATD only; ``warpx_tpu.ops.deposit.
    deposit_current_vay``): the NODAL D arrays whose k-space division by
    i k gives the charge-conserving J (the division is
    ``PsatdSolver.push``'s).  ``positions`` are x^{n+1}; x^n is
    reconstructed as x^{n+1} - dt v.  2D XZ and 3D."""
    ndim = geom.ndim
    if ndim == 1:
        raise NotImplementedError("Vay deposition not implemented in 1D")
    shape = tuple(out_shape or geom.n_cell)
    lo = geom.prob_lo if origin is None else origin
    invvol = 1.0 / geom.cell_volume
    taps_n = order + 3
    d3 = _blocks(out, shape, w)
    for sl in _chunks(w.shape[0], chunk_size):
        gaminv = inv_gamma(ux[sl], uy[sl], uz[sl])
        vel3 = (ux[sl] * gaminv, uy[sl] * gaminv, uz[sl] * gaminv)
        wq = (q * w[sl]) * invvol
        f = wq * (1.0 / dt)
        i0s, SN, SO = [], [], []
        for d in range(ndim):
            v_act = vel3[d] if ndim == 3 else vel3[(0, 2)[d]]
            xn = (positions[d][sl] - lo[d]) / geom.dx[d]
            xo = xn - v_act * dt / geom.dx[d]
            i0, s_new, s_old = esirkepov_weights(xn, xo, order)
            i0s.append(_tap_idx(i0, taps_n, shape[d], wrap, offset))
            SN.append(torch.stack(s_new, dim=0))
            SO.append(torch.stack(s_old, dim=0))
        if ndim == 3:
            def outer(a, b, c):
                return (a[:, None, None, :] * b[None, :, None, :]
                        * c[None, None, :, :])

            SNx, SNy, SNz = SN
            SOx, SOy, SOz = SO
            t0 = f * (outer(SNx, SNy, SNz) - outer(SOx, SOy, SOz))
            t1 = f * (outer(SNx, SNy, SOz) - outer(SOx, SOy, SNz))
            t2 = f * (outer(SNx, SOy, SNz) - outer(SOx, SNy, SOz))
            t3 = f * (outer(SOx, SNy, SNz) - outer(SNx, SOy, SOz))
            vals = ((2 * t0 + t1 + t2 - 2 * t3) / 6.0,
                    (2 * t0 + t1 - 2 * t2 + t3) / 6.0,
                    (2 * t0 - 2 * t1 + t2 + t3) / 6.0)
            ix, iy, iz = i0s
            idx = [torch.broadcast_to(ix[:, None, None, :], t0.shape),
                   torch.broadcast_to(iy[None, :, None, :], t0.shape),
                   torch.broadcast_to(iz[None, None, :, :], t0.shape)]
        else:
            # 2D XZ: Dy is the direct deposit of wq*vy on averaged shapes
            SNx, SNz = SN
            SOx, SOz = SO
            t0 = f * (SNx[:, None, :] * SNz[None, :, :]
                      - SOx[:, None, :] * SOz[None, :, :])
            t1 = f * (SNx[:, None, :] * SOz[None, :, :]
                      - SOx[:, None, :] * SNz[None, :, :])
            vals = (0.5 * (t0 + t1),
                    (wq * vel3[1] * 0.25)
                    * ((SNx + SOx)[:, None, :] * (SNz + SOz)[None, :, :]),
                    0.5 * (t0 - t1))
            ix, iz = i0s
            idx = [torch.broadcast_to(ix[:, None, :], t0.shape),
                   torch.broadcast_to(iz[None, :, :], t0.shape)]
        for target, v in zip(d3, vals):
            _scatter_add_(target, idx, v)
    return d3
