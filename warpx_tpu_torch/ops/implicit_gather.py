"""Energy-conserving implicit field gather (Esirkepov-stencil variant).

The counterpart of ``warpx_tpu.ops.implicit_gather`` (reference:
doGatherShapeNEsirkepovStencilImplicit, FieldGather.H:446-860): the
fields are gathered with the same Esirkepov path weights that the
charge-conserving deposit uses over the n -> n+1 trajectory, which makes
the theta-implicit scheme conserve energy exactly at theta = 1/2 (Angus et
al., JCP 491 (2023)).

Per axis, over the T = order + 3 taps of the window:
  ov[t]  = cumsum(s_old - s_new)[t] / (x_new - x_old)   (its limit, the
           shape of one order less at t + 1/2, without motion; the JAX
           package takes 1 at every tap there: ROADMAP.md Queue C)
  av[t]  = (s_new + s_old)[t] / 2
  mix[t1, t2] = (sn1 sn2 + so1 so2) / 3 + (sn1 so2 + so1 sn2) / 6

3D:  Ex ~ ov_x mix_yz on the E window (nodal shape evaluations),
     Bx ~ ov_x mix_yz on the B window (shapes at coordinate - 1/2).
2D (XZ): Ex, Bz ~ ov_x av_z; Ey ~ mix_xz; Ez, Bx ~ av_x ov_z;
     By ~ mix at order - 1 on the half-shifted window.

The (T, T, T, n) weights of the 3D branch are built ``chunk_size``
particles at a time (a chunk's tensors only: at 128³ with 8.4 M particles
one whole tensor would take 4.3 GB in float64).  Periodic domains only.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .shapes import esirkepov_weights, spline

__all__ = ["gather_eb_implicit"]


def _weights(x_new, x_old, order):
    """(i0, sn, so, ov, av), the tap axis first: (T, n).  Where the
    particle does not move, ov takes the limit of cum / delta: the shape
    of one order less at the half-shifted node, S_{n-1}(x - i - 1/2)
    (the B-spline's derivative telescopes), whose taps sum to one."""
    i0, sn_l, so_l = esirkepov_weights(x_new, x_old, order)
    sn = torch.stack(sn_l, dim=0)
    so = torch.stack(so_l, dim=0)
    cum = torch.cumsum(so - sn, dim=0)
    delta = x_new - x_old
    still = delta == 0.0
    one = torch.ones((), dtype=delta.dtype, device=delta.device)
    if order >= 1:
        base = i0.to(x_new.dtype)
        limit = torch.stack([spline(x_new - (base + m) - 0.5, order - 1)
                             for m in range(order + 3)], dim=0)
    else:
        # order 0 (2D By's window) uses no ov
        limit = one
    ov = torch.where(still, limit, cum / torch.where(still, one, delta))
    av = 0.5 * (sn + so)
    return i0, sn, so, ov, av


def _mix(w1, w2):
    """(T1, T2, n) transverse Esirkepov mix of two ``_weights`` tuples."""
    sn1, so1, sn2, so2 = w1[1], w1[2], w2[1], w2[2]
    return ((sn1[:, None] * sn2[None, :] + so1[:, None] * so2[None, :]) / 3.0
            + (sn1[:, None] * so2[None, :] + so1[:, None] * sn2[None, :])
            / 6.0)


def _win_idx(i0, taps, n):
    ar = torch.arange(taps, device=i0.device, dtype=torch.int64)
    return torch.remainder(i0.long()[None, :] + ar[:, None], n)


def _chunks(n, chunk_size):
    if not chunk_size or n <= chunk_size:
        return [slice(0, n)]
    return [slice(a, min(n, a + chunk_size))
            for a in range(0, n, chunk_size)]


def _gather_3d(new_g, old_g, F, n_cell, order):
    taps = order + 3
    nx, ny, nz = n_cell
    we = [_weights(new_g[d], old_g[d], order) for d in range(3)]
    wb = [_weights(new_g[d] - 0.5, old_g[d] - 0.5, order) for d in range(3)]
    out = []
    for names, w3 in ((("Ex", "Ey", "Ez"), we), (("Bx", "By", "Bz"), wb)):
        ix, iy, iz = (_win_idx(w3[d][0], taps, n_cell[d]) for d in range(3))
        lin = ((ix[:, None, None, :] * ny + iy[None, :, None, :]) * nz
               + iz[None, None, :, :])
        ovx, ovy, ovz = w3[0][3], w3[1][3], w3[2][3]
        wx = ovx[:, None, None, :] * _mix(w3[1], w3[2])[None, :, :, :]
        wy = ovy[None, :, None, :] * _mix(w3[0], w3[2])[:, None, :, :]
        wz = ovz[None, None, :, :] * _mix(w3[0], w3[1])[:, :, None, :]
        for nm, wgt in zip(names, (wx, wy, wz)):
            vals = F[nm].reshape(-1)[lin]
            out.append(torch.sum(vals * wgt, dim=(0, 1, 2)))
    return out


def _gather_2d(new_g, old_g, F, n_cell, order):
    taps = order + 3
    nz = n_cell[1]
    wx = _weights(new_g[0], old_g[0], order)
    wz = _weights(new_g[1], old_g[1], order)
    ix = _win_idx(wx[0], taps, n_cell[0])
    iz = _win_idx(wz[0], taps, n_cell[1])

    def s2(field, wgt, ix_, iz_):
        vals = field.reshape(-1)[ix_[:, None, :] * nz + iz_[None, :, :]]
        return torch.sum(vals * wgt, dim=(0, 1))

    ovx, avx = wx[3], wx[4]
    ovz, avz = wz[3], wz[4]
    w_ex = ovx[:, None, :] * avz[None, :, :]
    w_ey = _mix(wx, wz)
    w_ez = avx[:, None, :] * ovz[None, :, :]
    ex = s2(F["Ex"], w_ex, ix, iz)
    bz = s2(F["Bz"], w_ex, ix, iz)
    ey = s2(F["Ey"], w_ey, ix, iz)
    ez = s2(F["Ez"], w_ez, ix, iz)
    bx = s2(F["Bx"], w_ez, ix, iz)
    # By: shapes of one order less on the half-shifted window
    # (FieldGather.H:561-566)
    tb = order + 2
    wxb = _weights(new_g[0] - 0.5, old_g[0] - 0.5, order - 1)
    wzb = _weights(new_g[1] - 0.5, old_g[1] - 0.5, order - 1)
    by = s2(F["By"], _mix(wxb, wzb), _win_idx(wxb[0], tb, n_cell[0]),
            _win_idx(wzb[0], tb, n_cell[1]))
    return [ex, ey, ez, bx, by, bz]


def _gather_1d(new_g, old_g, F, n_cell, order):
    """The 1D branch (JAX implicit_gather.py:184-198): Ex, Ey and Bz take
    the averaged shapes, Ez, Bx and By the running sums."""
    wz = _weights(new_g[0], old_g[0], order)
    iz = _win_idx(wz[0], order + 3, n_cell[0])
    ovz, avz = wz[3], wz[4]

    def s1(field, wgt):
        return torch.sum(field[iz] * wgt, dim=0)

    return [s1(F["Ex"], avz), s1(F["Ey"], avz), s1(F["Ez"], ovz),
            s1(F["Bx"], ovz), s1(F["By"], ovz), s1(F["Bz"], avz)]


def gather_eb_implicit(
    pos_n: Sequence[torch.Tensor],
    pos_nph: Sequence[torch.Tensor],
    field_arrays: dict,
    geom,
    order: int,
    chunk_size: int | None = None,
) -> Tuple[torch.Tensor, ...]:
    """(Ex..Bz) at the particles with the implicit Esirkepov-stencil
    weights.  ``pos_n``: the positions at time n; ``pos_nph``: at n+1/2
    (the new full position is 2 pos_nph - pos_n, FieldGather.H:488-494).
    Periodic domains only."""
    ndim = geom.ndim
    dx, lo = geom.dx, geom.prob_lo
    new_g = [(2.0 * pos_nph[d] - pos_n[d] - lo[d]) / dx[d]
             for d in range(ndim)]
    old_g = [(pos_n[d] - lo[d]) / dx[d] for d in range(ndim)]
    body = {1: _gather_1d, 2: _gather_2d, 3: _gather_3d}[ndim]
    parts = [body([g[sl] for g in new_g], [g[sl] for g in old_g],
                  field_arrays, geom.n_cell, order)
             for sl in _chunks(pos_n[0].shape[0], chunk_size)]
    if len(parts) == 1:
        return tuple(parts[0])
    return tuple(torch.cat([p[c] for p in parts]) for c in range(6))
