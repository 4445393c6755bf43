"""Electrostatic field solvers: the Poisson solve and E = -grad(phi).

The counterpart of ``warpx_tpu.solvers.electrostatic`` (reference:
Source/FieldSolver/ElectrostaticSolvers/, ablastr/fields/PoissonSolver.H):
the reference's 2nd-order nodal Laplacian (MLNodeTensorLaplacian's 7-point
star) inverted directly by fast transforms, FFT along periodic dims and
DST-I (the odd sine transform, which diagonalizes the Dirichlet operator)
along bounded dims; the relativistic solver scales the operator by
(1 - beta_d^2) along each axis and adds B = beta x E / c.  The open-boundary
solve (``warpx.poisson_solver = fft``) convolves rho with the integrated
Green function on the doubled grid (Hockney-Eastwood).

The DST-I runs before the FFTs and its inverse after the inverse FFTs, on
real arrays.  The JAX package applies the transforms in axis order, so on a
box periodic along one axis and bounded along a later one its DST-I
receives the FFT's complex output and drops its imaginary part, and the
solution misses the operator by order one (ROADMAP.md Queue C); on boxes
bounded or periodic along every axis both orders agree to roundoff.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..constants import c as _c
from ..constants import ep0 as _ep0

__all__ = ["PoissonSolver", "phi_to_e", "phi_to_e_beta", "phi_to_b",
           "igf_greens_hat", "solve_open_igf", "vector_potential_b",
           "phi_to_e_nodal", "phi_to_b_nodal"]

_AXIS_OF = {1: {2: 0}, 2: {0: 0, 2: 1}, 3: {0: 0, 1: 1, 2: 2}}


def _dst1(arr: torch.Tensor, axis: int) -> torch.Tensor:
    """DST-I along ``axis`` by the FFT of the length 2(m+1) odd extension:
    X_k = sum_j x_j sin(pi (j+1)(k+1)/(m+1)) for m interior values."""
    m = arr.shape[axis]
    zshape = list(arr.shape)
    zshape[axis] = 1
    zero = arr.new_zeros(zshape)
    ext = torch.cat([zero, arr, zero, -torch.flip(arr, [axis])], dim=axis)
    F = torch.fft.fft(ext, dim=axis)
    return (-0.5) * F.narrow(axis, 1, m).imag


def _idst1(arr: torch.Tensor, axis: int) -> torch.Tensor:
    """The inverse DST-I: the DST-I itself times 2/(m+1)."""
    return _dst1(arr, axis) * (2.0 / (arr.shape[axis] + 1))


class PoissonSolver:
    """The direct Poisson solve on mixed periodic/Dirichlet boxes.

    rho and phi are nodal: n values along a periodic dim, n+1 along a
    bounded one with phi = 0 at the wall nodes (or the inhomogeneous
    values ``phi_b`` of ``solve``).  ``beta2`` scales the operator by
    (1 - beta_d^2) along each axis (the relativistic solve).  The operator
    is the reference's 7-point star (the JAX package's default 'cross'
    stencil; its 'fem' alternative has no caller)."""

    def __init__(self, geom, periodic: Sequence[bool],
                 beta2: Sequence[float] | None = None, dtype=torch.float64,
                 device="cpu"):
        self.geom = geom
        self.periodic = tuple(periodic)
        ndim = geom.ndim
        self._scale = tuple(beta2 or (0.0,) * ndim)
        total = 0.0
        for d in range(ndim):
            n = geom.n_cell[d]
            dx = geom.dx[d]
            if self.periodic[d]:
                theta = 2.0 * np.pi * np.arange(n) / n
            else:
                # interior nodes 1..n-1: n-1 Dirichlet modes
                theta = np.pi * np.arange(1, n) / n
            lam = ((2.0 - 2.0 * np.cos(theta)) / (dx * dx)
                   * (1.0 - self._scale[d]))
            shape = [1] * ndim
            shape[d] = lam.shape[0]
            total = total + lam.reshape(shape)
        kw = dict(dtype=dtype, device=device)
        self.denom = torch.as_tensor(np.where(total == 0.0, 1.0, total), **kw)
        self.zero_mask = torch.as_tensor(total == 0.0, device=device)

    def _conv3(self, arr, d, w):
        """The 3-point stencil (w_m, w_0, w_p) along d, zero outside a
        bounded dim (only interior outputs are read)."""
        if self.periodic[d]:
            am = torch.roll(arr, 1, d)
            ap = torch.roll(arr, -1, d)
        else:
            zshape = list(arr.shape)
            zshape[d] = 1
            z = arr.new_zeros(zshape)
            n = arr.shape[d]
            am = torch.cat([z, arr.narrow(d, 0, n - 1)], dim=d)
            ap = torch.cat([arr.narrow(d, 1, n - 1), z], dim=d)
        return w[0] * am + w[1] * arr + w[2] * ap

    def apply_op(self, phi: torch.Tensor) -> torch.Tensor:
        """The discrete operator L = -div(sigma grad) that ``solve``
        inverts, on a whole nodal array (valid at interior nodes)."""
        out = None
        for d in range(self.geom.ndim):
            s = (1.0 - self._scale[d]) / self.geom.dx[d] ** 2
            term = self._conv3(phi, d, (-s, 2.0 * s, -s))
            out = term if out is None else out + term
        return out

    def solve(self, rho: torch.Tensor,
              phi_b: torch.Tensor | None = None) -> torch.Tensor:
        """phi of the nodal rho; ``phi_b`` (whole shape, non-zero at the
        wall layers only) moves its operator image to the right-hand side
        and its wall values into the result."""
        ndim = self.geom.ndim
        bounded = [d for d in range(ndim) if not self.periodic[d]]
        periodic = [d for d in range(ndim) if self.periodic[d]]
        x = rho
        if phi_b is not None:
            x = x - _ep0 * self.apply_op(phi_b)
        for d in bounded:
            x = x.narrow(d, 1, self.geom.n_cell[d] - 1)
        for d in bounded:
            x = _dst1(x, d)
        for d in periodic:
            x = torch.fft.fft(x, dim=d)
        x = torch.where(self.zero_mask, torch.zeros((), dtype=x.dtype,
                                                     device=x.device),
                        (x / _ep0) / self.denom)
        for d in periodic:
            x = torch.fft.ifft(x, dim=d)
        if periodic:
            x = x.real
        for d in bounded:
            x = _idst1(x, d)
        if bounded:
            pad = [0, 0] * ndim
            for d in bounded:
                pad[2 * (ndim - 1 - d)] = pad[2 * (ndim - 1 - d) + 1] = 1
            x = torch.nn.functional.pad(x, pad)
        if phi_b is not None:
            x = x + phi_b
        return x


def _integrated_potential(x, y, z):
    """The closed-form integral of 1/|r| over a cell corner
    (IntegratedGreenFunctionSolver.H:37-50)."""
    r = torch.sqrt(x * x + y * y + z * z)
    return (-0.5 * z * z * torch.atan(x * y / (z * r))
            - 0.5 * y * y * torch.atan(x * z / (y * r))
            - 0.5 * x * x * torch.atan(y * z / (x * r))
            + y * z * torch.asinh(x / torch.sqrt(y * y + z * z))
            + x * z * torch.asinh(y / torch.sqrt(x * x + z * z))
            + x * y * torch.asinh(z / torch.sqrt(x * x + y * y)))


def igf_greens_hat(n_nodes, cell, dtype=torch.float64, device="cpu"):
    """The rfftn of the integrated Green function on the 2x zero-padding
    grid (IntegratedGreenFunctionSolver.cpp:140-190, mirror-symmetric
    fill).  ``n_nodes``: nodal extents; ``cell``: (dx, dy, dz), stretched
    by gamma for a relativistic solve (PoissonSolver.H:263-265).  Built and
    transformed in float64 on ``device`` once at set-up, then rounded to
    the complex type of ``dtype`` (complex64 for a float32 run)."""
    kw = dict(dtype=torch.float64, device=device)
    dists = []
    for n, d in zip(n_nodes, cell):
        i = torch.arange(2 * n, **kw)
        dists.append(torch.minimum(i, 2 * n - i) * d)
    X = dists[0][:, None, None]
    Y = dists[1][None, :, None]
    Z = dists[2][None, None, :]
    dx, dy, dz = cell
    G = torch.zeros(tuple(2 * n for n in n_nodes), **kw)
    for sx in (+1, -1):
        for sy in (+1, -1):
            for sz in (+1, -1):
                G += (sx * sy * sz) * _integrated_potential(
                    X + sx * 0.5 * dx, Y + sy * 0.5 * dy, Z + sz * 0.5 * dz)
    G *= 1.0 / (4.0 * np.pi * _ep0)
    ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
    return torch.fft.rfftn(G).to(ctype)


def solve_open_igf(rho: torch.Tensor, g_hat: torch.Tensor) -> torch.Tensor:
    """The open-boundary (free-space) Poisson solve: the zero-padded FFT
    convolution of rho with the integrated Green function (Hockney-
    Eastwood)."""
    nx, ny, nz = rho.shape
    full = (2 * nx, 2 * ny, 2 * nz)
    pad = rho.new_zeros(full)
    pad[:nx, :ny, :nz] = rho
    phi = torch.fft.irfftn(torch.fft.rfftn(pad) * g_hat, s=full)
    return phi[:nx, :ny, :nz].to(rho.dtype)


def _stag_diff(phi, d, dx, periodic):
    """The staggered first difference of nodal phi along d (n+1 -> n in a
    bounded dim; rolled in a periodic one)."""
    if periodic:
        return (torch.roll(phi, -1, d) - phi) / dx
    n = phi.shape[d]
    return (phi.narrow(d, 1, n - 1) - phi.narrow(d, 0, n - 1)) / dx


def _avg(arr, d, periodic):
    """Adjacent values along d averaged (node -> center)."""
    if periodic:
        return 0.5 * (arr + torch.roll(arr, -1, d))
    n = arr.shape[d]
    return 0.5 * (arr.narrow(d, 1, n - 1) + arr.narrow(d, 0, n - 1))


def phi_to_e_beta(phi, geom, periodic, beta):
    """E = -(1 - beta beta^T) grad(phi) at the staggered E sites
    (ElectrostaticSolver.cpp computeE:255-330)."""
    ndim = geom.ndim
    out = []
    for d in range(ndim):
        e = -(1.0 - beta[d] * beta[d]) * _stag_diff(phi, d, geom.dx[d],
                                                     periodic[d])
        for dp in range(ndim):
            if dp == d or beta[d] * beta[dp] == 0.0:
                continue
            g = _avg(_stag_diff(phi, dp, geom.dx[dp], periodic[dp]), d,
                     periodic[d])
            if not periodic[dp]:
                # back to the nodal extent along dp by repeating the edge
                g = torch.cat([g.narrow(dp, 0, 1), g], dim=dp)
            else:
                g = 0.5 * (g + torch.roll(g, 1, dp))
            e = e - beta[d] * beta[dp] * g
        out.append(e)
    return out


def _b_of_grads(grad_at, beta):
    """B_i = (-beta_j d_k(phi) + beta_k d_j(phi)) / c for (i, j, k) cyclic,
    the components without a term None."""
    out = {}
    for (i, j, k) in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        t1 = grad_at(i, k)
        t2 = grad_at(i, j)
        b = None
        if beta[j] != 0.0 and t1 is not None:
            b = -beta[j] * t1
        if beta[k] != 0.0 and t2 is not None:
            b = (0.0 if b is None else b) + beta[k] * t2
        out[i] = None if b is None else b / _c
    return out


def phi_to_b(phi, geom, periodic, beta):
    """B = -(beta x grad(phi))/c at the staggered B sites
    (ElectrostaticSolver.cpp computeB:384-460): {xyz index: array or
    None}; the gradients of inactive dims are zero."""
    axis_of = _AXIS_OF[geom.ndim]

    def grad_at(b_axis, g_axis):
        """d(phi)/d(g_axis) averaged to the B_{b_axis} site."""
        if g_axis not in axis_of:
            return None
        d = axis_of[g_axis]
        g = _stag_diff(phi, d, geom.dx[d], periodic[d])
        for other, od in axis_of.items():
            if other not in (b_axis, g_axis):
                g = _avg(g, od, periodic[od])
        return g

    return _b_of_grads(grad_at, beta)


def phi_to_e(phi: torch.Tensor, geom, periodic: Sequence[bool]):
    """The staggered E = -grad(phi) (ablastr computeE), active axes only:
    n values along the gradient's dim, phi's extent along the others."""
    return [-_stag_diff(phi, d, geom.dx[d], periodic[d])
            for d in range(geom.ndim)]


def vector_potential_b(A3, geom, periodic):
    """B = curl(A) from the nodal vector potential (indexed by xyz) onto the
    staggered B sites (MagnetostaticSolver.cpp)."""
    axis_of = _AXIS_OF[geom.ndim]

    def d_term(b_axis, a_axis, g_axis):
        """d(A_{a_axis})/d(g_axis) averaged to the B_{b_axis} site."""
        if g_axis not in axis_of:
            return None
        d = axis_of[g_axis]
        g = _stag_diff(A3[a_axis], d, geom.dx[d], periodic[d])
        for other, od in axis_of.items():
            if other not in (b_axis, g_axis):
                g = _avg(g, od, periodic[od])
        return g

    out = {}
    for (i, j, k) in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        t1 = d_term(i, k, j)  # dA_k/dx_j
        t2 = d_term(i, j, k)  # dA_j/dx_k
        b = t1
        if t2 is not None:
            b = -t2 if b is None else b - t2
        out[i] = b
    return out


def _centered_grad(phi, d, dx, periodic):
    """The centered gradient of nodal phi along d, phi's shape (one-sided
    at bounded walls): collocated grids."""
    if periodic:
        return (torch.roll(phi, -1, d) - torch.roll(phi, 1, d)) / (2.0 * dx)
    n = phi.shape[d]
    interior = (phi.narrow(d, 2, n - 2) - phi.narrow(d, 0, n - 2)) / (2.0 * dx)
    lo = (phi.narrow(d, 1, 1) - phi.narrow(d, 0, 1)) / dx
    hi = (phi.narrow(d, n - 1, 1) - phi.narrow(d, n - 2, 1)) / dx
    return torch.cat([lo, interior, hi], dim=d)


def phi_to_e_nodal(phi, geom, periodic, beta):
    """The collocated E = -(1 - b b^T) grad(phi), every component nodal."""
    ndim = geom.ndim
    grads = [_centered_grad(phi, d, geom.dx[d], periodic[d])
             for d in range(ndim)]
    out = []
    for d in range(ndim):
        e = -(1.0 - beta[d] * beta[d]) * grads[d]
        for dp in range(ndim):
            if dp != d and beta[d] * beta[dp] != 0.0:
                e = e - beta[d] * beta[dp] * grads[dp]
        out.append(e)
    return out


def phi_to_b_nodal(phi, geom, periodic, beta):
    """The collocated B = -(beta x grad phi)/c, every component nodal."""
    grads = {a: _centered_grad(phi, d, geom.dx[d], periodic[d])
             for a, d in _AXIS_OF[geom.ndim].items()}
    return _b_of_grads(lambda b_axis, g_axis: grads.get(g_axis), beta)
