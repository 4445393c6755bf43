"""Macroscopic Maxwell solver: media with conductivity, permittivity and
permeability.

The counterpart of ``warpx_tpu.solvers.macroscopic`` (reference:
MacroscopicEvolveE.cpp:180-300, MacroscopicProperties.H:137-192):

  E^{n+1} = alpha E^n + beta (curl(B/mu) - J)

with per-cell sigma, epsilon and mu:

  Lax-Wendroff  : alpha = (1 - f)/(1 + f), beta = dt/(eps (1 + f)), f = s dt/2e
  Backward Euler: alpha = 1/(1 + f),       beta = dt/(eps (1 + f)), f = s dt/e

The properties are cell-centered (MacroscopicProperties.cpp:121-131); sigma
and epsilon are averaged to each E component's staggered site, H = B/mu
divides by mu at the B component's own index.  The B update is the ordinary
Faraday law.  Yee and CKC E stencils on the staggered periodic grid, 2D XZ
and 3D.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..constants import ep0 as _ep0
from ..constants import mu0 as _mu0
from .yee import _down

__all__ = ["MacroscopicMedium", "evolve_e_macroscopic"]


def _cc_coords(geom):
    """Cell-center (x, y, z) coordinates over the grid (y = 0 in 2D, x = y
    = 0 in 1D)."""
    mesh = np.meshgrid(*[geom.cell_centers(d) for d in range(geom.ndim)],
                       indexing="ij")
    if geom.ndim == 3:
        return mesh[0], mesh[1], mesh[2]
    if geom.ndim == 2:
        return mesh[0], np.zeros_like(mesh[0]), mesh[1]
    return np.zeros_like(mesh[0]), np.zeros_like(mesh[0]), mesh[0]


def _avg_to(arr: torch.Tensor, e_flags) -> torch.Tensor:
    """A cell-centered array averaged to an E component's site: the two
    adjacent centers along each dim where the component is nodal (periodic
    wrap), as ablastr::coarsen::sample::Interp with cr = 1."""
    out = arr
    for d, flag in enumerate(e_flags):
        if flag == 1:
            out = 0.5 * (out + torch.roll(out, 1, d))
    return out


@dataclasses.dataclass(frozen=True)
class MacroscopicMedium:
    """The per-component alpha and beta coefficient arrays and 1/mu."""

    alpha: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    beta: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    inv_mu: torch.Tensor  # cell-centered

    @classmethod
    def create(cls, cfg, staggering, dtype=torch.float64,
               device="cpu") -> "MacroscopicMedium":
        """The medium of ``cfg``'s constant or parsed sigma, epsilon and mu
        (vacuum's values where unset); expressions evaluate in float64 on
        the host."""
        from ..utils.expression import compile_expression

        geom = cfg.geometry
        consts = dict(cfg.user_constants or ())
        kw = dict(dtype=dtype, device=device)

        def build(value, func, default):
            if func:
                fn = compile_expression(func, ("x", "y", "z"), consts)
                vals = torch.as_tensor(fn(*_cc_coords(geom)))
                return vals.to(**kw) * torch.ones(geom.n_cell, **kw)
            return torch.full(geom.n_cell, default if value is None
                              else value, **kw)

        sigma = build(cfg.macro_sigma, cfg.macro_sigma_function, 0.0)
        eps = build(cfg.macro_epsilon, cfg.macro_epsilon_function, _ep0)
        mu = build(cfg.macro_mu, cfg.macro_mu_function, _mu0)
        if float(eps.min()) <= 0.0:
            raise ValueError("macroscopic epsilon must be strictly positive")
        lax_wendroff = cfg.macroscopic_sigma_method == "laxwendroff"
        dt = cfg.dt
        alphas, betas = [], []
        for comp in ("Ex", "Ey", "Ez"):
            s = _avg_to(sigma, staggering[comp])
            e = _avg_to(eps, staggering[comp])
            if lax_wendroff:
                f = 0.5 * s * dt / e
                alphas.append((1.0 - f) / (1.0 + f))
            else:
                f = s * dt / e
                alphas.append(1.0 / (1.0 + f))
            betas.append(dt / (e * (1.0 + f)))
        return cls(alpha=tuple(alphas), beta=tuple(betas), inv_mu=1.0 / mu)


def evolve_e_macroscopic(fields, medium: MacroscopicMedium, geom,
                         dt: float):
    """E^{n+1} = alpha E^n + beta (curl(B/mu) - J) on the staggered mesh
    (CKC takes the same plain downward differences for E as Yee)."""
    del dt  # inside beta
    Hx = fields.Bx * medium.inv_mu
    Hy = fields.By * medium.inv_mu
    Hz = fields.Bz * medium.inv_mu
    jx, jy, jz = fields.jx, fields.jy, fields.jz
    ax_al, ay_al, az_al = medium.alpha
    ax_be, ay_be, az_be = medium.beta
    if geom.ndim == 3:
        idx, idy, idz = (1.0 / d for d in geom.dx)
        Ex = ax_al * fields.Ex + ax_be * (
            _down(Hz, 1, idy) - _down(Hy, 2, idz) - jx)
        Ey = ay_al * fields.Ey + ay_be * (
            _down(Hx, 2, idz) - _down(Hz, 0, idx) - jy)
        Ez = az_al * fields.Ez + az_be * (
            _down(Hy, 0, idx) - _down(Hx, 1, idy) - jz)
    elif geom.ndim == 2:  # (x, z); d/dy = 0
        idx, idz = (1.0 / d for d in geom.dx)
        Ex = ax_al * fields.Ex + ax_be * (-_down(Hy, 1, idz) - jx)
        Ey = ay_al * fields.Ey + ay_be * (
            _down(Hx, 1, idz) - _down(Hz, 0, idx) - jy)
        Ez = az_al * fields.Ez + az_be * (_down(Hy, 0, idx) - jz)
    else:  # (z); d/dx = d/dy = 0
        idz = 1.0 / geom.dx[0]
        Ex = ax_al * fields.Ex + ax_be * (-_down(Hy, 0, idz) - jx)
        Ey = ay_al * fields.Ey + ay_be * (_down(Hx, 0, idz) - jy)
        Ez = az_al * fields.Ez + az_be * (-jz)
    return fields.replace(Ex=Ex, Ey=Ey, Ez=Ez)
