"""FDTD Maxwell updates on the staggered Yee mesh (periodic torus, 1D Z,
2D XZ and 3D).

The counterpart of ``warpx_tpu.solvers.yee`` (reference:
FiniteDifferenceSolver EvolveB.cpp:120-190, EvolveE.cpp:120-215,
CartesianYeeAlgorithm.H / CartesianCKCAlgorithm.H).  On the periodic
domain the guard-cell exchange is ``torch.roll``.

dB/dt = -curl E   (upward differences)
dE/dt = c^2 (curl B - mu0 J)   (downward differences)

On a collocated grid (``algo = "nodal"``) every difference is the
centered one of CartesianNodalAlgorithm.H, (F[i+1] - F[i-1]) / (2 dx).

With hyperbolic divergence cleaning the scalars F (nodal) and G
(cell-centered; nodal on a collocated grid) advance with ``evolve_f`` /
``evolve_g`` and feed back through ``add_grad_f`` / ``add_grad_g``
(EvolveF.cpp, EvolveG.cpp, EvolveE.cpp:218-240, EvolveB.cpp:192-209).
"""

from __future__ import annotations

import torch

from ..constants import c as _c
from ..constants import ep0 as _ep0
from ..constants import mu0 as _mu0
from ..core.state import FieldState

__all__ = [
    "evolve_b", "evolve_e", "compute_dt_yee", "compute_dt_ckc",
    "compute_div_e", "compute_div_b", "evolve_f", "evolve_g", "add_grad_f",
    "add_grad_g",
]

_c2 = _c * _c


def _up(F, axis, inv_d):
    return (torch.roll(F, -1, axis) - F) * inv_d


def _down(F, axis, inv_d):
    return (F - torch.roll(F, 1, axis)) * inv_d


def _centered(F, axis, inv_d):
    """The collocated grid's centered difference (CartesianNodalAlgorithm.H;
    JAX yee.py:136)."""
    return 0.5 * inv_d * (torch.roll(F, -1, axis) - torch.roll(F, 1, axis))


def _refuse(algo):
    raise NotImplementedError(
        f"field solver {algo!r} on the periodic curls (the JAX package "
        "runs plain Yee for it; ECT runs on the bounded step's cut "
        "cells; ROADMAP.md Queue C)"
    )


def compute_dt_ckc(geom, cfl: float) -> float:
    """CKC timestep (CartesianCKCAlgorithm.H ComputeMaxDt)."""
    return cfl * (min(geom.dx) / _c)


def compute_dt_yee(geom, cfl: float) -> float:
    """CFL timestep with the reference's rounding order
    (CartesianYeeAlgorithm.H:48-56, WarpXComputeDt.cpp)."""
    s = 0.0
    for d in geom.dx:
        s += 1.0 / (d * d)
    deltat = 1.0 / ((s ** 0.5) * _c)
    return cfl * deltat


def _ckc_coefs(geom):
    """Cole-Karkkainen-Cowan stencil coefficients
    (CartesianCKCAlgorithm.H:36-105)."""
    inv = [1.0 / d for d in geom.dx]
    delta = max(inv)
    if geom.ndim == 1:
        return {"alphaz": inv[0]}
    if geom.ndim == 2:
        rx, rz = (inv[0] / delta) ** 2, (inv[1] / delta) ** 2
        beta = 0.125
        return {
            "alphax": (1 - 2 * rz * beta) * inv[0],
            "alphaz": (1 - 2 * rx * beta) * inv[1],
            "betaxz": beta * rz * inv[0], "betazx": beta * rx * inv[1],
        }
    rx, ry, rz = [(v / delta) ** 2 for v in inv]
    beta = 0.125 * (1.0 - rx * ry * rz / (ry * rz + rz * rx + rx * ry))
    inv_r = 1.0 / (ry * rz + rz * rx + rx * ry)
    gx = ry * rz * (0.0625 - 0.125 * ry * rz * inv_r)
    gy = rx * rz * (0.0625 - 0.125 * rx * rz * inv_r)
    gz = rx * ry * (0.0625 - 0.125 * rx * ry * inv_r)
    return {
        "alphax": (1 - 2 * ry * beta - 2 * rz * beta - 4 * gx) * inv[0],
        "alphay": (1 - 2 * rx * beta - 2 * rz * beta - 4 * gy) * inv[1],
        "alphaz": (1 - 2 * rx * beta - 2 * ry * beta - 4 * gz) * inv[2],
        "betaxy": ry * beta * inv[0], "betaxz": rz * beta * inv[0],
        "betayx": rx * beta * inv[1], "betayz": rz * beta * inv[1],
        "betazx": rx * beta * inv[2], "betazy": ry * beta * inv[2],
        "gammax": gx * inv[0], "gammay": gy * inv[1], "gammaz": gz * inv[2],
    }


def _up_ckc(F, daxis, coefs):
    """CKC extended upward difference along array axis ``daxis``."""
    if F.ndim == 1:
        return coefs["alphaz"] * (torch.roll(F, -1, 0) - F)
    if F.ndim == 2:
        other = 1 - daxis
        base = torch.roll(F, -1, daxis) - F
        beta = coefs["betaxz"] if daxis == 0 else coefs["betazx"]
        return coefs["alpha" + "xz"[daxis]] * base + beta * (
            torch.roll(base, -1, other) + torch.roll(base, 1, other)
        )
    a, b = [ax for ax in range(3) if ax != daxis]
    name = "xyz"[daxis]
    alpha = coefs["alpha" + name]
    beta_a = coefs["beta" + name + "xyz"[a]]
    beta_b = coefs["beta" + name + "xyz"[b]]
    gamma = coefs["gamma" + name]
    base = torch.roll(F, -1, daxis) - F
    term = alpha * base
    term = term + beta_a * (torch.roll(base, -1, a) + torch.roll(base, 1, a))
    term = term + beta_b * (torch.roll(base, -1, b) + torch.roll(base, 1, b))
    term = term + gamma * (
        torch.roll(torch.roll(base, -1, a), -1, b)
        + torch.roll(torch.roll(base, 1, a), -1, b)
        + torch.roll(torch.roll(base, -1, a), 1, b)
        + torch.roll(torch.roll(base, 1, a), 1, b)
    )
    return term


def evolve_b(fields: FieldState, geom, dt: float,
             algo: str = "yee") -> FieldState:
    Ex, Ey, Ez = fields.Ex, fields.Ey, fields.Ez
    if algo == "ckc":
        coefs = _ckc_coefs(geom)

        def up(F, axis):
            return _up_ckc(F, axis, coefs)
    elif algo in ("yee", "nodal"):
        inv = [1.0 / d for d in geom.dx]
        diff = _up if algo == "yee" else _centered

        def up(F, axis):
            return diff(F, axis, inv[axis])
    else:
        _refuse(algo)
    if geom.ndim == 1:  # axis (z); d/dx = d/dy = 0
        Bx = fields.Bx + dt * up(Ey, 0)
        By = fields.By - dt * up(Ex, 0)
        Bz = fields.Bz
    elif geom.ndim == 2:  # axes (x, z); d/dy = 0
        Bx = fields.Bx + dt * up(Ey, 1)
        By = fields.By + dt * (up(Ez, 0) - up(Ex, 1))
        Bz = fields.Bz - dt * up(Ey, 0)
    else:
        Bx = fields.Bx + dt * (up(Ey, 2) - up(Ez, 1))
        By = fields.By + dt * (up(Ez, 0) - up(Ex, 2))
        Bz = fields.Bz + dt * (up(Ex, 1) - up(Ey, 0))
    return fields.replace(Bx=Bx, By=By, Bz=Bz)


def evolve_e(fields: FieldState, geom, dt: float,
             algo: str = "yee") -> FieldState:
    """E update; CKC uses the plain Yee downward differences for E, a
    collocated grid the centered ones."""
    if algo not in ("yee", "ckc", "nodal"):
        _refuse(algo)
    d = _centered if algo == "nodal" else _down
    Bx, By, Bz = fields.Bx, fields.By, fields.Bz
    jx, jy, jz = fields.jx, fields.jy, fields.jz
    k = _c2 * dt
    if geom.ndim == 1:
        idz = 1.0 / geom.dx[0]
        Ex = fields.Ex + k * (-d(By, 0, idz) - _mu0 * jx)
        Ey = fields.Ey + k * (d(Bx, 0, idz) - _mu0 * jy)
        Ez = fields.Ez + k * (-_mu0 * jz)
        return fields.replace(Ex=Ex, Ey=Ey, Ez=Ez)
    if geom.ndim == 2:
        idx, idz = (1.0 / d_ for d_ in geom.dx)
        Ex = fields.Ex + k * (-d(By, 1, idz) - _mu0 * jx)
        Ey = fields.Ey + k * (d(Bx, 1, idz) - d(Bz, 0, idx) - _mu0 * jy)
        Ez = fields.Ez + k * (d(By, 0, idx) - _mu0 * jz)
        return fields.replace(Ex=Ex, Ey=Ey, Ez=Ez)
    idx, idy, idz = (1.0 / d_ for d_ in geom.dx)
    Ex = fields.Ex + k * (d(Bz, 1, idy) - d(By, 2, idz) - _mu0 * jx)
    Ey = fields.Ey + k * (d(Bx, 2, idz) - d(Bz, 0, idx) - _mu0 * jy)
    Ez = fields.Ez + k * (d(By, 0, idx) - d(Bx, 1, idy) - _mu0 * jz)
    return fields.replace(Ex=Ex, Ey=Ey, Ez=Ez)


def compute_div_e(fields: FieldState, geom) -> torch.Tensor:
    """Nodal div(E) (ComputeDivE.cpp; downward differences onto nodes)."""
    if geom.ndim == 1:
        return _down(fields.Ez, 0, 1.0 / geom.dx[0])
    if geom.ndim == 2:
        idx, idz = (1.0 / d for d in geom.dx)
        return _down(fields.Ex, 0, idx) + _down(fields.Ez, 1, idz)
    idx, idy, idz = (1.0 / d for d in geom.dx)
    return (
        _down(fields.Ex, 0, idx)
        + _down(fields.Ey, 1, idy)
        + _down(fields.Ez, 2, idz)
    )


def compute_div_b(fields: FieldState, geom) -> torch.Tensor:
    """Cell-centered div(B) (upward differences from faces to centers)."""
    if geom.ndim == 1:
        return _up(fields.Bz, 0, 1.0 / geom.dx[0])
    if geom.ndim == 2:
        idx, idz = (1.0 / d for d in geom.dx)
        return _up(fields.Bx, 0, idx) + _up(fields.Bz, 1, idz)
    idx, idy, idz = (1.0 / d for d in geom.dx)
    return (
        _up(fields.Bx, 0, idx) + _up(fields.By, 1, idy)
        + _up(fields.Bz, 2, idz)
    )


def _pick(algo: str, staggered):
    """The difference of a cleaning term: ``staggered`` (upward or
    downward) on the staggered grid, centered on a collocated one."""
    return _centered if algo == "nodal" else staggered


def _div(fields: FieldState, names, geom, diff):
    inv = [1.0 / d for d in geom.dx]
    comps = [getattr(fields, nm) for nm in names]
    if geom.ndim == 1:
        return diff(comps[2], 0, inv[0])
    if geom.ndim == 2:
        return diff(comps[0], 0, inv[0]) + diff(comps[2], 1, inv[1])
    return (diff(comps[0], 0, inv[0]) + diff(comps[1], 1, inv[1])
            + diff(comps[2], 2, inv[2]))


def evolve_f(F, fields: FieldState, rho, geom, dt: float,
             algo: str = "yee"):
    """div E cleaning scalar: F += dt (div E - rho/eps0) (EvolveF.cpp:
    119-126; F is nodal on the staggered grid)."""
    div = _div(fields, ("Ex", "Ey", "Ez"), geom, _pick(algo, _down))
    return F + dt * (div - rho / _ep0)


def evolve_g(G, fields: FieldState, geom, dt: float, algo: str = "yee"):
    """div B cleaning scalar: G += c^2 dt div B (EvolveG.cpp:108-112; G is
    cell-centered on the staggered grid)."""
    return G + _c2 * dt * _div(fields, ("Bx", "By", "Bz"), geom,
                               _pick(algo, _up))


def add_grad_f(fields: FieldState, F, geom, dt: float,
               algo: str = "yee") -> FieldState:
    """The charge-conservation correction E += c^2 dt grad F
    (EvolveE.cpp:218-240)."""
    up = _pick(algo, _up)
    inv = [1.0 / d for d in geom.dx]
    k = _c2 * dt
    if geom.ndim == 1:
        return fields.replace(Ez=fields.Ez + k * up(F, 0, inv[0]))
    if geom.ndim == 2:
        return fields.replace(Ex=fields.Ex + k * up(F, 0, inv[0]),
                              Ez=fields.Ez + k * up(F, 1, inv[1]))
    return fields.replace(Ex=fields.Ex + k * up(F, 0, inv[0]),
                          Ey=fields.Ey + k * up(F, 1, inv[1]),
                          Ez=fields.Ez + k * up(F, 2, inv[2]))


def add_grad_g(fields: FieldState, G, geom, dt: float,
               algo: str = "yee") -> FieldState:
    """The div B correction B += dt grad G (EvolveB.cpp:192-209)."""
    down = _pick(algo, _down)
    inv = [1.0 / d for d in geom.dx]
    if geom.ndim == 1:
        return fields.replace(Bz=fields.Bz + dt * down(G, 0, inv[0]))
    if geom.ndim == 2:
        return fields.replace(Bx=fields.Bx + dt * down(G, 0, inv[0]),
                              Bz=fields.Bz + dt * down(G, 1, inv[1]))
    return fields.replace(Bx=fields.Bx + dt * down(G, 0, inv[0]),
                          By=fields.By + dt * down(G, 1, inv[1]),
                          Bz=fields.Bz + dt * down(G, 2, inv[2]))
