"""Background stopping: drag on a warm electron or ion background.

The counterpart of ``warpx_tpu.ops.stopping`` (reference:
Source/Particles/Collision/BackgroundStopping/BackgroundStopping.cpp):
on an electron background u is scaled by exp(-alpha dt) with the NRL
slowing-down rate in the low-velocity limit; on an ion background the
kinetic energy follows dW/dt = -alpha / sqrt(W), integrated exactly over
the step.  Deterministic: no draws.

Scaled units.  The JAX package's prefactors multiply q^2 q_e^2 ~ 7e-76 and
ep0^2 into tensors, under float32's smallest subnormal; here every SI
prefactor is one host float64 constant, the temperature stays in kelvin
and, on an ion background, the energy is in units of m c^2.
"""

from __future__ import annotations

import math

import torch

from ..constants import c as _c, ep0 as _ep0, kb as _kb, q_e as _q_e
from .mcc import background_xyz

__all__ = ["apply_background_stopping", "stopping_collision_update"]

_M_E = 9.1093837015e-31


def _loglambda(n, T_K, Zb: float):
    """The Coulomb logarithm log((12 pi / Zb) n lambda_D^3), lambda_D^2 =
    3 kb T ep0 / (n q_e^2) (the background mass cancels), written
    (kb T)^1.5 / sqrt(n) so that float32 holds its factors."""
    k = 3.0 * _kb * _ep0 / (_q_e * _q_e)
    return torch.log((12.0 * math.pi / Zb) * (k * T_K) ** 1.5
                     / torch.sqrt(n))


def apply_background_stopping(sp, ndim: int, t, *, q: float, m: float,
                              kind: str, M_bg: float, Z_bg: float, n_fn,
                              T_fn, dt: float):
    """One stopping step for one species; returns the updated species.
    ``n_fn``, ``T_fn``: the background density [m^-3] and temperature [K]
    as compiled f(x, y, z, t)."""
    x, y, z = background_xyz(sp, ndim)
    n_b = n_fn(x, y, z, t)
    T_K = T_fn(x, y, z, t)
    ll = _loglambda(n_b, T_K, abs(q / _q_e))
    if kind == "electrons":
        # BackgroundStopping.cpp:141-147: alpha = K n ll / T^1.5
        k = (math.sqrt(2.0) * q * q * _q_e * _q_e * math.sqrt(M_bg)
             / (12.0 * math.pi ** 1.5 * _ep0 ** 2 * m * _kb ** 1.5))
        alpha = k * n_b * ll / (T_K * torch.sqrt(T_K))
        scale = torch.exp(-alpha * dt)
    else:
        # BackgroundStopping.cpp:190-199, W in units of m c^2
        e0 = m * _c * _c
        k = (math.sqrt(2.0) * Z_bg * Z_bg * _q_e * _q_e * q * q
             * math.sqrt(m) / (8.0 * math.pi * _ep0 ** 2 * M_bg)
             / e0 ** 1.5)
        alpha = k * n_b * ll
        W0 = 0.5 * (sp.ux ** 2 + sp.uy ** 2 + sp.uz ** 2) * (1.0 / (_c * _c))
        W1 = torch.clamp(W0 ** 1.5 - 1.5 * alpha * dt, min=0.0) ** (2.0 / 3.0)
        pos = W0 > 0.0
        scale = torch.where(pos, torch.sqrt(W1 / torch.where(
            pos, W0, torch.ones_like(W0))), torch.zeros_like(W0))
    scale = torch.where(sp.alive, scale, torch.ones_like(scale))
    return sp.replace(ux=sp.ux * scale, uy=sp.uy * scale, uz=sp.uz * scale)


def stopping_collision_update(state, cfg, dt: float):
    """Every background_stopping collision of the configuration, in order,
    every step."""
    from ..utils.expression import compile_expression

    cols = [c for c in cfg.collisions if c.kind == "background_stopping"]
    if not cols:
        return state
    by_name = {s.name: s for s in cfg.species}
    species = dict(state.species)
    uc = dict(cfg.user_constants or ())
    for col in cols:
        sp_cfg = by_name[col.species[0]]
        M_bg = col.background_mass if col.background_mass > 0 else (
            _M_E if col.background_type == "electrons" else None)
        if M_bg is None:
            raise ValueError(
                f"{col.name}: background_mass required for ion stopping")
        species[sp_cfg.name] = apply_background_stopping(
            species[sp_cfg.name], cfg.geometry.ndim, state.time,
            q=sp_cfg.charge, m=sp_cfg.mass, kind=col.background_type,
            M_bg=M_bg, Z_bg=col.background_charge_state,
            n_fn=compile_expression(col.background_density,
                                    ("x", "y", "z", "t"), uc),
            T_fn=compile_expression(col.background_temperature,
                                    ("x", "y", "z", "t"), uc),
            dt=dt)
    return state.replace(species=species)
