"""NFluxPerCell particle injection from a plane.

The counterpart of ``warpx_tpu.core.flux_injection`` (reference:
PhysicalParticleContainer::AddPlasmaFlux:1570-1790): every step,
num_particles_per_cell macroparticles are emitted per surface cell with
weight flux * area_cell / ppc * dt, placed uniformly within the surface
cell, given a "gaussianflux" momentum along the plane's normal (u G(u - u_m),
drawn with the reference's two rejection schemes,
SampleGaussianFluxDistribution.H:32-80) and Gaussian momenta across it, and
flown by a random fraction of dt (:1759-1762).

Every number comes from a ``utils/draws.py`` source in the pattern of the
JAX package's keys: the injector splits 11 sources and uses them by the same
index (transverse positions 0-2, the flight 3, the normal momentum 4, the
tangential momenta from 5 on), and the rejection splits 48 more, two a
round, for all 24 rounds.  A slot that no round accepts keeps |u_m| + u_th,
the JAX package's fallback; the i-th new particle takes the i-th free slot,
and one past the last free slot is dropped without a word, as in the JAX
package (ROADMAP.md Queue C).  The weight factor area / ppc * dt is formed
in float64 on the host and rounded to the run's type once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants
from ..ops.emit import emit_targets, put_rows
from ..utils.expression import compile_expression

__all__ = ["make_flux_injector", "sample_gaussian_flux", "flux_capacity"]

_ROUNDS = 24  # rejection rounds (the acceptance of a round is high)
_AXES3 = {1: (2,), 2: (0, 2), 3: (0, 1, 2)}


def sample_gaussian_flux(draws, n: int, u_m: float, u_th: float,
                         dtype: torch.dtype, device) -> torch.Tensor:
    """generateGaussianFluxDist for ``n`` particles: u >= 0 with density
    ~ u G(u - u_m), the first accepted of _ROUNDS candidates a slot."""
    if u_th == 0.0:
        return torch.full((n,), u_m, dtype=dtype, device=device)
    abs_u_m = abs(u_m)
    keys = draws.split(2 * _ROUNDS)
    u = torch.full((n,), abs_u_m + u_th, dtype=dtype, device=device)
    done = torch.zeros(n, dtype=torch.bool, device=device)
    if abs_u_m < 0.6 * u_th:
        umsign = math.copysign(1.0, u_m) if u_m != 0.0 else 1.0
        approx_u_th = u_th / math.sqrt(1.0 - abs_u_m / u_th)
        pref = (abs_u_m / u_th) / (2.0 * u_th * u_th)
        for r in range(_ROUNDS):
            x1 = keys[2 * r].uniform((n,), dtype)
            cand = approx_u_th * torch.sqrt(2.0 * torch.log(1.0 / (1.0 - x1)))
            x2 = keys[2 * r + 1].uniform((n,), dtype)
            acc = x2 < torch.exp(-pref * (cand - umsign * u_th) ** 2)
            u = torch.where(acc & ~done, cand, u)
            done = done | acc
    else:
        approx_u_m = abs_u_m + u_th * u_th / abs_u_m
        inv_um = 1.0 / abs_u_m
        for r in range(_ROUNDS):
            cand = approx_u_m + u_th * keys[2 * r].normal((n,), dtype)
            x2 = keys[2 * r + 1].uniform((n,), dtype)
            acc = (cand > 0) & (
                x2 < cand * inv_um * torch.exp(1.0 - cand * inv_um))
            u = torch.where(acc & ~done, cand, u)
            done = done | acc
    return u


def _per_step_count(sp_cfg, geom):
    """(particles a step, the index of the normal among the active axes)."""
    axes = geom.axis_names
    d_n = axes.index(sp_cfg.flux_normal_axis)
    n_trans = math.prod(geom.n_cell[d] for d in range(geom.ndim) if d != d_n)
    return sp_cfg.num_particles_per_cell * n_trans, d_n


def flux_capacity(sp_cfg, geom, max_step: int) -> int:
    """The slots a whole run emits into."""
    n, _ = _per_step_count(sp_cfg, geom)
    return n * max(max_step, 1)


def make_flux_injector(sp_cfg, geom, dt: float, dtype: torch.dtype, device):
    """``inject(sp, t, draws) -> sp``: one step's emission of ``sp_cfg``
    at the time ``t`` into the species ``sp``, on ``device``."""
    ndim = geom.ndim
    npart, d_n = _per_step_count(sp_cfg, geom)
    ppc = sp_cfg.num_particles_per_cell
    trans_dims = [d for d in range(ndim) if d != d_n]
    w_fac = math.prod(geom.dx[d] for d in trans_dims) / ppc * dt
    xyz_i = {"x": 0, "y": 1, "z": 2}[sp_cfg.flux_normal_axis]
    u_means = (sp_cfg.ux, sp_cfg.uy, sp_cfg.uz)
    u_ths = (sp_cfg.ux_th, sp_cfg.uy_th, sp_cfg.uz_th)
    flux_fn = None
    if sp_cfg.flux_expr:
        flux_fn = compile_expression(sp_cfg.flux_expr, ("x", "y", "z", "t"),
                                     dict(sp_cfg.user_constants))
    # the lower corners of the transverse cells, ppc times each, in the
    # order of the JAX package's meshgrid (float64 on the host, then cast)
    mesh = np.meshgrid(*[np.arange(geom.n_cell[d]) for d in trans_dims],
                       indexing="ij")
    bases = [torch.from_numpy(
        np.repeat(m.reshape(-1), ppc).astype(float) * geom.dx[d]
        + geom.prob_lo[d]).to(device=device, dtype=dtype)
        for m, d in zip(mesh, trans_dims)]
    c2 = torch.full((), constants.c ** 2, dtype=dtype, device=device)
    everyone = torch.ones(npart, dtype=torch.bool, device=device)

    def inject(sp, t: float, draws):
        keys = draws.split(8 + 3)
        pos = [None] * ndim
        for i, d in enumerate(trans_dims):
            pos[d] = bases[i] + keys[i].uniform((npart,), dtype) * geom.dx[d]
        pos[d_n] = torch.full((npart,), sp_cfg.surface_flux_pos, dtype=dtype,
                              device=device)

        # momenta (units of c, then m/s)
        un = sample_gaussian_flux(keys[4], npart, u_means[xyz_i],
                                  u_ths[xyz_i], dtype, device)
        un = un * sp_cfg.flux_direction
        u3 = [None, None, None]
        ki = 5
        for a in range(3):
            if a == xyz_i:
                u3[a] = un * constants.c
            else:
                u3[a] = (u_means[a] + u_ths[a] * keys[ki].normal(
                    (npart,), dtype)) * constants.c
                ki += 1

        # the weight from the (space-time dependent) flux
        if flux_fn is not None:
            xyz = [torch.zeros(npart, dtype=dtype, device=device)] * 3
            for d, a in enumerate(_AXES3[ndim]):
                xyz[a] = pos[d]
            flux = torch.broadcast_to(
                torch.as_tensor(flux_fn(*xyz, t), device=device).to(dtype),
                (npart,))
        else:
            flux = torch.full((npart,), sp_cfg.flux, dtype=dtype,
                              device=device)
        w_new = flux * w_fac
        ok = w_new > 0
        if sp_cfg.flux_tmin >= 0 and not t >= sp_cfg.flux_tmin:
            ok = torch.zeros_like(ok)
        if sp_cfg.flux_tmax >= 0 and not t < sp_cfg.flux_tmax:
            ok = torch.zeros_like(ok)

        # the random flight within the step (UpdatePosition by t_fract)
        gam = torch.sqrt(1.0 + (u3[0] ** 2 + u3[1] ** 2 + u3[2] ** 2) / c2)
        t_fract = keys[3].uniform((npart,), dtype) * dt
        for d, a in enumerate(_AXES3[ndim]):
            pos[d] = pos[d] + u3[a] / gam * t_fract

        # the i-th particle into the i-th free slot; none past the last
        cap = sp.capacity
        free_idx, _ = emit_targets(everyone, ~sp.alive)
        tgt = torch.where(ok & (free_idx < cap), free_idx,
                          torch.full_like(free_idx, cap))
        out = sp.replace(w=put_rows(sp.w, tgt, w_new),
                         ux=put_rows(sp.ux, tgt, u3[0]),
                         uy=put_rows(sp.uy, tgt, u3[1]),
                         uz=put_rows(sp.uz, tgt, u3[2]),
                         alive=put_rows(sp.alive, tgt, True))
        return out.with_positions(ndim, [
            put_rows(p, tgt, v) for p, v in zip(sp.positions(ndim), pos)])

    return inject
