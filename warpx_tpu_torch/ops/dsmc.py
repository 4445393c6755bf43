"""DSMC binary collisions between kinetic species.

The counterpart of ``warpx_tpu.ops.dsmc`` (reference:
Source/Particles/Collision/BinaryCollision/DSMC/DSMCFunc.H,
SplitAndScatterFunc.H): the pairs of the fusion module collide with
probability 1 - exp(-mult_ratio w_max sigma_tot(E_COM) v_rel dt / dV), then
scatter by one of the configured processes, picked in proportion to its
partial cross section:

  * elastic (and any other kind but back and charge exchange): isotropic
    redirection of the COM momentum;
  * back: reversal of the COM momentum;
  * charge_exchange: the partners' velocities swapped.

Cross sections are (energy [eV], sigma [m^2]) tables, linear in between,
zero below the first energy and the last value above it.  Unequal weights:
each partner takes its update with probability w_other / w_max.

Where a cell holds more species-1 than species-2 particles, several pairs
share one species-2 partner and all of them write it; as on the JAX
package's CPU run, the last pair in the (cell, random) order wins, the
old momentum too when that pair did not collide (``collisions.
last_writers``; ROADMAP.md Queue C).  Scaled units as in
``ops/collisions.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import c as _c
from .collisions import last_writers, pair_arrays, put_last, tiny
from .fusion import collision_parameters, isotropic

__all__ = ["dsmc_collision_update", "load_cross_section", "interp_sigma",
           "com_scatter"]


def load_cross_section(path: str):
    """(energies [eV], sigmas [m^2]) from a two-column whitespace table."""
    data = np.loadtxt(path)
    return np.asarray(data[:, 0], float), np.asarray(data[:, 1], float)


def interp_sigma(E_eV, energies, sigmas):
    """``jnp.interp(E_eV, energies, sigmas, left=0, right=sigmas[-1])``."""
    xp = torch.as_tensor(np.asarray(energies, float), dtype=E_eV.dtype,
                         device=E_eV.device)
    fp = torch.as_tensor(np.asarray(sigmas, float), dtype=E_eV.dtype,
                         device=E_eV.device)
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, E_eV, right=True), 1, n - 1)
    dx = xp[i] - xp[i - 1]
    delta = E_eV - xp[i - 1]
    f = torch.where(dx == 0, fp[i], fp[i - 1] + delta / torch.where(
        dx == 0, torch.ones_like(dx), dx) * (fp[i] - fp[i - 1]))
    f = torch.where(E_eV < xp[0], torch.zeros_like(f), f)
    return torch.where(E_eV > xp[-1], fp[-1].expand_as(f), f)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def com_scatter(u1, m1, u2, m2, key, mode):
    """Scatter the pairs in their COM frame, keeping |p*| (elastic: an
    isotropic direction from ``key``; back: reversed).  Returns the new
    (u1, u2) in m/s (Perez 2012 eqs. 12-13, in units of c and m1)."""
    mu = m2 / m1
    a = tuple(x * (1.0 / _c) for x in u1)
    b = tuple(x * (1.0 / _c) for x in u2)
    g1 = torch.sqrt(1.0 + _dot(a, a))
    g2 = torch.sqrt(1.0 + _dot(b, b))
    p_tot = tuple(x + mu * y for x, y in zip(a, b))
    mass_g = g1 + mu * g2
    vc = tuple(p / mass_g for p in p_tot)
    gc = 1.0 / torch.sqrt(torch.clamp(1.0 - _dot(vc, vc), min=1e-30))
    # (gc - 1) / vc^2 = gc^2 / (1 + gc) in units of c
    h = gc * gc / (1.0 + gc)
    fac = h * _dot(vc, a) - gc * g1
    p1s = tuple(p + v * fac for p, v in zip(a, vc))
    if mode == "elastic":
        p1s_new = isotropic(key, torch.sqrt(_dot(p1s, p1s)))
    elif mode == "back":
        p1s_new = tuple(-p for p in p1s)
    else:
        raise ValueError(mode)
    g1s = torch.sqrt(1.0 + _dot(p1s_new, p1s_new))
    fac2 = h * _dot(vc, p1s_new) + g1s * gc
    p1 = tuple(p + v * fac2 for p, v in zip(p1s_new, vc))
    return (tuple(p * _c for p in p1),
            tuple((pt - p) * (_c / mu) for pt, p in zip(p_tot, p1)))


def dsmc_collision_update(state, cfg, col, dt: float, draws):
    """One DSMC collision step for the CollisionConfig ``col`` (kind
    'dsmc') on the numbers of ``draws`` (split as ``jax.random.split(key,
    7)``)."""
    geom = cfg.geometry
    by_name = {s.name: s for s in cfg.species}
    n1, n2 = col.species
    intra = n1 == n2
    sp1, sp2 = state.species[n1], state.species[n2]
    m1, m2 = by_name[n1].mass, by_name[n2].mass
    k_s1, k_s2, k_ev, k_pick, k_mom, k_a1, k_a2 = draws.split(7)
    origL, origS, mult_ratio, ok = pair_arrays(sp1, sp2, geom, k_s1, k_s2,
                                               intra)
    u1 = (sp1.ux[origL], sp1.uy[origL], sp1.uz[origL])
    u2 = (sp2.ux[origS], sp2.uy[origS], sp2.uz[origS])
    w1, w2 = sp1.w[origL], sp2.w[origS]
    E_keV, v_rel, lab2com = collision_parameters(u1, u2, m1, m2)
    E_eV = E_keV * 1e3
    sigmas = [interp_sigma(E_eV, p.energies, p.sigmas)
              for p in col.processes]
    sigma_tot = sum(sigmas) if sigmas else torch.zeros_like(E_eV)
    w_max = torch.maximum(w1, w2)
    prob = -torch.expm1(-(sigma_tot * (v_rel * (dt / geom.cell_volume)))
                        * (mult_ratio.to(w1.dtype) * w_max * lab2com))
    collide = ok & (k_ev.uniform(prob.shape, prob.dtype) < prob)

    # the process, in proportion to its partial cross section
    pick = k_pick.uniform(prob.shape, prob.dtype) * torch.clamp(
        sigma_tot, min=tiny(w1.dtype))
    u1n, u2n = u1, u2
    acc = torch.zeros_like(sigma_tot)
    for p, sg in zip(col.processes, sigmas):
        sel = collide & (pick >= acc) & (pick < acc + sg)
        acc = acc + sg
        if p.kind == "charge_exchange":
            c1n, c2n = u2, u1
        else:
            mode = "back" if p.kind == "back" else "elastic"
            c1n, c2n = com_scatter(
                u1, m1, u2, m2,
                k_mom.fold_in({"elastic": 1, "back": 2}.get(p.kind, 3)),
                mode)
        u1n = tuple(torch.where(sel, x, y) for x, y in zip(c1n, u1n))
        u2n = tuple(torch.where(sel, x, y) for x, y in zip(c2n, u2n))

    # unequal weights: each partner updates with probability w_other / w_max
    upd1 = collide & (k_a1.uniform(prob.shape, prob.dtype) < w2 / w_max)
    upd2 = collide & (k_a2.uniform(prob.shape, prob.dtype) < w1 / w_max)

    # origL is a permutation of species 1's slots; origS repeats
    sp1n = sp1.replace(**{
        k: getattr(sp1, k).index_copy(0, origL, torch.where(
            upd1, v, getattr(sp1, k)[origL]))
        for k, v in zip(("ux", "uy", "uz"), u1n)})
    # intra-species the partners' writes land on the updated species
    base2 = sp1n if intra else sp2
    tgt = last_writers(origS, base2.capacity)
    sp2n = base2.replace(**{
        k: put_last(getattr(base2, k), tgt, torch.where(
            upd2, v, getattr(base2, k)[origS]))
        for k, v in zip(("ux", "uy", "uz"), u2n)})
    species = dict(state.species)
    species[n1] = sp1n
    species[n2] = sp2n
    return state.replace(species=species)
