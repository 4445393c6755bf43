"""Background Monte-Carlo collisions (MCC) against a neutral gas.

The counterpart of ``warpx_tpu.ops.mcc`` (reference: the null-collision MCC
of Source/Particles/Collision/BackgroundMCC/BackgroundMCCCollision.cpp and
ImpactIonization.H): every particle draws against the fixed total
collision probability 1 - exp(-nu_max dt), the colliding ones pick a
process by the cumulative normalized frequency, and scatter:

  * elastic and excitation: isotropic in the COM frame (after the
    excitation's energy penalty, a relativistic momentum rescale);
  * back: the COM velocity reversed;
  * charge_exchange: the sampled Maxwellian target's velocity taken;
  * ionization (its own pass): the source electron loses the ionization
    energy, shares the rest evenly with a secondary electron, both
    isotropic; the ion samples the background Maxwellian.  The k-th event
    (in slot order) puts its secondary into the k-th free slot of the
    electrons and its ion into the k-th free slot of the ions
    (``ops/emit.py``).

Cross sections are two-column (energy [eV], sigma [m^2]) tables on a
uniform energy grid (ScatteringProcess.cpp:96), clamped to the end values
outside it.  nu_max and the collision probabilities are host numbers
(numpy), as in the JAX package.

Scaled units, as in ``ops/collisions.py``: the JAX package's collision
energy forms m M ~ 6e-56 kg^2 for an electron on argon and its energy
rescale divides by c^2 past 1e-45, both under float32's smallest
subnormal; here velocities are in units of c, energies in units of m c^2
(m the colliding particle's mass), and gamma - 1 = u^2 / (1 + gamma).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..constants import c as _c, kb as _kb, q_e as _q_e
from .emit import emit_targets, put_rows

__all__ = ["load_cross_section", "mcc_nu_max", "total_collision_prob",
           "apply_mcc_scattering", "apply_mcc_ionization",
           "mcc_collision_update", "background_xyz"]


def load_cross_section(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a two-column cross-section file (energy eV, sigma m^2); the
    energy grid must be uniform (ScatteringProcess.cpp:96)."""
    data = np.loadtxt(path)
    if data.ndim != 2 or data.shape[1] < 2:
        raise ValueError(f"bad cross-section file {path!r}")
    e, s = data[:, 0].astype(float), data[:, 1].astype(float)
    de = np.diff(e)
    if de.size and not np.allclose(de, de[0], rtol=1e-5):
        raise ValueError(
            f"cross-section energy grid in {path!r} is not uniform")
    return e, s


def _sigma_at(E_eV, energies: Sequence[float], sigmas: Sequence[float]):
    """Clamped linear interpolation on the uniform energy grid
    (ScatteringProcess.H:81-99); the divisor is a 0-d tensor (see
    ``collisions.cell_of``)."""
    e_lo, e_hi = energies[0], energies[-1]
    n = len(energies)
    dE = (e_hi - e_lo) / (n - 1) if n > 1 else 1.0
    s = torch.as_tensor(np.asarray(sigmas, float), dtype=E_eV.dtype,
                        device=E_eV.device)
    dE_t = torch.tensor(dE, dtype=E_eV.dtype, device=E_eV.device)
    t = torch.clamp((E_eV - e_lo) / dE_t, 0.0, float(n - 1))
    i0 = torch.clamp(torch.floor(t).to(torch.int64), 0, max(n - 2, 0))
    frac = t - i0
    return s[i0] * (1.0 - frac) + s[torch.clamp(i0 + 1, max=n - 1)] * frac


def mcc_nu_max(processes, mass: float, max_density: float) -> float:
    """The host-side maximum collision frequency over the fixed energy
    sweep 1e-4..5000 eV in steps of 0.2 eV, widened by the tables' limits
    (BackgroundMCCCollision.cpp:165-206)."""
    E_start, E_end, E_step = 1e-4, 5000.0, 0.2
    for p in processes:
        E_start = min(E_start, p.energies[0])
        E_end = max(E_end, p.energies[-1])
        n = len(p.energies)
        if n > 1:
            E_step = min(E_step, (p.energies[-1] - p.energies[0]) / (n - 1))
    E = np.arange(E_start, E_end, E_step)
    sigma = np.zeros_like(E)
    for p in processes:
        en = np.asarray(p.energies)
        sg = np.asarray(p.sigmas)
        t = np.clip((E - en[0]) / ((en[-1] - en[0]) / (len(en) - 1)), 0,
                    len(en) - 1)
        i0 = np.clip(np.floor(t).astype(int), 0, max(len(en) - 2, 0))
        frac = t - i0
        sigma += sg[i0] * (1 - frac) + sg[np.minimum(i0 + 1,
                                                     len(en) - 1)] * frac
    nu = max_density * math.sqrt(2.0 / mass * _q_e) * sigma * np.sqrt(E)
    return float(nu.max()) if nu.size else 0.0


def total_collision_prob(nu_max: float, dt: float) -> float:
    return 1.0 - math.exp(-nu_max * dt)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _lorentz(u, V, sign=1.0):
    """The proper velocity ``u`` seen from a frame moving at ``V`` (both in
    units of c; ParticleUtils::doLorentzTransform); sign = -1 boosts back.
    (gamma_V - 1) / V^2 is written gamma_V^2 / (1 + gamma_V)."""
    V = tuple(sign * v for v in V)
    gV = 1.0 / torch.sqrt(1.0 - _dot(V, V))
    gu = torch.sqrt(1.0 + _dot(u, u))
    f = gV * gV / (1.0 + gV) * _dot(V, u) - gV * gu
    return tuple(x + f * v for x, v in zip(u, V))


def _random_unit(key, shape, dtype):
    """Isotropic unit vectors (ParticleUtils::getRandomVector)."""
    k1, k2 = key.split(2)
    ct = k1.uniform(shape, dtype, -1.0, 1.0)
    phi = k2.uniform(shape, dtype, 0.0, 2.0 * np.pi)
    st = torch.sqrt(1.0 - ct * ct)
    return st * torch.cos(phi), st * torch.sin(phi), ct


def background_xyz(sp, ndim: int):
    """(x, y, z) of every slot for the background expressions, the
    inactive axes at 0."""
    pos = sp.positions(ndim)
    out = [torch.zeros_like(sp.w)] * 3
    for a, arr in zip({1: (2,), 2: (0, 2), 3: (0, 1, 2)}[ndim], pos):
        out[a] = arr
    return out


def apply_mcc_scattering(key, sp, ndim: int, t, *, m: float, M: float,
                         processes, n_a_fn, T_a_fn, nu_max: float,
                         p_coll: float, dtype):
    """The particle-conserving MCC pass (elastic, back, charge exchange,
    excitation) on one species, on the numbers of ``key`` (split as
    ``jax.random.split(key, 5)``); returns the updated species.
    ``n_a_fn``, ``T_a_fn``: the background density [m^-3] and temperature
    [K] as compiled f(x, y, z, t)."""
    if not processes:
        return sp
    cap = sp.capacity
    keys = key.split(5)
    x, y, z = background_xyz(sp, ndim)
    n_a = n_a_fn(x, y, z, t)
    T_a = T_a_fn(x, y, z, t)
    mu = M / m

    collide = sp.alive & (keys[0].uniform((cap,), dtype) <= p_coll)
    # the target (neutral) velocity from the local Maxwellian, in units of
    # c (non-relativistic; BackgroundMCCCollision.cpp:384-391)
    vel_std = torch.sqrt(T_a * (_kb / (M * _c * _c)))
    na = keys[1].normal((3, cap), dtype)
    ua = (vel_std * na[0], vel_std * na[1], vel_std * na[2])
    u = tuple(c_ * (1.0 / _c) for c_ in (sp.ux, sp.uy, sp.uz))
    v = tuple(a - b for a, b in zip(u, ua))
    v2 = _dot(v, v)
    v_coll = torch.sqrt(v2)
    # the two-body collision energy (ParticleUtils::getCollisionEnergy)
    gamma = torch.sqrt(1.0 + v2)
    E_coll = (m * _c * _c / _q_e) * (
        2.0 * mu * v2 / (gamma + 1.0)
        / (1.0 + mu + torch.sqrt(1.0 + mu * mu + 2.0 * mu * gamma)))

    col_select = keys[2].uniform((cap,), dtype)
    nu_cum = torch.zeros(cap, dtype=dtype, device=sp.w.device)
    chosen = torch.full((cap,), -1, dtype=torch.int64, device=sp.w.device)
    for i, proc in enumerate(processes):
        sig = _sigma_at(E_coll, proc.energies, proc.sigmas)
        nu_cum = nu_cum + n_a * sig * v_coll * (_c / nu_max)
        newly = collide & (chosen < 0) & (col_select <= nu_cum)
        chosen = torch.where(newly, torch.full_like(chosen, i), chosen)

    # the COM velocity from the pre-penalty velocity, as the reference
    uCOM = tuple(x_ / (gamma + mu) for x_ in v)
    e = _random_unit(keys[3], (cap,), dtype)
    gm1 = v2 / (1.0 + gamma)  # gamma - 1 of the collision velocity
    new = (sp.ux, sp.uy, sp.uz)
    for i, proc in enumerate(processes):
        sel = chosen == i
        if proc.kind == "charge_exchange":
            new = tuple(torch.where(sel, a * _c, b) for a, b in zip(ua, new))
            continue
        w = v
        if proc.energy_penalty > 0.0:
            Ep = torch.clamp(gm1 - proc.energy_penalty * _q_e
                             / (m * _c * _c), min=0.0)
            scale = torch.sqrt(Ep * (Ep + 2.0)) / torch.where(
                v_coll == 0.0, torch.ones_like(v_coll), v_coll)
            w = tuple(x_ * scale for x_ in w)
        bvec = _lorentz(w, uCOM)
        if proc.kind == "back":
            bvec = tuple(-x_ for x_ in bvec)
        else:  # elastic, excitation: isotropic in the COM frame
            vp = torch.sqrt(_dot(bvec, bvec))
            bvec = tuple(x_ * vp for x_ in e)
        bvec = _lorentz(bvec, uCOM, sign=-1.0)
        new = tuple(torch.where(sel, (a + b) * _c, o)
                    for a, b, o in zip(bvec, ua, new))
    return sp.replace(ux=new[0], uy=new[1], uz=new[2])


def _emit(dst, src, ndim, u3, mask):
    """The k-th event of ``mask`` (slot order over ``src``) into the k-th
    free slot of ``dst``: the source's weight and position, the momentum
    ``u3``, runtime attributes zeroed."""
    tgt, placeable = emit_targets(mask, ~dst.alive)
    pos = [put_rows(p, tgt, s) for p, s in zip(dst.positions(ndim),
                                               src.positions(ndim))]
    out = dst.replace(
        w=put_rows(dst.w, tgt, src.w),
        ux=put_rows(dst.ux, tgt, u3[0]),
        uy=put_rows(dst.uy, tgt, u3[1]),
        uz=put_rows(dst.uz, tgt, u3[2]),
        alive=put_rows(dst.alive, tgt, placeable),
        extra={k: put_rows(v, tgt, 0) for k, v in dst.extra.items()},
    )
    return out.with_positions(ndim, pos)


def apply_mcc_ionization(key, sp_e, sp_ion, ndim: int, t, *, m: float,
                         M_bg: float, proc, n_a_fn, T_a_fn,
                         nu_max_ioniz: float, p_coll_ioniz: float, dtype):
    """The impact-ionization pass on the numbers of ``key`` (split as
    ``jax.random.split(key, 6)``): the source electrons lose the
    ionization energy, secondary electron and ion pairs are made
    (ImpactIonization.H).  Returns (electrons, ions)."""
    cap = sp_e.capacity
    keys = key.split(6)
    x, y, z = background_xyz(sp_e, ndim)
    n_a = n_a_fn(x, y, z, t)
    T_a = T_a_fn(x, y, z, t)

    candidate = sp_e.alive & (keys[0].uniform((cap,), dtype) <= p_coll_ioniz)
    u = tuple(c_ * (1.0 / _c) for c_ in (sp_e.ux, sp_e.uy, sp_e.uz))
    u2 = _dot(u, u)
    gm1 = u2 / (1.0 + torch.sqrt(1.0 + u2))
    mc2_eV = m * _c * _c / _q_e
    sig = _sigma_at(gm1 * mc2_eV, proc.energies, proc.sigmas)
    nu_i = n_a * sig * torch.sqrt(u2) * (_c / nu_max_ioniz)
    ionized = candidate & (keys[1].uniform((cap,), dtype) <= nu_i)

    # each outgoing electron carries half of what the ionization leaves
    E_out = torch.clamp((gm1 - proc.energy_penalty / mc2_eV) * 0.5, min=0.0)
    up = torch.sqrt(E_out * (E_out + 2.0)) * _c

    e1 = _random_unit(keys[2], (cap,), dtype)
    sp_new = sp_e.replace(**{
        k: torch.where(ionized, d * up, getattr(sp_e, k))
        for k, d in zip(("ux", "uy", "uz"), e1)})
    e2 = _random_unit(keys[3], (cap,), dtype)
    sec = tuple(d * up for d in e2)
    ion_std = torch.sqrt(T_a * (_kb / M_bg))
    ni = keys[4].normal((3, cap), dtype)
    ion = (ion_std * ni[0], ion_std * ni[1], ion_std * ni[2])
    sp_e = _emit(sp_new, sp_new, ndim, sec, ionized)
    sp_ion = _emit(sp_ion, sp_new, ndim, ion, ionized)
    return sp_e, sp_ion


def mcc_collision_update(state, cfg, dt: float, draws):
    """Every background_mcc collision of the configuration, in order, on
    the numbers of ``draws`` (one split a pass, taken on steps that skip
    the collision too, as the JAX package's ``jax.lax.cond`` does).
    nu_max and the probabilities are host numbers
    (BackgroundMCCCollision.cpp:225-266)."""
    from ..utils.expression import compile_expression

    cols = [c for c in cfg.collisions if c.kind == "background_mcc"]
    if not cols:
        return state
    ndim = cfg.geometry.ndim
    by_name = {s.name: s for s in cfg.species}
    species = dict(state.species)
    dtype = state.fields.Ex.dtype
    uc = dict(cfg.user_constants or ())
    for col in cols:
        sp_cfg = by_name[col.species[0]]
        sp = species[sp_cfg.name]
        m1 = sp_cfg.mass
        scatter = tuple(p for p in col.processes if p.kind != "ionization")
        ioniz = tuple(p for p in col.processes if p.kind == "ionization")
        # the background mass: the product ion's when ionizing, else the
        # species' own (BackgroundMCCCollision.cpp:258-270)
        if col.background_mass > 0:
            M_bg = col.background_mass
        elif ioniz and col.ionization_species:
            M_bg = by_name[col.ionization_species].mass
        else:
            M_bg = m1
        n_a_fn = compile_expression(col.background_density,
                                    ("x", "y", "z", "t"), uc)
        T_a_fn = compile_expression(col.background_temperature,
                                    ("x", "y", "z", "t"), uc)
        dt_coll = dt * col.ndt
        do_now = state.step % col.ndt == 0
        if scatter:
            nu_max = mcc_nu_max(scatter, m1, col.max_background_density)
            (sub,) = draws.split(1)
            if do_now:
                sp = apply_mcc_scattering(
                    sub, sp, ndim, state.time, m=m1, M=M_bg,
                    processes=scatter, n_a_fn=n_a_fn, T_a_fn=T_a_fn,
                    nu_max=nu_max,
                    p_coll=total_collision_prob(nu_max, dt_coll),
                    dtype=dtype)
        if ioniz:
            nu_max_i = mcc_nu_max(ioniz, m1, col.max_background_density)
            (sub,) = draws.split(1)
            if do_now:
                sp, species[col.ionization_species] = apply_mcc_ionization(
                    sub, sp, species[col.ionization_species], ndim,
                    state.time, m=m1, M_bg=M_bg, proc=ioniz[0],
                    n_a_fn=n_a_fn, T_a_fn=T_a_fn, nu_max_ioniz=nu_max_i,
                    p_coll_ioniz=total_collision_prob(nu_max_i, dt_coll),
                    dtype=dtype)
        species[sp_cfg.name] = sp
    return state.replace(species=species)
