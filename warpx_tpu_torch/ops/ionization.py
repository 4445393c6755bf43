"""ADK field ionization: tunnel ionization creating electrons from ions.

The counterpart of ``warpx_tpu.ops.ionization`` (reference: the ADK rate
coefficients of PhysicalParticleContainer::InitIonizationModule, Chen, JCP
236 (2013) eq. 2; the per-particle probability of
ElementaryProcess/Ionization.H:95-155; the filter-copy-transform creation of
ParticleCreation/FilterCopyTransform.H): each ionization event raises the
ion's ``ionizationLevel`` and places one product electron with the ion's
position, momentum and weight in the next free slot of the product species.

The ion keeps its deck charge whatever its level, as in the JAX package,
which reads ``ionizationLevel`` nowhere else (WarpX deposits q_e times the
level; ROADMAP.md Queue C).

Ionization energies (eV) from the NIST table the reference vendors
(Source/Utils/Physics/IonizationEnergiesTable.H), the JAX package's subset.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .. import constants
from .emit import emit_targets, put_rows

__all__ = ["IONIZATION_ENERGIES", "adk_coefficients",
           "ionization_probability", "ionize", "apply_ionization"]

# eV per charge state (NIST)
IONIZATION_ENERGIES: Dict[str, Tuple[float, ...]] = {
    "H": (13.59843449,),
    "He": (24.58738880, 54.4177650),
    "Li": (5.39171495, 75.6400964, 122.4543581),
    "Be": (9.322699, 18.21115, 153.896203, 217.7185843),
    "B": (8.298019, 25.15483, 37.93058, 259.3715, 340.226020),
    "C": (11.2602880, 24.383154, 47.88778, 64.49352, 392.090515, 489.993194),
    "N": (14.53413, 29.60125, 47.4453, 77.4735, 97.8901, 552.06732, 667.046116),
    "O": (
        13.618055, 35.12112, 54.93554, 77.41350, 113.8990, 138.1189,
        739.32682, 871.40988,
    ),
    "Ne": (
        21.564540, 40.96297, 63.4233, 97.1900, 126.247, 157.934, 207.271,
        239.0970, 1195.80783, 1362.19915,
    ),
    "Ar": (
        15.7596117, 27.62967, 40.735, 59.58, 74.84, 91.290, 124.41, 143.4567,
        422.60, 479.76, 540.4, 619.0, 685.5, 755.13, 855.5, 918.375,
        4120.6656, 4426.2228,
    ),
}


def adk_coefficients(element: str, dt: float):
    """(prefactor, exp_prefactor, power) per charge state as float64 numpy
    arrays, the prefactor including dt, exactly as InitIonizationModule
    computes them."""
    energies = np.array(IONIZATION_ENERGIES[element])
    alpha = constants.alpha
    a3 = alpha**3
    a4 = a3 * alpha
    wa = a3 * constants.c / constants.r_e
    Ea = constants.m_e * constants.c**2 / constants.q_e * a4 / constants.r_e
    UH = IONIZATION_ENERGIES["H"][0]
    l_eff = math.sqrt(UH / energies[0]) - 1.0

    Z = energies.shape[0]
    prefactor = np.zeros(Z)
    exp_prefactor = np.zeros(Z)
    power = np.zeros(Z)
    for i in range(Z):
        n_eff = (i + 1) * math.sqrt(UH / energies[i])
        C2 = 2.0 ** (2 * n_eff) / (
            n_eff * math.gamma(n_eff + l_eff + 1.0) * math.gamma(n_eff - l_eff)
        )
        power[i] = -(2.0 * n_eff - 1.0)
        Uion = energies[i]
        prefactor[i] = (
            dt * wa * C2 * (Uion / (2.0 * UH))
            * (2.0 * (Uion / UH) ** 1.5 * Ea) ** (2.0 * n_eff - 1.0)
        )
        exp_prefactor[i] = -2.0 / 3.0 * (Uion / UH) ** 1.5 * Ea
    return prefactor, exp_prefactor, power


def ionization_probability(ion_lev, ux, uy, uz, ex, ey, ez, bx, by, bz,
                           coeffs, atomic_number: int):
    """Per-particle ionization probability this step (Ionization.H:95-150).

    ``coeffs`` is ``adk_coefficients``'s triple.  The rate is evaluated as
    exp(log(prefactor) + power log E + exp_prefactor / E): the same
    function as the JAX package's prefactor * E**power * exp(...), whose
    prefactor (up to ~1e38 for N and ~1e44 for Ar at dt = 1e-16) overflows
    float32 (as (u.E)^2 does for fast particles in strong fields)."""
    dt = ux.dtype
    dev = ux.device
    c2_inv = constants.inv_c2
    ga = torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz) * c2_inv)
    # (u.E / c)^2 rather than (u.E)^2 / c^2: the same number, and no
    # float32 overflow for fast particles in strong fields
    udotE_c = (ux * ex + uy * ey + uz * ez) * (1.0 / constants.c)
    E = torch.sqrt(torch.clamp(
        -udotE_c * udotE_c
        + (ga * ex + uy * bz - uz * by) ** 2
        + (ga * ey + uz * bx - ux * bz) ** 2
        + (ga * ez + ux * by - uy * bx) ** 2, min=0.0))
    prefactor, exp_prefactor, power = coeffs
    lev = torch.clamp(ion_lev, 0, atomic_number - 1).to(torch.int64)
    log_pre = torch.as_tensor(np.log(prefactor), dtype=dt, device=dev)[lev]
    expp = torch.as_tensor(exp_prefactor, dtype=dt, device=dev)[lev]
    pw = torch.as_tensor(power, dtype=dt, device=dev)[lev]
    pos = E > 0.0
    E_safe = torch.where(pos, E, torch.ones_like(E))
    w_dtau = torch.where(
        pos,
        (1.0 / ga) * torch.exp(log_pre + pw * torch.log(E_safe)
                               + expp / E_safe),
        torch.zeros_like(E))
    p = 1.0 - torch.exp(-w_dtau)
    return torch.where(ion_lev < atomic_number, p, torch.zeros_like(p))


def ionize(ion, prod, e6, coeffs, atomic_number: int, draw: torch.Tensor,
           ndim: int):
    """The deterministic core of one ionization substep: ``draw`` holds one
    uniform number per ion slot (the JAX package's draw from its subkey).
    Returns (ion, prod) with the levels raised and the product electrons
    placed."""
    ion_lev = ion.extra["ionizationLevel"]
    p = ionization_probability(ion_lev, ion.ux, ion.uy, ion.uz, *e6,
                               coeffs, atomic_number)
    ionized = ion.alive & (draw < p)
    new_ion = ion.replace(extra={
        **ion.extra,
        "ionizationLevel": ion_lev + ionized.to(ion_lev.dtype)})
    tgt, placeable = emit_targets(ionized, ~prod.alive)
    out = prod.replace(
        w=put_rows(prod.w, tgt, ion.w),
        ux=put_rows(prod.ux, tgt, ion.ux),
        uy=put_rows(prod.uy, tgt, ion.uy),
        uz=put_rows(prod.uz, tgt, ion.uz),
        alive=put_rows(prod.alive, tgt, placeable),
    ).with_positions(ndim, [
        put_rows(pe, tgt, pi)
        for pe, pi in zip(prod.positions(ndim), ion.positions(ndim))])
    if out.extra:
        # runtime attributes of products default to 0 (the reference's
        # DefaultInitialization.H)
        out = out.replace(extra={k: put_rows(v, tgt, 0)
                                 for k, v in out.extra.items()})
    return new_ion, out


def apply_ionization(draws, ion, prod, e6, coeffs, atomic_number: int,
                     ndim: int):
    """One ionization substep on the numbers of ``draws``
    (``utils/draws.py``): one split, one uniform per ion slot."""
    (sub,) = draws.split(1)
    draw = sub.uniform((ion.capacity,), ion.ux.dtype)
    return ionize(ion, prod, e6, coeffs, atomic_number, draw, ndim)
