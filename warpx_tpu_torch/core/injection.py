"""Plasma injection: per-cell particle placement, weights, momentum sampling.

The counterpart of ``warpx_tpu.core.injection.inject_species`` for
NUniformPerCell / NRandomPerCell placement, a constant density profile and
``at_rest`` / ``constant`` / ``gaussian`` momenta (reference:
PhysicalParticleContainer.cpp:925-1334, InjectorPosition.H:67-107).  It runs
on the host in numpy and draws from the caller's ``np.random.Generator`` in
the same order as the JAX package, so the same seed gives bit-identical
particles; the arrays then move to the requested device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import constants
from .config import SpeciesConfig
from .grid import Geometry
from .state import ParticleState

__all__ = ["inject_species"]


def _regular_unit_positions(ppc: Tuple[int, ...], ndim: int) -> np.ndarray:
    """Unit-cell offsets for NUniformPerCell, ordered like the reference
    (InjectorPosition.H:100-107: i_part decomposes as x-major, then z, then y)."""
    ppc = tuple(ppc)[:ndim]
    if ndim == 3:
        nx, ny, nz = ppc
    elif ndim == 2:
        nx, nz = ppc
        ny = 1
    else:
        (nz,) = ppc
        nx = ny = 1
    n_tot = nx * ny * nz
    out = np.zeros((n_tot, 3))
    for i_part in range(n_tot):
        ix = i_part // (ny * nz)
        iz = (i_part - ix * (ny * nz)) // ny
        iy = (i_part - ix * (ny * nz)) - ny * iz
        out[i_part] = [(0.5 + ix) / nx, (0.5 + iy) / ny, (0.5 + iz) / nz]
    return out


def inject_species(
    sp: SpeciesConfig,
    geom: Geometry,
    rng: np.random.Generator,
    *,
    dtype: torch.dtype,
    device: torch.device | str,
    capacity: int | None = None,
) -> ParticleState:
    """Inject one species; alive particles first, dead slots (up to
    ``capacity``) parked at the domain center with zero weight."""
    ndim = geom.ndim
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    if sp.injection_style not in ("nuniformpercell", "nrandompercell"):
        raise NotImplementedError(
            f"injection style {sp.injection_style!r} (ROADMAP.md Queue A 11)"
        )
    if sp.profile != "constant":
        raise NotImplementedError(
            f"density profile {sp.profile!r} (ROADMAP.md Queue A 11)"
        )
    if sp.momentum_distribution not in ("at_rest", "none", "constant",
                                        "gaussian"):
        raise NotImplementedError(
            f"momentum distribution {sp.momentum_distribution!r} "
            "(ROADMAP.md Queue A 11)"
        )

    # --- per-cell offsets (unit box, full xyz triple)
    if sp.injection_style == "nuniformpercell":
        unit = _regular_unit_positions(sp.num_particles_per_cell_each_dim, ndim)
    else:
        unit = rng.random((sp.num_particles_per_cell, 3))
    ppc_tot = unit.shape[0]

    # --- cell grid
    mesh_axes = [
        geom.prob_lo[d] + np.arange(geom.n_cell[d]) * geom.dx[d]
        for d in range(ndim)
    ]
    cell_lo = np.meshgrid(*mesh_axes, indexing="ij")
    cell_lo = np.stack([m.reshape(-1) for m in cell_lo], axis=-1)
    unit_active = unit[:, {3: [0, 1, 2], 2: [0, 2], 1: [2]}[ndim]]
    dx = np.array(geom.dx)
    pos = cell_lo[:, None, :] + unit_active[None, :, :] * dx[None, None, :]
    pos = pos.reshape(-1, ndim).astype(np_dtype)
    scale_vec = np.full(pos.shape[0], geom.cell_volume / ppc_tot, np_dtype)

    # --- density -> weight
    dens = np.full(pos.shape[0], sp.density, dtype=np_dtype)
    w = (dens * scale_vec).astype(np_dtype)
    mask = w > 0

    # --- momentum (units of gamma*beta; stored as u = c * value, m/s)
    n = pos.shape[0]
    if sp.momentum_distribution in ("at_rest", "none"):
        ux = np.zeros(n, dtype=np_dtype)
        uy = np.zeros(n, dtype=np_dtype)
        uz = np.zeros(n, dtype=np_dtype)
    elif sp.momentum_distribution == "constant":
        ux = np.full(n, sp.ux, dtype=np_dtype)
        uy = np.full(n, sp.uy, dtype=np_dtype)
        uz = np.full(n, sp.uz, dtype=np_dtype)
    else:  # gaussian
        ux = rng.normal(sp.ux, sp.ux_th or 0.0, n).astype(np_dtype)
        uy = rng.normal(sp.uy, sp.uy_th or 0.0, n).astype(np_dtype)
        uz = rng.normal(sp.uz, sp.uz_th or 0.0, n).astype(np_dtype)
    ux = (ux * constants.c).astype(np_dtype)
    uy = (uy * constants.c).astype(np_dtype)
    uz = (uz * constants.c).astype(np_dtype)

    # --- compact to alive-first layout, pad to capacity
    keep = np.nonzero(mask)[0]
    count = keep.size
    cap = capacity or count
    if cap < count:
        raise ValueError(f"capacity {cap} < injected count {count}")

    def _pad(a, fill=0.0):
        out = np.full(cap, fill, dtype=a.dtype)
        out[:count] = a[keep]
        return torch.from_numpy(out).to(device)

    alive = np.zeros(cap, dtype=bool)
    alive[:count] = True
    ps = ParticleState(
        w=_pad(w), ux=_pad(ux), uy=_pad(uy), uz=_pad(uz),
        alive=torch.from_numpy(alive).to(device),
    )
    centers = [
        0.5 * (geom.prob_lo[d] + geom.prob_hi[d]) for d in range(ndim)
    ]
    return ps.with_positions(
        ndim, [_pad(pos[:, d], fill=centers[d]) for d in range(ndim)],
    )
