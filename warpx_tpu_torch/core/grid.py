"""Structured-mesh geometry and Yee staggering metadata.

Replaces the reference's per-level amrex Geometry + IndexType nodal flags
(reference: Source/WarpX.cpp nodal-flag setup; Source/Fields.H:28-81 field list).
A field component's staggering is a per-dimension flag: 1 = nodal (sample at
integer index i), 0 = cell/staggered (sample at i + 1/2).

Axis conventions follow the reference's compile-time dims
(reference: Source/Particles/NamedComponentParticleContainer.H:23-38):
  3D: axes (x, y, z); 2D "XZ": axes (x, z); 1D: axis (z).
Array layout is C-order with the listed axes, e.g. a 3D field is (nx, ny, nz).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["Geometry", "yee_staggering", "collocated_staggering", "AXIS_NAMES"]

AXIS_NAMES = {1: ("z",), 2: ("x", "z"), 3: ("x", "y", "z")}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static mesh geometry (hashable; safe to close over in jit)."""

    ndim: int
    n_cell: Tuple[int, ...]
    prob_lo: Tuple[float, ...]
    prob_hi: Tuple[float, ...]
    periodic: Tuple[bool, ...]
    # RZ quasi-cylindrical geometry: 2D (r, z) grid, 3D Cartesian particles
    # (reference: WARPX_DIM_RZ compile-time dimension)
    rz: bool = False

    @property
    def dx(self) -> Tuple[float, ...]:
        return tuple(
            (hi - lo) / n for lo, hi, n in zip(self.prob_lo, self.prob_hi, self.n_cell)
        )

    @property
    def axis_names(self) -> Tuple[str, ...]:
        if self.rz:
            return ("r", "z")
        return AXIS_NAMES[self.ndim]

    @property
    def cell_volume(self) -> float:
        return float(np.prod(self.dx))

    @property
    def all_periodic(self) -> bool:
        return all(self.periodic)

    def cell_centers(self, axis: int) -> np.ndarray:
        d = self.dx[axis]
        return self.prob_lo[axis] + (np.arange(self.n_cell[axis]) + 0.5) * d

    def nodes(self, axis: int) -> np.ndarray:
        d = self.dx[axis]
        return self.prob_lo[axis] + np.arange(self.n_cell[axis] + 1) * d


def yee_staggering(ndim: int) -> dict[str, Tuple[int, ...]]:
    """Nodal flags (1=node, 0=cell) per component on the staggered Yee mesh.

    Matches the reference nodal flags: Ex=(0,1,1), Ey=(1,0,1), Ez=(1,1,0),
    Bx=(1,0,0), By=(0,1,0), Bz=(0,0,1), J like E, rho fully nodal; projected
    onto the active axes for 2D (x,z) and 1D (z).
    """
    full = {
        "Ex": (0, 1, 1),
        "Ey": (1, 0, 1),
        "Ez": (1, 1, 0),
        "Bx": (1, 0, 0),
        "By": (0, 1, 0),
        "Bz": (0, 0, 1),
        "jx": (0, 1, 1),
        "jy": (1, 0, 1),
        "jz": (1, 1, 0),
        "rho": (1, 1, 1),
        "F": (1, 1, 1),  # div(E) cleaning scalar: nodal
        "G": (0, 0, 0),  # div(B) cleaning scalar: cell-centered
        "phi": (1, 1, 1),
    }
    axes = {1: (2,), 2: (0, 2), 3: (0, 1, 2)}[ndim]
    return {name: tuple(flags[a] for a in axes) for name, flags in full.items()}


def collocated_staggering(ndim: int) -> dict[str, Tuple[int, ...]]:
    """All-nodal staggering for warpx.grid_type = collocated."""
    return {name: (1,) * ndim for name in yee_staggering(ndim)}
