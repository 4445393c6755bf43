"""Domain layout: physical region, PML strips, per-component array shapes.

A copy of ``warpx_tpu.core.domain`` (numpy, host side).

The reference allocates PML split fields in separate boxes surrounding the
domain (Source/BoundaryConditions/PML.cpp MakeBoxArray); here the field
arrays are EXTENDED by the PML width so the strips are ordinary array regions
and the domain<->PML exchange (PML.cpp:1117 Exchange) becomes shared storage:
the interior solver owns the physical region, the split-field solver owns the
strips, selected by precomputed masks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from .config import SimConfig
from .grid import Geometry

__all__ = ["DomainLayout"]


@dataclasses.dataclass(frozen=True)
class DomainLayout:
    geom: Geometry
    bc_lo: Tuple[str, ...]
    bc_hi: Tuple[str, ...]
    pml_ncell: int
    # damped-BC zone width (PSATD; reference: the FFT guard region that
    # DampFieldsInGuards operates on, WarpXPushFieldsEM.cpp:1276)
    damp_ncell: int = 16

    @classmethod
    def from_config(cls, cfg: SimConfig) -> "DomainLayout":
        ndim = cfg.geometry.ndim
        return cls(
            geom=cfg.geometry,
            bc_lo=cfg.field_bc_lo or ("periodic",) * ndim,
            bc_hi=cfg.field_bc_hi or ("periodic",) * ndim,
            pml_ncell=cfg.pml_ncell,
            damp_ncell=(
                max(cfg.psatd_order, 16) if cfg.psatd_order > 0 else 16
            ),
        )

    # ------------------------------------------------------------------ sizes
    def bounded(self, d: int) -> bool:
        return self.bc_lo[d] != "periodic"

    def ext_lo(self, d: int) -> int:
        if self.bc_lo[d] == "pml":
            return self.pml_ncell
        # Silver-Mueller keeps one stateful absorbing guard cell
        # (reference: ApplySilverMuellerBoundary.cpp "innermost guard cell")
        if self.bc_lo[d] == "absorbing_silver_mueller":
            return 1
        if self.bc_lo[d] == "damped":
            return self.damp_ncell
        return 0

    def ext_hi(self, d: int) -> int:
        if self.bc_hi[d] == "pml":
            return self.pml_ncell
        if self.bc_hi[d] == "absorbing_silver_mueller":
            return 1
        if self.bc_hi[d] == "damped":
            return self.damp_ncell
        return 0

    @property
    def has_ext(self) -> bool:
        return any(
            self.ext_lo(d) or self.ext_hi(d) for d in range(self.geom.ndim)
        )

    def n_alloc(self, d: int, nodal: bool) -> int:
        """Allocated extent of a component along dim d (cells + strips +
        the extra wall node for nodal components on bounded dims)."""
        n = self.geom.n_cell[d] + self.ext_lo(d) + self.ext_hi(d)
        if nodal and self.bounded(d):
            n += 1
        return n

    def comp_shape(self, flags) -> Tuple[int, ...]:
        return tuple(
            self.n_alloc(d, flags[d] == 1) for d in range(self.geom.ndim)
        )

    def field_shapes(self, staggering: Dict) -> Dict[str, Tuple[int, ...]]:
        return {name: self.comp_shape(flags) for name, flags in staggering.items()}

    @property
    def has_pml(self) -> bool:
        return any(
            self.bc_lo[d] == "pml" or self.bc_hi[d] == "pml"
            for d in range(self.geom.ndim)
        )

    def static_origin(self) -> Tuple[float, ...]:
        """Physical coordinate of array index 0 (before any window shift)."""
        return tuple(
            self.geom.prob_lo[d] - self.ext_lo(d) * self.geom.dx[d]
            for d in range(self.geom.ndim)
        )

    def phys_slice(self, flags) -> Tuple[slice, ...]:
        """Slice of the physical region (incl. wall nodes for nodal comps)."""
        out = []
        for d in range(self.geom.ndim):
            lo = self.ext_lo(d)
            n = self.geom.n_cell[d] + (
                1 if (flags[d] == 1 and self.bounded(d)) else 0
            )
            out.append(slice(lo, lo + n))
        return tuple(out)

    # ------------------------------------------------------------- PML sigmas
    def sigma_factors(self, d: int, dt: float):
        """(sigma_fac_node, sigma_fac_star) damping factors exp(-sigma dt)
        along dim d over the allocated NODAL extent (n_alloc nodal).

        Quadratic profile (PML.cpp FillLo/FillHi:64-117):
          sigma(node g outside by o cells)   = fac * o^2
          sigma(center g+1/2 outside by o-.5)= fac * (o-.5)^2
          fac = 4c/(dx * delta^2)  (PML.cpp:188), delta = pml_ncell
        Index convention: star[j] corresponds to position j+1/2.
        """
        n = self.geom.n_cell[d]
        dx = self.geom.dx[d]
        ncell = self.pml_ncell
        elo = self.ext_lo(d)
        ehi = self.ext_hi(d)
        fac = 4.0 * 299792458.0 / (dx * ncell * ncell)
        n_nodes = n + elo + ehi + 1
        g = np.arange(n_nodes) - elo  # global node index
        sigma = np.zeros(n_nodes)
        if elo:
            mask = g < 0
            sigma[mask] = fac * ((-g[mask]).astype(float) ** 2)
        if ehi:
            mask = g > n
            sigma[mask] = fac * ((g[mask] - n).astype(float) ** 2)
        # star positions g+1/2 (length n_nodes-1 suffices; keep n_nodes,
        # the last entry unused)
        gs = g.astype(float) + 0.5
        sigma_star = np.zeros(n_nodes)
        if elo:
            mask = gs < 0
            sigma_star[mask] = fac * ((-gs[mask]) ** 2)
        if ehi:
            mask = gs > n
            sigma_star[mask] = fac * ((gs[mask] - n) ** 2)
        return np.exp(-sigma * dt), np.exp(-sigma_star * dt)

    def in_pml_mask(self, flags) -> np.ndarray:
        """1.0 where the component site lies in a PML strip (the split solver
        owns it), 0.0 in the interior (regular solver owns it).

        Ownership follows the reference's Exchange: the outermost valid
        DOMAIN point (incl. the wall node of nodal comps) is interior-owned.
        """
        ndim = self.geom.ndim
        mask = np.zeros(self.comp_shape(flags))
        for d, outside in enumerate(self.pml_axes(flags)):
            bshape = [1] * ndim
            bshape[d] = outside.shape[0]
            mask = np.maximum(mask, outside.reshape(bshape).astype(float))
        return mask

    def pml_axes(self, flags) -> list:
        """``in_pml_mask`` by axis: for each axis, whether each index along
        it lies outside the domain's owned sites (the mask is their union
        over the axes)."""
        ndim = self.geom.ndim
        shape = self.comp_shape(flags)
        axes = []
        for d in range(ndim):
            n = self.geom.n_cell[d]
            elo = self.ext_lo(d)
            idx = np.arange(shape[d]) - elo  # global index
            nodal = flags[d] == 1
            if nodal:
                # interior nodes: [0, n]
                outside = (idx < 0) | (idx > n)
            else:
                # interior cells: [0, n-1]
                outside = (idx < 0) | (idx > n - 1)
            if not self.ext_lo(d):
                outside &= idx >= 0
            if not self.ext_hi(d):
                outside &= idx <= n
            axes.append(outside)
        return axes
