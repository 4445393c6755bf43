"""The ``Simulation`` class for the periodic explicit paths, 2D XZ and 3D.

The counterpart of ``warpx_tpu.core.simulation.Simulation`` cut to the
paths this port covers: ``init`` (injection from ``np.random.default_rng``
in the JAX package's order, then the tile-binned layout unless
``tiled_particles="off"``), ``evolve`` (with the -dt/2 and +dt/2 momentum
half-pushes of WarpXEvolve.cpp:222-229, 493-505) and ``checksums``.  The
step is the tile-binned ``binned_pic_step``, or the per-particle
``pic_step`` for ``tiled_particles="off"``.  The simulation runs on the
CUDA device unless the caller names another device; with no GPU it raises
rather than run on the CPU unasked.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..diagnostics.checksum import compute_checksums
from ..diagnostics.fields import cell_centered_output
from .binned_step import (binned_pic_step, binned_supported, make_tile_spec,
                           pusher_params)
from .config import SimConfig
from .grid import yee_staggering
from .injection import inject_species
from .state import FieldState, ParticleState, SimState
from .step import pic_step, push_momenta_half, wrap_positions

__all__ = ["Simulation"]


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU"
        )
    return torch.device("cuda")


class Simulation:
    """``binned`` says which step runs: True for the tile-binned step (the
    fused kernels on a CUDA device), False for the per-particle ``pic_step``
    (plain PyTorch on any device), which ``tiled_particles="auto"`` falls
    back to outside ``binned_supported``.  A caller that measures the
    kernels checks it."""

    def __init__(self, cfg: SimConfig, dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None):
        self.device = (_default_device() if device is None
                       else torch.device(device))
        self.dtype = dtype
        self.cfg = cfg
        if cfg.geometry.ndim not in (2, 3):
            raise NotImplementedError("1D (ROADMAP.md Queue A 3-4)")
        if cfg.tiled_particles == "on" and not binned_supported(cfg):
            raise NotImplementedError(
                "tiled_particles=on but the configuration is outside the "
                "ported tile-binned path (see binned_supported; ROADMAP.md "
                "Queue A)"
            )
        # 'auto' takes the tile-binned path wherever it covers the
        # configuration, the per-particle step elsewhere
        self.binned = binned_supported(cfg)
        self.staggering = yee_staggering(cfg.geometry.ndim)
        self.params = (pusher_params(cfg, dtype, self.device)
                       if self.binned else None)
        self.state: SimState | None = None
        self.tile_spec = None
        self.is_synchronized = True

    def init(self, seed: int | None = None) -> SimState:
        cfg = self.cfg
        geom = cfg.geometry
        rng = np.random.default_rng(seed if seed is not None else cfg.seed)
        kw = dict(dtype=self.dtype, device=self.device)
        species = {
            sp_cfg.name: inject_species(sp_cfg, geom, rng, **kw)
            for sp_cfg in cfg.species
        }
        aux = {}
        if self.binned:
            species, aux = self._tile_layout(species)

        def zeros():
            return torch.zeros(geom.n_cell, **kw)

        fields = FieldState(
            Ex=zeros(), Ey=zeros(), Ez=zeros(),
            Bx=zeros(), By=zeros(), Bz=zeros(),
            jx=zeros(), jy=zeros(), jz=zeros(),
        )
        self.state = SimState(fields=fields, species=species, step=0,
                              time=0.0, aux=aux)
        self.is_synchronized = True
        return self.state

    def _tile_layout(self, species):
        """Re-lay every species out at the shared tile-binned capacity;
        returns the species and the layout's zeroed safety counters."""
        cfg = self.cfg
        geom = cfg.geometry
        n_max = max((ps.capacity for ps in species.values()), default=0)
        self.tile_spec = make_tile_spec(cfg, max(n_max, 1))
        cap = self.tile_spec.capacity
        center = [0.5 * (lo + hi)
                  for lo, hi in zip(geom.prob_lo, geom.prob_hi)]

        def _pad(ps: ParticleState) -> ParticleState:
            if ps.capacity > cap:
                raise ValueError(f"species capacity {ps.capacity} exceeds "
                                 f"tile capacity {cap}")
            pad = cap - ps.capacity

            def ext(a, fill=0.0):
                return torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                                device=a.device)])

            pos = [ext(p, c) for p, c in zip(ps.positions(geom.ndim),
                                               center)]
            return ps.replace(
                ux=ext(ps.ux), uy=ext(ps.uy), uz=ext(ps.uz), w=ext(ps.w),
                alive=ext(ps.alive, False),
            ).with_positions(geom.ndim, pos)

        counter = torch.zeros((), dtype=torch.int32, device=self.device)
        return ({nm: _pad(ps) for nm, ps in species.items()},
                {"tile_overflow": counter, "tile_violations": counter})

    def step(self, state: SimState) -> SimState:
        """One PIC step of ``state`` (no half-pushes)."""
        if not self.binned:
            return pic_step(state, self.cfg, self.staggering)
        return binned_pic_step(state, self.cfg, self.staggering,
                               self.tile_spec, self.params)

    def evolve(self, numsteps: int = -1) -> SimState:
        """Advance ``numsteps`` steps (or to max_step), with WarpX::Evolve's
        synchronization pattern."""
        if self.state is None:
            self.init()
        cfg = self.cfg
        start = self.state.step
        stop = (cfg.max_step if numsteps < 0
                else min(start + numsteps, cfg.max_step))
        for step in range(start, stop):
            if self.is_synchronized:
                # push the momenta back half a step (WarpXEvolve.cpp:493-505)
                self.state = push_momenta_half(
                    self.state, cfg, self.staggering, -0.5 * cfg.dt
                )
                self.is_synchronized = False
            self.state = self.step(self.state)
            if step == cfg.max_step - 1:
                # synchronize: forward half push with the new fields
                self.state = push_momenta_half(
                    self.state, cfg, self.staggering, 0.5 * cfg.dt
                )
                self.is_synchronized = True
        return self.state

    def _normalize_binned(self):
        """Assert the tile-layout invariants (no slot overflow, no drift
        beyond the rebin margin) and wrap the positions back into the
        periodic domain before any host-side output."""
        if self.state is None or not self.binned:
            return
        aux = self.state.aux
        ovf = int(aux["tile_overflow"])
        vio = int(aux["tile_violations"])
        if ovf or vio:
            raise RuntimeError(
                f"tile-binned layout invariant violated: overflow={ovf} "
                f"violations={vio} (raise tile_headroom / sort_margin or "
                "lower sort_interval)"
            )
        geom = self.cfg.geometry
        self.state = self.state.replace(species={
            nm: wrap_positions(sp, geom)
            for nm, sp in self.state.species.items()
        })

    def field_diagnostics(self) -> Dict[str, torch.Tensor]:
        return cell_centered_output(self.state, self.cfg, self.staggering)

    def checksums(self) -> Dict[str, Dict[str, float]]:
        self._normalize_binned()
        return compute_checksums(self.state, self.cfg, self.staggering)
