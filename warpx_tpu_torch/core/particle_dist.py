"""Particle decomposition over ranks (the full-feature distributed mode).

The counterpart of ``warpx_tpu.core.particle_dist``.  The reference runs
its whole feature matrix under MPI by decomposing space; here the
PARTICLES are decomposed instead: every rank holds the whole grid, and a
round-robin slice of every species' slots.  One all-reduce of the
deposited J (and rho) at the deposit -> advance seam
(``BoundedStepper.field_tail``) and of rho in the electrostatic solve makes
the replicated field update the same on every rank; everything else of the
bounded step (PML, walls, the moving window, laser antennas, filters,
particle boundaries, continuous injection) is replicated field work or
per-particle work and runs unchanged.  Each particle that the continuous
injection creates lands on exactly one rank (``continuous_injection``'s
round-robin by rank within the selected set), so an n-rank run equals the
one-device run to the roundoff of the sum's order.

Particles never migrate, so the load is balanced by construction; the
spatial ``DistSimulation`` stays the mode for grids too large to
replicate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.distributed as dist

from ..diagnostics.checksum import compute_checksums
from ..diagnostics.fields import cell_centered_output
from ..parallel.distribute import gather_particles
from ..parallel.topology import rank_device
from .config import SimConfig
from .simulation import Simulation, _dist_flush, _dist_outputs, _dist_refusals
from .state import SimState

__all__ = ["ParticleDistSimulation", "ParticleShards"]


@dataclasses.dataclass(frozen=True)
class ParticleShards:
    """This rank among ``world`` particle shards of ``group``: the
    bounded step's hook (``BoundedStepper.shards``)."""

    rank: int
    world: int
    group: object = None

    def sum(self, tensors):
        """The tensors summed over the ranks, in one all-reduce of their
        concatenation."""
        tensors = tuple(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()
        return tuple(out)


class ParticleDistSimulation(Simulation):
    """A bounded simulation over the ranks of a ``torch.distributed``
    process group, the particles decomposed.  ``device=None`` takes
    ``cuda:$LOCAL_RANK``; ``device="cpu"`` runs over gloo."""

    @staticmethod
    def _check_supported(cfg: SimConfig) -> None:
        need = _dist_refusals(
            "ParticleDistSimulation does not implement {} yet")
        geom = cfg.geometry
        need(not geom.rz, "RZ geometry under particle decomposition")
        need(cfg.max_level == 0, "mesh refinement under particle decomposition")
        need(cfg.evolve_scheme == "explicit",
             "implicit schemes under particle decomposition")
        need(not cfg.collisions,
             "collisions (cell-paired) under particle decomposition")
        need(not cfg.do_qed_schwinger,
             "Schwinger pair production under particle decomposition")
        for sp in cfg.species:
            need(not sp.do_field_ionization,
                 "field ionization under particle decomposition")
            need(not (sp.do_qed_quantum_sync or sp.do_qed_breit_wheeler),
                 "QED processes under particle decomposition")
            need(not sp.do_resampling,
                 "resampling under particle decomposition")
            need(not sp.save_particles_at,
                 "boundary scraping buffers under particle decomposition")
            need(sp.injection_style != "nfluxpercell",
                 "flux injection under particle decomposition")

    def __init__(self, cfg: SimConfig, dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None, group=None):
        self._check_supported(cfg)
        device = rank_device(device, group)
        self.group = group
        self.n_shards = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        # the bounded stepper's hook; set before the stepper is built
        self._shards = ParticleShards(self.rank, self.n_shards, group)
        super().__init__(cfg, dtype=dtype, device=device)
        # the tile-binned layout is not hooked: per particle
        self.binned = False
        self.tile_spec = None
        if not self.is_bounded:
            raise NotImplementedError(
                "ParticleDistSimulation covers the bounded path "
                "(non-periodic BCs / moving window / lasers / bounded ES); "
                "use DistSimulation for periodic explicit decks"
            )

    def _init_bounded(self, rng) -> SimState:
        """The whole initial state, as every rank builds it from the same
        seed, then this rank's deal of the slots: before the initial
        electrostatic solve, whose rho is all-reduced."""
        super()._init_bounded(rng)
        self.state = self._pad_species(self.state)
        return self.state

    def _pad_species(self, state: SimState) -> SimState:
        """Round every species' slot capacity up to a multiple of the ranks
        and DEAL the slots round-robin: this rank keeps slots rank, rank +
        n, ... (segment ``rank`` of the JAX package's dealt array).  The
        injection fills free slots rank-locally, and the initial population
        sits in a contiguous prefix: without the deal, full early ranks
        would drop their share of injected particles while later ones sit
        empty."""
        n, r = self.n_shards, self.rank
        species = {}
        for nm, sp in state.species.items():
            extra_n = (-sp.capacity) % n

            def fix(a):
                if a is None:
                    return None
                if extra_n:
                    a = torch.cat([a, a.new_zeros((extra_n,) + a.shape[1:])])
                return a[r::n].contiguous()

            species[nm] = sp.replace(
                w=fix(sp.w), ux=fix(sp.ux), uy=fix(sp.uy), uz=fix(sp.uz),
                alive=fix(sp.alive), x=fix(sp.x), y=fix(sp.y), z=fix(sp.z),
                extra={k: fix(v) for k, v in sp.extra.items()},
            )
        return state.replace(species=species)

    def gather_state(self) -> SimState:
        """The global state in the JAX package's layout (the replicated
        fields, each species' dealt slots by rank); on every rank (a
        collective)."""
        st = self.state
        return st.replace(species={
            nm: gather_particles(sp, self.group, self.n_shards)
            for nm, sp in st.species.items()})

    def checksums(self) -> Dict[str, Dict[str, float]]:
        return compute_checksums(self.gather_state(), self.cfg,
                                 self.staggering, psatd=self.psatd)

    def field_diagnostics(self) -> Dict[str, torch.Tensor]:
        # rho comes from every rank's particles
        return cell_centered_output(self.gather_state(), self.cfg,
                                    self.staggering)

    def alive_count(self) -> int:
        """The live particles of every species on every rank."""
        n = sum(sp.alive.sum() for sp in self.state.species.values())
        n = torch.as_tensor(n, dtype=torch.int64, device=self.device)
        dist.all_reduce(n, group=self.group)
        return int(n)

    def _setup_diagnostics(self, outputs: dict, output_dir: str):
        _dist_outputs(outputs)
        super()._setup_diagnostics(outputs, output_dir)

    def flush_diagnostics(self, step: int):
        _dist_flush(self, step)
