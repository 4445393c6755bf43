"""The ``Simulation`` class for the explicit paths, 2D XZ and 3D, periodic
and bounded.

The counterpart of ``warpx_tpu.core.simulation.Simulation`` cut to the
paths this port covers: ``init`` (injection from ``np.random.default_rng``
in the JAX package's order, then the tile-binned layout unless
``tiled_particles="off"``), ``evolve`` (with the -dt/2 and +dt/2 momentum
half-pushes of WarpXEvolve.cpp:222-229, 493-505) and ``checksums``.  On the
periodic torus the step is the tile-binned ``binned_pic_step``, or the
per-particle ``pic_step`` for ``tiled_particles="off"``; under
em_solver = psatd both advance the fields with ``sim.psatd``
(``solvers/psatd.py``).  A configuration
with a non-periodic field face, a moving window or a laser runs through
``core/bounded_step.py::BoundedStepper`` (``is_bounded``): ``step_binned``
or ``step_main``, then ``step_window`` after every step.  ``from_deck``
builds one from an inputs deck (``core/deck.py``) with the deck's outputs,
which ``evolve`` writes on their schedule after each step
(``flush_diagnostics``: plotfile, openPMD, checkpoint and reduced
diagnostics under ``output_dir``), then the back-transformed diagnostics of
a boosted run take their rows (``self.btd``, ``diagnostics/btd.py``).  After
each step the NFluxPerCell species emit from their planes
(``core/flux_injection.py``), then ``resample`` thins the species whose
trigger fires.  ``init`` lays the initial external grid fields
(``warpx.E/B_ext_grid_init_style``: constant, parsed or read from an
openPMD file).  The random numbers of the collisions, ionization, QED,
Schwinger, plane emission and resampling come from ``self.draws``
(``utils/draws.py``).  An electrostatic run solves for its fields at the
end of ``init`` and after every step (``stepper.solve_es``); a hybrid-PIC
run deposits rho and J into its temporaries at the end of ``init``; a
macroscopic medium (``self.medium``) is built for the periodic step.  An
implicit scheme steps through ``self.implicit`` (``solvers/implicit.py``)
with no leapfrog half-pushes; cold fluids start from ``init`` into the
state's ``aux``; under ECT the initial grid fields are zero on the covered
edges and faces.  A collocated grid stages every component on the nodes;
a rigid-injected species starts with its plane and mean v_z in ``aux``;
the boundary-scraping buffers start empty and ``scraped_particles`` reads
them.  Under mesh refinement (``amr.max_level = 1``) the periodic step
is ``core/mr.py::make_mr_step``'s (``self.mr_step``) and the bounded
stepper carries the patch; ``init`` starts the patch at rest and injects
``warpx.refine_plasma``'s fine lattice, the checksums and plotfiles gain
level 1.  An RZ configuration takes ``self.rz`` (``rz/core.py::RZStepper``
or ``rz/spectral.py::RZSpectralStepper``) before any other path, with the
RZ plotfile names and checksums.  ``init``
registers the run for the data views (``runtime.py``), and ``evolve``
calls the user callbacks (``utils/callbacks.py``) at the JAX package's
hook sites.  The
simulation runs on the CUDA device unless the caller names another
device; with no GPU it raises rather than run on the CPU unasked.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..constants import c as _c
from ..diagnostics.btd import BTDSnapshots
from ..diagnostics.checksum import compute_checksums
from ..diagnostics.fields import cell_centered_output, current_origin
from ..diagnostics.reduced import ReducedDiagWriter, compute_reduced
from ..io.checkpoint import save_checkpoint
from ..io.openpmd import compact_columns, host, write_openpmd_iteration
from ..io.plotfile import write_plotfile
from ..parallel.distribute import distribute_state, gather_particles
from ..parallel.load_balance import (knapsack_assignment, morton_order,
                                     sfc_assignment)
from ..parallel.topology import SpatialMesh, rank_device
from ..runtime import set_simulation
from ..rz.core import (RZStepper, check_rz_supported, rz_cell_centered_output,
                       rz_checksums, rz_init_state)
from ..rz.spectral import RZSpectralStepper
from ..solvers.div_cleaner import project_div_b
from ..solvers.psatd import PsatdFirstOrder, PsatdSolver
from ..utils.callbacks import _registry as _cb_registry
from ..utils.callbacks import execute_callbacks as _cb
from ..utils.draws import Draws
from ..utils.expression import compile_expression
from ..utils.intervals import IntervalsParser
from ..utils.observability import SignalFlags, StepTimer
from ..utils.parser import Deck
from .binned_step import (binned_pic_step, binned_supported,
                           bounded_binned_supported, make_tile_spec,
                           pusher_params)
from .bounded_step import (BoundedStepper, check_bounded_supported,
                           needs_bounded_step)
from .config import SimConfig
from .deck import config_from_deck, outputs_from_deck
from .domain import DomainLayout
from .flux_injection import flux_capacity, make_flux_injector
from .grid import AXIS_NAMES, collocated_staggering, yee_staggering
from .injection import (columns_to_state, inject_gaussian_beam_host,
                        inject_species_host, position_fills)
from .laser import antenna_particles
from .sharded_step import (all_gather_grid, make_balanced_half_push,
                           make_balanced_step, make_sharded_half_push,
                           make_sharded_step)
from .mr import (MRLayout, make_mr_step, mr_init_aux, mr_output_fields,
                 refine_spec_of)
from .state import FieldState, ParticleState, SimState
from .step import has_stochastic, pic_step, push_momenta_half, wrap_positions

__all__ = ["Simulation", "DistSimulation"]

# the slots of a plane-emitting species: a whole run's emission, at most
# this many (the JAX package's simulation.py:900-910)
FLUX_CAPACITY_MAX = 5_000_000


def _staggered_points(shape, flags, geom, origin):
    """The (ndim) meshgrid of a component's positions: node ``i`` of an
    axis at origin + i dx where the component is nodal (flag 1), at
    origin + (i + 1/2) dx where it is cell-centered."""
    return np.meshgrid(*[
        origin[d] + (np.arange(shape[d]) + (0.0 if flags[d] == 1 else 0.5))
        * geom.dx[d] for d in range(geom.ndim)], indexing="ij")


def _interp_file_field(mesh, shape, flags, geom, origin) -> np.ndarray:
    """Multilinear interpolation of an openPMD mesh component onto the
    staggered grid positions (WarpX::ReadExternalFieldFromFile,
    WarpXInitData.cpp:1503-1672: the file's data lives on the node lattice
    offset + i * spacing; each point interpolates in its enclosing file
    cell), in float64 on the host."""
    data = np.asarray(mesh["data"], np.float64)
    if data.ndim == geom.ndim + 1:
        # thetaMode layout (m-components, r, z): mode 0's real part
        data = data[0]
    if data.ndim != geom.ndim:
        raise ValueError(f"external field file has rank {data.ndim}, "
                         f"expected {geom.ndim}")
    spacing = np.asarray(mesh["spacing"], np.float64)
    offset = np.asarray(mesh["offset"], np.float64)
    pts = _staggered_points(shape, flags, geom, origin)
    # the fractional file index along each axis, clipped to the file
    idx_f = [np.clip((p - offset[d]) / spacing[d], 0.0, data.shape[d] - 1.0)
             for d, p in enumerate(pts)]
    i0 = [np.minimum(np.floor(f).astype(np.int64), data.shape[d] - 2)
          if data.shape[d] > 1 else np.zeros_like(f, np.int64)
          for d, f in enumerate(idx_f)]
    frac = [f - i for f, i in zip(idx_f, i0)]
    out = np.zeros(shape, np.float64)
    for corner in itertools.product((0, 1), repeat=geom.ndim):
        w = np.ones(shape, np.float64)
        idx = []
        for d, c in enumerate(corner):
            if data.shape[d] > 1:
                w = w * (frac[d] if c else (1.0 - frac[d]))
                idx.append(np.minimum(i0[d] + c, data.shape[d] - 1))
            else:
                if c:
                    w = w * 0.0
                idx.append(i0[d])
        out += w * data[tuple(idx)]
    return out


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
        self.rz = None
        if cfg.geometry.rz:
            self._init_rz()
            return
        if cfg.geometry.ndim not in (1, 2, 3):
            raise ValueError(f"geometry.ndim = {cfg.geometry.ndim}")
        for sp_cfg in cfg.species:
            if sp_cfg.attributes and sp_cfg.injection_style not in (
                    "nuniformpercell", "nrandompercell", "gaussian_beam"):
                # the JAX package evaluates them for the plasma styles and
                # the Gaussian beam only, and gives any other species none
                raise NotImplementedError(
                    f"runtime attributes of the {sp_cfg.injection_style!r} "
                    "style (the JAX package injects such a species without "
                    "them; ROADMAP.md Queue C)")
        self.is_bounded = needs_bounded_step(cfg)
        if cfg.do_divb_cleaning_external and self.is_bounded:
            # the JAX package's refusal (simulation.py:803-812)
            raise NotImplementedError(
                "warpx.do_divb_cleaning_external on bounded/RZ domains")
        supported = (bounded_binned_supported if self.is_bounded
                     else binned_supported)(cfg)
        if cfg.tiled_particles == "on" and not supported:
            raise NotImplementedError(
                "tiled_particles=on but the configuration is outside the "
                "ported tile-binned path (see binned_supported and "
                "bounded_binned_supported; ROADMAP.md Queue A)"
            )
        # 'auto' takes the tile-binned path wherever it covers the
        # configuration, the per-particle step elsewhere
        self.binned = supported
        self.staggering = (collocated_staggering(cfg.geometry.ndim)
                           if cfg.grid_type == "collocated"
                           else yee_staggering(cfg.geometry.ndim))
        # mesh refinement (JAX simulation.py:119-144): the bounded step
        # carries the patch inside its stepper, the periodic one is
        # core/mr.py's; neither is tile-binned (the JAX package runs MR
        # per particle)
        self.mr_layout = None
        self.mr_step = self.mr_half_push = None
        if cfg.max_level > 0:
            if self.is_bounded:
                check_bounded_supported(cfg)
                self.mr_layout = MRLayout(cfg, self.staggering)
            else:
                self.mr_step, self.mr_half_push, self.mr_layout = \
                    make_mr_step(cfg, self.staggering, dtype, self.device)
        # the theta- and semi-implicit schemes (JAX simulation.py:176-195):
        # periodic only, particles kept at integer times (no leapfrog
        # half-pushes around the step loop)
        # (check_bounded_supported refuses them off the periodic torus)
        self.implicit = None
        if cfg.evolve_scheme != "explicit" and not self.is_bounded:
            from ..solvers.implicit import ImplicitStepper

            self.implicit = ImplicitStepper(cfg, self.staggering, dtype,
                                            self.device)
        self.state: SimState | None = None
        self.tile_spec = None
        self.is_synchronized = True
        self.stepper = None
        self.deck: Deck | None = None
        self.output_dir = "diags"
        self.diags: list = []
        self.btd: list = []
        self.reduced: list = []
        self.signals: SignalFlags | None = None
        # the random numbers of collisions, ionization, QED, Schwinger and
        # resampling (utils/draws.py): one generator on the device, seeded
        # from the configuration; None where nothing draws
        self.draws = (Draws(cfg.seed, self.device) if has_stochastic(cfg)
                      else None)
        self._flux_injectors = {}
        self._resampling_triggers = {
            s.name: IntervalsParser(list(s.resampling_trigger_intervals))
            for s in cfg.species if s.do_resampling}
        # the periodic spectral solver (the bounded one is the stepper's)
        self.psatd = None
        # the macroscopic medium of the periodic step (JAX
        # simulation.py:244-249)
        self.medium = None
        if self.is_bounded:
            check_bounded_supported(cfg)
            self.params = None
        else:
            if cfg.em_solver == "psatd":
                self.psatd = self._periodic_psatd()
            if cfg.em_solver_medium == "macroscopic":
                from ..solvers.macroscopic import MacroscopicMedium

                self.medium = MacroscopicMedium.create(
                    cfg, self.staggering, dtype=dtype, device=self.device)
            self.params = (pusher_params(cfg, dtype, self.device)
                           if self.binned else None)

    def _init_rz(self):
        """The RZ paths, routed first as the JAX package routes them
        (simulation.py:97-114): the cylindrical FDTD stepper
        (``rz/core.py``) or the Hankel PSATD one (``rz/spectral.py``), per
        particle; the continuous injection behind a window draws from
        ``self.draws``."""
        cfg = self.cfg
        check_rz_supported(cfg)
        self.rz = (RZSpectralStepper if cfg.em_solver == "psatd"
                   else RZStepper)(cfg, self.dtype, self.device)
        self.is_bounded = self.binned = False
        self.staggering = yee_staggering(2)
        self.mr_layout = self.mr_step = self.mr_half_push = None
        self.implicit = self.state = self.tile_spec = self.stepper = None
        self.is_synchronized = True
        self.deck = None
        self.output_dir = "diags"
        self.diags, self.btd, self.reduced = [], [], []
        self.signals = None
        self.draws = (Draws(cfg.seed, self.device) if cfg.do_moving_window
                      and any(s.do_continuous_injection for s in cfg.species)
                      else None)
        self._flux_injectors, self._resampling_triggers = {}, {}
        self.psatd = self.medium = self.params = None

    def _rz_output(self) -> Dict[str, torch.Tensor]:
        """The RZ plotfile's fields (``rz_cell_centered_output``)."""
        return rz_cell_centered_output(self.state, self.cfg,
                                       getattr(self.rz, "solver", None))

    def _periodic_psatd(self):
        """The periodic spectral solver of the JAX package's choice
        (simulation.py:198-241): first-order PSATD advances by the multi-J
        sub-step (WarpX.cpp:2750: solver_dt /= do_multi_J_n_depositions),
        every other family is a ``PsatdSolver``."""
        cfg = self.cfg
        kw = dict(n_order=cfg.psatd_order,
                  collocated_grid=cfg.grid_type == "collocated",
                  update_with_rho=cfg.psatd_update_with_rho,
                  single_box=cfg.psatd_periodic_single_box,
                  dtype=self.dtype, device=self.device)
        if cfg.psatd_solution_type == "first-order":
            if cfg.do_dive_cleaning != cfg.do_divb_cleaning:
                raise NotImplementedError(
                    "first-order PSATD requires do_dive_cleaning == "
                    "do_divb_cleaning")
            return PsatdFirstOrder(
                cfg.geometry, self.staggering,
                cfg.dt / max(1, cfg.multi_j_n_depositions),
                j_in_time=cfg.psatd_j_in_time,
                rho_in_time=cfg.psatd_rho_in_time,
                div_cleaning=cfg.do_dive_cleaning, **kw)
        return PsatdSolver(
            cfg.geometry, self.staggering, cfg.dt,
            current_correction=cfg.psatd_current_correction,
            v_galilean=cfg.psatd_v_galilean,
            v_comoving=cfg.psatd_v_comoving,
            vay_deposition=cfg.current_deposition == "vay",
            time_averaging=cfg.psatd_time_averaging, **kw)

    def _with_optional_fields(self, fields: FieldState,
                              shapes=None) -> FieldState:
        """The cleaning scalars F and G (of the domain's shape, or of
        ``shapes`` on a bounded domain: F nodal, G cell-centered) and the
        time-averaged fields, zero at the start as Efield_avg_fp is (JAX
        simulation.py:792-800, 1236-1243)."""
        cfg = self.cfg
        upd = {}
        kw = dict(dtype=fields.Ex.dtype, device=fields.Ex.device)
        for nm, on in (("F", cfg.do_dive_cleaning),
                       ("G", cfg.do_divb_cleaning)):
            if on:
                upd[nm] = (torch.zeros_like(fields.Ex) if shapes is None
                           else torch.zeros(shapes[nm], **kw))
        if cfg.psatd_time_averaging:
            for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
                upd[nm + "_avg"] = torch.zeros_like(getattr(fields, nm))
        return fields.replace(**upd)

    @classmethod
    def from_deck(cls, deck, overrides=(),
                  dtype: torch.dtype = torch.float32,
                  device: torch.device | str | None = None,
                  output_dir: str = "diags") -> "Simulation":
        """A simulation of the inputs deck ``deck`` (a ``Deck`` or the path
        of a deck file, with ParmParse ``key=value`` ``overrides``) that
        writes the deck's outputs under ``output_dir``; the deck is kept as
        ``sim.deck``."""
        if not isinstance(deck, Deck):
            deck = Deck.from_file(deck, overrides)
        sim = cls(config_from_deck(deck), dtype=dtype, device=device)
        sim.deck = deck
        sim._setup_diagnostics(outputs_from_deck(deck), output_dir)
        return sim

    def _setup_diagnostics(self, outputs: dict, output_dir: str):
        """The output schedule of ``outputs_from_deck`` (reference:
        MultiDiagnostics / MultiReducedDiags): the back-transformed
        snapshots, the reduced diagnostics' writers under
        ``<output_dir>/reducedfiles``, the signal handlers."""
        self.output_dir = output_dir
        self.diags = outputs["diags"]
        self.btd = [BTDSnapshots(b["name"], self.cfg, b["num_snapshots"],
                                 b["dt_snapshots_lab"], b["fields"],
                                 output_dir)
                    for b in outputs.get("btd", [])]
        self.reduced = [
            dict(rd, writer=ReducedDiagWriter(
                os.path.join(output_dir, "reducedfiles"), rd["name"],
                rd["kind"]))
            for rd in outputs["reduced"]]
        if outputs["break_signals"] or outputs["checkpoint_signals"]:
            self.signals = SignalFlags(outputs["break_signals"],
                                       outputs["checkpoint_signals"])

    def _product_capacities(self) -> Dict[str, int]:
        """The slots a species gets for the particles that ionization, QED,
        Schwinger pair creation, fusion and MCC impact ionization put into
        it (JAX simulation.py:816-884): an ionizable species' product gets
        room for every ion fully stripped, a QED product one slot per
        parent, a Schwinger product min(n_cells max_step, 2,000,000), a
        fusion product max(per_prod n / 4, 65536) (per_prod 6 for p-B11,
        else 4; n the first reactant's count), an MCC ionization product
        max(2 n, 16).  The parents are counted from an
        injection with a fresh generator, as the JAX package counts them."""
        cfg = self.cfg
        geom = cfg.geometry
        ft = torch.empty((), dtype=self.dtype).numpy().dtype
        caps: Dict[str, int] = {}

        def count(sp_cfg):
            if sp_cfg.injection_style not in ("nuniformpercell",
                                              "nrandompercell"):
                return 0  # the JAX package's empty container
            return inject_species_host(sp_cfg, geom, np.random.default_rng(
                cfg.seed), ft)["w"].shape[0]

        for sp_cfg in cfg.species:
            if sp_cfg.do_field_ionization:
                from ..ops.ionization import IONIZATION_ENERGIES

                z_max = len(IONIZATION_ENERGIES[sp_cfg.physical_element])
                nm = sp_cfg.ionization_product_species
                caps[nm] = caps.get(nm, 0) + count(sp_cfg) * max(
                    z_max - sp_cfg.ionization_initial_level, 0)
        for sp_cfg in cfg.species:
            srcs = []
            if sp_cfg.do_qed_quantum_sync and sp_cfg.qed_product:
                srcs = [sp_cfg.qed_product]
            if sp_cfg.do_qed_breit_wheeler:
                srcs = [sp_cfg.qed_bw_ele_product, sp_cfg.qed_bw_pos_product]
            if srcs:
                n = count(sp_cfg)
                for nm in srcs:
                    if nm and nm != sp_cfg.name:
                        caps[nm] = caps.get(nm, 0) + n
        if cfg.do_qed_schwinger:
            budget = min(math.prod(geom.n_cell) * max(cfg.max_step, 1),
                         2_000_000)
            for nm in (cfg.qed_schwinger_ele, cfg.qed_schwinger_pos):
                if nm:
                    caps[nm] = caps.get(nm, 0) + budget
        by_name = {s.name: s for s in cfg.species}
        for col in cfg.collisions:
            if col.kind == "nuclearfusion":
                # a fraction of the first reactant's slots: the yield of a
                # step is small, and an event past the last slot is dropped
                per_prod = 6 if col.fusion_kind == "protonboron" else 4
                n = count(by_name[col.species[0]])
                for nm in col.product_species:
                    caps[nm] = caps.get(nm, 0) + max(per_prod * n // 4,
                                                     65536)
            if col.kind == "background_mcc" and col.ionization_species:
                nm = col.ionization_species
                caps[nm] = caps.get(nm, 0) + max(
                    2 * count(by_name[col.species[0]]), 16)
        return caps

    def _mcc_grown(self, sp_cfg):
        """A species that MCC impact ionization grows gets twice its
        initial slots (its capacity_factor 2.0, as the JAX package sets it,
        simulation.py:884-887)."""
        if sp_cfg.capacity_factor <= 1.0 and any(
                c.kind == "background_mcc" and c.ionization_species
                and c.species[0] == sp_cfg.name for c in self.cfg.collisions):
            return dataclasses.replace(sp_cfg, capacity_factor=2.0)
        return sp_cfg

    def _with_extras(self, sp_cfg, cols: dict, capacity=None) -> dict:
        """The species' runtime attributes at the start of the run (JAX
        simulation.py:956-973): the ions' initial level, and exponentially
        distributed QED optical depths from ``default_rng(seed + 17)``,
        created anew for every species as the JAX package does; for
        ``capacity`` slots (default: the columns' length), beside the
        deck's attributes that the injection evaluated."""
        cap = capacity or cols["w"].shape[0]
        ft = cols["w"].dtype
        extra = dict(cols.get("extra", {}))
        if sp_cfg.do_field_ionization:
            extra["ionizationLevel"] = np.full(
                cap, sp_cfg.ionization_initial_level, np.int32)
        qed_rng = np.random.default_rng(self.cfg.seed + 17)
        if sp_cfg.do_qed_quantum_sync:
            extra["opticalDepthQSR"] = qed_rng.exponential(size=cap).astype(ft)
        if sp_cfg.do_qed_breit_wheeler:
            extra["opticalDepthBW"] = qed_rng.exponential(size=cap).astype(ft)
        return dict(cols, extra=extra) if extra else cols

    def _rigid_aux(self, sp_cfg, cols) -> dict:
        """A rigid-injected species' plane in the boosted frame and the
        mean v_z of its initial particles (RigidInjectedParticleContainer
        .cpp:76, 105; JAX simulation.py:974-988), host numbers in the
        state's precision."""
        if sp_cfg.zinject_plane is None:
            return {}
        ft = cols["w"].dtype.type
        a0 = cols["alive"]
        uz = cols["uz"]
        g = np.sqrt(1.0 + (cols["ux"] ** 2 + cols["uy"] ** 2 + uz ** 2)
                    / 299792458.0 ** 2)
        vzs = (uz / g)[a0]
        return {f"zinject:{sp_cfg.name}": ft(sp_cfg.zinject_plane
                                             / self.cfg.gamma_boost),
                f"vzave:{sp_cfg.name}": ft(float(vzs.mean()) if vzs.size
                                           else 0.0)}

    def _with_scrape_buffers(self) -> None:
        """The boundary-scraping buffers (ParticleBoundaryBuffer; JAX
        simulation.py:1245-1260): per species and face of
        ``save_particles_at``, a fill count and the species' capacity of
        records (w, u, positions, step)."""
        aux = dict(self.state.aux)
        kw = dict(dtype=self.dtype, device=self.device)
        ndim = self.cfg.geometry.ndim
        for sp_cfg in self.cfg.species:
            cap = self.state.species[sp_cfg.name].capacity
            for face in sp_cfg.save_particles_at:
                pref = f"scrape:{sp_cfg.name}:{face}"
                aux[f"{pref}:n"] = torch.zeros((), dtype=torch.int32,
                                               device=self.device)
                for fld in ["w", "ux", "uy", "uz"] + [f"p{d}"
                                                     for d in range(ndim)]:
                    aux[f"{pref}:{fld}"] = torch.zeros(cap, **kw)
                aux[f"{pref}:step"] = torch.zeros(cap, dtype=torch.int32,
                                                  device=self.device)
        self.state = self.state.replace(aux=aux)

    def scraped_particles(self, species: str, face: str) -> Dict[str,
                                                                  np.ndarray]:
        """The particles of ``species`` absorbed at ``face`` ("xlo", ...,
        "eb") so far (ParticleBoundaryBuffer::getParticleBuffer; JAX
        simulation.py:1292-1303): w, ux, uy, uz, p0..p{ndim-1} and the
        step, trimmed to the fill count.  The count goes on past the
        buffer's capacity, whose records are dropped, as in the JAX
        package."""
        pref = f"scrape:{species}:{face}"
        n = int(self.state.aux[f"{pref}:n"])
        return {k.rsplit(":", 1)[-1]: v.detach().cpu().numpy()[:n]
                for k, v in self.state.aux.items()
                if k.startswith(pref + ":") and not k.endswith(":n")}

    def _capacity(self, sp_cfg, caps) -> int | None:
        """The slots of a species whose size the injection does not
        decide: a plane-emitting species' whole run of emission (at most
        FLUX_CAPACITY_MAX), a product species' ``caps`` entry."""
        if sp_cfg.injection_style == "nfluxpercell":
            return min(flux_capacity(sp_cfg, self.cfg.geometry,
                                     self.cfg.max_step), FLUX_CAPACITY_MAX)
        return caps.get(sp_cfg.name)

    def _init_external_grid(self, fields: FieldState, shapes,
                            origin) -> FieldState:
        """The initial E and B grid fields (WarpXInitData.cpp
        InitLevelData, ReadExternalFieldFromFile; JAX simulation.py:652-705):
        a constant, the deck's expressions at each component's staggered
        positions (array index 0 at ``origin``: prob_lo, or the padded
        block's corner on a bounded domain), or the file's mesh
        interpolated there; expressions and files are evaluated in float64
        on the host, then moved to the device."""
        cfg = self.cfg
        geom = cfg.geometry
        axes = {1: (2,), 2: (0, 2), 3: (0, 1, 2)}[geom.ndim]
        upd = {}
        for spec, comps in ((cfg.e_ext_grid, ("Ex", "Ey", "Ez")),
                            (cfg.b_ext_grid, ("Bx", "By", "Bz"))):
            if spec is None:
                continue
            style, vals = spec
            for ci, comp in enumerate(comps):
                shape = tuple(shapes[comp])
                flags = self.staggering[comp]
                if style == "constant":
                    upd[comp] = torch.full(shape, vals[ci], dtype=self.dtype,
                                           device=self.device)
                    continue
                if style == "file":
                    from ..io.openpmd import read_openpmd_mesh

                    val = torch.from_numpy(_interp_file_field(
                        read_openpmd_mesh(vals[0], comps[0][0], "xyz"[ci]),
                        shape, flags, geom, origin))
                else:
                    xyz = [torch.zeros(shape, dtype=torch.float64)] * 3
                    for a, pts in zip(axes, _staggered_points(
                            shape, flags, geom, origin)):
                        xyz[a] = torch.from_numpy(pts)
                    fn = compile_expression(vals[ci], ("x", "y", "z"),
                                            dict(cfg.user_constants))
                    val = torch.broadcast_to(torch.as_tensor(
                        fn(*xyz), dtype=torch.float64), shape)
                upd[comp] = val.to(device=self.device,
                                   dtype=self.dtype).contiguous()
        if cfg.eb_implicit_function and cfg.em_solver == "ect" and upd:
            # the reference's parser fill skips covered edges and faces,
            # which stay 0 (WarpXInitData.cpp:1131-1180; JAX
            # simulation.py:711-735)
            from ..solvers.ect import cached_ect_geometry

            geo = cached_ect_geometry(
                cfg.eb_implicit_function, tuple(cfg.user_constants or ()),
                geom, tuple(geom.prob_lo))
            for comp in upd:
                d = "xyz".index(comp[1])
                keep = (geo["edges"][comp] if comp[0] == "E"
                        else geo["S"].get(d))
                if keep is not None:
                    upd[comp] = torch.where(
                        torch.as_tensor(keep > 0.0, device=self.device),
                        upd[comp], torch.zeros((), dtype=self.dtype,
                                               device=self.device))
        return fields.replace(**upd)

    def _do_flux_injection(self) -> None:
        """Each NFluxPerCell species emits one step's particles from its
        plane, at the time the step started (ContinuousFluxInjection in
        PhysicalParticleContainer::Evolve; JAX simulation.py:1421-1445),
        each on one source split from ``self.draws``."""
        cfg = self.cfg
        for sp_cfg in cfg.species:
            if sp_cfg.injection_style != "nfluxpercell":
                continue
            inject = self._flux_injectors.get(sp_cfg.name)
            if inject is None:
                inject = self._flux_injectors[sp_cfg.name] = \
                    make_flux_injector(sp_cfg, cfg.geometry, cfg.dt,
                                       self.dtype, self.device)
            (sub,) = self.draws.split(1)
            sp = inject(self.state.species[sp_cfg.name],
                        self.state.time - cfg.dt, sub)
            self.state = self.state.replace(
                species={**self.state.species, sp_cfg.name: sp})

    def init(self, seed: int | None = None) -> SimState:
        # first: the data views (fields.py) see this run
        set_simulation(self)
        cfg = self.cfg
        geom = cfg.geometry
        rng = np.random.default_rng(seed if seed is not None else cfg.seed)
        if self.rz is not None:
            # the species from rng, the window's and fronts' scalars (JAX
            # simulation.py:746-778)
            self.state = rz_init_state(cfg, self.dtype, self.device, rng)
            self.is_synchronized = True
            return self.state
        if self.is_bounded:
            self._init_bounded(rng)
        else:
            self._init_periodic(rng)
        if self.mr_layout is not None:
            # the patch's solutions and fine current start at rest (JAX
            # simulation.py:1262-1267)
            self.state = self.state.replace(aux={
                **self.state.aux,
                **mr_init_aux(self.mr_layout, self.dtype, self.device)})
        if self.stepper is not None and self.stepper.is_es:
            # the initial space-charge field (WarpXInitData.cpp:598)
            self.state = self.stepper.solve_es(self.state)
        if cfg.em_solver == "hybrid":
            # rho^0 and J^0 into the hybrid temporaries
            # (HybridPICDepositInitialRhoAndJ)
            self.state = self.state.replace(
                fields=self._hybrid_initial_deposit(self.state))
        if cfg.fluids:
            # the cold fluids' nodal state lives in aux
            # (WarpXFluidContainer; JAX simulation.py:1269-1279)
            from ..solvers.fluids import fluid_keys, init_fluid

            aux = dict(self.state.aux)
            for fl in cfg.fluids:
                Nf, NU3 = init_fluid(fl, geom, self.dtype, self.device)
                aux.update(zip(fluid_keys(fl.name), (Nf,) + NU3))
            self.state = self.state.replace(aux=aux)
        return self.state

    def _hybrid_initial_deposit(self, state) -> FieldState:
        """The fields with ``hrho`` and ``hjx/y/z`` of the t = 0 deposit
        (WarpXPushFieldsHybridPIC.cpp:194; JAX simulation.py:1304-1335):
        rho and the direct J at relative time 0 of every depositing
        species, filtered under use_filter.  The JAX package exports
        ``hybrid_initial_e`` but never calls it, and neither does this
        (ROADMAP.md Queue C)."""
        from ..ops.deposit import deposit_current_direct, deposit_rho
        from ..solvers.filter import bilinear_filter

        cfg = self.cfg
        geom = cfg.geometry
        kw = dict(dtype=self.dtype, device=self.device)
        rho0 = torch.zeros(geom.n_cell, **kw)
        j3 = [torch.zeros(geom.n_cell, **kw) for _ in range(3)]
        for sp_cfg in cfg.species:
            sp = state.species[sp_cfg.name]
            if sp.capacity == 0 or sp_cfg.do_not_deposit:
                continue
            w_eff = torch.where(sp.alive, sp.w, torch.zeros_like(sp.w))
            pos = sp.positions(geom.ndim)
            rho0 = deposit_rho(pos, w_eff, sp_cfg.charge, geom,
                               cfg.particle_shape, out=rho0,
                               chunk_size=cfg.deposit_chunk_size)
            jj = deposit_current_direct(
                pos, sp.ux, sp.uy, sp.uz, w_eff, sp_cfg.charge, geom,
                self.staggering, cfg.dt, cfg.particle_shape,
                relative_time=0.0, chunk_size=cfg.deposit_chunk_size)
            j3 = [a + b for a, b in zip(j3, jj)]
        if cfg.use_filter:
            npass = cfg.filter_npass_each_dir or (1,) * geom.ndim
            rho0 = bilinear_filter(rho0, npass)
            j3 = [bilinear_filter(a, npass) for a in j3]
        return state.fields.replace(hrho=rho0, hjx=j3[0], hjy=j3[1],
                                    hjz=j3[2])

    def _init_periodic(self, rng) -> SimState:
        cfg = self.cfg
        geom = cfg.geometry
        kw = dict(dtype=self.dtype, device=self.device)
        ft = torch.empty((), dtype=self.dtype).numpy().dtype
        caps = self._product_capacities()
        species, rigid = {}, {}
        for sp_cfg in cfg.species:
            if sp_cfg.injection_style == "gaussian_beam":
                cols = inject_gaussian_beam_host(sp_cfg, geom, rng, ft,
                                                 cfg.gamma_boost)
            else:
                cols = inject_species_host(
                    self._mcc_grown(sp_cfg), geom, rng, ft,
                    self._capacity(sp_cfg, caps), cfg.gamma_boost,
                    refine_spec_of(cfg, self.mr_layout, sp_cfg))
            species[sp_cfg.name] = columns_to_state(
                self._with_extras(sp_cfg, cols), self.device)
            rigid.update(self._rigid_aux(sp_cfg, cols))
        aux = {}
        if self.binned:
            species, aux = self._tile_layout(species)

        def zeros():
            return torch.zeros(geom.n_cell, **kw)

        fields = self._with_optional_fields(FieldState(
            Ex=zeros(), Ey=zeros(), Ez=zeros(),
            Bx=zeros(), By=zeros(), Bz=zeros(),
            jx=zeros(), jy=zeros(), jz=zeros(),
        ))
        fields = self._init_external_grid(
            fields, {nm: geom.n_cell for nm in ("Ex", "Ey", "Ez", "Bx", "By",
                                               "Bz")}, geom.prob_lo)
        if cfg.do_divb_cleaning_external:
            # the projection div(B) cleaner on the initial B
            # (ProjectionDivCleaner, WarpXInitData.cpp:589-591)
            fields = project_div_b(fields, geom)
        self.state = SimState(fields=fields, species=species, step=0,
                              time=0.0, aux={**aux, **rigid})
        self._with_scrape_buffers()
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
                extra={k: ext(v, 0) for k, v in ps.extra.items()},
            ).with_positions(geom.ndim, pos)

        counter = torch.zeros((), dtype=torch.int32, device=self.device)
        return ({nm: _pad(ps) for nm, ps in species.items()},
                {"tile_overflow": counter, "tile_violations": counter})

    # ------------------------------------------------------- bounded set-up
    def _init_bounded(self, rng) -> SimState:
        """Species on the host in ``cfg.species`` order from the one
        generator (a continuously injected species is injected twice, the
        first time to count its initial particles, as the JAX package does,
        so the draws that follow are the same), the window's host scalars,
        the PML split fields, then, for the tile-binned step, the relayout
        of the plasma at the tile capacity: all before the one transfer."""
        cfg = self.cfg
        geom = cfg.geometry
        ndim = geom.ndim
        ft = torch.empty((), dtype=self.dtype).numpy().dtype
        wdir = cfg.moving_window_dir
        host, aux, pads = {}, {}, {}
        caps = self._product_capacities()
        for sp_cfg in cfg.species:
            if sp_cfg.injection_style == "laser":
                laser = next(las for las in cfg.lasers
                             if las.name == sp_cfg.name)
                cols, _, _ = antenna_particles(laser, geom, ft)
            elif sp_cfg.injection_style == "gaussian_beam":
                cols = inject_gaussian_beam_host(sp_cfg, geom, rng, ft,
                                                 cfg.gamma_boost)
            else:
                capacity = self._capacity(sp_cfg, caps)
                refine = refine_spec_of(cfg, self.mr_layout, sp_cfg)
                cols = None
                if sp_cfg.do_continuous_injection and cfg.do_moving_window:
                    # room for what the window uncovers over the whole run
                    ppc = sp_cfg.num_particles_per_cell_each_dim
                    ppc_tot = int(np.prod(ppc)) if ppc else 1
                    cross = int(np.prod([geom.n_cell[d] for d in range(ndim)
                                         if d != wdir]))
                    if refine is not None:
                        # the refined streams multiply the cross section
                        cross *= int(np.prod(self.mr_layout.rv))
                    travel_cells = math.ceil(
                        cfg.moving_window_v * _c * cfg.dt * cfg.max_step
                        / geom.dx[wdir]) + 4
                    drawn = rng.bit_generator.state
                    first = inject_species_host(sp_cfg, geom, rng, ft,
                                                gamma_boost=cfg.gamma_boost,
                                                refine_spec=refine)
                    count = int(first["alive"].sum())
                    capacity = count + travel_cells * cross * ppc_tot
                    if (rng.bit_generator.state == drawn
                            and first["w"].shape[0] == count
                            and self._mcc_grown(sp_cfg) is sp_cfg):
                        # the injection drew nothing: the second would
                        # give the same rows; they cross as they are and
                        # are padded to capacity on the device
                        cols, pads[sp_cfg.name] = first, capacity
                    del first
                if cols is None:
                    cols = inject_species_host(self._mcc_grown(sp_cfg), geom,
                                               rng, ft, capacity,
                                               cfg.gamma_boost, refine)
            host[sp_cfg.name] = self._with_extras(sp_cfg, cols,
                                                  pads.get(sp_cfg.name))
            aux.update(self._rigid_aux(sp_cfg, cols))
            if sp_cfg.do_continuous_injection and cfg.do_moving_window:
                aux[f"inject_pos:{sp_cfg.name}"] = ft.type(
                    geom.prob_hi[wdir] if cfg.moving_window_v > 0
                    else geom.prob_lo[wdir])
        if cfg.do_moving_window:
            # moving_window_x starts at the domain's lower edge
            # (WarpX.cpp:649); the edges accumulate step by step
            aux["window_x"] = ft.type(geom.prob_lo[wdir])
            aux["window_offset"] = 0
            aux["window_lo"] = ft.type(geom.prob_lo[wdir])
            aux["window_hi"] = ft.type(geom.prob_hi[wdir])

        slow = ()
        if self.binned:
            host, slow = self._relayout_bounded(host)
            counter = torch.zeros((), dtype=torch.int32, device=self.device)
            aux["tile_overflow"] = counter
            aux["tile_violations"] = counter
            if cfg.do_moving_window:
                aux["tile_anchor"] = ft.type(geom.prob_lo[wdir])
        # ParticleDistSimulation's hook (core/particle_dist.py), as the JAX
        # package passes its psum axis (simulation.py:130)
        self.stepper = BoundedStepper(
            cfg, self.staggering, self.dtype, self.device,
            tile_spec=self.tile_spec, slow_species=slow,
            shards=getattr(self, "_shards", None))

        kw = dict(dtype=self.dtype, device=self.device)
        shapes = self.stepper.shapes
        # the PML split fields (FDTD: one per curl term; PSATD: the spectral
        # splits over the extended box)
        for key, shape in self.stepper.pml_split_shapes().items():
            aux[key] = torch.zeros(shape, **kw)
        fields = self._with_optional_fields(FieldState(**{
            nm: torch.zeros(shapes[nm], **kw)
            for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")}),
            shapes)
        fields = self._init_external_grid(
            fields, shapes, DomainLayout.from_config(cfg).static_origin())
        relaid = {s.name for s in cfg.species if self.binned
                  and s.injection_style != "laser" and s.name not in slow}
        species = {nm: columns_to_state(
            cols, self.device,
            self.tile_spec.capacity if nm in relaid else pads.get(nm),
            position_fills(geom)) for nm, cols in host.items()}
        self.state = SimState(fields=fields, species=species, step=0,
                              time=0.0, aux=aux)
        self._with_scrape_buffers()
        self.is_synchronized = True
        return self.state

    def _relayout_bounded(self, host):
        """The bounded tile layout, on the host columns: the plasma species
        alive-compacted and re-laid at the tile capacity (a continuously
        injected species carries a whole-run capacity far beyond its live
        count); ``p_max`` sized from the peak occupancy of a tile (beams
        concentrate) and from the per-cell bound of an injected plasma, not
        from the mean.  A species with a small static population keeps its
        compact layout and rides the per-particle path inside the binned
        step.  Returns (columns, the names of those species); a relaid
        species' columns may stop short of the tile capacity, the rest
        being dead slots."""
        cfg = self.cfg
        geom = cfg.geometry
        ndim = geom.ndim
        names = AXIS_NAMES[ndim]
        tile = cfg.tile_size[-ndim:]
        ntpd = [n // t for n, t in zip(geom.n_cell, tile)]
        n_tiles = int(np.prod(ntpd))
        is_laser = {s.name: s.injection_style == "laser" for s in cfg.species}
        small = {s.name for s in cfg.species
                 if not is_laser[s.name] and not s.do_continuous_injection
                 and host[s.name]["w"].shape[0] <= 8192}
        max_tile = max_alive = 1
        for sp_cfg in cfg.species:
            if is_laser[sp_cfg.name] or sp_cfg.name in small:
                continue
            cols = host[sp_cfg.name]
            alive = cols["alive"]
            n_alive = int(alive.sum())
            if n_alive:
                max_alive = max(max_alive, n_alive)
                prefix = bool(alive[:n_alive].all())
                idx = np.zeros(n_alive, np.int64)
                for d in range(ndim):
                    p = (cols[names[d]][:n_alive] if prefix
                         else cols[names[d]][alive])
                    t = p - geom.prob_lo[d]
                    t /= geom.dx[d]
                    cell = np.floor(t, out=t).astype(np.int64)
                    cell //= tile[d]
                    np.clip(cell, 0, ntpd[d] - 1, out=cell)
                    idx *= ntpd[d]
                    idx += cell
                max_tile = max(max_tile,
                               int(np.bincount(idx, minlength=n_tiles).max()))
            ppc = sp_cfg.num_particles_per_cell_each_dim
            if ppc and (sp_cfg.do_continuous_injection
                        or sp_cfg.injection_style in ("nuniformpercell",
                                                      "nrandompercell")):
                max_tile = max(max_tile,
                               int(np.prod(ppc)) * int(np.prod(tile)))
        spec0 = make_tile_spec(cfg, max_alive)
        p_max = max(spec0.p_max,
                    -(-int(math.ceil(max_tile * cfg.tile_headroom)) // 128)
                    * 128)
        self.tile_spec = dataclasses.replace(spec0, p_max=p_max)
        cap = self.tile_spec.capacity

        def relayout(cols):
            alive = cols["alive"]
            n_alive = int(alive.sum())
            if n_alive > cap:
                raise ValueError(f"{n_alive} live particles exceed the tile "
                                 f"capacity {cap}; raise tile_headroom")
            if alive[:n_alive].all():
                # alive first already: the first ``cap`` rows, padded to
                # ``cap`` on the device (columns_to_state)
                out = {k: a[:cap] for k, a in cols.items() if k != "extra"}
                if "extra" in cols:
                    out["extra"] = {k: a[:cap]
                                    for k, a in cols["extra"].items()}
                return out
            take = np.argsort(~alive, kind="stable")[:cap]
            out = {}
            if "extra" in cols:
                out["extra"] = {}
                for k, a in cols["extra"].items():
                    arr = np.zeros(cap, a.dtype)
                    arr[:take.shape[0]] = a[take]
                    out["extra"][k] = arr
            for k, a in cols.items():
                if k == "extra":
                    continue
                fill = False if k == "alive" else 0.0
                if k in names:
                    d = names.index(k)
                    fill = 0.5 * (geom.prob_lo[d] + geom.prob_hi[d])
                arr = np.full(cap, fill, a.dtype)
                arr[:take.shape[0]] = a[take]
                out[k] = arr
            return out

        return ({nm: (cols if is_laser[nm] or nm in small
                      else relayout(cols)) for nm, cols in host.items()},
                tuple(sorted(small)))

    def step(self, state: SimState) -> SimState:
        """One PIC step of ``state`` (no half-pushes; on a bounded domain
        without the window's move and the particle boundaries that follow
        it in ``evolve``)."""
        if self.rz is not None:
            # an RZ step ends with the window's move (JAX rz/core.py:1535)
            return self.rz.step(state, self.draws)
        if self.is_bounded:
            return self.stepper.step(state, self.draws)
        if self.mr_step is not None:
            return self.mr_step(state)
        if self.implicit is not None:
            return self.implicit(state)
        if not self.binned:
            return pic_step(state, self.cfg, self.staggering, self.psatd,
                            self.draws, medium=self.medium)
        return binned_pic_step(state, self.cfg, self.staggering,
                               self.tile_spec, self.params, self.psatd)

    def evolve(self, numsteps: int = -1) -> SimState:
        """Advance ``numsteps`` steps (or to max_step), with WarpX::Evolve's
        synchronization pattern."""
        if self.state is None:
            self.init()
        cfg = self.cfg
        start = self.state.step
        stop = (cfg.max_step if numsteps < 0
                else min(start + numsteps, cfg.max_step))
        timer = StepTimer(self.device) if cfg.verbose else None
        signals = self.signals
        leapfrog = self.implicit is None
        # the user callbacks (utils/callbacks.py) at JAX's sites and in its
        # order (simulation.py:1352-1411); an empty registry costs nothing
        hooks = _cb_registry
        for step in range(start, stop):
            if signals is not None and signals.break_requested:
                # graceful break on a signal (WarpXEvolve.cpp:457-462)
                if hooks:
                    _cb("onbreaksignal")
                break
            if hooks:
                # the hooks of phases inside the step fire at its start
                for h in ("beforestep", "particleinjection",
                          "particlescraper", "beforedeposition",
                          "beforecollisions"):
                    _cb(h)
            if self.is_synchronized and leapfrog:
                # push the momenta back half a step (WarpXEvolve.cpp:493-505)
                self.state = self._half_push(-0.5 * cfg.dt)
                self.is_synchronized = False
            self.state = self.step(self.state)
            self._do_flux_injection()
            self.resample(step + 1)
            if step == cfg.max_step - 1 and leapfrog:
                # synchronize: forward half push with the new fields
                self.state = self._half_push(0.5 * cfg.dt)
                self.is_synchronized = True
            if self.is_bounded:
                # MoveWindow and the particle boundaries; J moves along when
                # synchronized (WarpXEvolve.cpp:246)
                self.state = self.stepper.step_window(
                    self.state, move_j=self.is_synchronized,
                    draws=self.draws)
            if hooks:
                for h in ("afterdeposition", "aftercollisions"):
                    _cb(h)
            if self.is_bounded and self.stepper.is_es:
                # the electrostatic solve at the end of the PIC loop
                # (WarpXEvolve.cpp:269-283)
                if hooks:
                    _cb("beforeEsolve")
                self.state = self.stepper.solve_es(self.state)
                if hooks:
                    _cb("afterEsolve")
            self.flush_diagnostics(step + 1)
            for btd in self.btd:
                btd.update(self)
            if hooks:
                _cb("afterdiagnostics")
                _cb("afterstep")
            if timer is not None:
                timer.step_done(step + 1, float(self.state.time), cfg.dt)
            if signals is not None and signals.pop_checkpoint():
                # checkpoint on a signal (WarpXEvolve.cpp:1248-1259)
                if hooks:
                    _cb("oncheckpointsignal")
                save_checkpoint(
                    os.path.join(self.output_dir,
                                 f"chk_signal{step + 1:06d}"),
                    self.state, self.is_synchronized, self.draws)
        return self.state

    def resample(self, timestep: int) -> None:
        """Resample each species whose trigger fires after step
        ``timestep`` (doResampling(istep + 1), WarpXEvolve.cpp:212;
        ResamplingTrigger: an interval of
        ``resampling_trigger_intervals``, or an average of alive particles
        per cell above ``resampling_trigger_max_avg_ppc``, which waits for
        the device to count them), on the numbers of ``self.draws``."""
        from ..ops.resampling import (leveling_thinning,
                                      velocity_coincidence_thinning)

        cfg = self.cfg
        n_cells = float(math.prod(cfg.geometry.n_cell))
        for sp_cfg in cfg.species:
            if not sp_cfg.do_resampling:
                continue
            sp = self.state.species[sp_cfg.name]
            fire = self._resampling_triggers[sp_cfg.name].contains(timestep)
            if not fire and math.isfinite(
                    sp_cfg.resampling_trigger_max_avg_ppc):
                fire = (float(sp.alive.sum()) / n_cells
                        > sp_cfg.resampling_trigger_max_avg_ppc)
            if not fire:
                continue
            if sp_cfg.resampling_algorithm == "velocity_coincidence_thinning":
                sp = velocity_coincidence_thinning(
                    sp, cfg.geometry, self.draws,
                    grid_type=sp_cfg.resampling_velocity_grid_type,
                    delta_ur=sp_cfg.resampling_delta_ur,
                    n_theta=sp_cfg.resampling_n_theta,
                    n_phi=sp_cfg.resampling_n_phi,
                    delta_u=sp_cfg.resampling_delta_u,
                    min_ppc=sp_cfg.resampling_min_ppc)
            else:
                sp = leveling_thinning(
                    sp, cfg.geometry, self.draws,
                    target_ratio=sp_cfg.resampling_target_ratio)
            self.state = self.state.replace(
                species={**self.state.species, sp_cfg.name: sp})

    def _half_push(self, dt_half: float) -> SimState:
        if self.rz is not None:
            return self.rz.half_push(self.state, dt_half)
        if self.is_bounded:
            return self.stepper.half_push(self.state, dt_half)
        if self.mr_half_push is not None:
            return self.mr_half_push(self.state, dt_half)
        return push_momenta_half(self.state, self.cfg, self.staggering,
                                 dt_half)

    def _normalize_binned(self):
        """Assert the tile-layout invariants (no slot overflow, no drift
        beyond the rebin margin) and wrap the positions back into the
        periodic domain before any host-side output.  On a bounded domain
        only the periodic particle dims wrap: behind a moving window live
        particles rightly sit outside the static bounds."""
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
        if self.is_bounded:
            def wrap(sp):
                return sp.with_positions(
                    geom.ndim,
                    self.stepper._wrap_periodic(sp.positions(geom.ndim)))
        else:
            def wrap(sp):
                return wrap_positions(sp, geom)
        self.state = self.state.replace(species={
            nm: wrap(sp) for nm, sp in self.state.species.items()})

    # ------------------------------------------------------------- outputs
    def flush_diagnostics(self, step: int):
        """Write the outputs due at ``step`` (the step just completed).  A
        step with nothing due touches no tensor, so it adds no wait for the
        device."""
        if not any(o["intervals"].contains(step)
                   for o in self.reduced + self.diags):
            return
        self._normalize_binned()
        for rd in self.reduced:
            if rd["intervals"].contains(step):
                vals = compute_reduced(rd["kind"], self.state, self.cfg,
                                       self.staggering, params=rd["params"])
                rd["writer"].write(step, float(self.state.time), vals)
        for dg in self.diags:
            if not dg["intervals"].contains(step):
                continue
            path = os.path.join(self.output_dir, f"{dg['name']}{step:06d}")
            if dg["format"] == "checkpoint":
                save_checkpoint(path, self.state, self.is_synchronized,
                                self.draws)
                continue
            wanted = dg["fields"]
            fields = {}
            if wanted != ["none"] and self.rz is not None:
                # the RZ plotfile's names (JAX simulation.py:506-509)
                fields = dict(sorted(
                    (k, v) for k, v in self._rz_output().items()
                    if not wanted or k in wanted))
            elif wanted != ["none"]:
                # by name, the order of the JAX package's files
                fields = dict(sorted(cell_centered_output(
                    self.state, self.cfg, self.staggering,
                    names=wanted or None, psatd=self.psatd).items()))
            select = self._particle_select(dg["pfilters"])
            if dg["format"] == "plotfile":
                self._flush_plotfile(dg, path, step, fields, select)
            else:
                write_openpmd_iteration(
                    os.path.join(self.output_dir, f"{dg['name']}.h5"), step,
                    self.state, self.cfg, fields, float(self.state.time),
                    self.cfg.dt, current_origin(self.state, self.cfg),
                    species_names=dg["species"], select=select)

    def plotfile_particles(self, species_names=None, select=None):
        """The particle columns a plotfile holds, per species: the alive
        (and selected) slots compacted on the device, positions, momenta
        m*u and weights as host arrays."""
        ndim = self.cfg.geometry.ndim
        out = {}
        for sp_cfg in self.cfg.species:
            if species_names is not None and sp_cfg.name not in species_names:
                continue
            sp = self.state.species[sp_cfg.name]
            if sp.capacity == 0:
                continue
            mask = sp.alive
            if select and sp_cfg.name in select:
                mask = mask & select[sp_cfg.name]
            cols = compact_columns(
                mask, [*sp.positions(ndim), sp.ux, sp.uy, sp.uz, sp.w,
                       *sp.extra.values()])
            attrs = dict(zip(["x", "y", "z"][:ndim], cols[:ndim]))
            for c, u in zip("xyz", cols[ndim:ndim + 3]):
                attrs[f"momentum_{c}"] = sp_cfg.mass * u
            attrs["weight"] = cols[ndim + 3]
            # the runtime attributes as extra real components
            attrs.update(zip(sp.extra, cols[ndim + 4:]))
            out[sp_cfg.name] = attrs
        return out

    def _flush_plotfile(self, dg, path, step, fields, select):
        """The AMReX plotfile ``<output_dir>/<diag><step:06d>/``
        (FlushFormatPlotfile; io/plotfile.py) of the cell-centered
        ``fields`` and the selected particles, at the window's origin."""
        geom = self.cfg.geometry
        origin = [float(o) for o in current_origin(self.state, self.cfg)]
        prob_hi = [o + hi - lo for o, lo, hi in zip(origin, geom.prob_lo,
                                                     geom.prob_hi)]
        # a plotfile holds at least one component
        levels = [{k: host(v) for k, v in fields.items()} if fields
                  else {"Ex": host(self.state.fields.Ex)}]
        ref_ratio = []
        if self.mr_layout is not None and fields:
            # level 1: the covering grid of the lev=1 checksums, the
            # requested components (JAX simulation.py:558-568)
            lev1 = mr_output_fields(self.state, self.cfg, self.staggering,
                                    self.mr_layout)
            levels.append({k: lev1[k] for k in fields if k in lev1})
            ref_ratio.append(tuple(self.mr_layout.rv))
        write_plotfile(
            path, levels, prob_lo=origin, prob_hi=prob_hi,
            time=float(self.state.time), step=step, ref_ratio=ref_ratio,
            particles=self.plotfile_particles(dg["species"], select))

    def _particle_select(self, pfilters):
        """Per-species output masks on the state's device from a
        diagnostic's particle filters (reference: Source/Diagnostics/
        FilterFunctors: a parsed filter of (t,x,y,z,ux,uy,uz), u in units of
        c; every k-th slot; a random fraction drawn on the host from the
        seed and the step, as the JAX package draws it)."""
        if not pfilters:
            return None
        geom = self.cfg.geometry
        act = {1: (2,), 2: (0, 2), 3: (0, 1, 2)}[geom.ndim]
        rng = np.random.default_rng(self.cfg.seed + int(self.state.step))
        consts = self.deck.my_constants if self.deck is not None else {}
        select = {}
        for spn, f in pfilters.items():
            sp = self.state.species[spn]
            n = sp.capacity
            mask = torch.ones(n, dtype=torch.bool, device=self.device)
            if "filter" in f:
                xyz = [torch.zeros_like(sp.w)] * 3
                for d, a in enumerate(act):
                    xyz[a] = sp.positions(geom.ndim)[d]
                u = [getattr(sp, "u" + c) / _c for c in "xyz"]
                fn = compile_expression(
                    f["filter"], ("t", "x", "y", "z", "ux", "uy", "uz"),
                    consts)
                mask &= fn(float(self.state.time), *xyz, *u) > 0
            if "stride" in f:
                mask &= torch.arange(n, device=self.device) % max(
                    int(f["stride"]), 1) == 0
            if "fraction" in f:
                mask &= torch.from_numpy(
                    rng.random(n) < float(f["fraction"])).to(self.device)
            select[spn] = mask
        return select

    def field_diagnostics(self) -> Dict[str, torch.Tensor]:
        if self.rz is not None:
            return self._rz_output()
        return cell_centered_output(self.state, self.cfg, self.staggering,
                                    psatd=self.psatd)

    def checksums(self) -> Dict[str, Dict[str, float]]:
        if self.rz is not None:
            # JAX simulation.py:1547-1550
            return rz_checksums(self.state, self.cfg,
                                getattr(self.rz, "solver", None))
        self._normalize_binned()
        return compute_checksums(self.state, self.cfg, self.staggering,
                                 psatd=self.psatd, mr_layout=self.mr_layout)


def _dist_refusals(what: str):
    """The ``need`` of a distributed simulation's ``_check_supported``:
    raises ``what`` with the item for a feature it does not run."""
    def need(ok: bool, item: str) -> None:
        if not ok:
            raise NotImplementedError(what.format(item))
    return need


class DistSimulation(Simulation):
    """A simulation spread over the ranks of a ``torch.distributed``
    process group, one spatial block of the grid per rank (the counterpart
    of ``warpx_tpu.core.simulation.DistSimulation``).

    ``mesh_shape`` maps axis names to shard counts (``{"x": 2, "z": 2}``);
    its product must be the group's size.  ``device=None`` takes
    ``cuda:$LOCAL_RANK``; ``device="cpu"`` runs over gloo.  Every rank
    builds the whole initial state on its device from the same seed, then
    keeps its block of the fields and its own segment of the particles
    (``parallel/distribute.py``); the step is ``core/sharded_step.py``'s.
    ``checksums``, ``field_diagnostics`` and ``gather_state`` are
    collectives: every rank calls them and gets the same numbers.  The
    single-device ``Simulation`` is the parity reference.
    """

    #: configuration features the sharded step implements; anything else
    #: must fail rather than silently run periodic Yee
    @staticmethod
    def _check_supported(cfg: SimConfig) -> None:
        geom = cfg.geometry
        need = _dist_refusals(
            "DistSimulation does not implement {} yet; use the single-chip "
            "Simulation")
        need(not geom.rz, "RZ geometry under sharding")
        need(all(geom.periodic), "non-periodic boundaries under sharding")
        need(cfg.em_solver in ("yee",), f"em_solver={cfg.em_solver} under sharding")
        need(cfg.electrostatic == "none", "electrostatic solve under sharding")
        need(cfg.evolve_scheme == "explicit", "implicit schemes under sharding")
        need(not cfg.do_moving_window, "moving window under sharding")
        need(not cfg.lasers, "laser antennas under sharding")
        need(not cfg.fluids, "fluid species under sharding")
        need(not cfg.collisions, "collisions under sharding")
        need(not cfg.use_filter, "bilinear filter under sharding")
        need(not cfg.lattice_elements, "accelerator lattice under sharding")
        need(not cfg.do_qed_schwinger, "Schwinger pair production under sharding")
        for sp in cfg.species:
            need(not sp.do_field_ionization, "field ionization under sharding")
            need(not (sp.do_qed_quantum_sync or sp.do_qed_breit_wheeler),
                 "QED processes under sharding")
        # what the sharded step would drop without a word, as the JAX
        # package's does (ROADMAP.md Queue C)
        need(cfg.max_level == 0, "mesh refinement under sharding")
        need(cfg.grid_type == "staggered"
             and cfg.field_gathering != "momentum-conserving",
             "collocated or hybrid grids, momentum-conserving gathering "
             "under sharding")
        need(cfg.current_deposition in ("esirkepov", "direct"),
             f"current_deposition={cfg.current_deposition} under sharding")
        need(not (any(cfg.e_ext_particle) or any(cfg.b_ext_particle)),
             "external particle fields under sharding")
        need(not (cfg.do_dive_cleaning or cfg.do_divb_cleaning),
             "divergence cleaning under sharding")
        need(cfg.em_solver_medium != "macroscopic",
             "a macroscopic medium under sharding")
        need(not cfg.use_nci_corr, "the NCI corrector under sharding")
        for sp in cfg.species:
            need(not sp.attributes, "runtime attributes under sharding")
            need(not sp.do_resampling, "resampling under sharding")
            need(sp.injection_style != "nfluxpercell",
                 "flux injection under sharding")
            need(sp.zinject_plane is None, "rigid injection under sharding")
            need(sp.species_type != "photon" and sp.mass != 0.0,
                 "photon species under sharding")

    def __init__(self, cfg: SimConfig, mesh_shape: Dict[str, int],
                 dtype: torch.dtype = torch.float32, headroom: float = 1.5,
                 device: torch.device | str | None = None, group=None):
        self._check_supported(cfg)
        device = rank_device(device, group)
        self.smesh = SpatialMesh.create(mesh_shape, group)
        super().__init__(cfg, dtype=dtype, device=device)
        # the sharded path has its own layout: no tile binning
        self.binned = False
        self.params = self.tile_spec = None
        self.headroom = headroom
        self._step = make_sharded_step(cfg, self.staggering, self.smesh)
        self._half_push_fn = make_sharded_half_push(cfg, self.staggering,
                                                    self.smesh)
        self._lb_intervals = IntervalsParser(cfg.load_balance_intervals)
        self._balanced = False  # particles still live with their slab owner

    @property
    def rank(self) -> int:
        return self.smesh.rank

    def init(self, seed: int | None = None) -> SimState:
        state = super().init(seed)
        aux = dict(state.aux)
        aux.setdefault("lost", torch.zeros((), dtype=torch.int32,
                                           device=self.device))
        aux.setdefault("lb_efficiency", torch.ones((), dtype=self.dtype,
                                                   device=self.device))
        self.state = distribute_state(state.replace(aux=aux),
                                      self.cfg.geometry, self.smesh,
                                      self.headroom)
        return self.state

    def step(self, state: SimState) -> SimState:
        return self._step(state)

    def _half_push(self, dt_half: float) -> SimState:
        return self._half_push_fn(self.state, dt_half)

    def assert_no_lost(self) -> None:
        """Fail loudly if the fixed-K particle exchange buffers overflowed.

        The reference's Redistribute cannot lose particles; the fixed
        buffers can, so the step counts the overflow into aux['lost'] (the
        same on every rank) and the host asserts here."""
        lost = self.state.aux.get("lost")
        if lost is not None:
            n = int(lost)
            if n:
                raise RuntimeError(
                    f"{n} particles overflowed the exchange buffers "
                    "(increase headroom / exchange capacity K)"
                )

    def evolve(self, numsteps: int = -1) -> SimState:
        if not self._lb_intervals.is_activated():
            state = super().evolve(numsteps)
            self.assert_no_lost()
            return state
        # single-step the base loop so that the rebalance fires at the
        # algo.load_balance_intervals boundaries (WarpXEvolve.cpp:434
        # `if (step > 0 && load_balance_intervals.contains(step+1))`)
        if self.state is None:
            self.init()
        cfg = self.cfg
        start = self.state.step
        stop = cfg.max_step if numsteps < 0 else min(start + numsteps,
                                                     cfg.max_step)
        for _ in range(start, stop):
            super().evolve(1)
            t = self.state.step
            if t < cfg.max_step and self._lb_intervals.contains(t):
                self.load_balance()
        self.assert_no_lost()
        return self.state

    # -- the global view, by collectives -----------------------------------
    def gather_state(self) -> SimState:
        """The global state in the JAX package's layout: whole fields, each
        species' slot axis the ranks' segments in rank order; on every
        rank (a collective)."""
        st = self.state
        geom = self.cfg.geometry
        fields = st.fields.replace(**{
            nm: all_gather_grid(getattr(st.fields, nm), geom, self.smesh)
            for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")})
        species = {nm: gather_particles(sp, self.smesh.group,
                                        self.smesh.total_shards)
                   for nm, sp in st.species.items()}
        return st.replace(fields=fields, species=species)

    def checksums(self) -> Dict[str, Dict[str, float]]:
        return compute_checksums(self.gather_state(), self.cfg,
                                 self.staggering)

    def field_diagnostics(self) -> Dict[str, torch.Tensor]:
        return cell_centered_output(self.gather_state(), self.cfg,
                                    self.staggering)

    def _setup_diagnostics(self, outputs: dict, output_dir: str):
        _dist_outputs(outputs)
        super()._setup_diagnostics(outputs, output_dir)

    def flush_diagnostics(self, step: int):
        _dist_flush(self, step)

    # -- dynamic load balancing (WarpXRegrid.cpp:74-160 analog) -------------
    def _tile_grid(self) -> tuple:
        """Per-axis tile counts for cost binning: the shard grid refined
        until there are >= 8 tiles per rank (the over-decomposition that
        gives makeKnapSack/makeSFC something to trade)."""
        geom = self.cfg.geometry
        tiles = [max(1, self.smesh.n_shards(ax)) for ax in geom.axis_names]
        n_chips = self.smesh.total_shards
        while int(np.prod(tiles)) < 8 * n_chips:
            # double the axis with the fewest tiles that still has cells
            cand = [d for d in range(geom.ndim)
                    if tiles[d] * 2 <= geom.n_cell[d]]
            if not cand:
                break
            d = min(cand, key=lambda i: tiles[i])
            tiles[d] *= 2
        return tuple(tiles)

    def measure_costs(self):
        """Per-tile and per-rank heuristic costs of the live state:
        (tiles, tile costs, rank costs, each species' tile index per local
        slot, -1 for a dead one).

        cost = cells_wt * n_cells + particles_wt * n_particles
        (ComputeCostsHeuristic, WarpXRegrid.cpp:316; weights
        algo.costs_heuristic_*_wt).  The fields stay on even slabs, so the
        cell term is a constant per rank; the particle term follows slot
        ownership.  The tile counts are all-reduced and the ranks' counts
        all-gathered, so every rank computes the same costs."""
        cfg = self.cfg
        geom = cfg.geometry
        smesh = self.smesh
        n_chips = smesh.total_shards
        tiles = self._tile_grid()
        n_tiles = int(np.prod(tiles))
        kw = dict(dtype=torch.int64, device=self.device)
        tile_counts = torch.zeros(n_tiles, **kw)
        mine = torch.zeros(1, **kw)
        owner_tile = {}
        for sp_cfg in cfg.species:
            sp = self.state.species[sp_cfg.name]
            if sp.capacity == 0:
                owner_tile[sp_cfg.name] = torch.zeros(0, **kw)
                continue
            idx = torch.zeros(sp.capacity, **kw)
            for d, p in enumerate(sp.positions(geom.ndim)):
                ext = (geom.prob_hi[d] - geom.prob_lo[d]) / tiles[d]
                cell = torch.div(p - geom.prob_lo[d], ext,
                                 rounding_mode="floor").long()
                idx = idx * tiles[d] + torch.clamp(cell, 0, tiles[d] - 1)
            idx = torch.where(sp.alive, idx, torch.full_like(idx, -1))
            owner_tile[sp_cfg.name] = idx
            tile_counts += torch.bincount(idx[idx >= 0], minlength=n_tiles)
            mine += sp.alive.sum()
        if n_chips > 1:
            dist.all_reduce(tile_counts, group=smesh.group)
            parts = [torch.zeros_like(mine) for _ in range(n_chips)]
            dist.all_gather(parts, mine, group=smesh.group)
            mine = torch.cat(parts)
        chip_counts = mine.cpu().numpy()
        cw, pw = cfg.costs_heuristic_cells_wt, cfg.costs_heuristic_particles_wt
        cells_per_chip = float(np.prod(geom.n_cell)) / n_chips
        tile_costs = pw * tile_counts.cpu().numpy().astype(np.float64)
        chip_costs = pw * chip_counts.astype(np.float64) + cw * cells_per_chip
        return tiles, tile_costs, chip_costs, owner_tile

    def load_balance(self) -> bool:
        """Propose a new tile->rank assignment and adopt it when the
        efficiency gain beats algo.load_balance_efficiency_ratio_threshold
        (the doLoadBalance test, WarpXRegrid.cpp:119-124).  Adoption
        repacks every species' slots to the assigned ranks, in their global
        slot order, and switches the step to balanced mode (all-gathered
        gather fields, one J all-reduce): the counterpart of the
        reference's RemakeLevel + Redistribute.  Returns True when
        adopted."""
        cfg = self.cfg
        geom = cfg.geometry
        n_chips = self.smesh.total_shards
        tiles, tile_costs, chip_costs, owner_tile = self.measure_costs()
        cur_eff = float(chip_costs.mean() / chip_costs.max()) \
            if chip_costs.max() > 0 else 1.0
        if cfg.load_balance_with_sfc:
            order = morton_order(tiles)
            assign = sfc_assignment(tile_costs, order, n_chips)
        else:
            nmax = int(math.ceil(
                len(tile_costs) / n_chips * cfg.load_balance_knapsack_factor
            ))
            assign = knapsack_assignment(tile_costs, n_chips, nmax)
        cw = cfg.costs_heuristic_cells_wt
        cells_per_chip = float(np.prod(geom.n_cell)) / n_chips
        loads = np.bincount(assign, weights=tile_costs, minlength=n_chips)
        loads = loads + cw * cells_per_chip
        new_eff = float(loads.mean() / loads.max()) if loads.max() > 0 else 1.0

        aux = dict(self.state.aux)
        adopt = new_eff > cur_eff * cfg.load_balance_efficiency_ratio_threshold
        self.last_assignment = assign
        if adopt:
            assign_t = torch.as_tensor(assign, device=self.device)
            species = {}
            for sp_cfg in cfg.species:
                sp = self.state.species[sp_cfg.name]
                if sp.capacity == 0:
                    species[sp_cfg.name] = sp
                    continue
                idx = owner_tile[sp_cfg.name]
                owner = torch.where(idx >= 0, assign_t[idx.clamp(min=0)],
                                    torch.full_like(idx, -1))
                species[sp_cfg.name] = self._repack(sp, owner)
            aux["lb_efficiency"] = torch.tensor(new_eff, dtype=self.dtype,
                                                device=self.device)
            self.state = self.state.replace(species=species, aux=aux)
            self._enter_balanced_mode()
        else:
            aux["lb_efficiency"] = torch.tensor(cur_eff, dtype=self.dtype,
                                                device=self.device)
            self.state = self.state.replace(aux=aux)
        if cfg.verbose and self.rank == 0:
            print(
                f"load balance @step {self.state.step}: efficiency "
                f"{cur_eff:.3f} -> {new_eff:.3f} "
                f"({'adopted' if adopt else 'kept'})"
            )
        return adopt

    def _repack(self, sp: ParticleState, owner: torch.Tensor):
        """This rank's new segment: the particles assigned to it, in
        global slot order, then dead slots at the domain's center (the JAX
        package's ``pack_by_owner`` on the all-gathered slots)."""
        geom = self.cfg.geometry
        n = self.smesh.total_shards
        cap = sp.capacity
        g = gather_particles(sp, self.smesh.group, n)
        if n > 1:
            parts = [torch.empty_like(owner) for _ in range(n)]
            dist.all_gather(parts, owner, group=self.smesh.group)
            owner = torch.cat(parts)
        counts = torch.bincount(owner[owner >= 0], minlength=n)
        if counts.numel() and int(counts.max()) > cap:
            raise RuntimeError(
                f"load-balance repack overflow: a chip was assigned "
                f"{int(counts.max())} particles > segment capacity {cap}; "
                "increase headroom"
            )
        sel = torch.nonzero(owner == self.rank).reshape(-1)
        k = sel.numel()

        def pack(t, fill=0.0):
            out = torch.full((cap,), fill, dtype=t.dtype, device=t.device)
            out[:k] = t[sel]
            return out

        centers = [0.5 * (lo + hi) for lo, hi in zip(geom.prob_lo,
                                                     geom.prob_hi)]
        return sp.replace(
            w=pack(g.w), ux=pack(g.ux), uy=pack(g.uy), uz=pack(g.uz),
            alive=torch.arange(cap, device=self.device) < k,
            extra={nm: pack(v, 0) for nm, v in g.extra.items()},
        ).with_positions(geom.ndim, [
            pack(p, c) for p, c in zip(g.positions(geom.ndim), centers)])

    def _enter_balanced_mode(self) -> None:
        """Swap to the balanced step: particles ride their assigned rank,
        the gather reads all-gathered fields, the deposit all-reduces J to
        the slab owners."""
        if self._balanced:
            return
        self._step = make_balanced_step(self.cfg, self.staggering,
                                        self.smesh)
        self._half_push_fn = make_balanced_half_push(
            self.cfg, self.staggering, self.smesh)
        self._balanced = True


def _dist_outputs(outputs: dict) -> None:
    """A distributed run writes reduced diagnostics only (rank 0, from the
    gathered state)."""
    if outputs["diags"] or outputs.get("btd") or outputs.get(
            "break_signals") or outputs.get("checkpoint_signals"):
        raise NotImplementedError(
            "plotfile, openPMD, back-transformed and checkpoint outputs of a "
            "distributed run (ROADMAP.md Queue A 14.4)")


def _dist_flush(sim, step: int) -> None:
    """The reduced diagnostics due at ``step``, computed on rank 0 from the
    gathered state (every rank joins the gather)."""
    due = [rd for rd in sim.reduced if rd["intervals"].contains(step)]
    if not due:
        return
    state = sim.gather_state()
    if sim.rank != 0:
        return
    for rd in due:
        vals = compute_reduced(rd["kind"], state, sim.cfg, sim.staggering,
                               params=rd["params"])
        rd["writer"].write(step, float(state.time), vals)
