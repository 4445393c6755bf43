"""The ``Simulation`` class for the explicit paths, 2D XZ and 3D, periodic
and bounded.

The counterpart of ``warpx_tpu.core.simulation.Simulation`` cut to the
paths this port covers: ``init`` (injection from ``np.random.default_rng``
in the JAX package's order, then the tile-binned layout unless
``tiled_particles="off"``), ``evolve`` (with the -dt/2 and +dt/2 momentum
half-pushes of WarpXEvolve.cpp:222-229, 493-505) and ``checksums``.  On the
periodic torus the step is the tile-binned ``binned_pic_step``, or the
per-particle ``pic_step`` for ``tiled_particles="off"``.  A configuration
with a non-periodic field face, a moving window or a laser runs through
``core/bounded_step.py::BoundedStepper`` (``is_bounded``): ``step_binned``
or ``step_main``, then ``step_window`` after every step.  ``from_deck``
builds one from an inputs deck (``core/deck.py``) with the deck's outputs,
which ``evolve`` writes on their schedule after each step
(``flush_diagnostics``: plotfile, openPMD, checkpoint and reduced
diagnostics under ``output_dir``).  The simulation runs on the CUDA device
unless the caller names another device; with no GPU it raises rather than
run on the CPU unasked.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict

import numpy as np
import torch

from ..constants import c as _c
from ..diagnostics.checksum import compute_checksums
from ..diagnostics.fields import cell_centered_output, current_origin
from ..diagnostics.reduced import ReducedDiagWriter, compute_reduced
from ..io.checkpoint import save_checkpoint
from ..io.openpmd import compact_columns, host, write_openpmd_iteration
from ..io.plotfile import write_plotfile
from ..utils.expression import compile_expression
from ..utils.observability import SignalFlags, StepTimer
from ..utils.parser import Deck
from .binned_step import (binned_pic_step, binned_supported,
                           bounded_binned_supported, make_tile_spec,
                           pusher_params)
from .bounded_step import (B_TERMS, E_TERMS, BoundedStepper,
                           check_bounded_supported, needs_bounded_step)
from .config import SimConfig
from .deck import config_from_deck, outputs_from_deck
from .grid import yee_staggering
from .injection import (columns_to_state, inject_gaussian_beam_host,
                        inject_species, inject_species_host)
from .laser import antenna_particles
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
        self.is_bounded = needs_bounded_step(cfg)
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
        self.staggering = yee_staggering(cfg.geometry.ndim)
        self.state: SimState | None = None
        self.tile_spec = None
        self.is_synchronized = True
        self.stepper = None
        self.deck: Deck | None = None
        self.output_dir = "diags"
        self.diags: list = []
        self.reduced: list = []
        self.signals: SignalFlags | None = None
        if self.is_bounded:
            check_bounded_supported(cfg)
            self.params = None
        else:
            self.params = (pusher_params(cfg, dtype, self.device)
                           if self.binned else None)

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
        MultiDiagnostics / MultiReducedDiags): the reduced diagnostics'
        writers under ``<output_dir>/reducedfiles``, the signal handlers."""
        self.output_dir = output_dir
        self.diags = outputs["diags"]
        self.reduced = [
            dict(rd, writer=ReducedDiagWriter(
                os.path.join(output_dir, "reducedfiles"), rd["name"],
                rd["kind"]))
            for rd in outputs["reduced"]]
        if outputs["break_signals"] or outputs["checkpoint_signals"]:
            self.signals = SignalFlags(outputs["break_signals"],
                                       outputs["checkpoint_signals"])

    def init(self, seed: int | None = None) -> SimState:
        cfg = self.cfg
        geom = cfg.geometry
        rng = np.random.default_rng(seed if seed is not None else cfg.seed)
        if self.is_bounded:
            return self._init_bounded(rng)
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
        host, aux = {}, {}
        for sp_cfg in cfg.species:
            if sp_cfg.injection_style == "laser":
                laser = next(las for las in cfg.lasers
                             if las.name == sp_cfg.name)
                cols, _, _ = antenna_particles(laser, geom, ft)
            elif sp_cfg.injection_style == "gaussian_beam":
                cols = inject_gaussian_beam_host(sp_cfg, geom, rng, ft)
            else:
                capacity = None
                if sp_cfg.do_continuous_injection and cfg.do_moving_window:
                    # room for what the window uncovers over the whole run
                    ppc = sp_cfg.num_particles_per_cell_each_dim
                    ppc_tot = int(np.prod(ppc)) if ppc else 1
                    cross = int(np.prod([geom.n_cell[d] for d in range(ndim)
                                         if d != wdir]))
                    travel_cells = math.ceil(
                        cfg.moving_window_v * _c * cfg.dt * cfg.max_step
                        / geom.dx[wdir]) + 4
                    first = inject_species_host(sp_cfg, geom, rng, ft)
                    capacity = (int(first["alive"].sum())
                                + travel_cells * cross * ppc_tot)
                    del first
                cols = inject_species_host(sp_cfg, geom, rng, ft, capacity)
            host[sp_cfg.name] = cols
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
        self.stepper = BoundedStepper(
            cfg, self.staggering, self.dtype, self.device,
            tile_spec=self.tile_spec, slow_species=slow)

        kw = dict(dtype=self.dtype, device=self.device)
        shapes = self.stepper.shapes
        if self.stepper.has_pml:
            # Berenger split fields, one part per curl term
            for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
                for term in (E_TERMS if nm[0] == "E" else B_TERMS)[nm]:
                    if term[2] in geom.axis_names:
                        aux[f"pml:{nm}:{term[2]}"] = torch.zeros(shapes[nm],
                                                                 **kw)
        fields = FieldState(**{
            nm: torch.zeros(shapes[nm], **kw)
            for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")})
        species = {nm: columns_to_state(cols, self.device)
                   for nm, cols in host.items()}
        self.state = SimState(fields=fields, species=species, step=0,
                              time=0.0, aux=aux)
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
        step.  Returns (columns, the names of those species)."""
        cfg = self.cfg
        geom = cfg.geometry
        ndim = geom.ndim
        names = ("x", "z") if ndim == 2 else ("x", "y", "z")
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
            if alive.any():
                max_alive = max(max_alive, int(alive.sum()))
                idx = np.zeros(int(alive.sum()), np.int64)
                for d in range(ndim):
                    p = cols[names[d]][alive]
                    cell = np.clip(
                        np.floor((p - geom.prob_lo[d]) / geom.dx[d])
                        .astype(np.int64) // tile[d], 0, ntpd[d] - 1)
                    idx = idx * ntpd[d] + cell
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
            take = np.argsort(~alive, kind="stable")[:cap]
            out = {}
            for k, a in cols.items():
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
        if self.is_bounded:
            return self.stepper.step(state)
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
        timer = StepTimer(self.device) if cfg.verbose else None
        signals = self.signals
        for step in range(start, stop):
            if signals is not None and signals.break_requested:
                # graceful break on a signal (WarpXEvolve.cpp:457-462)
                break
            if self.is_synchronized:
                # push the momenta back half a step (WarpXEvolve.cpp:493-505)
                self.state = self._half_push(-0.5 * cfg.dt)
                self.is_synchronized = False
            self.state = self.step(self.state)
            if step == cfg.max_step - 1:
                # synchronize: forward half push with the new fields
                self.state = self._half_push(0.5 * cfg.dt)
                self.is_synchronized = True
            if self.is_bounded:
                # MoveWindow and the particle boundaries; J moves along when
                # synchronized (WarpXEvolve.cpp:246)
                self.state = self.stepper.step_window(
                    self.state, move_j=self.is_synchronized)
            self.flush_diagnostics(step + 1)
            if timer is not None:
                timer.step_done(step + 1, float(self.state.time), cfg.dt)
            if signals is not None and signals.pop_checkpoint():
                # checkpoint on a signal (WarpXEvolve.cpp:1248-1259)
                save_checkpoint(
                    os.path.join(self.output_dir,
                                 f"chk_signal{step + 1:06d}"),
                    self.state, self.is_synchronized)
        return self.state

    def _half_push(self, dt_half: float) -> SimState:
        if self.is_bounded:
            return self.stepper.half_push(self.state, dt_half)
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
                save_checkpoint(path, self.state, self.is_synchronized)
                continue
            wanted = dg["fields"]
            fields = {}
            if wanted != ["none"]:
                # by name, the order of the JAX package's files
                fields = dict(sorted(cell_centered_output(
                    self.state, self.cfg, self.staggering,
                    names=wanted or None).items()))
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
                mask, [*sp.positions(ndim), sp.ux, sp.uy, sp.uz, sp.w])
            attrs = dict(zip(["x", "y", "z"][:ndim], cols[:ndim]))
            for c, u in zip("xyz", cols[ndim:ndim + 3]):
                attrs[f"momentum_{c}"] = sp_cfg.mass * u
            attrs["weight"] = cols[ndim + 3]
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
        level = ({k: host(v) for k, v in fields.items()} if fields
                 else {"Ex": host(self.state.fields.Ex)})
        write_plotfile(
            path, [level], prob_lo=origin, prob_hi=prob_hi,
            time=float(self.state.time), step=step,
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
        return cell_centered_output(self.state, self.cfg, self.staggering)

    def checksums(self) -> Dict[str, Dict[str, float]]:
        self._normalize_binned()
        return compute_checksums(self.state, self.cfg, self.staggering)
