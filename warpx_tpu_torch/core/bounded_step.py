"""PIC step on bounded (non-periodic) domains with a moving window.

The counterpart of ``warpx_tpu.core.bounded_step`` (there one closure,
``make_bounded_kernels``; here the class ``BoundedStepper``) for the explicit
FDTD and PSATD cases, 2D XZ and 3D:

* per-face field boundaries (periodic | pec | pml | absorbing Silver-Mueller
  | none) as guard fills on ng-padded blocks (WarpX_PEC.cpp mirror rules,
  ``core/boundaries.py``; zero guards elsewhere); a Silver-Mueller face owns
  one guard cell whose fields the curls leave alone and whose transverse B
  follows the first-order absorbing relation once a step; a
  component nodal in a bounded dimension stores n+1 values, both wall nodes
  included; PML strips are ordinary array regions (``core/domain.py``) that
  evolve the Berenger split fields ``aux["pml:<comp>:<axis>"]``;
* under PSATD, the spectral push over the whole extended box (periodic,
  damped and pml faces): damped zones ramp the fields down with a sin^2
  profile, PML strips evolve spectral split fields (with F/G splits under
  ``do_pml_dive_cleaning``) on the same box (``solvers/psatd.py``); the
  start- and end-of-step rho of update-with-rho and current correction,
  the time-averaged gather, and the Galilean drift: every gather and
  deposit origin moves with v_galilean to its own source time, and so do
  the physical bounds and the window's shift count;
* deposition guards at non-periodic faces are dropped, periodic ones folded
  (SumBoundary folds only the periodic directions, WarpXComm.cpp:1552);
* the bilinear filter of J on the padded block (WarpXComm.cpp:1357);
* laser antennas as prescribed-motion particle species that deposit current
  (LaserParticleContainer::Evolve);
* the moving window: a whole-cell shift of every field array, domain edges
  accumulated on the host, continuous plasma injection into the newly
  uncovered cells (WarpXMovingWindow.cpp:139-479);
* absorbing, reflecting and thermal particle boundaries (a thermal wall
  re-emits from the Gaussian flux distribution of ``boundary_u_th``), the
  boundary-scraping buffers of what the faces and the embedded boundary
  absorb (``aux["scrape:<species>:<face>:*"]``), continuous injection with
  constant, parsed or Gaussian momenta;
* collocated grids (the staggered up and down differences of the JAX
  package on nodal arrays) and momentum-conserving gathering (the padded
  blocks averaged to the nodes, ``mc_aux_pads``);
* rigid injection (``core/step.py::rigid_push``), the accelerator
  lattice's fields in 3D, and species that are not pushed, gather no field
  or deposit nothing (do_not_*);
* hyperbolic divergence cleaning (F/G, EvolveF.cpp / EvolveG.cpp): under
  FDTD the scalars advance half steps around the B pushes with their
  gradients fed back into E and B, and in the PML strips each term becomes
  a Berenger split of its own; under PSATD the spectral solver carries them;
* the Lorentz-boosted frame: the antenna at the lab time of its plane with
  its mobility divided by gamma, the injected plasma at its lab position
  (the ballistic correction at the boosted time) with boosted weights and
  momenta, and the injection front at the relativistic composition of the
  plasma's and the frame's speeds;
* the electrostatic solve (``solve_es``; every electrostatic run takes
  this step, an all-periodic one too): the step pushes the particles and
  deposits nothing, and after the window's move the Poisson solve per
  group (lab frame, relativistic per species, magnetostatic, the open-box
  IGF; Dirichlet wall potentials f(t)) replaces E and B and stores phi;
* the Godfrey NCI corrector on the padded gather blocks (per particle and
  ahead of the fused kernels' frame);
* an embedded boundary (``warpx.eb_implicit_function``, ``eb2.*``; per
  particle): the covered E edges and B faces frozen (staircase), or the
  ECT solver's cut-cell faces (``solvers/ect.py``), and the particles
  inside the body removed with the particle boundaries;
* two-level mesh refinement (``core/mr.py``; per particle): the fine
  patch rides the window, the particles deep in it gather from the fine
  aux and deposit on the fine grid, the fine J is averaged down into level
  0's block, both patch solutions advance in their PML rings, and
  ``warpx.refine_plasma`` injects the fine lattice in its footprint;
* field ionization before the push (``ops/ionization.py``), photon species
  streaming at c, the radiation-reaction pusher.  The JAX package's bounded
  step runs no QED event and no Schwinger pair creation: a configuration
  that asks for them raises (ROADMAP.md Queue C).

``step_main`` is the per-particle step and the oracle of ``step_binned``,
the tile-binned step: there the gather + push + deposit of the plasma runs
through the fused kernels (``ops/fused_pic.py``) over tiles anchored in
space where the window stood at the last rebin, while the grid slides under
them by whole cells (the kernels' ``anchors``/``zshift``/``smax`` mode);
guard fills, filter, field advance, PML, particle boundaries and injection
are shared with ``step_main``.

The window's scalars (``window_x``, ``window_lo``, ``window_hi``,
``window_offset``, ``tile_anchor``, ``inject_pos:<species>``) are host
numbers in the state's precision, and ``state.step`` is a host int, so every
branch of the step (rebin or not, inject or not, how far to shift) is
decided without waiting for the device.  The one wait is in
``continuous_injection``, which asks for the free slots
(``torch.nonzero``); it runs on the steps before a rebin only.

What the JAX function does beyond this raises ``NotImplementedError`` with
its ROADMAP.md queue item (``check_bounded_supported``).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..constants import c as _c
from ..constants import ep0 as _ep0
from ..constants import mu0 as _mu0
from ..ops.deposit import (deposit_current_direct, deposit_current_esirkepov,
                           deposit_rho)
from ..ops.fused_pic import binned_push_deposit, padded_shape
from ..ops.gather import gather_eb
from ..ops.push import PUSHERS, photon_position_step, position_step
from ..ops.tiling import fold_windows_open, rebin
from ..solvers import yee
from ..solvers.filter import bilinear_filter, bilinear_filter_padded
from ..solvers.psatd import PsatdPmlSolver, PsatdSolver
from .binned_step import _FOLD_AXES, pusher_groups, pusher_params
from .boundaries import fill_guards_pec, is_tangential
from .config import SimConfig
from .domain import DomainLayout
from .grid import Geometry
from .injection import (PARSED_PROFILES, _AXES3, _bulk_momentum,
                        _regular_unit_positions, attribute_values,
                        profile_values, xyz_of)
from .laser import update_antenna
from .mr import (MRLayout, add_patch_j, check_mr_supported, coarsen_field,
                 compute_aux1, deposit_slots, gather_levels,
                 make_patch_advance, patch_parts, select, to_nodal_torus)
from .state import SimState
from .step import (_add_ext, _apply_nci, check_lattice, collisions_substep,
                   galilean_velocity, ionization_substep, nodal_staggering,
                   rigid_push)

__all__ = ["BoundedStepper", "guard_width", "field_shapes",
           "check_bounded_supported", "needs_bounded_step"]

_COMP_AXIS = {"x": 0, "y": 1, "z": 2}
_c2 = _c * _c
_EB = ("Ex", "Ey", "Ez", "Bx", "By", "Bz")
_FIELDS = _EB + ("jx", "jy", "jz")

# Yee curl terms: output comp -> [(sign, input comp, diff xyz-axis, up|dn)]
B_TERMS = {
    "Bx": [(+1.0, "Ey", "z", "up"), (-1.0, "Ez", "y", "up")],
    "By": [(+1.0, "Ez", "x", "up"), (-1.0, "Ex", "z", "up")],
    "Bz": [(+1.0, "Ex", "y", "up"), (-1.0, "Ey", "x", "up")],
}
E_TERMS = {
    "Ex": [(+1.0, "Bz", "y", "dn"), (-1.0, "By", "z", "dn")],
    "Ey": [(+1.0, "Bx", "z", "dn"), (-1.0, "Bz", "x", "dn")],
    "Ez": [(+1.0, "By", "x", "dn"), (-1.0, "Bx", "y", "dn")],
}
# the divergence-cleaning scalars and their gradient feedback (EvolveF.cpp,
# EvolveG.cpp; EvolveE.cpp:218-240, EvolveB.cpp:192-209); in the PML each
# gradient term is a Berenger split of its own, keyed by its direction
F_TERMS = {"F": [(+1.0, "Ex", "x", "dn"), (+1.0, "Ey", "y", "dn"),
                 (+1.0, "Ez", "z", "dn")]}
G_TERMS = {"G": [(+1.0, "Bx", "x", "up"), (+1.0, "By", "y", "up"),
                 (+1.0, "Bz", "z", "up")]}
GRADF_TERMS = {"E" + a: [(+1.0, "F", a, "up")] for a in "xyz"}
GRADG_TERMS = {"B" + a: [(+1.0, "G", a, "dn")] for a in "xyz"}


def guard_width(cfg: SimConfig) -> int:
    ng = cfg.particle_shape + 3
    if cfg.use_filter:
        ng += max(cfg.filter_npass_each_dir or (1,))
    return ng


def field_shapes(cfg, staggering) -> Dict[str, tuple]:
    """Per-component allocated shapes (PML strips and wall nodes included)."""
    return DomainLayout.from_config(cfg).field_shapes(staggering)


def needs_bounded_step(cfg: SimConfig) -> bool:
    """Whether ``cfg`` runs through the bounded step: a non-periodic field
    face, a moving window, a laser, or an electrostatic solve (on an
    all-periodic box too, as the JAX package's
    ``Simulation._needs_bounded_kernels`` routes it)."""
    nonperiodic = any(bc != "periodic"
                      for bc in (cfg.field_bc_lo + cfg.field_bc_hi))
    return (nonperiodic or cfg.do_moving_window or bool(cfg.lasers)
            or cfg.electrostatic != "none")


def check_bounded_supported(cfg: SimConfig) -> None:
    """Refuse every branch of the JAX package's bounded step that is not
    ported, naming the ROADMAP.md item it waits for."""
    ndim = cfg.geometry.ndim

    def no(what, item):
        raise NotImplementedError(f"bounded step: {what} (ROADMAP.md {item})")

    if (cfg.start_moving_window_step != 0
            or cfg.end_moving_window_step != -1):
        # the JAX package reads the window's step range and never uses it
        no("a moving-window step range other than 0 / -1 (the JAX "
           "package moves the window from step 0 to the end)", "Queue C")
    if any(cfg.psatd_v_galilean) and cfg.em_solver != "psatd":
        raise NotImplementedError(
            "psatd.v_galilean without the PSATD solver")
    faces = (tuple(cfg.field_bc_lo or ("periodic",) * ndim)
             + tuple(cfg.field_bc_hi or ("periodic",) * ndim))
    if cfg.electrostatic != "none":
        # the field solver does not run: the Poisson solve replaces it
        if cfg.electrostatic not in ("labframe", "relativistic",
                                     "labframe-electromagnetostatic"):
            raise ValueError(f"electrostatic solver {cfg.electrostatic!r}")
        all_open = all(b == "open" for b in faces)
        # the JAX package's two errors (bounded_step.py:1955-1963)
        if cfg.poisson_solver == "fft" and not (all_open and ndim == 3):
            raise NotImplementedError(
                "poisson_solver=fft requires 3D open boundaries")
        if all_open and cfg.poisson_solver != "fft":
            raise NotImplementedError(
                "open field boundaries need warpx.poisson_solver = fft")
        for bc in faces:
            if bc not in ("periodic", "pec", "open"):
                no(f"the electrostatic solve with field boundary {bc!r} "
                   "(the JAX package's Poisson solve covers periodic, "
                   "Dirichlet and open faces)", "Queue C")
        if cfg.do_moving_window or cfg.lasers:
            no("the electrostatic solve with a moving window or a laser "
               "antenna (the JAX package neither deposits the antenna nor "
               "shifts phi)", "Queue C")
    elif cfg.em_solver == "psatd":
        for bc in tuple(cfg.field_bc_lo) + tuple(cfg.field_bc_hi):
            if bc not in ("periodic", "damped", "pml"):
                # the JAX package's refusal (bounded_step.py:128-139)
                no(f"PSATD with field boundary {bc!r} (the JAX package "
                   "refuses it: periodic, damped and pml only)", "Queue C")
    elif cfg.em_solver in ("hybrid", "none"):
        no(f"em_solver {cfg.em_solver!r} on the bounded step (the JAX "
           "package's bounded step advances the fields by Yee there)",
           "Queue C")
    elif cfg.em_solver not in ("yee", "ckc", "ect"):
        raise NotImplementedError(f"maxwell solver {cfg.em_solver}")
    else:
        for bc in faces:
            if bc in ("damped", "open"):
                # the JAX package gives them zero guards and no damping
                # under FDTD (bounded_step.py:519-560); the reference
                # allows damped faces with PSATD only and open faces with
                # the electrostatic solve
                no(f"field boundary {bc!r} under FDTD (the JAX package runs "
                   "it as a zero guard)", "Queue C")
            if bc not in ("periodic", "pec", "pml",
                          "absorbing_silver_mueller", "none"):
                raise NotImplementedError(f"field boundary {bc!r}")
        if "absorbing_silver_mueller" in faces and "pml" in faces:
            # the JAX package's refusal (bounded_step.py:341-342)
            no("mixing PML and Silver-Mueller (the JAX package refuses "
               "it)", "Queue C")
    if cfg.em_solver == "ect" and not cfg.eb_implicit_function:
        no("the ECT solver without an embedded boundary (the JAX "
           "package's bounded step runs plain Yee curls then)", "Queue C")
    if cfg.eb_implicit_function:
        # the JAX package's refusals (bounded_step.py:420-425, :459-466)
        if cfg.em_solver == "psatd":
            raise NotImplementedError(
                "embedded boundaries with PSATD (the JAX package refuses "
                "them too; ROADMAP.md Queue C)")
        if cfg.do_moving_window:
            raise NotImplementedError(
                "embedded boundaries with a moving window (the JAX "
                "package refuses them too; ROADMAP.md Queue C)")
    if cfg.em_solver == "ect":
        for bc in faces:
            if bc == "periodic":
                # the JAX package's ECT arrays hold n + 1 nodes on every
                # axis, one more than a periodic axis' fields
                no("the ECT solver on a periodic axis (the JAX package's "
                   "cut-cell arrays do not fit the fields there)", "Queue C")
            if bc != "pec":
                raise NotImplementedError(
                    f"ECT with {bc} boundaries (the JAX package refuses "
                    "them too; ROADMAP.md Queue C)")
        if cfg.do_dive_cleaning or cfg.do_divb_cleaning:
            raise NotImplementedError(
                "ECT with F/G div cleaning (the JAX package refuses it "
                "too; ROADMAP.md Queue C)")
    if cfg.fluids:
        no("fluid species on the bounded step (the JAX package's bounded "
           "step has no fluid code)", "Queue C")
    if cfg.evolve_scheme != "explicit":
        # the JAX package's refusal (simulation.py:115-118)
        raise NotImplementedError(
            "implicit schemes support periodic EM domains only")
    for lo, hi in zip(cfg.field_bc_lo, cfg.field_bc_hi):
        if (lo == "periodic") != (hi == "periodic"):
            # the JAX package reads the lower face's only (bounded_step.py:
            # 133, 531); the reference aborts on such a deck
            no("a dimension periodic on one face only (the JAX package "
               "reads its lower face's condition for both)", "Queue C")
    for bc in tuple(cfg.particle_bc_lo) + tuple(cfg.particle_bc_hi):
        if bc not in ("periodic", "absorbing", "reflecting", "thermal"):
            raise NotImplementedError(f"particle boundary {bc!r}")
    if cfg.em_solver_medium != "vacuum":
        # the JAX package refuses it off the periodic torus
        # (simulation.py:146-150)
        no("a macroscopic medium on the bounded step", "Queue C")
    if cfg.current_deposition == "vay":
        # the JAX package's bounded step deposits direct J there and hands
        # it to a solver that divides it by i k as if it were D
        no("Vay deposition on the bounded step", "Queue C")
    if cfg.current_deposition not in ("esirkepov", "direct", "villasenor"):
        raise NotImplementedError(
            f"current deposition {cfg.current_deposition!r}")
    if cfg.field_gathering == "momentum-conserving" and any(
            o != 2 for o in cfg.field_centering_no):
        # the JAX package's bounded average is two-point whatever the
        # order (bounded_step.py:693-710); its periodic one honours it
        no("momentum-conserving gathering at centering order "
           f"{tuple(cfg.field_centering_no)} on the bounded step (the JAX "
           "package's bounded step averages two points)", "Queue C")
    if cfg.use_hybrid_qed:
        no("hybrid QED on the bounded step (the JAX package's bounded "
           "step has no call to it)", "Queue C")
    check_lattice(cfg)
    if cfg.do_qed_schwinger:
        no("Schwinger pair creation on the bounded step (the JAX package's "
           "bounded step skips it)", "Queue C")
    for col in cfg.collisions:
        if col.kind not in ("background_mcc", "background_stopping"):
            # the JAX package's bounded step runs only MCC and stopping
            # and would drop these silently
            no(f"{col.kind} collision {col.name!r} on the bounded step (the "
               "JAX package's bounded step skips it)", "Queue C")
    if cfg.do_moving_window and not 0 <= cfg.moving_window_dir < ndim:
        raise ValueError("moving_window_dir must be an active-axis index")
    if cfg.max_level > 0:
        # the JAX package's refusals (bounded_step.py:730-741)
        if cfg.em_solver == "psatd":
            no("mesh refinement with PSATD (the JAX package refuses it)",
               "Queue C")
        if cfg.do_subcycling:
            no("mesh refinement with subcycling (the JAX package refuses it "
               "on the bounded step)", "Queue C")
        if (any(cfg.psatd_v_galilean) or cfg.electrostatic != "none"
                or cfg.evolve_scheme != "explicit"):
            no("mesh refinement outside explicit electromagnetics (the JAX "
               "package refuses it)", "Queue C")
        if cfg.use_nci_corr:
            no("mesh refinement with the NCI corrector on the bounded step "
               "(the JAX package refuses it; its periodic MR covers it)",
               "Queue C")
        check_mr_supported(cfg)
    laser_names = {las.name for las in cfg.lasers}
    for las in cfg.lasers:
        if las.profile not in ("gaussian", "from_file"):
            # the JAX reader refuses it (deck.py:481-482)
            no(f"laser profile {las.profile!r} (the JAX package refuses "
               "it)", "Queue C")
        if las.do_continuous_injection:
            # the JAX reader reads it (deck.py:289) and never uses it
            no("continuous injection of a laser antenna (the JAX package "
               "reads it and runs without it)", "Queue C")
    for sp in cfg.species:
        if sp.injection_style == "laser":
            if sp.name not in laser_names:
                raise ValueError(f"laser species {sp.name!r} has no "
                                 "LaserConfig")
            continue
        if sp.mass == 0.0 and sp.species_type != "photon":
            no(f"massless species {sp.name!r} that is not a photon (the JAX "
               "package's pusher divides by its mass)", "Queue C")
        if sp.do_qed_quantum_sync or sp.do_qed_breit_wheeler:
            # the JAX package's bounded step runs no QED event and no
            # optical-depth evolution: it would drop them silently
            no(f"QED events of {sp.name!r} on the bounded step (the JAX "
               "package's bounded step skips them)", "Queue C")
        if sp.pusher not in PUSHERS:
            no(f"pusher {sp.pusher!r} (the JAX package has none of that "
               "name either)", "Queue C")
        if sp.do_continuous_injection:
            if sp.injection_style != "nuniformpercell":
                # the JAX package injects the regular lattice of
                # NUniformPerCell whatever the style (bounded_step.py:1411)
                no(f"continuous injection of {sp.injection_style!r} (the JAX "
                   "package injects a regular lattice for it)", "Queue C")
            if sp.profile != "constant" and sp.profile not in PARSED_PROFILES:
                no(f"continuous injection with the {sp.profile!r} profile "
                   "(the JAX package has no density for it)", "Queue C")
            if sp.momentum_distribution not in (
                    "at_rest", "none", "constant", "parse_momentum_function",
                    "gaussian"):
                # the JAX package's refusal (bounded_step.py:1585-1588)
                no("continuous injection with momentum distribution "
                   f"{sp.momentum_distribution!r} (the JAX package refuses "
                   "it)", "Queue C")


def _slice(ndim, d, a, b):
    idx = [slice(None)] * ndim
    idx[d] = slice(a, b)
    return tuple(idx)


def _union_mask(axes, **kw):
    """1.0 where any axis's boolean vector in ``axes`` is set at the site's
    index along it, else 0.0, over their outer product, made on the
    tensors' device."""
    mask = torch.zeros((), **kw)
    for d, outside in enumerate(axes):
        shape = [1] * len(axes)
        shape[d] = outside.shape[0]
        mask = torch.maximum(mask, torch.as_tensor(
            outside, device=kw.get("device")).reshape(shape).to(mask.dtype))
    return mask


def _overlap(start, n_src, n_dst):
    """Source and destination slices that place a length-``n_src`` axis at
    index ``start`` of a length-``n_dst`` axis, cropped to both."""
    a = max(0, -start)
    b = min(n_src, n_dst - start)
    return slice(a, max(a, b)), slice(a + start, max(a, b) + start)


class BoundedStepper:
    """The bounded step's functions over one configuration.  With
    ``tile_spec`` (from ``binned_step.make_tile_spec``; configuration held to
    ``bounded_binned_supported``) ``step`` is the tile-binned ``step_binned``
    and the species named in ``slow_species`` (small, static: a beam) keep
    their compact layout and ride the per-particle path inside it; without,
    ``step`` is ``step_main``.

    A laser antenna and a slow species deposit into the whole padded block
    (``index_add_`` costs by the particle, not by the block), where the JAX
    package deposits into a thin slab around their mean position along the
    window axis: the slab's base index would have to be read back from the
    device every step, and at a fine grid a beam outgrows the slab's fixed
    128 cells.  Both give the same J to roundoff.
    """

    def __init__(self, cfg: SimConfig, staggering: Dict, dtype: torch.dtype,
                 device, tile_spec=None, slow_species=(), shards=None):
        check_bounded_supported(cfg)
        self.cfg = cfg
        # particle decomposition (core/particle_dist.py; JAX
        # make_bounded_kernels' psum_axis): the fields replicated, this
        # rank's slice of every species' slots; ``shards.sum`` all-reduces
        # the deposited sources at the deposit -> advance seam and in the
        # electrostatic solve, ``shards.rank`` and ``shards.world`` split
        # the continuous injection and the thermal walls' draws
        self.shards = shards
        self.staggering = staggering
        self.dtype = dtype
        self.device = torch.device(device)
        # host numbers in the state's precision, as the device arithmetic
        # of the JAX package holds them: self._f(x)
        self._f = torch.empty((), dtype=dtype).numpy().dtype.type
        self.spec = tile_spec
        self.slow_species = frozenset(slow_species)
        geom = cfg.geometry
        ndim = self.ndim = geom.ndim
        self.ng = guard_width(cfg)
        self.axes = geom.axis_names
        self.bc_lo = tuple(cfg.field_bc_lo or ("periodic",) * ndim)
        self.bc_hi = tuple(cfg.field_bc_hi or ("periodic",) * ndim)
        self.pbc_lo = tuple(cfg.particle_bc_lo or ("periodic",) * ndim)
        self.pbc_hi = tuple(cfg.particle_bc_hi or ("periodic",) * ndim)
        self.wdir = cfg.moving_window_dir
        bounded = [bc != "periodic" for bc in self.bc_lo]
        layout = DomainLayout.from_config(cfg)
        self.shapes = layout.field_shapes(staggering)
        self.ext_lo = [layout.ext_lo(d) for d in range(ndim)]
        # allocated cell extent per dim (a nodal component holds one more)
        self.n_ext = [geom.n_cell[d] + self.ext_lo[d] + layout.ext_hi(d)
                      for d in range(ndim)]
        # the deposition block: covers the nodal top in bounded dims
        self.big_shape = tuple(
            self.n_ext[d] + (1 if bounded[d] else 0) + 2 * self.ng
            for d in range(ndim))
        self.static_origin = layout.static_origin()
        # CKC's stencil is off on a collocated grid (JAX
        # bounded_step.py:588)
        self.is_ckc = cfg.em_solver == "ckc" and cfg.grid_type != "collocated"
        self.ckc = yee._ckc_coefs(geom) if self.is_ckc else None
        self.is_laser = {sp.name: sp.injection_style == "laser"
                         for sp in cfg.species}
        self.laser_cfg = {las.name: las for las in cfg.lasers}
        # Galilean PSATD: the drift velocity on the active axes (None
        # without); the window's shift count is its motion relative to
        # the drifting grid
        self.v_gal = galilean_velocity(cfg)
        v_rel = cfg.moving_window_v * _c - (
            self.v_gal[self.wdir] if self.v_gal is not None
            and cfg.do_moving_window else 0.0)
        self.max_shift = (
            int(math.ceil(abs(v_rel) * cfg.dt / geom.dx[self.wdir])) + 1
            if cfg.do_moving_window else 0)
        # start- and end-of-step rho for EvolveF, update-with-rho and
        # current correction (rho_fp components 0/1,
        # WarpXPushFieldsEM.cpp:1041)
        self.is_es = cfg.electrostatic != "none"
        self.need_rho = not self.is_es and (cfg.do_dive_cleaning or (
            cfg.em_solver == "psatd" and (cfg.psatd_update_with_rho
                                          or cfg.psatd_current_correction)))
        # the cleaning scalars the fields carry
        self.clean = tuple(nm for nm, on in (("F", cfg.do_dive_cleaning),
                                             ("G", cfg.do_divb_cleaning))
                           if on)
        # boosted frame: the speed the frame moves at along z
        self.beta_boost = (math.sqrt(1.0 - 1.0 / cfg.gamma_boost**2)
                           if cfg.gamma_boost > 1.0 else 0.0)

        # --- PML: split-field ownership masks and damping factors
        self.has_pml = layout.has_pml
        kw = dict(dtype=dtype, device=self.device)
        if self.is_es:
            self._init_es()
        self.psatd = self.psatd_pml = None
        if cfg.em_solver == "psatd":
            self._init_psatd(layout)
        elif self.has_pml:
            self.pml_mask = {
                nm: _union_mask(layout.pml_axes(staggering[nm]), **kw)
                for nm in _EB + self.clean}
            self.pml_owned = {nm: m > 0 for nm, m in self.pml_mask.items()}
            self._damp = {}
            for d in range(ndim):
                fac_node, fac_star = layout.sigma_factors(d, cfg.dt)
                for nm in _EB + self.clean:
                    nodal = staggering[nm][d] == 1
                    cnt = self.shapes[nm][d]
                    shape = [1] * ndim
                    shape[d] = cnt
                    v = (fac_node if nodal else fac_star)[:cnt]
                    self._damp[nm, d] = torch.as_tensor(
                        v.reshape(shape), **kw)

        # --- Silver-Mueller faces
        self._init_silver_mueller()
        # momentum-conserving gathering: the padded blocks averaged to the
        # nodes, gathered as nodal
        self.mc_gather = cfg.field_gathering == "momentum-conserving"
        self.gather_stag = (nodal_staggering(ndim, staggering)
                            if self.mc_gather else staggering)

        # --- embedded boundary
        self._init_eb()

        # --- mesh refinement
        self.mr = None
        if cfg.max_level > 0:
            self._init_mr()

        # --- tile-binned step
        if tile_spec is not None:
            spec = tile_spec
            self.smax = (self.max_shift * spec.interval
                         if cfg.do_moving_window else 0)
            self.waxis = self.wdir if cfg.do_moving_window else -1
            # kernel index t*tile + a on axis d reads padded index
            # kbase[d] + t*tile + a (less the accumulated window shift on
            # the window axis)
            self.kbase = [self.ext_lo[d] + self.ng - spec.off
                          for d in range(ndim)]
            self.wrap_dims = tuple(bc == "periodic" for bc in self.pbc_lo)
            self.stag_items = tuple(
                sorted((k, tuple(v)) for k, v in staggering.items()))
            self.binned_cfgs = tuple(
                sp for sp in cfg.species
                if not self.is_laser[sp.name]
                and sp.name not in self.slow_species)
            self.params = pusher_params(cfg, dtype, self.device,
                                        species=self.binned_cfgs)
            # every zshift handed to the kernels, for the callers that check
            # the moving-window mode really ran
            self.zshifts_seen = set()

    def _init_mr(self):
        """Two-level mesh refinement inside the bounded step (JAX
        bounded_step.py:713-814): the patch machinery of ``core/mr.py``
        (its own PML rings, the average-down, the aux interpolation, the
        buffer masks), level 0 through this stepper.  The refined box is
        fixed in level 0's index space, so it rides the moving window: its
        arrays shift with the fields (``step_window``) and its physical
        bounds, for the particles' masks and the patch's gather and
        deposit origin, gain the window's offset."""
        from types import SimpleNamespace

        cfg = self.cfg
        layout = MRLayout(cfg, self.staggering)
        adv = {fine: make_patch_advance(layout, self.staggering,
                                        cfg.em_solver, 0.5 * cfg.dt, cfg.dt,
                                        fine, self.dtype, self.device)
               for fine in (True, False)}
        self.mr = SimpleNamespace(layout=layout, adv=adv)

    def mr_frame(self, state):
        """The patch's frame at the window's offset: (lower corner of its
        valid box, origin of its fine extended grid), host numbers in the
        state's precision as the JAX package's traced scalars hold them."""
        layout = self.mr.layout
        patch_lo = list(layout.patch_lo)
        origin_f = list(layout.geom_f_ext.prob_lo)
        if self.cfg.do_moving_window:
            f, w = self._f, self.wdir
            ws = f(state.aux["window_lo"]
                   - f(self.cfg.geometry.prob_lo[w]))
            patch_lo[w] = f(f(patch_lo[w]) + ws)
            origin_f[w] = f(f(origin_f[w]) + ws)
        return patch_lo, origin_f

    def mr_gather_fields(self, state):
        """aux(1) = fp + I(aux(0) - cp) from level 0's fields cropped to
        the domain frame (PML strips and nodal tops dropped), averaged to
        the nodes on the patch torus under momentum-conserving gathering,
        and the patch's frame: what the fine gather reads."""
        n_cell = self.cfg.geometry.n_cell
        crop = {nm: getattr(state.fields, nm)[tuple(
            slice(self.ext_lo[d], self.ext_lo[d] + n_cell[d])
            for d in range(self.ndim))] for nm in _EB}
        aux1 = compute_aux1(crop, state.aux, self.mr.layout, self.staggering)
        if self.mc_gather:
            aux1 = to_nodal_torus(aux1, self.staggering)
        return (aux1, *self.mr_frame(state))

    def _init_silver_mueller(self):
        """The absorbing Silver-Mueller faces (ApplySilverMuellerBoundary
        .cpp:185-330; JAX bounded_step.py:330-395): one guard cell per
        such face (``DomainLayout``) whose E and B never evolve by the
        curls (``sm_mask``); the transverse B there follows the first-order
        absorbing relation once a step, after the first B half push, with
        the whole step's coefficients (WarpXFieldBoundaries.cpp:136-140)."""
        cfg = self.cfg
        ndim = self.ndim
        self.sm_lo = [bc == "absorbing_silver_mueller" for bc in self.bc_lo]
        self.sm_hi = [bc == "absorbing_silver_mueller" for bc in self.bc_hi]
        self.sm_mask = None
        if not (any(self.sm_lo) or any(self.sm_hi)):
            return
        self.sm_mask = {}
        for nm in _EB:
            m = np.zeros(self.shapes[nm], bool)
            for d in range(ndim):
                if self.sm_lo[d]:
                    m[(slice(None),) * d + (0,)] = True
                if self.sm_hi[d]:
                    m[(slice(None),) * d + (self.shapes[nm][d] - 1,)] = True
            self.sm_mask[nm] = torch.as_tensor(m, device=self.device)
        self.sm_c1, self.sm_c2 = [], []
        for d in range(ndim):
            cdt = _c * cfg.dt / cfg.geometry.dx[d]
            self.sm_c1.append((1.0 - cdt) / (1.0 + cdt))
            self.sm_c2.append(2.0 * cdt / (1.0 + cdt) / _c)

    def apply_silver_mueller(self, fields):
        """The Silver-Mueller update of the transverse B guards: on the
        upper face B_t = c1 B_t + s c2 E_p at the wall node inside the
        guard (E's index n - 2, B's n - 1), on the lower face B_t = c1 B_t -
        s c2 E_p at index 1 and 0, s the Levi-Civita sign of (normal, t,
        p) negated."""
        ndim = self.ndim
        upd = {nm: getattr(fields, nm) for nm in ("Bx", "By", "Bz")}
        for d in range(ndim):
            if not (self.sm_lo[d] or self.sm_hi[d]):
                continue
            ia = _COMP_AXIS[self.axes[d]]
            c1, c2 = self.sm_c1[d], self.sm_c2[d]
            for it in range(3):
                if it == ia:
                    continue
                ip = 3 - ia - it
                # +1 cyclic, -1 anticyclic
                sgn_hi = -float(((ia - it) * (it - ip) * (ip - ia)) // 2)
                tname = "B" + "xyz"[it]
                E = getattr(fields, "E" + "xyz"[ip])
                B = upd[tname]
                if self.sm_hi[d]:
                    gi = B.shape[d] - 1
                    new = (c1 * B.select(d, gi)
                           + sgn_hi * c2 * E.select(d, E.shape[d] - 2))
                    B = B.clone()
                    B.select(d, gi).copy_(new)
                if self.sm_lo[d]:
                    new = c1 * B.select(d, 0) - sgn_hi * c2 * E.select(d, 1)
                    B = B.clone()
                    B.select(d, 0).copy_(new)
                upd[tname] = B
        return fields.replace(**upd)

    def _init_eb(self):
        """The embedded boundary (JAX bounded_step.py:413-481): the
        implicit function sampled at each component's staggered points
        gives the staircase masks (``eb_mask``: evolve where phi <= 0,
        covered components frozen, EvolveE.cpp "lx <= 0" and the face-area
        branch of EvolveB.cpp).  Under ECT the E masks are the cut edges'
        lengths > 0, the conformally updated B faces (all three in 3D, By in
        2D) lose their masks, and ``ect_evolve_b`` advances them
        (``solvers/ect.py``).  ``eb_phi`` gives the function at particle
        positions for the removal of particles inside the body."""
        from ..utils.expression import compile_expression

        cfg = self.cfg
        self.eb_mask = None
        self.eb_phi = None
        self.ect_evolve_b = None
        if not cfg.eb_implicit_function:
            return
        geom = cfg.geometry
        ndim = self.ndim
        fn = compile_expression(cfg.eb_implicit_function, ("x", "y", "z"),
                                dict(cfg.user_constants or ()))

        def phi_at(coords):
            xyz = [torch.zeros((), dtype=coords[0].dtype,
                               device=coords[0].device)] * 3
            for d in range(ndim):
                xyz[_AXES3[ndim][d]] = coords[d]
            return torch.as_tensor(fn(*xyz))

        self.eb_phi = phi_at
        mask = {}
        for nm in _EB:
            coords = [torch.from_numpy(
                self.static_origin[d]
                + (np.arange(self.shapes[nm][d])
                   + (0.0 if self.staggering[nm][d] == 1 else 0.5))
                * geom.dx[d]) for d in range(ndim)]
            mesh = torch.meshgrid(*coords, indexing="ij")
            mask[nm] = (phi_at(list(mesh)) <= 0.0).to(self.device)
        if cfg.em_solver == "ect":
            from ..solvers.ect import cached_ect_geometry, make_ect_evolve_b

            geo = cached_ect_geometry(
                cfg.eb_implicit_function, tuple(cfg.user_constants or ()),
                geom, tuple(geom.prob_lo))
            for nm in ("Ex", "Ey", "Ez"):
                mask[nm] = torch.as_tensor(geo["edges"][nm] > 0.0,
                                           device=self.device)
            for nm in (("Bx", "By", "Bz") if ndim == 3 else ("By",)):
                mask.pop(nm)
            self.ect_evolve_b = make_ect_evolve_b(geo, self.dtype,
                                                  self.device)
        self.eb_mask = mask

    def inside_eb(self, pos):
        """True where a particle at ``pos`` (active axes) lies inside the
        body (phi > 0), False everywhere without an embedded boundary."""
        if self.eb_phi is None:
            return torch.zeros(pos[0].shape, dtype=torch.bool,
                               device=pos[0].device)
        return self.eb_phi(list(pos)) > 0.0

    def _init_es(self):
        """The electrostatic solve's groups (JAX bounded_step.py:1940-2015):
        lab frame and magnetostatic solve every species at once;
        relativistic solves each species in its mean rest frame, beta from
        its configured momentum (constant and gaussian distributions only,
        as the JAX package takes it; zero for any other).  A group holds
        its species, beta (xyz and active axes) and its backend: a
        ``PoissonSolver`` scaled by (1 - beta_d^2), or under
        ``poisson_solver = fft`` the integrated Green function on the
        gamma-stretched cell.  The magnetostatic solve has a solver of its
        own; the wall potentials are compiled f(t)."""
        from ..solvers.electrostatic import PoissonSolver, igf_greens_hat
        from ..utils.expression import compile_expression

        cfg = self.cfg
        geom = cfg.geometry
        ndim = self.ndim
        self.es_periodic = tuple(bc == "periodic" for bc in self.bc_lo)
        self.es_igf = cfg.poisson_solver == "fft"
        kw = dict(dtype=self.dtype, device=self.device)
        sp_es = [s for s in cfg.species if not s.do_not_deposit]
        relativistic = cfg.electrostatic == "relativistic"
        self.es_ms_solver = (
            PoissonSolver(geom, self.es_periodic, **kw)
            if cfg.electrostatic == "labframe-electromagnetostatic"
            else None)
        self.es_groups = []
        for grp in ([[s] for s in sp_es] if relativistic else [sp_es]):
            beta3 = np.zeros(3)
            if relativistic and grp[0].momentum_distribution in (
                    "constant", "gaussian"):
                u = np.array([grp[0].ux, grp[0].uy, grp[0].uz], float)
                beta3 = u / math.sqrt(1.0 + float(u @ u))
            beta_act = tuple(float(beta3[a]) for a in _AXES3[ndim])
            if self.es_igf:
                cell = tuple(geom.dx[d] / math.sqrt(1.0 - beta_act[d] ** 2)
                             for d in range(ndim))
                backend = igf_greens_hat(self.shapes["rho"], cell,
                                         self.dtype, self.device)
            else:
                backend = PoissonSolver(
                    geom, self.es_periodic,
                    beta2=tuple(b * b for b in beta_act), **kw)
            self.es_groups.append(([s.name for s in grp],
                                   tuple(float(b) for b in beta3), beta_act,
                                   backend))
        self.es_potentials = None
        if cfg.boundary_potentials:
            consts = dict(cfg.user_constants or ())
            self.es_potentials = [
                tuple(compile_expression(e, ("t",), consts) if e else None
                      for e in pair)
                for pair in cfg.boundary_potentials]

    def wall_potential(self, time):
        """The inhomogeneous Dirichlet values at ``time`` on the wall layers
        of the bounded dims (PoissonBoundaryHandler; f(t) evaluated in
        float64 on the host), or None without wall potentials."""
        if self.es_potentials is None:
            return None
        phi_b = torch.zeros(self.shapes["rho"], dtype=self.dtype,
                            device=self.device)
        for d, (f_lo, f_hi) in enumerate(self.es_potentials):
            if self.es_periodic[d]:
                continue
            for fn, i in ((f_lo, 0), (f_hi, phi_b.shape[d] - 1)):
                if fn is not None:
                    phi_b.select(d, i).fill_(float(fn(float(time))))
        return phi_b

    def solve_es(self, state: SimState) -> SimState:
        """ComputeSpaceChargeField (WarpXSolveFieldsES.cpp:16; JAX
        bounded_step.py:2017-2112): rho of each group
        (``diagnostics/fields.py::deposit_total_rho``), one Poisson solve
        per group with the wall potential in the first only, E = -(1 -
        beta beta^T) grad(phi) and B = -(beta x grad(phi))/c summed over
        the groups; under labframe-electromagnetostatic nabla^2 A = -mu0 J
        of the nodal J (weights w u/gamma), B += curl A.  E and B are
        replaced, phi stored."""
        from ..diagnostics.fields import deposit_total_rho
        from ..solvers.electrostatic import (phi_to_b, phi_to_b_nodal,
                                             phi_to_e_beta, phi_to_e_nodal,
                                             solve_open_igf,
                                             vector_potential_b)

        cfg = self.cfg
        geom = cfg.geometry
        ndim = self.ndim
        periodic = self.es_periodic
        names = {1: ("Ez",), 2: ("Ex", "Ez"), 3: ("Ex", "Ey", "Ez")}[ndim]
        kw = dict(dtype=self.dtype, device=self.device)
        upd = {nm: torch.zeros(self.shapes[nm], **kw) for nm in _EB}
        phi_b = self.wall_potential(state.time)
        phi_tot = None
        for gi, (grp, beta3, beta_act, backend) in enumerate(self.es_groups):
            rho = deposit_total_rho(state, cfg, only=grp)
            if self.shards is not None:
                (rho,) = self.shards.sum((rho,))
            if self.es_igf:
                phi = solve_open_igf(rho, backend)
            else:
                phi = backend.solve(rho, phi_b if gi == 0 else None)
            phi_tot = phi if phi_tot is None else phi_tot + phi
            # a collocated grid takes the nodal gradients (JAX
            # bounded_step.py:2066-2073)
            collocated = cfg.grid_type == "collocated"
            to_e = phi_to_e_nodal if collocated else phi_to_e_beta
            to_b = phi_to_b_nodal if collocated else phi_to_b
            for nm, e in zip(names, to_e(phi, geom, periodic, beta_act)):
                upd[nm] = upd[nm] + e
            if any(b != 0.0 for b in beta3):
                for i, b in to_b(phi, geom, periodic, beta3).items():
                    if b is not None:
                        upd["B" + "xyz"[i]] = upd["B" + "xyz"[i]] + b
        if self.es_ms_solver is not None:
            # nabla^2 A = -mu0 J on the nodes (ComputeMagnetostaticField);
            # solve() inverts L x / ep0, so it is handed mu0 ep0 J
            mu0_ep0 = 1.0 / (_c * _c * _ep0) * _ep0
            wrap = all(periodic)
            A3 = {}
            for i, uc in enumerate(("ux", "uy", "uz")):
                Jn = torch.zeros(self.shapes["rho"], **kw)
                for sp_cfg in cfg.species:
                    sp = state.species[sp_cfg.name]
                    if sp.capacity == 0 or sp_cfg.do_not_deposit:
                        continue
                    gam = torch.sqrt(1.0 + (sp.ux ** 2 + sp.uy ** 2
                                            + sp.uz ** 2) / (_c * _c))
                    w_eff = torch.where(sp.alive, sp.w * getattr(sp, uc)
                                        / gam, torch.zeros_like(sp.w))
                    Jn = deposit_rho(
                        sp.positions(ndim), w_eff, sp_cfg.charge, geom,
                        cfg.particle_shape, out=Jn, wrap=wrap,
                        out_shape=None if wrap else self.shapes["rho"],
                        chunk_size=cfg.deposit_chunk_size)
                if self.shards is not None:
                    # the JAX package sums rho only (ROADMAP.md Queue C)
                    (Jn,) = self.shards.sum((Jn,))
                A3[i] = self.es_ms_solver.solve(Jn * mu0_ep0)
            for i, b in vector_potential_b(A3, geom, periodic).items():
                if b is not None:
                    upd["B" + "xyz"[i]] = upd["B" + "xyz"[i]] + b
        if phi_tot is not None:
            upd["phi"] = phi_tot
        return state.replace(fields=state.fields.replace(**upd))

    def _init_psatd(self, layout):
        """The bounded PSATD solvers over the extended box (interior, damped
        zones and PML strips; JAX bounded_step.py:174-300): the single-box
        solver, the sin^2 damping profile over the outer half of each
        damped zone (damp_field_in_guards + constrain_tilebox_to_guards,
        WarpXPushFieldsEM_K.H:78-120) and, with PML faces, the split-field
        solver, its strip masks and its damping factors."""
        cfg = self.cfg
        geom = cfg.geometry
        ndim = self.ndim
        n_ext = self.n_ext
        kw = dict(dtype=self.dtype, device=self.device)
        ext_geom = Geometry(
            ndim=ndim, n_cell=tuple(n_ext),
            prob_lo=tuple(self.static_origin),
            prob_hi=tuple(self.static_origin[d] + n_ext[d] * geom.dx[d]
                          for d in range(ndim)),
            periodic=(True,) * ndim)
        self.psatd = PsatdSolver(
            ext_geom, self.staggering, cfg.dt, n_order=cfg.psatd_order,
            update_with_rho=cfg.psatd_update_with_rho,
            current_correction=cfg.psatd_current_correction,
            v_galilean=cfg.psatd_v_galilean,
            v_comoving=cfg.psatd_v_comoving, single_box=True,
            collocated_grid=cfg.grid_type == "collocated",
            time_averaging=cfg.psatd_time_averaging,
            dive_cleaning=cfg.do_dive_cleaning,
            divb_cleaning=cfg.do_divb_cleaning,
            dtype=self.dtype, device=self.device)
        prof_nd = np.ones(tuple(n_ext))
        ngd = layout.damp_ncell
        for d in range(ndim):
            prof = np.ones(n_ext[d])
            ramp = np.sin(np.pi * np.arange(ngd // 2) / ngd) ** 2
            if self.bc_lo[d] == "damped":
                prof[: ngd // 2] = ramp
            if self.bc_hi[d] == "damped":
                prof[n_ext[d] - ngd // 2:] = ramp[::-1]
            shape_d = [1] * ndim
            shape_d[d] = n_ext[d]
            prof_nd = prof_nd * prof.reshape(shape_d)
        self.damp_profile = torch.as_tensor(prof_nd, **kw)
        if not self.has_pml:
            return
        # the spectral PML: split fields over the same box, re-fed from the
        # regular fields in the interior every step (PML::Exchange)
        self.psatd_pml = PsatdPmlSolver(
            ext_geom, self.staggering, cfg.dt, n_order=cfg.psatd_order,
            collocated_grid=cfg.grid_type == "collocated",
            v_galilean=cfg.psatd_v_galilean,
            dive_cleaning=cfg.do_pml_dive_cleaning,
            divb_cleaning=cfg.do_pml_divb_cleaning,
            dtype=self.dtype, device=self.device)
        self.pml_comps = list(_EB) + (["F", "G"] if self.psatd_pml.cleaning
                                      else [])

        def strip_axes(flags):
            """By axis, where the split solver owns the site (PML
            strips)."""
            axes = []
            for d in range(ndim):
                idx = np.arange(n_ext[d]) - self.ext_lo[d]
                top = geom.n_cell[d] if flags[d] == 1 else geom.n_cell[d] - 1
                outside = np.zeros(n_ext[d], bool)
                if self.bc_lo[d] == "pml":
                    outside |= idx < 0
                if self.bc_hi[d] == "pml":
                    outside |= idx > top
                axes.append(outside)
            return axes

        self.pml_mask_ext = {
            nm: _union_mask(strip_axes(self.staggering[nm]), **kw)
            for nm in self.pml_comps}
        self.pml_own_ext = {nm: m > 0 for nm, m in self.pml_mask_ext.items()}
        sig = {d: layout.sigma_factors(d, cfg.dt) for d in range(ndim)}
        self.pml_damp_ext = {}
        for nm in self.pml_comps:
            for ax in self.psatd_pml.split_dirs(nm):
                if ax not in self.axes:
                    continue  # the y split in 2D is not damped
                dd = self.axes.index(ax)
                arr = sig[dd][0 if self.staggering[nm][dd] == 1 else 1]
                sh = [1] * ndim
                sh[dd] = n_ext[dd]
                self.pml_damp_ext[nm, ax] = torch.as_tensor(
                    arr[: n_ext[dd]].reshape(sh), **kw)

    def fdtd_terms(self) -> Dict[str, list]:
        """Each FDTD-advanced component's terms: the curls, and with
        cleaning the F/G divergences and their gradients."""
        terms = {nm: list((E_TERMS if nm[0] == "E" else B_TERMS)[nm])
                 for nm in _EB}
        for on, own, grads in ((self.cfg.do_dive_cleaning, F_TERMS,
                                GRADF_TERMS),
                               (self.cfg.do_divb_cleaning, G_TERMS,
                                GRADG_TERMS)):
            if on:
                terms.update({nm: list(ts) for nm, ts in own.items()})
                for nm, ts in grads.items():
                    terms[nm] += ts
        return terms

    def pml_split_shapes(self) -> Dict[str, tuple]:
        """The PML split fields of the state's ``aux``, by key
        (``pml:<comp>:<dir>``), with their shapes: one per term under FDTD
        (``fdtd_terms``), the spectral splits over the extended box under
        PSATD."""
        if not self.has_pml:
            return {}
        if self.psatd_pml is not None:
            return {f"pml:{nm}:{ax}": tuple(self.n_ext)
                    for nm in self.pml_comps
                    for ax in self.psatd_pml.split_dirs(nm)}
        return {f"pml:{nm}:{term[2]}": self.shapes[nm]
                for nm, terms in self.fdtd_terms().items()
                for term in terms if term[2] in self.axes}

    # ------------------------------------------------------------ host scalars
    def origin_of(self, state):
        """Coordinates of array index 0 (PML strips included)."""
        out = list(self.static_origin)
        if self.cfg.do_moving_window:
            w = self.wdir
            strip = self._f(self.ext_lo[w] * self.cfg.geometry.dx[w])
            out[w] = self._f(state.aux["window_lo"] - strip)
        return out

    def gal_origin_at(self, origin, state, frac=0.0):
        """``origin`` shifted by the Galilean drift at t^n + frac dt (JAX
        bounded_step.py:167-172), in the state's precision."""
        if self.v_gal is None:
            return origin
        f = self._f
        t = f(f(state.time) + f(frac * self.cfg.dt))
        return [f(o + f(v * t)) for o, v in zip(origin, self.v_gal)]

    # the physical bounds drift with the grid under Galilean PSATD
    # (ShiftGalileanBoundary moves prob_lo/hi)
    def phys_lo_of(self, state):
        out = list(self.cfg.geometry.prob_lo)
        if self.cfg.do_moving_window:
            out[self.wdir] = state.aux["window_lo"]
        return self.gal_origin_at(out, state)

    def domain_hi_of(self, state):
        out = list(self.cfg.geometry.prob_hi)
        if self.cfg.do_moving_window:
            out[self.wdir] = state.aux["window_hi"]
        return self.gal_origin_at(out, state)

    # --------------------------------------------------------- padded blocks
    def pad_eb(self, arr, comp_name):
        """Pad one E/B component (or the F/G scalar) with ``ng`` guards per
        side, filled by its boundary condition: wrapped (periodic), mirrored
        (pec) or zero; F and G take zero guards at every bounded face."""
        ndim, ng = self.ndim, self.ng
        out = arr.new_zeros([n + 2 * ng for n in arr.shape])
        out[tuple(slice(ng, ng + n) for n in arr.shape)] = arr
        for d in range(ndim):
            if self.bc_lo[d] != "periodic":
                continue
            n_val = arr.shape[d]
            # dims before d are already wrapped: corners come along
            out[_slice(ndim, d, 0, ng)] = \
                out[_slice(ndim, d, n_val, n_val + ng)]
            out[_slice(ndim, d, ng + n_val, 2 * ng + n_val)] = \
                out[_slice(ndim, d, ng, 2 * ng)]
        if comp_name in ("F", "G"):
            return out
        comp_axis = _COMP_AXIS[comp_name[-1].lower()]
        for d in range(ndim):
            nodal = self.staggering[comp_name][d] == 1
            tang = is_tangential(comp_axis, _COMP_AXIS[self.axes[d]])
            if comp_name[0] == "E":
                zero_wall, mirror_tang = tang and nodal, tang
            else:
                zero_wall, mirror_tang = (not tang) and nodal, not tang
            for side, bc in (("lo", self.bc_lo[d]), ("hi", self.bc_hi[d])):
                if bc == "pec":
                    out = fill_guards_pec(out, d, ng, self.n_ext[d], nodal,
                                          mirror_tang, side, zero_wall)
        return out

    def fold_and_crop(self, padded, comp_name):
        """Fold periodic guards, drop bounded guards; crop to the
        component's shape."""
        ng = self.ng
        out = padded
        for d in reversed(range(self.ndim)):
            nv = self.shapes[comp_name][d]
            nd = out.ndim
            if self.bc_lo[d] == "periodic":
                n_tot = out.shape[d]
                valid = out[_slice(nd, d, ng, n_tot - ng)].clone()
                valid[_slice(nd, d, nv - ng, nv)] += out[_slice(nd, d, 0, ng)]
                valid[_slice(nd, d, 0, ng)] += \
                    out[_slice(nd, d, n_tot - ng, n_tot)]
                out = valid
            else:
                out = out[_slice(nd, d, ng, ng + nv)]
        return out.contiguous()

    def curl_term(self, out_name, term, pads, coef):
        """One curl contribution, sign * coef * d(in)/d(axis), on the
        shape of ``out_name``."""
        sgn, in_name, dd_xyz, kind = term
        nv = self.shapes[out_name]
        ng = self.ng
        dd = self.axes.index(dd_xyz)
        P = pads[in_name]
        if self.is_ckc and kind == "up" and in_name[0] == "E":
            # the CKC stencil applies to the E-curl of the B push only
            G = yee._up_ckc(P, dd, self.ckc)
            sl = tuple(slice(ng, ng + nv[d]) for d in range(self.ndim))
            return (sgn * coef) * G[sl]
        sl_a, sl_b = [], []
        for d in range(self.ndim):
            if d == dd:
                a, b = (ng + 1, ng) if kind == "up" else (ng, ng - 1)
            else:
                a = b = ng
            sl_a.append(slice(a, a + nv[d]))
            sl_b.append(slice(b, b + nv[d]))
        diff = P[tuple(sl_a)] - P[tuple(sl_b)]
        return (sgn * coef / self.cfg.geometry.dx[dd]) * diff

    def enforce_walls(self, fields):
        """Zero the tangential-E and normal-B wall nodes at PEC faces."""
        if "pec" not in self.bc_lo + self.bc_hi:
            return fields
        upd = {}
        for name in _EB:
            arr = getattr(fields, name)
            comp_axis = _COMP_AXIS[name[-1].lower()]
            for d in range(self.ndim):
                nodal = self.staggering[name][d] == 1
                tang = is_tangential(comp_axis, _COMP_AXIS[self.axes[d]])
                zero_wall = ((tang and nodal) if name[0] == "E"
                             else ((not tang) and nodal))
                if not zero_wall:
                    continue
                for bc, i in ((self.bc_lo[d], 0),
                              (self.bc_hi[d], arr.shape[d] - 1)):
                    if bc == "pec":
                        if arr is getattr(fields, name):
                            arr = arr.clone()
                        arr[_slice(self.ndim, d, i, i + 1)] = 0.0
            upd[name] = arr
        return fields.replace(**upd)

    def _padded_eb(self, fields, use_avg=False):
        """The guard-padded E/B blocks (of the time-averaged fields with
        ``use_avg`` where the run carries them)."""
        suffix = "_avg" if use_avg and fields.Ex_avg is not None else ""
        return {name: self.pad_eb(getattr(fields, name + suffix), name)
                for name in _EB}

    def mc_aux_pads(self, farr_pad):
        """The padded staggered blocks averaged to the nodes for
        momentum-conserving gathering (UpdateAuxilaryDataStagToNodal on the
        padded block; JAX bounded_step.py:692-710): the two-point average
        along each staggered axis, the first entry zero (a guard the
        gather never reads)."""
        out = {}
        for name, a in farr_pad.items():
            for d, flag in enumerate(self.staggering[name]):
                if flag == 0:
                    n = a.shape[d]
                    core = 0.5 * (a.narrow(d, 0, n - 1) + a.narrow(d, 1, n - 1))
                    a = torch.cat([torch.zeros_like(a.narrow(d, 0, 1)), core],
                                  dim=d)
            out[name] = a
        return out

    def _gather_blocks(self, fields, use_avg=False):
        """The padded blocks a gather reads: through the NCI corrector
        under use_nci_corr, averaged to the nodes under
        momentum-conserving gathering (``self.gather_stag``)."""
        farr_pad = self._padded_eb(fields, use_avg)
        if self.cfg.use_nci_corr:
            farr_pad = _apply_nci(farr_pad, self.cfg)
        if self.mc_gather:
            farr_pad = self.mc_aux_pads(farr_pad)
        return farr_pad

    def _gather(self, pos, farr_pad, origin, u3=None, fine=None):
        """The fields at ``pos`` with the external ones (and, given the
        momenta ``u3``, the lattice's); with ``fine`` (the result of
        ``mr_gather_fields``) the particles deep in the refined patch read
        the fine aux instead (buffer-mask ownership)."""
        cfg = self.cfg
        e6 = gather_eb(pos, farr_pad, self.gather_stag, cfg.geometry,
                       cfg.particle_shape, cfg.galerkin, origin=origin,
                       wrap=False, offset=self.ng)
        if fine is not None:
            aux1, patch_lo, origin_f = fine
            layout = self.mr.layout
            e6 = gather_levels(
                e6, select(layout.fine_mask(pos, layout.gather_buf,
                                            patch_lo)), pos,
                lambda p: gather_eb(p, aux1, self.gather_stag,
                                    layout.geom_f_ext, cfg.particle_shape,
                                    cfg.galerkin, origin=origin_f,
                                    wrap=False))
        return _add_ext(e6, cfg, pos=pos, u3=u3)

    def _wrap_periodic(self, pos):
        """Wrap the periodic particle dims into the (static) domain."""
        geom = self.cfg.geometry
        out = list(pos)
        for d in range(self.ndim):
            if self.pbc_lo[d] == "periodic":
                lo, hi = geom.prob_lo[d], geom.prob_hi[d]
                out[d] = lo + torch.remainder(out[d] - lo, hi - lo)
        return out

    def _deposit(self, pos, u, w_eff, q, origin, shape, out=None):
        cfg = self.cfg
        kw = dict(origin=origin, wrap=False, offset=self.ng, out_shape=shape,
                  chunk_size=cfg.deposit_chunk_size, out=out)
        if cfg.current_deposition != "esirkepov":
            # direct, and villasenor, which the JAX package deposits
            # directly too (bounded_step.py:1023-1036)
            return deposit_current_direct(
                pos, *u, w_eff, q, cfg.geometry, self.staggering, cfg.dt,
                cfg.particle_shape, **kw)
        return deposit_current_esirkepov(
            pos, *u, w_eff, q, cfg.geometry, cfg.dt, cfg.particle_shape,
            **kw)

    def _deposit_rho(self, pos, w_eff, q, origin, out):
        cfg = self.cfg
        return deposit_rho(pos, w_eff, q, cfg.geometry, cfg.particle_shape,
                           out=out, origin=origin, wrap=False,
                           offset=self.ng, out_shape=self.big_shape,
                           chunk_size=cfg.deposit_chunk_size)

    def _advance_antenna(self, sp, name, time):
        """The antenna's prescribed motion; in a boosted frame its mobility
        is divided by gamma (LaserParticleContainer.cpp:775)."""
        laser = self.laser_cfg[name]
        cfg = self.cfg
        return update_antenna(sp, laser, cfg.geometry,
                              0.05 / laser.e_max / cfg.gamma_boost, time,
                              cfg.dt, gamma_boost=cfg.gamma_boost,
                              z0_lab=laser.z0_lab)

    # ------------------------------------------------------------- step_main
    def step_main(self, state: SimState, draws=None) -> SimState:
        """The per-particle bounded step: background MCC and stopping
        collisions and field ionization on the numbers of ``draws`` (a
        ``utils.draws`` source), gather on the padded blocks (of
        the time-averaged fields under averaged PSATD), push (photons
        stream at c), deposit J (Esirkepov or direct) and, for
        update-with-rho and current correction, rho at the start and end of
        the step into the ``big_shape`` block, field tail.  Under Galilean
        PSATD each origin sits at its own source time: the gather and
        rho_old at t^n, J at t^{n+1/2}, rho_new at t^{n+1}."""
        cfg = self.cfg
        ndim = self.ndim
        origin0 = self.origin_of(state)
        origin = self.gal_origin_at(origin0, state)
        origin_j = self.gal_origin_at(origin0, state, 0.5)
        origin_new = self.gal_origin_at(origin0, state, 1.0)
        farr_pad = self._gather_blocks(
            state.fields,
            use_avg=cfg.em_solver == "psatd" and cfg.psatd_time_averaging)
        if any(c.kind == "background_mcc" for c in cfg.collisions) and (
                draws is None):
            raise ValueError("MCC collisions draw random numbers: pass "
                             "step_main a utils.draws source")
        # MCC and stopping (the kinds ``check_bounded_supported`` lets
        # through) before ionization, as the JAX package's bounded step runs
        # them (``bounded_step.py:838-847``)
        state = collisions_substep(state, cfg, draws)
        if any(s.do_field_ionization for s in cfg.species):
            if draws is None:
                raise ValueError("field ionization draws random numbers: "
                                 "pass step_main a utils.draws source")
            # the fields at t^n without the external particle fields, as
            # the JAX package gathers them for doFieldIonization
            state = ionization_substep(
                state, cfg,
                lambda pos: gather_eb(
                    pos, farr_pad, self.gather_stag, cfg.geometry,
                    cfg.particle_shape, cfg.galerkin, origin=origin,
                    wrap=False, offset=self.ng),
                draws)
        j_total = rho_old = rho_new = None
        new_species = {}
        aux_updates = {}
        fine = mr_jf = None
        if self.mr is not None:
            fine = self.mr_gather_fields(state)
            mr_jf = tuple(torch.zeros(self.mr.layout.n_fext,
                                      dtype=self.dtype, device=self.device)
                          for _ in range(3))
        for sp_cfg in cfg.species:
            sp = state.species[sp_cfg.name]
            if sp.capacity == 0:
                new_species[sp_cfg.name] = sp
                continue
            if self.is_laser[sp_cfg.name]:
                sp_new = self._advance_antenna(sp, sp_cfg.name, state.time)
                q_eff = 1.0
            elif sp_cfg.species_type == "photon":
                # massless: streaming at c along u (PhotonParticleContainer
                # ::PushPX); no charge, so no deposit
                new_species[sp_cfg.name] = sp.with_positions(
                    ndim, self._wrap_periodic(photon_position_step(
                        sp.positions(ndim), sp.ux, sp.uy, sp.uz, cfg.dt,
                        ndim)))
                continue
            else:
                pos = sp.positions(ndim)
                if sp_cfg.do_not_gather:
                    e6 = (torch.zeros_like(sp.ux),) * 6
                else:
                    e6 = self._gather(pos, farr_pad, origin,
                                      u3=(sp.ux, sp.uy, sp.uz), fine=fine)
                if sp_cfg.do_not_push:
                    u3, new_pos = (sp.ux, sp.uy, sp.uz), pos
                else:
                    u3, new_pos, upd = rigid_push(state, sp_cfg, cfg, pos,
                                                  sp, e6, cfg.dt, ndim)
                    aux_updates.update(upd)
                sp_new = sp.replace(ux=u3[0], uy=u3[1],
                                    uz=u3[2]).with_positions(ndim, new_pos)
                q_eff = sp_cfg.charge
            if sp_cfg.do_not_deposit:
                new_species[sp_cfg.name] = sp_new.with_positions(
                    ndim, self._wrap_periodic(sp_new.positions(ndim)))
                continue
            if self.need_rho:
                zero = torch.zeros_like(sp.w)
                rho_old = self._deposit_rho(
                    sp.positions(ndim), torch.where(sp.alive, sp.w, zero),
                    q_eff, origin, rho_old)
                rho_new = self._deposit_rho(
                    sp_new.positions(ndim),
                    torch.where(sp_new.alive, sp_new.w, zero), q_eff,
                    origin_new, rho_new)
            if not self.is_es:
                w_eff = torch.where(sp.alive, sp_new.w,
                                    torch.zeros_like(sp.w))
                if mr_jf is not None and not self.is_laser[sp_cfg.name]:
                    # the deposition buffer split: deep-patch particles
                    # deposit on the fine grid, the rest (the buffer ring
                    # too) on level 0 (PartitionParticlesInBuffers)
                    layout = self.mr.layout
                    new_pos = sp_new.positions(ndim)
                    mask_d = layout.fine_mask(new_pos, layout.dep_buf,
                                              fine[1])
                    mr_jf = deposit_slots(
                        select(mask_d & sp.alive), new_pos,
                        (sp_new.ux, sp_new.uy, sp_new.uz), w_eff, q_eff,
                        layout.geom_f_ext, cfg.dt, cfg.particle_shape,
                        mr_jf, origin=fine[2], wrap=False,
                        out_shape=layout.n_fext,
                        chunk_size=cfg.deposit_chunk_size)
                    w_eff = torch.where(mask_d, torch.zeros_like(w_eff),
                                        w_eff)
                j_total = self._deposit(
                    sp_new.positions(ndim),
                    (sp_new.ux, sp_new.uy, sp_new.uz), w_eff, q_eff,
                    origin_j, self.big_shape, out=j_total)
            new_species[sp_cfg.name] = sp_new.with_positions(
                ndim, self._wrap_periodic(sp_new.positions(ndim)))
        if self.is_es:
            # no deposit and no field advance: the Poisson solve follows
            # the particle boundaries (WarpXEvolve.cpp:269-283)
            return state.replace(species=new_species, step=state.step + 1,
                                 time=state.time + cfg.dt,
                                 aux={**state.aux, **aux_updates})
        if mr_jf is not None:
            j_total = self.mr_sync(state, mr_jf, j_total, aux_updates)
        return self.field_tail(state, new_species, j_total, aux_updates,
                               rho_old, rho_new)

    def mr_sync(self, state, mr_jf, j_total, aux_updates):
        """SyncCurrent and the patch solves (JAX bounded_step.py:1064-1108):
        the fine J averaged down and added into level 0's padded block over
        the patch box (the deposit block's index = domain cell + ext_lo +
        ng), the per-level filters, both patch advances; the patch state
        into ``aux_updates``.  Returns level 0's J block."""
        layout = self.mr.layout
        jcp = tuple(coarsen_field(a, self.staggering[nm], layout)
                    for a, nm in zip(mr_jf, ("jx", "jy", "jz")))
        if j_total is None:
            j_total = tuple(torch.zeros(self.big_shape, dtype=self.dtype,
                                        device=self.device)
                            for _ in range(3))
        j_total = add_patch_j(j_total, jcp, layout, self.staggering,
                              [self.ext_lo[d] + self.ng
                               for d in range(self.ndim)])
        if self.cfg.use_filter:
            npass = self.cfg.filter_npass_each_dir or (1,) * self.ndim
            mr_jf = tuple(bilinear_filter(a, npass) for a in mr_jf)
            jcp = tuple(bilinear_filter(a, npass) for a in jcp)
        for prefix, j3 in (("f", mr_jf), ("c", jcp)):
            b, e = self.mr.adv[prefix == "f"]
            parts = b(e(b(patch_parts(state.aux, prefix)), j3))
            aux_updates.update({f"mr:{prefix}:{k}": v
                                for k, v in parts.items()})
        aux_updates.update({f"mr:j:{nm}": a
                            for nm, a in zip(("jx", "jy", "jz"), mr_jf)})
        return j_total

    # ------------------------------------------------------------ field tail
    def field_tail(self, state, new_species, j_total, aux_updates,
                   rho_old=None, rho_new=None):
        """Filter J (and the rho pair) on the padded block, fold and crop
        it, then advance the fields: B half, E full with J, B half, or the
        spectral push.  In the PML strips each
        Berenger split field integrates one curl term of the total fields
        (EvolveBPML.cpp, EvolveEPML.cpp) and is damped once per step
        (DampPML); the totals there are the sums of the splits, which makes
        the reference's domain <-> PML exchange shared storage."""
        cfg = self.cfg
        dt = cfg.dt
        kw = dict(dtype=self.dtype, device=self.device)
        if self.shards is not None:
            # the particle-decomposition seam (SyncCurrent over the
            # particle shards; JAX bounded_step.py:1121-1130): the replicated
            # field advance sees the global deposit
            if j_total is not None:
                j_total = self.shards.sum(j_total)
            if rho_old is not None:
                rho_old, rho_new = self.shards.sum((rho_old, rho_new))
        if j_total is None:
            j_valid = tuple(torch.zeros(self.shapes[nm], **kw)
                            for nm in ("jx", "jy", "jz"))
        else:
            if cfg.use_filter:
                npass = cfg.filter_npass_each_dir or (1,) * self.ndim
                j_total = tuple(bilinear_filter_padded(a, npass)
                                for a in j_total)
            j_valid = tuple(self.fold_and_crop(a, name)
                            for a, name in zip(j_total, ("jx", "jy", "jz")))
        fields = state.fields.replace(jx=j_valid[0], jy=j_valid[1],
                                      jz=j_valid[2])
        aux = dict(state.aux)
        aux.update(aux_updates)
        rho_pair = None
        if self.need_rho:
            if rho_old is None:
                rho_pair = (torch.zeros(self.shapes["rho"], **kw),) * 2
            else:
                if cfg.use_filter:
                    npass = cfg.filter_npass_each_dir or (1,) * self.ndim
                    rho_old = bilinear_filter_padded(rho_old, npass)
                    rho_new = bilinear_filter_padded(rho_new, npass)
                rho_pair = (self.fold_and_crop(rho_old, "rho"),
                            self.fold_and_crop(rho_new, "rho"))
        if self.psatd is not None:
            fields = self.psatd_push(fields, aux, rho_pair)
            return state.replace(fields=fields, species=new_species,
                                 step=state.step + 1, time=state.time + dt,
                                 aux=aux)
        jmap = dict(zip(("Ex", "Ey", "Ez"), ("jx", "jy", "jz")))
        all_terms = self.fdtd_terms()

        def advance(fields, out_names, coef, dth, with_j=False, source=None):
            """Advance ``out_names`` by dth * coef * (their terms: the curls
            and, with cleaning, the divergence or gradient terms);
            ``source`` (the -rho/eps0 of EvolveF) adds dth * source outside
            the PML."""
            terms_of = {nm: [t for t in all_terms[nm] if t[2] in self.axes]
                        for nm in out_names}
            pads = {t[1]: self.pad_eb(getattr(fields, t[1]), t[1])
                    for ts in terms_of.values() for t in ts}
            upd = {}
            for nm in out_names:
                terms = terms_of[nm]
                curls = [self.curl_term(nm, t, pads, coef) for t in terms]
                # a component with no term (Ez and Bz in 1D) keeps its
                # value outside the PML and is zero inside it, as in the
                # JAX package
                zero = torch.zeros_like(getattr(fields, nm))
                total = curls[0] if curls else zero
                for t in curls[1:]:
                    total = total + t
                reg = getattr(fields, nm) + dth * total
                if with_j:
                    reg = reg - dth * _c2 * _mu0 * getattr(fields, jmap[nm])
                if source is not None:
                    reg = reg + dth * source
                if self.has_pml:
                    tot = zero
                    for term, cur in zip(terms, curls):
                        key = f"pml:{nm}:{term[2]}"
                        split = self.pml_mask[nm] * (aux[key] + dth * cur)
                        aux[key] = split
                        tot = tot + split
                    reg = torch.where(self.pml_owned[nm], tot, reg)
                if self.sm_mask is not None and nm in self.sm_mask:
                    # the Silver-Mueller guards never evolve by the curls
                    reg = torch.where(self.sm_mask[nm], getattr(fields, nm),
                                      reg)
                if self.eb_mask is not None and nm in self.eb_mask:
                    # covered components stay frozen (staircase EB)
                    reg = torch.where(self.eb_mask[nm], reg,
                                      getattr(fields, nm))
                upd[nm] = reg
            return fields.replace(**upd)

        def advance_b(fields, dth):
            """The Faraday half step: the ECT cut-cell faces where the
            solver is ECT (EvolveBCartesianECT; in 2D XZ only By, Bx and Bz
            keeping the staircase), the curls otherwise."""
            if self.ect_evolve_b is None:
                return advance(fields, b_comps, 1.0, dth)
            B3 = self.ect_evolve_b(fields.Ex, fields.Ey, fields.Ez,
                                   (fields.Bx, fields.By, fields.Bz), dth)
            if self.ndim == 2:
                f2 = advance(fields, ("Bx", "Bz"), 1.0, dth)
                return fields.replace(Bx=f2.Bx, By=B3[1], Bz=f2.Bz)
            return fields.replace(Bx=B3[0], By=B3[1], Bz=B3[2])

        # F,G half -> B half (+grad G) -> E (+grad F) -> F,G half -> B half
        # (WarpXEvolve.cpp:416-437)
        e_comps, b_comps = _EB[:3], _EB[3:]
        dive, divb = cfg.do_dive_cleaning, cfg.do_divb_cleaning
        if dive:
            fields = advance(fields, ("F",), 1.0, 0.5 * dt,
                             source=-rho_pair[0] / _ep0)
        if divb:
            fields = advance(fields, ("G",), _c2, 0.5 * dt)
        fields = advance_b(fields, 0.5 * dt)
        if self.sm_mask is not None:
            fields = self.apply_silver_mueller(fields)
        fields = advance(fields, e_comps, _c2, dt, with_j=True)
        if dive:
            fields = advance(fields, ("F",), 1.0, 0.5 * dt,
                             source=-rho_pair[1] / _ep0)
        if divb:
            fields = advance(fields, ("G",), _c2, 0.5 * dt)
        fields = advance_b(fields, 0.5 * dt)

        if self.has_pml:
            # DampPML: damp each split along its own direction, refresh the
            # totals
            split_dirs: Dict[str, list] = {}
            for key in aux:
                if key.startswith("pml:"):
                    _, nm, ax = key.split(":")
                    split_dirs.setdefault(nm, []).append(ax)
            upd = {}
            for nm, dirs in split_dirs.items():
                tot = None
                for ax in sorted(dirs):
                    key = f"pml:{nm}:{ax}"
                    aux[key] = aux[key] * self._damp[nm, self.axes.index(ax)]
                    tot = aux[key] if tot is None else tot + aux[key]
                upd[nm] = torch.where(self.pml_owned[nm], tot,
                                      getattr(fields, nm))
            fields = fields.replace(**upd)

        fields = self.enforce_walls(fields)
        return state.replace(fields=fields, species=new_species,
                             step=state.step + 1, time=state.time + dt,
                             aux=aux)

    def _crop_to_ext(self, arr):
        """Drop the extra wall node of a component nodal in a bounded dim."""
        for d in range(self.ndim):
            if arr.shape[d] == self.n_ext[d] + 1:
                arr = arr.narrow(d, 0, self.n_ext[d])
        return arr

    def _restore_shape(self, arr, comp_name):
        """Re-append the (damped-to-zero) wall node where the component
        stores one."""
        for d in range(self.ndim):
            if arr.shape[d] == self.shapes[comp_name][d] - 1:
                zshape = list(arr.shape)
                zshape[d] = 1
                arr = torch.cat([arr, arr.new_zeros(zshape)], dim=d)
        return arr

    def psatd_push(self, fields, aux, rho_pair=None):
        """The spectral field advance over the extended box (PushPSATD, then
        DampFieldsInGuards; JAX bounded_step.py:1151-1230), with the rho
        pair of update-with-rho and current correction; the time-averaged
        fields come back undamped, as the JAX package's do.  With PML faces
        the interior splits are re-fed from the fields at t^n (the first
        split takes the field, the others zero; PML::Exchange,
        PML.cpp:1180-1196), the splits advance spectrally, are damped along
        their own directions (DampPML) and their totals replace the fields
        in the strips.  Updates the splits in ``aux``; returns the fields."""
        crop = {nm: self._crop_to_ext(getattr(fields, nm))
                for nm in _FIELDS + self.clean}
        new_splits = None
        if self.psatd_pml is not None:
            splits = {}
            for nm in self.pml_comps:
                reg = crop.get(nm)
                m = self.pml_mask_ext[nm]
                for i, ax in enumerate(self.psatd_pml.split_dirs(nm)):
                    cur = aux[f"pml:{nm}:{ax}"]
                    if i == 0 and reg is not None:
                        splits[nm, ax] = torch.where(self.pml_own_ext[nm],
                                                     cur, reg)
                    else:
                        splits[nm, ax] = cur * m
            new_splits = self.psatd_pml.push(splits)
        if rho_pair is not None:
            rho_pair = tuple(self._crop_to_ext(r) for r in rho_pair)
        out = self.psatd.push(crop, rho_pair)
        if new_splits is not None:
            tot = {}
            for (nm, ax), arr in new_splits.items():
                dmp = self.pml_damp_ext.get((nm, ax))
                if dmp is not None:
                    arr = arr * dmp
                aux[f"pml:{nm}:{ax}"] = arr
                tot[nm] = arr if nm not in tot else tot[nm] + arr
            for nm in _EB + tuple(nm for nm in self.clean if nm in tot):
                out[nm] = torch.where(self.pml_own_ext[nm], tot[nm], out[nm])
        upd = {nm: self._restore_shape(out[nm] * self.damp_profile, nm)
               for nm in _EB}
        upd.update({nm: self._restore_shape(out[nm], nm)
                    for nm in self.clean})
        if self.psatd.time_averaging:
            upd.update({nm + "_avg": self._restore_shape(out[nm + "_avg"], nm)
                        for nm in _EB})
        return fields.replace(**upd)

    # ----------------------------------------------------------- step_window
    def shift_field(self, arr, num_shift: int):
        """Slide ``arr`` down the window axis by ``num_shift`` cells; the
        cells that enter at the top are zero."""
        if num_shift == 0:
            return arr
        w = self.wdir
        n = arr.shape[w]
        out = torch.zeros_like(arr)
        out.narrow(w, 0, n - num_shift).copy_(
            arr.narrow(w, num_shift, n - num_shift))
        return out

    def continuous_injection(self, state, sp_cfg, sp, phys_lo, new_hi,
                             draws=None):
        """Inject plasma into the whole cells newly uncovered at the window's
        top (WarpXMovingWindow.cpp:395-440 with AddPlasma's layout).  The
        j-th selected candidate takes the j-th free slot; asking for the
        free slots waits for the device.  Gaussian momenta draw from
        ``draws`` folded with the step and the species (JAX
        bounded_step.py:1565-1578)."""
        cfg = self.cfg
        geom = cfg.geometry
        ndim, wdir = self.ndim, self.wdir
        dxs = geom.dx
        f = self._f
        key = f"inject_pos:{sp_cfg.name}"
        cur_pos = state.aux[key]
        dz = f(dxs[wdir])
        # (new_hi - cur_pos) is a whole number of cells for a plasma at rest
        # (both move in dz quanta): nudge the floor so that accumulated
        # rounding cannot hold the newest column back for a step
        new_pos = f(cur_pos + f(np.floor(
            f(f(f(new_hi[wdir] - cur_pos) / dz) + f(1e-9))) * dz))
        # the band of candidate cells: with the tile-binned step injection
        # is batched to the steps before a rebin, so the band covers a whole
        # interval of window motion
        K = max(self.max_shift * (2 if self.spec is None
                                  else self.spec.interval + 2), 4)
        unit = _regular_unit_positions(
            sp_cfg.num_particles_per_cell_each_dim, ndim)
        ppc_tot = unit.shape[0]
        kw = dict(dtype=self.dtype, device=self.device)
        unit_active = torch.as_tensor(unit[:, list(_AXES3[ndim])], **kw)
        grids = []
        for d in range(ndim):
            if d == wdir:
                cells = torch.arange(geom.n_cell[wdir] - K, geom.n_cell[wdir],
                                     **kw)
                grids.append(phys_lo[wdir] + cells * dxs[wdir])
            else:
                grids.append(geom.prob_lo[d]
                             + torch.arange(geom.n_cell[d], **kw) * dxs[d])
        mesh = torch.meshgrid(*grids, indexing="ij")
        cell_lo = torch.stack([m.reshape(-1) for m in mesh], dim=-1)
        npart = cell_lo.shape[0] * ppc_tot
        pos = (cell_lo[:, None, :]
               + unit_active * torch.as_tensor(dxs, **kw)).reshape(npart,
                                                                   ndim)
        scale_vec = torch.full((npart,), geom.cell_volume / ppc_tot, **kw)
        if self.mr is not None and cfg.refine_plasma and \
                sp_cfg.do_continuous_injection:
            # warpx.refine_plasma (findRefinedInjectionBox,
            # PhysicalParticleContainer.cpp:3260; JAX bounded_step.py:
            # 1446-1490): the cells whose coarse index across the window
            # axis falls in the refined box's footprint inject on the fine
            # lattice instead, after the coarse candidates
            mrl = self.mr.layout
            rv = mrl.rv
            R = int(np.prod(rv))
            dxf = torch.as_tensor([dxs[d] / rv[d] for d in range(ndim)],
                                  **kw)
            subs = torch.meshgrid(*[torch.arange(rv[d], **kw)
                                    * (dxs[d] / rv[d]) for d in range(ndim)],
                                  indexing="ij")
            sub = torch.stack([t.reshape(-1) for t in subs], dim=-1)
            pos_f = (cell_lo[:, None, None, :] + sub[None, :, None, :]
                     + unit_active * dxf).reshape(-1, ndim)

            def in_footprint(p):
                m = torch.ones(p.shape[0], dtype=torch.bool,
                               device=self.device)
                for d in range(ndim):
                    if d == wdir:
                        continue
                    ci = torch.floor((p[:, d] - geom.prob_lo[d]) / dxs[d])
                    m &= (ci >= mrl.i0[d]) & (ci < mrl.i1[d])
                return m

            zero = torch.zeros((), **kw)
            scale_vec = torch.cat([
                torch.where(in_footprint(pos), zero, scale_vec),
                torch.where(in_footprint(pos_f),
                            torch.full((), geom.cell_volume / (R * ppc_tot),
                                       **kw), zero)])
            pos = torch.cat([pos, pos_f], dim=0)
            npart = pos.shape[0]
        pz = pos[:, wdir]
        sel = (pz > cur_pos) & (pz < new_pos)
        if self.shards is not None:
            # particle decomposition: each candidate lands on exactly one
            # rank, dealt round-robin by rank WITHIN the selected set so
            # that every batch spreads evenly whatever the candidate grid's
            # order (JAX bounded_step.py:1499-1507)
            sel &= ((torch.cumsum(sel, 0) - 1) % self.shards.world
                    == self.shards.rank)
        # boosted frame: the profiles and bounds are the lab's at
        # t_lab = 0, reached by the ballistic correction at the boosted
        # time (PhysicalParticleContainer.cpp applyBallisticCorrection)
        lab = pos
        gb, bb = cfg.gamma_boost, self.beta_boost
        if gb > 1.0:
            ub = _bulk_momentum(sp_cfg)
            betaz_bulk = float(ub[2] / np.sqrt(1.0 + ub @ ub))
            lab = pos.clone()
            lab[:, -1] = gb * (pos[:, -1] * (1.0 - bb * betaz_bulk)
                               - _c * state.time * (betaz_bulk - bb))
        if sp_cfg.bounds_lo:
            for d in range(ndim):
                sel &= ((lab[:, d] >= sp_cfg.bounds_lo[d])
                        & (lab[:, d] <= sp_cfg.bounds_hi[d]))
        if sp_cfg.profile == "constant":
            dens = torch.full((npart,), sp_cfg.density, **kw)
        else:
            dens = profile_values(sp_cfg.density_expr, sp_cfg, lab,
                                  ndim).to(self.dtype)
        w_new = torch.where(sel, dens * scale_vec, torch.zeros((), **kw))
        sel &= w_new > 0
        if sp_cfg.momentum_distribution == "constant":
            u_new = [torch.full((npart,), v * _c, **kw)
                     for v in (sp_cfg.ux, sp_cfg.uy, sp_cfg.uz)]
        elif sp_cfg.momentum_distribution == "parse_momentum_function":
            u_new = [profile_values(e, sp_cfg, lab, ndim).to(self.dtype) * _c
                     for e in sp_cfg.momentum_exprs]
        elif sp_cfg.momentum_distribution == "gaussian":
            if draws is None:
                raise ValueError("Gaussian continuous injection draws "
                                 "random numbers: pass a utils.draws source")
            # the JAX package folds the key with the step and Python's
            # (per-process salted) hash of the name; a source replaying its
            # chain takes the same hash in the same process
            ks = draws.fold_in(state.step).fold_in(
                abs(hash(sp_cfg.name)) % (2 ** 31)).split(3)
            u_new = [(mu + (th or 0.0) * k.normal((npart,), self.dtype)) * _c
                     for mu, th, k in zip(
                         (sp_cfg.ux, sp_cfg.uy, sp_cfg.uz),
                         (sp_cfg.ux_th, sp_cfg.uy_th, sp_cfg.uz_th), ks)]
        else:  # at rest
            u_new = [torch.zeros(npart, **kw) for _ in range(3)]
        if gb > 1.0:
            # lab -> boosted momenta and flux factor (AddPlasma:1243-1246)
            gam_lab = torch.sqrt(1.0 + (u_new[0] * u_new[0]
                                        + u_new[1] * u_new[1]
                                        + u_new[2] * u_new[2]) / (_c * _c))
            betaz_lab = u_new[2] / (gam_lab * _c)
            w_new = w_new * gb * (1.0 - bb * betaz_lab)
            u_new[2] = gb * (u_new[2] - bb * gam_lab * _c)
            sel &= w_new > 0

        src = torch.nonzero(sel).reshape(-1)
        free = torch.nonzero(~sp.alive).reshape(-1)[:npart]
        if src.numel() > free.numel():
            raise RuntimeError(
                f"continuous injection of {sp_cfg.name!r}: {src.numel()} new "
                f"particles but {free.numel()} free slots (raise "
                "tile_headroom or capacity_factor)")
        tgt = free[:src.numel()]

        def put(arr, vals):
            out = arr.clone()
            out[tgt] = vals[src].to(arr.dtype)
            return out

        alive = sp.alive.clone()
        alive[tgt] = True
        new = sp.replace(w=put(sp.w, w_new), ux=put(sp.ux, u_new[0]),
                         uy=put(sp.uy, u_new[1]), uz=put(sp.uz, u_new[2]),
                         alive=alive)
        new = new.with_positions(ndim, [
            put(p, pos[:, d]) for d, p in enumerate(sp.positions(ndim))])
        if sp_cfg.attributes:
            # at the lab position, the boosted momenta and the time of the
            # step (JAX bounded_step.py:1600-1605)
            vals = attribute_values(
                sp_cfg, xyz_of([lab[:, d] for d in range(ndim)], ndim),
                *u_new, state.time, self.dtype)
            new = new.replace(extra={
                **new.extra, **{k: put(new.extra[k], v)
                                for k, v in vals.items()}})
        aux = dict(state.aux)
        aux[key] = new_pos
        return state.replace(aux=aux), new

    def step_window(self, state: SimState, move_j: bool,
                    draws=None) -> SimState:
        """MoveWindow and the particle boundaries: advance the window's host
        scalars, shift the fields and the PML splits (and J when
        ``move_j``), inject into the uncovered cells, then record what
        crossed a face into the scraping buffers, absorb it, and reflect
        or re-emit it from a thermal wall; the Gaussian injection and the
        thermal walls draw from ``draws``."""
        cfg = self.cfg
        ndim, wdir = self.ndim, self.wdir
        f = self._f
        if cfg.do_moving_window:
            aux = dict(state.aux)
            # the injection front rides with the plasma's bulk velocity
            # (UpdateInjectionPosition, WarpXMovingWindow.cpp:61-134)
            for sp_cfg in cfg.species:
                if (not sp_cfg.do_continuous_injection
                        or self.is_laser[sp_cfg.name]):
                    continue
                u_d = float(_bulk_momentum(sp_cfg)[_AXES3[ndim][wdir]])
                v_shift = _c * u_d / math.sqrt(1.0 + u_d * u_d)
                if cfg.gamma_boost > 1.0:
                    # the lab speed composed with the frame's
                    bb = self.beta_boost
                    v_shift = (v_shift - _c * bb) / (1.0 - v_shift * bb / _c)
                key_ip = f"inject_pos:{sp_cfg.name}"
                aux[key_ip] = f(aux[key_ip] + f(v_shift * cfg.dt))
            dz = f(cfg.geometry.dx[wdir])
            window_x = f(aux["window_x"]
                         + f(cfg.moving_window_v * _c * cfg.dt))
            # under Galilean PSATD the count is the window's motion relative
            # to the drifting grid (WarpXMovingWindow.cpp:171; state.time is
            # t^{n+1} here)
            lo_grid = aux["window_lo"]
            if self.v_gal is not None:
                lo_grid = f(lo_grid + f(self.v_gal[wdir] * f(state.time)))
            num_shift = int(np.floor(f(f(window_x - lo_grid) / dz)))
            num_shift = min(max(num_shift, 0), self.max_shift)
            shift_len = f(f(num_shift) * dz)
            aux["window_x"] = window_x
            aux["window_offset"] = int(aux["window_offset"]) + num_shift
            aux["window_lo"] = f(aux["window_lo"] + shift_len)
            aux["window_hi"] = f(aux["window_hi"] + shift_len)

            fl = state.fields
            names = list(_EB + self.clean) + (["jx", "jy", "jz"] if move_j
                                               else [])
            if fl.Ex_avg is not None:
                names += [nm + "_avg" for nm in _EB]
            upd = {nm: self.shift_field(getattr(fl, nm), num_shift)
                   for nm in names}
            for key in aux:
                if key.startswith(("pml:", "mr:c:")):
                    aux[key] = self.shift_field(aux[key], num_shift)
                elif key.startswith(("mr:f:", "mr:j:")):
                    # the refined box is fixed in level 0's index space: the
                    # fine patch shifts by ref_ratio fine cells a coarse
                    # cell (shiftMF on every level,
                    # WarpXMovingWindow.cpp:479)
                    aux[key] = self.shift_field(
                        aux[key], num_shift * self.mr.layout.rv[wdir])
            state = state.replace(fields=fl.replace(**upd), aux=aux)
            new_phys_lo = self.phys_lo_of(state)
            new_hi = self.domain_hi_of(state)

            # binned mode: new particles land in arbitrary dead slots, which
            # only the rebin re-sorts, so inject only when the next step
            # rebins (state.step is already that step's number)
            due = (self.spec is None
                   or state.step % self.spec.interval == 0)
            if due:
                new_species = dict(state.species)
                for sp_cfg in cfg.species:
                    if (not sp_cfg.do_continuous_injection
                            or self.is_laser[sp_cfg.name]):
                        continue
                    state, new_species[sp_cfg.name] = \
                        self.continuous_injection(
                            state, sp_cfg, new_species[sp_cfg.name],
                            new_phys_lo, new_hi, draws)
                state = state.replace(species=new_species)

        origin = self.phys_lo_of(state)
        hi = self.domain_hi_of(state)
        new_species = {}
        scrape = {}
        for sp_cfg in cfg.species:
            sp = state.species[sp_cfg.name]
            if sp.capacity == 0:
                new_species[sp_cfg.name] = sp
                continue
            alive = sp.alive
            pos = list(sp.positions(ndim))
            for face in sp_cfg.save_particles_at:
                scrape.update(self._scrape(state, sp_cfg, sp, pos, face,
                                           origin, hi))
            for d in range(ndim):
                if self.pbc_lo[d] == "absorbing":
                    alive = alive & (pos[d] >= origin[d])
                if self.pbc_hi[d] == "absorbing":
                    alive = alive & (pos[d] <= hi[d])
            if self.eb_phi is not None:
                # remove the particles inside the body
                # (EmbeddedBoundary/ParticleScraper.H)
                alive = alive & ~self.inside_eb(pos)
            u = {"x": sp.ux, "y": sp.uy, "z": sp.uz}
            for d in range(ndim):
                for bc, sign in ((self.pbc_lo[d], 1.0), (self.pbc_hi[d],
                                                          -1.0)):
                    if bc not in ("reflecting", "thermal"):
                        continue
                    wall = origin[d] if sign > 0 else hi[d]
                    ref = pos[d] < wall if sign > 0 else pos[d] > wall
                    pos[d] = torch.where(ref, 2 * wall - pos[d], pos[d])
                    if bc == "thermal":
                        self._thermalize(u, ref, d, sign, sp_cfg, draws)
                    else:
                        ax = self.axes[d]
                        u[ax] = torch.where(ref, -u[ax], u[ax])
            new_species[sp_cfg.name] = sp.replace(
                alive=alive, ux=u["x"], uy=u["y"], uz=u["z"],
            ).with_positions(ndim, pos)
        return state.replace(species=new_species,
                             aux={**state.aux, **scrape} if scrape
                             else state.aux)

    def _scrape(self, state, sp_cfg, sp, pos, face, origin, hi) -> dict:
        """Record the live particles of ``sp`` beyond absorbing ``face``
        (or inside the embedded body for "eb") into its buffer
        (ParticleBoundaryBuffer; JAX bounded_step.py:1759-1802): the k-th
        of them in slot order takes record count + k; records past the
        buffer's capacity are dropped while the count goes on.  Returns the
        buffer's updated aux entries."""
        ndim = self.ndim
        if face == "eb":
            if self.eb_phi is None:
                return {}
            crossed = sp.alive & self.inside_eb(pos)
        elif face[0] not in self.axes:
            return {}
        else:
            d = self.axes.index(face[0])
            is_lo = face.endswith("lo")
            if (self.pbc_lo[d] if is_lo else self.pbc_hi[d]) != "absorbing":
                return {}
            crossed = sp.alive & (pos[d] < origin[d] if is_lo
                                  else pos[d] > hi[d])
        pref = f"scrape:{sp_cfg.name}:{face}"
        n0 = state.aux[f"{pref}:n"]
        cap = state.aux[f"{pref}:w"].shape[0]
        rank = torch.cumsum(crossed.to(torch.int64), 0) - 1
        tgt = torch.where(crossed, n0.to(torch.int64) + rank,
                          torch.full_like(rank, cap)).clamp_(max=cap)
        recs = [("w", sp.w), ("ux", sp.ux), ("uy", sp.uy), ("uz", sp.uz)]
        recs += [(f"p{d}", pos[d]) for d in range(ndim)]
        recs.append(("step", torch.full_like(tgt, state.step)))
        out = {}
        for fld, arr in recs:
            base = state.aux[f"{pref}:{fld}"]
            # one slot past the buffer takes the rest and is cut away
            buf = torch.cat([base, base.new_zeros(1)])
            buf.scatter_(0, tgt, arr.to(base.dtype))
            out[f"{pref}:{fld}"] = buf[:cap]
        out[f"{pref}:n"] = n0 + crossed.sum(dtype=n0.dtype)
        return out

    def _thermalize(self, u, ref, d, side_sign, sp_cfg, draws):
        """Thermal wall re-emission of the reflected particles ``ref``
        (ParticleBoundaries_K.H:82-90; JAX bounded_step.py:1820-1851): the
        normal u from the Gaussian flux distribution of spread u_th,
        directed into the domain, the tangential ones Gaussian; each face
        draws full-capacity vectors from three sources split from
        ``draws``.  With u_th <= 0 the reflected particles stop."""
        from .flux_injection import sample_gaussian_flux

        uth = sp_cfg.boundary_u_th
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        if uth <= 0.0:
            for ax in "xyz":
                u[ax] = torch.where(ref, zero, u[ax])
            return
        if draws is None:
            raise ValueError("thermal walls draw random numbers: pass "
                             "step_window a utils.draws source")
        cap = ref.shape[0]
        k1, k2, k3 = draws.split(3)
        ax_n = self.axes[d]
        un = self._shard_draw(
            k1, lambda k, n: sample_gaussian_flux(k, n, 0.0, uth, self.dtype,
                                                  self.device), cap) * _c
        u[ax_n] = torch.where(ref, side_sign * un, u[ax_n])
        ks = [k2, k3]
        for ax in "xyz":
            if ax == ax_n:
                continue
            u[ax] = torch.where(ref, uth * _c * self._shard_draw(
                ks.pop(), lambda k, n: k.normal((n,), self.dtype), cap),
                u[ax])

    def _shard_draw(self, k, draw, cap):
        """``draw(k, cap)``; under particle decomposition from
        ``k.fold_in(rank)``, so that the ranks' particles take different
        numbers (JAX bounded_step.py:483-490 ``_shard_key``).  A source
        whose ``fold_in`` derives no new stream (``utils/draws.py``'s
        ``Draws``: every rank's generator runs in step) draws every rank's
        vector and this rank keeps its own: the streams stay in step, the
        ranks' numbers differ."""
        if self.shards is None:
            return draw(k, cap)
        folded = k.fold_in(self.shards.rank)
        if folded is not k:
            return draw(folded, cap)
        r = self.shards.rank
        return draw(k, cap * self.shards.world)[r * cap:(r + 1) * cap]

    # ------------------------------------------------------------- half push
    def half_push(self, state: SimState, dt_half: float) -> SimState:
        """Gather on the padded blocks at the current positions (the
        instantaneous fields, at the Galilean origin of t^n) and push the
        momenta by ``dt_half`` only."""
        origin = self.gal_origin_at(self.origin_of(state), state)
        farr_pad = self._padded_eb(state.fields)
        if self.mc_gather:
            farr_pad = self.mc_aux_pads(farr_pad)
        fine = (self.mr_gather_fields(state) if self.mr is not None
                else None)
        new_species = {}
        for sp_cfg in self.cfg.species:
            sp = state.species[sp_cfg.name]
            if (sp.capacity == 0 or self.is_laser[sp_cfg.name]
                    or sp_cfg.species_type == "photon"
                    or sp_cfg.do_not_push):
                new_species[sp_cfg.name] = sp
                continue
            pos = sp.positions(self.ndim)
            if self.spec is not None:
                # binned layouts leave the positions unwrapped between
                # rebins: wrap the gather's coordinate, not the state's
                pos = self._wrap_periodic(pos)
            # the JAX package's bounded half push adds the lattice
            # (bounded_step.py:1932), its periodic one does not
            e6 = self._gather(pos, farr_pad, origin, u3=(sp.ux, sp.uy, sp.uz),
                              fine=fine)
            ux, uy, uz = PUSHERS[sp_cfg.pusher](
                sp.ux, sp.uy, sp.uz, *e6, sp_cfg.charge, sp_cfg.mass,
                dt_half)
            new_species[sp_cfg.name] = sp.replace(ux=ux, uy=uy, uz=uz)
        return state.replace(species=new_species)

    # ------------------------------------------------------------ step_binned
    def to_kernel_frame(self, farr_pad):
        """Slice the guard-padded component blocks to the fused kernels'
        window-aligned layout (the bounded ``pad_fields``): extents
        ``padded_shape(spec, n_cell, smax)``, the window axis with ``smax``
        cells of slack below so that the kernels' window start
        ``t*tile + smax - zshift`` stays in range for any shift in
        [0, smax].  Rows outside the block are zero: only a particle beyond
        the margin reaches them, and the violation count flags it."""
        shape = padded_shape(self.spec, self.cfg.geometry.n_cell, self.smax)
        outs = []
        for nm in _EB:
            a = farr_pad[nm]
            src, dst = [], []
            for d in range(self.ndim):
                lo_i = self.kbase[d] - (self.smax if d == self.waxis else 0)
                s_sl, d_sl = _overlap(-lo_i, a.shape[d], shape[d])
                src.append(s_sl)
                dst.append(d_sl)
            out = a.new_zeros(shape)
            out[tuple(dst)] = a[tuple(src)]
            outs.append(out)
        return tuple(outs)

    def embed_folded(self, F, shift: int):
        """Place an open-folded J (``fold_windows_open``: extent
        n + w - tile per dim, index p <-> anchor-frame cell p - off) in a
        zeroed ``big_shape`` block at the base the gather frame uses, less
        the window's shift since the rebin; what falls outside is dropped
        (zero by the violation count)."""
        src, dst = [], []
        for d in range(self.ndim):
            start = self.kbase[d] - (shift if d == self.waxis else 0)
            s_sl, d_sl = _overlap(start, F.shape[d], self.big_shape[d])
            src.append(s_sl)
            dst.append(d_sl)
        out = F.new_zeros(self.big_shape)
        out[tuple(dst)] = F[tuple(src)]
        return out

    def step_binned(self, state: SimState) -> SimState:
        """The tile-binned bounded step: rebin every ``interval`` steps
        around the window's current edge, fused gather + push + deposit over
        the anchored tiles, open fold into the deposition block, the beam
        and the antenna alongside on the per-particle path, field tail."""
        cfg, spec = self.cfg, self.spec
        geom = cfg.geometry
        ndim = self.ndim
        f = self._f
        nt = spec.n_tiles
        do_rebin = state.step % spec.interval == 0
        aux_updates = {}
        origin_t = list(geom.prob_lo)
        shift = 0
        if cfg.do_moving_window:
            # the tiles re-anchor to the window's edge at each rebin;
            # between rebins the grid slides under them by whole cells
            anchor = (state.aux["window_lo"] if do_rebin
                      else state.aux["tile_anchor"])
            aux_updates["tile_anchor"] = anchor
            shift = int(np.round(f(f(state.aux["window_lo"] - anchor)
                                   / f(geom.dx[self.wdir]))))
            origin_t[self.wdir] = anchor
            self.zshifts_seen.add(shift)

        # --- rebin: absorbed slots sort past the last tile and free up
        overflow = state.aux["tile_overflow"]
        species = dict(state.species)
        if do_rebin:
            for sp_cfg in self.binned_cfgs:
                species[sp_cfg.name], ovf = rebin(
                    species[sp_cfg.name], geom, spec, origin=tuple(origin_t),
                    wrap_dims=self.wrap_dims)
                overflow = overflow + ovf
        state_b = state.replace(species=species)

        # --- guard-padded fields (through the NCI corrector) -> kernel
        # frame
        farr_pad = self._padded_eb(state.fields)
        if cfg.use_nci_corr:
            farr_pad = _apply_nci(farr_pad, cfg)
        fields6 = self.to_kernel_frame(farr_pad)

        # --- fused gather + push + deposit: one launch per pusher
        jw_tot = None
        violations = state.aux["tile_violations"]
        new_species = {}
        for pusher_name, sps, params, parts, counts in pusher_groups(
                state_b, spec, self.params):
            newp, jw, viol = binned_push_deposit(
                params, fields6, parts, tuple(origin_t), shift,
                counts=counts, spec=spec, geom=geom,
                order=cfg.particle_shape, galerkin=cfg.galerkin,
                pusher_name=pusher_name, dt=cfg.dt,
                stag_items=self.stag_items, mxu=cfg.tile_mxu,
                smax=self.smax)
            jw_tot = jw if jw_tot is None else tuple(
                a + b for a, b in zip(jw_tot, jw))
            violations = violations + viol.sum(dtype=torch.int32)
            for k, sp_cfg in enumerate(sps):
                sl = slice(k * nt, (k + 1) * nt)
                flat = [a[sl].reshape(-1) for a in newp]
                new_species[sp_cfg.name] = species[sp_cfg.name].replace(
                    ux=flat[ndim], uy=flat[ndim + 1], uz=flat[ndim + 2],
                ).with_positions(ndim, flat[:ndim])

        # --- open fold into the big_shape guard frame
        j_total = None
        if jw_tot is not None:
            j_total = tuple(
                self.embed_folded(
                    fold_windows_open(jw_tot[i], spec,
                                      axes=_FOLD_AXES[ndim][i]), shift)
                for i in range(3))

        # --- small static species ride the per-particle path in their
        # compact layout (no rebin: expanding a 100-particle beam to
        # n_tiles * p_max slots would cost a sort as large as the plasma's)
        origin = self.origin_of(state)
        for sp_cfg in cfg.species:
            if sp_cfg.name not in self.slow_species:
                continue
            sp = state.species[sp_cfg.name]
            if sp.capacity == 0:
                new_species[sp_cfg.name] = sp
                continue
            pos = sp.positions(ndim)
            e6 = self._gather(pos, farr_pad, origin)
            ux, uy, uz = PUSHERS[sp_cfg.pusher](
                sp.ux, sp.uy, sp.uz, *e6, sp_cfg.charge, sp_cfg.mass, cfg.dt)
            new_pos = position_step(pos, ux, uy, uz, cfg.dt, ndim)
            sp_new = sp.replace(ux=ux, uy=uy, uz=uz).with_positions(ndim,
                                                                    new_pos)
            new_species[sp_cfg.name] = sp_new
            w_eff = torch.where(sp.alive, sp_new.w, torch.zeros_like(sp.w))
            j_total = self._deposit(new_pos, (ux, uy, uz), w_eff,
                                    sp_cfg.charge, origin, self.big_shape,
                                    out=j_total)

        # --- laser antennas deposit alongside
        for sp_cfg in cfg.species:
            if not self.is_laser[sp_cfg.name]:
                continue
            sp = state.species[sp_cfg.name]
            if sp.capacity == 0:
                new_species[sp_cfg.name] = sp
                continue
            sp_new = self._advance_antenna(sp, sp_cfg.name, state.time)
            w_eff = torch.where(sp.alive, sp_new.w, torch.zeros_like(sp.w))
            j_total = self._deposit(
                sp_new.positions(ndim), (sp_new.ux, sp_new.uy, sp_new.uz),
                w_eff, 1.0, origin, self.big_shape, out=j_total)
            new_species[sp_cfg.name] = sp_new

        aux_updates["tile_overflow"] = overflow
        aux_updates["tile_violations"] = violations
        return self.field_tail(state, new_species, j_total, aux_updates)

    def step(self, state: SimState, draws=None) -> SimState:
        return (self.step_main(state, draws) if self.spec is None
                else self.step_binned(state))
