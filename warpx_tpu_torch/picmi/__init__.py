"""PICMI-standard Python front end.

The counterpart of ``warpx_tpu.picmi``, with the surface of the reference's
``pywarpx.picmi`` (Python/pywarpx/picmi.py): users construct grids,
solvers, species, lasers, applied fields, collisions and diagnostics and
call ``Simulation.step(n)``.

As in the reference, every PICMI object LOWERS TO INPUT DECK KEYS (the
reference lowers onto pywarpx ParmParse buckets, picmi.py:2976
initialize_warpx; here onto a deck string that ``Simulation.from_deck``
reads), so the PICMI surface covers what the deck reader covers, and what
the reader refuses (``NotImplementedError`` naming its ROADMAP.md item) it
refuses alike.  The deck text is the JAX package's byte for byte.

``write_input_file`` writes the generated deck, so a PICMI script and its
deck run alike (the analog of picmi.py:2983).  The one difference in
surface: ``Simulation`` takes keyword-only ``device`` (None: the card; with
no GPU the run raises) and ``dtype`` (None: float32), which JAX takes from
its own configuration.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List

from .. import constants as _const

__all__ = [
    "constants",
    # species & distributions
    "Species", "MultiSpecies", "UniformDistribution", "AnalyticDistribution",
    "GaussianBunchDistribution", "UniformFluxDistribution",
    "ParticleListDistribution",
    "PseudoRandomLayout", "GriddedLayout",
    # grids & smoothers
    "Cartesian1DGrid", "Cartesian2DGrid", "Cartesian3DGrid",
    "CylindricalGrid", "BinomialSmoother",
    # solvers
    "ElectromagneticSolver", "ElectrostaticSolver", "HybridPICSolver",
    "ExplicitEvolveScheme", "ThetaImplicitEMEvolveScheme",
    "SemiImplicitEMEvolveScheme", "PicardNonlinearSolver",
    "NewtonNonlinearSolver", "GMRESLinearSolver",
    # lasers
    "GaussianLaser", "AnalyticLaser", "LaserAntenna",
    # fields applied / loaded
    "ConstantAppliedField", "AnalyticAppliedField", "AnalyticInitialField",
    "LoadInitialField", "LoadAppliedField", "Mirror", "PlasmaLens",
    # elementary processes & collisions
    "FieldIonization", "CoulombCollisions", "MCCCollisions",
    "DSMCCollisions", "EmbeddedBoundary",
    # diagnostics
    "FieldDiagnostic", "TimeAveragedFieldDiagnostic", "ParticleDiagnostic",
    "Checkpoint", "ReducedDiagnostic", "LabFrameFieldDiagnostic",
    "LabFrameParticleDiagnostic", "ParticleBoundaryScrapingDiagnostic",
    "Simulation",
]

constants = SimpleNamespace(
    c=_const.c, ep0=_const.ep0, mu0=_const.mu0, q_e=_const.q_e,
    m_e=_const.m_e, m_p=_const.m_p, kb=_const.kb,
)

_AXES3 = {1: ("z",), 2: ("x", "z"), 3: ("x", "y", "z")}


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (list, tuple)):
        return " ".join(_fmt(x) for x in v)
    if isinstance(v, float):
        return repr(v)
    return str(v)


class _Deck:
    """Ordered key-value store rendered as a ParmParse deck."""

    def __init__(self):
        self.items: List = []
        self._names: Dict[str, List[str]] = {}

    def set(self, key: str, val) -> None:
        if val is None:
            return
        self.items.append((key, _fmt(val)))

    def append_name(self, group: str, name: str) -> None:
        self._names.setdefault(group, [])
        if name not in self._names[group]:
            self._names[group].append(name)

    def text(self) -> str:
        lines = [
            f"{group} = {' '.join(names)}"
            for group, names in self._names.items()
        ]
        lines += [f"{k} = {v}" for k, v in self.items]
        return "\n".join(lines) + "\n"


# ------------------------------------------------------------------ layouts

class GriddedLayout:
    def __init__(self, n_macroparticle_per_cell, grid=None):
        self.n_macroparticle_per_cell = list(n_macroparticle_per_cell)
        self.grid = grid


class PseudoRandomLayout:
    def __init__(self, n_macroparticles=None, n_macroparticles_per_cell=None,
                 seed=None, grid=None):
        self.n_macroparticles = n_macroparticles
        self.n_macroparticles_per_cell = n_macroparticles_per_cell
        self.seed = seed
        self.grid = grid


# ------------------------------------------------------------ distributions

class UniformDistribution:
    def __init__(self, density, lower_bound=None, upper_bound=None,
                 directed_velocity=None, rms_velocity=None, fill_in=None):
        self.density = density
        self.lower_bound = list(lower_bound or [None] * 3)
        self.upper_bound = list(upper_bound or [None] * 3)
        self.directed_velocity = list(directed_velocity or [0.0] * 3)
        self.rms_velocity = list(rms_velocity or [0.0] * 3)
        self.fill_in = fill_in

    def _lower(self, d, name):
        d.set(f"{name}.profile", "constant")
        d.set(f"{name}.density", self.density)
        _bounds(d, name, self.lower_bound, self.upper_bound)
        _momentum(d, name, self.directed_velocity, self.rms_velocity)
        if self.fill_in:
            d.set(f"{name}.do_continuous_injection", 1)


class AnalyticDistribution:
    def __init__(self, density_expression, lower_bound=None, upper_bound=None,
                 directed_velocity=None, momentum_expressions=None,
                 rms_velocity=None, fill_in=None, **user_vars):
        self.density_expression = density_expression
        self.lower_bound = list(lower_bound or [None] * 3)
        self.upper_bound = list(upper_bound or [None] * 3)
        self.directed_velocity = list(directed_velocity or [0.0] * 3)
        self.momentum_expressions = momentum_expressions
        self.rms_velocity = list(rms_velocity or [0.0] * 3)
        self.fill_in = fill_in
        self.user_vars = dict(user_vars)

    def _lower(self, d, name):
        d.set(f"{name}.profile", "parse_density_function")
        d.set(f"{name}.density_function(x,y,z)", self.density_expression)
        for k, v in self.user_vars.items():
            d.set(f"my_constants.{k}", v)
        _bounds(d, name, self.lower_bound, self.upper_bound)
        if self.momentum_expressions and any(
                e is not None for e in self.momentum_expressions):
            d.set(f"{name}.momentum_distribution_type",
                  "parse_momentum_function")
            for comp, e in zip(("ux", "uy", "uz"), self.momentum_expressions):
                d.set(f"{name}.momentum_function_{comp}(x,y,z)",
                      f"({e or 0})/{_const.c!r}")
        else:
            _momentum(d, name, self.directed_velocity, self.rms_velocity)
        if self.fill_in:
            d.set(f"{name}.do_continuous_injection", 1)


class GaussianBunchDistribution:
    def __init__(self, n_physical_particles, rms_bunch_size,
                 rms_velocity=None, centroid_position=None,
                 centroid_velocity=None, velocity_divergence=None):
        self.n_physical_particles = n_physical_particles
        self.rms_bunch_size = list(rms_bunch_size)
        self.rms_velocity = list(rms_velocity or [0.0] * 3)
        self.centroid_position = list(centroid_position or [0.0] * 3)
        self.centroid_velocity = list(centroid_velocity or [0.0] * 3)

    def _lower(self, d, name, n_macroparticles=100, charge=-_const.q_e):
        inv_c = 1.0 / _const.c
        d.set(f"{name}.injection_style", "gaussian_beam")
        for ax, s, m in zip("xyz", self.rms_bunch_size,
                            self.centroid_position):
            d.set(f"{name}.{ax}_rms", s)
            d.set(f"{name}.{ax}_m", m)
        d.set(f"{name}.npart", n_macroparticles)
        d.set(f"{name}.q_tot", self.n_physical_particles * charge)
        d.set(f"{name}.momentum_distribution_type", "gaussian")
        for comp, v, th in zip(("ux", "uy", "uz"), self.centroid_velocity,
                               self.rms_velocity):
            d.set(f"{name}.{comp}_m", v * inv_c)
            d.set(f"{name}.{comp}_th", th * inv_c)


class UniformFluxDistribution:
    def __init__(self, flux, flux_normal_axis, surface_flux_position,
                 flux_direction, flux_tmin=None, flux_tmax=None,
                 directed_velocity=None, rms_velocity=None,
                 gaussian_flux_momentum_distribution=True):
        self.flux = flux
        self.flux_normal_axis = flux_normal_axis
        self.surface_flux_position = surface_flux_position
        self.flux_direction = flux_direction
        self.flux_tmin = flux_tmin
        self.flux_tmax = flux_tmax
        self.directed_velocity = list(directed_velocity or [0.0] * 3)
        self.rms_velocity = list(rms_velocity or [0.0] * 3)
        self.gaussian = gaussian_flux_momentum_distribution

    def _lower(self, d, name, ppc=2):
        inv_c = 1.0 / _const.c
        ax = (self.flux_normal_axis if isinstance(self.flux_normal_axis, str)
              else "xyz"[self.flux_normal_axis])
        d.set(f"{name}.injection_style", "NFluxPerCell")
        d.set(f"{name}.num_particles_per_cell", ppc)
        d.set(f"{name}.flux_profile", "constant")
        d.set(f"{name}.flux", self.flux)
        d.set(f"{name}.surface_flux_pos", self.surface_flux_position)
        d.set(f"{name}.flux_normal_axis", ax)
        d.set(f"{name}.flux_direction", int(self.flux_direction))
        if self.flux_tmin is not None:
            d.set(f"{name}.flux_tmin", self.flux_tmin)
        if self.flux_tmax is not None:
            d.set(f"{name}.flux_tmax", self.flux_tmax)
        d.set(f"{name}.momentum_distribution_type",
              "gaussianflux" if self.gaussian else "gaussian")
        for comp, v, th in zip(("ux", "uy", "uz"), self.directed_velocity,
                               self.rms_velocity):
            d.set(f"{name}.{comp}_m", v * inv_c)
            d.set(f"{name}.{comp}_th", th * inv_c)


class ParticleListDistribution:
    def __init__(self, x=0.0, y=0.0, z=0.0, ux=0.0, uy=0.0, uz=0.0,
                 weight=0.0):
        def lst(v):
            return list(v) if isinstance(v, (list, tuple)) else [v]
        self.x, self.y, self.z = lst(x), lst(y), lst(z)
        self.ux, self.uy, self.uz = lst(ux), lst(uy), lst(uz)
        self.weight = lst(weight)
        n = len(self.x)
        for a in ("y", "z", "ux", "uy", "uz", "weight"):
            col = getattr(self, a)
            if len(col) == 1 and n > 1:
                setattr(self, a, col * n)

    def _lower(self, d, name):
        inv_c = 1.0 / _const.c
        d.set(f"{name}.injection_style", "MultipleParticles")
        d.set(f"{name}.multiple_particles_pos_x", self.x)
        d.set(f"{name}.multiple_particles_pos_y", self.y)
        d.set(f"{name}.multiple_particles_pos_z", self.z)
        d.set(f"{name}.multiple_particles_ux",
              [u * inv_c for u in self.ux])
        d.set(f"{name}.multiple_particles_uy",
              [u * inv_c for u in self.uy])
        d.set(f"{name}.multiple_particles_uz",
              [u * inv_c for u in self.uz])
        d.set(f"{name}.multiple_particles_weight", self.weight)


def _bounds(d, name, lower, upper):
    for ax, lo, hi in zip("xyz", lower, upper):
        if lo is not None:
            d.set(f"{name}.{ax}min", lo)
        if hi is not None:
            d.set(f"{name}.{ax}max", hi)


def _momentum(d, name, v, rms):
    inv_c = 1.0 / _const.c
    if any(rms):
        d.set(f"{name}.momentum_distribution_type", "gaussian")
        for comp, vv, th in zip(("ux", "uy", "uz"), v, rms):
            d.set(f"{name}.{comp}_m", vv * inv_c)
            d.set(f"{name}.{comp}_th", th * inv_c)
    elif any(v):
        d.set(f"{name}.momentum_distribution_type", "constant")
        for comp, vv in zip(("ux", "uy", "uz"), v):
            d.set(f"{name}.{comp}", vv * inv_c)
    else:
        d.set(f"{name}.momentum_distribution_type", "at_rest")


# ---------------------------------------------------------------- species

class Species:
    def __init__(self, particle_type=None, name=None, charge_state=None,
                 charge=None, mass=None, initial_distribution=None,
                 density_scale=None, particle_shape=None, **kw):
        self.particle_type = particle_type
        self.name = name
        self.charge = charge
        self.charge_state = charge_state
        self.mass = mass
        self.initial_distribution = initial_distribution
        self.density_scale = density_scale
        # warpx_* extras (reference picmi.py Species.init kw handling)
        self.do_not_push = kw.pop("warpx_do_not_push", None)
        self.do_not_deposit = kw.pop("warpx_do_not_deposit", None)
        self.do_not_gather = kw.pop("warpx_do_not_gather", None)
        self.random_theta = kw.pop("warpx_random_theta", None)
        self.save_particles_at = kw.pop("warpx_save_particles_at", [])
        self.do_resampling = kw.pop("warpx_do_resampling", None)
        self.resampling_trigger_intervals = kw.pop(
            "warpx_resampling_trigger_intervals", None)
        self.extra = {
            k[len("warpx_"):]: v for k, v in kw.items()
            if k.startswith("warpx_")
        }

    def _lower(self, d, layout, ndim):
        name = self.name
        d.append_name("particles.species_names", name)
        if self.particle_type:
            d.set(f"{name}.species_type", self.particle_type)
        if self.charge is not None:
            d.set(f"{name}.charge", self.charge)
        if self.mass is not None:
            d.set(f"{name}.mass", self.mass)
        if self.charge_state is not None:
            d.set(f"{name}.ionization_initial_level", int(self.charge_state))
        dist = self.initial_distribution
        if dist is None:
            d.set(f"{name}.injection_style", "none")
        elif isinstance(dist, GaussianBunchDistribution):
            n_mac = getattr(layout, "n_macroparticles", None) or 100
            q = self.charge if self.charge is not None else -_const.q_e
            dist._lower(d, name, n_macroparticles=n_mac, charge=q)
        elif isinstance(dist, UniformFluxDistribution):
            ppc = 2
            if isinstance(layout, GriddedLayout):
                ppc = layout.n_macroparticle_per_cell[0]
            elif getattr(layout, "n_macroparticles_per_cell", None):
                ppc = layout.n_macroparticles_per_cell
            dist._lower(d, name, ppc=ppc)
        elif isinstance(dist, ParticleListDistribution):
            dist._lower(d, name)
        else:
            if isinstance(layout, GriddedLayout):
                ppc = list(layout.n_macroparticle_per_cell)
                while len(ppc) < 3:
                    ppc.append(1)
                d.set(f"{name}.injection_style", "NUniformPerCell")
                d.set(f"{name}.num_particles_per_cell_each_dim", ppc)
            elif isinstance(layout, PseudoRandomLayout):
                d.set(f"{name}.injection_style", "NRandomPerCell")
                d.set(f"{name}.num_particles_per_cell",
                      layout.n_macroparticles_per_cell or 1)
            else:
                d.set(f"{name}.injection_style", "NUniformPerCell")
                d.set(f"{name}.num_particles_per_cell_each_dim",
                      [1, 1, 1])
            dist._lower(d, name)
        if self.do_not_push:
            d.set(f"{name}.do_not_push", 1)
        if self.do_not_deposit:
            d.set(f"{name}.do_not_deposit", 1)
        if self.do_not_gather:
            d.set(f"{name}.do_not_gather", 1)
        if self.random_theta is not None:
            d.set(f"{name}.random_theta", self.random_theta)
        for face in self.save_particles_at:
            d.set(f"{name}.save_particles_at_{face}", 1)
        if self.do_resampling:
            d.set(f"{name}.do_resampling", 1)
            if self.resampling_trigger_intervals is not None:
                d.set(f"{name}.resampling_trigger_intervals",
                      self.resampling_trigger_intervals)
        for k, v in self.extra.items():
            d.set(f"{name}.{k}", v)


class MultiSpecies:
    """Several species sharing one distribution/layout
    (picmi.py:444)."""

    def __init__(self, particle_types=None, names=None, charge_states=None,
                 initial_distribution=None, proportions=None):
        self.species_instances_list = [
            Species(particle_type=t, name=n, charge_state=cs,
                    initial_distribution=initial_distribution,
                    density_scale=p)
            for t, n, cs, p in zip(
                particle_types or [],
                names or [],
                charge_states or [None] * len(names or []),
                proportions or [None] * len(names or []),
            )
        ]

    def __iter__(self):
        return iter(self.species_instances_list)


# ------------------------------------------------------------------ grids

class _Grid:
    ndim = 3
    rz = False

    def __init__(self, number_of_cells=None, lower_bound=None,
                 upper_bound=None, lower_boundary_conditions=None,
                 upper_boundary_conditions=None,
                 moving_window_velocity=None,
                 lower_boundary_conditions_particles=None,
                 upper_boundary_conditions_particles=None,
                 warpx_max_grid_size=None, warpx_blocking_factor=None,
                 guard_cells=None, **kw):
        self.number_of_cells = list(number_of_cells)
        self.lower_bound = list(lower_bound)
        self.upper_bound = list(upper_bound)
        self.lower_boundary_conditions = list(lower_boundary_conditions)
        self.upper_boundary_conditions = list(upper_boundary_conditions)
        self.lower_bc_particles = lower_boundary_conditions_particles
        self.upper_bc_particles = upper_boundary_conditions_particles
        self.moving_window_velocity = moving_window_velocity
        self.max_grid_size = warpx_max_grid_size
        self.blocking_factor = warpx_blocking_factor
        self.refined_regions = []
        for lev, lo, hi, rr in kw.pop("refined_regions", []) or []:
            self.refined_regions.append((lev, lo, hi, rr))
        self.kw = kw

    @staticmethod
    def _map_bc(b):
        b = (b or "periodic").lower()
        return {"open": "pml", "dirichlet": "pec", "neumann": "none"}.get(
            b, b
        )

    def _lower(self, d):
        d.set("amr.n_cell", self.number_of_cells)
        d.set("geometry.dims", "RZ" if self.rz else self.ndim)
        d.set("geometry.prob_lo", self.lower_bound)
        d.set("geometry.prob_hi", self.upper_bound)
        d.set("boundary.field_lo",
              [self._map_bc(b) for b in self.lower_boundary_conditions])
        d.set("boundary.field_hi",
              [self._map_bc(b) for b in self.upper_boundary_conditions])
        if self.lower_bc_particles:
            d.set("boundary.particle_lo",
                  [b.lower() for b in self.lower_bc_particles])
        if self.upper_bc_particles:
            d.set("boundary.particle_hi",
                  [b.lower() for b in self.upper_bc_particles])
        if self.max_grid_size:
            d.set("amr.max_grid_size", self.max_grid_size)
        if self.moving_window_velocity is not None and any(
                self.moving_window_velocity):
            d.set("warpx.do_moving_window", 1)
            axes = _AXES3[self.ndim]
            for i, v in enumerate(self.moving_window_velocity):
                if v:
                    d.set("warpx.moving_window_dir",
                          axes[i] if not self.rz else ("r", "z")[i])
                    d.set("warpx.moving_window_v", v / _const.c)
        if self.refined_regions:
            lev, lo, hi, rr = self.refined_regions[0]
            d.set("amr.max_level", lev)
            d.set("warpx.fine_tag_lo", lo)
            d.set("warpx.fine_tag_hi", hi)
            if rr:
                d.set("amr.ref_ratio_vect", rr)
        else:
            d.set("amr.max_level", 0)


class Cartesian3DGrid(_Grid):
    ndim = 3


class Cartesian2DGrid(_Grid):
    ndim = 2


class Cartesian1DGrid(_Grid):
    ndim = 1


class CylindricalGrid(_Grid):
    """RZ multi-mode grid (picmi.py:857)."""

    ndim = 2
    rz = True

    def __init__(self, number_of_cells=None, lower_bound=None,
                 upper_bound=None, lower_boundary_conditions=None,
                 upper_boundary_conditions=None, n_azimuthal_modes=1,
                 **kw):
        super().__init__(number_of_cells, lower_bound, upper_bound,
                         lower_boundary_conditions,
                         upper_boundary_conditions, **kw)
        self.n_azimuthal_modes = n_azimuthal_modes

    def _lower(self, d):
        super()._lower(d)
        d.set("warpx.n_rz_azimuthal_modes", self.n_azimuthal_modes)


class BinomialSmoother:
    def __init__(self, n_pass=None, compensation=None, stride=None,
                 alpha=None):
        if isinstance(n_pass, (list, tuple)):
            self.n_pass = list(n_pass)
        elif n_pass is not None:
            self.n_pass = [n_pass]
        else:
            self.n_pass = [1]


# ----------------------------------------------------------------- solvers

class ExplicitEvolveScheme:
    def _lower(self, d):
        d.set("algo.evolve_scheme", "explicit")


class PicardNonlinearSolver:
    def __init__(self, verbose=None, absolute_tolerance=0.0,
                 relative_tolerance=1e-6, max_iterations=100,
                 require_convergence=True):
        self.verbose = verbose
        self.absolute_tolerance = absolute_tolerance
        self.relative_tolerance = relative_tolerance
        self.max_iterations = max_iterations
        self.require_convergence = require_convergence

    def _lower(self, d):
        d.set("implicit_evolve.nonlinear_solver", "picard")
        d.set("picard.relative_tolerance", self.relative_tolerance)
        d.set("picard.absolute_tolerance", self.absolute_tolerance)
        d.set("picard.max_iterations", self.max_iterations)
        d.set("picard.require_convergence",
              1 if self.require_convergence else 0)


class GMRESLinearSolver:
    def __init__(self, verbose_int=None, restart_length=30,
                 absolute_tolerance=0.0, relative_tolerance=1e-4,
                 max_iterations=1000):
        self.restart_length = restart_length
        self.absolute_tolerance = absolute_tolerance
        self.relative_tolerance = relative_tolerance
        self.max_iterations = max_iterations

    def _lower(self, d):
        d.set("gmres.relative_tolerance", self.relative_tolerance)
        d.set("gmres.absolute_tolerance", self.absolute_tolerance)
        d.set("gmres.max_iterations", self.max_iterations)
        d.set("gmres.restart_length", self.restart_length)


class NewtonNonlinearSolver:
    def __init__(self, verbose=None, absolute_tolerance=0.0,
                 relative_tolerance=1e-6, max_iterations=20,
                 require_convergence=True, linear_solver=None,
                 max_particle_iterations=None, particle_tolerance=None):
        self.absolute_tolerance = absolute_tolerance
        self.relative_tolerance = relative_tolerance
        self.max_iterations = max_iterations
        self.require_convergence = require_convergence
        self.linear_solver = linear_solver
        self.max_particle_iterations = max_particle_iterations
        self.particle_tolerance = particle_tolerance

    def _lower(self, d):
        d.set("implicit_evolve.nonlinear_solver", "newton")
        d.set("newton.relative_tolerance", self.relative_tolerance)
        d.set("newton.absolute_tolerance", self.absolute_tolerance)
        d.set("newton.max_iterations", self.max_iterations)
        d.set("newton.require_convergence",
              1 if self.require_convergence else 0)
        if self.max_particle_iterations is not None:
            d.set("implicit_evolve.max_particle_iterations",
                  self.max_particle_iterations)
        if self.particle_tolerance is not None:
            d.set("implicit_evolve.particle_tolerance",
                  self.particle_tolerance)
        if self.linear_solver is not None:
            self.linear_solver._lower(d)


class ThetaImplicitEMEvolveScheme:
    def __init__(self, theta=0.5, nonlinear_solver=None):
        self.theta = theta
        self.nonlinear_solver = nonlinear_solver

    def _lower(self, d):
        d.set("algo.evolve_scheme", "theta_implicit_em")
        d.set("implicit_evolve.theta", self.theta)
        if self.nonlinear_solver is not None:
            self.nonlinear_solver._lower(d)


class SemiImplicitEMEvolveScheme:
    def __init__(self, nonlinear_solver=None):
        self.nonlinear_solver = nonlinear_solver

    def _lower(self, d):
        d.set("algo.evolve_scheme", "semi_implicit_em")
        if self.nonlinear_solver is not None:
            self.nonlinear_solver._lower(d)


class ElectromagneticSolver:
    def __init__(self, grid, method="Yee", cfl=None, source_smoother=None,
                 field_smoother=None, l_nodal=None, stencil_order=None,
                 galilean_velocity=None, divE_cleaning=None,
                 divB_cleaning=None, pml_divE_cleaning=None,
                 pml_divB_cleaning=None, warpx_periodic_single_box_fft=None,
                 warpx_current_correction=None, warpx_psatd_update_with_rho=None,
                 warpx_psatd_do_time_averaging=None, warpx_do_pml_in_domain=None,
                 warpx_pml_ncell=None, warpx_grid_type=None,
                 warpx_evolve_scheme=None, **kw):
        self.grid = grid
        self.method = (method or "Yee").lower()
        self.cfl = cfl
        self.source_smoother = source_smoother
        self.stencil_order = stencil_order
        self.galilean_velocity = galilean_velocity
        self.divE_cleaning = divE_cleaning
        self.divB_cleaning = divB_cleaning
        self.psatd_single_box = warpx_periodic_single_box_fft
        self.current_correction = warpx_current_correction
        self.update_with_rho = warpx_psatd_update_with_rho
        self.time_averaging = warpx_psatd_do_time_averaging
        self.pml_ncell = warpx_pml_ncell
        self.grid_type = warpx_grid_type or (
            "collocated" if l_nodal else None
        )
        self.evolve_scheme = warpx_evolve_scheme
        self.kw = kw

    def _lower(self, d):
        self.grid._lower(d)
        d.set("algo.maxwell_solver", self.method)
        d.set("warpx.cfl", self.cfl if self.cfl is not None else 0.999)
        if self.grid_type:
            d.set("warpx.grid_type", self.grid_type)
        if self.divE_cleaning is not None:
            d.set("warpx.do_dive_cleaning", self.divE_cleaning)
        if self.divB_cleaning is not None:
            d.set("warpx.do_divb_cleaning", self.divB_cleaning)
        if self.pml_ncell is not None:
            d.set("warpx.pml_ncell", self.pml_ncell)
        if self.method == "psatd":
            if self.stencil_order is not None:
                d.set("psatd.nox", self.stencil_order[0])
                if len(self.stencil_order) > 2:
                    d.set("psatd.noy", self.stencil_order[1])
                d.set("psatd.noz", self.stencil_order[-1])
            if self.psatd_single_box is not None:
                d.set("psatd.periodic_single_box_fft",
                      self.psatd_single_box)
            if self.current_correction is not None:
                d.set("psatd.current_correction", self.current_correction)
            if self.update_with_rho is not None:
                d.set("psatd.update_with_rho", self.update_with_rho)
            if self.time_averaging is not None:
                d.set("psatd.do_time_averaging", self.time_averaging)
            if self.galilean_velocity is not None:
                v = [x / _const.c for x in self.galilean_velocity]
                d.set("psatd.v_galilean",
                      v if len(v) == 3 else [0.0, 0.0, v[-1]])
        if self.source_smoother is not None:
            d.set("warpx.use_filter", 1)
            np_ = self.source_smoother.n_pass
            d.set("warpx.filter_npass_each_dir",
                  np_ * self.grid.ndim if len(np_) == 1 else np_)
        if self.evolve_scheme is not None:
            self.evolve_scheme._lower(d)


class ElectrostaticSolver:
    def __init__(self, grid, method="Multigrid", required_precision=None,
                 warpx_relativistic=None, warpx_poisson_solver=None, **kw):
        self.grid = grid
        self.method = method
        self.relativistic = warpx_relativistic
        self.poisson_solver = warpx_poisson_solver
        self.required_precision = required_precision
        self.cfl = None
        self.kw = kw

    def _lower(self, d):
        self.grid._lower(d)
        d.set("warpx.do_electrostatic",
              "relativistic" if self.relativistic else "labframe")
        if self.poisson_solver:
            d.set("algo.poisson_solver", self.poisson_solver)
        if "warpx_const_dt" in self.kw:
            d.set("warpx.const_dt", self.kw["warpx_const_dt"])


class HybridPICSolver:
    """Ohm's-law hybrid-PIC solver (picmi.py:1755)."""

    def __init__(self, grid, Te=None, n0=None, gamma=5.0 / 3.0,
                 n_floor=None, plasma_resistivity=None,
                 plasma_hyper_resistivity=None, substeps=None,
                 Jx_external_function=None, Jy_external_function=None,
                 Jz_external_function=None, **kw):
        self.grid = grid
        self.Te = Te
        self.n0 = n0
        self.gamma = gamma
        self.n_floor = n_floor
        self.plasma_resistivity = plasma_resistivity
        self.plasma_hyper_resistivity = plasma_hyper_resistivity
        self.substeps = substeps
        self.j_ext = (Jx_external_function, Jy_external_function,
                      Jz_external_function)
        self.cfl = None
        self.kw = kw

    def _lower(self, d):
        self.grid._lower(d)
        d.set("algo.maxwell_solver", "hybrid")
        p = "hybrid_pic_model"
        d.set(f"{p}.elec_temp", self.Te)
        d.set(f"{p}.n0_ref", self.n0)
        d.set(f"{p}.gamma", self.gamma)
        if self.n_floor is not None:
            d.set(f"{p}.n_floor", self.n_floor)
        if self.plasma_resistivity is not None:
            if isinstance(self.plasma_resistivity, str):
                d.set(f"{p}.plasma_resistivity(rho,J)",
                      self.plasma_resistivity)
            else:
                d.set(f"{p}.plasma_resistivity", self.plasma_resistivity)
        if self.plasma_hyper_resistivity is not None:
            d.set(f"{p}.plasma_hyper_resistivity",
                  self.plasma_hyper_resistivity)
        if self.substeps is not None:
            d.set(f"{p}.substeps", self.substeps)
        for ax, e in zip("xyz", self.j_ext):
            if e is not None:
                d.set(f"{p}.J{ax}_external_grid_function(x,y,z,t)", e)
        if "warpx_const_dt" in self.kw:
            d.set("warpx.const_dt", self.kw["warpx_const_dt"])


# ------------------------------------------------------------------ lasers

class GaussianLaser:
    def __init__(self, wavelength, waist, duration, focal_position=None,
                 centroid_position=None, propagation_direction=None,
                 polarization_direction=None, E0=None, a0=None,
                 phi0=None, phi2=None, beta=None, zeta=None,
                 fill_in=True, name=None):
        self.wavelength = wavelength
        self.waist = waist
        self.duration = duration
        self.focal_position = list(focal_position or [0.0, 0.0, 0.0])
        self.centroid_position = list(centroid_position or [0.0, 0.0, 0.0])
        self.propagation_direction = list(
            propagation_direction or [0.0, 0.0, 1.0])
        self.polarization_direction = list(
            polarization_direction or [1.0, 0.0, 0.0])
        if E0 is None and a0 is not None:
            E0 = (a0 * 2 * math.pi * _const.m_e * _const.c**2
                  / (_const.q_e * wavelength))
        self.E0 = E0
        self.phi0 = phi0
        self.phi2 = phi2
        self.beta = beta
        self.zeta = zeta
        self.name = name or "laser"

    def _lower(self, d, position):
        nm = self.name
        d.append_name("lasers.names", nm)
        d.set(f"{nm}.profile", "Gaussian")
        d.set(f"{nm}.position", position)
        d.set(f"{nm}.direction", self.propagation_direction)
        d.set(f"{nm}.polarization", self.polarization_direction)
        d.set(f"{nm}.e_max", self.E0)
        d.set(f"{nm}.wavelength", self.wavelength)
        d.set(f"{nm}.profile_waist", self.waist)
        d.set(f"{nm}.profile_duration", self.duration)
        # t_peak from the centroid's distance to the antenna plane
        dist = sum(
            (c - p) * dirn for c, p, dirn in zip(
                self.centroid_position, position,
                self.propagation_direction)
        )
        d.set(f"{nm}.profile_t_peak", -dist / _const.c)
        foc = sum(
            (f - p) * dirn for f, p, dirn in zip(
                self.focal_position, position, self.propagation_direction)
        )
        d.set(f"{nm}.profile_focal_distance", foc)
        if self.phi2 is not None:
            d.set(f"{nm}.phi2", self.phi2)
        if self.beta is not None:
            d.set(f"{nm}.beta", self.beta)
        if self.zeta is not None:
            d.set(f"{nm}.zeta", self.zeta)
        if self.phi0 is not None:
            d.set(f"{nm}.phi0", self.phi0)


class AnalyticLaser:
    def __init__(self, field_expression=None, wavelength=None,
                 propagation_direction=None, polarization_direction=None,
                 name=None, **user_vars):
        self.field_expression = field_expression
        self.wavelength = wavelength
        self.propagation_direction = list(
            propagation_direction or [0.0, 0.0, 1.0])
        self.polarization_direction = list(
            polarization_direction or [1.0, 0.0, 0.0])
        self.name = name or "laser"
        self.user_vars = dict(user_vars)

    def _lower(self, d, position):
        nm = self.name
        d.append_name("lasers.names", nm)
        d.set(f"{nm}.profile", "parse_field_function")
        d.set(f"{nm}.position", position)
        d.set(f"{nm}.direction", self.propagation_direction)
        d.set(f"{nm}.polarization", self.polarization_direction)
        d.set(f"{nm}.wavelength", self.wavelength)
        d.set(f"{nm}.field_function(X,Y,t)", self.field_expression)
        for k, v in self.user_vars.items():
            d.set(f"my_constants.{k}", v)


class LaserAntenna:
    def __init__(self, position, normal_vector=None):
        self.position = list(position)
        self.normal_vector = normal_vector


# ----------------------------------------------------- applied/initial field

class ConstantAppliedField:
    def __init__(self, Ex=None, Ey=None, Ez=None, Bx=None, By=None, Bz=None,
                 lower_bound=None, upper_bound=None):
        self.E = [Ex or 0.0, Ey or 0.0, Ez or 0.0]
        self.B = [Bx or 0.0, By or 0.0, Bz or 0.0]

    def _lower(self, d):
        if any(self.E):
            d.set("particles.E_ext_particle_init_style", "constant")
            d.set("particles.E_external_particle", self.E)
        if any(self.B):
            d.set("particles.B_ext_particle_init_style", "constant")
            d.set("particles.B_external_particle", self.B)


class AnalyticAppliedField:
    def __init__(self, Ex_expression=None, Ey_expression=None,
                 Ez_expression=None, Bx_expression=None, By_expression=None,
                 Bz_expression=None, **user_vars):
        self.E_expr = [Ex_expression, Ey_expression, Ez_expression]
        self.B_expr = [Bx_expression, By_expression, Bz_expression]
        self.user_vars = dict(user_vars)

    def _lower(self, d):
        raise NotImplementedError(
            "AnalyticAppliedField (parse_E_ext_particle_function) is not "
            "implemented; use AnalyticInitialField or ConstantAppliedField"
        )


class AnalyticInitialField:
    def __init__(self, Ex_expression=None, Ey_expression=None,
                 Ez_expression=None, Bx_expression=None, By_expression=None,
                 Bz_expression=None, **user_vars):
        self.E_expr = [Ex_expression, Ey_expression, Ez_expression]
        self.B_expr = [Bx_expression, By_expression, Bz_expression]
        self.user_vars = dict(user_vars)

    def _lower(self, d):
        for k, v in self.user_vars.items():
            d.set(f"my_constants.{k}", v)
        if any(e is not None for e in self.E_expr):
            d.set("warpx.E_ext_grid_init_style", "parse_E_ext_grid_function")
            for ax, e in zip("xyz", self.E_expr):
                d.set(f"warpx.E{ax}_external_grid_function(x,y,z)", e or "0")
        if any(e is not None for e in self.B_expr):
            d.set("warpx.B_ext_grid_init_style", "parse_B_ext_grid_function")
            for ax, e in zip("xyz", self.B_expr):
                d.set(f"warpx.B{ax}_external_grid_function(x,y,z)", e or "0")


class LoadInitialField:
    """Initial grid fields from an openPMD file (picmi.py:2026)."""

    def __init__(self, read_fields_from_path, load_E=True, load_B=True):
        self.path = read_fields_from_path
        self.load_E = load_E
        self.load_B = load_B

    def _lower(self, d):
        d.set("warpx.read_fields_from_path", self.path)
        if self.load_E:
            d.set("warpx.E_ext_grid_init_style", "read_from_file")
        if self.load_B:
            d.set("warpx.B_ext_grid_init_style", "read_from_file")


class LoadAppliedField:
    def __init__(self, read_fields_from_path, load_E=True, load_B=True):
        self.path = read_fields_from_path

    def _lower(self, d):
        raise NotImplementedError(
            "LoadAppliedField (particle fields gathered from file grids) "
            "is not implemented; use LoadInitialField"
        )


class Mirror:
    def __init__(self, x_front_location=None, y_front_location=None,
                 z_front_location=None, depth=None, number_of_cells=None):
        self.z_front_location = z_front_location
        self.depth = depth
        self.number_of_cells = number_of_cells

    def _lower(self, d):
        raise NotImplementedError(
            "Mirror (warpx.num_mirrors field zeroing) is not implemented"
        )


class PlasmaLens:
    """Repeated plasma-lens applied field (picmi.py:2533)."""

    def __init__(self, period, starts, lengths, strengths_E=None,
                 strengths_B=None):
        self.period = period
        self.starts = starts
        self.lengths = lengths
        self.strengths_E = strengths_E
        self.strengths_B = strengths_B

    def _lower(self, d):
        raise NotImplementedError(
            "PlasmaLens (particles.repeated_plasma_lens) is not "
            "implemented; use a lattice plasmalens element deck"
        )


# ---------------------------------------------- collisions & elem processes

class FieldIonization:
    def __init__(self, model, ionized_species, product_species):
        self.model = model
        self.ionized_species = ionized_species
        self.product_species = product_species

    def _lower(self, d):
        sp = getattr(self.ionized_species, "name", self.ionized_species)
        prod = getattr(self.product_species, "name", self.product_species)
        d.set(f"{sp}.do_field_ionization", 1)
        d.set(f"{sp}.ionization_product_species", prod)


class CoulombCollisions:
    def __init__(self, name, species, CoulombLog=None, ndt=None):
        self.name = name
        self.species = species
        self.CoulombLog = CoulombLog
        self.ndt = ndt

    def _lower(self, d):
        d.append_name("collisions.collision_names", self.name)
        d.set(f"{self.name}.type", "pairwisecoulomb")
        d.set(f"{self.name}.species",
              [getattr(s, "name", s) for s in self.species])
        if self.CoulombLog is not None:
            d.set(f"{self.name}.CoulombLog", self.CoulombLog)
        if self.ndt is not None:
            d.set(f"{self.name}.ndt", self.ndt)


class MCCCollisions:
    """Background Monte-Carlo collisions (picmi.py:2289)."""

    def __init__(self, name, species, background_density,
                 background_temperature, scattering_processes,
                 background_mass=None, max_background_density=None,
                 ndt=None):
        self.name = name
        self.species = species
        self.background_density = background_density
        self.background_temperature = background_temperature
        self.scattering_processes = scattering_processes
        self.background_mass = background_mass
        self.ndt = ndt

    def _lower(self, d):
        nm = self.name
        d.append_name("collisions.collision_names", nm)
        d.set(f"{nm}.type", "background_mcc")
        d.set(f"{nm}.species", getattr(self.species, "name", self.species))
        if isinstance(self.background_density, str):
            d.set(f"{nm}.background_density(x,y,z,t)",
                  self.background_density)
        else:
            d.set(f"{nm}.background_density", self.background_density)
        if isinstance(self.background_temperature, str):
            d.set(f"{nm}.background_temperature(x,y,z,t)",
                  self.background_temperature)
        else:
            d.set(f"{nm}.background_temperature",
                  self.background_temperature)
        if self.background_mass is not None:
            d.set(f"{nm}.background_mass", self.background_mass)
        if self.ndt is not None:
            d.set(f"{nm}.ndt", self.ndt)
        procs = []
        for proc, info in self.scattering_processes.items():
            procs.append(proc)
            for key, val in (info or {}).items():
                d.set(f"{nm}.{proc}_{key}", val)
        d.set(f"{nm}.scattering_processes", procs)


class DSMCCollisions:
    def __init__(self, name, species, scattering_processes, ndt=None):
        self.name = name
        self.species = species
        self.scattering_processes = scattering_processes
        self.ndt = ndt

    def _lower(self, d):
        nm = self.name
        d.append_name("collisions.collision_names", nm)
        d.set(f"{nm}.type", "dsmc")
        d.set(f"{nm}.species",
              [getattr(s, "name", s) for s in self.species])
        if self.ndt is not None:
            d.set(f"{nm}.ndt", self.ndt)
        procs = []
        for proc, info in self.scattering_processes.items():
            procs.append(proc)
            for key, val in (info or {}).items():
                d.set(f"{nm}.{proc}_{key}", val)
        d.set(f"{nm}.scattering_processes", procs)


class EmbeddedBoundary:
    """Implicit-function or analytic EB geometry (picmi.py:2418)."""

    def __init__(self, implicit_function=None, stl_file=None,
                 potential=None, cover_multiple_cuts=None, **kw):
        if stl_file is not None:
            raise NotImplementedError("STL embedded boundaries")
        self.implicit_function = implicit_function
        self.potential = potential
        self.user_vars = {
            k: v for k, v in kw.items() if not k.startswith("warpx_")
        }

    def _lower(self, d):
        if self.implicit_function is not None:
            d.set("warpx.eb_implicit_function",
                  f'"{self.implicit_function}"')
        if self.potential is not None:
            d.set("warpx.eb_potential(x,y,z,t)", self.potential)
        for k, v in self.user_vars.items():
            d.set(f"my_constants.{k}", v)


# ------------------------------------------------------------- diagnostics

class _Diag:
    counter = [0]

    def __init__(self, name=None):
        if name is None:
            _Diag.counter[0] += 1
            name = f"diag{_Diag.counter[0]}"
        self.name = name


class FieldDiagnostic(_Diag):
    def __init__(self, grid=None, period=None, data_list=None,
                 write_dir=None, warpx_format=None, name=None, **kw):
        super().__init__(name)
        self.period = period
        self.data_list = data_list
        self.write_dir = write_dir
        self.format = warpx_format

    def _lower(self, d):
        nm = self.name
        d.append_name("diagnostics.diags_names", nm)
        d.set(f"{nm}.diag_type", "Full")
        d.set(f"{nm}.intervals", self.period or 0)
        if self.format:
            d.set(f"{nm}.format", self.format)
        if self.data_list:
            fields = sorted({
                f for f in (
                    _FIELD_MAP.get(x, x) for x in self.data_list
                ) if f
            })
            d.set(f"{nm}.fields_to_plot", fields)


_FIELD_MAP = {
    "E": "Ex", "B": "Bx", "J": "jx",
    "Ex": "Ex", "Ey": "Ey", "Ez": "Ez",
    "Bx": "Bx", "By": "By", "Bz": "Bz",
    "Jx": "jx", "Jy": "jy", "Jz": "jz",
    "rho": "rho", "phi": "phi", "F": "F", "G": "G",
    "divE": "divE", "divB": "divB", "part_per_cell": "part_per_cell",
}


class TimeAveragedFieldDiagnostic(FieldDiagnostic):
    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "TimeAveragedFieldDiagnostic is not implemented"
        )


class ParticleDiagnostic(_Diag):
    def __init__(self, period=None, species=None, data_list=None,
                 write_dir=None, warpx_format=None, name=None, **kw):
        super().__init__(name)
        self.period = period
        self.species = species or []
        self.format = warpx_format

    def _lower(self, d):
        nm = self.name
        d.append_name("diagnostics.diags_names", nm)
        d.set(f"{nm}.diag_type", "Full")
        d.set(f"{nm}.intervals", self.period or 0)
        if self.format:
            d.set(f"{nm}.format", self.format)
        if self.species:
            d.set(f"{nm}.species",
                  [getattr(s, "name", s) for s in self.species])


class Checkpoint(_Diag):
    def __init__(self, period=None, write_dir=None, name=None, **kw):
        super().__init__(name)
        self.period = period

    def _lower(self, d):
        nm = self.name
        d.append_name("diagnostics.diags_names", nm)
        d.set(f"{nm}.diag_type", "Full")
        d.set(f"{nm}.format", "checkpoint")
        d.set(f"{nm}.intervals", self.period or 0)


class ReducedDiagnostic(_Diag):
    def __init__(self, diag_type=None, period=None, name=None, species=None,
                 bin_number=None, bin_min=None, bin_max=None,
                 histogram_function=None, reduction_type=None,
                 reduced_function=None, probe_geometry=None, x_probe=None,
                 y_probe=None, z_probe=None, **kw):
        super().__init__(name)
        self.diag_type = diag_type
        self.period = period
        self.species = species
        self.extra = dict(kw)
        for k, v in (("bin_number", bin_number), ("bin_min", bin_min),
                     ("bin_max", bin_max),
                     ("histogram_function(t,x,y,z,ux,uy,uz,w)",
                      histogram_function),
                     ("reduction_type", reduction_type),
                     ("reduced_function(x,y,z,Ex,Ey,Ez,Bx,By,Bz,jx,jy,jz)",
                      reduced_function),
                     ("probe_geometry", probe_geometry),
                     ("x_probe", x_probe), ("y_probe", y_probe),
                     ("z_probe", z_probe)):
            if v is not None:
                self.extra[k] = v

    def _lower(self, d):
        nm = self.name
        d.append_name("warpx.reduced_diags_names", nm)
        d.set(f"{nm}.type", self.diag_type)
        d.set(f"{nm}.intervals", self.period or 1)
        if self.species is not None:
            d.set(f"{nm}.species", getattr(self.species, "name",
                                           self.species))
        for k, v in self.extra.items():
            d.set(f"{nm}.{k}", v)


class LabFrameFieldDiagnostic(_Diag):
    """Back-transformed field diagnostic (picmi.py:3566)."""

    def __init__(self, grid=None, num_snapshots=None, dt_snapshots=None,
                 dz_snapshots=None, data_list=None, warpx_format=None,
                 name=None, **kw):
        super().__init__(name)
        self.num_snapshots = num_snapshots
        self.dt_snapshots = dt_snapshots
        self.dz_snapshots = dz_snapshots
        self.data_list = data_list

    def _lower(self, d):
        nm = self.name
        d.append_name("diagnostics.diags_names", nm)
        d.set(f"{nm}.diag_type", "BackTransformed")
        d.set(f"{nm}.num_snapshots_lab", self.num_snapshots)
        if self.dt_snapshots is not None:
            d.set(f"{nm}.dt_snapshots_lab", self.dt_snapshots)
        if self.dz_snapshots is not None:
            d.set(f"{nm}.dz_snapshots_lab", self.dz_snapshots)
        if self.data_list:
            fields = sorted({
                f for f in (
                    _FIELD_MAP.get(x, x) for x in self.data_list
                ) if f
            })
            d.set(f"{nm}.fields_to_plot", fields)


class LabFrameParticleDiagnostic(LabFrameFieldDiagnostic):
    def __init__(self, *a, species=None, **kw):
        super().__init__(*a, **kw)
        self.species = species


class ParticleBoundaryScrapingDiagnostic(_Diag):
    def __init__(self, period=None, species=None, name=None, **kw):
        super().__init__(name)
        self.period = period
        self.species = species or []

    def _lower(self, d):
        nm = self.name
        d.append_name("diagnostics.diags_names", nm)
        d.set(f"{nm}.diag_type", "BoundaryScraping")
        d.set(f"{nm}.intervals", self.period or 0)
        if self.species:
            d.set(f"{nm}.species",
                  [getattr(s, "name", s) for s in self.species])


# -------------------------------------------------------------- simulation

class Simulation:
    """PICMI Simulation: collects components, lowers them to a deck, runs
    the core Simulation on it (picmi.py:2593 Simulation; step :2989)."""

    def __init__(self, solver=None, max_steps=None, max_time=None,
                 verbose=None, particle_shape="linear", gamma_boost=None,
                 time_step_size=None,
                 warpx_current_deposition_algo=None,
                 warpx_particle_pusher_algo=None,
                 warpx_field_gathering_algo=None,
                 warpx_use_filter=None, warpx_serialize_initial_conditions=None,
                 warpx_do_dynamic_scheduling=None, warpx_load_balance_intervals=None,
                 warpx_random_seed=None, warpx_embedded_boundary=None,
                 warpx_sort_intervals=None, *, device=None, dtype=None,
                 **kw):
        self.solver = solver
        self.device = device
        self.dtype = dtype
        self.max_steps = max_steps
        self.max_time = max_time
        self.verbose = verbose
        self.gamma_boost = gamma_boost
        self.time_step_size = time_step_size
        shape_map = {"linear": 1, "quadratic": 2, "cubic": 3, "quartic": 4,
                     "NGP": 0, 1: 1, 2: 2, 3: 3, 4: 4}
        self.particle_shape = shape_map.get(particle_shape, 1)
        self.current_deposition = warpx_current_deposition_algo
        self.particle_pusher = warpx_particle_pusher_algo
        self.field_gathering = warpx_field_gathering_algo
        self.use_filter = warpx_use_filter
        self.load_balance_intervals = warpx_load_balance_intervals
        self.sort_intervals = warpx_sort_intervals
        self.embedded_boundary = warpx_embedded_boundary
        self.species: List = []
        self.layouts: List = []
        self.lasers: List = []
        self.laser_injections: List = []
        self.diagnostics: List = []
        self.applied_fields = list(kw.pop("applied_fields", []) or [])
        self.collisions = list(kw.pop("collisions", []) or [])
        self.interactions: List = []
        self._sim = None
        self.extra_keys = {
            k[len("warpx_"):].replace("_", "."): v
            for k, v in kw.items() if k.startswith("warpx_")
        }

    # ----------------------------------------------------------- components
    def add_species(self, species, layout=None, initialize_self_field=False):
        if isinstance(species, MultiSpecies):
            for sp in species:
                self.species.append(sp)
                self.layouts.append(layout)
        else:
            self.species.append(species)
            self.layouts.append(layout)

    def add_laser(self, laser, injection_method=None):
        self.lasers.append(laser)
        self.laser_injections.append(injection_method)

    def add_applied_field(self, field):
        self.applied_fields.append(field)

    def add_diagnostic(self, diag):
        self.diagnostics.append(diag)

    def add_interaction(self, interaction):
        self.interactions.append(interaction)

    # ----------------------------------------------------------------- deck
    def _build_deck_text(self) -> str:
        d = _Deck()
        d.set("max_step", self.max_steps if self.max_steps is not None else 0)
        if self.max_time is not None:
            d.set("stop_time", self.max_time)
        if self.verbose is not None:
            d.set("warpx.verbose", self.verbose)
        d.set("algo.particle_shape", self.particle_shape)
        if self.gamma_boost:
            d.set("warpx.gamma_boost", self.gamma_boost)
            d.set("warpx.boost_direction", "z")
        if self.time_step_size is not None:
            d.set("warpx.const_dt", self.time_step_size)
        self.solver._lower(d)
        if self.current_deposition:
            d.set("algo.current_deposition", self.current_deposition)
        if self.particle_pusher:
            d.set("algo.particle_pusher", self.particle_pusher)
        if self.field_gathering:
            d.set("algo.field_gathering", self.field_gathering)
        if self.use_filter is not None:
            d.set("warpx.use_filter", self.use_filter)
        if self.sort_intervals is not None:
            d.set("warpx.sort_intervals", self.sort_intervals)
        ndim = self.solver.grid.ndim
        for sp, layout in zip(self.species, self.layouts):
            sp._lower(d, layout, ndim)
        for laser, inj in zip(self.lasers, self.laser_injections):
            pos = (inj.position if isinstance(inj, LaserAntenna)
                   else laser.centroid_position)
            laser._lower(d, pos)
        for af in self.applied_fields:
            af._lower(d)
        if self.embedded_boundary is not None:
            self.embedded_boundary._lower(d)
        for c in self.collisions:
            c._lower(d)
        for it in self.interactions:
            it._lower(d)
        for diag in self.diagnostics:
            diag._lower(d)
        for k, v in self.extra_keys.items():
            d.set(k, v)
        return d.text()

    def _ensure_sim(self):
        if self._sim is None:
            from ..core.simulation import Simulation as CoreSim
            from ..utils.parser import Deck

            kw = {} if self.dtype is None else {"dtype": self.dtype}
            self._sim = CoreSim.from_deck(
                Deck.from_string(self._build_deck_text()),
                device=self.device, **kw)
            self._sim.init()
        return self._sim

    def initialize_warpx(self):
        self._ensure_sim()

    def step(self, nsteps: int = -1):
        sim = self._ensure_sim()
        sim.evolve(nsteps)

    def write_input_file(self, file_name="inputs"):
        """Emit the generated ParmParse deck (picmi.py:2983)."""
        with open(file_name, "w") as fh:
            fh.write(self._build_deck_text())

    @property
    def extension(self):
        return self._ensure_sim()
