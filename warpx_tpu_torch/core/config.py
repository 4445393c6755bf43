"""Resolved static simulation configuration.

A copy of ``warpx_tpu.core.config``'s ``LaserConfig``, ``SpeciesConfig``
and ``SimConfig``, cut to the fields the ported paths read (2D XZ and 3D
explicit EM with the Yee, CKC or PSATD solver, periodic and bounded with
PML/PEC (FDTD) or PML/damped (PSATD) faces, moving window, Gaussian and lasy
laser antennas, continuous injection, Gaussian beams, single, multiple and
openPMD-file particles, NFluxPerCell plane injection, constant and parsed
profiles, thermal (Maxwell-Boltzmann, Maxwell-Juttner), uniform and parsed
Gaussian momenta, initial external grid fields, shape orders 1-4,
divergence cleaning, the Lorentz-boosted frame, field ionization, QED
(quantum synchrotron, Breit-Wheeler, Schwinger) with photon species,
classical radiation reaction, resampling, binary collisions (pairwise
Coulomb, nuclear fusion, DSMC, background MCC and stopping), the
electrostatic solvers, the Ohm's-law hybrid solver, the macroscopic medium,
the Godfrey NCI corrector, the theta- and semi-implicit schemes with the
Picard and Newton-GMRES solvers, cold fluid species, embedded
boundaries with the ECT solver, absorbing Silver-Mueller and "none" FDTD
faces, thermal walls and boundary-scraping buffers, collocated and hybrid
grids with momentum-conserving gathering, hybrid QED, rigid injection, the
accelerator lattice and the do_not_* species; per-particle and tile-binned
steps).  Fields keep the reference's names and defaults,
so a configuration built for ``warpx_tpu`` with these fields builds here
with the same keyword arguments.  Features whose fields are absent come
with later items of ROADMAP.md's Queue A.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .grid import Geometry

__all__ = ["LaserConfig", "SpeciesConfig", "MCCProcessConfig",
           "CollisionConfig", "SimConfig"]


@dataclasses.dataclass(frozen=True)
class LaserConfig:
    """One laser antenna (reference: Source/Laser/LaserProfiles.H and
    Source/Particles/LaserParticleContainer.H)."""

    name: str
    profile: str = "gaussian"
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    direction: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    polarization: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    e_max: float = 0.0
    wavelength: float = 1e-6
    profile_waist: float = 1e-6
    profile_duration: float = 1e-15
    profile_t_peak: float = 0.0
    profile_focal_distance: float = 0.0
    phi0: float = 0.0
    zeta: float = 0.0
    beta: float = 0.0
    phi2: float = 0.0
    theta_stc: float = 0.0
    do_continuous_injection: bool = False
    # lab-frame plane coordinate along the normal (boosted runs)
    z0_lab: float = 0.0
    # profile = from_file (lasy): LaserProfileFromFile.cpp
    lasy_file_name: str = ""
    delay: float = 0.0


@dataclasses.dataclass(frozen=True)
class SpeciesConfig:
    name: str
    charge: float
    mass: float
    # nuniformpercell | nrandompercell | singleparticle | multipleparticles
    # | external_file | nfluxpercell | gaussian_beam | laser | none
    injection_style: str = "none"
    num_particles_per_cell_each_dim: Tuple[int, ...] = ()
    num_particles_per_cell: int = 0
    profile: str = "constant"  # constant | parse_density_function
    density: float = 0.0
    # parse_density_function: n(x, y, z) in m^-3 (utils/expression.py)
    density_expr: Optional[str] = None
    # at_rest | constant | gaussian | maxwell_boltzmann | maxwell_juttner |
    # uniform | parse_momentum_function | gaussian_parse_momentum_function
    momentum_distribution: str = "at_rest"
    # parse_momentum_function: (ux, uy, uz)(x, y, z) in units of c; the
    # means of gaussian_parse_momentum_function
    momentum_exprs: Optional[Tuple[str, str, str]] = None
    # gaussian_parse_momentum_function: the spreads (x, y, z)
    momentum_th_exprs: Optional[Tuple[str, str, str]] = None
    # maxwell_boltzmann / maxwell_juttner (theta = kT/mc^2, the drift
    # beta_bulk along bulk_vel_dir, "-z" for negative)
    theta: float = 0.0
    beta_bulk: float = 0.0
    bulk_vel_dir: str = "x"
    # parsed theta(x, y, z) and beta(x, y, z) (<sp>.theta_distribution_type
    # = parser, beta_distribution_type = parser)
    theta_expr: Optional[str] = None
    beta_expr: Optional[str] = None
    # uniform: the cuboid [u_min, u_max] in u-space (units of c)
    u_min: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    u_max: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # singleparticle: position (m), u (units of c) and weight
    single_particle_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    single_particle_u: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    single_particle_weight: float = 0.0
    # multipleparticles: the columns (x, y, z, ux, uy, uz, w)
    multiple_particles: Tuple[Tuple[float, ...], ...] = ()
    # external_file: the openPMD file of one species and the shift of its z
    injection_file: Optional[str] = None
    z_shift: float = 0.0
    # nfluxpercell (PlasmaInjector flux keys; AddPlasmaFlux): the plane's
    # position along its normal axis, the emission direction (+1, -1), the
    # flux (m^-2 s^-1) or its expression f(x, y, z, t), and the times
    # between which it emits (-1: no limit)
    surface_flux_pos: float = 0.0
    flux_normal_axis: str = "z"
    flux_direction: int = 1
    flux: float = 0.0
    flux_expr: str = ""
    flux_tmin: float = -1.0
    flux_tmax: float = -1.0
    # constant momentum (units of gamma*beta, multiplied by c at injection)
    ux: float = 0.0
    uy: float = 0.0
    uz: float = 0.0
    # gaussian momentum spread
    ux_th: float = 0.0
    uy_th: float = 0.0
    uz_th: float = 0.0
    # injection bounds (SI) on the active axes; () when unbounded
    bounds_lo: Tuple[float, ...] = ()
    bounds_hi: Tuple[float, ...] = ()
    do_not_push: bool = False
    do_not_gather: bool = False
    do_not_deposit: bool = False
    pusher: str = "boris"  # boris | vay | higuera | boris_rr
    do_continuous_injection: bool = False
    # boundary scraping: the faces whose absorbed particles are recorded
    # (<species>.save_particles_at_xlo/... and _eb ->
    # ParticleBoundaryBuffer), named "xlo", "zhi", "eb"
    save_particles_at: Tuple[str, ...] = ()
    # rigid injection (RigidInjectedParticleContainer): the species
    # advances at its mean vz until it crosses the (boosted-frame) plane
    zinject_plane: Optional[float] = None
    rigid_advance: bool = True
    # flip u_z after the boost transform of a Gaussian beam that propagates
    # backward in a boosted frame (PhysicalParticleContainer.cpp:487-489)
    do_backward_propagation: bool = False
    # thermal particle boundary's re-emission spread (boundary.<sp>.u_th,
    # units of c)
    boundary_u_th: float = 0.0
    # QED processes (reference: <species>.do_qed_quantum_sync /
    # do_qed_breit_wheeler and product-species keys)
    do_qed_quantum_sync: bool = False
    qed_product: str = ""  # quantum_sync_phot_product_species
    do_qed_breit_wheeler: bool = False
    qed_bw_ele_product: str = ""
    qed_bw_pos_product: str = ""
    # gaussian beam injection
    x_rms: float = 0.0
    y_rms: float = 0.0
    z_rms: float = 0.0
    x_m: float = 0.0
    y_m: float = 0.0
    z_m: float = 0.0
    npart: int = 0
    q_tot: float = 0.0
    z_cut: float = float("inf")
    # runtime attributes (<species>.addRealAttributes /
    # addIntegerAttributes): (name, expression of (x, y, z, ux, uy, uz, t),
    # is_integer), evaluated where a particle is injected
    attributes: Tuple[Tuple[str, str, bool], ...] = ()
    species_type: str = ""
    # the deck's my_constants, which the parsed profiles may name
    user_constants: Tuple[Tuple[str, float], ...] = ()
    # resampling (reference: Resampling.cpp / ResamplingTrigger.cpp)
    do_resampling: bool = False
    resampling_algorithm: str = "leveling_thinning"
    resampling_trigger_intervals: Tuple[str, ...] = ("0",)
    resampling_trigger_max_avg_ppc: float = float("inf")
    resampling_target_ratio: float = 1.5
    resampling_min_ppc: int = 1
    resampling_velocity_grid_type: str = "spherical"
    resampling_delta_ur: float = 0.0
    resampling_n_theta: int = 1
    resampling_n_phi: int = 1
    resampling_delta_u: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # extra particle capacity headroom factor for continuous injection
    capacity_factor: float = 1.0
    # ADK field ionization (reference: PhysicalParticleContainer ionization)
    do_field_ionization: bool = False
    physical_element: str = ""
    ionization_initial_level: int = 0
    ionization_product_species: str = ""
    # RZ: a random azimuth offset per cell at injection
    # (<species>.random_theta, PhysicalParticleContainer.cpp:300)
    random_theta: bool = True

    @property
    def qm(self) -> float:
        return self.charge / self.mass


@dataclasses.dataclass(frozen=True)
class MCCProcessConfig:
    """One scattering process of a background MCC or DSMC collision
    (reference: ScatteringProcess.H): a cross-section table on its energy
    grid (eV; uniform for MCC) in m^2, clamped to its end values outside
    the grid."""

    kind: str  # elastic | back | charge_exchange | excitation | ionization
    energy_penalty: float = 0.0  # eV
    energies: Tuple[float, ...] = ()
    sigmas: Tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class CollisionConfig:
    """One binary-collision pairing (reference: CollisionHandler.H)."""

    name: str
    species: Tuple[str, str]
    # pairwisecoulomb | nuclearfusion | dsmc | background_mcc |
    # background_stopping
    kind: str = "pairwisecoulomb"
    coulomb_log: float = -1.0  # <= 0: computed per pair
    ndt: int = 1
    # background MCC (reference: BackgroundMCCCollision.H)
    background_density: str = ""  # expression f(x, y, z, t), m^-3
    background_temperature: str = ""  # expression f(x, y, z, t), K
    background_mass: float = -1.0  # kg; -1: the species' or product's mass
    max_background_density: float = 0.0
    ionization_species: str = ""
    processes: Tuple[MCCProcessConfig, ...] = ()
    # background stopping (reference: BackgroundStopping.H)
    background_type: str = "electrons"  # electrons | ions
    background_charge_state: float = 0.0
    # nuclear fusion (reference: NuclearFusionFunc.H:61-79)
    product_species: Tuple[str, ...] = ()
    fusion_kind: str = ""  # protonboron | dt | ddp | ddn | dhe
    fusion_multiplier: float = 1.0
    fusion_probability_threshold: float = 0.02
    fusion_probability_target_value: float = 0.002


@dataclasses.dataclass(frozen=True)
class SimConfig:
    geometry: Geometry
    max_step: int
    dt: float
    particle_shape: int = 1
    em_solver: str = "yee"  # yee | ckc | psatd | hybrid | ect | none
    current_deposition: str = "esirkepov"
    field_gathering: str = "energy-conserving"
    grid_type: str = "staggered"  # staggered | collocated | hybrid
    # staggered -> nodal interpolation order per active axis for
    # momentum-conserving gathering (warpx.field_centering_no*; 2, hybrid
    # grids 8); () takes 2
    field_centering_no: Tuple[int, ...] = ()
    use_filter: bool = False
    filter_npass_each_dir: Tuple[int, ...] = ()  # () = one pass per axis
    use_nci_corr: bool = False
    species: Tuple[SpeciesConfig, ...] = ()
    cfl: float = 0.999
    seed: int = 0
    # bound peak memory of deposition tap intermediates (None = no chunking)
    deposit_chunk_size: int | None = 2_000_000
    # per-dim field boundaries on the active axes: periodic | pec | pml |
    # absorbing_silver_mueller | damped | open | none
    field_bc_lo: Tuple[str, ...] = ()
    field_bc_hi: Tuple[str, ...] = ()
    # per-dim particle boundaries: periodic | absorbing | reflecting |
    # thermal
    particle_bc_lo: Tuple[str, ...] = ()
    particle_bc_hi: Tuple[str, ...] = ()
    # moving window (reference: WarpXMovingWindow.cpp)
    do_moving_window: bool = False
    moving_window_dir: int = -1  # active-axis index
    moving_window_v: float = 1.0  # units of c
    # the window's step range (warpx.start/end_moving_window_step); the
    # window moves from step 0 to the end, the only range the JAX package
    # runs (ROADMAP.md Queue C)
    start_moving_window_step: int = 0
    end_moving_window_step: int = -1
    lasers: Tuple[LaserConfig, ...] = ()
    # cold relativistic fluid species (reference: fluids.species_names,
    # WarpXFluidContainer), on the SpeciesConfig profile fields
    fluids: Tuple[SpeciesConfig, ...] = ()
    pml_ncell: int = 10
    # mesh refinement (amr.max_level, warpx.fine_tag_lo/hi): one static
    # fine patch, Vay's substitution scheme (core/mr.py); the ratio per
    # active axis (amr.ref_ratio / amr.ref_ratio_vect)
    max_level: int = 0
    ref_ratio: Tuple[int, ...] = ()
    fine_tag_lo: Tuple[float, ...] = ()
    fine_tag_hi: Tuple[float, ...] = ()
    # the refined box is the tag box grown to amr.blocking_factor multiples
    # in fine cells (AMReX BoxArray blocking)
    blocking_factor: int = 8
    # inject r-times finer particle streams where the transverse footprint
    # of the refined box covers the cell (warpx.refine_plasma;
    # PhysicalParticleContainer::findRefinedInjectionBox)
    refine_plasma: bool = False
    # particles within this many fine cells of the patch's edge gather from
    # / deposit to level 0 (WarpX::BuildBufferMasks)
    n_field_gather_buffer: int = 3
    n_current_deposition_buffer: int = 2
    # fine-level time subcycling (warpx.do_subcycling; OneStep_sub1)
    do_subcycling: bool = False
    # embedded boundary: the implicit function f(x, y, z), > 0 covered
    # (warpx.eb_implicit_function or the eb2.* builders); covered edges of
    # E and faces of B stay frozen (staircase), or the ECT solver's cut
    # cells under em_solver = ect
    eb_implicit_function: str = ""
    # hybrid QED Maxwell (warpx.use_hybrid_QED, warpx.quantum_xi;
    # WarpX_QED_Field_Pushers.cpp): PSATD on a collocated grid; xi c^2
    use_hybrid_qed: bool = False
    quantum_xi_c2: float = 1.1728865132395492e-35
    # accelerator lattice: ("quad" | "plasmalens", z_start, z_end, dEdx,
    # dBdx) laid out from z = 0 (Source/AcceleratorLattice/)
    lattice_elements: Tuple = ()
    # Lorentz-boosted frame (warpx.gamma_boost / boost_direction; the
    # deck's geometry is given in lab coordinates and converted at parse
    # time)
    gamma_boost: float = 1.0
    boost_direction: str = "z"
    # initial grid fields (warpx.E/B_ext_grid_init_style): None,
    # ("constant", (vx, vy, vz)), ("parse", (fx, fy, fz)) or ("file",
    # (path,))
    e_ext_grid: Optional[Tuple] = None
    b_ext_grid: Optional[Tuple] = None
    # constant external fields applied to particles during gather
    e_ext_particle: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    b_ext_particle: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # macroscopic Maxwell medium (algo.em_solver_medium,
    # MacroscopicProperties.cpp; sigma, epsilon and mu constant or parsed
    # f(x, y, z); None takes the vacuum's value)
    em_solver_medium: str = "vacuum"  # vacuum | macroscopic
    macroscopic_sigma_method: str = "backwardeuler"  # | laxwendroff
    macro_sigma: float | None = None
    macro_sigma_function: str = ""
    macro_epsilon: float | None = None
    macro_epsilon_function: str = ""
    macro_mu: float | None = None
    macro_mu_function: str = ""
    # the electrostatic solver (ElectrostaticSolverAlgo): none | labframe |
    # relativistic | labframe-electromagnetostatic
    electrostatic: str = "none"
    # warpx.poisson_solver: multigrid (here the direct transform solve) |
    # fft (the open-boundary integrated Green function, 3D all-open box)
    poisson_solver: str = "multigrid"
    # Dirichlet wall potentials per active dim, ((lo, hi), ...) as f(t)
    # strings, "" where unset (boundary.potential_lo_x etc.)
    boundary_potentials: Tuple = ()
    do_dive_cleaning: bool = False
    do_divb_cleaning: bool = False
    # split-field cleaning inside the PML (warpx.do_pml_dive_cleaning /
    # do_pml_divb_cleaning; defaults true for PSATD, WarpX.cpp:848-870)
    do_pml_dive_cleaning: bool = False
    do_pml_divb_cleaning: bool = False
    # the projection div(B) cleaner at initialization
    # (warpx.do_divb_cleaning_external, ProjectionDivCleaner)
    do_divb_cleaning_external: bool = False
    # PSATD knobs (reference: WarpX.cpp:1409-1520)
    psatd_order: int = 16  # -1 = infinite order (periodic single box)
    psatd_update_with_rho: bool = False
    psatd_current_correction: bool = False
    # averaged Galilean PSATD (psatd.do_time_averaging)
    psatd_time_averaging: bool = False
    psatd_periodic_single_box: bool = False
    # multi-J: J time dependence (reference: psatd.J_in_time, warpx.do_multi_J)
    psatd_j_in_time: str = "constant"
    # multi-J sub-depositions per step (warpx.do_multi_J_n_depositions)
    multi_j_n_depositions: int = 1
    # psatd.solution_type: second-order | first-order
    psatd_solution_type: str = "second-order"
    # psatd.rho_in_time: linear | constant
    psatd_rho_in_time: str = "linear"
    # Galilean frame velocity [m/s] (reference: psatd.v_galilean * c)
    psatd_v_galilean: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # comoving-PSATD velocity [m/s] (reference: psatd.v_comoving * c)
    psatd_v_comoving: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # tile-binned hot path (ops/tiling.py + ops/fused_pic.py); the analog of
    # the reference's binned shared-memory deposition
    # (WarpXParticleContainer.cpp:490-548) at the SortParticlesByBin cadence
    tiled_particles: str = "auto"  # auto | on | off
    tile_size: Tuple[int, int, int] = (8, 8, 8)
    sort_interval: int = 4
    sort_margin: int = 0  # 0 = auto: ceil(interval * c*dt/min(dx))
    tile_headroom: float = 2.0
    # precision of the fused kernels (ops/fused_pic.py): f32 | mixed | bf16
    tile_mxu: str = "f32"
    # the per-step time report (warpx.verbose; utils/observability.py)
    verbose: bool = False
    # Schwinger pair production (reference: warpx.do_qed_schwinger +
    # qed_schwinger.* keys, MultiParticleContainer::doQEDSchwinger)
    do_qed_schwinger: bool = False
    qed_schwinger_ele: str = ""
    qed_schwinger_pos: str = ""
    qed_schwinger_y_size: float = 0.0  # 2D transverse size
    qed_schwinger_threshold: float = 25.0  # Poisson->Gaussian crossover
    # activation region (qed_schwinger.{x,y,z}{min,max}), +-inf if unset
    qed_schwinger_bounds_lo: Tuple[float, float, float] = (
        float("-inf"),) * 3
    qed_schwinger_bounds_hi: Tuple[float, float, float] = (
        float("inf"),) * 3
    # binary collisions, in the deck's order (collisions.collision_names)
    collisions: Tuple[CollisionConfig, ...] = ()
    # the deck's my_constants, which the collisions' background
    # expressions, the medium's and the wall potentials' may name
    user_constants: Tuple[Tuple[str, float], ...] = ()
    # hybrid-PIC (Ohm's law) model (hybrid_pic_model.*,
    # HybridPICModel.H:152-180); elec_temp in eV
    hybrid_substeps: int = 10
    hybrid_elec_temp: float = 0.0
    hybrid_n0_ref: float = 1.0
    hybrid_gamma: float = 5.0 / 3.0
    hybrid_n_floor: float = 1.0
    hybrid_eta: str = "0"  # plasma_resistivity(rho, J), Ohm m
    hybrid_eta_h: float = 0.0  # hyper-resistivity
    hybrid_resistivity_has_J: bool = False
    hybrid_j_ext: Tuple[str, str, str] = ("", "", "")
    # implicit evolve schemes (algo.evolve_scheme; ImplicitSolvers/):
    # explicit | theta_implicit_em | semi_implicit_em, with the Picard or
    # the Newton (Jacobian-free GMRES) nonlinear solver
    evolve_scheme: str = "explicit"
    implicit_theta: float = 0.5
    implicit_nonlinear: str = "picard"  # picard | newton
    picard_max_iterations: int = 100
    picard_rtol: float = 1.0e-6
    picard_atol: float = 0.0
    implicit_max_particle_iterations: int = 1
    # Newton-Krylov (NewtonSolver.H:118-136; the Jacobian-vector product
    # is exact, by forward-mode differentiation)
    newton_max_iterations: int = 100
    newton_rtol: float = 1.0e-6
    newton_atol: float = 0.0
    gmres_max_iterations: int = 1000
    gmres_restart: int = 30
    gmres_rtol: float = 1.0e-4
    gmres_atol: float = 0.0
    # --- dynamic load balancing (algo.load_balance_*, WarpXRegrid.cpp:74):
    # DistSimulation.load_balance; the JAX package's defaults ---
    load_balance_intervals: str = "0"  # IntervalsParser string; "0" = never
    load_balance_with_sfc: bool = False  # SFC split instead of knapsack
    load_balance_knapsack_factor: float = 1.24  # max tiles/rank = ceil(T/n*f)
    load_balance_efficiency_ratio_threshold: float = 1.1
    load_balance_costs_update: str = "heuristic"  # heuristic only
    costs_heuristic_cells_wt: float = 0.1   # WarpX.cpp:417 (non-GPU default)
    costs_heuristic_particles_wt: float = 0.9
    # RZ geometry: the azimuthal modes of the fields
    # (warpx.n_rz_azimuthal_modes, Source/WarpX.H:316)
    n_rz_modes: int = 1

    @property
    def galerkin(self) -> bool:
        """Reduced-order gather along staggered axes (WarpX.cpp:154,
        967, 1207-1214): off for collocated grids, momentum-conserving
        gathering, and direct deposition with an EM solver."""
        if self.grid_type == "collocated":
            return False
        if self.field_gathering == "momentum-conserving":
            return False
        if self.current_deposition == "direct" and self.em_solver not in (
            "none",
            "hybrid",
        ):
            return False
        return True
