"""Resolved static simulation configuration.

A copy of ``warpx_tpu.core.config``'s ``LaserConfig``, ``SpeciesConfig``
and ``SimConfig``, cut to the fields the ported paths read (2D XZ and 3D
explicit EM, periodic and bounded with PML/PEC faces, moving window, laser
antennas, continuous injection and Gaussian beams, constant and parsed
profiles; per-particle and tile-binned steps).  Fields keep the reference's
names and defaults, so a configuration built for ``warpx_tpu`` with these
fields builds here with the same keyword arguments.  Features whose fields are absent come with later
items of ROADMAP.md's Queue A.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .grid import Geometry

__all__ = ["LaserConfig", "SpeciesConfig", "SimConfig"]


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


@dataclasses.dataclass(frozen=True)
class SpeciesConfig:
    name: str
    charge: float
    mass: float
    # nuniformpercell | nrandompercell | gaussian_beam | laser | none
    injection_style: str = "none"
    num_particles_per_cell_each_dim: Tuple[int, ...] = ()
    num_particles_per_cell: int = 0
    profile: str = "constant"  # constant | parse_density_function
    density: float = 0.0
    # parse_density_function: n(x, y, z) in m^-3 (utils/expression.py)
    density_expr: Optional[str] = None
    # at_rest | constant | gaussian | parse_momentum_function
    momentum_distribution: str = "at_rest"
    # parse_momentum_function: (ux, uy, uz)(x, y, z) in units of c
    momentum_exprs: Optional[Tuple[str, str, str]] = None
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
    pusher: str = "boris"  # boris | vay | higuera
    do_continuous_injection: bool = False
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
    species_type: str = ""
    # the deck's my_constants, which the parsed profiles may name
    user_constants: Tuple[Tuple[str, float], ...] = ()
    # extra particle capacity headroom factor for continuous injection
    capacity_factor: float = 1.0

    @property
    def qm(self) -> float:
        return self.charge / self.mass


@dataclasses.dataclass(frozen=True)
class SimConfig:
    geometry: Geometry
    max_step: int
    dt: float
    particle_shape: int = 1
    em_solver: str = "yee"  # yee | ckc | none
    current_deposition: str = "esirkepov"
    field_gathering: str = "energy-conserving"
    grid_type: str = "staggered"
    use_filter: bool = False
    filter_npass_each_dir: Tuple[int, ...] = ()  # () = one pass per axis
    use_nci_corr: bool = False
    species: Tuple[SpeciesConfig, ...] = ()
    cfl: float = 0.999
    seed: int = 0
    # bound peak memory of deposition tap intermediates (None = no chunking)
    deposit_chunk_size: int | None = 2_000_000
    # per-dim field boundaries on the active axes: periodic | pec | pml
    field_bc_lo: Tuple[str, ...] = ()
    field_bc_hi: Tuple[str, ...] = ()
    # per-dim particle boundaries: periodic | absorbing | reflecting
    particle_bc_lo: Tuple[str, ...] = ()
    particle_bc_hi: Tuple[str, ...] = ()
    # moving window (reference: WarpXMovingWindow.cpp)
    do_moving_window: bool = False
    moving_window_dir: int = -1  # active-axis index
    moving_window_v: float = 1.0  # units of c
    lasers: Tuple[LaserConfig, ...] = ()
    pml_ncell: int = 10
    # Lorentz-boosted frame; only the lab frame (1.0) is ported
    gamma_boost: float = 1.0
    # constant external fields applied to particles during gather
    e_ext_particle: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    b_ext_particle: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    em_solver_medium: str = "vacuum"
    do_dive_cleaning: bool = False
    do_divb_cleaning: bool = False
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
