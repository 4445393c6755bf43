"""Canonical simulation setups ("models"): ready-made SimConfig functions.

The counterpart of ``warpx_tpu.models``.  They mirror the reference's
flagship example classes (Examples/Physics_applications and the
uniform-plasma benchmark) as functions, so users can start from
a working configuration without a ParmParse deck.  Each returns the port's
``SimConfig``; run it with ``Simulation(cfg)`` or spread it over ranks with
``DistSimulation``.
"""

from __future__ import annotations

import numpy as np

from .. import constants
from ..core.config import LaserConfig, SimConfig, SpeciesConfig
from ..core.grid import Geometry
from ..solvers.yee import compute_dt_yee

__all__ = ["uniform_plasma", "langmuir_wave", "lwfa_3d"]


def uniform_plasma(n: int = 64, ppc: int = 1, ndim: int = 3,
                   density: float = 1.0e25, max_step: int = 100,
                   thermal_u: float = 0.01) -> SimConfig:
    """Warm uniform plasma on a periodic torus, the throughput benchmark's
    configuration (reference: Examples/Physics_applications/
    uniform_plasma)."""
    L = 1.0e-5
    geom = Geometry(
        ndim, (n,) * ndim, (0.0,) * ndim, (L,) * ndim, (True,) * ndim
    )
    electrons = SpeciesConfig(
        name="electrons", charge=-constants.q_e, mass=constants.m_e,
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=(ppc,) * ndim,
        profile="constant", density=density,
        momentum_distribution="gaussian",
        ux_th=thermal_u, uy_th=thermal_u, uz_th=thermal_u,
    )
    return SimConfig(
        geometry=geom, max_step=max_step,
        dt=compute_dt_yee(geom, 0.999), species=(electrons,),
    )


def langmuir_wave(n: int = 64, ndim: int = 3, n0: float = 2.0e24,
                  epsilon: float = 0.01, max_step: int = 40) -> SimConfig:
    """Standing Langmuir oscillation (reference: Examples/Tests/langmuir,
    the primary parity family)."""
    L = 40.0e-6
    geom = Geometry(
        ndim, (n,) * ndim, (-L / 2,) * ndim, (L / 2,) * ndim,
        (True,) * ndim,
    )
    wp = float(np.sqrt(n0 * constants.q_e**2
                       / (constants.m_e * constants.ep0)))
    k = 2 * np.pi / L
    u = epsilon * k / (wp / constants.c)
    electrons = SpeciesConfig(
        name="electrons", charge=-constants.q_e, mass=constants.m_e,
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=(2,) * ndim,
        profile="constant", density=n0,
        momentum_distribution="parse_momentum_function",
        momentum_exprs=(
            f"{u}*sin(2*pi*x/{L})", "0", "0",
        ) if ndim > 1 else ("0", "0", f"{u}*sin(2*pi*z/{L})"),
    )
    return SimConfig(
        geometry=geom, max_step=max_step,
        dt=compute_dt_yee(geom, 0.8), species=(electrons,),
    )


def lwfa_3d(n_trans: int = 32, n_long: int = 64,
            max_step: int = 200) -> SimConfig:
    """3D laser-wakefield accelerator stage with a moving window
    (reference: Examples/Physics_applications/laser_acceleration): a laser
    antenna, continuous injection, PEC walls."""
    lo = (-25.0e-6, -25.0e-6, -15.0e-6)
    hi = (25.0e-6, 25.0e-6, 10.0e-6)
    geom = Geometry(
        3, (n_trans, n_trans, n_long), lo, hi, (False, False, False)
    )
    electrons = SpeciesConfig(
        name="electrons", charge=-constants.q_e, mass=constants.m_e,
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=(1, 1, 1),
        profile="parse_density_function",
        density_expr="1.e23*(z>0)",
        do_continuous_injection=True,
    )
    laser = LaserConfig(
        name="laser", position=(0.0, 0.0, 9.0e-6),
        direction=(0.0, 0.0, 1.0), polarization=(1.0, 0.0, 0.0),
        e_max=1.0e12, wavelength=0.8e-6, profile="gaussian",
        profile_waist=5.0e-6, profile_duration=15.0e-15,
        profile_t_peak=30.0e-15, profile_focal_distance=100.0e-6,
    )
    return SimConfig(
        geometry=geom, max_step=max_step, dt=compute_dt_yee(geom, 0.999),
        species=(electrons,), lasers=(laser,),
        field_bc_lo=("pec",) * 3, field_bc_hi=("pec",) * 3,
        particle_bc_lo=("absorbing",) * 3,
        particle_bc_hi=("absorbing",) * 3,
        do_moving_window=True, moving_window_dir=2, moving_window_v=1.0,
    )
