"""1D Cartesian geometry (``geometry.dims = 1``, the z axis) in the port
against the JAX package, CPU, float64, 1e-9.

The 1D Esirkepov (transverse currents direct, Jz charge-conserving) and
direct deposits at orders 1-3; the 1D Yee, CKC and collocated curls and the
cleaning operators; periodic decks end to end under Esirkepov, direct and
``villasenor`` deposition (the JAX package deposits villasenor directly
with the Galerkin gather kept on); the 1D laser-wakefield deck of WarpX's
``inputs_test_1d_laser_acceleration`` form (moving window, PEC faces, a
Gaussian antenna, the bilinear filter, continuous injection, an integer
and a real runtime attribute) and PML and Silver-Mueller faces;
the field models the JAX package runs in 1D (PSATD, the electrostatic
solves, the Ohm's-law hybrid solver with ``tests/test_hybrid.py``'s 1D
Ohm's-law terms, the macroscopic medium, the implicit schemes, a fluid
species, collocated grids, Coulomb collisions and field ionization on the
JAX package's key chain); a back-transformed snapshot of a vacuum pulse
(``tests/test_btd.py``); the 1D refusals the JAX package makes too.  The
JAX runs are small: those whose step compiles slower than it runs op by op
go under ``jax.disable_jit``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu import constants
from warpx_tpu.core.config import SimConfig as JSimConfig
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.grid import yee_staggering as j_yee_staggering
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.core.state import FieldState as JFieldState
from warpx_tpu.diagnostics.btd import BTDSnapshots as JBTDSnapshots
from warpx_tpu.ops import deposit as jdep
from warpx_tpu.solvers import hybrid as jhyb
from warpx_tpu.solvers import yee as jyee
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.grid import Geometry, yee_staggering
from warpx_tpu_torch.core.state import FieldState
from warpx_tpu_torch.diagnostics.btd import BTDSnapshots
from warpx_tpu_torch.ops import deposit as tdep
from warpx_tpu_torch.solvers import hybrid as thyb
from warpx_tpu_torch.solvers import yee as tyee
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_draws_util import (ION_2D, assert_checksums_close,
                                    assert_runs_close, field_hook, jax_run,
                                    port_run, seeded_ex)
from .test_torch_models_util import assert_runs_agree, port_config, rel_err

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

C = constants.c
RTOL = 1e-9
NAMES = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")


def geoms(n=32, lo=-10e-6, hi=10e-6):
    return (JGeometry(1, (n,), (lo,), (hi,), (True,)),
            Geometry(ndim=1, n_cell=(n,), prob_lo=(lo,), prob_hi=(hi,),
                     periodic=(True,)))


def jax_deck_run(text, jit=False):
    if jit:
        return jax_run(text)
    with jax.disable_jit():
        return jax_run(text)


# ---- the deposits and the curls -------------------------------------------

@pytest.mark.parametrize("kind,order", [
    ("esirkepov", 1), ("esirkepov", 3), ("direct", 2)])
def test_deposit_1d_matches_jax(kind, order):
    """The 1D deposits on random particles that cross cell faces (u up to
    0.9 c along z), wrapped through the periodic ends."""
    jg, tg = geoms()
    rng = np.random.default_rng(order)
    n = 300
    z = rng.uniform(-10e-6, 10e-6, n)
    u = rng.normal(size=(3, n)) * C
    w = rng.uniform(0.5, 1.5, n) * 1e10
    dt = 0.5 * tg.dx[0] / C
    targs = ([torch.from_numpy(z)], *(torch.from_numpy(a) for a in u),
             torch.from_numpy(w), -constants.q_e, tg)
    jargs = ([jnp.asarray(z)], *(jnp.asarray(a) for a in u), jnp.asarray(w),
             -constants.q_e, jg)
    with jax.disable_jit():
        if kind == "esirkepov":
            got = tdep.deposit_current_esirkepov(*targs, dt, order)
            ref = jdep.deposit_current_esirkepov(*jargs, dt, order)
        else:
            got = tdep.deposit_current_direct(*targs, yee_staggering(1), dt,
                                              order)
            ref = jdep.deposit_current_direct(*jargs, j_yee_staggering(1),
                                              dt, order)
    for g, r in zip(got, ref):
        assert g.shape == (32,)
        assert rel_err(g.numpy(), r) <= 1e-12


def _fields(rng, n):
    return {nm: rng.normal(size=n) * (1.0 if nm[0] != "B" else 1e-8)
            for nm in NAMES}


@pytest.mark.parametrize("algo", ["yee", "ckc", "nodal"])
def test_curls_1d_match_jax(algo):
    """evolve_b / evolve_e (Yee, CKC, the collocated centered curls) and
    the divergence-cleaning operators in 1D on seeded fields."""
    jg, tg = geoms()
    a = _fields(np.random.default_rng(5), 32)
    jf = JFieldState(**{k: jnp.asarray(v) for k, v in a.items()})
    tf = FieldState(**{k: torch.from_numpy(v) for k, v in a.items()})
    dt = 1e-16
    for name in ("evolve_b", "evolve_e"):
        got = getattr(tyee, name)(tf, tg, dt, algo)
        ref = getattr(jyee, name)(jf, jg, dt, algo)
        for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
            assert rel_err(getattr(got, nm).numpy(),
                           getattr(ref, nm)) <= 1e-14, (name, nm)
    F, G = torch.from_numpy(a["jx"]), torch.from_numpy(a["jy"])
    rho = torch.from_numpy(a["jz"])
    pairs = [(tyee.evolve_f(F, tf, rho, tg, dt, algo),
              jyee.evolve_f(jnp.asarray(a["jx"]), jf, jnp.asarray(a["jz"]),
                            jg, dt, algo)),
             (tyee.evolve_g(G, tf, tg, dt, algo),
              jyee.evolve_g(jnp.asarray(a["jy"]), jf, jg, dt, algo)),
             (tyee.add_grad_f(tf, F, tg, dt, algo).Ez,
              jyee.add_grad_f(jf, jnp.asarray(a["jx"]), jg, dt, algo).Ez),
             (tyee.add_grad_g(tf, G, tg, dt, algo).Bz,
              jyee.add_grad_g(jf, jnp.asarray(a["jy"]), jg, dt, algo).Bz),
             (tyee.compute_div_e(tf, tg), jyee.compute_div_e(jf, jg)),
             (tyee.compute_div_b(tf, tg), jyee.compute_div_b(jf, jg))]
    for i, (g, r) in enumerate(pairs):
        assert rel_err(g.numpy(), r) <= 1e-14, i


# ---- periodic decks -------------------------------------------------------

PERIODIC = """
max_step = 2
amr.n_cell = 16
geometry.dims = 1
geometry.prob_lo = -10.e-6
geometry.prob_hi = 10.e-6
warpx.cfl = 0.8
algo.particle_shape = {order}
algo.current_deposition = {dep}
algo.maxwell_solver = {solver}
particles.species_names = electrons ions
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 2
electrons.profile = constant
electrons.density = 1.e25
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = 0.01*sin(z*3.e5)
electrons.momentum_function_uy(x,y,z) = 0.02*cos(z*3.e5)
electrons.momentum_function_uz(x,y,z) = 0.05*sin(z*3.14159e5)
ions.species_type = proton
ions.injection_style = NUniformPerCell
ions.num_particles_per_cell_each_dim = 1
ions.profile = constant
ions.density = 1.e25
ions.momentum_distribution_type = constant
ions.uz = 0.001
"""


@pytest.mark.parametrize("dep,order,solver", [
    ("esirkepov", 3, "yee"), ("direct", 2, "ckc"), ("villasenor", 3, "ckc"),
    ("esirkepov", 2, "psatd")])
def test_periodic_deck_matches_jax(dep, order, solver):
    """The periodic 1D step, per particle, slot by slot and by checksums;
    villasenor keeps the Galerkin gather and so differs from direct (held
    to JAX in ``test_deposit_1d_matches_jax``)."""
    text = PERIODIC.format(dep=dep, order=order, solver=solver)
    j = jax_deck_run(text)
    p = port_run(text)
    assert not p.binned and not p.is_bounded
    assert_runs_close(p, j, RTOL)
    assert_checksums_close(p.checksums(), j.checksums(), RTOL)
    if dep == "villasenor":
        assert p.cfg.galerkin
        direct = port_run(text.replace("villasenor", "direct"))
        assert not direct.cfg.galerkin
        jz = (p.checksums()["lev=0"]["jz"],
              direct.checksums()["lev=0"]["jz"])
        assert abs(jz[0] / jz[1] - 1.0) > 1e-6


# ---- the bounded step -----------------------------------------------------

LWFA_1D = """
max_step = {steps}
amr.n_cell = 128
geometry.dims = 1
geometry.prob_lo = -30.e-6
geometry.prob_hi = 2.e-6
boundary.field_lo = pec
boundary.field_hi = pec
warpx.cfl = 0.9
warpx.do_moving_window = 1
warpx.moving_window_dir = z
warpx.moving_window_v = 1.0
warpx.use_filter = 1
algo.maxwell_solver = ckc
algo.particle_shape = 3
particles.species_names = electrons
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = "NUniformPerCell"
electrons.num_particles_per_cell_each_dim = 4
electrons.xmin = -20.e-6
electrons.xmax = 20.e-6
electrons.ymin = -20.e-6
electrons.ymax = 20.e-6
electrons.zmin = -5.e-6
electrons.profile = constant
electrons.density = 2.e23
electrons.momentum_distribution_type = "at_rest"
electrons.do_continuous_injection = 1
electrons.addIntegerAttributes = regionofinterest
electrons.attribute.regionofinterest(x,y,z,ux,uy,uz,t) = "(z>-2.0e-6) * (z<3.0e-6)"
electrons.addRealAttributes = initialenergy
electrons.attribute.initialenergy(x,y,z,ux,uy,uz,t) = "ux*ux + uy*uy + uz*uz + z*1.e12"
lasers.names = laser1
laser1.profile = Gaussian
laser1.position = 0. 0. -8.e-6
laser1.direction = 0. 0. 1.
laser1.polarization = 0. 1. 0.
laser1.e_max = 16.e12
laser1.profile_waist = 5.e-6
laser1.profile_duration = 5.e-15
laser1.profile_t_peak = 10.e-15
laser1.profile_focal_distance = 100.e-6
laser1.wavelength = 0.8e-6
"""


def test_lwfa_1d_matches_jax():
    """The 1D laser-wakefield deck for 20 steps: the window moved and
    injected, the antenna drove Ey, the attributes (an int32
    regionofinterest, a real initialenergy) ride every injected particle
    and land on the JAX run's, slot by slot and in the checksums."""
    text = LWFA_1D.format(steps=20)
    j = jax_deck_run(text, jit=True)
    p = port_run(text)
    assert p.is_bounded and not p.binned
    assert_runs_close(p, j, RTOL)
    sums = p.checksums()
    assert_checksums_close(sums, j.checksums(), RTOL)
    sp = p.state.species["electrons"]
    assert sp.extra["regionofinterest"].dtype == torch.int32
    assert sums["electrons"]["particle_regionofinterest"] > 0
    assert int(p.state.aux["window_offset"]) > 0
    assert float(p.state.fields.Ey.abs().max()) > 1e9


@pytest.mark.parametrize("faces,solver", [
    ("absorbing_silver_mueller", "ckc"), ("pml", "yee")])
def test_bounded_faces_1d_match_jax(faces, solver):
    """The antenna's pulse through Silver-Mueller and PML faces (no
    window, no plasma injection beyond the initial slab): E, B and J each
    within 1e-9 of their group's largest value, the particles slot by
    slot."""
    text = "\n".join(
        ln for ln in LWFA_1D.format(steps=12).splitlines()
        if "moving_window" not in ln and "continuous" not in ln
        and "ttribute" not in ln)
    text = (text.replace("field_lo = pec", f"field_lo = {faces}")
            .replace("field_hi = pec", f"field_hi = {faces}")
            .replace("maxwell_solver = ckc", f"maxwell_solver = {solver}"))
    j = jax_deck_run(text, jit=True)
    p = port_run(text)
    assert_runs_agree(j, p)


# ---- the field models ------------------------------------------------------

MODEL_BASE = """
max_step = 3
amr.n_cell = 32
geometry.dims = 1
geometry.prob_lo = 0.
geometry.prob_hi = 16.e-6
warpx.cfl = 0.5
my_constants.pi = 3.141592653589793
{field}
particles.species_names = electrons ions
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 2
electrons.profile = constant
electrons.density = 2.e24
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "0.02*sin(2*pi*z/16.e-6)"
electrons.momentum_function_uy(x,y,z) = "0.01*cos(2*pi*z/16.e-6)"
electrons.momentum_function_uz(x,y,z) = "0.015*sin(2*pi*z/16.e-6)"
ions.species_type = proton
ions.injection_style = NUniformPerCell
ions.num_particles_per_cell_each_dim = 1
ions.profile = constant
ions.density = 2.e24
ions.momentum_distribution_type = gaussian
ions.ux_th = 0.0005
ions.uy_th = 0.0005
ions.uz_th = 0.0005
ions.uz_m = 0.001
"""

# (deck keys, whether the JAX run compiles)
FIELD_MODELS = {
    "electrostatic_dirichlet": (
        "warpx.do_electrostatic = labframe\nboundary.field_lo = pec\n"
        "boundary.field_hi = pec\nboundary.particle_lo = absorbing\n"
        "boundary.particle_hi = absorbing\nboundary.potential_lo_z = 0\n"
        "boundary.potential_hi_z = 20.*sin(2*pi*t/(4.e-15))\n"
        "warpx.use_filter = 0", False),
    "hybrid": ("algo.maxwell_solver = hybrid\n"
               "hybrid_pic_model.elec_temp = 10.\n"
               "hybrid_pic_model.n0_ref = 2.e24\n"
               "hybrid_pic_model.plasma_resistivity(rho,J) = 1.e-6\n"
               "hybrid_pic_model.substeps = 5", False),
    "macroscopic": ("algo.em_solver_medium = macroscopic\n"
                    'macroscopic.sigma_function(x,y,z) = "1.e3*(z>8.e-6)"\n'
                    "macroscopic.epsilon = 2.*8.8541878128e-12\n"
                    "warpx.use_filter = 0", True),
    "theta_implicit": ("algo.evolve_scheme = theta_implicit_em\n"
                       "warpx.use_filter = 0\n"
                       "picard.relative_tolerance = 1.e-11\n"
                       "picard.max_iterations = 60", True),
    "collocated_psatd": ("warpx.grid_type = collocated\n"
                         "algo.maxwell_solver = psatd", False),
}


@pytest.mark.parametrize("model", sorted(FIELD_MODELS))
def test_field_model_1d_matches_jax(model):
    keys, jit = FIELD_MODELS[model]
    text = MODEL_BASE.replace("{field}", keys)
    j = jax_deck_run(text, jit)
    p = port_run(text)
    assert_runs_agree(j, p)


FLUID_1D = """
max_step = 3
amr.n_cell = 32
geometry.dims = 1
geometry.prob_lo = -10.e-6
geometry.prob_hi = 10.e-6
warpx.cfl = 0.8
warpx.use_filter = 0
my_constants.pi = 3.141592653589793
my_constants.k0 = 2*pi/20.e-6
fluids.species_names = electrons
electrons.charge = -q_e
electrons.mass = m_e
electrons.profile = parse_density_function
electrons.density_function(x,y,z) = "2.e24*(1 + 0.01*cos(k0*z))"
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "0.01*sin(k0*z)"
electrons.momentum_function_uy(x,y,z) = "0.002*cos(k0*z)"
electrons.momentum_function_uz(x,y,z) = "0.005*sin(k0*z)"
particles.species_names = ions
ions.species_type = proton
ions.injection_style = NUniformPerCell
ions.num_particles_per_cell_each_dim = 2
ions.profile = constant
ions.density = 2.e24
ions.momentum_distribution_type = constant
ions.uz = 0.001
"""


def test_fluid_species_1d_matches_jax():
    j = jax_deck_run(FLUID_1D, jit=True)
    p = port_run(FLUID_1D)
    assert_runs_agree(j, p)
    for nm in ("fluid_N:electrons", "fluid_NUz:electrons"):
        assert rel_err(p.state.aux[nm].numpy(), j.state.aux[nm]) <= RTOL


def test_collisions_and_ionization_1d_match_jax():
    """The stochastic operators in 1D on the JAX package's key chain:
    e-e and ion-e Coulomb collisions and the field ionization of a
    nitrogen dopant under a seeded Ex, 3 steps."""
    text = (ION_2D.replace("amr.n_cell = 16 16", "amr.n_cell = 32")
            .replace("geometry.dims = 2", "geometry.dims = 1")
            .replace("-8.e-6 -8.e-6", "-8.e-6")
            .replace("8.e-6  8.e-6", "8.e-6")
            .replace("num_particles_per_cell_each_dim = 1 1",
                     "num_particles_per_cell_each_dim = 2")
            .replace("num_particles_per_cell_each_dim = 2 2",
                     "num_particles_per_cell_each_dim = 4")
            .replace("max_step = 6", "max_step = 3")
            + "electrons.momentum_distribution_type = gaussian\n"
              "electrons.ux_th = 0.01\nelectrons.uy_th = 0.01\n"
              "electrons.uz_th = 0.01\n"
              "collisions.collision_names = c_ee c_ie\n"
              "c_ee.species = electrons electrons\n"
              "c_ie.species = ions electrons\n")
    ex = seeded_ex(32, scale=3e12, mean=2e12)
    j = jax_run(text, hook=field_hook(ex, True))
    p = port_run(text, hook=field_hook(ex, False))
    assert int(p.state.species["eprod"].alive.sum()) > 0
    assert_runs_close(p, j, RTOL)
    assert_checksums_close(p.checksums(), j.checksums(), RTOL)


def test_hybrid_ohm_terms_1d():
    """tests/test_hybrid.py::test_ohm_hall_and_pressure_terms: the Hall
    term of By = dB sin(kz) in Bz = B0 on a uniform rho, and the pressure
    term of a graded density, through both packages' ohm_solve_e, and
    against the closed forms."""
    n, L = 128, 2.0
    dz, k = L / n, 2 * np.pi / L
    jg = JGeometry(1, (n,), (0.0,), (L,), (True,))
    tg = Geometry(ndim=1, n_cell=(n,), prob_lo=(0.0,), prob_hi=(L,),
                  periodic=(True,))
    zc, zn = (np.arange(n) + 0.5) * dz, np.arange(n) * dz
    B0, dB, n0 = 0.2, 0.02, 1e20
    rho0 = constants.q_e * n0
    zero = np.zeros(n)

    def run(te, rho, by, bz, pressure):
        jcfg = JSimConfig(geometry=jg, max_step=1, dt=1e-9, species=(),
                          em_solver="hybrid", hybrid_elec_temp=te,
                          hybrid_n0_ref=n0, hybrid_gamma=2.0,
                          hybrid_n_floor=1.0)
        cfg = port_config(jcfg)
        a = {nm: zero for nm in NAMES}
        a.update(By=by, Bz=bz)
        jf = JFieldState(**{k_: jnp.asarray(v) for k_, v in a.items()})
        tf = FieldState(**{k_: torch.from_numpy(v) for k_, v in a.items()})
        ji = (zero,) * 3
        tpe = (thyb.electron_pressure(torch.from_numpy(rho), cfg)
               if pressure else None)
        jpe = (jhyb.electron_pressure(jnp.asarray(rho), jcfg)
               if pressure else None)
        got = thyb.ohm_solve_e(tf, tuple(torch.from_numpy(v) for v in ji),
                               torch.from_numpy(rho), tg, yee_staggering(1),
                               cfg, Pe=tpe, solve_for_Faraday=not pressure)
        ref = jhyb.ohm_solve_e(jf, tuple(jnp.asarray(v) for v in ji),
                               jnp.asarray(rho), jg, j_yee_staggering(1),
                               jcfg, Pe=jpe, solve_for_Faraday=not pressure)
        for nm in ("Ex", "Ey", "Ez"):
            assert rel_err(getattr(got, nm).numpy(), getattr(ref, nm),
                           scale=max(np.abs(np.asarray(getattr(ref, c))).max()
                                     for c in ("Ex", "Ey", "Ez"))) <= 1e-12
        return got

    got = run(0.0, np.full(n, rho0), dB * np.sin(k * zc), np.full(n, B0),
              False)
    jx_th = -dB * k * np.cos(k * zn) / constants.mu0
    ey_th = -jx_th * B0 / rho0
    assert np.allclose(got.Ey.numpy(), ey_th, atol=2e-3 * np.abs(ey_th).max())
    prof = 1.0 + 0.1 * np.sin(k * zn)
    got = run(100.0, rho0 * prof, zero, zero, True)
    pe = n0 * 100.0 * constants.q_e * prof ** 2
    dpe = (np.roll(pe, -1) - pe) / dz
    rho_at = 0.5 * (rho0 * prof + np.roll(rho0 * prof, -1))
    assert np.allclose(got.Ez.numpy(), -dpe / rho_at,
                       atol=1e-8 * np.abs(dpe / rho_at).max())


def test_btd_vacuum_pulse_1d_matches_jax(tmp_path):
    """tests/test_btd.py::test_btd_vacuum_pulse at 128 cells: the boosted
    pulse's back-transformed snapshot, rows and values, in both
    packages."""
    gamma = 2.0
    beta = np.sqrt(1.0 - 1.0 / gamma ** 2)
    L, n = 100e-6, 128
    dz = L / n
    jg = JGeometry(1, (n,), (0.0,), (L,), (True,))
    jcfg = JSimConfig(geometry=jg, max_step=115, dt=0.999 * dz / C,
                      species=(), em_solver="yee", gamma_boost=gamma,
                      use_filter=False)
    tcfg = port_config(jcfg)
    jsim = JSimulation(jcfg)
    jsim.init()
    tsim = warpx_tpu_torch.Simulation(tcfg, dtype=torch.float64,
                                      device="cpu")
    tsim.init()
    E0p, zcp, sigp = 1e8, 30e-6, 5e-6
    init = {}
    for nm, amp in (("Ex", E0p), ("By", E0p / C)):
        z = (np.arange(n) + (0.0 if jsim.staggering[nm][0] else 0.5)) * dz
        init[nm] = amp * np.exp(-((z - zcp) ** 2) / (2 * sigp ** 2))
    jsim.state = jsim.state.replace(fields=jsim.state.fields.replace(
        **{k: jnp.asarray(a) for k, a in init.items()}))
    tsim.state = tsim.state.replace(fields=tsim.state.fields.replace(
        **{k: torch.from_numpy(a) for k, a in init.items()}))
    t_lab = gamma * beta * (zcp + 20e-6) / C
    jb = JBTDSnapshots("btd", jcfg, 1, t_lab, ["Ex", "By"],
                       str(tmp_path / "jax"))
    tb = BTDSnapshots("btd", tcfg, 1, t_lab, ["Ex", "By"],
                      str(tmp_path / "port"))
    jb.t_lab = tb.t_lab = [t_lab]
    for _ in range(jcfg.max_step):
        jsim.evolve(1)
        jb.update(jsim)
        tsim.evolve(1)
        tb.update(tsim)
    assert jb.done == tb.done == [True]
    np.testing.assert_array_equal(tb.filled[0], jb.filled[0])
    assert tb.filled[0].sum() > 40
    got, ref = tb.snapshot(0), jb.snapshot(0)
    for nm in ("Ex", "By"):
        assert rel_err(np.asarray(got[nm]), np.asarray(ref[nm])) <= RTOL


# ---- refusals --------------------------------------------------------------

@pytest.mark.parametrize("extra,match", [
    # the JAX package's refusals in 1D (deposit.py, psatd.py:985, ect.py)
    ("algo.current_deposition = vay\nalgo.maxwell_solver = psatd\n",
     "Vay deposition not implemented in 1D"),
    ("algo.maxwell_solver = psatd\nboundary.field_lo = pml\n"
     "boundary.field_hi = pml\n", "PML in Cartesian 1D geometry"),
    ("algo.maxwell_solver = ect\nboundary.field_lo = pec\n"
     "boundary.field_hi = pec\nwarpx.eb_implicit_function = \"z-5.e-6\"\n",
     "ECT is 2D-XZ/3D only"),
])
def test_1d_refusals(extra, match):
    text = "\n".join(ln for ln in PERIODIC.format(
        dep="esirkepov", order=1, solver="yee").splitlines()
        if "current_deposition" not in ln and "maxwell_solver" not in ln)
    cfg = config_from_deck(Deck.from_string(text + "\n" + extra))
    with pytest.raises(NotImplementedError, match=match):
        sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64,
                                         device="cpu")
        sim.init()
        sim.evolve(1)


def test_1d_deck_reads_as_jax():
    """The 1D deck's configuration equals the JAX reader's: the axis maps,
    the window along z, the attributes."""
    from warpx_tpu.core.deck import config_from_deck as j_config_from_deck
    from warpx_tpu.utils.parser import Deck as JDeck

    text = LWFA_1D.format(steps=5)
    got = config_from_deck(Deck.from_string(text))
    ref = port_config(j_config_from_deck(JDeck.from_string(text)))
    assert got == dataclasses.replace(ref)
    assert got.moving_window_dir == 0 and got.geometry.ndim == 1
    assert got.species[0].attributes == (
        ("initialenergy", "ux*ux + uy*uy + uz*uz + z*1.e12", False),
        ("regionofinterest", "(z>-2.0e-6) * (z<3.0e-6)", True))
