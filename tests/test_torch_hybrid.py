"""The Ohm's-law hybrid-PIC solver in the port against the JAX package.

``electron_pressure``, ``ohm_solve_e`` (Hall, pressure, resistive and
hyper-resistive terms, an external current) on the analytic fields of
``tests/test_hybrid.py`` laid on 2D and 3D grids (the JAX package's own
hybrid tests are 1D: their Ohm's-law terms and a 1D hybrid run are held in
``tests/test_torch_dims1.py``) and
on seeded fields, ``_rk4_b``, ``hybrid_evolve_fields`` and
``hybrid_initial_e``, each at 1e-9; whole 2D and 3D hybrid ``Simulation``
runs of 3 steps (the initial deposit into ``hrho``/``hj*`` included) and a
deck with ``algo.maxwell_solver = hybrid``.  CPU, float64.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu import constants
from warpx_tpu.core.config import SimConfig as JSimConfig
from warpx_tpu.core.config import SpeciesConfig as JSpeciesConfig
from warpx_tpu.core.deck import config_from_deck as j_config_from_deck
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.grid import yee_staggering as j_yee_staggering
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.core.state import FieldState as JFieldState
from warpx_tpu.solvers import hybrid as jhyb
from warpx_tpu.utils.expression import compile_expression as j_compile
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.grid import Geometry, yee_staggering
from warpx_tpu_torch.core.state import FieldState
from warpx_tpu_torch.solvers import hybrid as hyb
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_models_util import (assert_runs_agree, port_config,
                                     rel_err, run_both)

q_e = constants.q_e
mu0 = constants.mu0
NAMES = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")
N0 = 1e20


def _geoms(ndim):
    n = (8, 6, 10) if ndim == 3 else (12, 16)
    lo, hi = (0.0,) * ndim, tuple(1.0 + 0.2 * d for d in range(ndim))
    return (JGeometry(ndim, n, lo, hi, (True,) * ndim),
            Geometry(ndim=ndim, n_cell=n, prob_lo=lo, prob_hi=hi,
                     periodic=(True,) * ndim))


def _cfg(jg, **kw):
    base = dict(max_step=1, dt=1e-9, species=(), em_solver="hybrid",
                hybrid_elec_temp=50.0, hybrid_n0_ref=N0, hybrid_gamma=2.0,
                hybrid_n_floor=N0 * 1e-3)
    base.update(kw)
    jcfg = JSimConfig(geometry=jg, **base)
    return jcfg, port_config(jcfg)


def _seeded(jg, seed):
    """Seeded B (a guide field along z plus noise), E, J, ion current and a
    positive nodal rho of ~q_e n0."""
    rng = np.random.default_rng(seed)
    a = {nm: rng.normal(size=jg.n_cell) * (1e-3 if nm[0] == "B" else 1.0)
         for nm in NAMES}
    a["Bz"] = a["Bz"] + 0.2
    ji = tuple(rng.normal(size=jg.n_cell) * 1e3 for _ in range(3))
    rho = q_e * N0 * (1.0 + 0.2 * rng.random(size=jg.n_cell))
    return a, ji, rho


def _both(a):
    return (JFieldState(**{nm: jnp.asarray(v) for nm, v in a.items()}),
            FieldState(**{nm: torch.from_numpy(v) for nm, v in a.items()}))


def _t3(ts):
    return tuple(torch.from_numpy(np.asarray(t)) for t in ts)


def _j3(ts):
    return tuple(jnp.asarray(t) for t in ts)


def _assert_e(got, ref, tol=1e-9):
    for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
        assert rel_err(getattr(got, nm).numpy(),
                       getattr(ref, nm)) <= tol, nm


def test_electron_pressure_matches_jax():
    jg, _ = _geoms(2)
    jcfg, cfg = _cfg(jg)
    rho = q_e * N0 * np.random.default_rng(0).random(size=jg.n_cell)
    rho[0, 0] = -1.0  # clamped to zero density
    got = hyb.electron_pressure(torch.from_numpy(rho), cfg).numpy()
    assert rel_err(got, jhyb.electron_pressure(jnp.asarray(rho), jcfg)) \
        <= 1e-12


@pytest.mark.parametrize("ndim", [2, 3])
def test_hall_and_pressure_terms_on_analytic_fields(ndim):
    """tests/test_hybrid.py's analytic fields along z on a 2D/3D grid: the
    Hall term of By = dB sin(kz) in Bz = B0 is Ey = -J_x B0 / rho, J_x the
    discrete curl of By; the pressure term of a graded density is
    -dPe/dz / rho at the Ez sites."""
    jg, tg = _geoms(ndim)
    stag, jstag = yee_staggering(ndim), j_yee_staggering(ndim)
    jcfg, cfg = _cfg(jg, hybrid_elec_temp=0.0, hybrid_n_floor=1.0)
    nz, L = jg.n_cell[-1], jg.prob_hi[-1]
    dz, k = L / nz, 2 * np.pi / L
    zc = (np.arange(nz) + 0.5) * dz
    zn = np.arange(nz) * dz
    B0, dB, rho0 = 0.2, 0.02, q_e * N0
    zeros = np.zeros(jg.n_cell)
    a = {nm: zeros for nm in NAMES}
    a["By"] = np.broadcast_to(dB * np.sin(k * zc), jg.n_cell).copy()
    a["Bz"] = np.full(jg.n_cell, B0)
    jf, tf = _both(a)
    ji = (zeros,) * 3
    rho = np.full(jg.n_cell, rho0)
    got = hyb.ohm_solve_e(tf, _t3(ji), torch.from_numpy(rho), tg, stag, cfg)
    ref = jhyb.ohm_solve_e(jf, _j3(ji), jnp.asarray(rho), jg, jstag, jcfg)
    _assert_e(got, ref)
    # the discrete curl: By's difference across each Ex node
    jx_th = -dB * (np.sin(k * zc) - np.sin(k * (zc - dz))) / dz / mu0
    ey_th = np.broadcast_to(-jx_th * B0 / rho0, jg.n_cell)
    assert rel_err(got.Ey.numpy(), ey_th) <= 1e-10
    # the pressure term: a graded density, Te > 0, B = 0
    jcfg2, cfg2 = _cfg(jg, hybrid_elec_temp=100.0, hybrid_n_floor=1.0)
    prof = np.broadcast_to(1.0 + 0.1 * np.sin(k * zn), jg.n_cell)
    rho2 = rho0 * prof
    jf0, tf0 = _both({nm: zeros for nm in NAMES})
    got2 = hyb.ohm_solve_e(
        tf0, _t3(ji), torch.from_numpy(rho2), tg, stag, cfg2,
        Pe=hyb.electron_pressure(torch.from_numpy(rho2), cfg2),
        solve_for_Faraday=False)
    ref2 = jhyb.ohm_solve_e(
        jf0, _j3(ji), jnp.asarray(rho2), jg, jstag, jcfg2,
        Pe=jhyb.electron_pressure(jnp.asarray(rho2), jcfg2),
        solve_for_Faraday=False)
    _assert_e(got2, ref2)
    pe = N0 * 100.0 * q_e * prof ** 2
    dpe = (np.roll(pe, -1, -1) - pe) / dz
    rho_at = 0.5 * (rho2 + np.roll(rho2, -1, -1))
    assert rel_err(got2.Ez.numpy(), -dpe / rho_at) <= 1e-8


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("eta,eta_h,jext", [
    ("1.e-4", 0.0, False), ("1.e-4*rho/(1.6e1)+1.e-9*J", 1e-6, False),
    ("0", 0.0, True)])
def test_ohm_solve_e_matches_jax(ndim, eta, eta_h, jext):
    """Hall, resistive (constant, and rho- and |J|-dependent) and
    hyper-resistive terms, and an external current, on seeded fields."""
    jg, tg = _geoms(ndim)
    stag, jstag = yee_staggering(ndim), j_yee_staggering(ndim)
    kw = dict(hybrid_eta=eta, hybrid_eta_h=eta_h,
              hybrid_resistivity_has_J="J" in eta)
    if jext:
        kw["hybrid_j_ext"] = ("1.e3*sin(2*pi*z)", "", "5.e2*x")
    jcfg, cfg = _cfg(jg, **kw)
    a, ji, rho = _seeded(jg, 3 + ndim)
    jf, tf = _both(a)
    jeta = j_compile(eta, ("rho", "J"), {})
    teta = hyb.resistivity(cfg)
    for faraday in (True, False):
        pe_t = None if faraday else hyb.electron_pressure(
            torch.from_numpy(rho), cfg)
        pe_j = None if faraday else jhyb.electron_pressure(jnp.asarray(rho),
                                                           jcfg)
        got = hyb.ohm_solve_e(tf, _t3(ji), torch.from_numpy(rho), tg, stag,
                              cfg, eta_fn=teta, Pe=pe_t,
                              solve_for_Faraday=faraday)
        ref = jhyb.ohm_solve_e(jf, _j3(ji), jnp.asarray(rho), jg, jstag,
                               jcfg, eta_fn=jeta, Pe=pe_j,
                               solve_for_Faraday=faraday)
        _assert_e(got, ref)


@pytest.mark.parametrize("ndim", [2, 3])
def test_rk4_and_field_advance_match_jax(ndim):
    jg, tg = _geoms(ndim)
    stag, jstag = yee_staggering(ndim), j_yee_staggering(ndim)
    jcfg, cfg = _cfg(jg, hybrid_eta="1.e-5", hybrid_substeps=3)
    a, ji, rho = _seeded(jg, 9)
    _, ji2, rho2 = _seeded(jg, 10)
    jf, tf = _both(a)
    jeta = j_compile(jcfg.hybrid_eta, ("rho", "J"), {})
    teta = hyb.resistivity(cfg)
    dt = 1e-9
    _assert_e(hyb._rk4_b(tf, _t3(ji), torch.from_numpy(rho), tg, stag, cfg,
                         teta, dt),
              jhyb._rk4_b(jf, _j3(ji), jnp.asarray(rho), jg, jstag, jcfg,
                          jeta, dt))
    _assert_e(hyb.hybrid_evolve_fields(
        tf, torch.from_numpy(rho), torch.from_numpy(rho2), _t3(ji),
        _t3(ji2), tg, stag, cfg, teta, dt),
        jhyb.hybrid_evolve_fields(
            jf, jnp.asarray(rho), jnp.asarray(rho2), _j3(ji), _j3(ji2), jg,
            jstag, jcfg, jeta, dt))
    _assert_e(hyb.hybrid_initial_e(tf, torch.from_numpy(rho), _t3(ji), tg,
                                   stag, cfg, teta),
              jhyb.hybrid_initial_e(jf, jnp.asarray(rho), _j3(ji), jg, jstag,
                                    jcfg, jeta))


def _plasma_cfg(ndim, steps=3, **kw):
    """A uniform thermal proton plasma with fluid electrons in a guide
    field along z and a shear perturbation (tests/test_hybrid.py's Alfven
    wave, on a 2D/3D grid), direct deposition, per particle."""
    n = (8, 6, 16) if ndim == 3 else (8, 16)
    L = 1.0
    geom = JGeometry(ndim, n, (0.0,) * ndim, (L / 2,) * (ndim - 1) + (L,),
                     (True,) * ndim)
    m_i = 1.67e-27
    B0 = 0.25
    wci = q_e * B0 / m_i
    sp = JSpeciesConfig(
        name="ions", charge=q_e, mass=m_i, injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=(2,) * ndim, profile="constant",
        density=N0, momentum_distribution="gaussian", ux_th=1e-5,
        uy_th=1e-5, uz_th=1e-5)
    base = dict(max_step=steps, dt=2e-3 * 2 * np.pi / wci, species=(sp,),
                em_solver="hybrid", current_deposition="direct",
                hybrid_elec_temp=10.0, hybrid_n0_ref=N0,
                hybrid_n_floor=N0 * 1e-3, hybrid_substeps=4,
                hybrid_eta="1.e-7", use_filter=True, tiled_particles="off",
                b_ext_grid=("parse", ("0", f"{0.02 * B0}*sin(2*pi*z/{L})",
                                      f"{B0}")))
    base.update(kw)
    return JSimConfig(geometry=geom, **base)


@pytest.mark.parametrize("ndim", [2, 3])
def test_hybrid_run_matches_jax(ndim):
    jcfg = _plasma_cfg(ndim)
    # the initial deposit into the hybrid temporaries
    jsim0 = JSimulation(jcfg)
    jsim0.init()
    sim0 = warpx_tpu_torch.Simulation(port_config(jcfg),
                                      dtype=torch.float64, device="cpu")
    sim0.init()
    for nm in ("hrho", "hjx", "hjy", "hjz"):
        assert rel_err(getattr(sim0.state.fields, nm).numpy(),
                       getattr(jsim0.state.fields, nm)) <= 1e-12, nm
    jsim, sim = run_both(jcfg, 3)
    assert not sim.binned
    assert_runs_agree(jsim, sim, fields=("hrho", "hjx", "hjy", "hjz"))
    assert float(sim.state.fields.Ey.abs().max()) > 0.0


def test_resistive_diffusion_rate():
    """tests/test_hybrid.py::test_resistive_diffusion_rate on a 4 x 64 grid:
    static ions, constant resistivity, no guide field: a By ~ sin(kz)
    perturbation diffuses as exp(-eta k^2 t / mu0) within 1 %, and the
    port's run agrees with the JAX run at 1e-9."""
    n, L, eta, dB = 64, 1.0, 1e-4, 1e-4
    k = 2 * np.pi / L
    rate = eta * k * k / mu0
    dt, steps = 0.02 / rate, 40
    geom = JGeometry(2, (4, n), (0.0, 0.0), (L / 16, L), (True, True))
    sp = JSpeciesConfig(
        name="ions", charge=q_e, mass=1.67e-27,
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=(1, 16), profile="constant",
        density=N0, momentum_distribution="at_rest", do_not_push=True,
        do_not_gather=True)
    zc = (np.arange(n) + 0.5) * (L / n)
    jcfg = JSimConfig(
        geometry=geom, max_step=steps, dt=dt, species=(sp,),
        em_solver="hybrid", current_deposition="direct",
        hybrid_elec_temp=0.0, hybrid_n0_ref=N0, hybrid_n_floor=N0 * 1e-3,
        hybrid_eta=str(eta), use_filter=False, tiled_particles="off",
        b_ext_grid=("parse", ("0", f"{dB}*sin(2*pi*z/{L})", "0")))
    jsim, sim = run_both(jcfg, steps)
    assert_runs_agree(jsim, sim, fields=("hrho",))
    by = sim.state.fields.By.numpy()
    amp = float(2.0 * np.mean(by * np.sin(k * zc)))
    assert abs(amp - dB * np.exp(-rate * dt * steps)) / dB < 0.01


HYBRID_DECK = """
max_step = 3
amr.n_cell = 8 16
geometry.dims = 2
geometry.prob_lo = 0. 0.
geometry.prob_hi = 0.5 1.
algo.maxwell_solver = hybrid
warpx.const_dt = 2.6e-9
warpx.use_filter = 0
hybrid_pic_model.elec_temp = 10.
hybrid_pic_model.n0_ref = 1.e20
hybrid_pic_model.n_floor = 1.e17
hybrid_pic_model.substeps = 4
hybrid_pic_model.plasma_resistivity(rho,J) = 1.e-7
warpx.B_ext_grid_init_style = constant
warpx.B_external_grid = 0. 0. 0.25
particles.species_names = ions
ions.species_type = proton
ions.injection_style = NUniformPerCell
ions.num_particles_per_cell_each_dim = 2 2
ions.profile = constant
ions.density = 1.e20
ions.momentum_distribution_type = gaussian
ions.ux_th = 1.e-5
ions.uy_th = 1.e-5
ions.uz_th = 1.e-5
"""


def test_hybrid_deck_runs_through_from_deck():
    jsim = JSimulation(j_config_from_deck(JDeck.from_string(HYBRID_DECK)))
    jsim.init()
    jsim.evolve()
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(HYBRID_DECK), dtype=torch.float64, device="cpu")
    assert sim.cfg.em_solver == "hybrid"
    assert sim.cfg.current_deposition == "direct"
    assert sim.cfg.hybrid_substeps == 4
    sim.init()
    sim.evolve()
    assert_runs_agree(jsim, sim, fields=("hrho", "hjx", "hjy", "hjz"))


def test_hybrid_on_a_bounded_domain_raises():
    """The JAX package's bounded step advances a hybrid run's fields by
    Yee (ROADMAP.md Queue C): the port refuses it."""
    cfg = dataclasses.replace(
        port_config(_plasma_cfg(2)), field_bc_lo=("periodic", "pec"),
        field_bc_hi=("periodic", "pec"))
    with pytest.raises(NotImplementedError, match=r"Queue C"):
        warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
