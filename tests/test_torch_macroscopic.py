"""The macroscopic medium (algo.em_solver_medium = macroscopic) in the port
against the JAX package and ``tests/test_macroscopic.py``'s closed forms.

``MacroscopicMedium.create`` (constant and parsed sigma, epsilon, mu; both
sigma methods) and ``evolve_e_macroscopic`` at 1e-12; the uniform
conductor's damping against alpha^n (both methods), the vacuum identity,
the dielectric's dispersion (its two gates) and the parsed sigma profile,
each beside the JAX run; a run with particles and a deck.  CPU, float64.
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
from warpx_tpu.solvers import macroscopic as jmac
from warpx_tpu.solvers.yee import compute_dt_yee
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.grid import yee_staggering
from warpx_tpu_torch.core.state import FieldState
from warpx_tpu_torch.solvers import macroscopic as mac
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_models_util import (assert_runs_agree, port_config,
                                     rel_err, run_both)

c = constants.c
ep0 = constants.ep0
NAMES = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")


def _cfg(n=16, sigma=None, eps=None, method="backwardeuler", **kw):
    geom = JGeometry(3, (n, n, n), (0.0,) * 3, (1.0,) * 3, (True,) * 3)
    return JSimConfig(
        geometry=geom, max_step=10, dt=compute_dt_yee(geom, 0.9),
        em_solver_medium="macroscopic", macroscopic_sigma_method=method,
        macro_sigma=sigma, macro_epsilon=eps, use_filter=False,
        tiled_particles="off", **kw)


def _sims(jcfg):
    """Both packages' simulations of ``jcfg``, initialized."""
    jsim = JSimulation(jcfg)
    jsim.init()
    sim = warpx_tpu_torch.Simulation(port_config(jcfg), dtype=torch.float64,
                                     device="cpu")
    sim.init()
    return jsim, sim


def _set_fields(jsim, sim, **arrs):
    jsim.state = jsim.state.replace(fields=jsim.state.fields.replace(
        **{k: jnp.asarray(v) for k, v in arrs.items()}))
    sim.state = sim.state.replace(fields=sim.state.fields.replace(
        **{k: torch.from_numpy(np.asarray(v, np.float64))
           for k, v in arrs.items()}))


def _steps(jsim, sim, n):
    """``n`` of each package's own step (no half-pushes)."""
    for _ in range(n):
        jsim.state = jsim._step(jsim.state)
        sim.state = sim.step(sim.state)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("method", ["backwardeuler", "laxwendroff"])
@pytest.mark.parametrize("parsed", [False, True])
def test_medium_and_e_update_match_jax(ndim, method, parsed):
    n = (8, 6, 10)[:ndim] if ndim == 3 else (8, 10)
    lo, hi = (0.0,) * ndim, (1.0,) * ndim
    jg = JGeometry(ndim, n, lo, hi, (True,) * ndim)
    fn = dict(macro_sigma_function="1.e-2*(1+sin(2*pi*x))*(z>0.3)",
              macro_epsilon_function="8.8541878128e-12*(2+z)",
              macro_mu_function="1.25663706212e-6*(1+0.5*x)") if parsed else dict(
        macro_sigma=3e-3, macro_epsilon=3 * ep0, macro_mu=None)
    jcfg = JSimConfig(geometry=jg, max_step=1, dt=compute_dt_yee(jg, 0.5),
                      em_solver_medium="macroscopic",
                      macroscopic_sigma_method=method, **fn)
    cfg = port_config(jcfg)
    ref = jmac.MacroscopicMedium.create(jcfg, j_yee_staggering(ndim))
    got = mac.MacroscopicMedium.create(cfg, yee_staggering(ndim))
    for a, b in zip(got.alpha + got.beta + (got.inv_mu,),
                    ref.alpha + ref.beta + (ref.inv_mu,)):
        assert rel_err(a.numpy(), b) <= 1e-12
    rng = np.random.default_rng(ndim)
    a = {nm: rng.normal(size=n) * (1e-8 if nm[0] == "B" else 1.0)
         for nm in NAMES}
    jf = JFieldState(**{k: jnp.asarray(v) for k, v in a.items()})
    tf = FieldState(**{k: torch.from_numpy(v) for k, v in a.items()})
    out_j = jmac.evolve_e_macroscopic(jf, ref, jg, jcfg.dt)
    out_t = mac.evolve_e_macroscopic(tf, got, cfg.geometry, cfg.dt)
    for nm in ("Ex", "Ey", "Ez"):
        assert rel_err(getattr(out_t, nm).numpy(),
                       getattr(out_j, nm)) <= 1e-12, nm


@pytest.mark.parametrize("method", ["backwardeuler", "laxwendroff"])
def test_uniform_conductor_damping(method):
    """A uniform Ex in a uniform conductor falls as alpha^n exactly."""
    sigma = 5.0e-3
    jsim, sim = _sims(_cfg(sigma=sigma, method=method))
    ones = np.ones(sim.state.fields.Ex.shape)
    _set_fields(jsim, sim, Ex=ones)
    _steps(jsim, sim, 10)
    fac = sigma * sim.cfg.dt / ep0
    alpha = ((1 - 0.5 * fac) / (1 + 0.5 * fac) if method == "laxwendroff"
             else 1.0 / (1 + fac))
    ex = sim.state.fields.Ex.numpy()
    assert abs(ex.mean() - alpha ** 10) < 1e-12 * alpha ** 10
    assert ex.std() < 1e-12
    assert rel_err(ex, jsim.state.fields.Ex) <= 1e-12


def test_vacuum_medium_matches_vacuum_solver():
    """sigma = 0, eps = ep0, mu = mu0 through the medium equals the plain
    Yee advance to roundoff, in each package."""
    k = 2 * np.pi
    z = np.arange(16) / 16.0
    ex = np.tile(np.sin(k * z), (16, 16, 1))
    runs = {}
    for medium in ("macroscopic", "vacuum"):
        cfg = _cfg()
        if medium == "vacuum":
            cfg = dataclasses.replace(cfg, em_solver_medium="vacuum")
        jsim, sim = _sims(cfg)
        _set_fields(jsim, sim, Ex=ex, By=ex / c)
        _steps(jsim, sim, 8)
        runs[medium] = (sim.state.fields.Ex.numpy(), jsim.state.fields.Ex)
    a, b = runs["macroscopic"][0], runs["vacuum"][0]
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(a).max())
    for got, ref in runs.values():
        assert rel_err(got, ref) <= 1e-12


def test_dielectric_phase_velocity():
    """A standing wave in eps = 4 eps0: the scheme's omega against the Yee
    dispersion in the dielectric (1e-9) and against k c/2 (5e-3), and the
    port's samples against the JAX run's."""
    n, lx, eps_r, m = 64, 1.0, 4.0, 2
    geom = JGeometry(3, (4, 4, n), (0.0,) * 3, (lx / 16, lx / 16, lx),
                     (True,) * 3)
    dt = compute_dt_yee(geom, 0.5)
    jsim, sim = _sims(JSimConfig(
        geometry=geom, max_step=10, dt=dt, em_solver_medium="macroscopic",
        macro_epsilon=eps_r * ep0, use_filter=False, tiled_particles="off"))
    k = 2 * np.pi * m / lx
    zc = np.arange(n) / n * lx
    _set_fields(jsim, sim, Ex=np.tile(np.cos(k * zc), (4, 4, 1)))
    samples, ref = [], []
    for _ in range(20):
        samples.append(np.fft.fft(sim.state.fields.Ex.numpy()[0, 0])[m].real)
        ref.append(np.fft.fft(np.asarray(jsim.state.fields.Ex)[0, 0])[m].real)
        _steps(jsim, sim, 1)
    s = np.array(samples)
    assert rel_err(s, np.array(ref)) <= 1e-12
    w_meas = np.arccos(np.median((s[2:] + s[:-2]) / (2.0 * s[1:-1]))) / dt
    v = c / np.sqrt(eps_r)
    dz = lx / n
    w_theory = 2.0 / dt * np.arcsin(v * dt / dz * np.sin(k * dz / 2.0))
    assert abs(w_meas - w_theory) / w_theory < 1e-9
    assert abs(w_meas - k * v) / (k * v) < 5e-3


def test_parsed_sigma_profile():
    """A parsed constant equals the constant exactly; a conductor over
    z > 0.5 damps there only; both beside the JAX run."""
    outs = {}
    for name, cfg in (
            ("const", _cfg(sigma=5.0e-3)),
            ("parsed", dataclasses.replace(
                _cfg(), macro_sigma_function="5.0e-3 + 0*z")),
            ("half", dataclasses.replace(
                _cfg(), macro_sigma_function="5.0e-3*(z>0.5)"))):
        jsim, sim = _sims(cfg)
        _set_fields(jsim, sim, Ex=np.ones(sim.state.fields.Ex.shape))
        _steps(jsim, sim, 4)
        outs[name] = sim.state.fields.Ex.numpy()
        assert rel_err(outs[name], jsim.state.fields.Ex) <= 1e-12
    np.testing.assert_array_equal(outs["const"], outs["parsed"])
    fac = 5.0e-3 * _cfg().dt / ep0
    left = outs["half"][:, :, 4].mean()
    right = outs["half"][:, :, 12].mean()
    assert abs(right - (1 / (1 + fac)) ** 4) < 1e-3
    assert right < 0.9 < left


def test_plasma_in_a_medium_run_matches_jax():
    """Particles, J and the medium together over 3 steps."""
    sp = JSpeciesConfig(
        name="electrons", charge=-constants.q_e, mass=constants.m_e,
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=(1, 1, 1), profile="constant",
        density=1e10, momentum_distribution="gaussian", ux_th=1e-2,
        uy_th=1e-2, uz_th=1e-2)
    cfg = _cfg(n=8, sigma=5e-3, eps=2 * ep0, method="laxwendroff",
               species=(sp,))
    jsim, sim = run_both(cfg, 3)
    assert not sim.binned
    assert_runs_agree(jsim, sim)


MEDIUM_DECK = """
max_step = 3
amr.n_cell = 8 8 8
geometry.dims = 3
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 1. 1. 1.
warpx.cfl = 0.9
warpx.use_filter = 0
algo.em_solver_medium = macroscopic
algo.macroscopic_sigma_method = laxwendroff
macroscopic.sigma_function(x,y,z) = "1.e-3*(z>0.5)"
macroscopic.epsilon = 2.*8.8541878128e-12
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.profile = constant
electrons.density = 1.e10
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.01
electrons.uy_th = 0.01
electrons.uz_th = 0.01
"""


def test_medium_deck_runs_through_from_deck():
    jsim = JSimulation(j_config_from_deck(JDeck.from_string(MEDIUM_DECK)))
    jsim.init()
    jsim.evolve()
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(MEDIUM_DECK), dtype=torch.float64, device="cpu")
    assert sim.cfg.em_solver_medium == "macroscopic"
    assert sim.cfg.macroscopic_sigma_method == "laxwendroff"
    assert sim.medium is not None
    sim.init()
    sim.evolve()
    assert_runs_agree(jsim, sim)
