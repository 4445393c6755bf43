"""The cold fluid species of the port (``warpx_tpu_torch/solvers/
fluids.py`` and the fluid branch of ``core/step.py::pic_step``) against the
JAX package's (``warpx_tpu/solvers/fluids.py``, ``core/step.py``) on the CPU
in float64: each fluid function, 2D and 3D Langmuir-fluid decks through
``Simulation.from_deck``, fluids beside particles, the binned gate sending
fluids per particle, the fluid charge in the rho output, and a fluid
checkpoint and restart."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.config import SpeciesConfig as JSpeciesConfig
from warpx_tpu.core.deck import config_from_deck as j_config_from_deck
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.grid import yee_staggering as j_yee_staggering
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.core.state import FieldState as JFieldState
from warpx_tpu.diagnostics.fields import deposit_total_rho as j_total_rho
from warpx_tpu.solvers import fluids as jfl
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.binned_step import binned_supported
from warpx_tpu_torch.core.config import SpeciesConfig
from warpx_tpu_torch.core.grid import Geometry, yee_staggering
from warpx_tpu_torch.core.state import FieldState, state_to_numpy
from warpx_tpu_torch.diagnostics.fields import deposit_total_rho
from warpx_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from warpx_tpu_torch.solvers import fluids as fl
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_models_util import (RTOL, assert_runs_agree, port_config,
                                     rel_err)

LANGMUIR = """
max_step = {steps}
amr.n_cell = {cells}
geometry.dims = {dims}
geometry.prob_lo = {lo}
geometry.prob_hi = {hi}
warpx.cfl = 0.8
warpx.use_filter = {filt}
algo.current_deposition = esirkepov
my_constants.pi = 3.141592653589793
my_constants.k0 = 2*pi/20.e-6
fluids.species_names = electrons
electrons.charge = -q_e
electrons.mass = m_e
electrons.profile = parse_density_function
electrons.density_function(x,y,z) = "2.e24*(1 + 0.01*cos(k0*x))"
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "0.01*sin(k0*x)"
electrons.momentum_function_uy(x,y,z) = "0.002*cos(k0*z)"
electrons.momentum_function_uz(x,y,z) = "0.005*sin(k0*z)"
{extra}
"""

IONS = """
particles.species_names = ions
ions.species_type = proton
ions.injection_style = NUniformPerCell
ions.num_particles_per_cell_each_dim = {ppc}
ions.profile = constant
ions.density = 2.e24
ions.momentum_distribution_type = constant
ions.ux = 0.001
"""


def deck_text(dims, steps=4, filt=0, extra=""):
    n = 16
    return LANGMUIR.format(steps=steps, cells=f"{n} " * dims, dims=dims,
                           lo="-10.e-6 " * dims, hi="10.e-6 " * dims,
                           filt=filt, extra=extra)


def both_from_deck(text, steps, tmp_path=None):
    jsim = JSimulation.from_deck(JDeck.from_string(text))
    jsim.init()
    jsim.evolve(steps)
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float64, device="cpu")
    sim.init()
    sim.evolve(steps)
    return jsim, sim


def assert_fluids_agree(jsim, sim, rtol=RTOL):
    for k, ref in jsim.state.aux.items():
        if k.startswith("fluid_"):
            ref = np.asarray(ref)
            scale = np.abs(ref).max() if "_N:" in k else max(
                np.abs(np.asarray(v)).max() for kk, v in jsim.state.aux.items()
                if kk.startswith("fluid_NU"))
            assert rel_err(sim.state.aux[k].numpy(), ref, scale) <= rtol, k


# ------------------------------------------------------------ the functions
def _setup(ndim, seed):
    rng = np.random.default_rng(seed)
    n_cell = (12, 10) if ndim == 2 else (8, 6, 10)
    lo = (-1.0e-6,) * ndim
    hi = tuple(l + 0.1e-6 * n for l, n in zip(lo, n_cell))
    jg = JGeometry(ndim, n_cell, lo, hi, (True,) * ndim)
    g = Geometry(ndim, n_cell, lo, hi, (True,) * ndim)
    N = 1e24 * (1.0 + 0.3 * rng.standard_normal(n_cell))
    N[(0,) * ndim] = -1.0e20  # a node the positivity and prim guards see
    NU = [N * 3e7 * rng.standard_normal(n_cell) for _ in range(3)]
    F = {nm: rng.standard_normal(n_cell) * (1e9 if nm[0] == "E" else 3.0)
         for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")}
    return jg, g, N, NU, F


@pytest.mark.parametrize("ndim", [2, 3])
def test_fluid_functions_match_jax(ndim):
    jg, g, N, NU, F = _setup(ndim, 11 + ndim)
    q, m, dt = -1.602176634e-19, 9.1093837015e-31, 1.0e-16
    jsp = JSpeciesConfig(name="e", charge=q, mass=m)
    sp = SpeciesConfig(name="e", charge=q, mass=m)
    t = torch.from_numpy
    jN, jNU = jnp.asarray(N), tuple(jnp.asarray(a) for a in NU)
    tN, tNU = t(N), tuple(t(a) for a in NU)
    jf = JFieldState(**{k: jnp.asarray(v) for k, v in F.items()})
    tf = FieldState(**{k: t(v) for k, v in F.items()})
    js, ts = j_yee_staggering(ndim), yee_staggering(ndim)

    ref = jfl.fluid_gather_push(jN, jNU, jf, jg, js, jsp, dt)
    got = fl.fluid_gather_push(tN, tNU, tf, g, ts, sp, dt)
    for a, b in zip(got, ref):
        assert rel_err(a.numpy(), np.asarray(b)) <= RTOL
    ref = jfl.fluid_advect(jN, jNU, jg, dt)
    got = fl.fluid_advect(tN, tNU, g, dt)
    assert rel_err(got[0].numpy(), np.asarray(ref[0])) <= RTOL
    for a, b in zip(got[1], ref[1]):
        assert rel_err(a.numpy(), np.asarray(b)) <= RTOL
    ref = jfl.fluid_evolve(jN, jNU, jf, jg, js, jsp, dt)
    got = fl.fluid_evolve(tN, tNU, tf, g, ts, sp, dt)
    assert rel_err(got[0].numpy(), np.asarray(ref[0])) <= RTOL
    for a, b in zip(got[1], ref[1]):
        assert rel_err(a.numpy(), np.asarray(b)) <= RTOL
    ref = jfl.fluid_current(jN, jNU, jg, js, q)
    got = fl.fluid_current(tN, tNU, g, ts, q)
    for a, b in zip(got, ref):
        assert rel_err(a.numpy(), np.asarray(b)) <= RTOL
    np.testing.assert_array_equal(fl.fluid_rho(tN, q).numpy(),
                                  np.asarray(jfl.fluid_rho(jN, q)))


@pytest.mark.parametrize("ndim", [2, 3])
def test_init_fluid_matches_jax(ndim):
    text = deck_text(ndim)
    jcfg = j_config_from_deck(JDeck.from_string(text))
    cfg = port_config(jcfg)
    (jsp,), (sp,) = jcfg.fluids, cfg.fluids
    assert sp.profile == "parse_density_function" and sp.momentum_exprs
    jN, jNU = jfl.init_fluid(jsp, jcfg.geometry, jnp.float64)
    N, NU = fl.init_fluid(sp, cfg.geometry, torch.float64, "cpu")
    assert rel_err(N.numpy(), np.asarray(jN)) <= RTOL
    for a, b in zip(NU, jNU):
        assert rel_err(a.numpy(), np.asarray(b)) <= RTOL


# ------------------------------------------------------------ whole runs
@pytest.mark.parametrize("ndim,filt", [(2, 0), (3, 0), (2, 1)])
def test_langmuir_fluid_deck_matches_jax(ndim, filt):
    """A Langmuir wave of a cold fluid, 4 steps from the deck in both
    packages: fields, fluid state and checksums to 1e-9 (the filter on J
    too in the last case)."""
    jsim, sim = both_from_deck(deck_text(ndim, filt=filt), 4)
    assert not sim.binned
    assert_fluids_agree(jsim, sim)
    assert_runs_agree(jsim, sim)


def test_fluid_beside_particles_matches_jax():
    text = deck_text(2, extra=IONS.format(ppc="1 1"))
    jsim, sim = both_from_deck(text, 3)
    assert_fluids_agree(jsim, sim)
    assert_runs_agree(jsim, sim)
    # the fluid's charge joins the particles' in the rho output
    ref = np.asarray(j_total_rho(jsim.state, jsim.cfg))
    got = deposit_total_rho(sim.state, sim.cfg).numpy()
    assert rel_err(got, ref) <= RTOL


def test_binned_gate_sends_fluids_per_particle():
    """The JAX package's periodic gate passes fluids, and its binned step
    has no fluid code; the port's gate keeps them per particle."""
    text = deck_text(2, extra=IONS.format(ppc="1 1"))
    cfg = warpx_tpu_torch.core.deck.config_from_deck(Deck.from_string(text))
    assert cfg.tiled_particles == "auto" and cfg.fluids
    assert not binned_supported(cfg)
    assert binned_supported(dataclasses.replace(cfg, fluids=()))
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
    assert not sim.binned


def test_fluid_checkpoint_restart(tmp_path):
    """Two steps, a checkpoint, a restart and two more give the fluid state
    of four straight steps, bit for bit."""
    text = deck_text(2, steps=4, extra=IONS.format(ppc="1 1"))

    def fresh():
        sim = warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(text), dtype=torch.float64, device="cpu")
        sim.init()
        return sim

    straight = fresh()
    straight.evolve(4)
    ref = state_to_numpy(straight.state)
    first = fresh()
    first.evolve(2)
    save_checkpoint(str(tmp_path / "chk"), first.state,
                    first.is_synchronized)
    again = fresh()
    again.state, again.is_synchronized = load_checkpoint(
        str(tmp_path / "chk"), again.state)
    assert any(k.startswith("fluid_NUz:") for k in again.state.aux)
    again.evolve(2)
    got = state_to_numpy(again.state)
    assert got["step"] == 4
    for k, a in ref["aux"].items():
        np.testing.assert_array_equal(got["aux"][k], a, err_msg=k)
    for nm, a in ref["fields"].items():
        np.testing.assert_array_equal(got["fields"][nm], a, err_msg=nm)
