"""The Lorentz-boosted frame in the port against the JAX package.

The deck's conversion (geometry along the boost axis with and without the
moving window's contraction, the antenna's plane and ``z0_lab``), the
boosted initial particles bit for bit (the plasma's positions, weights and
uz, the Gaussian beam), the antenna's boosted update at 1e-12, and the
32 x 64 laser-wakefield deck at ``warpx.gamma_boost = 10`` tile-binned (sort
interval 1) and per particle against the JAX package's runs at 1e-9; the
boosted refusals name their items.  CPU, float64.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core import laser as jlaser
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.core.state import ParticleState as JParticleState
from warpx_tpu_torch.core import laser as tlaser
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.injection import columns_to_state
from warpx_tpu_torch.core.state import state_to_numpy
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import (LWFA_2D, assert_checksums,
                                      assert_close, assert_states_close,
                                      jax_config, jax_state_numpy,
                                      port_config, run_jax, run_port)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

BOOST = "warpx.gamma_boost = 10.\nwarpx.boost_direction = z\n"
DECK = LWFA_2D.replace("max_step = 12", "max_step = 6") + BOOST


def _port_from_deck(text, tiled="off"):
    return config_from_deck(Deck.from_string(
        text + f"\ntpu.tiled_particles = {tiled}\n"))


@pytest.mark.parametrize("window", ["1", "0"])
def test_boosted_config_matches_jax(window):
    """Every field of the converted configuration equals the JAX reader's:
    prob_lo/hi along z scaled by 1/(gamma (1 - beta beta_w)) (beta_w the
    window's speed, or beta itself without a window), the antenna at
    Z0_lab / gamma with its z0_lab, the boosted default v_galilean."""
    text = DECK
    if window == "0":
        text = re.sub(r"warpx\.(do_)?moving_window.*\n", "", DECK)
    text += "psatd.use_default_v_galilean = 1\n"
    ref = port_config(jax_config(text, "off"))
    got = _port_from_deck(text)
    for f in dataclasses.fields(ref):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    lab = _port_from_deck(LWFA_2D)
    assert got.geometry.prob_lo[1] < 9.9 * lab.geometry.prob_lo[1]
    assert got.geometry.prob_lo[0] == lab.geometry.prob_lo[0]
    assert got.lasers[0].z0_lab == -10.0e-6
    assert got.lasers[0].position[2] == pytest.approx(-1.0e-6, rel=1e-14)


@pytest.fixture(scope="module")
def jax_boosted():
    """The JAX package's per-particle and binned runs of the boosted deck
    (sort interval 1 for the binned one) and its initial state."""
    jsim_off, _ = run_jax(DECK, "off")
    text_on = DECK.replace("warpx.sort_intervals = 4",
                           "warpx.sort_intervals = 1")
    jsim_on, _ = run_jax(text_on, "on")
    init = JSimulation(dataclasses.replace(jsim_off.cfg))
    return {"off": jsim_off, "on": jsim_on,
            "init": jax_state_numpy(init.init())}


def test_boosted_initial_particles_bit_identical(jax_boosted):
    """The boosted plasma (ballistic correction of its bounds, boosted
    weights and uz), the mapped beam, the antenna and the PML splits equal
    the JAX package's to the bit."""
    sim = warpx_tpu_torch.Simulation(port_config(jax_boosted["off"].cfg),
                                     dtype=torch.float64, device="cpu")
    got = state_to_numpy(sim.init())
    ref = jax_boosted["init"]
    assert_states_close(got, ref, tol=0.0)
    uz = got["species"]["electrons"]["uz"][got["species"]["electrons"]
                                           ["alive"]]
    # a plasma at rest in the lab streams at -beta c in the boosted frame
    assert uz.size and np.all(uz < -0.99 * 10 * 299792458.0)


def test_boosted_antenna_matches_jax(jax_boosted):
    jcfg = jax_boosted["off"].cfg
    cfg = port_config(jcfg)
    assert (tlaser.boost_laser_position(cfg.lasers[0], 10.0)
            == jlaser.boost_laser_position(jcfg.lasers[0], 10.0))
    jps, _, jmob = jlaser.antenna_particles(jcfg.lasers[0], jcfg.geometry,
                                            np.float64)
    cols, _, mob = tlaser.antenna_particles(cfg.lasers[0], cfg.geometry,
                                            np.float64)
    jsp = JParticleState(**{k: jnp.asarray(getattr(jps, k))
                            for k in ("w", "ux", "uy", "uz", "alive", "x",
                                      "z")})
    sp = columns_to_state(cols, "cpu")
    las, jlas = cfg.lasers[0], jcfg.lasers[0]
    for t in (0.0, 2.3e-14, 1.1e-13):
        ref = jlaser.update_antenna(jsp, jlas, jcfg.geometry, jmob / 10.0,
                                    jnp.asarray(t), jcfg.dt, gamma_boost=10.0,
                                    z0_lab=jlas.z0_lab)
        got = tlaser.update_antenna(sp, las, cfg.geometry, mob / 10.0, t,
                                    cfg.dt, gamma_boost=10.0,
                                    z0_lab=las.z0_lab)
        for k in ("x", "z", "ux", "uy", "uz"):
            assert_close(getattr(got, k).numpy(), getattr(ref, k), (t, k))
    # the antenna recedes at -beta c
    assert float(got.uz.max()) < -0.99 * 10 * 299792458.0


@pytest.mark.parametrize("tiled", ["on", "off"])
def test_boosted_lwfa_matches_jax(jax_boosted, tiled):
    """The boosted deck after 6 steps, tile-binned (K1c's plain version,
    sort interval 1) and per particle: checksums at 1e-9, the window and
    the plasma's count as the JAX package's, no overflow or violation."""
    jsim = jax_boosted[tiled]
    sim = run_port(port_config(jsim.cfg))
    assert sim.binned == (tiled == "on") and sim.cfg.gamma_boost == 10.0
    assert_checksums(jsim.checksums(), sim.checksums())
    for k in ("window_lo", "window_hi", "window_x"):
        assert float(sim.state.aux[k]) == float(jsim.state.aux[k]), k
    assert float(sim.state.aux["inject_pos:electrons"]) == pytest.approx(
        float(jsim.state.aux["inject_pos:electrons"]), rel=1e-13)
    alive = {nm: int(sp.alive.sum()) for nm, sp in sim.state.species.items()}
    assert alive == {nm: int(sp.alive.sum())
                     for nm, sp in jsim.state.species.items()}
    if tiled == "on":
        assert sim.tile_spec.interval == 1
        assert int(sim.state.aux["tile_overflow"]) == 0
        assert int(sim.state.aux["tile_violations"]) == 0


@pytest.mark.parametrize("extra,item", [
    pytest.param("fluids.species_names = f1\n", "Queue C",
                 id="fluids.species_names = f1\n-Queue A 11.3"),
    # the lattice in a boosted frame keeps the JAX reader's refusal, rigid
    # injection runs since Queue A 11.4 (the cases keep their ids)
    pytest.param("lattice.elements = q1\n", "Queue C",
                 id="lattice.elements = q1\n-Queue A 11.4"),
    pytest.param("particles.rigid_injected_species = beam\n"
                 "beam.zinject_plane = -13.e-6\n", "runs",
                 id="electrons.zinject_plane = 0.\n-Queue A 11.4"),
    ("particles.use_fdtd_nci_corr = 1\n", "Queue A 11.3"),
])
def test_boosted_refusals_name_their_items(extra, item):
    """Fluids and the lattice in a boosted frame keep the JAX package's
    refusals (both name Queue C; the cases keep their ids).  The NCI
    corrector runs since Queue A 11.3's first half, rigid injection since
    Queue A 11.4: their cases (which keep their ids) run the boosted deck
    through them for two steps."""
    text = DECK + extra
    if "nci" in extra or item == "runs":
        cfg = _port_from_deck(text)
        assert (cfg.use_nci_corr or cfg.species[1].zinject_plane
                is not None) and cfg.gamma_boost > 1.0
        sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64,
                                         device="cpu")
        sim.init()
        sim.evolve(2)
        assert sim.state.step == 2
        assert all(bool(torch.isfinite(getattr(sim.state.fields, nm)).all())
                   for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"))
        return
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md {re.escape(item)}\)"):
        _port_from_deck(text)
