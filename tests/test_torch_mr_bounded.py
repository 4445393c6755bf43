"""Mesh refinement on the bounded step (``core/bounded_step.py`` with
``core/mr.py``'s patch) against the JAX package on the CPU in float64.

The 32 x 64 laser-wakefield deck of ``tests/test_binned_bounded.py`` (PML
faces, a moving window at c, a laser antenna, continuous injection, a
Gaussian beam, the filter, order 3) with a ratio-2 patch that rides the
window and ``warpx.refine_plasma`` on, per particle, as the JAX package
runs it; also with momentum-conserving gathering.  Fields, PML and patch
state, particles and the lev=0 and lev=1 checksums within 1e-9; a
checkpoint under the moving window that restarts onto the same
trajectory; the JAX package's refusals of the bounded step mirrored.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.deck import config_from_deck as jax_config_from_deck
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.state import state_to_numpy
from warpx_tpu_torch.io.checkpoint import load_checkpoint
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import (LWFA_2D, assert_checksums,
                                      jax_state_numpy, port_config)
from .test_torch_mr import close

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

# a 16 x 24 coarse-cell patch around the laser (x in [-7.5, 7.5] um, z in
# [-17.4, -4.6] um after blocking), riding the window; refined injection
MR = """
amr.max_level = 1
amr.ref_ratio = 2
warpx.fine_tag_lo = -7.5e-6 -17.e-6
warpx.fine_tag_hi = 7.5e-6 -5.e-6
warpx.refine_plasma = 1
tpu.tiled_particles = off
"""
DECKS = {
    "window_refine": LWFA_2D + MR,
    "window_momentum_conserving": LWFA_2D.replace(
        "max_step = 12", "max_step = 4") + MR
    + "algo.field_gathering = momentum-conserving\n",
}


@functools.lru_cache(maxsize=None)
def jax_run(name):
    sim = JSimulation(jax_config_from_deck(JDeck.from_string(DECKS[name])))
    sim.init()
    sim.evolve()
    return sim, jax_state_numpy(sim.state), sim.checksums()


@functools.lru_cache(maxsize=None)
def port_run(name):
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(DECKS[name]), dtype=torch.float64, device="cpu")
    sim.init()
    sim.evolve()
    return sim


@pytest.mark.parametrize("name", sorted(DECKS))
def test_config_and_path_match_jax(name):
    jsim = jax_run(name)[0]
    sim = port_run(name)
    assert sim.cfg == port_config(jsim.cfg)
    assert sim.is_bounded and not sim.binned and sim.stepper.mr is not None
    assert sim.mr_layout.i0 == jsim.mr_layout.i0
    assert sim.mr_layout.i1 == jsim.mr_layout.i1
    # the patch rode the window
    assert int(sim.state.aux["window_offset"]) > 0


@pytest.mark.parametrize("name", sorted(DECKS))
def test_checksums_match_jax(name):
    ref = jax_run(name)[2]
    assert {"lev=0", "lev=1", "electrons", "beam"} <= set(ref)
    assert_checksums(ref, port_run(name).checksums())


@pytest.mark.parametrize("name", sorted(DECKS))
def test_state_matches_jax(name):
    """Every field, PML split, patch array and particle array within 1e-9
    of its largest magnitude; the same particles alive."""
    ref = jax_run(name)[1]
    got = state_to_numpy(port_run(name).state)
    for nm, a in ref["fields"].items():
        close(got["fields"][nm], a, nm)
    keys = [k for k in ref["aux"] if k.startswith(("mr:", "pml:"))]
    assert sum(k.startswith("mr:") for k in keys) == 19
    for k in keys:
        if k.startswith("pml:"):
            # a split holds a part of its component: held to the
            # component's scale
            comp = k.split(":")[1]
            scale = max(np.abs(ref["fields"][comp]).max(),
                        np.abs(ref["aux"][k]).max())
            assert np.abs(got["aux"][k] - ref["aux"][k]).max() <= (
                1e-9 * scale), k
        else:
            close(got["aux"][k], ref["aux"][k], k)
    for name_sp in ("electrons", "beam"):
        np.testing.assert_array_equal(got["species"][name_sp]["alive"],
                                      ref["species"][name_sp]["alive"])
        for k, a in ref["species"][name_sp].items():
            if a is not None and k != "alive":
                close(got["species"][name_sp][k], a, f"{name_sp}.{k}")


def test_refined_injection_matches_jax():
    """The refined lattice (four streams a coarse stream at a quarter of
    the weight) in the footprint, at init and on the window's injection:
    the same count as the JAX package's, every live particle of one weight
    or the other."""
    jsim = jax_run("window_refine")[0]
    sim = port_run("window_refine")
    sp, jsp = sim.state.species["electrons"], jsim.state.species["electrons"]
    n = int(sp.alive.sum())
    assert n == int(np.asarray(jsp.alive).sum())
    w = sp.w[sp.alive]
    w_max = float(w.max())
    # a refined particle weighs a quarter of a coarse one
    quarter = torch.isclose(w, torch.full_like(w, 0.25 * w_max))
    assert int(quarter.sum()) > 0
    assert int(quarter.sum()) + int((w == w_max).sum()) == n


RESTART = DECKS["window_refine"] + (
    "diagnostics.diags_names = chk\nchk.format = checkpoint\n"
    "chk.intervals = 6:6\n")


def test_restart_is_bitwise(tmp_path):
    """A checkpoint at step 6 under the moving window restarts onto the
    uninterrupted run's trajectory bit for bit, the patch's shifted state
    included."""
    kw = dict(dtype=torch.float64, device="cpu")
    full = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(RESTART), output_dir=str(tmp_path / "a"), **kw)
    full.init()
    full.evolve()
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(RESTART), output_dir=str(tmp_path / "b"), **kw)
    sim.init()
    sim.state, sim.is_synchronized = load_checkpoint(
        str(tmp_path / "a" / "chk000006"), sim.state)
    sim.evolve()
    got, ref = state_to_numpy(sim.state), state_to_numpy(full.state)
    for nm, a in ref["fields"].items():
        np.testing.assert_array_equal(got["fields"][nm], a, err_msg=nm)
    for k, a in ref["aux"].items():
        np.testing.assert_array_equal(got["aux"][k], a, err_msg=k)
    for name_sp, sp in ref["species"].items():
        for k, a in sp.items():
            if a is not None:
                np.testing.assert_array_equal(got["species"][name_sp][k], a,
                                              err_msg=f"{name_sp}.{k}")


# the JAX package's refusals of the bounded MR step (bounded_step.py:730-741,
# simulation.py:115-118), on configurations built by hand
REFUSED = {
    "psatd": dict(em_solver="psatd"),
    "subcycling": dict(do_subcycling=True),
    "nci_corrector": dict(use_nci_corr=True),
    "electrostatic": dict(electrostatic="labframe", em_solver="none"),
    "implicit": dict(evolve_scheme="theta_implicit_em"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_jax_refusals_are_mirrored(case):
    jcfg = jax_config_from_deck(JDeck.from_string(DECKS["window_refine"]))
    jcfg = dataclasses.replace(jcfg, **REFUSED[case])
    with pytest.raises(NotImplementedError):
        JSimulation(jcfg)
    with pytest.raises(NotImplementedError):
        warpx_tpu_torch.Simulation(port_config(jcfg), dtype=torch.float64,
                                   device="cpu")


def test_chip_smoke_mr_deck_copies():
    """chip_smoke.py's mr_parity runs its own copies of these files' decks
    (it imports neither JAX nor the tests): they must stay equal."""
    import importlib.util
    import pathlib

    from .test_torch_mr import DECKS as PERIODIC

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cases = dict(smoke.mr_parity_cases())
    assert cases == {
        "periodic_2d": PERIODIC["2d_filter"], "periodic_3d": PERIODIC["3d"],
        "subcycled": PERIODIC["2d_subcycled"],
        "nci_subcycled": PERIODIC["2d_nci_subcycled"],
        "momentum_conserving": PERIODIC["2d_momentum_conserving"],
        "window_pml_refine": DECKS["window_refine"]}
