"""RZ FDTD on bounded z (``warpx_tpu_torch/rz/core.py::RZStepper``)
against the JAX package's ``make_rz_step_fns`` on the CPU in float64.

Decks written here, each run once through both packages: the RZ LWFA cut to
16 x 64 (PEC z walls, the moving window at c, the antenna, continuous
injection of a warm plasma with random_theta, whose draws replay JAX's key
chain, and a Gaussian beam), absorbing Silver-Mueller faces around an
antenna, and a laser diffracting around an embedded disk.  Fields (the
Silver-Mueller rings included), particles, the window's scalars and the
checksums within 1e-9; the continuous injection alone; the JAX step's
refusals of an embedded boundary with a window or particles; a checkpoint
that restarts onto the same trajectory bit for bit (the rings and the draw
stream included); the RZ plotfile's names.
"""

import jax
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.rz import core as jrz
from warpx_tpu_torch.core.state import state_to_numpy
from warpx_tpu_torch.io.checkpoint import load_checkpoint
from warpx_tpu_torch.rz import core as rz
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import port_config
from .test_torch_rz_util import (DECKS, _EB, _LWFA, _SILVER_MUELLER,
                                 assert_checksums, assert_fields,
                                 assert_species, close, jax_run,
                                 port_fields, port_run, port_species)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

BOUNDED = ("lwfa", "silver_mueller", "eb")


@pytest.mark.parametrize("name", BOUNDED)
def test_config_matches_jax(name):
    jsim = jax_run(name)[0]
    sim = port_run(name)
    assert sim.cfg == port_config(jsim.cfg)
    assert isinstance(sim.rz, rz.RZStepper)
    assert not sim.binned and not sim.is_bounded


@pytest.mark.parametrize("name", BOUNDED)
def test_fields_match_jax(name):
    """E, B, J (and the Silver-Mueller rings) after the run."""
    assert_fields(port_fields(port_run(name)), jax_run(name)[1])


@pytest.mark.parametrize("name", BOUNDED)
def test_particles_match_jax(name):
    """Every species' slots (the antennas', the beam's, the injected
    plasma's with its theta) after the run."""
    assert_species(port_species(port_run(name)), jax_run(name)[2])


@pytest.mark.parametrize("name", BOUNDED)
def test_checksums_match_jax(name):
    assert_checksums(port_run(name).checksums(), jax_run(name)[3])


def test_window_scalars_match_jax():
    """The window's position, its grid origin and the injection front."""
    jsim = jax_run("lwfa")[0]
    sim = port_run("lwfa")
    assert set(sim.state.aux) == set(jsim.state.aux)
    for k, v in jsim.state.aux.items():
        close(np.asarray(float(sim.state.aux[k])), np.asarray(v), k)
    # the window moved
    assert float(sim.state.aux["window_lo"]) > sim.cfg.geometry.prob_lo[1]


def test_antenna_drives_mode_one():
    """The x-polarized antenna drives the m = 1 components of E."""
    sim = port_run("lwfa")
    ey = sim.state.fields.Ey
    assert float(ey[1:].abs().max()) > 1e3 * float(ey[0].abs().max() + 1e-30)


def test_continuous_injection_matches_jax():
    """The window moved and the plasma was injected into the uncovered
    columns, the theta offsets and the Gaussian momenta drawn on the JAX
    key chain: the same slots come alive with the same particles."""
    jsim = jax_run("lwfa")[0]
    sim = port_run("lwfa")
    init = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(DECKS["lwfa"]), dtype=torch.float64, device="cpu")
    n0 = int(init.init().species["electrons"].alive.sum())
    jalive = np.asarray(jsim.state.species["electrons"].alive)
    alive = sim.state.species["electrons"].alive.numpy()
    assert np.array_equal(alive, jalive)
    # more live electrons than at the start (some leave by the lower wall)
    fresh = alive[n0:]
    assert fresh.sum() > 0
    sp = sim.state.species["electrons"]
    jsp = jsim.state.species["electrons"]
    idx = np.nonzero(fresh)[0] + n0
    for k in ("ux", "uy", "uz", "x", "y", "z", "w"):
        close(getattr(sp, k).numpy()[idx], np.asarray(getattr(jsp, k))[idx],
              k)


# ------------------------------------------------------- the EB refusals
EB_REFUSALS = {
    "with a window": (_EB.format(steps=1, extra="").replace(
        "boundary.field_lo = none pec", "boundary.field_lo = none pec\n"
        "warpx.do_moving_window = 1\nwarpx.moving_window_dir = z"),
        "RZ embedded boundary with a moving window"),
    "with particles": (_EB.format(steps=1, extra=(
        "particles.species_names = e\ne.charge = -q_e\ne.mass = m_e\n"
        "e.injection_style = NUniformPerCell\n"
        "e.num_particles_per_cell_each_dim = 1 1 1\ne.density = 1.e20\n"
        "e.profile = constant\n")), "RZ embedded boundary with particles"),
}


@pytest.mark.parametrize("case", sorted(EB_REFUSALS))
def test_eb_refusals_are_mirrored(case):
    from warpx_tpu.core.deck import config_from_deck as jcfd
    from warpx_tpu.utils.parser import Deck as JDeck

    text, msg = EB_REFUSALS[case]
    with pytest.raises(NotImplementedError, match=msg):
        jrz.make_rz_step_fns(jcfd(JDeck.from_string(text)),
                             jax.numpy.float64)
    with pytest.raises(NotImplementedError, match=msg):
        warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(text), dtype=torch.float64, device="cpu")


# ------------------------------------------------------------- restart
_RESTART = {
    "lwfa": _LWFA.format(
        steps=4, modes=2, nr=8, nz=32, order=1,
        plasma_extra="electrons.momentum_distribution_type = gaussian\n"
                     "electrons.uz_th = 0.01",
        extra="diagnostics.diags_names = chk\nchk.intervals = 2\n"
              "chk.format = checkpoint\n"),
    "silver_mueller": _SILVER_MUELLER.format(
        steps=4, extra="diagnostics.diags_names = chk\nchk.intervals = 2\n"
                       "chk.format = checkpoint\n"),
}


@pytest.mark.parametrize("name", sorted(_RESTART))
def test_restart_is_bitwise(name, tmp_path):
    """A run restarted from its step-2 checkpoint (the window's scalars,
    the Silver-Mueller rings and the draw stream in it) lands on the
    uninterrupted run bit for bit."""
    def sim_of():
        return warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(_RESTART[name]), dtype=torch.float64,
            device="cpu", output_dir=str(tmp_path))

    full = sim_of()
    full.init()
    full.evolve()
    ref = state_to_numpy(full.state)
    again = sim_of()
    again.init()
    again.state, again.is_synchronized = load_checkpoint(
        str(tmp_path / "chk000002"), again.state, again.draws)
    assert again.state.step == 2
    again.evolve()
    got = state_to_numpy(again.state)
    assert (ref["fields"].get("smg") is not None) == (name == "silver_mueller")
    for nm, a in ref["fields"].items():
        if isinstance(a, dict):
            for k, v in a.items():
                assert np.array_equal(got["fields"][nm][k], v), (nm, k)
        else:
            assert np.array_equal(got["fields"][nm], a), nm
    for spn, sp in ref["species"].items():
        for k, v in sp.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    assert np.array_equal(got["species"][spn][k][kk], vv)
            elif v is not None:
                assert np.array_equal(got["species"][spn][k], v), (spn, k)
    assert {k: float(v) for k, v in got["aux"].items()} == {
        k: float(v) for k, v in ref["aux"].items()}


def test_plotfile_has_the_rz_names(tmp_path):
    """The RZ plotfile holds the mode sums and each mode's components
    (Er, Etheta_1_real, ...), as the JAX package's RZ output names them."""
    text = _SILVER_MUELLER.format(
        steps=2, extra="diagnostics.diags_names = plt\nplt.intervals = 2\n"
                       "plt.fields_to_plot = Er Etheta_1_real Bz_1_imag "
                       "rho\n")
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float64, device="cpu",
        output_dir=str(tmp_path))
    sim.init()
    sim.evolve()
    header = (tmp_path / "plt000002" / "Header").read_text().split("\n")
    n = int(header[1])
    assert header[2:2 + n] == ["Bz_1_imag", "Er", "Etheta_1_real", "rho"]
    assert sim.field_diagnostics()["Er"].shape == (16, 64)


def test_chip_smoke_rz_deck_copies():
    """chip_smoke.py's rz_parity runs its own copies of the RZ deck
    templates (it imports neither JAX nor the tests): they must stay
    equal."""
    import importlib.util
    import pathlib

    from . import test_torch_rz_util as util

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.RZ_TEST_DECKS == {
        "langmuir": util._LANGMUIR, "lwfa": util._LWFA,
        "silver_mueller": util._SILVER_MUELLER, "eb": util._EB,
        "psatd": util._PSATD}
    # the LWFA cell's deck reads as the port's RZ deck, at 2 modes
    cfg = warpx_tpu_torch.core.deck.config_from_deck(
        Deck.from_string(smoke.rz_lwfa_deck(16, 64, 2)))
    assert cfg.geometry.rz and cfg.n_rz_modes == 2
    cfg = warpx_tpu_torch.core.deck.config_from_deck(
        Deck.from_string(smoke.rz_psatd_deck(16, 64, 2)))
    assert cfg.em_solver == "psatd" and cfg.psatd_v_galilean[2] > 0
