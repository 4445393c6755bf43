"""The port's bounded PSATD step against the JAX package.

* The 32 x 64 laser-wakefield deck of ``test_torch_bounded.py`` with
  ``algo.maxwell_solver = psatd`` and ``algo.current_deposition =
  esirkepov`` (PML on four faces, which under PSATD carries the F/G split
  cleaning; moving window, antenna, continuous injection, beam, filter,
  order 3), 8 steps with a rebin at step 4: the port's binned and
  per-particle runs land on the JAX package's checksums at 1e-9, through
  ``Simulation``, through ``Simulation.from_deck`` and through the CLI.
* A vacuum pulse crossing damped z faces (``test_psatd_bounded.py::_cfg``
  with Esirkepov deposition and no species), until the damped zone has
  taken half its energy: every E/B component within 1e-12 of the JAX
  package's.
* A checkpoint of the deck at step 4 restarts and repeats the uninterrupted
  run to step 8 bit for bit (PML splits and F/G splits included).

CPU, float64.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.config import SimConfig as JSimConfig
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu_torch.__main__ import main as cli_main
from warpx_tpu_torch.core.config import SimConfig
from warpx_tpu_torch.core.grid import Geometry
from warpx_tpu_torch.core.state import state_to_numpy
from warpx_tpu_torch.io.checkpoint import load_checkpoint
from warpx_tpu_torch.solvers.psatd import PsatdPmlSolver, PsatdSolver
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import (LWFA_2D, assert_checksums,
                                      port_config, run_jax, run_port)

torch.set_num_threads(1)

C = 299792458.0
DECK = LWFA_2D.replace(
    "algo.maxwell_solver = yee",
    "algo.maxwell_solver = psatd\nalgo.current_deposition = esirkepov",
).replace("max_step = 12", "max_step = 8")
CHECKPOINT = """
diagnostics.diags_names = chk
chk.format = checkpoint
chk.intervals = 4:4
"""


@pytest.fixture(scope="module")
def jax_lwfa():
    """The JAX package's per-particle run of the deck (its binned run lands
    on the same checksums; Pallas in interpret mode would add 25 s)."""
    sim, _ = run_jax(DECK, "off")
    return {"cfg": sim.cfg, "sums": sim.checksums(),
            "alive": {nm: int(sp.alive.sum())
                      for nm, sp in sim.state.species.items()},
            "window_lo": float(sim.state.aux["window_lo"])}


@pytest.mark.parametrize("tiled", ["on", "off"])
def test_lwfa_psatd_matches_jax(jax_lwfa, tiled):
    cfg = port_config(jax_lwfa["cfg"], tiled_particles=tiled)
    assert cfg.em_solver == "psatd" and cfg.do_pml_dive_cleaning
    sim = run_port(cfg)
    st = sim.stepper
    assert sim.is_bounded and sim.binned == (tiled == "on")
    assert isinstance(st.psatd, PsatdSolver) and st.psatd.ng == 0
    assert isinstance(st.psatd_pml, PsatdPmlSolver) and st.psatd_pml.cleaning
    assert st.psatd.n_fft == (32 + 20, 64 + 20)
    aux = sim.state.aux
    assert {k for k in aux if k.startswith("pml:F:")} == {
        "pml:F:x", "pml:F:y", "pml:F:z"}
    assert aux["pml:Ex:z"].shape == st.psatd.n_fft
    assert float(aux["window_lo"]) == jax_lwfa["window_lo"] > -28e-6
    if tiled == "on":
        assert int(aux["tile_overflow"]) == int(aux["tile_violations"]) == 0
        assert sorted(st.zshifts_seen) == [0, 1, 2, 3]
    assert {nm: int(sp.alive.sum()) for nm, sp in
            sim.state.species.items()} == jax_lwfa["alive"]
    assert_checksums(jax_lwfa["sums"], sim.checksums())


def test_lwfa_psatd_from_deck_and_cli(jax_lwfa, tmp_path, capsys):
    """The deck text through ``Simulation.from_deck`` (binned) and through
    ``python -m warpx_tpu_torch`` (per particle), against JAX."""
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(DECK), dtype=torch.float64, device="cpu",
        output_dir=str(tmp_path / "api"))
    assert sim.binned and sim.cfg.em_solver == "psatd"
    assert sim.cfg.dt == 0.98 * min(sim.cfg.geometry.dx) / C
    sim.init()
    sim.evolve()
    assert_checksums(jax_lwfa["sums"], sim.checksums())
    path = tmp_path / "deck"
    path.write_text(DECK)
    capsys.readouterr()
    assert cli_main([str(path), "tpu.tiled_particles=off", "--device", "cpu",
                     "--checksums", "--output-dir",
                     str(tmp_path / "cli")]) == 0
    out = capsys.readouterr().out
    sums = json.loads(out[out.index("{"):])
    assert_checksums(jax_lwfa["sums"], sums)


def test_lwfa_psatd_restart_is_bitwise(tmp_path):
    def run(out):
        sim = warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(DECK + CHECKPOINT), dtype=torch.float64,
            device="cpu", output_dir=str(out))
        sim.init()
        return sim

    ref = run(tmp_path / "a")
    ref.evolve()
    want = state_to_numpy(ref.state)
    assert (tmp_path / "a" / "chk000004" / "state.npz").exists()
    sim = run(tmp_path / "b")
    sim.state, sim.is_synchronized = load_checkpoint(
        str(tmp_path / "a" / "chk000004"), sim.state)
    assert sim.state.step == 4 and "pml:G:z" in sim.state.aux
    sim.evolve()
    got = state_to_numpy(sim.state)
    assert got["step"] == want["step"] == 8 and got["time"] == want["time"]
    for nm, a in want["fields"].items():
        np.testing.assert_array_equal(got["fields"][nm], a, err_msg=nm)
    for name, sp in want["species"].items():
        for k, a in sp.items():
            np.testing.assert_array_equal(got["species"][name][k], a,
                                          err_msg=f"{name}.{k}")
    assert set(got["aux"]) == set(want["aux"])
    for k, a in want["aux"].items():
        np.testing.assert_array_equal(got["aux"][k], a, err_msg=k)


# ---- the damped-z vacuum pulse ----------------------------------------------

def _pulse_cfg(cls, geom_cls):
    """``test_psatd_bounded.py::_cfg`` with Esirkepov deposition."""
    n, L = 64, 1.0
    geom = geom_cls(2, (16, n), (0.0, -L / 2), (0.25, L / 2),
                    periodic=(True, False))
    return cls(
        geometry=geom, max_step=200, dt=0.95 * (L / n) / C,
        em_solver="psatd", psatd_order=16, use_filter=False,
        current_deposition="esirkepov",
        field_bc_lo=("periodic", "damped"), field_bc_hi=("periodic", "damped"),
        particle_bc_lo=("periodic", "absorbing"),
        particle_bc_hi=("periodic", "absorbing"))


def _pulse_arrays(shapes, geom, z0=0.0, w0=0.06):
    """A Gaussian EM pulse moving +z, Ex = f(z), By = Ex/c, embedded in the
    stored (damped-zone) shapes as ``test_psatd_bounded.py`` embeds it."""
    z = geom.prob_lo[1] + (np.arange(geom.n_cell[1]) + 0.5) * geom.dx[1]
    prof = np.exp(-((z - z0) / w0) ** 2) * np.cos(
        2 * np.pi * (z - z0) / (4 * w0))
    ex = np.tile(prof, (geom.n_cell[0], 1))

    def put(shape, arr):
        tgt = np.zeros(shape)
        o0 = (shape[0] - arr.shape[0]) // 2
        o1 = (shape[1] - arr.shape[1]) // 2
        tgt[o0:o0 + arr.shape[0], o1:o1 + arr.shape[1]] = arr
        return tgt

    return {"Ex": put(shapes["Ex"], ex), "By": put(shapes["By"], ex / C)}


def test_damped_pulse_matches_jax():
    # the front enters the damped zone (z > 0.5) near step 24 and its ramp
    # (the outer half, z > 0.625) near step 33; the centre reaches it at 44
    steps = 52
    jsim = JSimulation(_pulse_cfg(JSimConfig, JGeometry))
    jstate = jsim.init()
    cfg = _pulse_cfg(SimConfig, Geometry)
    tsim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
    tstate = tsim.init()
    assert tsim.is_bounded and tsim.stepper.psatd is not None
    assert tsim.stepper.psatd_pml is None
    assert tsim.stepper.n_ext == [16, 64 + 2 * 16]
    shapes = {nm: tuple(getattr(tstate.fields, nm).shape)
              for nm in ("Ex", "By")}
    assert shapes == {nm: tuple(getattr(jstate.fields, nm).shape)
                      for nm in shapes}
    pulse = _pulse_arrays(shapes, cfg.geometry)
    jsim.state = jstate.replace(fields=jstate.fields.replace(
        **{nm: jnp.asarray(a) for nm, a in pulse.items()}))
    tsim.state = tstate.replace(fields=tstate.fields.replace(
        **{nm: torch.from_numpy(a) for nm, a in pulse.items()}))
    jsim.evolve(steps)
    tsim.evolve(steps)
    assert tsim.state.step == int(jsim.state.step) == steps

    def energy(f):
        return float(sum((np.asarray(getattr(f, nm)) ** 2).sum()
                         * (1.0 if nm[0] == "E" else C * C)
                         for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")))

    assert energy(tsim.state.fields) < 0.5 * energy(
        dataclasses.replace(tstate.fields, **{
            nm: torch.from_numpy(a) for nm, a in pulse.items()}))
    for fam in "EB":
        names = [fam + a for a in "xyz"]
        scale = max(np.abs(np.asarray(getattr(jsim.state.fields, nm))).max()
                    for nm in names)
        assert scale > 0
        for nm in names:
            ref = np.asarray(getattr(jsim.state.fields, nm))
            got = getattr(tsim.state.fields, nm).numpy()
            assert got.shape == ref.shape, nm
            assert np.abs(got - ref).max() <= 1e-12 * scale, nm
