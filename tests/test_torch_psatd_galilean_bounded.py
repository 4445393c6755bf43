"""The bounded per-particle step's PSATD families against the JAX package.

The 32 x 64 laser-wakefield deck of ``test_torch_bounded.py`` (PML on four
faces with the PSATD F/G split cleaning, moving window at c, antenna,
continuous injection, beam, filter, order 3), 8 steps, as
``algo.maxwell_solver = psatd``:

* with ``psatd.v_galilean = 0 0 0.5`` and Esirkepov deposition: the grid
  drifts at c/2, so every gather and deposit origin, the physical bounds
  and the window's shift count move with it; update-with-rho is on (the
  reader's default for a Galilean run), so rho is deposited at the start
  and end of the step.  Once more with ``psatd.do_time_averaging = 1``,
  which gathers from the averaged fields;
* with no deposition key: PSATD's default direct deposition and the
  current correction it turns on, through ``Simulation.from_deck`` and
  through ``python -m warpx_tpu_torch``.

Each lands on the JAX package's per-particle checksums at 1e-9 (divE and
divB excepted, as in ``test_torch_bounded_util.assert_checksums``).  The
tile-binned bounded gate refuses all of them in both packages.  CPU,
float64.
"""

import json

import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.binned_step import (
    bounded_binned_supported as j_bounded_binned_supported)
from warpx_tpu_torch.__main__ import main as cli_main
from warpx_tpu_torch.core.binned_step import bounded_binned_supported
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import (LWFA_2D, assert_checksums, port_config,
                                      run_jax, run_port)

torch.set_num_threads(1)

PSATD = LWFA_2D.replace("max_step = 12", "max_step = 8").replace(
    "algo.maxwell_solver = yee", "algo.maxwell_solver = psatd")
GALILEAN = PSATD + """
algo.current_deposition = esirkepov
psatd.v_galilean = 0. 0. 0.5
"""
DECKS = {
    "galilean": GALILEAN,
    "galilean_averaged": GALILEAN + "psatd.do_time_averaging = 1\n",
}


@pytest.mark.parametrize("name", sorted(DECKS))
def test_galilean_lwfa_matches_jax(name):
    jsim, _ = run_jax(DECKS[name], "auto")
    jcfg = jsim.cfg
    assert jcfg.psatd_update_with_rho and any(jcfg.psatd_v_galilean)
    assert not j_bounded_binned_supported(jcfg)
    cfg = port_config(jcfg, tiled_particles="auto")
    assert not bounded_binned_supported(cfg)
    sim = run_port(cfg)
    assert sim.is_bounded and not sim.binned
    st = sim.stepper
    assert st.need_rho and st.v_gal == [0.0, 0.5 * 299792458.0]
    # the window moves at c against a grid drifting at c/2
    assert float(sim.state.aux["window_lo"]) == float(
        jsim.state.aux["window_lo"])
    if cfg.psatd_time_averaging:
        assert float(sim.state.fields.Ez_avg.abs().max()) > 0
    assert {nm: int(sp.alive.sum()) for nm, sp in sim.state.species.items()
            } == {nm: int(sp.alive.sum())
                  for nm, sp in jsim.state.species.items()}
    assert_checksums(jsim.checksums(), sim.checksums())


@pytest.fixture(scope="module")
def jax_direct():
    sim, _ = run_jax(PSATD, "auto")
    assert sim.cfg.current_deposition == "direct"
    assert sim.cfg.psatd_current_correction
    return sim.checksums()


def test_default_direct_deposition_from_deck(jax_direct, tmp_path):
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(PSATD), dtype=torch.float64, device="cpu",
        output_dir=str(tmp_path))
    assert sim.cfg.current_deposition == "direct" and not sim.binned
    assert not sim.cfg.galerkin
    sim.init()
    sim.evolve()
    assert_checksums(jax_direct, sim.checksums())


def test_default_direct_deposition_through_cli(jax_direct, tmp_path,
                                               capsys):
    path = tmp_path / "deck"
    path.write_text(PSATD)
    capsys.readouterr()
    assert cli_main([str(path), "--device", "cpu", "--checksums",
                     "--output-dir", str(tmp_path / "cli")]) == 0
    out = capsys.readouterr().out
    assert_checksums(jax_direct, json.loads(out[out.index("{"):]))
