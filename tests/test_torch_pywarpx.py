"""The port's pywarpx input buckets (``warpx_tpu_torch.pywarpx``) against
the JAX package's (``tests/test_pywarpx_buckets.py``), float64 on the
CPU: the same buckets write the same deck, the bucket run agrees with
JAX's at 1e-9, and the written deck through ``Simulation.from_deck`` runs
exactly as the buckets did."""

import sys

import numpy as np
import pytest
import torch

import warpx_tpu.pywarpx
import warpx_tpu_torch.pywarpx

from .test_torch_frontend_util import (CPU64, clean_frontends,  # noqa: F401
                                       fields_close, particles_close, states,
                                       sums_close)

pytestmark = pytest.mark.usefixtures("clean_frontends")


def _fill(pw):
    """tests/test_pywarpx_buckets.py's buckets, a thermal plasma so that
    the steps move something."""
    pw.max_step = 3
    pw.amr.n_cell = [8, 8, 8]
    pw.geometry.dims = 3
    pw.geometry.prob_lo = [-1e-5] * 3
    pw.geometry.prob_hi = [1e-5] * 3
    pw.boundary.field_lo = ["periodic"] * 3
    pw.boundary.field_hi = ["periodic"] * 3
    pw.warpx.cfl = 0.9
    pw.warpx.use_filter = 0
    pw.algo.particle_shape = 1
    pw.particles.species_names = ["electrons"]
    el = pw.Species("electrons")
    el.charge = "-q_e"
    el.mass = "m_e"
    el.injection_style = "NUniformPerCell"
    el.num_particles_per_cell_each_dim = [1, 1, 1]
    el.profile = "constant"
    el.density = 1e20
    el.momentum_distribution_type = "gaussian"
    el.ux_th = 0.01
    el.uy_th = 0.01
    el.uz_th = 0.01
    return el


def test_buckets_build_run_and_write(tmp_path):
    """tests/test_pywarpx_buckets.py on the port, held against the JAX
    package's bucket run, then the written deck through from_deck."""
    tpw, jpw = warpx_tpu_torch.pywarpx, warpx_tpu.pywarpx
    for pw in (tpw, jpw):
        _fill(pw)
    assert tpw.attr_list() == jpw.attr_list()
    path = tpw.write_input_file(str(tmp_path / "inputs"))
    jpw.write_input_file(str(tmp_path / "inputs_jax"))
    text = open(path).read()
    assert text == open(tmp_path / "inputs_jax").read()
    assert "amr.n_cell = 8 8 8" in text
    assert "electrons.density = 1e+20" in text

    sim = tpw.init(output_dir=str(tmp_path / "diags"), **CPU64)
    assert tpw.getsim() is sim
    assert warpx_tpu_torch.runtime.get_simulation() is sim
    tpw.evolve()
    assert sim.state.step == 3
    n = sum(int(s.alive.sum()) for s in sim.state.species.values())
    assert n == 512
    jsim = jpw.init(output_dir=str(tmp_path / "jax"))
    jpw.evolve()
    # JAX's "auto" runs per particle on the CPU, the port's the tile-binned
    # step: the same physics, compared on the fields and the checksums
    ref, got = states(jsim, sim)
    fields_close(ref, got)
    particles_close(ref, got)

    # the written deck runs exactly as the buckets did
    sim2 = warpx_tpu_torch.Simulation.from_deck(
        path, output_dir=str(tmp_path / "d2"), **CPU64)
    sim2.init()
    sim2.evolve()
    np.testing.assert_array_equal(sim.state.fields.Ex.numpy(),
                                  sim2.state.fields.Ex.numpy())
    sums_close(jsim.checksums(), sim.checksums())
    tpw.finalize()
    assert tpw.getsim() is None
    with pytest.raises(RuntimeError, match="pywarpx.init"):
        tpw.evolve()


def test_bucket_api_matches_jax():
    """The buckets' surface: group attributes, values formatted as JAX
    formats them (booleans as 1/0, lists space-joined, empty lists and None
    dropped), per-species buckets made once."""
    tpw, jpw = warpx_tpu_torch.pywarpx, warpx_tpu.pywarpx
    assert tpw.__all__ == jpw.__all__
    for pw in (tpw, jpw):
        pw.warpx.do_moving_window = True
        pw.warpx.serialize_initial_conditions = False
        pw.algo.current_deposition = "esirkepov"
        pw.psatd.nox = None
        pw.diagnostics.diags_names = []
        pw.lasers.add_new_group_attr("laser1", "e_max", 1.5e12)
        pw.lasers.add_new_attr("names", ["laser1"])
        pw.stop_time = 1e-13
        assert pw.Species("beam") is pw.Species("beam")
        pw.Species("beam").q_tot = -1e-12
        with pytest.raises(AttributeError):
            pw.amr.n_cell
    assert tpw.attr_list() == jpw.attr_list()
    assert "warpx.do_moving_window = 1" in tpw.attr_list()
    assert "lasers.laser1.e_max = 1500000000000.0" in tpw.attr_list()
    assert set(tpw.bucket_dict()) == set(jpw.bucket_dict())


def test_init_without_a_device_takes_the_card(tmp_path):
    """Without ``device`` the run goes to the card; with no GPU it raises
    rather than run on the CPU."""
    tpw = warpx_tpu_torch.pywarpx
    _fill(tpw)
    if torch.cuda.is_available():
        sim = tpw.init(output_dir=str(tmp_path))
        assert sim.device.type == "cuda"
        assert sim.state.fields.Ex.dtype == torch.float32
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpw.init(output_dir=str(tmp_path))


def test_pywarpx_alias_exposes_the_port_s_picmi(monkeypatch):
    """``from pywarpx import picmi`` with pywarpx aliased to the port gives
    the port's PICMI."""
    monkeypatch.setitem(sys.modules, "pywarpx", warpx_tpu_torch.pywarpx)
    from pywarpx import picmi

    from warpx_tpu_torch import picmi as tpicmi

    assert picmi is tpicmi
    assert "device" in picmi.Simulation.__init__.__kwdefaults__
