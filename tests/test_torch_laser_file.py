"""Lasers from lasy files in the port (``warpx_tpu_torch/core/
laser_file.py``, ``core/laser.py::fill_amplitude``'s ``from_file`` branch)
against the JAX package, CPU, float64; the mirror of
``tests/test_laser_from_file.py``.

The amplitude of a cartesian and of a thetaMode (RZ) envelope equals the
JAX package's ``lasy_amplitude`` at 1e-12 of e_max and the built-in
Gaussian within 2e-2 of e_max; it is zero outside the envelope's plane and
time window; ``delay`` shifts it; the loader reads the file's metadata;
the 2D deck driven by the file runs through both packages within 1e-9 and
emits the Gaussian's field; the reader refuses binary files and a missing
file as the JAX reader does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpx_tpu.core import laser_file as jlaser_file
from warpx_tpu.core.config import LaserConfig as JLaserConfig
from warpx_tpu.core.deck import config_from_deck as jconfig_from_deck
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core import laser_file
from warpx_tpu_torch.core.config import LaserConfig
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.laser import fill_amplitude
from warpx_tpu_torch.utils.parser import Deck

from .test_laser_from_file import (E_MAX, T_PEAK, TAU, WAIST, WAVELENGTH,
                                   _write_lasy_cartesian, _write_lasy_rz)
from .test_torch_bounded_util import port_config
from .test_torch_draws_util import (assert_checksums_close,
                                    assert_runs_close, jax_run, port_run)

torch.set_num_threads(1)


def _lasers(profile, fname=""):
    kw = dict(name="lasy", position=(0.0, 0.0, 0.0),
              direction=(0.0, 0.0, 1.0), polarization=(1.0, 0.0, 0.0),
              e_max=E_MAX, wavelength=WAVELENGTH, profile=profile,
              profile_waist=WAIST, profile_duration=TAU,
              profile_t_peak=T_PEAK, profile_focal_distance=0.0,
              lasy_file_name=fname)
    return LaserConfig(**kw), JLaserConfig(**kw)


@pytest.mark.parametrize("geometry", ["cartesian", "thetaMode"])
def test_lasy_amplitude_matches_jax_and_gaussian(tmp_path, geometry):
    write = (_write_lasy_cartesian if geometry == "cartesian"
             else _write_lasy_rz)
    fname = write(str(tmp_path / f"{geometry}.h5"))
    lf, jlf = _lasers("from_file", fname)
    lg, _ = _lasers("gaussian")
    jld = jlaser_file.load_lasy(fname)
    ld = laser_file.load_lasy(fname)
    rng = np.random.default_rng(0)
    X = rng.uniform(-3 * WAIST, 3 * WAIST, 256)
    Y = rng.uniform(-2.5 * WAIST, 2.5 * WAIST, 256)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    for t in (20e-15, 55e-15, 60e-15, 90e-15):
        ref = np.asarray(jlaser_file.lasy_amplitude(
            jld, jlf, jnp.asarray(X), jnp.asarray(Y), t))
        got = laser_file.lasy_amplitude(ld, lf, Xt, Yt, t).numpy()
        assert np.abs(got - ref).max() <= 1e-12 * E_MAX, t
        a_ref = fill_amplitude(lg, 3, Xt, Yt, t).numpy()
        a_fil = fill_amplitude(lf, 3, Xt, Yt, t).numpy()
        assert np.abs(a_fil - a_ref).max() < 2e-2 * E_MAX, t


def test_lasy_out_of_bounds_zero(tmp_path):
    fname = _write_lasy_cartesian(str(tmp_path / "gauss.h5"))
    lf, _ = _lasers("from_file", fname)
    X = torch.tensor([5 * WAIST, 0.0], dtype=torch.float64)
    Y = torch.zeros(2, dtype=torch.float64)
    a = fill_amplitude(lf, 3, X, Y, 60e-15).numpy()
    assert a[0] == 0.0 and abs(a[1]) > 0.1 * E_MAX
    assert np.all(fill_amplitude(lf, 3, X, Y, 500e-15).numpy() == 0.0)


def test_lasy_delay_shifts_pulse(tmp_path):
    fname = _write_lasy_cartesian(str(tmp_path / "gauss.h5"))
    lf, _ = _lasers("from_file", fname)
    lfd = dataclasses.replace(lf, delay=20e-15)
    X = torch.zeros(1, dtype=torch.float64)
    a0 = fill_amplitude(lf, 3, X, X, 60e-15).numpy()
    ad = fill_amplitude(lfd, 3, X, X, 80e-15).numpy()
    np.testing.assert_allclose(a0, ad, atol=1e-3 * E_MAX)


def test_lasy_loader_metadata(tmp_path):
    fname = _write_lasy_cartesian(str(tmp_path / "meta.h5"))
    ld = laser_file.load_lasy(fname)
    jld = jlaser_file.load_lasy(fname)
    assert ld.cartesian and laser_file.is_loaded(fname)
    assert ld.t_min == 0.0 and abs(ld.t_max - 120e-15) < 1e-20
    assert abs(ld.x_min + 4 * WAIST) < 1e-12
    for k in ("t_min", "t_max", "x_min", "x_max", "y_min", "y_max"):
        assert getattr(ld, k) == getattr(jld, k), k
    np.testing.assert_array_equal(ld.data, np.asarray(jld.data))
    rz = laser_file.load_lasy(_write_lasy_rz(str(tmp_path / "rz.h5")))
    assert not rz.cartesian and rz.r_min == 0.0
    assert abs(rz.r_max - 4 * WAIST) < 1e-18


_DECK = """
max_step = 40
amr.n_cell = 32 64
geometry.dims = 2
geometry.prob_lo = -15.e-6 -10.e-6
geometry.prob_hi =  15.e-6  10.e-6
boundary.field_lo = periodic pec
boundary.field_hi = periodic pec
warpx.cfl = 0.9
lasers.names = lasy
lasy.position = 0. 0. -5.e-6
lasy.direction = 0. 0. 1.
lasy.polarization = 1. 0. 0.
lasy.e_max = {emax}
lasy.wavelength = {wl}
"""


def test_lasy_deck_matches_jax_and_gaussian(tmp_path):
    """The 2D deck of ``tests/test_laser_from_file.py`` driven by the lasy
    file: the port's run lands on the JAX package's within 1e-9, the deck
    reader builds the JAX reader's configuration, and the field is the
    Gaussian profile's within 3 % of its largest value."""
    fname = _write_lasy_cartesian(str(tmp_path / "gauss2d.h5"))
    base = _DECK.format(emax=E_MAX, wl=WAVELENGTH)
    text = base + (f'lasy.profile = from_file\nlasy.lasy_file_name = '
                   f'"{fname}"\nlasy.delay = 0.\n')
    assert config_from_deck(Deck.from_string(text)) == port_config(
        jconfig_from_deck(JDeck.from_string(text)))
    j = jax_run(text)
    p = port_run(text, replay=False)
    assert p.is_bounded and p.cfg.lasers[0].profile == "from_file"
    assert_runs_close(p, j, 1e-9)
    assert_checksums_close(p.checksums(), j.checksums(), 1e-9)
    gauss = port_run(base + (
        f"lasy.profile = gaussian\nlasy.profile_waist = {WAIST}\n"
        f"lasy.profile_duration = {TAU}\nlasy.profile_t_peak = {T_PEAK}\n"
        "lasy.profile_focal_distance = 0.0\n"), replay=False)
    ref = gauss.state.fields.Ex.numpy()
    assert ref.max() > 1e9  # the laser launched
    dev = np.abs(p.state.fields.Ex.numpy() - ref).max()
    assert dev < 0.03 * np.abs(ref).max()


def test_lasy_deck_refusals(tmp_path):
    """As in the JAX reader: a from_file laser needs a lasy file (binary
    files are refused, ROADMAP.md Queue C) that exists; other profiles
    are refused as the JAX reader refuses them (Queue C)."""
    base = _DECK.format(emax=E_MAX, wl=WAVELENGTH) + "lasy.profile = {p}\n"
    with pytest.raises(NotImplementedError, match="binary_file_name.*Queue C"):
        config_from_deck(Deck.from_string(base.format(p="from_file")))
    with pytest.raises(FileNotFoundError):
        config_from_deck(Deck.from_string(
            base.format(p="from_file") + "lasy.lasy_file_name = "
            f"{tmp_path / 'absent.h5'}\n"))
    with pytest.raises(NotImplementedError, match="Queue C"):
        config_from_deck(Deck.from_string(base.format(p="parse_field")))
