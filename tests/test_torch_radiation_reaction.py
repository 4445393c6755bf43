"""The classical radiation-reaction pusher and photon streaming of the port
(``warpx_tpu_torch/ops/push.py``) against the JAX package, CPU, float64.

``push_momentum_boris_rr`` and ``photon_position_step`` hold at 1e-12; a
``do_classical_radiation_reaction`` species and a photon species run
through the periodic and the bounded per-particle steps within 1e-9 of the
JAX package's runs; the deck key selects the ``boris_rr`` pusher.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpx_tpu.ops import push as jpush
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.ops import push as tpush
from warpx_tpu_torch.utils.parser import Deck

from .test_binned_bounded import _LWFA_2D
from .test_torch_draws_util import (QED_FIELDS, assert_checksums_close,
                                    assert_runs_close, jax_run, port_run)

torch.set_num_threads(1)

C = 299792458.0
QE = 1.602176634e-19
ME = 9.1093837015e-31


@pytest.mark.parametrize("uscale,escale", [(1.0, 1e12), (1000.0, 2e15)])
def test_push_momentum_boris_rr_matches_jax(uscale, escale):
    rng = np.random.default_rng(5)
    n = 4096
    cols = ([rng.normal(size=n) * uscale * C for _ in range(3)]
            + [rng.normal(size=n) * escale for _ in range(3)]
            + [rng.normal(size=n) * escale / C for _ in range(3)])
    for q in (-QE, QE):
        ref = jpush.push_momentum_boris_rr(*map(jnp.asarray, cols), q, ME,
                                           3e-17)
        got = tpush.push_momentum_boris_rr(*map(torch.from_numpy, cols), q,
                                           ME, 3e-17)
        for g, r in zip(got, ref):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-12,
                                       atol=1e-12 * np.abs(r).max())
    # the reaction is there: the RR push differs from the plain Boris push
    plain = tpush.push_momentum_boris(*map(torch.from_numpy, cols), -QE, ME,
                                      3e-17)
    assert not torch.equal(got[0], plain[0])


@pytest.mark.parametrize("ndim", [2, 3])
def test_photon_position_step_matches_jax(ndim):
    rng = np.random.default_rng(6)
    n = 2048
    u = [rng.normal(size=n) * 1e3 * C for _ in range(3)]
    pos = [rng.normal(size=n) * 1e-5 for _ in range(ndim)]
    ref = jpush.photon_position_step(tuple(map(jnp.asarray, pos)),
                                     *map(jnp.asarray, u), 2e-15, ndim)
    got = tpush.photon_position_step(tuple(map(torch.from_numpy, pos)),
                                     *map(torch.from_numpy, u), 2e-15, ndim)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=0)
    # at c: each photon moved c dt
    d2 = sum((g.numpy() - p) ** 2 for g, p in zip(got, pos))
    if ndim == 3:
        np.testing.assert_allclose(np.sqrt(d2), C * 2e-15, rtol=1e-12)


RR_PERIODIC = """
max_step = 5
amr.n_cell = 16 16
geometry.dims = 2
geometry.prob_lo = -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6
warpx.const_dt = 2.e-17
particles.species_names = electrons photons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 2 2
electrons.profile = constant
electrons.density = 1.e20
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 300.
electrons.uy_th = 300.
electrons.uz_th = 300.
electrons.do_classical_radiation_reaction = 1
photons.species_type = photon
photons.injection_style = NUniformPerCell
photons.num_particles_per_cell_each_dim = 1 1
photons.profile = constant
photons.density = 1.e20
photons.momentum_distribution_type = gaussian
photons.ux_th = 1000.
photons.uy_th = 1000.
photons.uz_th = 1000.
""" + QED_FIELDS


def test_deck_selects_the_rr_pusher():
    cfg = config_from_deck(Deck.from_string(RR_PERIODIC))
    by = {s.name: s for s in cfg.species}
    assert by["electrons"].pusher == "boris_rr"
    assert by["photons"].pusher == "boris"
    assert by["photons"].mass == 0.0 and by["photons"].charge == 0.0


def test_rr_and_photons_periodic_match_jax():
    """Thermal electrons at ~300 m_e c with radiation reaction and photons
    in the reference QED decks' fields, 5 steps through both packages:
    fields, species and checksums within 1e-9."""
    ref = jax_run(RR_PERIODIC)
    got = port_run(RR_PERIODIC)
    assert not got.binned
    assert_runs_close(got, ref, 1e-9)
    assert_checksums_close(got.checksums(), ref.checksums())


RR_BOUNDED = _LWFA_2D.replace("max_step = 12", "max_step = 8").replace(
    "particles.species_names = electrons beam",
    "particles.species_names = electrons beam photons").replace(
    "beam.species_type = electron",
    "beam.species_type = electron\nbeam.do_classical_radiation_reaction = 1",
) + """
photons.species_type = photon
photons.injection_style = NUniformPerCell
photons.num_particles_per_cell_each_dim = 1 1
photons.zmax = -10.e-6
photons.profile = constant
photons.density = 1.e20
photons.momentum_distribution_type = gaussian
photons.ux_th = 100.
photons.uz_m = 200.
photons.uz_th = 100.
tpu.tiled_particles = off
"""


def test_rr_and_photons_bounded_match_jax():
    """The 32 x 64 laser-wakefield deck with radiation reaction on the beam
    and a photon species streaming through the PML faces and the moving
    window, per particle, 8 steps: within 1e-9 of the JAX package's run."""
    ref = jax_run(RR_BOUNDED)
    got = port_run(RR_BOUNDED)
    assert got.is_bounded and got.stepper.spec is None
    by = {s.name: s for s in got.cfg.species}
    assert by["beam"].pusher == "boris_rr"
    assert_runs_close(got, ref, 1e-9)
    assert_checksums_close(got.checksums(), ref.checksums())
