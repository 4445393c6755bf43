"""The port's beamline physics against the JAX package: the accelerator
lattice, rigid injection and the do_not_* species.

Hard-edged quadrupoles and plasma lenses (``core/step.py::_add_ext`` with
the residence-fraction correction), then whole 16^3 runs of a witness beam
rigid-injected into them, periodic (rigid_advance) and in a PML box
(ballistic, beside species with do_not_push, do_not_gather and
do_not_deposit); rigid injection in the boosted 32 x 64 laser-wakefield
deck; the refusals.  CPU,
float64, within 1e-9.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core import step as jstep
from warpx_tpu.core.deck import config_from_deck as j_config_from_deck
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core import step as tstep
from warpx_tpu_torch.core.binned_step import (binned_supported,
                                               bounded_binned_supported)
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import LWFA_2D, port_config
from .test_torch_draws_util import (assert_checksums_close, assert_runs_close,
                                    jax_run, port_run)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

BEAM_3D = """
max_step = 8
amr.n_cell = 16 16 16
geometry.dims = 3
geometry.prob_lo = -8.e-6 -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6  8.e-6
warpx.cfl = 0.98
algo.particle_shape = 1
particles.species_names = electrons beam
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.profile = constant
electrons.density = 1.e23
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.01
electrons.uy_th = 0.01
electrons.uz_th = 0.01
beam.species_type = electron
beam.injection_style = gaussian_beam
beam.x_rms = 2.e-6
beam.y_rms = 2.e-6
beam.z_rms = 1.e-6
beam.z_m = -4.e-6
beam.npart = 500
beam.q_tot = -1.e-14
beam.momentum_distribution_type = gaussian
beam.uz_m = 50.
beam.ux_th = 0.5
beam.uy_th = 0.5
beam.uz_th = 1.
beam.do_not_deposit = 1
"""

# a drift to z = -6 um, a quadrupole to -1 um, a drift, a plasma lens
LATTICE = """
lattice.elements = d1 q1 d2 l1
d1.type = drift
d1.ds = -6.e-6
q1.type = quad
q1.ds = 5.e-6
q1.dEdx = 1.e14
q1.dBdx = 3.e5
d2.type = drift
d2.ds = 1.e-6
l1.type = plasmalens
l1.ds = 5.e-6
l1.dEdx = 2.e14
l1.dBdx = 1.e5
"""

PEC = "boundary.field_lo = pec pec pec\nboundary.field_hi = pec pec pec\n"
RIGID = "particles.rigid_injected_species = beam\nbeam.zinject_plane = -2.e-6\n"


def test_lattice_fields_match_jax():
    """The quadrupole's and the lens' fields with the fraction of the step
    a particle spends inside each element (HardEdged_K.H:25-46), also for a
    particle at rest on an element's edge."""
    text = BEAM_3D + LATTICE
    cfg = config_from_deck(Deck.from_string(text))
    jcfg = j_config_from_deck(JDeck.from_string(text))
    assert cfg.lattice_elements == jcfg.lattice_elements
    assert [e[0] for e in cfg.lattice_elements] == ["quad", "plasmalens"]
    np.testing.assert_allclose(
        [e[1:] for e in cfg.lattice_elements],
        [(-6e-6, -1e-6, 1e14, 3e5), (0.0, 5e-6, 2e14, 1e5)],
        rtol=1e-14, atol=1e-20)
    rng = np.random.default_rng(3)
    n = 400
    pos = [rng.uniform(-8e-6, 8e-6, n) for _ in range(3)]
    u3 = [rng.normal(0, 1e9, n), rng.normal(0, 1e9, n),
          rng.normal(0, 3e10, n)]
    pos[2][:4] = (-6e-6, -1e-6, 0.0, 5e-6)
    u3[2][:4] = 0.0
    e6 = [rng.normal(0, 1e9, n) for _ in range(6)]
    got = tstep._add_ext([torch.from_numpy(a) for a in e6], cfg,
                         pos=[torch.from_numpy(a) for a in pos],
                         u3=[torch.from_numpy(a) for a in u3])
    ref = jstep._add_ext([jnp.asarray(a) for a in e6], jcfg,
                         pos=[jnp.asarray(a) for a in pos],
                         u3=[jnp.asarray(a) for a in u3])
    for g, r, e in zip(got, ref, e6):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13,
                                   atol=1e-13 * np.abs(e).max())


# the witness of the bounded run is pushed by nothing, and a plasma that
# gathers no field and a positron witness that deposits nothing ride along
DO_NOT = """
particles.species_names = electrons beam still witness
electrons.do_not_gather = 1
still.species_type = electron
still.injection_style = gaussian_beam
still.x_rms = 2.e-6
still.y_rms = 2.e-6
still.z_rms = 1.e-6
still.z_m = 4.e-6
still.npart = 100
still.q_tot = -1.e-14
still.momentum_distribution_type = gaussian
still.uz_m = 5.
still.ux_th = 0.5
still.do_not_push = 1
witness.species_type = positron
witness.injection_style = NUniformPerCell
witness.num_particles_per_cell_each_dim = 1 1 1
witness.profile = constant
witness.density = 1.e23
witness.momentum_distribution_type = gaussian
witness.uz_m = 1.
witness.do_not_deposit = 1
"""


@pytest.mark.parametrize("case", ["periodic", "bounded"])
def test_lattice_and_rigid_injection_match_jax(case):
    """A witness beam (do_not_deposit) rigid-injected at z = -2 um through
    the quadrupole and the lens, per particle (both binned gates send a
    lattice there): periodic with rigid_advance; bounded (PML) advancing
    ballistically upstream of the plane, with a species that is never
    pushed, a plasma that gathers no field and a witness that deposits
    nothing."""
    extra = ""
    if case == "bounded":
        extra = (PEC.replace("pec", "pml") + "beam.rigid_advance = 0\n"
                 + DO_NOT)
    text = BEAM_3D + LATTICE + RIGID + extra
    j = jax_run(text)
    p = port_run(text, replay=False)
    assert not p.binned and p.is_bounded == (case == "bounded")
    assert not (binned_supported(p.cfg) or bounded_binned_supported(p.cfg))
    aux = p.state.aux
    assert float(aux["zinject:beam"]) == float(j.state.aux["zinject:beam"])
    assert float(aux["vzave:beam"]) == pytest.approx(
        float(j.state.aux["vzave:beam"]), rel=1e-14)
    assert_runs_close(p, j, 1e-9)
    assert_checksums_close(p.checksums(), j.checksums(), 1e-9)
    # some of the beam crossed the plane, some did not
    z = p.state.species["beam"].z
    assert bool((z > -2e-6).any()) and bool((z < -2e-6).any())
    # the lattice moved the beam transversely (against a run without it)
    free = port_run(BEAM_3D + RIGID + extra, replay=False)
    dux = (p.state.species["beam"].ux - free.state.species["beam"].ux).abs()
    assert float(dux.max()) > 1e-3 * float(
        free.state.species["beam"].ux.abs().max())
    if case == "bounded":
        init = port_run(text.replace("max_step = 8", "max_step = 0"),
                        replay=False)
        for k in ("x", "y", "z", "ux", "uy", "uz"):
            assert torch.equal(getattr(p.state.species["still"], k),
                               getattr(init.state.species["still"], k)), k


def test_rigid_injection_in_a_boosted_frame_matches_jax():
    """The boosted laser-wakefield deck's beam rigid-injected: the plane
    at z_lab / gamma moves at -v_boost."""
    text = (LWFA_2D.replace("max_step = 12", "max_step = 6")
            + "warpx.gamma_boost = 10.\nwarpx.boost_direction = z\n"
            + "particles.rigid_injected_species = beam\n"
            + "beam.zinject_plane = -13.e-6\n")
    j = jax_run(text)
    p = port_run(text, replay=False)
    assert p.cfg.gamma_boost == 10.0 and not p.binned
    assert float(p.state.aux["zinject:beam"]) == pytest.approx(
        float(j.state.aux["zinject:beam"]), rel=1e-15)
    assert_runs_close(p, j, 1e-9)
    assert_checksums_close(p.checksums(), j.checksums(), 1e-9)


@pytest.mark.parametrize("change", [
    # the JAX package adds the lattice's fields in 3D only
    lambda c: dataclasses.replace(
        c, geometry=dataclasses.replace(
            c.geometry, ndim=2, n_cell=(16, 16), prob_lo=(-8e-6, -8e-6),
            prob_hi=(8e-6, 8e-6), periodic=(True, True))),
], ids=["lattice in 2D"])
def test_lattice_refusals_name_queue_c(change):
    cfg = change(config_from_deck(Deck.from_string(BEAM_3D + LATTICE)))
    with pytest.raises(NotImplementedError, match="Queue C"):
        sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64,
                                         device="cpu")
        sim.init()
        sim.evolve(1)


def test_port_config_carries_the_new_fields():
    """Every field the JAX reader sets for these decks has its counterpart
    in the port's configuration."""
    text = BEAM_3D + LATTICE + RIGID + (
        "beam.save_particles_at_zhi = 1\nboundary.beam.u_th = 0.1\n")
    got = config_from_deck(Deck.from_string(text))
    ref = port_config(j_config_from_deck(JDeck.from_string(text)))
    assert got == ref
    beam = got.species[1]
    assert (beam.zinject_plane, beam.rigid_advance, beam.save_particles_at,
            beam.boundary_u_th) == (-2e-6, True, ("zhi",), 0.1)
