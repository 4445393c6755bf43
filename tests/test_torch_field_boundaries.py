"""The port's FDTD field faces against the JAX package: Silver-Mueller and
the others.

Absorbing Silver-Mueller faces on every side of a 32 x 32 box and of a
16^3 box under Yee (a warm plasma, random initial E and B written into
both packages after init, so that every face's guard and every transverse
component carries a value), per particle and tile-binned (held to the
JAX package's per-particle run); the "none"
faces, which both packages run as zero guards; and the faces the port
refuses with the JAX package or where the JAX package runs something else
(ROADMAP.md Queue C).  CPU, float64, within 1e-9.
"""

import dataclasses

import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_draws_util import (assert_checksums_close, assert_runs_close,
                                    field_hook, jax_run, port_run)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

_BOX = {
    2: """
amr.n_cell = 32 32
geometry.dims = 2
geometry.prob_lo = -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6
""",
    3: """
amr.n_cell = 16 16 16
geometry.dims = 3
geometry.prob_lo = -8.e-6 -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6  8.e-6
""",
}


def box_deck(ndim, face, steps=6, particle_bc="absorbing", extra="",
             ppc=None):
    """A box with ``face`` field boundaries on every side and a warm
    electron plasma, ``ppc`` particles per cell (one by default)."""
    faces = " ".join([face] * ndim)
    pbc = " ".join([particle_bc] * ndim)
    ppc = ppc or ["1"] * ndim
    return f"max_step = {steps}\n" + _BOX[ndim] + f"""
boundary.field_lo = {faces}
boundary.field_hi = {faces}
boundary.particle_lo = {pbc}
boundary.particle_hi = {pbc}
warpx.cfl = 0.98
algo.particle_shape = 2
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = {" ".join(ppc)}
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.1
electrons.uy_th = 0.1
electrons.uz_th = 0.1
""" + extra


def random_fields(jsim, seed=7):
    """Random E (~1e10 V/m) and B (~30 T) of the JAX run's field shapes."""
    rng = np.random.default_rng(seed)
    return {nm: rng.normal(size=np.asarray(
        getattr(jsim.state.fields, nm)).shape)
        * (30.0 if nm[0] == "B" else 1e10)
        for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")}


def run_pair(text, seed=7, tiled=("off",)):
    """The deck through the JAX package per particle and through the port
    (per particle and/or tile-binned), from the same random fields."""
    box = {}

    def jax_hook(sim):
        box["f"] = random_fields(sim, seed)
        field_hook(box["f"], True)(sim)

    j = jax_run(text + "tpu.tiled_particles = off\n", hook=jax_hook)
    ports = {t: port_run(text + f"tpu.tiled_particles = {t}\n",
                         hook=field_hook(box["f"], False), replay=False)
             for t in tiled}
    return ports, j


@pytest.fixture(scope="module")
def sm_runs():
    """Per dimension: the Silver-Mueller box (3 x 3 or 1 x 1 x 3 a cell:
    more than the 8192 particles below which a species keeps its compact
    layout and never reaches the fused kernel) through the JAX package per
    particle and the port per particle and tile-binned."""
    return {ndim: run_pair(box_deck(
        ndim, "absorbing_silver_mueller", steps=4 if ndim == 3 else 6,
        ppc=["3", "3"] if ndim == 2 else ["1", "1", "3"]),
        tiled=("off", "on")) for ndim in (2, 3)}


@pytest.mark.parametrize("ndim,tiled", [(2, "off"), (2, "on"), (3, "off"),
                                        (3, "on")])
def test_silver_mueller_matches_jax(sm_runs, ndim, tiled):
    """Every face and component: the guards hold the fields the curls
    leave alone, and the transverse B there follows the absorbing relation
    once a step.  The tile-binned run is held to the JAX package's
    per-particle one (the same physics; its J sums in another order)."""
    ports, j = sm_runs[ndim]
    p = ports[tiled]
    assert p.is_bounded and p.binned == (tiled == "on")
    assert p.stepper.sm_mask is not None and not p.stepper.slow_species
    # the guard column of every face holds a value the relation wrote
    for nm in ("Bx", "By", "Bz"):
        arr = getattr(p.state.fields, nm).numpy()
        for d in range(ndim):
            if nm[1] == p.cfg.geometry.axis_names[d]:
                continue
            assert np.abs(arr.take(0, axis=d)).max() > 0.0, (nm, d)
            assert np.abs(arr.take(-1, axis=d)).max() > 0.0, (nm, d)
    if tiled == "off":
        assert_runs_close(p, j, 1e-9)
    else:
        # the binned layout holds the particles in another order than the
        # per-particle one; the fields and the checksums compare
        for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"):
            a = getattr(p.state.fields, nm).numpy()
            b = np.asarray(getattr(j.state.fields, nm))
            assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), nm
    assert_checksums_close(p.checksums(), j.checksums(), 1e-9)


def test_silver_mueller_absorbs_a_pulse():
    """A vacuum pulse of the 2D box leaves through the faces: what stays is
    a small part of its peak."""
    text = box_deck(2, "absorbing_silver_mueller", steps=80).replace(
        "electrons.density = 1.e24", "electrons.density = 0.") + """
warpx.E_ext_grid_init_style = parse_E_ext_grid_function
warpx.Ex_external_grid_function(x,y,z) = 0.
warpx.Ey_external_grid_function(x,y,z) = 1.e3*exp(-(x*x+z*z)/(2.e-6)**2)
warpx.Ez_external_grid_function(x,y,z) = 0.
"""
    sim = port_run(text, replay=False)
    peak = 1.0e3
    assert float(sim.state.fields.Ey.abs().max()) < 0.03 * peak


def test_none_faces_match_jax():
    """"none" faces: zero guards in both packages, and no wall node
    zeroed."""
    ports, j = run_pair(box_deck(2, "none"))
    assert_runs_close(ports["off"], j, 1e-9)


def _cfg(text):
    return config_from_deck(Deck.from_string(text))


@pytest.mark.parametrize("face,item", [
    ("damped", "Queue C"),
    ("open", "Queue C"),
])
def test_fdtd_faces_the_jax_package_runs_as_zero_guards(face, item):
    """Damped faces (PSATD's in the reference) and open faces (the
    electrostatic solve's) under Yee: the JAX package runs them as zero
    guards, the port refuses them."""
    cfg = _cfg(box_deck(2, face))
    with pytest.raises(NotImplementedError, match=item):
        warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("change", [
    # the JAX package's refusal of PML beside Silver-Mueller
    lambda c: dataclasses.replace(
        c, field_bc_lo=("absorbing_silver_mueller", "pml")),
    # its bounded PSATD takes periodic, damped and pml faces only
    lambda c: dataclasses.replace(c, em_solver="psatd"),
    # it reads a dimension's lower face for both
    lambda c: dataclasses.replace(
        c, field_bc_lo=("periodic", "absorbing_silver_mueller")),
], ids=["pml", "psatd", "one-sided periodic"])
def test_silver_mueller_refusals_name_queue_c(change):
    cfg = change(_cfg(box_deck(2, "absorbing_silver_mueller")))
    with pytest.raises(NotImplementedError, match="Queue C"):
        warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
