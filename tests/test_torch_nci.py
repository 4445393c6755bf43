"""The Godfrey NCI corrector in the port against the JAX package.

``nci_godfrey_stencil`` over c dt/dz in [0, 1] for both coefficient sets
and both gathers (exact), ``apply_z_stencil`` (1e-12); 5 steps of
``tests/test_nci.py``'s gamma = 10 drifting pair plasma on the periodic
per-particle step; the bounded 32 x 64 laser-wakefield deck with
``particles.use_fdtd_nci_corr = 1``, per particle against the JAX package,
and the port's tile-binned step (the plain version of K1c on the CPU)
against its own per-particle step.  CPU, float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu import constants
from warpx_tpu.core.config import SimConfig as JSimConfig
from warpx_tpu.core.config import SpeciesConfig as JSpeciesConfig
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.solvers import filter as jfilter
from warpx_tpu.solvers.yee import compute_dt_yee
from warpx_tpu_torch.core.step import _apply_nci
from warpx_tpu_torch.solvers import filter as tfilter
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import LWFA_2D, jax_config, run_jax
from .test_torch_models_util import (assert_checksums_grouped,
                                     assert_runs_agree, port_config,
                                     rel_err, run_both)

NCI_DECK = (LWFA_2D.replace("max_step = 12", "max_step = 6")
            + "particles.use_fdtd_nci_corr = 1\n")


@pytest.mark.parametrize("coeff_set", ["ExEyBz", "BxByEz"])
@pytest.mark.parametrize("nodal", [False, True])
def test_stencil_matches_jax(coeff_set, nodal):
    for cdtodz in np.linspace(0.0, 1.0, 57):
        got = tfilter.nci_godfrey_stencil(cdtodz, coeff_set, nodal)
        ref = jfilter.nci_godfrey_stencil(cdtodz, coeff_set, nodal)
        np.testing.assert_array_equal(got, ref)
        # a smoother: the stencil's weights sum to one (2 s0 + 2 sum s_k)
        assert abs(2 * got.sum() - 1.0) < 1e-12


@pytest.mark.parametrize("shape,axis", [((12, 20), 1), ((6, 5, 16), 2),
                                        ((16, 9), 0)])
def test_apply_z_stencil_matches_jax(shape, axis):
    a = np.random.default_rng(axis).normal(size=shape)
    s = jfilter.nci_godfrey_stencil(0.7, "ExEyBz", False)
    got = tfilter.apply_z_stencil(torch.from_numpy(a), s, axis).numpy()
    assert rel_err(got, jfilter.apply_z_stencil(jnp.asarray(a), s, axis)) \
        <= 1e-12


def _drift_cfg(nci=True):
    """tests/test_nci.py's cold gamma = 10 electron-ion plasma drifting
    along z on a periodic 32^2 grid, order 3."""
    geom = JGeometry(2, (32, 32), (0.0, 0.0), (16e-6, 16e-6), (True, True))
    uz = np.sqrt(10.0 ** 2 - 1.0)
    species = tuple(
        JSpeciesConfig(
            name=nm, charge=q, mass=m, injection_style="nuniformpercell",
            num_particles_per_cell_each_dim=(2, 2), profile="constant",
            density=1.0e27, momentum_distribution="gaussian", uz=uz,
            ux_th=1e-3, uy_th=1e-3, uz_th=1e-3)
        for nm, q, m in (("electrons", -constants.q_e, constants.m_e),
                         ("ions", constants.q_e, 5.0 * constants.m_e)))
    return JSimConfig(geometry=geom, max_step=10 ** 9,
                      dt=compute_dt_yee(geom, 0.98), particle_shape=3,
                      species=species, use_nci_corr=nci)


def test_apply_nci_filters_the_gather_fields():
    jcfg = _drift_cfg()
    cfg = port_config(jcfg)
    rng = np.random.default_rng(5)
    farr = {nm: rng.normal(size=(32, 32))
            for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")}
    from warpx_tpu.core.step import _apply_nci as j_apply_nci

    ref = j_apply_nci({k: jnp.asarray(v) for k, v in farr.items()}, jcfg)
    got = _apply_nci({k: torch.from_numpy(v) for k, v in farr.items()}, cfg)
    for nm in farr:
        assert rel_err(got[nm].numpy(), ref[nm]) <= 1e-12, nm


def test_drifting_plasma_run_matches_jax():
    """Five steps of the drifting plasma through the corrector, per
    particle (the periodic binned gate refuses the corrector)."""
    jsim, sim = run_both(_drift_cfg(), 5)
    assert not sim.binned
    assert_runs_agree(jsim, sim)


def test_bounded_deck_per_particle_matches_jax():
    jsim, _ = run_jax(NCI_DECK, tiled="off")
    cfg = port_config(jax_config(NCI_DECK, "off"))
    assert cfg.use_nci_corr
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
    assert not sim.binned
    sim.init()
    sim.evolve()
    assert_runs_agree(jsim, sim)


def test_bounded_deck_binned_matches_per_particle():
    """The tile-binned bounded step (the plain version of K1c reads the
    corrected padded block) against the per-particle step, rebinning every
    step (the binned step injects on rebin steps only)."""
    text = NCI_DECK.replace("warpx.sort_intervals = 4",
                            "warpx.sort_intervals = 1")
    sims = {}
    for tiled, nci in (("on", 1), ("off", 1), ("on", 0)):
        sim = warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(text.replace("use_fdtd_nci_corr = 1",
                                          f"use_fdtd_nci_corr = {nci}")
                             + f"tpu.tiled_particles = {tiled}\n"),
            dtype=torch.float64, device="cpu")
        assert sim.binned == (tiled == "on")
        sim.init()
        sim.evolve()
        sims[tiled, nci] = sim.checksums()
    assert_checksums_grouped(sims["off", 1], sims["on", 1], 1e-9)
    # the corrector changes the run
    ez = [sims[k]["lev=0"]["Ez"] for k in (("on", 1), ("on", 0))]
    assert abs(ez[0] - ez[1]) > 1e-6 * abs(ez[1])
