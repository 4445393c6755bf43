"""The port's continuous injection with Gaussian momenta and parsed
profiles under a moving window, against the JAX package.

A 16 x 64 window moving at c through a plasma whose injected electrons
take Gaussian momenta (the draws replay the JAX package's key chain,
folded with the step and the species, ``tests/test_torch_draws_util.py``)
over a parsed density, per particle and tile-binned (where the injection
waits for the steps before a rebin); the injected momenta's moments over
a constant density; the refusals.  CPU, float64, within 1e-9.
"""

import dataclasses

import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_draws_util import (assert_checksums_close, assert_runs_close,
                                    jax_run, port_run)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

WINDOW = """
max_step = 8
amr.n_cell = 16 64
geometry.dims = 2
geometry.prob_lo = -8.e-6 -24.e-6
geometry.prob_hi =  8.e-6   8.e-6
boundary.field_lo = pec pml
boundary.field_hi = pec pml
warpx.cfl = 0.98
warpx.do_moving_window = 1
warpx.moving_window_dir = z
warpx.moving_window_v = 1.0
warpx.sort_intervals = 4
algo.particle_shape = 2
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 2
electrons.xmin = -6.e-6
electrons.xmax =  6.e-6
electrons.zmin = -20.e-6
electrons.density = 2.e23
electrons.do_continuous_injection = 1
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.01
electrons.uy_th = 0.02
electrons.uz_th = 0.01
electrons.uz_m = 0.001
"""

PROFILES = {
    "constant": "electrons.profile = constant\n",
    "parsed": "electrons.profile = parse_density_function\n"
              "electrons.density_function(x,y,z) = "
              "2.e23*(1+0.5*sin(z*1.e6))*(x*x<2.5e-11)\n",
}


@pytest.mark.parametrize("tiled", ["off", "on"])
def test_gaussian_injection_matches_jax(tiled):
    """Gaussian momenta over a parsed density, per particle (injecting
    every step) and tile-binned (injecting before each rebin)."""
    text = WINDOW + PROFILES["parsed"] + f"tpu.tiled_particles = {tiled}\n"
    j = jax_run(text)
    p = port_run(text)
    assert p.binned == (tiled == "on") and p.draws is not None
    before = port_run(text.replace("max_step = 8", "max_step = 0"))
    n0 = int(before.state.species["electrons"].alive.sum())
    n1 = int(p.state.species["electrons"].alive.sum())
    assert n1 > n0  # the window uncovered cells and they were filled
    assert n1 == int(j.state.species["electrons"].alive.sum())
    if tiled == "off":
        assert_runs_close(p, j, 1e-9)
    assert_checksums_close(p.checksums(), j.checksums(), 1e-9)


def test_injected_momenta_follow_the_deck():
    """The injected electrons' mean and spread of each momentum component
    lie within three standard errors of the deck's."""
    text = (WINDOW.replace("max_step = 8", "max_step = 40")
            + PROFILES["constant"] + "tpu.tiled_particles = off\n")
    sim = port_run(text, replay=False)
    sp = sim.state.species["electrons"]
    new = sp.alive & (sp.z > 8e-6)  # beyond the window's first top edge
    n = int(new.sum())
    assert n > 200
    c = 299792458.0
    for comp, mean, th in (("ux", 0.0, 0.01), ("uy", 0.0, 0.02),
                           ("uz", 0.001, 0.01)):
        u = getattr(sp, comp)[new].numpy() / c
        assert abs(u.mean() - mean) < 3.0 * th / np.sqrt(n), comp
        assert abs(u.std() - th) < 3.0 * th / np.sqrt(2.0 * n), comp


@pytest.mark.parametrize("change", [
    # the JAX package injects the regular lattice for any style
    lambda s: dataclasses.replace(s, injection_style="nrandompercell"),
    # its injection refuses these momenta
    lambda s: dataclasses.replace(s, momentum_distribution="maxwell_boltzmann"),
], ids=["nrandompercell", "maxwell_boltzmann"])
def test_continuous_injection_refusals_name_queue_c(change):
    cfg = config_from_deck(Deck.from_string(WINDOW + PROFILES["constant"]))
    cfg = dataclasses.replace(cfg, species=(change(cfg.species[0]),))
    with pytest.raises(NotImplementedError, match="Queue C"):
        warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
