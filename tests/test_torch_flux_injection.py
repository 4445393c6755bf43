"""NFluxPerCell plane injection of the port (``warpx_tpu_torch/core/
flux_injection.py`` and its hook in ``Simulation.evolve``) against the JAX
package, CPU, float64.

``sample_gaussian_flux`` in both rejection schemes and one
``make_flux_injector`` call replay the JAX package's keys
(``tests/test_torch_draws_util.py``) and land on its numbers; a slot no
round accepts keeps the fallback |u_m| + u_th; particles past the last free
slot are dropped as the JAX package drops them; a 16^3 deck (with
Maxwell-Boltzmann electrons and a constant external Bz) and a 32^2 deck
(a parsed flux between flux_tmin and flux_tmax; periodic, and between PEC
walls through the bounded step) with a flux species run 5 steps through
both packages within 1e-9; the binned gates send a flux
species per particle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpx_tpu.core import flux_injection as jflux
from warpx_tpu.core.deck import config_from_deck as jconfig_from_deck
from warpx_tpu.core.state import ParticleState as JParticleState
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch import Simulation
from warpx_tpu_torch.core import flux_injection as tflux
from warpx_tpu_torch.core.binned_step import (binned_supported,
                                              bounded_binned_supported)
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.state import ParticleState
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import LWFA_2D
from .test_torch_draws_util import (_Leaf, assert_checksums_close,
                                    assert_runs_close, assert_species_close,
                                    jax_run, jax_species_numpy, port_run,
                                    port_species_numpy)

torch.set_num_threads(1)

FLUX_3D = """
max_step = 5
amr.n_cell = 16 16 16
geometry.dims = 3
geometry.prob_lo = -8.e-6 -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6  8.e-6
warpx.B_ext_grid_init_style = constant
warpx.B_external_grid = 0. 0. 1.
particles.species_names = electrons protons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = maxwell_boltzmann
electrons.theta = 1.e-4
protons.species_type = proton
protons.injection_style = NFluxPerCell
protons.num_particles_per_cell = 2
protons.surface_flux_pos = -7.e-6
protons.flux_normal_axis = z
protons.flux_direction = 1
protons.flux = 3.e30
protons.momentum_distribution_type = gaussianflux
protons.uz_m = 0.01
protons.ux_th = 0.005
protons.uy_th = 0.005
protons.uz_th = 0.005
"""

# electrons emitted along -x from x = 6 um, a flux that rises along z,
# on from the second step to the fourth (u_m = 0.05 < 0.6 u_th: the
# first rejection scheme)
FLUX_2D = """
max_step = 5
amr.n_cell = 32 32
geometry.dims = 2
geometry.prob_lo = -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6
particles.species_names = ions electrons
ions.species_type = proton
ions.injection_style = NUniformPerCell
ions.num_particles_per_cell_each_dim = 1 1
ions.profile = constant
ions.density = 1.e24
electrons.species_type = electron
electrons.injection_style = NFluxPerCell
electrons.num_particles_per_cell = 3
electrons.surface_flux_pos = 6.e-6
electrons.flux_normal_axis = x
electrons.flux_direction = -1
electrons.flux_profile = parse_flux_function
electrons.flux_function(x,y,z,t) = "1.e30 * (1 + z / 8.e-6)"
electrons.flux_tmin = 1.e-15
electrons.flux_tmax = 6.e-15
electrons.momentum_distribution_type = gaussianflux
electrons.ux_m = 0.05
electrons.ux_th = 0.1
electrons.uy_th = 0.02
electrons.uz_th = 0.03
"""


@pytest.mark.parametrize("u_m,u_th,n", [
    (0.0, 0.1, 4096),     # first scheme, u_m = 0
    (-0.03, 0.1, 4096),   # first scheme, a negative mean
    (0.2, 0.1, 4096),     # second scheme, u_m = 2 u_th
    (0.5, 0.0, 16),       # no spread: u_m everywhere
])
def test_sample_gaussian_flux_replays_jax(u_m, u_th, n):
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jflux.sample_gaussian_flux(key, n, u_m, u_th,
                                                jnp.float64))
    got = tflux.sample_gaussian_flux(_Leaf(key, "cpu"), n, u_m, u_th,
                                     torch.float64, "cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    assert (got >= 0).all() or u_m < 0


class _Reject:
    """A draw source whose candidates are never accepted (every uniform
    1, every normal -1e3: negative candidates)."""

    def split(self, n):
        return (self,) * n

    def uniform(self, shape, dtype):
        return torch.ones(shape, dtype=dtype)

    def normal(self, shape, dtype):
        return torch.full(shape, -1e3, dtype=dtype)


@pytest.mark.parametrize("u_m", [0.0, 0.2])
def test_rejection_fallback_keeps_the_jax_value(u_m):
    """A slot no round accepts keeps |u_m| + u_th, the JAX package's
    fallback (ROADMAP.md Queue C)."""
    u = tflux.sample_gaussian_flux(_Reject(), 8, u_m, 0.1, torch.float64,
                                   "cpu")
    assert torch.equal(u, torch.full((8,), abs(u_m) + 0.1,
                                     dtype=torch.float64))


def _empty(cfg, name, cap, alive_every=0):
    """A flux species' container of ``cap`` slots in both packages, every
    ``alive_every``-th slot already taken (0: none)."""
    ndim = cfg.geometry.ndim
    rng = np.random.default_rng(5)
    cols = {k: rng.normal(size=cap) for k in ("w", "ux", "uy", "uz")}
    alive = np.zeros(cap, bool)
    if alive_every:
        alive[::alive_every] = True
    names = ("x", "z") if ndim == 2 else ("x", "y", "z")
    cols.update({k: rng.normal(size=cap) * 1e-6 for k in names})
    j = JParticleState(**{k: jnp.asarray(v) for k, v in cols.items()},
                       alive=jnp.asarray(alive))
    t = ParticleState(**{k: torch.from_numpy(v) for k, v in cols.items()},
                      alive=torch.from_numpy(alive))
    return j, t


@pytest.mark.parametrize("deck,name,t,cap_of", [
    (FLUX_3D, "protons", 0.0, lambda n: 3 * n),
    (FLUX_2D, "electrons", 2e-15, lambda n: 3 * n),
    # fewer free slots than a step emits: the rest is dropped
    (FLUX_3D, "protons", 0.0, lambda n: n // 2),
], ids=["3d", "2d-parsed", "3d-past-capacity"])
def test_make_flux_injector_replays_jax(deck, name, t, cap_of):
    """One injector call on JAX's keys: positions, momenta, weights and
    the slots taken equal the JAX package's."""
    jcfg = jconfig_from_deck(JDeck.from_string(deck))
    cfg = config_from_deck(Deck.from_string(deck))
    jsp = next(s for s in jcfg.species if s.name == name)
    sp = next(s for s in cfg.species if s.name == name)
    npart, _ = tflux._per_step_count(sp, cfg.geometry)
    assert npart == jflux._per_step_count(jsp, jcfg.geometry)[0]
    j0, t0 = _empty(cfg, name, cap_of(npart), alive_every=3)
    key = jax.random.PRNGKey(7)
    ref = jflux.make_flux_injector(jsp, jcfg.geometry, jcfg.dt,
                                   jnp.float64)(j0, t, key)
    got = tflux.make_flux_injector(sp, cfg.geometry, cfg.dt, torch.float64,
                                   "cpu")(t0, t, _Leaf(key, "cpu"))
    assert_species_close(port_species_numpy(got), jax_species_numpy(ref),
                         1e-12, name)
    placed = int(got.alive.sum()) - int(t0.alive.sum())
    assert placed == min(npart, int((~t0.alive).sum()))


# the 2D deck between PEC walls along z, through the bounded step
FLUX_2D_BOUNDED = FLUX_2D + """
boundary.field_lo = periodic pec
boundary.field_hi = periodic pec
boundary.particle_lo = periodic reflecting
boundary.particle_hi = periodic reflecting
"""


@pytest.mark.parametrize("deck", [FLUX_3D, FLUX_2D, FLUX_2D_BOUNDED],
                         ids=["3d", "2d", "2d-bounded"])
def test_flux_deck_matches_jax(deck):
    """Five steps of a deck with a flux species through both packages (the
    port on JAX's key chain): species, fields and checksums within 1e-9;
    the flux species ran per particle and its slots were sized as the JAX
    package sizes them."""
    j = jax_run(deck)
    p = port_run(deck)
    assert not p.binned and p.is_bounded == (deck is FLUX_2D_BOUNDED)
    name = "protons" if "protons" in deck else "electrons"
    cap = p.state.species[name].capacity
    assert cap == j.state.species[name].capacity
    assert cap == tflux.flux_capacity(
        next(s for s in p.cfg.species if s.name == name), p.cfg.geometry,
        p.cfg.max_step)
    assert int(p.state.species[name].alive.sum()) > 0
    assert_runs_close(p, j, 1e-9)
    assert_checksums_close(p.checksums(), j.checksums(), 1e-9)


def test_flux_species_runs_per_particle():
    """Both binned gates send a flux species per particle: periodic (the
    JAX package's passes it, ROADMAP.md Queue C) and bounded (as the JAX
    package's does)."""
    cfg = config_from_deck(Deck.from_string(FLUX_3D + "tpu.tiled_particles "
                                            "= auto\n"))
    assert not binned_supported(cfg)
    assert binned_supported(dataclasses.replace(cfg, species=cfg.species[:1]))
    lwfa = config_from_deck(Deck.from_string(LWFA_2D))
    flux = dataclasses.replace(lwfa.species[0], name="emitted",
                               injection_style="nfluxpercell",
                               num_particles_per_cell=1, flux=1e30,
                               uz_th=0.01)
    assert bounded_binned_supported(lwfa)
    assert not bounded_binned_supported(dataclasses.replace(
        lwfa, species=lwfa.species + (flux,)))
    sim = Simulation(cfg, dtype=torch.float64, device="cpu")
    assert not sim.binned and sim.draws is not None
