"""Particle resampling of the port (``warpx_tpu_torch/ops/resampling.py``
and ``Simulation.resample``) against the JAX package, CPU, float64.

Both thinnings on JAX's own draws give the same alive masks and, at 1e-12,
the same weights, momenta and positions (the velocity-coincidence bins are
compared first); a 8^3 run with both triggers lands within 1e-9 of the JAX
run per particle; the tile-binned run (the kernels' plain versions) agrees
with the port's per-particle run where the thinning is deterministic and
statistically where it draws; the average-ppc trigger fires on the JAX
package's steps.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.state import ParticleState as JParticleState
from warpx_tpu.ops import resampling as jres
from warpx_tpu_torch.core.grid import Geometry
from warpx_tpu_torch.core.state import ParticleState
from warpx_tpu_torch.ops import resampling as tres
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_draws_util import (ReplayDraws, assert_checksums_close,
                                    assert_runs_close, assert_species_close,
                                    jax_run, jax_species_numpy, port_run,
                                    port_species_numpy)

torch.set_num_threads(1)

C = 299792458.0
GEOM = dict(ndim=3, n_cell=(4, 4, 4), prob_lo=(0.0, 0.0, 0.0),
            prob_hi=(4e-6, 4e-6, 4e-6), periodic=(True, True, True))


def _species(n=4096, seed=3, u_th=0.02):
    rng = np.random.default_rng(seed)
    cols = {k: rng.random(n) * 4e-6 for k in ("x", "y", "z")}
    cols.update({k: rng.normal(size=n) * u_th * C for k in ("ux", "uy",
                                                            "uz")})
    cols["w"] = rng.random(n) * 2.0 + 0.1
    cols["alive"] = rng.random(n) < 0.9
    return cols


def _both(cols):
    j = JParticleState(**{k: jnp.asarray(v) for k, v in cols.items()})
    t = ParticleState(**{k: torch.from_numpy(v.copy())
                         for k, v in cols.items()})
    return j, t


def test_leveling_on_jax_draws():
    j, t = _both(_species())
    key = jax.random.PRNGKey(4)
    ref, _ = jres.leveling_thinning(j, JGeometry(**GEOM), key, 1.5)
    got = tres.leveling_thinning(t, Geometry(**GEOM), ReplayDraws(key), 1.5)
    assert_species_close(port_species_numpy(got), jax_species_numpy(ref),
                         1e-12)
    n0, n1 = t.alive.sum(), int(np.asarray(ref.alive).sum())
    assert 0.3 * n0 < n1 < 0.95 * n0


BINS = {
    "spherical": dict(grid_type="spherical", delta_ur=0.03 * C, n_theta=3,
                      n_phi=2),
    "cartesian": dict(grid_type="cartesian",
                      delta_u=(0.03 * C, 0.03 * C, 0.03 * C)),
}


@pytest.mark.parametrize("grid", ["spherical", "cartesian"])
def test_velocity_coincidence_on_jax_draws(grid):
    """Bins first (an ulp of atan2 or acos could move a particle on a bin
    edge), then the merged species: alive masks bit for bit, the rest at
    1e-12; weight and momentum of the species conserved."""
    cols = _species()
    j, t = _both(cols)
    bins = BINS[grid]
    key = jax.random.PRNGKey(7)
    got_bins = tres.momentum_bins(t, **bins).numpy()
    # the JAX package computes the bins inside the pass: repeat its formula
    if grid == "spherical":
        u = [jnp.asarray(cols[k]) for k in ("ux", "uy", "uz")]
        umag = jnp.sqrt(u[0] ** 2 + u[1] ** 2 + u[2] ** 2)
        ii = ((jnp.arctan2(u[1], u[0]) + math.pi)
              / (2 * math.pi / bins["n_theta"])).astype(jnp.int32)
        jj = (jnp.arccos(jnp.clip(u[2] / jnp.maximum(umag, 1e-300), -1, 1))
              / (math.pi / bins["n_phi"])).astype(jnp.int32)
        kk = (umag / bins["delta_ur"]).astype(jnp.int32)
        ref_bins = np.asarray(ii + jj * bins["n_theta"]
                              + kk * bins["n_theta"] * bins["n_phi"])
        np.testing.assert_array_equal(got_bins, ref_bins)
    ref, _ = jres.velocity_coincidence_thinning(
        j, JGeometry(**GEOM), 1.67262192369e-27, key, **bins)
    got = tres.velocity_coincidence_thinning(
        t, Geometry(**GEOM), ReplayDraws(key), **bins)
    assert_species_close(port_species_numpy(got), jax_species_numpy(ref),
                         1e-12)
    a0, a1 = t.alive, got.alive
    assert int(a1.sum()) < 0.8 * int(a0.sum())
    for k in ("w",):
        tot0 = float(t.w[a0].sum())
        assert abs(float(got.w[a1].sum()) - tot0) < 1e-12 * tot0
    for k in ("ux", "uy", "uz"):
        p0 = float((t.w * getattr(t, k))[a0].sum())
        p1 = float((got.w * getattr(got, k))[a1].sum())
        scale = float((t.w * getattr(t, k).abs())[a0].sum())
        assert abs(p1 - p0) < 1e-12 * scale


RESAMPLE_3D = """
max_step = 6
amr.n_cell = 8 8 8
geometry.dims = 3
geometry.prob_lo = -4.e-6 -4.e-6 -4.e-6
geometry.prob_hi =  4.e-6  4.e-6  4.e-6
warpx.sort_intervals = 4
particles.species_names = electrons ions
electrons.species_type = electron
electrons.injection_style = NRandomPerCell
electrons.num_particles_per_cell = 8
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.01
electrons.uy_th = 0.01
electrons.uz_th = 0.01
electrons.do_resampling = 1
electrons.resampling_trigger_intervals = 2::2
ions.species_type = proton
ions.injection_style = NUniformPerCell
ions.num_particles_per_cell_each_dim = 2 2 2
ions.profile = constant
ions.density = 1.e24
ions.momentum_distribution_type = gaussian
ions.ux_th = 0.001
ions.uy_th = 0.001
ions.uz_th = 0.001
ions.do_resampling = 1
ions.resampling_algorithm = velocity_coincidence_thinning
ions.resampling_algorithm_delta_ur = 1e7
ions.resampling_algorithm_n_theta = 2
ions.resampling_algorithm_n_phi = 2
ions.resampling_trigger_intervals = 3::3
"""


def test_resampling_run_matches_jax():
    """Leveling every 2 steps on the electrons, velocity coincidence every
    3 on the ions, per particle, 6 steps, both packages on the same
    numbers: within 1e-9."""
    text = RESAMPLE_3D + "tpu.tiled_particles = off\n"
    ref = jax_run(text)
    got = port_run(text)
    assert not got.binned
    n_e = int(np.asarray(ref.state.species["electrons"].alive).sum())
    n_i = int(np.asarray(ref.state.species["ions"].alive).sum())
    assert n_e < 0.5 * 4096 and n_i < 0.8 * 4096
    assert_runs_close(got, ref, 1e-9)
    assert_checksums_close(got.checksums(), ref.checksums())


def _port_own(text):
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float64, device="cpu")
    sim.init()
    return sim


def test_binned_resampling_matches_per_particle():
    """The tile-binned run (K1 and K3's plain versions) against the port's
    per-particle run, each on its own generator: the ions' velocity
    coincidence keeps nearly the same count and conserves their weight in
    both; the electrons' leveling keeps their weight within 5 sigma of the
    start in both (its expectation is conserved).  The counts may differ
    by a few: between rebins the binned layout leaves positions unwrapped,
    so an ion that crossed the periodic boundary since the last rebin falls
    into the edge cell, as in the JAX package's binned step."""
    runs = {}
    for tiled in ("on", "off"):
        sim = _port_own(RESAMPLE_3D + f"tpu.tiled_particles = {tiled}\n")
        assert sim.binned == (tiled == "on")
        w0 = {nm: float(sp.w[sp.alive].sum())
              for nm, sp in sim.state.species.items()}
        sim.evolve()
        if sim.binned:
            assert int(sim.state.aux["tile_overflow"]) == 0
            assert int(sim.state.aux["tile_violations"]) == 0
        runs[tiled] = (sim, w0)
    counts = {t: int(s.state.species["ions"].alive.sum())
              for t, (s, _) in runs.items()}
    assert abs(counts["on"] - counts["off"]) <= 0.01 * counts["off"]
    assert counts["off"] < 0.8 * 4096
    for tiled, (sim, w0) in runs.items():
        ions = sim.state.species["ions"]
        assert abs(float(ions.w[ions.alive].sum()) - w0["ions"]) \
            < 1e-12 * w0["ions"]
        el = sim.state.species["electrons"]
        w_el = el.w[el.alive]
        # each pass keeps a particle of weight w below the level L with
        # probability w / L: the spread of the total is sqrt(sum w (L - w))
        n = int(w_el.numel())
        assert n < 0.6 * 4096
        sigma = float(w_el.mean()) * math.sqrt(4096)
        assert abs(float(w_el.sum()) - w0["electrons"]) < 5 * sigma, tiled


def test_average_ppc_trigger_fires_on_jax_steps():
    """A trigger on the average of alive particles per cell (no interval)
    fires on the same steps in both packages: the electrons' alive counts
    after every step agree."""
    text = RESAMPLE_3D.replace(
        "electrons.resampling_trigger_intervals = 2::2",
        "electrons.resampling_trigger_max_avg_ppc = 3.0").replace(
        "ions.do_resampling = 1", "ions.do_resampling = 0") + (
        "tpu.tiled_particles = off\n")
    from warpx_tpu.core.simulation import Simulation as JSimulation
    from warpx_tpu.utils.parser import Deck as JDeck

    j = JSimulation.from_deck(JDeck.from_string(text))
    j.init()
    p = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float64, device="cpu")
    p.draws = ReplayDraws.from_seed(p.cfg.seed)
    p.init()
    seq_j, seq_p = [], []
    for _ in range(6):
        j.evolve(1)
        p.evolve(1)
        seq_j.append(int(np.asarray(j.state.species["electrons"].alive)
                         .sum()))
        seq_p.append(int(p.state.species["electrons"].alive.sum()))
    assert seq_p == seq_j
    # 8, 5.3 and 3.6 per cell fire; below 3 per cell it stops
    assert seq_j[0] < 4096 and len(set(seq_j)) == 3
