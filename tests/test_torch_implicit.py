"""The implicit field solvers of the port (``warpx_tpu_torch/ops/
implicit_gather.py``, ``solvers/implicit.py``) against the JAX package's
(``warpx_tpu/ops/implicit_gather.py``, ``solvers/implicit.py``) on the CPU
in float64: the Esirkepov-stencil gather, the theta- and semi-implicit
Picard steps with JAX's iteration counts, several particle iterations,
Newton-GMRES, the batched GMRES against ``jax.scipy.sparse.linalg.gmres``,
and the energy conservation of theta = 1/2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.deck import config_from_deck as j_config_from_deck
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.ops import implicit_gather as _j_gather_mod
from warpx_tpu.ops.implicit_gather import gather_eb_implicit as j_gather
from warpx_tpu.ops.shapes import spline as j_spline
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.grid import Geometry
from warpx_tpu_torch.core.state import state_to_numpy
from warpx_tpu_torch.diagnostics.reduced import compute_reduced
from warpx_tpu_torch.ops.implicit_gather import _weights, gather_eb_implicit
from warpx_tpu_torch.solvers.implicit import gmres
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_models_util import (RTOL, assert_runs_agree, port_config,
                                     rel_err)

_J_WEIGHTS = _j_gather_mod._weights

DECK = """
max_step = {steps}
amr.n_cell = {cells}
geometry.dims = {dims}
geometry.prob_lo = {lo}
geometry.prob_hi = {hi}
warpx.use_filter = 0
warpx.cfl = 0.5
algo.evolve_scheme = {scheme}
implicit_evolve.theta = {theta}
picard.relative_tolerance = 1.e-11
picard.max_iterations = 60
particles.species_names = electrons ions
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = {ppc}
electrons.profile = constant
electrons.density = 2.e19
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "0.2*sin(2*pi*x/16.e-6)"
electrons.momentum_function_uy(x,y,z) = "0.1*cos(2*pi*z/16.e-6)"
electrons.momentum_function_uz(x,y,z) = "0.15*sin(2*pi*z/16.e-6)"
ions.species_type = proton
ions.injection_style = NUniformPerCell
ions.num_particles_per_cell_each_dim = {ppc}
ions.profile = constant
ions.density = 2.e19
ions.momentum_distribution_type = parse_momentum_function
ions.momentum_function_ux(x,y,z) = "-0.004*cos(2*pi*x/16.e-6)"
ions.momentum_function_uy(x,y,z) = "0.002"
ions.momentum_function_uz(x,y,z) = "0.003*cos(2*pi*z/16.e-6)+0.001"
my_constants.pi = 3.141592653589793
{extra}
"""


def deck_text(dims=2, steps=3, scheme="theta_implicit_em", theta=0.5,
              extra=""):
    n = 16 if dims == 2 else 8
    span = "-8.e-6 " * dims, "8.e-6 " * dims
    return DECK.format(steps=steps, cells=f"{n} " * dims, dims=dims,
                       lo=span[0], hi=span[1], scheme=scheme, theta=theta,
                       ppc="1 " * dims, extra=extra)


def jax_cfg(text, **kw):
    cfg = j_config_from_deck(JDeck.from_string(text))
    return dataclasses.replace(cfg, **kw) if kw else cfg


def both(jcfg, steps):
    jsim = JSimulation(jcfg)
    jsim.init()
    jsim.evolve(steps)
    sim = warpx_tpu_torch.Simulation(port_config(jcfg), dtype=torch.float64,
                                     device="cpu")
    sim.init()
    sim.evolve(steps)
    return jsim, sim


# --------------------------------------------------------------- the gather
def _jax_weights_with_limit(x_new, x_old, order, dtype):
    """The JAX package's ``_weights`` with ov at a particle that does not
    move replaced by the limit of cum / delta, the shape of one order
    less at the half-shifted node (the JAX package takes 1 at every tap
    there; ROADMAP.md Queue C)."""
    i0, sn, so, ov, av = _J_WEIGHTS(x_new, x_old, order, dtype)
    if order >= 1:
        base = i0.astype(x_new.dtype)
        limit = jnp.stack([j_spline(x_new - (base + m) - 0.5, order - 1)
                           for m in range(order + 3)], axis=0)
        ov = jnp.where(x_new == x_old, limit, ov)
    return i0, sn, so, ov, av


def test_still_limit_is_the_moving_weight():
    """The at-rest ov is the JAX package's cum / delta in the limit:
    between x -/+ 5e-6 cells they agree to 5e-11 (the roundoff of
    cum / delta)."""
    x = np.random.default_rng(0).uniform(3.0, 9.0, 200)
    h = 1.0e-5
    for order in (1, 2, 3):
        ref = _J_WEIGHTS(jnp.asarray(x + h / 2), jnp.asarray(x - h / 2),
                         order, None)
        got = _weights(torch.from_numpy(x), torch.from_numpy(x), order)
        np.testing.assert_array_equal(np.asarray(ref[0]), got[0].numpy())
        assert np.abs(np.asarray(ref[3]) - got[3].numpy()).max() < 5e-11
        np.testing.assert_allclose(got[3].sum(0).numpy(), 1.0, rtol=1e-14)


@pytest.mark.parametrize("ndim,order", [(2, 1), (2, 2), (2, 3), (3, 1),
                                        (3, 2), (3, 3)])
def test_gather_matches_jax(ndim, order, monkeypatch):
    """Random fields and particles, a quarter of them standing still (the
    delta == 0 branch of ov, held to its limit), the rest moving up to half
    a cell."""
    monkeypatch.setattr(_j_gather_mod, "_weights", _jax_weights_with_limit)
    rng = np.random.default_rng(7 + 10 * ndim + order)
    n_cell = (16, 12) if ndim == 2 else (8, 6, 10)
    lo = (-1.0e-6,) * ndim
    hi = tuple(l + 0.1e-6 * n for l, n in zip(lo, n_cell))
    jg = JGeometry(ndim, n_cell, lo, hi, (True,) * ndim)
    g = Geometry(ndim, n_cell, lo, hi, (True,) * ndim)
    F = {nm: rng.standard_normal(n_cell)
         for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")}
    n = 300
    pos_n = [lo[d] + rng.random(n) * (hi[d] - lo[d]) for d in range(ndim)]
    step = [rng.uniform(-0.5, 0.5, n) * 0.1e-6 for _ in range(ndim)]
    still = np.arange(n) % 4 == 0
    pos_nph = [p + np.where(still, 0.0, 0.5 * s)
               for p, s in zip(pos_n, step)]
    ref = j_gather([jnp.asarray(p) for p in pos_n],
                   [jnp.asarray(p) for p in pos_nph],
                   {k: jnp.asarray(v) for k, v in F.items()}, jg, order)
    t = torch.from_numpy
    got = gather_eb_implicit([t(p) for p in pos_n], [t(p) for p in pos_nph],
                             {k: t(v) for k, v in F.items()}, g, order,
                             chunk_size=70)
    for a, b in zip(got, ref):
        assert rel_err(a.numpy(), np.asarray(b)) <= RTOL


# ---------------------------------------------------------------- Picard
def picard_count(jcfg, steps_done):
    """The Picard iterations of the JAX package's step ``steps_done`` + 1:
    the least maximum under which its result equals the unbounded run's
    (the JAX step keeps its count inside its while loop)."""
    jsim = JSimulation(jcfg)
    jsim.init()
    jsim.evolve(steps_done)
    start = jsim.state
    full = jsim._step(start)

    def capped(k):
        cap = JSimulation(dataclasses.replace(jcfg, picard_max_iterations=k))
        cap.init()
        return cap._step(start)

    def same(a, b):
        return all(bool(jnp.array_equal(getattr(a.fields, nm),
                                        getattr(b.fields, nm)))
                   for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"))

    return full, capped, same


@pytest.mark.parametrize("scheme,theta", [("theta_implicit_em", 0.5),
                                          ("theta_implicit_em", 0.7),
                                          ("semi_implicit_em", 0.5)])
def test_picard_matches_jax(scheme, theta):
    """Three Picard steps in 2D agree with the JAX package's to 1e-9, and
    each step takes the JAX step's iteration count: capped at the port's
    count the JAX step gives its unbounded result, capped one lower it
    does not."""
    jcfg = jax_cfg(deck_text(2, 3, scheme, theta))
    jsim, sim = both(jcfg, 3)
    assert_runs_agree(jsim, sim)
    counts = [h["iterations"] for h in sim.implicit.history]
    assert len(counts) == 3 and all(1 < c < 60 for c in counts), counts
    full, capped, same = picard_count(jcfg, 2)
    assert same(capped(counts[2]), full)
    assert not same(capped(counts[2] - 1), full)


def test_picard_3d_matches_jax():
    jcfg = jax_cfg(deck_text(3, 2))
    jsim, sim = both(jcfg, 2)
    assert_runs_agree(jsim, sim)


def test_particle_iterations_match_jax():
    """Three ImplicitPushXP iterations a Picard iteration (the deck reader
    fixes one under Picard; the configuration asks for three)."""
    jcfg = jax_cfg(deck_text(2, 2), implicit_max_particle_iterations=3)
    jsim, sim = both(jcfg, 2)
    assert_runs_agree(jsim, sim)


def test_deck_reads_the_implicit_keys():
    text = deck_text(2, 2, extra="""
implicit_evolve.nonlinear_solver = newton
implicit_evolve.max_particle_iterations = 5
newton.max_iterations = 7
newton.relative_tolerance = 1.e-9
newton.absolute_tolerance = 1.e-30
gmres.max_iterations = 90
gmres.restart_length = 15
gmres.relative_tolerance = 1.e-7
gmres.absolute_tolerance = 1.e-31
""")
    got = config_from_deck(Deck.from_string(text))
    assert got == port_config(jax_cfg(text))
    assert (got.implicit_nonlinear, got.implicit_max_particle_iterations,
            got.newton_max_iterations, got.gmres_restart) == (
                "newton", 5, 7, 15)


# ---------------------------------------------------------------- Newton
def test_newton_gmres_matches_jax():
    """Newton-Krylov with the exact Jacobian-vector product at 16², tight
    tolerances."""
    text = deck_text(2, 2, extra="""
implicit_evolve.nonlinear_solver = newton
implicit_evolve.max_particle_iterations = 3
newton.relative_tolerance = 1.e-12
gmres.relative_tolerance = 1.e-10
gmres.restart_length = 12
gmres.max_iterations = 48
""")
    jcfg = jax_cfg(text)
    jsim, sim = both(jcfg, 2)
    assert_runs_agree(jsim, sim)
    last = sim.implicit.history[-1]
    assert last["iterations"] >= 1 and last["gmres_arnoldi"] >= 1


def test_gmres_matches_jax():
    """The port's GMRES and ``jax.scipy.sparse.linalg.gmres(solve_method=
    "batched")`` on one tuple-valued operator: a restart too short to
    converge in one pass, several restarts."""
    rng = np.random.default_rng(3)
    m = rng.standard_normal((19, 19)) + 6.0 * np.eye(19)
    b = rng.standard_normal(19)

    def split(v):
        return v[:12].reshape(4, 3), v[12:]

    def jA(x):
        v = m @ jnp.concatenate([x[0].reshape(-1), x[1]])
        return (v[:12].reshape(4, 3), v[12:])

    def tA(x):
        v = torch.from_numpy(m) @ torch.cat([x[0].reshape(-1), x[1]])
        return (v[:12].reshape(4, 3), v[12:])

    for restart, maxiter in ((5, 6), (19, 1), (40, 2)):
        ref, _ = jax.scipy.sparse.linalg.gmres(
            jA, tuple(jnp.asarray(a) for a in split(b)), tol=1e-9,
            restart=restart, maxiter=maxiter, solve_method="batched")
        stats = {}
        got = gmres(tA, tuple(torch.from_numpy(a) for a in split(b)),
                    tol=1e-9, restart=restart, maxiter=maxiter, stats=stats)
        for a, r in zip(got, ref):
            assert rel_err(a.numpy(), np.asarray(r)) <= RTOL
        assert 1 <= stats["restarts"] <= maxiter


# ---------------------------------------------------------------- energy
def total_energy(sim):
    fe = compute_reduced("FieldEnergy", sim.state, sim.cfg, sim.staggering)
    pe = compute_reduced("ParticleEnergy", sim.state, sim.cfg,
                         sim.staggering)
    return fe["total_lev0(J)"] + pe["total(J)"]


def test_theta_half_conserves_energy():
    """At theta = 1/2 the scheme conserves field plus particle energy to
    the Picard tolerance (the reference's analysis_1d.py gates 1e-14)."""
    text = deck_text(2, 6).replace("picard.relative_tolerance = 1.e-11",
                                   "picard.relative_tolerance = 1.e-14")
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float64, device="cpu")
    sim.init()
    e0 = total_energy(sim)
    drift = 0.0
    for _ in range(6):
        sim.evolve(1)
        drift = max(drift, abs(total_energy(sim) - e0) / e0)
    assert drift < 1e-12, drift
    assert sim.state.step == 6
    assert np.isfinite(state_to_numpy(sim.state)["fields"]["Ex"]).all()
