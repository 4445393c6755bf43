"""The electrostatic solvers in the port against the JAX package.

The DST-I and its inverse; ``PoissonSolver.solve`` (with beta2 scaling and
inhomogeneous wall values) and ``apply_op`` on boxes periodic or Dirichlet
along every axis at 1e-9 of the JAX package's, and on mixed boxes against
the discrete operator itself (the JAX package's solve misses it there:
ROADMAP.md Queue C); ``igf_greens_hat`` / ``solve_open_igf``; ``phi_to_e``,
``phi_to_e_beta``, ``phi_to_b``, ``vector_potential_b`` and the collocated
variants; whole ``Simulation`` runs of 3 steps (lab frame with f(t) wall
potentials, relativistic with two drifting species, magnetostatic with the
JAX test's analytic By, an open box through the IGF): fields, phi,
particles and checksums at 1e-9; decks through ``Simulation.from_deck`` and
the CLI.  CPU, float64.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu import constants
from warpx_tpu.core.config import SimConfig as JSimConfig
from warpx_tpu.core.config import SpeciesConfig as JSpeciesConfig
from warpx_tpu.core.deck import config_from_deck as j_config_from_deck
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.solvers import electrostatic as jes
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.__main__ import main as cli_main
from warpx_tpu_torch.core.grid import Geometry
from warpx_tpu_torch.solvers import electrostatic as es
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_models_util import (assert_runs_agree, port_config,
                                     rel_err, run_both)

ep0 = constants.ep0


def _geoms(ndim, periodic, n=None):
    n = n or ((12, 10, 14) if ndim == 3 else (16, 12))
    lo = (0.0,) * ndim
    hi = tuple(1e-5 * (1 + 0.1 * d) for d in range(ndim))
    return (JGeometry(ndim, n, lo, hi, periodic),
            Geometry(ndim=ndim, n_cell=n, prob_lo=lo, prob_hi=hi,
                     periodic=periodic))


def _nodal(jg, periodic, seed, walls_zero=True):
    """A seeded nodal rho (n per periodic dim, n + 1 per bounded one), zero
    on the wall layers; of zero mean on an all-periodic box."""
    shape = tuple(n if p else n + 1 for n, p in zip(jg.n_cell, periodic))
    a = np.random.default_rng(seed).normal(size=shape) * 1e-3
    if walls_zero:
        for d, p in enumerate(periodic):
            if not p:
                a[(slice(None),) * d + (0,)] = 0.0
                a[(slice(None),) * d + (-1,)] = 0.0
    if all(periodic):
        a -= a.mean()
    return a


@pytest.mark.parametrize("m,axis", [(7, 0), (15, 1), (30, 2)])
def test_dst1_and_inverse_match_jax(m, axis):
    shape = [5, 6, 4]
    shape[axis] = m
    x = np.random.default_rng(m).normal(size=shape)
    got = es._dst1(torch.from_numpy(x), axis).numpy()
    assert rel_err(got, jes._dst1(jnp.asarray(x), axis)) <= 1e-12
    back = es._idst1(torch.from_numpy(got), axis).numpy()
    assert rel_err(back, x) <= 1e-12
    assert rel_err(back, jes._idst1(jnp.asarray(got), axis)) <= 1e-12


_UNIFORM = [(2, (False, False)), (2, (True, True)),
            (3, (False, False, False)), (3, (True, True, True))]


@pytest.mark.parametrize("ndim,periodic", _UNIFORM)
@pytest.mark.parametrize("beta2", [None, "drift"])
def test_poisson_solve_matches_jax(ndim, periodic, beta2):
    jg, tg = _geoms(ndim, periodic)
    rho = _nodal(jg, periodic, 3 + ndim)
    b2 = None if beta2 is None else tuple(0.1 * (d + 1) for d in range(ndim))
    ref = jes.PoissonSolver(jg, periodic, beta2=b2)
    got = es.PoissonSolver(tg, periodic, beta2=b2)
    phi = got.solve(torch.from_numpy(rho))
    assert rel_err(phi.numpy(), ref.solve(jnp.asarray(rho))) <= 1e-9
    op = got.apply_op(phi).numpy()
    assert rel_err(op, ref.apply_op(jnp.asarray(phi.numpy()))) <= 1e-12
    inner = tuple(slice(None) if p else slice(1, -1) for p in periodic)
    assert rel_err(op[inner] * ep0, rho[inner]) <= 1e-10


@pytest.mark.parametrize("ndim", [2, 3])
def test_poisson_wall_potential_matches_jax(ndim):
    periodic = (False,) * ndim
    jg, tg = _geoms(ndim, periodic)
    rho = _nodal(jg, periodic, 11)
    phi_b = np.zeros_like(rho)
    phi_b[0] = 3.0
    phi_b[(slice(None),) * (ndim - 1) + (-1,)] = -2.0
    ref = jes.PoissonSolver(jg, periodic).solve(jnp.asarray(rho),
                                                jnp.asarray(phi_b))
    solver = es.PoissonSolver(tg, periodic)
    got = solver.solve(torch.from_numpy(rho), torch.from_numpy(phi_b))
    assert rel_err(got.numpy(), ref) <= 1e-9
    assert np.array_equal(got.numpy()[0], phi_b[0])
    inner = (slice(1, -1),) * ndim
    op = solver.apply_op(got).numpy()
    assert rel_err(op[inner] * ep0, rho[inner]) <= 1e-10


@pytest.mark.parametrize("ndim,periodic", [
    (2, (True, False)), (2, (False, True)), (3, (True, True, False)),
    (3, (False, True, False))])
def test_poisson_solve_mixed_box_inverts_the_operator(ndim, periodic):
    """Periodic along some axes and Dirichlet along others: the solution
    satisfies the discrete operator (the JAX package's solve, whose DST-I
    drops the imaginary part of an earlier FFT, does not: Queue C); the
    operator is the JAX package's."""
    jg, tg = _geoms(ndim, periodic)
    rho = _nodal(jg, periodic, 5)
    beta2 = tuple(0.05 * d for d in range(ndim))
    solver = es.PoissonSolver(tg, periodic, beta2=beta2)
    phi = solver.solve(torch.from_numpy(rho))
    op = solver.apply_op(phi).numpy()
    ref_op = jes.PoissonSolver(jg, periodic, beta2=beta2).apply_op(
        jnp.asarray(phi.numpy()))
    assert rel_err(op, ref_op) <= 1e-12
    inner = tuple(slice(None) if p else slice(1, -1) for p in periodic)
    assert rel_err(op[inner] * ep0, rho[inner]) <= 1e-10
    for d, p in enumerate(periodic):
        if not p:
            assert not phi.numpy()[(slice(None),) * d + (0,)].any()


@pytest.mark.parametrize("n_nodes,cell", [
    ((6, 5, 7), (1e-6, 2e-6, 1.5e-6)), ((9, 8, 5), (3e-7, 3e-7, 9e-7))])
def test_igf_matches_jax(n_nodes, cell):
    ref = jes.igf_greens_hat(n_nodes, cell)
    got = es.igf_greens_hat(n_nodes, cell)
    assert rel_err(got.numpy(), ref) <= 1e-9
    rho = np.random.default_rng(1).normal(size=n_nodes)
    phi = es.solve_open_igf(torch.from_numpy(rho), got).numpy()
    assert rel_err(phi, jes.solve_open_igf(jnp.asarray(rho), ref)) <= 1e-9


@pytest.mark.parametrize("ndim,periodic", [
    (2, (False, False)), (2, (True, False)), (3, (True, True, True)),
    (3, (False, True, False))])
def test_phi_to_fields_match_jax(ndim, periodic):
    jg, tg = _geoms(ndim, periodic)
    phi = _nodal(jg, periodic, 7, walls_zero=False)
    beta = tuple(0.1 + 0.2 * d for d in range(ndim))
    beta3 = (0.3, -0.2, 0.5)
    tp, jp = torch.from_numpy(phi), jnp.asarray(phi)
    for got, ref in [
            (es.phi_to_e(tp, tg, periodic),
             jes.phi_to_e(jp, jg, periodic)),
            (es.phi_to_e_beta(tp, tg, periodic, beta),
             jes.phi_to_e_beta(jp, jg, periodic, beta)),
            (es.phi_to_e_nodal(tp, tg, periodic, beta),
             jes.phi_to_e_nodal(jp, jg, periodic, beta))]:
        for a, b in zip(got, ref, strict=True):
            assert rel_err(a.numpy(), b) <= 1e-12
    A3 = [_nodal(jg, periodic, 20 + i, walls_zero=False) for i in range(3)]
    for got, ref in [
            (es.phi_to_b(tp, tg, periodic, beta3),
             jes.phi_to_b(jp, jg, periodic, beta3)),
            (es.phi_to_b_nodal(tp, tg, periodic, beta3),
             jes.phi_to_b_nodal(jp, jg, periodic, beta3)),
            (es.vector_potential_b([torch.from_numpy(a) for a in A3], tg,
                                   periodic),
             jes.vector_potential_b([jnp.asarray(a) for a in A3], jg,
                                    periodic))]:
        assert set(got) == set(ref)
        for i, b in ref.items():
            assert (got[i] is None) == (b is None), i
            if b is not None:
                assert rel_err(got[i].numpy(), b) <= 1e-12


def _es_species(ndim, **kw):
    bounds = dict(bounds_lo=(2e-6,) * ndim, bounds_hi=(6e-6, 7e-6, 6.5e-6)[
        :ndim]) if ndim else {}
    base = dict(name="electrons", charge=-constants.q_e, mass=constants.m_e,
                injection_style="nuniformpercell",
                num_particles_per_cell_each_dim=(1,) * ndim,
                profile="constant", density=1e22,
                momentum_distribution="gaussian", ux_th=1e-3, uy_th=1e-3,
                uz_th=1e-3, **bounds)
    base.update(kw)
    return JSpeciesConfig(**base)


def _es_cfg(ndim, species, electrostatic="labframe", **kw):
    n = (16,) * ndim
    geom = JGeometry(ndim, n, (0.0,) * ndim, (1e-5,) * ndim, (False,) * ndim)
    base = dict(max_step=3, dt=1e-15, species=species,
                electrostatic=electrostatic, em_solver="none",
                field_bc_lo=("pec",) * ndim, field_bc_hi=("pec",) * ndim,
                particle_bc_lo=("absorbing",) * ndim,
                particle_bc_hi=("absorbing",) * ndim, use_filter=False,
                tiled_particles="off", current_deposition="direct")
    base.update(kw)
    return JSimConfig(geometry=geom, **base)


def test_labframe_wall_potentials_run_matches_jax():
    """2D lab frame between PEC walls whose potentials follow f(t)."""
    cfg = _es_cfg(2, (_es_species(2),), boundary_potentials=(
        ("0", "100*sin(t*1e14)"), ("5", "-3*t*1e15")))
    jsim, sim = run_both(cfg, 3)
    assert_runs_agree(jsim, sim, fields=("phi",))
    phi = sim.state.fields.phi.numpy()
    t = sim.state.time
    assert phi[-1, 5] == pytest.approx(100 * np.sin(t * 1e14), rel=1e-14)
    assert phi[7, 0] == 5.0
    assert phi[7, -1] == pytest.approx(-3 * t * 1e15, rel=1e-14)


def test_relativistic_two_species_run_matches_jax():
    """One solve per species in its rest frame, B = beta x E / c."""
    a = _es_species(2, name="a", momentum_distribution="constant", uz=3.0,
                    ux_th=0.0, uy_th=0.0, uz_th=0.0)
    b = _es_species(2, name="b", charge=constants.q_e,
                    momentum_distribution="gaussian", ux=0.5, uz=1.0)
    jsim, sim = run_both(_es_cfg(2, (a, b), "relativistic"), 3)
    assert_runs_agree(jsim, sim, fields=("phi",))
    assert float(sim.state.fields.By.abs().max()) > 0.0


def _magnetostatic_cfg():
    """tests/test_electrostatic.py::test_magnetostatic_sinusoidal_current:
    a z current J1 sin(kx) on a periodic 32 x 8 x 8 box."""
    L, n = 8e-6, 32
    geom = JGeometry(3, (n, 8, 8), (0.0,) * 3, (L, L / 4, L / 4), (True,) * 3)
    sp = JSpeciesConfig(
        name="electrons", charge=-constants.q_e, mass=constants.m_e,
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=(4, 1, 1),
        profile="parse_density_function",
        density_expr=f"1.0e24*(1+0.5*sin(2*pi*x/{L}))",
        momentum_distribution="constant", uz=0.1)
    return JSimConfig(geometry=geom, max_step=3, dt=1e-18, species=(sp,),
                      electrostatic="labframe-electromagnetostatic",
                      tiled_particles="off"), L


def test_magnetostatic_run_matches_jax_and_ampere():
    cfg, L = _magnetostatic_cfg()
    jsim, sim = run_both(cfg, 3)
    assert_runs_agree(jsim, sim, fields=("phi",))
    sim0 = warpx_tpu_torch.Simulation(port_config(cfg), dtype=torch.float64,
                                      device="cpu")
    sim0.init()
    uz = 0.1
    vz = uz * constants.c / np.sqrt(1 + uz ** 2)
    J1 = -constants.q_e * 1.0e24 * 0.5 * vz
    k = 2 * np.pi / L
    x_by = (np.arange(32) + 0.5) * (L / 32)
    by_th = -(constants.mu0 * J1 / k) * np.cos(k * x_by)
    By = sim0.state.fields.By.numpy()
    assert np.abs(By[:, 0, 0] - by_th).max() / np.abs(by_th).max() < 0.02
    assert np.abs(sim0.state.fields.Bz.numpy()).max() < 0.02 * np.abs(
        by_th).max()


def _open_cfg(n=12):
    """A relativistic Gaussian beam on an all-open 3D box solved through
    the integrated Green function (the shape of the reference's
    open_bc_poisson_solver deck, cut to n^3 cells)."""
    sig = (2e-6, 1.5e-6, 4e-6)
    lo = tuple(-4 * s for s in sig)
    hi = tuple(4 * s for s in sig)
    geom = JGeometry(3, (n,) * 3, lo, hi, (False,) * 3)
    beam = JSpeciesConfig(
        name="electron", charge=-constants.q_e, mass=constants.m_e,
        injection_style="gaussian_beam", x_rms=sig[0], y_rms=sig[1],
        z_rms=sig[2], npart=3000, q_tot=-1e-12,
        momentum_distribution="gaussian", uz=50.0, ux_th=0.01,
        uy_th=0.01, uz_th=0.1)
    return JSimConfig(
        geometry=geom, max_step=3, dt=1e-16, species=(beam,),
        electrostatic="relativistic", em_solver="none",
        poisson_solver="fft", field_bc_lo=("open",) * 3,
        field_bc_hi=("open",) * 3, particle_bc_lo=("absorbing",) * 3,
        particle_bc_hi=("absorbing",) * 3, use_filter=False,
        tiled_particles="off", current_deposition="direct")


def test_open_igf_run_matches_jax():
    jsim, sim = run_both(_open_cfg(), 3)
    assert_runs_agree(jsim, sim, fields=("phi",))
    # B = beta x E / c of the beam's drift
    f = sim.state.fields
    assert float(f.By.abs().max()) > 0.0


def test_mixed_box_run_solves_poisson():
    """x periodic, z between Dirichlet walls at potentials 0 and f(t): the
    stored phi satisfies the discrete operator at every interior node, E
    is -grad(phi), the walls hold f(t); the port alone (Queue C)."""
    from warpx_tpu_torch.diagnostics.fields import deposit_total_rho

    cfg = _es_cfg(2, (_es_species(2, bounds_lo=(), bounds_hi=()),),
                  field_bc_lo=("periodic", "pec"),
                  field_bc_hi=("periodic", "pec"),
                  particle_bc_lo=("periodic", "absorbing"),
                  particle_bc_hi=("periodic", "absorbing"),
                  boundary_potentials=(("", ""), ("0", "50*sin(t*1e15)")))
    tcfg = port_config(dataclasses.replace(
        cfg, geometry=dataclasses.replace(cfg.geometry,
                                          periodic=(True, False))))
    sim = warpx_tpu_torch.Simulation(tcfg, dtype=torch.float64, device="cpu")
    sim.init()
    sim.evolve(2)
    phi = sim.state.fields.phi
    rho = deposit_total_rho(sim.state, tcfg).numpy()
    solver = es.PoissonSolver(tcfg.geometry, (True, False))
    op = solver.apply_op(phi).numpy()
    assert rel_err(op[:, 1:-1] * ep0, rho[:, 1:-1]) <= 1e-10
    ex, ez = es.phi_to_e(phi, tcfg.geometry, (True, False))
    assert rel_err(sim.state.fields.Ex.numpy(), ex.numpy()) == 0.0
    assert rel_err(sim.state.fields.Ez.numpy(), ez.numpy()) == 0.0
    assert float(phi[3, -1]) == pytest.approx(
        50 * np.sin(sim.state.time * 1e15), rel=1e-14)


ES_DECK = """
max_step = 3
amr.n_cell = 16 16
geometry.dims = 2
geometry.prob_lo = 0. 0.
geometry.prob_hi = 1.e-5 1.e-5
boundary.field_lo = pec pec
boundary.field_hi = pec pec
boundary.particle_lo = absorbing absorbing
boundary.particle_hi = absorbing absorbing
boundary.potential_lo_z = 0
boundary.potential_hi_z = 20.*sin(2*pi*t/(4.e-15))
warpx.const_dt = 1.e-15
warpx.use_filter = 0
warpx.do_electrostatic = {es}
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1
electrons.xmin = 2.e-6
electrons.xmax = 6.e-6
electrons.zmin = 2.e-6
electrons.zmax = 7.e-6
electrons.profile = constant
electrons.density = 1.e22
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.001
electrons.uy_th = 0.001
electrons.uz_th = 0.01
electrons.uz_m = 0.5
"""


@pytest.mark.parametrize("es_name", ["labframe", "relativistic",
                                     "labframe-electromagnetostatic"])
def test_es_deck_runs_through_from_deck(es_name):
    text = ES_DECK.format(es=es_name)
    jsim = JSimulation(j_config_from_deck(JDeck.from_string(text)))
    jsim.init()
    jsim.evolve()
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float64, device="cpu")
    assert sim.cfg.electrostatic == es_name
    assert sim.cfg.em_solver == "none"
    assert sim.cfg.current_deposition == "direct"
    sim.init()
    sim.evolve()
    assert_runs_agree(jsim, sim, fields=("phi",))


OPEN_DECK = """
max_step = 3
amr.n_cell = 12 12 12
geometry.dims = 3
geometry.prob_lo = -8.e-6 -6.e-6 -16.e-6
geometry.prob_hi =  8.e-6  6.e-6  16.e-6
boundary.field_lo = open open open
boundary.field_hi = open open open
boundary.particle_lo = absorbing absorbing absorbing
boundary.particle_hi = absorbing absorbing absorbing
warpx.do_electrostatic = relativistic
warpx.poisson_solver = fft
warpx.const_dt = 1.e-16
particles.species_names = beam
beam.species_type = electron
beam.injection_style = gaussian_beam
beam.x_rms = 2.e-6
beam.y_rms = 1.5e-6
beam.z_rms = 4.e-6
beam.x_m = 0.
beam.y_m = 0.
beam.z_m = 0.
beam.npart = 3000
beam.q_tot = -1.e-12
beam.momentum_distribution_type = gaussian
beam.ux_m = 0.
beam.uy_m = 0.
beam.uz_m = 50.
beam.ux_th = 0.01
beam.uy_th = 0.01
beam.uz_th = 0.1
"""


def test_open_fft_deck_runs_through_from_deck():
    """warpx.poisson_solver = fft on an all-open 3D box from a deck (the
    reference deck's filter on, by its default)."""
    jsim = JSimulation(j_config_from_deck(JDeck.from_string(OPEN_DECK)))
    jsim.init()
    jsim.evolve()
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(OPEN_DECK), dtype=torch.float64, device="cpu")
    assert sim.cfg.poisson_solver == "fft" and sim.cfg.use_filter
    sim.init()
    sim.evolve()
    assert_runs_agree(jsim, sim, fields=("phi",))


def _field_model_decks():
    from .test_torch_hybrid import HYBRID_DECK
    from .test_torch_macroscopic import MEDIUM_DECK
    from .test_torch_nci import NCI_DECK

    return {"electrostatic": ES_DECK.format(es="labframe"),
            "open_fft": OPEN_DECK, "hybrid": HYBRID_DECK,
            "macroscopic": MEDIUM_DECK, "nci": NCI_DECK}


@pytest.mark.parametrize("kind", ["electrostatic", "open_fft", "hybrid",
                                  "macroscopic", "nci"])
def test_field_model_decks_run_through_the_cli(kind, tmp_path, capsys):
    """Each model's deck through ``python -m warpx_tpu_torch`` on the CPU:
    its checksums equal an in-process run's."""
    deck = tmp_path / f"inputs_{kind}"
    deck.write_text(_field_model_decks()[kind])
    assert cli_main([str(deck), "--device", "cpu", "--steps", "2",
                     "--checksums"]) == 0
    out, _ = capsys.readouterr()
    printed = json.loads(out[out.index("\n") + 1:])
    sim = warpx_tpu_torch.Simulation.from_deck(
        str(deck), dtype=torch.float64, device="cpu")
    sim.init()
    sim.evolve(2)
    assert printed == json.loads(json.dumps(sim.checksums()))
    assert ("phi" in printed["lev=0"]) == (kind in ("electrostatic",
                                                    "open_fft"))


@pytest.mark.parametrize("change,match", [
    (dict(poisson_solver="fft"), "requires 3D open boundaries"),
    (dict(field_bc_lo=("open", "open"), field_bc_hi=("open", "open")),
     "need warpx.poisson_solver = fft"),
    (dict(field_bc_lo=("pml", "pec")), r"ROADMAP\.md Queue C"),
])
def test_es_gates_raise(change, match):
    cfg = port_config(_es_cfg(2, (_es_species(2),)), **change)
    with pytest.raises(NotImplementedError, match=match):
        warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
