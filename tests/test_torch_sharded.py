"""The port's spatially decomposed simulation (``DistSimulation``,
``core/sharded_step.py``) against the JAX package's.

A 2D Langmuir deck written here (its current has a curl, so that B is a
physical field and not the roundoff of a sum) (``tests/test_sharded.py``'s needs the
reference checkout) at the meshes {"z": 4}, {"x": 2} and {"x": 2, "z": 2},
one with direct deposition at order 2, and a 3D deck at {"z": 2} run through
``warpx_tpu.DistSimulation`` in-process on the virtual CPU devices and
through the port's over gloo ranks (``launch.run_ranks``, started once for
the module) in float64: the gathered state slot by slot within 1e-9 of
JAX's (fields per element, against the largest component of their kind),
checksums within 1e-9, and fields and particle multisets within 1e-9 of
the port's single-device run.  Then the half push
alone, a hot deck whose exchange buffers overflow (``lost`` equal to
JAX's, ``assert_no_lost`` raising in both), JAX's refusals word for word,
and the card default.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import warpx_tpu_torch
from warpx_tpu.core.deck import config_from_deck as jax_config_from_deck
from warpx_tpu.core.simulation import DistSimulation as JDistSimulation
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.simulation import DistSimulation
from warpx_tpu_torch.parallel.launch import init_single_rank, run_ranks
from warpx_tpu_torch.parallel.programs import run_jobs
from warpx_tpu_torch.parallel.topology import rank_device
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import assert_checksums, port_config

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

RTOL = 1e-9
FIELDS = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")

LANGMUIR_2D = """
max_step = 5
amr.n_cell = 32 32
geometry.dims = 2
geometry.prob_lo = -20.e-6 -20.e-6
geometry.prob_hi =  20.e-6  20.e-6
boundary.field_lo = periodic periodic
boundary.field_hi = periodic periodic
algo.current_deposition = esirkepov
algo.particle_shape = 1
warpx.cfl = 1.0
warpx.use_filter = 0
my_constants.epsilon = 0.01
my_constants.k = 157079.63267948965
my_constants.kp = 376357.71
particles.species_names = electrons positrons
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 2 2
electrons.profile = constant
electrons.density = 2.e24
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "epsilon * k/kp * sin(k*x) * cos(k*z)"
electrons.momentum_function_uy(x,y,z) = "0."
electrons.momentum_function_uz(x,y,z) = "0."
positrons.charge = q_e
positrons.mass = m_e
positrons.injection_style = NUniformPerCell
positrons.num_particles_per_cell_each_dim = 2 2
positrons.profile = constant
positrons.density = 2.e24
positrons.momentum_distribution_type = parse_momentum_function
positrons.momentum_function_ux(x,y,z) = "-epsilon * k/kp * sin(k*x) * cos(k*z)"
positrons.momentum_function_uy(x,y,z) = "0."
positrons.momentum_function_uz(x,y,z) = "0."
tpu.tiled_particles = off
"""

THERMAL_3D = """
max_step = 3
amr.n_cell = 16 16 16
geometry.dims = 3
geometry.prob_lo = -8.e-6 -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6  8.e-6
boundary.field_lo = periodic periodic periodic
boundary.field_hi = periodic periodic periodic
algo.current_deposition = esirkepov
algo.particle_shape = 1
warpx.cfl = 0.9
warpx.use_filter = 0
particles.species_names = electrons protons
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = nuniformpercell
electrons.num_particles_per_cell_each_dim = 1 1 2
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.05
electrons.uy_th = 0.05
electrons.uz_th = 0.05
protons.charge = q_e
protons.mass = m_p
protons.injection_style = nuniformpercell
protons.num_particles_per_cell_each_dim = 1 1 1
protons.profile = constant
protons.density = 1.e24
protons.momentum_distribution_type = at_rest
tpu.tiled_particles = off
"""

# a hot dense plasma: more movers a step than a face's buffer holds
HOT_2D = """
max_step = 3
amr.n_cell = 32 32
geometry.dims = 2
geometry.prob_lo = -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6
boundary.field_lo = periodic periodic
boundary.field_hi = periodic periodic
algo.particle_shape = 1
warpx.cfl = 0.9
warpx.use_filter = 0
particles.species_names = electrons
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = nuniformpercell
electrons.num_particles_per_cell_each_dim = 8 8
electrons.profile = constant
electrons.density = 1.e22
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.5
electrons.uy_th = 0.5
electrons.uz_th = 0.5
tpu.tiled_particles = off
"""

DIRECT_2D = LANGMUIR_2D.replace(
    "algo.current_deposition = esirkepov",
    "algo.current_deposition = direct").replace(
    "algo.particle_shape = 1", "algo.particle_shape = 2")

# (id, deck, mesh)
CASES = [("2d-z4", LANGMUIR_2D, {"z": 4}),
         ("2d-x2", LANGMUIR_2D, {"x": 2}),
         ("2d-x2z2", LANGMUIR_2D, {"x": 2, "z": 2}),
         ("2d-direct-z2", DIRECT_2D, {"z": 2}),
         ("3d-z2", THERMAL_3D, {"z": 2})]
HALF_PUSH = ("2d-x2z2-half-push", LANGMUIR_2D, {"x": 2, "z": 2})
OVERFLOW = ("hot-z2", HOT_2D, {"z": 2})


def _world(mesh):
    return int(np.prod(list(mesh.values())))


@pytest.fixture(scope="module")
def port_runs():
    jobs = [("dist", dict(world=_world(m), mesh=m, deck=d))
            for _, d, m in CASES]
    jobs.append(("dist", dict(world=4, mesh=HALF_PUSH[2], deck=HALF_PUSH[1],
                              steps=0, half_push=-0.5)))
    jobs.append(("dist", dict(world=2, mesh=OVERFLOW[2], deck=OVERFLOW[1])))
    res = run_ranks(4, run_jobs, (jobs,), timeout=300)
    names = [c[0] for c in CASES] + [HALF_PUSH[0], OVERFLOW[0]]
    return dict(zip(names, res[0])), dict(zip(names, res[1]))


def jax_run(deck, mesh, steps=-1):
    sim = JDistSimulation(jax_config_from_deck(JDeck.from_string(deck)),
                          mesh)
    sim.init()
    error = None
    try:
        sim.evolve(steps)
    except RuntimeError as e:
        error = str(e)
    return sim, error


def single_run(deck):
    sim = warpx_tpu_torch.Simulation(config_from_deck(Deck.from_string(deck)),
                                     dtype=torch.float64, device="cpu")
    sim.init()
    sim.evolve()
    return sim


def assert_field_close(got, ref, what):
    ref = np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-300)
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max() <= RTOL * scale, (
        what, np.abs(got - ref).max(), scale)


C = 299792458.0


def assert_fields_close(got, ref):
    """Each component within 1e-9 of the largest of its kind: E, J, and B
    against E/c too (a wave with no B, as the Langmuir wave's, leaves B at
    the roundoff of the sums' order)."""
    ref = {nm: np.asarray(ref[nm], np.float64) for nm in FIELDS}
    big = {k: max(np.abs(ref[k + c]).max() for c in "xyz") for k in "EBj"}
    big["B"] = max(big["B"], big["E"] / C)
    for nm in FIELDS:
        assert got[nm].shape == ref[nm].shape, nm
        err = np.abs(got[nm] - ref[nm]).max()
        assert err <= RTOL * big[nm[0]], (nm, err, big[nm[0]])


def assert_state_matches_jax(got, jstate):
    assert_fields_close(got["fields"],
                        {nm: getattr(jstate.fields, nm) for nm in FIELDS})
    for name, jsp in jstate.species.items():
        sp = got["species"][name]
        alive = np.asarray(jsp.alive)
        # the same slots, the same particles in them
        np.testing.assert_array_equal(sp["alive"], alive, err_msg=name)
        for k in ("w", "ux", "uy", "uz", "x", "y", "z"):
            ref = getattr(jsp, k)
            if ref is None:
                assert sp[k] is None
                continue
            assert_field_close(sp[k][alive], np.asarray(ref)[alive],
                               (name, k))


def assert_multisets_match(got, single):
    """The single-device run's fields and particles (as sets: the slots
    differ)."""
    assert_fields_close(got["fields"], {
        nm: getattr(single.state.fields, nm).numpy() for nm in FIELDS})
    for name, sp1 in single.state.species.items():
        a1 = sp1.alive.numpy()
        sp = got["species"][name]
        assert a1.sum() == sp["alive"].sum(), name
        for k in ("w", "ux", "uy", "uz", "x", "y", "z"):
            if getattr(sp1, k) is None:
                continue
            assert_field_close(np.sort(sp[k][sp["alive"]]),
                               np.sort(getattr(sp1, k).numpy()[a1]), (name, k))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dist_matches_jax_and_single(port_runs, case):
    name, deck, mesh = case
    got = port_runs[0][name]
    jsim, err = jax_run(deck, mesh)
    assert err is None and got["lost"] == 0
    assert got["lost"] == int(jsim.state.aux["lost"])
    assert_state_matches_jax(got["state"], jsim.state)
    assert_checksums(jsim.checksums(), got["checksums"])
    single = single_run(deck)
    assert_multisets_match(got["state"], single)
    assert_checksums(single.checksums(), got["checksums"])
    # every rank computed the same checksums by collectives
    assert port_runs[1][name]["checksums"] == got["checksums"]


def test_half_push_matches_jax(port_runs):
    """-dt/2 alone on the initial state (the sharded PushP)."""
    _, deck, mesh = HALF_PUSH
    got = port_runs[0][HALF_PUSH[0]]["state"]
    jsim = JDistSimulation(jax_config_from_deck(JDeck.from_string(deck)),
                           mesh)
    jsim.init()
    js = jsim._half_push(jsim.state, -0.5 * jsim.cfg.dt)
    assert got["step"] == 0
    assert_state_matches_jax(got, js)


def test_exchange_overflow_counts_as_jax(port_runs):
    """More movers than a face's K: the same ``lost`` as JAX, and
    ``assert_no_lost`` raises in both."""
    got = port_runs[0][OVERFLOW[0]]
    jsim, err = jax_run(OVERFLOW[1], OVERFLOW[2])
    n = int(jsim.state.aux["lost"])
    assert n > 0 and got["lost"] == n
    assert err is not None and got["error"] == err
    assert port_runs[1][OVERFLOW[0]]["lost"] == n


# ---- refusals and the device --------------------------------------------

REFUSED = [
    lambda c: dict(geometry=dataclasses.replace(c.geometry, rz=True)),
    lambda c: dict(geometry=dataclasses.replace(
        c.geometry, periodic=(False, True))),
    lambda c: dict(em_solver="psatd"),
    lambda c: dict(electrostatic="labframe"),
    lambda c: dict(evolve_scheme="theta_implicit_em"),
    lambda c: dict(do_moving_window=True),
    lambda c: dict(use_filter=True),
    lambda c: dict(lattice_elements=(("quad", 0.0, 1e-6, 1.0, 1.0),)),
    lambda c: dict(do_qed_schwinger=True),
    lambda c: dict(species=(dataclasses.replace(
        c.species[0], do_field_ionization=True),) + c.species[1:]),
    lambda c: dict(species=(dataclasses.replace(
        c.species[0], do_qed_quantum_sync=True),) + c.species[1:]),
]


@pytest.mark.parametrize("i", range(len(REFUSED)))
def test_refusals_match_jax(i):
    jcfg = jax_config_from_deck(JDeck.from_string(LANGMUIR_2D))
    jbad = dataclasses.replace(jcfg, **REFUSED[i](jcfg))
    with pytest.raises(NotImplementedError) as je:
        JDistSimulation._check_supported(jbad)
    tcfg = port_config(jcfg)
    tbad = dataclasses.replace(tcfg, **REFUSED[i](tcfg))
    with pytest.raises(NotImplementedError) as te:
        DistSimulation._check_supported(tbad)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("change", [
    dict(max_level=1), dict(current_deposition="vay"),
    dict(e_ext_particle=(1.0, 0.0, 0.0)), dict(use_nci_corr=True),
    dict(grid_type="collocated")], ids=str)
def test_port_refuses_what_the_step_would_drop(change):
    cfg = dataclasses.replace(
        config_from_deck(Deck.from_string(LANGMUIR_2D)), **change)
    with pytest.raises(NotImplementedError, match="under sharding"):
        DistSimulation._check_supported(cfg)
    DistSimulation._check_supported(
        config_from_deck(Deck.from_string(LANGMUIR_2D)))


def test_card_is_the_default_device():
    """``device=None`` asks for CUDA and raises without a card; a CUDA rank
    needs NCCL in its group and never falls back to gloo."""
    cfg = config_from_deck(Deck.from_string(LANGMUIR_2D))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DistSimulation(cfg, {"z": 1})
    init_single_rank("gloo")
    try:
        with pytest.raises(RuntimeError, match="nccl"):
            rank_device("cuda:0")
        assert rank_device("cpu") == torch.device("cpu")
        with pytest.raises(ValueError, match="needs 2 ranks"):
            DistSimulation(cfg, {"z": 2}, device="cpu")
    finally:
        dist.destroy_process_group()
