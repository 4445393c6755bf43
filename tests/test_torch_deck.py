"""The port's front end against the JAX package's: the deck reader
(``utils/parser.py``, ``utils/expression.py``, ``utils/intervals.py``,
``core/deck.py``), ``Simulation.from_deck`` and the CLI
(``python -m warpx_tpu_torch``).

Strings and decks go through both packages: the parsed tables, constants,
expressions and cadences agree (exactly, or within 1e-14 where a
transcendental function is evaluated); each accepted deck gives the JAX
reader's configuration carried across by ``port_config``; every deck with a
feature the port lacks raises ``NotImplementedError`` naming its ROADMAP.md
item.  Runs are float64 on the CPU (the kernels' plain versions).
"""

import importlib.util
import json
import pathlib
import re

import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.deck import config_from_deck as jax_config_from_deck
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.utils.expression import compile_expression as jcompile
from warpx_tpu.utils.expression import evaluate_constant as jevaluate
from warpx_tpu.utils.intervals import IntervalsParser as JIntervals
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.__main__ import main as cli_main
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.utils.expression import compile_expression
from warpx_tpu_torch.utils.expression import evaluate_constant
from warpx_tpu_torch.utils.intervals import IntervalsParser
from warpx_tpu_torch.utils.parser import Deck

from .test_binned_bounded import _LWFA_2D, _PEC_3D
from .test_torch_bounded_util import assert_checksums, port_config
from .test_torch_draws_util import (ION_2D, lwfa_nitrogen_deck, qed_deck,
                                    schwinger_deck)
from .test_torch_radiation_reaction import RR_PERIODIC
from .test_torch_resampling import RESAMPLE_3D

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_BENCH = _load("bench")
_SMOKE = _load("chip_smoke")

# a bounded 2D deck whose plasma has a parsed density and a parsed momentum
# and is continuously injected behind a moving window
PARSED_2D = """
max_step = 12
amr.n_cell = 32 64
geometry.dims = 2
geometry.prob_lo = -15.e-6 -28.e-6
geometry.prob_hi =  15.e-6   6.e-6
boundary.field_lo = pml pml
boundary.field_hi = pml pml
warpx.cfl = 0.98
warpx.do_moving_window = 1
warpx.moving_window_dir = z
warpx.sort_intervals = 4
algo.particle_shape = 2
my_constants.n0 = 2.e23
my_constants.Lz = 4.e-6
my_constants.xw = 10.e-6
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 2 1 1
electrons.zmin = -20.e-6
electrons.do_continuous_injection = 1
electrons.profile = parse_density_function
electrons.density_function(x,y,z) = "n0*(1 + 0.5*sin(z/Lz))*if(abs(x) < xw, 1, 0.25)"
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "0.01*x/xw"
electrons.momentum_function_uy(x,y,z) = "0"
electrons.momentum_function_uz(x,y,z) = "0.02*(z > -10.e-6 and not x > 5.e-6)"
tpu.tiled_particles = on
"""

ACCEPTED = {
    "lwfa_32x64_mixed": _LWFA_2D + "\ntpu.tiled_particles = on\n"
                        "tpu.tile_mxu = mixed\n",
    "pec_16^3": _PEC_3D,
    "bench_lwfa": _BENCH._LWFA_2D_DECK.format(
        max_step=20, nx=32, nz=128, ppcx=1, ppcz=1, interval=4, mxu="mixed"),
    "parsed_2d": PARSED_2D,
    # field ionization, QED with photon species, Schwinger, radiation
    # reaction and both resampling algorithms (the stochastic operators)
    "ionization_2d": ION_2D,
    "lwfa_nitrogen": lwfa_nitrogen_deck(_LWFA_2D),
    "qed_2d": qed_deck(),
    "schwinger_3d": schwinger_deck(3.0),
    "rr_photons_2d": RR_PERIODIC,
    "resampling_3d": RESAMPLE_3D,
}

_TEXT = """
my_constants.a = 2.5
my_constants.b = a*2 + sqrt(4)
my_constants.c = if(b > 6, 1, 0)
my_constants.d = (a < 3 and b > 6) or not (c > 0)
group.vals = 1 2.5e-3 a*b   # a comment
group.flag = true
group.off = 0
group.quoted = "x y" z
group.cont = 1 \\
  2 3
group.expr(x,y,z) = "a*x + y"
"""
_OVERRIDES = ("group.vals=4 5 a", "my_constants.a=3")


def test_deck_parser_matches_jax():
    for over in ((), _OVERRIDES):
        got, ref = Deck.from_string(_TEXT, over), JDeck.from_string(_TEXT, over)
        assert got.table == ref.table
        assert got.my_constants == ref.my_constants
        assert got.get_reals("group.vals") == ref.get_reals("group.vals")
        assert got.get_ints("group.cont") == ref.get_ints("group.cont")
        assert got.get_strings("group.quoted") == ref.get_strings(
            "group.quoted")
        for key in ("group.flag", "group.off", "group.missing"):
            assert got.get_bool(key) == ref.get_bool(key)
        assert got.get_expr_string("group", "expr") == ref.get_expr_string(
            "group", "expr")
        assert got.unused_keys() == ref.unused_keys()


@pytest.mark.parametrize("expr", [
    "2*pi + q_e/m_e", "sqrt(2) + a^2", "if(3 > 2, 1.5, 2)",
    "a < 3 and not a > 4 or 0", "heaviside(-a, 0.5) + sign(a) + fmod(7, a)",
    "exp(-a) * erf(0.3) + atan2(1, a) + log10(a) + pow(a, 3)",
])
def test_evaluate_constant_matches_jax(expr):
    consts = {"a": 2.5}
    assert evaluate_constant(expr, consts) == jevaluate(expr, consts)


_EXACT = [
    "n0*(1 + 0.5*(z > 0))*if(abs(x) < xw, 1, 0.25)",
    "(x > 0 and y < 0) or not z > 0",
    "heaviside(x, 0.5) + sign(y) + floor(z*3) + ceil(x) + fmod(x, 0.3)",
    "u = x*x; v = u + y; max(u, v) - min(y, z) + abs(v)^2",
    "0.02*(z > -0.5 and not x > 0.5)",
]
_TRANSCENDENTAL = [
    "n0*(1 + 0.5*sin(z/Lz))*exp(-x^2/xw)",
    "erf(y) + atan2(y, x) + pow(z, 2) + tanh(y) + cosh(z) + asin(x/4)",
    "log10(abs(x) + 1) + log(2 + y) + sqrt(1 + z*z) + tan(x/3) + acos(y/4)",
]


@pytest.mark.parametrize("expr", _EXACT + _TRANSCENDENTAL)
def test_compile_expression_matches_jax(expr):
    consts = {"n0": 2e23, "Lz": 0.7, "xw": 1.5}
    rng = np.random.default_rng(5)
    xyz = [rng.uniform(-2, 2, 257) for _ in range(3)]
    got = compile_expression(expr, ["x", "y", "z"], consts)(*xyz)
    ref = np.asarray(jcompile(expr, ["x", "y", "z"], consts)(*xyz))
    assert got.dtype == torch.float64 and got.shape == ref.shape
    if expr in _EXACT:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-14, atol=0)
    # a float32 tensor in gives a float32 tensor out
    got32 = compile_expression(expr, ["x", "y", "z"], consts)(
        *(torch.from_numpy(a).float() for a in xyz))
    assert got32.dtype == torch.float32


@pytest.mark.parametrize("spec", ["10", "1:5", "2:20:3", "0:10:2,15", ":8",
                                  "", "n", "3::4"])
def test_intervals_parser_matches_jax(spec):
    consts = {"n": 7.0}
    got, ref = IntervalsParser(spec, consts), JIntervals(spec, consts)
    assert got.is_activated() == ref.is_activated()
    for step in range(40):
        assert got.contains(step) == ref.contains(step)
        assert got.next_contained(step) == ref.next_contained(step)


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_config_from_deck_matches_jax(name):
    text = ACCEPTED[name]
    got = config_from_deck(Deck.from_string(text))
    assert got == port_config(jax_config_from_deck(JDeck.from_string(text)))


_BASE = """
max_step = 2
amr.n_cell = 16 16
geometry.dims = 2
geometry.prob_lo = -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.profile = constant
electrons.density = 1.e24
"""


@pytest.mark.parametrize("extra,item", [
    # 1D decks and villasenor deposition run since Queue A 3-4
    # (tests/test_torch_dims1.py); the window's step range, which the JAX
    # package reads and never uses, is refused (the cases keep their ids)
    pytest.param("warpx.end_moving_window_step = 5", "Queue C",
                 id="geometry.dims = 1\namr.n_cell = 16\n"
                    "geometry.prob_lo = 0\ngeometry.prob_hi = 1.e-6-"
                    "Queue A 3-4"),
    # mesh refinement runs since Queue A 12.1-12.2 (tests/test_torch_mr.py,
    # test_torch_mr_bounded.py): a second level keeps the JAX reader's
    # refusal; RZ runs since Queue A 12.3-12.4 (tests/test_torch_rz*.py):
    # an RZ solver other than Yee and PSATD keeps the JAX reader's refusal
    # (the cases keep their ids)
    pytest.param("geometry.dims = RZ\nalgo.maxwell_solver = ckc", "Queue C",
                 id="geometry.dims = RZ-Queue A 12"),
    pytest.param("amr.max_level = 2", "Queue C",
                 id="amr.max_level = 1-Queue A 12"),
    pytest.param("warpx.start_moving_window_step = 2", "Queue C",
                 id="algo.current_deposition = villasenor-Queue A 3"),
    # the hybrid solver and the electrostatic solvers run since Queue A
    # 11.3's first half (tests/test_torch_hybrid.py,
    # test_torch_electrostatic.py), ECT, the implicit schemes and the
    # embedded boundary since its second half (tests/test_torch_ect.py,
    # test_torch_implicit.py); an embedded boundary under PSATD keeps the
    # JAX reader's refusal.  Hybrid QED and the scraping buffers run since
    # Queue A 11.4 (tests/test_torch_collocated.py,
    # test_torch_particle_walls.py): hybrid QED off PSATD on a collocated
    # grid and current centering on the hybrid grid keep the JAX reader's
    # refusals (the cases keep their ids)
    pytest.param("algo.maxwell_solver = psatd\n"
                 'warpx.eb_implicit_function = "x"', "Queue C",
                 id="algo.maxwell_solver = hybrid-Queue A 11.3"),
    pytest.param("warpx.use_hybrid_QED = 1", "Queue C",
                 id="warpx.do_electrostatic = labframe-Queue A 11.3"),
    pytest.param("algo.evolve_scheme = theta_implicit_em\n"
                 'warpx.eb_implicit_function = "x"\n'
                 "electrons.save_particles_at_eb = 1\n"
                 "warpx.grid_type = hybrid\n"
                 "warpx.do_current_centering = 1", "Queue C",
                 id="algo.evolve_scheme = theta_implicit_em-Queue A 11.3"),
    # collisions run since Queue A 11.1; a collision key neither reader
    # reads still raises, naming Queue C (the case keeps its id)
    pytest.param(
        "collisions.collision_names = c1\nc1.species = electrons electrons\n"
        "c1.frobnicate = 1", "Queue C",
        id="collisions.collision_names = c1\nc1.species = electrons "
           "electrons-Queue A 11.1"),
    # lasy lasers (and their delay) run since Queue A 11.2; a binary laser
    # file neither reader reads (the case keeps its id)
    pytest.param("lasers.names = laser1\nlaser1.binary_file_name = a.bin",
                 "Queue C",
                 id="lasers.names = laser1\nlaser1.delay = 1.e-15-"
                    "Queue A 11.2"),
    # rigid injection runs since Queue A 11.4 (tests/test_torch_beamline
    # .py): a lattice in a boosted frame keeps the JAX reader's refusal,
    # and the plane of a species not listed in
    # particles.rigid_injected_species is read by neither reader (the
    # cases keep their ids)
    pytest.param("electrons.rigid_advance = 0\nwarpx.gamma_boost = 10.\n"
                 "lattice.elements = q1", "Queue C",
                 id="electrons.rigid_advance = 0-Queue A 11.4"),
    pytest.param("electrons.zinject_plane = 0.", "Queue C",
                 id="electrons.zinject_plane = 0.-Queue A 11.4"),
    # the JAX package writes it as a Full diagnostic (the case keeps its id)
    pytest.param(
        "diagnostics.diags_names = diag1\ndiag1.diag_type = TimeAveraged",
        "Queue C",
        id="diagnostics.diags_names = diag1\ndiag1.diag_type = "
           "TimeAveraged-Queue A 11"),
    # ChargeOnEB runs since Queue A 11.3's second half
    # (tests/test_torch_ect.py); its weighting function is read by neither
    # reader (the case keeps its id)
    pytest.param("warpx.reduced_diags_names = r1\nr1.type = ChargeOnEB\n"
                 "r1.weighting_function(x,y,z) = 1.", "Queue C",
                 id="warpx.reduced_diags_names = r1\nr1.type = ChargeOnEB-"
                    "Queue A 11.3"),
    # the JAX package runs it with no external field (the case keeps its id)
    pytest.param(
        "particles.E_ext_particle_init_style = parse_e_ext_particle_function",
        "Queue C",
        id="particles.E_ext_particle_init_style = "
           "parse_e_ext_particle_function-Queue A 11"),
    # openPMD files are read since Queue A 11.2, for the external_file
    # style; neither reader reads the key beside another style (the case
    # keeps its id)
    pytest.param("electrons.injection_file = p.h5", "Queue C",
                 id="electrons.injection_file = p.h5-Queue A 11.2"),
])
def test_unported_deck_features_raise(extra, item):
    """Nothing is dropped silently: each feature the port lacks raises
    NotImplementedError naming its ROADMAP.md item."""
    deck = Deck.from_string(_BASE + extra + "\n")
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md {re.escape(item)}\)"):
        config_from_deck(deck)


def test_no_physics_keys_are_accepted():
    deck = Deck.from_string(_BASE + "warpx.verbose = 1\n"
                            "amr.max_grid_size = 32\n")
    cfg = config_from_deck(deck)
    # warpx.verbose is read: it asks for the per-step time report
    assert cfg.verbose
    assert deck.unused_keys() == ["amr.max_grid_size"]


def _port_from_deck(text, **kw):
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float64, device="cpu", **kw)
    sim.init()
    return sim


def _jax_from_deck(text):
    sim = JSimulation.from_deck(JDeck.from_string(text))
    sim.init()
    return sim


def test_lwfa_mixed_from_deck_matches_jax():
    """``_LWFA_2D`` at tile_mxu = mixed through ``Simulation.from_deck`` in
    both packages, 12 steps: checksums within 1e-9."""
    text = ACCEPTED["lwfa_32x64_mixed"]
    ref, got = _jax_from_deck(text), _port_from_deck(text)
    assert got.binned and got.cfg.tile_mxu == "mixed"
    assert isinstance(got.deck, Deck)
    ref.evolve()
    got.evolve()
    assert_checksums(ref.checksums(), got.checksums())


def test_parsed_profiles_match_jax():
    """The parsed density and momentum: the initial particles within 1e-12
    of the JAX package's; then 12 steps of continuous injection behind the
    moving window, checksums within 1e-9 and the same particle count."""
    ref, got = _jax_from_deck(PARSED_2D), _port_from_deck(PARSED_2D)
    for name, sp in ref.state.species.items():
        mine = got.state.species[name]
        np.testing.assert_array_equal(mine.alive.numpy(),
                                      np.asarray(sp.alive))
        for k in ("x", "z", "ux", "uy", "uz", "w"):
            a = np.asarray(getattr(sp, k))
            err = np.abs(getattr(mine, k).numpy() - a).max()
            assert err <= 1e-12 * np.abs(a).max(), (k, err)
    assert float(np.abs(np.asarray(ref.state.species["electrons"].uz)).max()
                 ) > 0
    n0 = int(got.state.species["electrons"].alive.sum())
    ref.evolve()
    got.evolve()
    assert_checksums(ref.checksums(), got.checksums())
    n = int(got.state.species["electrons"].alive.sum())
    assert n > n0
    assert n == int(np.asarray(ref.state.species["electrons"].alive).sum())


def test_cli_prints_the_checksums(tmp_path, capsys):
    deck = tmp_path / "inputs"
    deck.write_text(PARSED_2D + "\namr.max_grid_size = 32\n")
    assert cli_main([str(deck), "max_step=6", "--device", "cpu", "--steps",
                     "3", "--checksums"]) == 0
    out, err = capsys.readouterr()
    assert out.startswith("completed 3 steps in ")
    printed = json.loads(out[out.index("\n") + 1:])
    sim = warpx_tpu_torch.Simulation.from_deck(
        str(deck), overrides=("max_step=6",), dtype=torch.float64,
        device="cpu")
    sim.init()
    sim.evolve(3)
    assert printed == json.loads(json.dumps(sim.checksums()))
    assert "unused deck keys: amr.max_grid_size" in err


def test_cli_without_gpu_raises(tmp_path, monkeypatch):
    deck = tmp_path / "inputs"
    deck.write_text(_BASE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main([str(deck)])
    # the output flags do not move the run to the CPU
    for flag in ("--output-dir", "--restart"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_main([str(deck), flag, str(tmp_path)])


def test_chip_smoke_deck_copies():
    """chip_smoke.py keeps its own copies of the deck texts it runs (it
    imports neither bench.py nor the tests): they must stay equal."""
    assert _SMOKE.LWFA_2D_DECK == _BENCH._LWFA_2D_DECK
    assert _SMOKE.LWFA_32X64_DECK == _LWFA_2D


def test_chip_smoke_stochastic_deck_copies():
    """The decks of chip_smoke.py's stochastic_parity are the tests' (its
    own copies: it imports neither JAX nor the tests)."""
    assert _SMOKE.ION_2D_DECK == ION_2D
    assert (_SMOKE.lwfa_nitrogen_deck(_SMOKE.LWFA_32X64_DECK)
            == lwfa_nitrogen_deck(_LWFA_2D))
    assert _SMOKE.qed_deck() == qed_deck()
    assert _SMOKE.schwinger_deck(3.0) == schwinger_deck(3.0)
    assert _SMOKE.RR_PERIODIC_DECK == RR_PERIODIC
    assert _SMOKE.RESAMPLE_3D_DECK == RESAMPLE_3D
