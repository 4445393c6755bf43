"""The port's dynamic load balancing (``DistSimulation.measure_costs``,
``load_balance``, the balanced step) against the JAX package's.

JAX's ``_CORNER_3D`` deck (``tests/test_load_balance.py``: all plasma in
the lowest-z corner of a z-sharded box) at {"z": 4} with
``algo.load_balance_intervals = 2``, in float64, through
``warpx_tpu.DistSimulation`` in-process and the port's over 4 gloo ranks:
at every load balance the same costs before and after, the same decision,
efficiency and assignment; the physics after the repack slot by slot
against JAX's (the repack keeps JAX's global slot order) and against the
port's single-device run.  A uniform plasma is kept in slab mode by the
threshold, as in JAX.  The deck's load-balancing keys are read as JAX's
reader reads them.
"""

import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.deck import config_from_deck as jax_config_from_deck
from warpx_tpu.core.simulation import DistSimulation as JDistSimulation
from warpx_tpu.parallel.load_balance import knapsack_assignment
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.parallel.launch import run_ranks
from warpx_tpu_torch.parallel.programs import run_jobs
from warpx_tpu_torch.utils.parser import Deck

from .test_load_balance import _CORNER_3D
from .test_torch_bounded_util import assert_checksums, port_config
from .test_torch_sharded import (assert_multisets_match,
                                 assert_state_matches_jax)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

MESH = {"z": 4}
CORNER = _CORNER_3D + "\nalgo.load_balance_intervals = 2\n"
UNIFORM = CORNER.replace(
    'electrons.density_function(x,y,z) = "if(z < -6.0e-6, 1.0e20, 0.0)"',
    'electrons.density_function(x,y,z) = "1.0e20"')


@pytest.fixture(scope="module")
def port_runs():
    jobs = [("dist", dict(world=4, mesh=MESH, deck=CORNER)),
            ("dist", dict(world=4, mesh=MESH, deck=UNIFORM, steps=3))]
    res = run_ranks(4, run_jobs, (jobs,), timeout=300)
    return res[0], res[1]


def jax_run(deck, steps=-1):
    """JAX's run with every load balance recorded as the port's job
    records it (the assignment recomputed from the tile costs: JAX keeps
    none)."""
    import math

    cfg = jax_config_from_deck(JDeck.from_string(deck))
    sim = JDistSimulation(cfg, MESH)
    sim.init()
    events = []
    balance = sim.load_balance

    def recorded():
        _, tile_costs, chip_costs, _ = sim.measure_costs()
        adopted = balance()
        nmax = int(math.ceil(len(tile_costs) / 4
                             * cfg.load_balance_knapsack_factor))
        events.append(dict(
            step=int(sim.state.step), tile_costs=tile_costs,
            chip_costs=chip_costs, adopted=adopted,
            assignment=knapsack_assignment(tile_costs, 4, nmax),
            lb_efficiency=float(sim.state.aux["lb_efficiency"]),
            costs_after=sim.measure_costs()[1:3]))
        return adopted

    sim.load_balance = recorded
    sim.evolve(steps)
    return sim, events


@pytest.fixture(scope="module")
def jax_corner():
    return jax_run(CORNER)


def test_balances_decide_as_jax(port_runs, jax_corner):
    got = port_runs[0][0]
    _, events = jax_corner
    assert [e["step"] for e in got["balances"]] == [2, 4]
    assert len(got["balances"]) == len(events)
    for g, j in zip(got["balances"], events):
        assert g["step"] == j["step"]
        np.testing.assert_array_equal(g["tile_costs"], j["tile_costs"])
        np.testing.assert_array_equal(g["chip_costs"], j["chip_costs"])
        assert g["adopted"] == j["adopted"]
        np.testing.assert_array_equal(g["assignment"], j["assignment"])
        assert g["lb_efficiency"] == j["lb_efficiency"]
        for a, b in zip(g["costs_after"], j["costs_after"]):
            np.testing.assert_array_equal(a, b)
    first = got["balances"][0]
    # imbalanced at first: every particle on rank 0
    eff0 = first["chip_costs"].mean() / first["chip_costs"].max()
    assert eff0 < 0.4 and first["adopted"]
    assert first["lb_efficiency"] > 0.85
    after = first["costs_after"][1]
    assert after.mean() / after.max() > 0.85
    assert got["balanced"]


def test_physics_after_repack_matches_jax_and_single(port_runs, jax_corner):
    got = port_runs[0][0]
    jsim, _ = jax_corner
    assert got["lost"] == 0 and got["lb_efficiency"] == float(
        jsim.state.aux["lb_efficiency"])
    assert_state_matches_jax(got["state"], jsim.state)
    assert_checksums(jsim.checksums(), got["checksums"])
    single = warpx_tpu_torch.Simulation(
        config_from_deck(Deck.from_string(_CORNER_3D)), dtype=torch.float64,
        device="cpu")
    single.init()
    single.evolve()
    assert_multisets_match(got["state"], single)
    assert_checksums(single.checksums(), got["checksums"])
    # every rank computed the same checksums by collectives
    assert port_runs[1][0]["checksums"] == got["checksums"]


def test_threshold_keeps_slab_mode_as_jax(port_runs):
    got = port_runs[0][1]
    jsim, events = jax_run(UNIFORM, 3)
    assert not got["balanced"] and not jsim._balanced
    assert [e["adopted"] for e in got["balances"]] == [False]
    assert got["lb_efficiency"] == float(jsim.state.aux["lb_efficiency"])
    assert got["lb_efficiency"] > 0.95
    np.testing.assert_array_equal(got["balances"][0]["assignment"],
                                  events[0]["assignment"])


LB_KEYS = """
algo.load_balance_intervals = 10 20:40:5
algo.load_balance_with_sfc = 1
algo.load_balance_knapsack_factor = 1.5
algo.load_balance_efficiency_ratio_threshold = 1.3
algo.load_balance_costs_update = Heuristic
algo.costs_heuristic_cells_wt = 0.2
algo.costs_heuristic_particles_wt = 0.7
"""


def test_deck_reads_load_balance_keys_as_jax():
    for text in (_CORNER_3D, _CORNER_3D + LB_KEYS):
        got = config_from_deck(Deck.from_string(text))
        assert got == port_config(jax_config_from_deck(
            JDeck.from_string(text)))
    assert got.load_balance_with_sfc and got.costs_heuristic_cells_wt == 0.2
    bad = _CORNER_3D + "algo.load_balance_costs_update = timers\n"
    with pytest.raises(NotImplementedError) as te:
        config_from_deck(Deck.from_string(bad))
    with pytest.raises(NotImplementedError) as je:
        jax_config_from_deck(JDeck.from_string(bad))
    assert str(te.value) == str(je.value)
