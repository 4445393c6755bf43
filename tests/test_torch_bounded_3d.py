"""The port's bounded step in 3D (PEC walls along z, periodic in x and y,
reflecting particles) against the JAX package.

The 16^3 deck of ``tests/test_binned_bounded.py`` (thermal electrons,
protons at rest, order 2, current filter, 8 steps) runs through both
packages on the CPU in float64.  With the deck's one particle per cell both
species stay under the 8192 particles below which a static species keeps
its compact layout, so the fused 3D kernel never runs; a second run with
three per cell sends both through it (the JAX package's Pallas kernel in
interpret mode, the port's plain version).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpx_tpu.core.boundaries import fill_guards_pec as j_fill_guards_pec
from warpx_tpu.core.bounded_step import make_bounded_kernels
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu_torch.core.boundaries import fill_guards_pec
from warpx_tpu_torch.core.bounded_step import BoundedStepper
from warpx_tpu_torch.core.grid import yee_staggering
from warpx_tpu_torch.core.state import state_from_numpy, state_to_numpy

from .test_torch_bounded_util import (PEC_3D, PEC_3D_BINNED,
                                      assert_checksums, assert_states_close,
                                      jax_state_numpy, jax_state_replace,
                                      port_config, randomize_fields, run_jax,
                                      run_port)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_pec():
    out = {}
    for name, deck in (("compact", PEC_3D), ("binned", PEC_3D_BINNED)):
        sim, _ = run_jax(deck, "on")
        assert sim.tile_spec is not None
        out[name] = {"cfg": sim.cfg, "sums": sim.checksums(),
                     "slow": set(sim._binned_slow_species)}
    return out


@pytest.mark.parametrize("tiled", ["on", "off"])
@pytest.mark.parametrize("deck", ["compact", "binned"])
def test_pec3d_checksums_match_jax(jax_pec, deck, tiled):
    ref = jax_pec[deck]
    sim = run_port(port_config(ref["cfg"], tiled_particles=tiled))
    assert sim.is_bounded and sim.binned == (tiled == "on")
    assert_checksums(ref["sums"], sim.checksums())
    if tiled == "on":
        # the fused kernel ran for the species the JAX package ran it for
        assert set(sim.stepper.slow_species) == ref["slow"]
        assert len(sim.stepper.binned_cfgs) == (2 if deck == "binned" else 0)
        aux = sim.state.aux
        assert int(aux["tile_overflow"]) == int(aux["tile_violations"]) == 0
        assert "window_lo" not in aux and sim.stepper.smax == 0


@pytest.fixture(scope="module")
def one_steps(jax_pec):
    """Two rounds of step_main + step_window and a half push, per-particle,
    from the deck's state after 3 steps with random fields."""
    jcfg = dataclasses.replace(jax_pec["compact"]["cfg"],
                               tiled_particles="off")
    jsim = JSimulation(jcfg)
    jsim.init()
    jsim.evolve(3)
    data = randomize_fields(jax_state_numpy(jsim.state), seed=13)
    # send some electrons through each wall
    el = data["species"]["electrons"] = {
        k: None if a is None else a.copy()
        for k, a in data["species"]["electrons"].items()}
    geom = jcfg.geometry
    el["z"][:40] = geom.prob_hi[2] - 0.01 * geom.dx[2]
    el["uz"][:40] = 1.0e8
    el["z"][40:80] = geom.prob_lo[2] + 0.01 * geom.dx[2]
    el["uz"][40:80] = -1.0e8
    step_main, step_window, half_push, _ = make_bounded_kernels(
        jcfg, jsim.staggering, jnp.float64)
    js = jax_state_replace(jsim.state, data)
    cfg = port_config(jcfg)
    stepper = BoundedStepper(cfg, yee_staggering(3), torch.float64, "cpu")
    ts = state_from_numpy(data, torch.float64, "cpu")
    out_j, out_t = [], []
    for _ in range(2):
        js = step_main(js)
        ts = stepper.step_main(ts)
        out_j.append(jax_state_numpy(js))
        out_t.append(state_to_numpy(ts))
        js = step_window(js, jnp.asarray(False))
        ts = stepper.step_window(ts, False)
        out_j.append(jax_state_numpy(js))
        out_t.append(state_to_numpy(ts))
    out_j.append(jax_state_numpy(half_push(js, dt_half=-0.5 * jcfg.dt)))
    out_t.append(state_to_numpy(stepper.half_push(ts, -0.5 * cfg.dt)))
    return out_j, out_t


@pytest.mark.parametrize("k,what", [
    (0, "step_main"), (1, "step_window"), (2, "step_main, second"),
    (3, "step_window, second"), (4, "half_push"),
])
def test_bounded_functions_3d_match_jax(one_steps, k, what):
    """pad_eb with periodic wraps and PEC mirrors, fold_and_crop's periodic
    fold, the 3D curl terms, enforce_walls (step_main); reflecting faces
    (step_window); the padded gather (half_push): slot by slot at 1e-12."""
    out_j, out_t = one_steps
    if k == 1:
        # the electrons sent through the walls came back
        before, after = (out_j[i]["species"]["electrons"] for i in (0, 1))
        assert np.all(before["uz"][:40] > 0) and np.all(after["uz"][:40] < 0)
        assert np.all(after["uz"][40:80] > 0)
        assert np.all(np.abs(after["z"][:80]) < 8e-6)
        assert np.all(np.abs(before["z"][:80]) > 8e-6)
    assert_states_close(out_t[k], out_j[k])


@pytest.mark.parametrize("ckc", [False, True])
def test_ckc_bounded_step_matches_jax(jax_pec, ckc):
    """One step_main with the CKC solver's upward stencil in the B push."""
    solver = "ckc" if ckc else "yee"
    base = jax_pec["compact"]["cfg"]
    from warpx_tpu.solvers.yee import compute_dt_ckc

    jcfg = dataclasses.replace(
        base, tiled_particles="off", em_solver=solver,
        dt=compute_dt_ckc(base.geometry, 0.98) if ckc else base.dt)
    jsim = JSimulation(jcfg)
    jsim.init()
    data = randomize_fields(jax_state_numpy(jsim.state), seed=17)
    step_main = make_bounded_kernels(jcfg, jsim.staggering, jnp.float64)[0]
    ref = jax_state_numpy(step_main(jax_state_replace(jsim.state, data)))
    stepper = BoundedStepper(port_config(jcfg), yee_staggering(3),
                             torch.float64, "cpu")
    got = state_to_numpy(stepper.step_main(
        state_from_numpy(data, torch.float64, "cpu")))
    assert_states_close(got, ref)


@pytest.mark.parametrize("nodal", [True, False])
@pytest.mark.parametrize("tangential", [True, False])
@pytest.mark.parametrize("side", ["lo", "hi"])
def test_fill_guards_pec_matches_jax(nodal, tangential, side):
    rng = np.random.default_rng(3)
    ng, n = 4, 6
    a = rng.normal(size=(5, n + (1 if nodal else 0) + 2 * ng, 3))
    for zero_wall in (False, True):
        ref = j_fill_guards_pec(jnp.asarray(a), 1, ng, n, nodal, tangential,
                                side, zero_wall)
        t = torch.tensor(a)
        got = fill_guards_pec(t, 1, ng, n, nodal, tangential, side,
                              zero_wall)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(t.numpy(), a)  # input left as it was
