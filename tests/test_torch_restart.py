"""Checkpoint and restart of the port's periodic 3D tile-binned step (the
path of kernel K1) against the JAX package.

An 8 x 8 x 16 periodic deck of two tiles (thermal electrons, protons at
rest, order 1, sort interval 4) writes a checkpoint at step 6 and runs to
step 12.  A second port simulation loads the checkpoint and runs to 12: its
state equals the uninterrupted port run's bit for bit (the kernels' plain
versions are deterministic on the CPU), and both land within 1e-9 of the
JAX package's uninterrupted run.  CPU, float64.
"""

import numpy as np
import pytest
import torch

from warpx_tpu_torch.core.state import state_to_numpy
from warpx_tpu_torch.io.checkpoint import load_checkpoint

from .test_torch_bounded_util import assert_checksums
from .test_torch_io import jax_from_deck, port_from_deck

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

PERIODIC_3D = """
max_step = 12
amr.n_cell = 8 8 16
geometry.dims = 3
geometry.prob_lo = -4.e-6 -4.e-6 -8.e-6
geometry.prob_hi =  4.e-6  4.e-6  8.e-6
warpx.cfl = 0.98
warpx.sort_intervals = 4
algo.particle_shape = 1
particles.species_names = electrons protons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.01
electrons.uy_th = 0.01
electrons.uz_th = 0.01
protons.species_type = proton
protons.injection_style = NUniformPerCell
protons.num_particles_per_cell_each_dim = 1 1 1
protons.profile = constant
protons.density = 1.e24
protons.momentum_distribution_type = at_rest
tpu.tiled_particles = on
diagnostics.diags_names = chk
chk.format = checkpoint
chk.intervals = 6:6
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("restart3d")
    ref = jax_from_deck(PERIODIC_3D, root / "jax")
    assert ref.tile_spec is not None
    ref.evolve()
    got = port_from_deck(PERIODIC_3D, root / "port")
    assert got.binned and not got.is_bounded
    got.evolve()
    # checksums() wraps the positions: keep the state the run ended in
    return {"root": root, "jax_sums": ref.checksums(), "port": got,
            "port_state": state_to_numpy(got.state)}


def test_uninterrupted_port_matches_jax(runs):
    assert (runs["root"] / "port" / "chk000006" / "state.npz").exists()
    assert_checksums(runs["jax_sums"], runs["port"].checksums())


def test_restart_is_bitwise(runs, tmp_path):
    sim = port_from_deck(PERIODIC_3D, tmp_path)
    sim.state, sim.is_synchronized = load_checkpoint(
        str(runs["root"] / "port" / "chk000006"), sim.state)
    assert sim.state.step == 6
    sim.evolve()
    got, ref = state_to_numpy(sim.state), runs["port_state"]
    assert got["step"] == ref["step"] == 12 and got["time"] == ref["time"]
    for nm, a in ref["fields"].items():
        np.testing.assert_array_equal(got["fields"][nm], a, err_msg=nm)
    for name, sp in ref["species"].items():
        for k, a in sp.items():
            np.testing.assert_array_equal(got["species"][name][k], a,
                                          err_msg=f"{name}.{k}")
    for k, a in ref["aux"].items():
        np.testing.assert_array_equal(got["aux"][k], a, err_msg=k)
    assert_checksums(runs["jax_sums"], sim.checksums())
