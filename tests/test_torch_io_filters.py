"""The particle filters of the port's Full diagnostics against the JAX
package's: ``uniform_stride`` and ``random_fraction`` (with a parsed
``plot_filter_function`` beside them) on the 32 x 64 laser-wakefield deck.

Both filters select by slot, so the deck runs on the per-particle path
(``tpu.tiled_particles = off``), where the slots hold the particles in
injection order in both packages: the written particles must be the same
rows in the same order, within 1e-9 of each column's largest value.  CPU,
float64.
"""

import h5py
import numpy as np
import pytest
import torch

from warpx_tpu.io.plotfile import read_particles as j_read_particles
from warpx_tpu_torch.io.plotfile import read_particles

from .test_binned_bounded import _LWFA_2D
from .test_torch_io import assert_close, jax_from_deck, port_from_deck

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

FILTERS = """
max_step = 8
tpu.tiled_particles = off
diagnostics.diags_names = strided sampled
strided.intervals = 4
strided.fields_to_plot = Ez
strided.electrons.uniform_stride = 3
strided.beam.uniform_stride = 7
sampled.format = openpmd
sampled.intervals = 4
sampled.fields_to_plot = none
sampled.species = electrons beam
sampled.electrons.random_fraction = 0.3
sampled.electrons.plot_filter_function(t,x,y,z,ux,uy,uz) = "z > -20.e-6"
sampled.beam.random_fraction = 0.5
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("filters")
    text = _LWFA_2D + FILTERS
    for name, make in (("jax", jax_from_deck), ("port", port_from_deck)):
        sim = make(text, root / name)
        sim.evolve()
    return root


@pytest.mark.parametrize("step", [4, 8])
@pytest.mark.parametrize("species", ["electrons", "beam"])
def test_uniform_stride_matches_jax(runs, step, species):
    got = read_particles(str(runs / "port" / f"strided{step:06d}"), species)
    want = j_read_particles(str(runs / "jax" / f"strided{step:06d}"),
                            species)
    assert sorted(got) == sorted(want)
    assert len(want["weight"]) > 0
    for k in want:
        assert_close(got[k], want[k], (species, k))


@pytest.mark.parametrize("step", [4, 8])
@pytest.mark.parametrize("species", ["electrons", "beam"])
def test_random_fraction_matches_jax(runs, step, species):
    with h5py.File(runs / "port" / "sampled.h5") as fp, \
            h5py.File(runs / "jax" / "sampled.h5") as fj:
        grp = f"data/{step}/particles/{species}"
        n_all = 100 if species == "beam" else 1274
        for rec in ("position/x", "position/z", "momentum/x", "momentum/y",
                    "momentum/z", "weighting/value"):
            got, want = fp[grp][rec][...], fj[grp][rec][...]
            assert 0 < len(want) < n_all
            assert_close(got, want, (species, rec))
        if species == "electrons":
            assert np.all(fp[grp]["position/z"][...] > -20e-6)
