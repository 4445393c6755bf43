"""The port's output path against the JAX package's: the plotfile writer
byte for byte, and the 32 x 64 laser-wakefield deck with outputs (a
plotfile of Ex Ez By jz rho and both species, an openPMD file of the
electrons under a particle filter, reduced FieldEnergy and ParticleNumber,
a checkpoint at step 6) run for 12 steps through ``Simulation.from_deck``
in both packages on the CPU in float64.

The two packages lay the tile-binned slots out in different orders (the
JAX package's sort is not stable), so particle columns are compared as
multisets: rows sorted by their quantized values, then held within 1e-9 of
the largest value of the column.  A restart from the checkpoint repeats the
uninterrupted port run bit for bit and lands within 1e-9 of the JAX run.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.diagnostics.checksum import (
    checksums_from_openpmd as j_sums_openpmd)
from warpx_tpu.diagnostics.checksum import (
    checksums_from_plotfile as j_sums_plotfile)
from warpx_tpu.io.plotfile import read_particles as j_read_particles
from warpx_tpu.io.plotfile import read_plotfile as j_read_plotfile
from warpx_tpu.io.plotfile import write_plotfile as j_write_plotfile
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.state import state_to_numpy
from warpx_tpu_torch.diagnostics.checksum import (checksums_from_openpmd,
                                                  checksums_from_plotfile)
from warpx_tpu_torch.io.checkpoint import load_checkpoint
from warpx_tpu_torch.io.openpmd import (read_openpmd_mesh,
                                        read_openpmd_particles)
from warpx_tpu_torch.io.plotfile import (read_particles, read_plotfile,
                                         write_plotfile)
from warpx_tpu_torch.utils.parser import Deck

from .test_binned_bounded import _LWFA_2D
from .test_torch_bounded_util import assert_checksums

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

RTOL = 1e-9

OUTPUTS = """
diagnostics.diags_names = diag1 diag2 chk
diag1.intervals = 6
diag1.fields_to_plot = Ex Ez By jz rho
diag1.species = electrons beam
diag2.format = openpmd
diag2.intervals = 6
diag2.fields_to_plot = Ez rho
diag2.species = electrons
diag2.electrons.plot_filter_function(t,x,y,z,ux,uy,uz) = "x > 2.e-6 and z < t*clight - 5.e-6"
chk.format = checkpoint
chk.intervals = 6:6
warpx.reduced_diags_names = fe pn
fe.type = FieldEnergy
fe.intervals = 3
pn.type = ParticleNumber
pn.intervals = 3
tpu.tiled_particles = on
"""
LWFA_OUT = _LWFA_2D + OUTPUTS


def port_from_deck(text, out, **kw):
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float64, device="cpu",
        output_dir=str(out), **kw)
    sim.init()
    return sim


def jax_from_deck(text, out):
    sim = JSimulation.from_deck(JDeck.from_string(text), output_dir=str(out))
    sim.init()
    return sim


def listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def assert_close(got, ref, what, tol=RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max() if ref.size else 0.0
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= tol * scale + 1e-300, (what, err, scale)


def _group(name):
    """Columns held against a common scale: the positions, the momenta
    (a component that is only roundoff is held against the others)."""
    if name in ("x", "y", "z"):
        return "position"
    if name.startswith("momentum") or name in ("px", "py", "pz"):
        return "momentum"
    return name


def assert_same_multiset(got, ref, what):
    """Two dicts of equally long particle columns hold the same rows within
    RTOL of the largest value of the column's group, in any order."""
    assert sorted(got) == sorted(ref), what
    names = sorted(ref)
    n = len(ref[names[0]])
    assert all(len(got[k]) == n and len(ref[k]) == n for k in names), what
    if n == 0:
        return
    scale = {}
    for k in names:
        g = _group(k)
        scale[g] = max(scale.get(g, 0.0), np.abs(ref[k]).max())

    def order(cols):
        # quantized to 2^-30 of the group's scale: far coarser than the
        # packages' differences, far finer than the particles' spacing
        return np.lexsort([
            np.round(np.asarray(cols[k]) / (scale[_group(k)] or 1.0)
                     * 2.0**30) for k in names][::-1])

    og, orf = order(got), order(ref)
    for k in names:
        g, r = np.asarray(got[k])[og], np.asarray(ref[k])[orf]
        err = np.abs(g - r).max()
        assert err <= RTOL * scale[_group(k)] + 1e-300, (what, k, err)


def reduced_table(path):
    with open(path) as fh:
        header = fh.readline()
        rows = [[float(v) for v in ln.split(",")] for ln in fh]
    return header, np.array(rows)


# ---- the plotfile writer, byte for byte ------------------------------------

def _plotfile_cases():
    rng = np.random.default_rng(0)
    lev0 = {n: rng.normal(size=(8, 6, 4)) for n in ("Ex", "By", "jz")}
    lev1 = {n: rng.normal(size=(16, 12, 8)) for n in ("Ex", "By", "jz")}
    parts = {"electrons": {
        "x": rng.normal(size=17), "y": rng.normal(size=17),
        "z": rng.normal(size=17), "weight": rng.random(17),
        "momentum_x": rng.normal(size=17)}}
    three_d = ([lev0, lev1], dict(
        prob_lo=(-1.0, -2.0, 0.0), prob_hi=(1.0, 2.0, 4.0), time=3.5e-13,
        step=10, ref_ratio=[(2, 2, 2)], particles=parts))
    # 2D plotfiles name the particles' x and z positions x and y
    f32 = {n: rng.normal(size=(12, 20)).astype(np.float32)
           for n in ("Ez", "rho", "part_per_cell")}
    two_d = ([f32], dict(
        prob_lo=(-15e-6, -27.5e-6), prob_hi=(15e-6, 6.5e-6),
        time=1.8130754997476305e-14, step=12, particles={
            "beam": {"x": rng.normal(size=5), "y": rng.normal(size=5),
                     "momentum_x": rng.normal(size=5),
                     "momentum_y": rng.normal(size=5),
                     "momentum_z": rng.normal(size=5),
                     "weight": rng.random(5)},
            "empty": {"x": np.zeros(0), "y": np.zeros(0),
                      "weight": np.zeros(0)}}))
    return {"3d_two_levels": three_d, "2d_float32": two_d}


@pytest.mark.parametrize("case", sorted(_plotfile_cases()))
def test_plotfile_writer_matches_jax_bytes(tmp_path, case):
    """The port's write_plotfile gives the JAX writer's files byte for byte;
    each package's reader reads the other's files back exactly."""
    levels, kw = _plotfile_cases()[case]
    mine, ref = tmp_path / "port", tmp_path / "jax"
    write_plotfile(str(mine), levels, **kw)
    j_write_plotfile(str(ref), levels, **kw)
    files = listing(ref)
    assert listing(mine) == files
    _, mismatch, errors = filecmp.cmpfiles(ref, mine, files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    for reader, path in ((read_plotfile, ref), (j_read_plotfile, mine)):
        back, meta = reader(str(path))
        assert meta["step"] == kw["step"] and meta["time"] == kw["time"]
        for lev, comps in zip(back, levels):
            assert list(lev) == list(comps)
            for n, arr in comps.items():
                np.testing.assert_array_equal(lev[n], arr.astype(np.float64))
    for sp, attrs in kw["particles"].items():
        for reader, path in ((read_particles, ref), (j_read_particles, mine)):
            back = reader(str(path), sp)
            for k, v in attrs.items():
                np.testing.assert_array_equal(back[k], v)


# ---- the laser-wakefield deck with outputs ---------------------------------

@pytest.fixture(scope="module")
def lwfa(tmp_path_factory):
    root = tmp_path_factory.mktemp("lwfa_outputs")
    ref = jax_from_deck(LWFA_OUT, root / "jax")
    ref.evolve()
    got = port_from_deck(LWFA_OUT, root / "port")
    got.evolve()
    return {"root": root, "jax": ref, "port": got,
            "port_state": state_to_numpy(got.state)}


def test_lwfa_outputs_are_the_same_files(lwfa):
    root = lwfa["root"]
    files = listing(root / "jax")
    assert listing(root / "port") == files
    assert {"diag1000006/Header", "diag1000012/Header", "diag2.h5",
            "chk000006/state.npz", "reducedfiles/fe.txt",
            "reducedfiles/pn.txt"} <= set(files)
    assert not any(f.startswith("chk000012") for f in files)


@pytest.mark.parametrize("step", [6, 12])
def test_lwfa_plotfile_matches_jax(lwfa, step):
    """Fields within 1e-9 of the largest value, particle columns as
    multisets, the checksums of the files within 1e-9 (each package's
    reader and checksum function on its own files)."""
    name = f"diag1{step:06d}"
    mine = str(lwfa["root"] / "port" / name)
    ref = str(lwfa["root"] / "jax" / name)
    (got,), gmeta = read_plotfile(mine)
    (want,), wmeta = j_read_plotfile(ref)
    assert gmeta["names"] == wmeta["names"] == ["By", "Ex", "Ez", "jz", "rho"]
    assert gmeta["step"] == step and gmeta["time"] == wmeta["time"]
    assert_close(gmeta["prob_lo"], wmeta["prob_lo"], "prob_lo", 1e-14)
    for n in want:
        assert_close(got[n], want[n], (step, n))
    for sp in ("electrons", "beam"):
        assert_same_multiset(read_particles(mine, sp),
                             j_read_particles(ref, sp), (step, sp))
    assert_checksums(j_sums_plotfile(ref), checksums_from_plotfile(mine))


def test_lwfa_openpmd_matches_jax(lwfa):
    """The openPMD iterations: the meshes within 1e-9, the filtered
    electrons as multisets, the file checksums within 1e-9."""
    mine = str(lwfa["root"] / "port" / "diag2.h5")
    ref = str(lwfa["root"] / "jax" / "diag2.h5")
    for step in (6, 12):
        assert_checksums(j_sums_openpmd(ref, step),
                         checksums_from_openpmd(mine, step))
    for name, comp in (("E", "z"), ("rho", None)):
        got = read_openpmd_mesh(mine, name, comp)
        want = read_openpmd_mesh(ref, name, comp)
        assert got["axis_labels"] == want["axis_labels"] == ["x", "z"]
        assert_close(got["data"], want["data"], name)
        assert_close(got["offset"], want["offset"], "offset", 1e-14)
    got = read_openpmd_particles(mine, "electrons")
    want = read_openpmd_particles(ref, "electrons")
    cols = ("x", "z", "px", "py", "pz", "w")
    n_all = int(lwfa["port"].state.species["electrons"].alive.sum())
    assert 0 < len(want["w"]) < n_all  # the filter took a part
    assert_same_multiset({k: got[k] for k in cols},
                         {k: want[k] for k in cols}, "openPMD electrons")
    assert got["time"] == want["time"] and got["mass"] == want["mass"]


@pytest.mark.parametrize("name", ["fe", "pn"])
def test_lwfa_reduced_files_match_jax(lwfa, name):
    header, got = reduced_table(lwfa["root"] / "port" / "reducedfiles"
                                / f"{name}.txt")
    jheader, want = reduced_table(lwfa["root"] / "jax" / "reducedfiles"
                                  / f"{name}.txt")
    assert header == jheader
    np.testing.assert_array_equal(got[:, 0], [3, 6, 9, 12])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_lwfa_restart_is_bitwise(lwfa, tmp_path):
    """A second port simulation loads the step-6 checkpoint and runs to 12:
    its state and its step-12 plotfile equal the uninterrupted run's bit
    for bit, and its checksums lie within 1e-9 of the JAX run's."""
    sim = port_from_deck(LWFA_OUT, tmp_path)
    sim.state, sim.is_synchronized = load_checkpoint(
        str(lwfa["root"] / "port" / "chk000006"), sim.state)
    assert sim.state.step == 6 and not sim.is_synchronized
    sim.evolve()
    assert sim.state.step == 12
    ref = lwfa["port_state"]
    got = state_to_numpy(sim.state)
    for group in ("fields", "aux"):
        assert set(got[group]) == set(ref[group])
        for k, a in ref[group].items():
            np.testing.assert_array_equal(got[group][k], a, err_msg=k)
    for name, sp in ref["species"].items():
        for k, a in sp.items():
            np.testing.assert_array_equal(got["species"][name][k], a,
                                          err_msg=f"{name}.{k}")
    files = listing(lwfa["root"] / "port" / "diag1000012")
    _, mismatch, errors = filecmp.cmpfiles(
        lwfa["root"] / "port" / "diag1000012", tmp_path / "diag1000012",
        files, shallow=False)
    assert not mismatch and not errors
    assert_checksums(lwfa["jax"].checksums(), sim.checksums())


def test_checkpoint_of_another_configuration_is_refused(lwfa, tmp_path):
    """A template whose slot capacity differs (twice the electrons a cell
    need twice the slots a tile) refuses the checkpoint."""
    sim = port_from_deck(
        LWFA_OUT + "\nelectrons.num_particles_per_cell_each_dim = 2 1 1\n",
        tmp_path)
    with pytest.raises(ValueError, match=r"species/electrons/w is float64"
                       r"\[4096\], the configuration has float64\[8192"):
        load_checkpoint(str(lwfa["root"] / "port" / "chk000006"), sim.state)


@pytest.mark.parametrize("extra,item", [
    # the legacy output keys and a restart named in the deck, which neither
    # package reads, name Queue C since Queue A 15 (the cases keep their ids)
    pytest.param("amr.plot_int = 10", "Queue C",
                 id="amr.plot_int = 10-Queue A 15"),
    pytest.param("amr.restart = chk000010", "Queue C",
                 id="amr.restart = chk000010-Queue A 15"),
    # the scraped particles' buffers are Simulation.scraped_particles since
    # Queue A 11.4; the JAX package writes this type as a Full diagnostic
    # of the fields (the case keeps its id)
    pytest.param("diagnostics.diags_names = d\nd.diag_type = BoundaryScraping",
                 "Queue C",
                 id="diagnostics.diags_names = d\nd.diag_type = "
                    "BoundaryScraping-Queue A 11"),
])
def test_outputs_the_port_lacks_raise(extra, item):
    from warpx_tpu_torch.core.deck import config_from_deck

    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md {item}\)"):
        config_from_deck(Deck.from_string(LWFA_OUT + extra + "\n"))


def test_unread_keys_of_an_output_are_listed_unused():
    """A key of a declared output that neither package reads changes no
    physics: it is accepted and left unused, as NO_PHYSICS keys are."""
    from warpx_tpu_torch.core.deck import config_from_deck

    deck = Deck.from_string(LWFA_OUT + "diag1.file_prefix = out/plt\n"
                            "fe.path = elsewhere\n")
    config_from_deck(deck)
    assert deck.unused_keys() == ["diag1.file_prefix", "fe.path"]
