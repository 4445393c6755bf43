"""The port's CLI with outputs against the JAX package's: the repo's
``inputs2d_from_PICMI`` deck (a 64 x 64 periodic plasma with a Full
diagnostic ``diag1`` every 10 steps), run by ``python -m warpx_tpu_torch
... --device cpu --output-dir D`` and by ``python -m warpx_tpu ...
--output-dir D`` in process, both with ``algo.current_deposition =
esirkepov`` (the port has no direct deposition yet, ROADMAP.md Queue A 3).

The port writes diag1 at steps 10, 20, 30 and 40, the JAX package's
reader reads the files, and the fields lie within 1e-9 of the JAX CLI's.
A run with a checkpoint at step 20 then resumes with ``--restart`` and
writes the step-30 and step-40 plotfiles byte for byte as the
uninterrupted run did.  CPU, float64.
"""

import filecmp
import pathlib

import numpy as np
import pytest
import torch

from warpx_tpu.__main__ import main as jax_cli
from warpx_tpu.io.plotfile import read_particles as j_read_particles
from warpx_tpu.io.plotfile import read_plotfile as j_read_plotfile
from warpx_tpu_torch.__main__ import main as cli_main

from .test_torch_io import assert_close, assert_same_multiset, listing

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

DECK = str(pathlib.Path(__file__).resolve().parents[1] / "inputs2d_from_PICMI")
ESIRKEPOV = "algo.current_deposition=esirkepov"
CHECKPOINT = ("diagnostics.diags_names=diag1 chk", "chk.format=checkpoint",
              "chk.intervals=20:20")
STEPS = (10, 20, 30, 40)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    assert jax_cli([DECK, ESIRKEPOV, "--output-dir", str(root / "jax")]) == 0
    assert cli_main([DECK, ESIRKEPOV, *CHECKPOINT, "--device", "cpu",
                     "--output-dir", str(root / "port")]) == 0
    return root


def test_cli_writes_diag1_on_schedule(runs):
    names = {p.split("/")[0] for p in listing(runs / "port")}
    assert names == {f"diag1{s:06d}" for s in STEPS} | {"chk000020"}
    assert {p.split("/")[0] for p in listing(runs / "jax")} == {
        f"diag1{s:06d}" for s in STEPS}


@pytest.mark.parametrize("step", STEPS)
def test_cli_fields_match_jax(runs, step):
    """The JAX package's reader reads the port's plotfile; its Ex and jx lie
    within 1e-9 of the JAX CLI's, its electrons are the JAX run's."""
    name = f"diag1{step:06d}"
    (got,), meta = j_read_plotfile(str(runs / "port" / name))
    (want,), jmeta = j_read_plotfile(str(runs / "jax" / name))
    assert meta["names"] == jmeta["names"] == ["Ex", "jx"]
    assert meta["step"] == step and meta["time"] == jmeta["time"]
    for n in want:
        assert np.abs(want[n]).max() > 0
        assert_close(got[n], want[n], (step, n))
    assert_same_multiset(
        j_read_particles(str(runs / "port" / name), "electrons"),
        j_read_particles(str(runs / "jax" / name), "electrons"), step)


def test_cli_restart_resumes_at_the_checkpoint(runs, tmp_path, capsys):
    capsys.readouterr()
    chk = runs / "port" / "chk000020"
    assert cli_main([DECK, ESIRKEPOV, *CHECKPOINT, "--device", "cpu",
                     "--output-dir", str(tmp_path), "--restart",
                     str(chk)]) == 0
    out = capsys.readouterr().out
    assert f"restarted from {chk} at step 20" in out
    assert "completed 40 steps" in out
    assert "STEP 21 ends" in out and "STEP 20 ends" not in out
    assert sorted({p.split("/")[0] for p in listing(tmp_path)}) == [
        "diag1000030", "diag1000040"]
    for name in ("diag1000030", "diag1000040"):
        files = listing(runs / "port" / name)
        _, mismatch, errors = filecmp.cmpfiles(
            runs / "port" / name, tmp_path / name, files, shallow=False)
        assert not mismatch and not errors, (name, mismatch, errors)
