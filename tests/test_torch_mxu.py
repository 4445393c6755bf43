"""The precision modes of the fused kernels ('mixed' and 'bf16', the TPU
kernel's ``tile_mxu``) in the port against the JAX package.

``binned_push_deposit_plain`` (CPU, float64) at each mode against
``warpx_tpu.ops.pallas_pic.binned_push_deposit(..., interpret=True)`` on the
layouts of ``test_torch_fused_pic.py``: every output within 1e-12 of its
largest value, in 2D and 3D, at orders 1-3 (one pusher per order) and once
per mode in moving-window mode.  The rounding to bfloat16 is
the same in both packages (float64 goes through float32), so 1e-12 holds.
Then the port's ``test_binned.py::test_binned_mxu_precision_modes`` and the
16^3 periodic slice at 'mixed' against the JAX package's binned run.
"""

import dataclasses

import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.simulation import Simulation as JSimulation

from .test_torch_fused_pic import _compare
from .test_torch_slice import _assert_checksums, jax_cfg, torch_cfg

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

_PUSHER = {1: "boris", 2: "vay", 3: "higuera"}


@pytest.mark.parametrize("mxu", ["mixed", "bf16"])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("ndim", [3, 2])
def test_plain_mode_matches_pallas_interpret(ndim, order, mxu):
    _compare(ndim, order, _PUSHER[order], mxu=mxu)


@pytest.mark.parametrize("ndim,order,mxu", [(2, 3, "mixed"), (3, 1, "bf16")])
def test_moving_window_mode_matches_pallas_interpret(ndim, order, mxu):
    """One case per mode: smax = 8, zshift = 3, tiles anchored 0.37 cells
    off prob_lo; 'mixed' in 2D, the laser-wakefield path's mode."""
    _compare(ndim, order, "boris", smax=8, zshift=3, anchor_off=0.37,
             mxu=mxu)


def test_binned_mxu_precision_modes():
    """The port of ``test_binned.py::test_binned_mxu_precision_modes``:
    'mixed' and 'bf16' stay within 3e-2 of the 'f32' run's Ex, differ from
    it, and conserve the total weight exactly."""
    results = {}
    for mxu in ("f32", "mixed", "bf16"):
        cfg = dataclasses.replace(torch_cfg(), max_step=4, tile_mxu=mxu)
        sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64,
                                         device="cpu")
        sim.init()
        sim.evolve()
        results[mxu] = sim.state
    ref = results["f32"].fields.Ex
    scale = float(ref.abs().max())
    w_ref = float(results["f32"].species["electrons"].w.sum())
    for mxu in ("mixed", "bf16"):
        err = float((results[mxu].fields.Ex - ref).abs().max()) / scale
        assert 0.0 < err < 3e-2, (mxu, err)
        assert float(results[mxu].species["electrons"].w.sum()) == w_ref


def test_mixed_slice_matches_jax():
    """The 16^3 slice at 'mixed', 4 steps (a rebin at step 3): the port's
    checksums within 1e-9 of the JAX package's binned run (Pallas in
    interpret mode)."""
    jsim = JSimulation(dataclasses.replace(jax_cfg("on", tile_mxu="mixed"),
                                           max_step=4))
    jsim.init()
    jsim.evolve()
    sim = warpx_tpu_torch.Simulation(
        dataclasses.replace(torch_cfg(tile_mxu="mixed"), max_step=4),
        dtype=torch.float64, device="cpu")
    sim.init()
    sim.evolve()
    _assert_checksums(jsim.checksums(), sim.checksums())
