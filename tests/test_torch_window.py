"""Cases the 2D fused kernel K2 branches on, through the port's bounded
step on the CPU in float64 against the JAX package.

The 32 x 64 laser-wakefield deck of ``tests/test_binned_bounded.py`` with a
moving window at 0.9 c, and with constant external particle fields (the
kernel's per-species field term), on the tile-binned path at sort interval
1 and on the per-particle path: checksums within 1e-9.  At a larger
interval the binned path injects on rebin steps only, so the two packages'
paths differ by design where the band ahead of the laser holds a field
(ROADMAP.md Queue C); at interval 1 they inject alike.  Then the host logic
of K2's gather table, which the kernel fixes at compile time: the Yee
staggering with Galerkin on or off, any other table refused.
"""

import pytest
import torch

from warpx_tpu_torch.core.grid import yee_staggering
from warpx_tpu_torch.ops import fused_pic

from .test_torch_bounded_util import (LWFA_2D, assert_checksums, port_config,
                                      run_jax, run_port)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

_INTERVAL_1 = LWFA_2D.replace("warpx.sort_intervals = 4",
                              "warpx.sort_intervals = 1")
DECKS = {
    "window_0.9c": _INTERVAL_1.replace("warpx.moving_window_v = 1.0",
                                       "warpx.moving_window_v = 0.9"),
    "external_fields": _INTERVAL_1 + (
        "particles.E_ext_particle_init_style = constant\n"
        "particles.E_external_particle = 1e9 -2e9 3e9\n"
        "particles.B_ext_particle_init_style = constant\n"
        "particles.B_external_particle = 5 -3 2\n"),
}


@pytest.mark.parametrize("tiled", ["on", "off"])
@pytest.mark.parametrize("deck", sorted(DECKS))
def test_window_deck_checksums_match_jax(deck, tiled):
    jsim, _ = run_jax(DECKS[deck], tiled)
    sim = run_port(port_config(jsim.cfg, tiled_particles=tiled))
    assert sim.is_bounded and sim.binned == (tiled == "on")
    assert sim.cfg.sort_interval == 1
    if deck == "window_0.9c":
        assert sim.cfg.moving_window_v == 0.9
        assert int(sim.state.aux["window_offset"]) > 0
    else:
        assert tuple(sim.cfg.e_ext_particle) == (1e9, -2e9, 3e9)
        assert tuple(sim.cfg.b_ext_particle) == (5.0, -3.0, 2.0)
    assert_checksums(jsim.checksums(), sim.checksums())


def _yee_items():
    return tuple(sorted((k, tuple(v)) for k, v in yee_staggering(2).items()))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_gather_table_2d_is_yee_with_galerkin_on_or_off(order):
    items = _yee_items()
    assert fused_pic.gather_table_2d(True, items) == 1
    assert fused_pic.gather_table_2d(False, items) == 0
    # the kernel's compile-time table: on Yee, Galerkin reduces the order
    # exactly on the staggered axes, so two weight sets an axis serve
    gorder, gstag = fused_pic._gather_table(order, True, dict(items), 2)
    assert gorder == [order - s for s in gstag]
    assert fused_pic._gather_table(order, False, dict(items), 2) == (
        [order] * 12, gstag)


@pytest.mark.parametrize("comp, stag", [("Ex", (1, 1)), ("By", (1, 1)),
                                        ("Bz", (1, 0))])
def test_gather_table_2d_refuses_other_staggering(comp, stag):
    items = tuple((k, stag if k == comp else v) for k, v in _yee_items())
    with pytest.raises(NotImplementedError, match="Queue C"):
        fused_pic.gather_table_2d(True, items)
