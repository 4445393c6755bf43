"""Cases of the 3D fused kernel K1, through the port on the CPU in float64
against the JAX package.

A 16 x 16 x 32 laser-wakefield deck (PML on every face, a moving window
along z, continuously injected electrons, a Gaussian antenna, order 2,
current filter): its electrons reach K1's moving-window mode on the
tile-binned path, whose plain version runs here.  It runs binned and per
particle through both packages for 6 steps (a rebin at step 4, the window
moved by then): checksums within 1e-9.  Then the host logic of K1's gather
table, which the kernel fixes at compile time: the Yee staggering with
Galerkin on or off, any other table refused on the kernel's route.
"""

import pytest
import torch

from warpx_tpu_torch.core.grid import yee_staggering
from warpx_tpu_torch.ops import fused_pic
from warpx_tpu_torch.ops.tiling import TileSpec

from .test_torch_bounded_util import (assert_checksums, port_config, run_jax,
                                      run_port)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

LWFA_3D = """
max_step = 6
amr.n_cell = 16 16 32
geometry.dims = 3
geometry.prob_lo = -15.e-6 -15.e-6 -28.e-6
geometry.prob_hi =  15.e-6  15.e-6   6.e-6
boundary.field_lo = pml pml pml
boundary.field_hi = pml pml pml
warpx.cfl = 0.98
warpx.use_filter = 1
warpx.do_moving_window = 1
warpx.moving_window_dir = z
warpx.moving_window_v = 1.0
warpx.sort_intervals = 4
algo.particle_shape = 2
algo.maxwell_solver = yee
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.xmin = -12.e-6
electrons.xmax =  12.e-6
electrons.ymin = -12.e-6
electrons.ymax =  12.e-6
electrons.zmin = -20.e-6
electrons.profile = constant
electrons.density = 2.e23
electrons.momentum_distribution_type = at_rest
electrons.do_continuous_injection = 1
lasers.names = laser1
laser1.profile = Gaussian
laser1.position = 0. 0. -10.e-6
laser1.direction = 0. 0. 1.
laser1.polarization = 0. 1. 0.
laser1.e_max = 16.e12
laser1.profile_waist = 5.e-6
laser1.profile_duration = 15.e-15
laser1.profile_t_peak = 30.e-15
laser1.profile_focal_distance = 100.e-6
laser1.wavelength = 0.8e-6
"""


@pytest.mark.parametrize("tiled", ["on", "off"])
def test_window3d_deck_checksums_match_jax(tiled):
    jsim, _ = run_jax(LWFA_3D, tiled)
    sim = run_port(port_config(jsim.cfg, tiled_particles=tiled))
    assert sim.is_bounded and sim.binned == (tiled == "on")
    assert sim.cfg.particle_shape == 2 and sim.cfg.geometry.ndim == 3
    assert int(sim.state.aux["window_offset"]) > 0
    if tiled == "on":
        # the electrons rode the fused kernel's moving-window mode
        assert [c.name for c in sim.stepper.binned_cfgs] == ["electrons"]
    assert_checksums(jsim.checksums(), sim.checksums())


def _yee_items():
    return tuple(sorted((k, tuple(v)) for k, v in yee_staggering(3).items()))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_gather_table_3d_is_yee_with_galerkin_on_or_off(order):
    items = _yee_items()
    assert fused_pic.gather_table_3d(True, items) == 1
    assert fused_pic.gather_table_3d(False, items) == 0
    # the kernel's compile-time table: on Yee, Galerkin reduces the order
    # exactly on the staggered axes, so two weight sets an axis serve
    gorder, gstag = fused_pic._gather_table(order, True, dict(items), 3)
    assert gorder == [order - s for s in gstag]
    assert fused_pic._gather_table(order, False, dict(items), 3) == (
        [order] * 18, gstag)
    # ... and the kernel's own table (csrc/fused_pic.cu, yee_stag): E on
    # its own axis, B on the other two
    assert gstag == [int(c < 3 and c == d or c >= 3 and c - 3 != d)
                     for c in range(6) for d in range(3)]


@pytest.mark.parametrize("comp, stag", [("Ex", (1, 1, 1)), ("Ey", (0, 1, 1)),
                                        ("Bx", (1, 1, 0)), ("Bz", (0, 0, 0))])
def test_gather_table_3d_refuses_other_staggering(comp, stag):
    items = tuple((k, stag if k == comp else v) for k, v in _yee_items())
    with pytest.raises(NotImplementedError, match="Queue C"):
        fused_pic.gather_table_3d(True, items)


def test_kernel_route_refuses_other_staggering_before_launch():
    """The wrapper's kernel route checks the table first: a non-Yee
    staggering raises there, before any library is built or launched, and
    never falls back to the plain version."""
    from warpx_tpu_torch.core.grid import Geometry

    geom = Geometry(ndim=3, n_cell=(8, 8, 8), prob_lo=(0.0,) * 3,
                    prob_hi=(8e-6,) * 3, periodic=(True,) * 3)
    spec = TileSpec.create(geom.n_cell, order=1, n_particles=64)
    items = tuple((k, (1, 1, 1) if k == "Ez" else v)
                  for k, v in _yee_items())
    parts = tuple(torch.zeros(spec.n_tiles, spec.p_max, dtype=torch.float64)
                  for _ in range(7))
    counts = torch.zeros(spec.n_tiles, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="Queue C"):
        fused_pic._launch_kernel(
            torch.zeros(1, 8, dtype=torch.float64), (), parts, counts,
            spec=spec, geom=geom, order=1, galerkin=True,
            pusher_name="boris", dt=1e-15, stag_items=items, lo=(0.0,) * 3,
            zoff=0, mxu="f32", smax=0)
