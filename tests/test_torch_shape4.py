"""Quartic particle shapes (``algo.particle_shape = 4``) in the port
(``warpx_tpu_torch/ops/shapes.py``) against the JAX package, CPU, float64.

The order-4 spline and its start index equal the JAX package's; the gather
takes 5 taps an axis and the Esirkepov deposit a window of 7, and the
deposit conserves charge at roundoff; the periodic per-particle step in 2D
and 3D and the bounded per-particle step (the 32 x 64 laser-wakefield deck
and the 16^3 PEC deck) run within 1e-9 of the JAX package; both binned
gates refuse order 4, as the JAX package's do, so ``auto`` runs per
particle; the fused kernel's wrapper refuses it.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpx_tpu.ops import shapes as jshapes
from warpx_tpu_torch import Simulation
from warpx_tpu_torch.core.binned_step import (binned_supported,
                                              bounded_binned_supported)
from warpx_tpu_torch.core.bounded_step import guard_width
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.grid import Geometry
from warpx_tpu_torch.ops import deposit, shapes
from warpx_tpu_torch.ops.fused_pic import _kernel_args
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import LWFA_2D, PEC_3D
from .test_torch_draws_util import (assert_checksums_close,
                                    assert_runs_close, jax_run, port_run)

torch.set_num_threads(1)


def test_order4_spline_and_start_index():
    x = np.random.default_rng(0).uniform(-6.0, 6.0, 200_001)
    xt = torch.from_numpy(x)
    ref = np.asarray(jshapes.spline(jnp.asarray(x), 4))
    got = shapes.spline(xt, 4).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)
    np.testing.assert_array_equal(
        shapes.start_index(xt, 4).numpy(),
        np.asarray(jshapes.start_index(jnp.asarray(x), 4)))
    # the five weights of a particle sum to one and the support is 5 wide
    i0, ws = shapes.shape_weights(xt, 4)
    assert len(ws) == 5
    np.testing.assert_allclose(sum(ws).numpy(), 1.0, rtol=0, atol=1e-14)
    assert float(shapes.spline(torch.tensor([2.5, -2.5]), 4).abs().max()) \
        == 0.0
    with pytest.raises(ValueError, match="shape order 5"):
        shapes.spline(xt, 5)


def test_order4_esirkepov_conserves_charge():
    """The 7-wide Esirkepov window: (rho_new - rho_old) / dt + div J = 0 at
    roundoff for order-4 particles moving less than a cell (2D)."""
    geom = Geometry(ndim=2, n_cell=(16, 16), prob_lo=(0.0, 0.0),
                    prob_hi=(16e-6, 16e-6), periodic=(True, True))
    rng = np.random.default_rng(1)
    n = 64
    dt = 1e-15
    x1 = [torch.from_numpy(rng.uniform(0, 16e-6, n)) for _ in range(2)]
    u = [torch.from_numpy(rng.normal(0, 1e8, n)) for _ in range(3)]
    w = torch.from_numpy(rng.uniform(1e9, 2e9, n))
    q = -1.602176634e-19
    jx, jy, jz = deposit.deposit_current_esirkepov(x1, *u, w, q, geom, dt, 4)
    gam = torch.sqrt(1 + (u[0] ** 2 + u[1] ** 2 + u[2] ** 2)
                     / 299792458.0 ** 2)
    x0 = [x1[0] - dt * u[0] / gam, x1[1] - dt * u[2] / gam]
    rho1 = deposit.deposit_rho(x1, w, q, geom, 4)
    rho0 = deposit.deposit_rho(x0, w, q, geom, 4)
    dx, dz = geom.dx
    div = ((jx - torch.roll(jx, 1, 0)) / dx + (jz - torch.roll(jz, 1, 1))
           / dz)
    resid = (rho1 - rho0) / dt + div
    assert float(resid.abs().max()) <= 1e-10 * float(div.abs().max())


_ORDER4 = "algo.particle_shape = 4\n"


def _jax_run(text, ndim):
    """The JAX package's run; in 3D op by op (``jax.disable_jit``): its
    order-4 step compiles for ~40 s a species, and the same functions run
    eagerly in a third of that."""
    if ndim == 2:
        return jax_run(text)
    with jax.disable_jit():
        return jax_run(text)


@pytest.mark.parametrize("ndim", [3, 2])
def test_order4_periodic_step_matches_jax(ndim):
    """A thermal plasma at order 4 (electrons and ions on 32^2; electrons
    on 8^3), 3 steps per particle (auto: the binned gate refuses order
    4)."""
    n = "8 8 8" if ndim == 3 else "32 32"
    species = "electrons" if ndim == 3 else "electrons ions"
    lo = " ".join(["-8.e-6"] * ndim)
    hi = " ".join(["8.e-6"] * ndim)
    text = f"""
max_step = 3
amr.n_cell = {n}
geometry.dims = {ndim}
geometry.prob_lo = {lo}
geometry.prob_hi = {hi}
{_ORDER4}
particles.species_names = {species}
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.05
electrons.uy_th = 0.05
electrons.uz_th = 0.05
"""
    if ndim == 2:
        text += """
ions.species_type = proton
ions.injection_style = NUniformPerCell
ions.num_particles_per_cell_each_dim = 1 1 1
ions.profile = constant
ions.density = 1.e24
"""
    cfg = config_from_deck(Deck.from_string(text))
    assert not binned_supported(cfg)
    assert binned_supported(dataclasses.replace(cfg, particle_shape=3))
    j = _jax_run(text, ndim)
    p = port_run(text, replay=False)
    assert not p.binned
    assert_runs_close(p, j, 1e-9)
    assert_checksums_close(p.checksums(), j.checksums(), 1e-9)


@pytest.mark.parametrize("deck", ["lwfa", "pec"])
def test_order4_bounded_step_matches_jax(deck):
    """The bounded per-particle step at order 4 (guard depth order + 3,
    plus the filter's passes): the 32 x 64 laser-wakefield deck, 4 steps,
    and the 16^3 PEC deck's electrons, 3 steps, within 1e-9 of the JAX
    package."""
    base = LWFA_2D if deck == "lwfa" else "\n".join(
        ln for ln in PEC_3D.replace(
            "particles.species_names = electrons protons",
            "particles.species_names = electrons").splitlines()
        if not ln.startswith("protons.")) + "\n"
    text = (base.replace("algo.particle_shape = 3", "")
            .replace("algo.particle_shape = 2", "")
            .replace("max_step = 12", "max_step = 4")
            .replace("max_step = 8", "max_step = 3") + _ORDER4)
    cfg = config_from_deck(Deck.from_string(text))
    assert cfg.particle_shape == 4 and not bounded_binned_supported(cfg)
    assert guard_width(cfg) == 7 + (1 if cfg.use_filter else 0)
    j = _jax_run(text, cfg.geometry.ndim)
    p = port_run(text, replay=False)
    assert p.is_bounded and not p.binned
    assert_runs_close(p, j, 1e-9)
    assert_checksums_close(p.checksums(), j.checksums(), 1e-9)


def test_fused_kernel_refuses_order4():
    """The fused kernels stay orders 1-3 (``ops/fused_pic.py``): their
    wrapper raises on order 4 rather than run it."""
    with pytest.raises(ValueError, match="outside 1-3"):
        _kernel_args(None, None, (torch.zeros(1),), None,
                     spec=types.SimpleNamespace(ndim=2), geom=None, order=4,
                     galerkin=True, pusher_name="boris", dt=1e-15,
                     stag_items=(), lo=None, zoff=None, mxu="f32", smax=0)
    cfg = config_from_deck(Deck.from_string(PEC_3D + _ORDER4))
    with pytest.raises(NotImplementedError, match="tiled_particles=on"):
        Simulation(dataclasses.replace(cfg, tiled_particles="on"),
                   dtype=torch.float64, device="cpu")
