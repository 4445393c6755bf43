"""The port's direct and Vay current deposits, and its rho and Esirkepov
deposits at a drifting origin, against the JAX package's.

Particles made with numpy from a seed (positions up to a cell outside the
domain, as between rebins; relativistic momenta; a few dead slots) go
through both packages on the CPU in float64; every deposited array lands on
JAX's at 1e-12 of its largest value.  Covered: 2D XZ and 3D, shape orders
1-3; direct deposition at the default relative time -dt/2 and at multi-J's
-dt and 0; a Galilean origin (the box's corner moved by v t); the bounded
form (no wrap, ``offset`` guards, ``out_shape``); and the port's chunking
(a deposit made 97 particles at a time sums to the same arrays).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpx_tpu.core.grid import yee_staggering as j_yee_staggering
from warpx_tpu.ops import deposit as j_deposit
from warpx_tpu_torch.core.grid import yee_staggering
from warpx_tpu_torch.ops import deposit

from .test_torch_ops import C, close, geoms, geoms2d, positions, t

torch.set_num_threads(1)

N = 600
Q = -1.602176634e-19
CHUNK = 97


def _particles(ndim, seed):
    jgeom, geom = geoms() if ndim == 3 else geoms2d()
    rng = np.random.default_rng(seed)
    pos = positions(rng, geom, N)
    u = [rng.normal(0.0, 0.6 * C, N) for _ in range(3)]
    w = rng.uniform(0.5, 1.5, N) * 1e10
    w[:7] = 0.0  # dead slots
    dt = 0.7 * min(geom.dx) / C
    return jgeom, geom, pos, u, w, dt


def _args(pos, u, w):
    """The (positions, ux, uy, uz, w) arguments of each package."""
    return (([jnp.asarray(p) for p in pos], *map(jnp.asarray, u),
             jnp.asarray(w)),
            ([t(p) for p in pos], *map(t, u), t(w)))


def _drift(geom, frac=0.37):
    """A Galilean origin: the corner moved by a fraction of the box."""
    return [lo + frac * (hi - lo)
            for lo, hi in zip(geom.prob_lo, geom.prob_hi)]


def _bounded(geom, order):
    """The bounded step's block: guards of order + 3 cells per side."""
    ng = order + 3
    return dict(wrap=False, offset=ng,
                out_shape=tuple(n + 1 + 2 * ng for n in geom.n_cell))


def _close3(got, ref):
    for a, b in zip(got, ref):
        close(a, b)


@pytest.mark.parametrize("ndim,order,rel", [
    (ndim, order, rel) for ndim in (2, 3) for order in (1, 2, 3)
    for rel in ("default", "minus_dt", "zero")])
def test_direct_deposit(ndim, order, rel):
    jgeom, geom, pos, u, w, dt = _particles(ndim, 10 * ndim + order)
    rt = {"default": None, "minus_dt": -dt, "zero": 0.0}[rel]
    ja, ta = _args(pos, u, w)
    for origin in (None, _drift(geom)):
        ref = j_deposit.deposit_current_direct(
            *ja, Q, jgeom, j_yee_staggering(ndim), dt, order,
            relative_time=rt, origin=origin)
        got = deposit.deposit_current_direct(
            *ta, Q, geom, yee_staggering(ndim), dt, order,
            relative_time=rt, origin=origin, chunk_size=CHUNK)
        _close3(got, ref)


@pytest.mark.parametrize("ndim,order", [(n, o) for n in (2, 3)
                                        for o in (1, 2, 3)])
def test_direct_deposit_bounded_form(ndim, order):
    jgeom, geom, pos, u, w, dt = _particles(ndim, 50 + ndim + order)
    ja, ta = _args(pos, u, w)
    kw = dict(origin=_drift(geom, -0.02), **_bounded(geom, order))
    ref = j_deposit.deposit_current_direct(
        *ja, Q, jgeom, j_yee_staggering(ndim), dt, order, **kw)
    got = deposit.deposit_current_direct(
        *ta, Q, geom, yee_staggering(ndim), dt, order, chunk_size=CHUNK,
        **kw)
    assert got[0].shape == kw["out_shape"]
    _close3(got, ref)


@pytest.mark.parametrize("ndim,order", [(n, o) for n in (2, 3)
                                        for o in (1, 2, 3)])
def test_vay_deposit(ndim, order):
    jgeom, geom, pos, u, w, dt = _particles(ndim, 70 + ndim + order)
    ja, ta = _args(pos, u, w)
    for kw in ({}, dict(origin=_drift(geom)),
               dict(origin=_drift(geom, -0.02), **_bounded(geom, order))):
        ref = j_deposit.deposit_current_vay(*ja, Q, jgeom, dt, order, **kw)
        got = deposit.deposit_current_vay(*ta, Q, geom, dt, order,
                                          chunk_size=CHUNK, **kw)
        _close3(got, ref)
    # the whole population in one piece gives the same arrays
    _close3(deposit.deposit_current_vay(*ta, Q, geom, dt, order),
            j_deposit.deposit_current_vay(*ja, Q, jgeom, dt, order))


@pytest.mark.parametrize("ndim,order", [(n, o) for n in (2, 3)
                                        for o in (1, 2, 3)])
def test_rho_and_esirkepov_at_drifting_origin(ndim, order):
    jgeom, geom, pos, u, w, dt = _particles(ndim, 90 + ndim + order)
    ja, ta = _args(pos, u, w)
    origin = _drift(geom)
    ref = j_deposit.deposit_rho(ja[0], ja[4], Q, jgeom, order,
                                origin=origin)
    got = deposit.deposit_rho(ta[0], ta[4], Q, geom, order, origin=origin,
                              chunk_size=CHUNK)
    close(got, ref)
    ref = j_deposit.deposit_current_esirkepov(*ja, Q, jgeom, dt, order,
                                              origin=origin)
    got = deposit.deposit_current_esirkepov(*ta, Q, geom, dt, order,
                                            origin=origin, chunk_size=CHUNK)
    _close3(got, ref)
