"""The port's particle and field operations against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU in float64.  Injection must be bit-identical; the rest
agrees to 1e-12 relative (max |diff| over max |ref|).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpx_tpu.core import injection as j_injection
from warpx_tpu.core.config import SpeciesConfig as JSpeciesConfig
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.grid import yee_staggering as j_yee_staggering
from warpx_tpu.core.state import FieldState as JFieldState
from warpx_tpu.ops import deposit as j_deposit
from warpx_tpu.ops import gather as j_gather
from warpx_tpu.ops import push as j_push
from warpx_tpu.ops import shapes as j_shapes
from warpx_tpu.solvers import filter as j_filter
from warpx_tpu.solvers import yee as j_yee
from warpx_tpu_torch.core import injection
from warpx_tpu_torch.core.config import SpeciesConfig
from warpx_tpu_torch.core.grid import Geometry, yee_staggering
from warpx_tpu_torch.core.state import FieldState
from warpx_tpu_torch.ops import deposit, gather, push, shapes
from warpx_tpu_torch.solvers import filter as t_filter
from warpx_tpu_torch.solvers import yee

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

RTOL = 1e-12
LX = 40e-6
C = 299792458.0


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64).copy())


def close(got, ref, rtol=RTOL):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= rtol * scale, (err, scale)


def geoms(n=(16, 12, 8)):
    kw = dict(ndim=3, n_cell=n, prob_lo=(-LX / 2, -LX / 3, -LX / 4),
              prob_hi=(LX / 2, LX / 3, LX / 4), periodic=(True,) * 3)
    return JGeometry(**kw), Geometry(**kw)


def geoms2d(n=(16, 12)):
    kw = dict(ndim=2, n_cell=n, prob_lo=(-LX / 2, -LX / 4),
              prob_hi=(LX / 2, LX / 4), periodic=(True,) * 2)
    return JGeometry(**kw), Geometry(**kw)


def positions(rng, geom, n):
    # unwrapped positions up to a cell outside the domain, as between rebins
    return [rng.uniform(lo - d, hi + d, n) for lo, hi, d in
            zip(geom.prob_lo, geom.prob_hi, geom.dx)]


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_shapes(order):
    rng = np.random.default_rng(order)
    x = rng.uniform(-3.0, 19.0, 4000)
    x[:8] = [0.5, -0.5, 1.0, 2.5, 3.0, -1.5, 7.5, 8.0]  # support edges
    close(shapes.spline(t(x - 7.3), order),
          j_shapes.spline(jnp.asarray(x - 7.3), order))
    np.testing.assert_array_equal(
        shapes.start_index(t(x), order).numpy(),
        np.asarray(j_shapes.start_index(jnp.asarray(x), order)))
    if order == 0:
        return
    i0, ws = shapes.shape_weights(t(x), order)
    ji0, jws = j_shapes.shape_weights(jnp.asarray(x), order)
    np.testing.assert_array_equal(i0.numpy(), np.asarray(ji0))
    for a, b in zip(ws, jws):
        close(a, b)
    xo = x - rng.uniform(-0.6, 0.6, x.size)
    i0, sn, so = shapes.esirkepov_weights(t(x), t(xo), order)
    ji0, jsn, jso = j_shapes.esirkepov_weights(jnp.asarray(x),
                                               jnp.asarray(xo), order)
    np.testing.assert_array_equal(i0.numpy(), np.asarray(ji0))
    for a, b in zip(sn + so, jsn + jso):
        close(a, b)


@pytest.mark.parametrize("pusher", ["boris", "vay", "higuera"])
def test_pushers(pusher):
    rng = np.random.default_rng(7)
    n = 5000
    u = rng.normal(0, 0.5 * C, (3, n))
    eb = np.concatenate([rng.normal(0, 1e12, (3, n)),
                         rng.normal(0, 3e3, (3, n))])
    q, m, dt = -1.602176634e-19, 9.1093837015e-31, 2e-15
    got = push.PUSHERS[pusher](*map(t, u), *map(t, eb), q, m, dt)
    ref = j_push.PUSHERS[pusher](*map(jnp.asarray, u),
                                 *map(jnp.asarray, eb), q, m, dt)
    for a, b in zip(got, ref):
        close(a, b)
    close(push.inv_gamma(*map(t, u)), j_push.inv_gamma(*map(jnp.asarray, u)))
    jg, g = geoms()
    pos = positions(rng, g, n)
    for a, b in zip(push.position_step(tuple(map(t, pos)), *map(t, u), dt, 3),
                    j_push.position_step(tuple(map(jnp.asarray, pos)),
                                         *map(jnp.asarray, u), dt, 3)):
        close(a, b)


@pytest.mark.parametrize("order,galerkin", [(1, True), (2, True), (3, True),
                                            (1, False), (3, False)])
def test_gather_eb(order, galerkin):
    rng = np.random.default_rng(order)
    jg, g = geoms()
    pos = positions(rng, g, 3000)
    fields = {nm: rng.normal(size=g.n_cell)
              for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")}
    got = gather.gather_eb([t(p) for p in pos],
                           {k: t(v) for k, v in fields.items()},
                           yee_staggering(3), g, order, galerkin)
    ref = j_gather.gather_eb([jnp.asarray(p) for p in pos],
                             {k: jnp.asarray(v) for k, v in fields.items()},
                             j_yee_staggering(3), jg, order, galerkin)
    for a, b in zip(got, ref):
        close(a, b)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_deposit_rho_and_count(order):
    rng = np.random.default_rng(10 + order)
    jg, g = geoms()
    pos = positions(rng, g, 3000)
    w = rng.uniform(0.5, 1.5, 3000) * 1e9
    q = -1.602176634e-19
    close(deposit.deposit_rho([t(p) for p in pos], t(w), q, g, order),
          j_deposit.deposit_rho([jnp.asarray(p) for p in pos],
                                jnp.asarray(w), q, jg, order))
    inside = [np.clip(p, lo, hi - 1e-12) for p, lo, hi in
              zip(pos, g.prob_lo, g.prob_hi)]
    alive = rng.random(3000) > 0.3
    np.testing.assert_array_equal(
        deposit.count_particles_per_cell([t(p) for p in inside],
                                         torch.from_numpy(alive), g).numpy(),
        np.asarray(j_deposit.count_particles_per_cell(
            [jnp.asarray(p) for p in inside], jnp.asarray(alive), jg)))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_deposit_current_esirkepov(order):
    rng = np.random.default_rng(20 + order)
    jg, g = geoms()
    n = 3000
    pos = positions(rng, g, n)
    u = rng.normal(0, 0.3 * C, (3, n))
    w = rng.uniform(0.5, 1.5, n) * 1e9
    q, dt = 1.602176634e-19, 0.5 * min(g.dx) / C
    got = deposit.deposit_current_esirkepov(
        [t(p) for p in pos], *map(t, u), t(w), q, g, dt, order)
    ref = j_deposit.deposit_current_esirkepov(
        [jnp.asarray(p) for p in pos], *map(jnp.asarray, u), jnp.asarray(w),
        q, jg, dt, order)
    for a, b in zip(got, ref):
        close(a, b)


def _fields(rng, n_cell):
    return {nm: rng.normal(size=n_cell) * s for nm, s in (
        ("Ex", 1e10), ("Ey", 1e10), ("Ez", 1e10), ("Bx", 30.0),
        ("By", 30.0), ("Bz", 30.0), ("jx", 1e14), ("jy", 1e14),
        ("jz", 1e14))}


@pytest.mark.parametrize("algo", ["yee", "ckc"])
def test_yee_evolve(algo):
    rng = np.random.default_rng(30)
    jg, g = geoms()
    f = _fields(rng, g.n_cell)
    tf = FieldState(**{k: t(v) for k, v in f.items()})
    jf = JFieldState(**{k: jnp.asarray(v) for k, v in f.items()})
    dt = (j_yee.compute_dt_yee(jg, 0.99) if algo == "yee"
          else j_yee.compute_dt_ckc(jg, 0.99))
    assert dt == (yee.compute_dt_yee(g, 0.99) if algo == "yee"
                  else yee.compute_dt_ckc(g, 0.99))
    got = yee.evolve_e(yee.evolve_b(tf, g, 0.5 * dt, algo), g, dt, algo)
    ref = j_yee.evolve_e(j_yee.evolve_b(jf, jg, 0.5 * dt, algo), jg, dt, algo)
    for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
        close(getattr(got, nm), getattr(ref, nm))
    close(yee.compute_div_e(got, g), j_yee.compute_div_e(ref, jg))
    close(yee.compute_div_b(got, g), j_yee.compute_div_b(ref, jg))


_INJECT = [
    dict(injection_style="nuniformpercell",
         num_particles_per_cell_each_dim=(2, 1, 3),
         momentum_distribution="gaussian", ux_th=0.1, uy_th=0.2, uz_th=0.05,
         uz=0.3),
    dict(injection_style="nrandompercell", num_particles_per_cell=3,
         momentum_distribution="gaussian", ux_th=0.01, uy_th=0.01,
         uz_th=0.01),
    dict(injection_style="nuniformpercell",
         num_particles_per_cell_each_dim=(1, 2, 1),
         momentum_distribution="constant", ux=0.1, uy=-0.2, uz=0.3),
    dict(injection_style="nrandompercell", num_particles_per_cell=2,
         momentum_distribution="at_rest"),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", range(len(_INJECT)))
def test_inject_species_bit_identical(case, dtype):
    kw = dict(name="e", charge=-1.602176634e-19, mass=9.1093837015e-31,
              profile="constant", density=1e24, **_INJECT[case])
    jg, g = geoms((8, 6, 4))
    ref = j_injection.inject_species(JSpeciesConfig(**kw), jg, dtype,
                                     np.random.default_rng(5))
    got = injection.inject_species(
        SpeciesConfig(**kw), g, np.random.default_rng(5),
        dtype=torch.float64 if dtype == np.float64 else torch.float32,
        device="cpu")
    for k in ("x", "y", "z", "ux", "uy", "uz", "w", "alive"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_unported_injection_raises():
    """A species the injection does not place (a Gaussian beam comes from
    ``inject_gaussian_beam``) gets the JAX package's empty container; a
    predefined profile the deck reader did not turn into a parsed one is
    refused, as the JAX package refuses it (ROADMAP.md Queue C); a parsed
    profile needs its function; an unknown style raises."""
    jg, g = geoms()
    sp = SpeciesConfig(name="e", charge=-1.0, mass=1.0,
                       injection_style="gaussian_beam")
    got = injection.inject_species(sp, g, np.random.default_rng(0),
                                   dtype=torch.float64, device="cpu",
                                   capacity=5)
    ref = j_injection.inject_species(
        JSpeciesConfig(**dataclasses.asdict(sp)), jg, np.float64,
        np.random.default_rng(0), capacity=5)
    for k in ("x", "y", "z", "ux", "uy", "uz", "w", "alive"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    sp = dataclasses.replace(sp, injection_style="nrandompercell",
                             num_particles_per_cell=1, profile="predefined")
    with pytest.raises(NotImplementedError,
                       match="JAX package refuses it too.*Queue C"):
        injection.inject_species(sp, g, np.random.default_rng(0),
                                 dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="predefined"):
        j_injection.inject_species(
            JSpeciesConfig(**dataclasses.asdict(sp)), jg, np.float64,
            np.random.default_rng(0))
    sp = dataclasses.replace(sp, profile="parse_density_function")
    with pytest.raises(ValueError, match="density_function"):
        injection.inject_species(sp, g, np.random.default_rng(0),
                                 dtype=torch.float64, device="cpu")
    sp = dataclasses.replace(sp, injection_style="nuniformpercel")
    with pytest.raises(ValueError, match="unknown injection style"):
        injection.inject_species(sp, g, np.random.default_rng(0),
                                 dtype=torch.float64, device="cpu")


# ---- the 2D XZ cases ---------------------------------------------------------

@pytest.mark.parametrize("order,galerkin", [(1, True), (2, True), (3, True),
                                            (2, False)])
def test_gather_eb_2d(order, galerkin):
    rng = np.random.default_rng(40 + order)
    jg, g = geoms2d()
    pos = positions(rng, g, 3000)
    fields = {nm: rng.normal(size=g.n_cell)
              for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")}
    assert yee_staggering(2) == j_yee_staggering(2)
    got = gather.gather_eb([t(p) for p in pos],
                           {k: t(v) for k, v in fields.items()},
                           yee_staggering(2), g, order, galerkin)
    ref = j_gather.gather_eb([jnp.asarray(p) for p in pos],
                             {k: jnp.asarray(v) for k, v in fields.items()},
                             j_yee_staggering(2), jg, order, galerkin)
    for a, b in zip(got, ref):
        close(a, b)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_deposit_2d(order):
    """2D deposit_rho, part_per_cell and the 2D Esirkepov branch (Jx, Jz
    cumulative, Jy direct)."""
    rng = np.random.default_rng(50 + order)
    jg, g = geoms2d()
    n = 3000
    pos = positions(rng, g, n)
    u = rng.normal(0, 0.3 * C, (3, n))
    w = rng.uniform(0.5, 1.5, n) * 1e9
    q, dt = 1.602176634e-19, 0.5 * min(g.dx) / C
    close(deposit.deposit_rho([t(p) for p in pos], t(w), q, g, order),
          j_deposit.deposit_rho([jnp.asarray(p) for p in pos],
                                jnp.asarray(w), q, jg, order))
    got = deposit.deposit_current_esirkepov(
        [t(p) for p in pos], *map(t, u), t(w), q, g, dt, order)
    ref = j_deposit.deposit_current_esirkepov(
        [jnp.asarray(p) for p in pos], *map(jnp.asarray, u), jnp.asarray(w),
        q, jg, dt, order)
    for a, b in zip(got, ref):
        assert a.shape == g.n_cell
        close(a, b)
    for a, b in zip(push.position_step(tuple(map(t, pos)), *map(t, u), dt, 2),
                    j_push.position_step(tuple(map(jnp.asarray, pos)),
                                         *map(jnp.asarray, u), dt, 2)):
        close(a, b)


@pytest.mark.parametrize("algo", ["yee", "ckc"])
def test_yee_evolve_2d(algo):
    rng = np.random.default_rng(31)
    jg, g = geoms2d()
    f = _fields(rng, g.n_cell)
    tf = FieldState(**{k: t(v) for k, v in f.items()})
    jf = JFieldState(**{k: jnp.asarray(v) for k, v in f.items()})
    dt = (j_yee.compute_dt_yee(jg, 0.99) if algo == "yee"
          else j_yee.compute_dt_ckc(jg, 0.99))
    assert dt == (yee.compute_dt_yee(g, 0.99) if algo == "yee"
                  else yee.compute_dt_ckc(g, 0.99))
    got = yee.evolve_e(yee.evolve_b(tf, g, 0.5 * dt, algo), g, dt, algo)
    ref = j_yee.evolve_e(j_yee.evolve_b(jf, jg, 0.5 * dt, algo), jg, dt, algo)
    for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
        close(getattr(got, nm), getattr(ref, nm))
    close(yee.compute_div_e(got, g), j_yee.compute_div_e(ref, jg))
    close(yee.compute_div_b(got, g), j_yee.compute_div_b(ref, jg))


@pytest.mark.parametrize("shape,npass", [
    ((16, 12), (1, 1)), ((16, 12), (2, 1)),
    ((16, 12, 8), (1, 1, 1)), ((16, 12, 8), (2, 1, 1)),
])
def test_bilinear_filter(shape, npass):
    arr = np.random.default_rng(len(shape)).normal(size=shape)
    close(t_filter.bilinear_filter(t(arr), npass),
          j_filter.bilinear_filter(jnp.asarray(arr), npass))
    # a binomial pass conserves the sum on the periodic torus
    assert abs(float(t_filter.bilinear_filter(t(arr), npass).sum())
               - arr.sum()) <= 1e-12 * np.abs(arr).sum()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", range(len(_INJECT)))
def test_inject_species_2d_bit_identical(case, dtype):
    kw = dict(name="e", charge=-1.602176634e-19, mass=9.1093837015e-31,
              profile="constant", density=1e24, **_INJECT[case])
    jg, g = geoms2d((8, 6))
    ref = j_injection.inject_species(JSpeciesConfig(**kw), jg, dtype,
                                     np.random.default_rng(5))
    got = injection.inject_species(
        SpeciesConfig(**kw), g, np.random.default_rng(5),
        dtype=torch.float64 if dtype == np.float64 else torch.float32,
        device="cpu")
    assert got.y is None and ref.y is None  # (x, z) are the coordinates
    for k in ("x", "z", "ux", "uy", "uz", "w", "alive"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kw", [
    dict(bounds_lo=(-1.2e-5, -0.5e-5), bounds_hi=(0.8e-5, float("inf"))),
    dict(bounds_lo=(-1.0e-5, -1.0e-5), bounds_hi=(1.0e-5, 1.0e-5),
         capacity_factor=1.5),
])
def test_inject_species_bounds_and_capacity_bit_identical(kw, dtype):
    """Injection bounds, the capacity factor and an explicit capacity, as
    the bounded step's continuously injected plasma uses them."""
    base = dict(name="e", charge=-1.602176634e-19, mass=9.1093837015e-31,
                profile="constant", density=1e24,
                injection_style="nuniformpercell",
                num_particles_per_cell_each_dim=(2, 2, 1), **kw)
    jg, g = geoms2d((8, 6))
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    for capacity in (None, 400):
        ref = j_injection.inject_species(JSpeciesConfig(**base), jg, dtype,
                                         np.random.default_rng(5), capacity)
        got = injection.inject_species(
            SpeciesConfig(**base), g, np.random.default_rng(5), dtype=tdtype,
            device="cpu", capacity=capacity)
        assert 0 < int(got.alive.sum()) < 8 * 6 * 4 < got.capacity + 200
        for k in ("x", "z", "ux", "uy", "uz", "w", "alive"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(ref, k)), k)


def test_count_particles_per_cell_with_origin():
    rng = np.random.default_rng(8)
    jg, g = geoms2d((8, 6))
    pos = positions(rng, g, 500)[:2]
    alive = rng.random(500) > 0.3
    origin = (g.prob_lo[0], g.prob_lo[1] + 2.5 * g.dx[1])
    ref = j_deposit.count_particles_per_cell(
        [jnp.asarray(p) for p in pos], jnp.asarray(alive), jg, origin=origin)
    got = deposit.count_particles_per_cell(
        [t(p) for p in pos], torch.tensor(alive), g, origin=origin)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
