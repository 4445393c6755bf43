"""The port's tile-binned layout against the JAX package's (CPU, float64).

``jax.lax.sort`` is not stable and ``torch.sort(stable=True)`` is, so the
rebinned slots are compared per tile as sorted multisets of particles; dead
slots and counters are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.state import ParticleState as JParticleState
from warpx_tpu.ops import tiling as j_tiling
from warpx_tpu_torch.core.grid import Geometry
from warpx_tpu_torch.core.state import ParticleState
from warpx_tpu_torch.ops import tiling

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

LX = 40e-6
FIELDS = ("x", "y", "z", "ux", "uy", "uz", "w")


def geoms(n=16):
    kw = dict(ndim=3, n_cell=(n,) * 3, prob_lo=(-LX / 2,) * 3,
              prob_hi=(LX / 2,) * 3, periodic=(True,) * 3)
    return JGeometry(**kw), Geometry(**kw)


@pytest.mark.parametrize("n,order,margin,tile,p_max", [
    (16, 1, 1, (8, 8, 8), None),
    (16, 3, 2, (8, 8, 8), 512),
    (24, 2, 1, (8, 8, 8), None),
    (32, 1, 1, (16, 16, 16), None),
])
def test_tile_spec_matches(n, order, margin, tile, p_max):
    args = ((n,) * 3, order, 5000)
    kw = dict(tile=tile, margin=margin, interval=3, headroom=1.5,
              p_max=p_max)
    got = tiling.TileSpec.create(*args, **kw)
    ref = j_tiling.TileSpec.create(*args, **kw)
    assert dataclasses_equal(got, ref)


def dataclasses_equal(a, b):
    names = ("tile", "tiles_per_dim", "p_max", "order", "margin",
             "interval", "w", "off")
    return all(getattr(a, k) == getattr(b, k) for k in names)


@pytest.mark.parametrize("n,tile", [(16, (8, 8, 8)), (32, (16, 16, 16))])
def test_extract_fold_adjoint_and_match(n, tile):
    """extract and fold are adjoint, and both equal the JAX package's; the
    (32, 16) case takes the general fold path (w % tile != 0)."""
    jg, g = geoms(n)
    spec = tiling.TileSpec.create(g.n_cell, order=1, n_particles=1000,
                                  tile=tile, margin=1, interval=1, p_max=128)
    jspec = j_tiling.TileSpec.create(g.n_cell, order=1, n_particles=1000,
                                     tile=tile, margin=1, interval=1,
                                     p_max=128)
    rng = np.random.default_rng(n)
    grid = rng.normal(size=g.n_cell)
    wr = rng.normal(size=(spec.n_tiles, spec.w, spec.w * spec.w))
    ext = tiling.extract_windows(torch.from_numpy(grid), spec)
    np.testing.assert_array_equal(
        ext.numpy(), np.asarray(j_tiling.extract_windows(jnp.asarray(grid),
                                                          jspec)))
    for axes in ((0, 1, 2), (1, 0, 2), (2, 0, 1)):
        fold = tiling.fold_windows(torch.from_numpy(wr), spec, g.n_cell,
                                   axes=axes)
        ref = np.asarray(j_tiling.fold_windows(jnp.asarray(wr), jspec,
                                               jg.n_cell, axes=axes))
        assert np.abs(fold.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    lhs = float((ext * torch.from_numpy(wr)).sum())
    rhs = float((torch.from_numpy(grid) * tiling.fold_windows(
        torch.from_numpy(wr), spec, g.n_cell)).sum())
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


def _particles(rng, cap, overfull_tile_at=None):
    pos = rng.uniform(-LX / 2, LX / 2, (3, cap))
    pos[0, :10] += LX  # out of the domain: must wrap
    pos[1, 10:20] -= LX
    if overfull_tile_at is not None:
        pos[:, :overfull_tile_at] = (-LX / 2 + 1e-7
                                     + rng.uniform(0, 1e-6, (3, overfull_tile_at)))
    alive = rng.random(cap) > 0.2
    vals = dict(
        x=pos[0], y=pos[1], z=pos[2],
        ux=rng.normal(size=cap), uy=rng.normal(size=cap),
        uz=rng.normal(size=cap), w=(rng.random(cap) + 0.5) * alive,
    )
    sp = ParticleState(alive=torch.from_numpy(alive),
                       **{k: torch.from_numpy(v.copy()) for k, v in vals.items()})
    jsp = JParticleState(alive=jnp.asarray(alive),
                         **{k: jnp.asarray(v) for k, v in vals.items()})
    return sp, jsp


@pytest.mark.parametrize("overfull", [None, 700])
def test_rebin_matches_jax(overfull):
    jg, g = geoms()
    spec = tiling.TileSpec.create(g.n_cell, order=1, n_particles=4096,
                                  margin=1, interval=1, p_max=512)
    jspec = j_tiling.TileSpec.create(g.n_cell, order=1, n_particles=4096,
                                     margin=1, interval=1, p_max=512)
    sp, jsp = _particles(np.random.default_rng(1), 4096, overfull)
    new, ovf = tiling.rebin(sp, g, spec)
    jnew, jovf = j_tiling.rebin(jsp, jg, jspec)
    assert int(ovf) == int(jovf)
    assert (int(ovf) > 0) == (overfull is not None)
    P = spec.p_max
    alive = new.alive.numpy()
    np.testing.assert_array_equal(alive, np.asarray(jnew.alive))
    got = np.stack([getattr(new, k).numpy() for k in FIELDS], axis=1)
    ref = np.stack([np.asarray(getattr(jnew, k)) for k in FIELDS], axis=1)
    # dead slots: tile-center positions, zero momentum and weight
    np.testing.assert_array_equal(got[~alive], ref[~alive])
    counts = np.bincount(np.nonzero(alive)[0] // P, minlength=spec.n_tiles)
    for tt in range(spec.n_tiles):
        if counts[tt] >= P:
            continue  # which particles an overfull tile keeps is order-dependent
        sl = slice(tt * P, (tt + 1) * P)
        a = got[sl][alive[sl]]
        b = ref[sl][alive[sl]]
        a = a[np.lexsort(a.T[::-1])]
        b = b[np.lexsort(b.T[::-1])]
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tiling.tile_ids(new.positions(3), g, spec).numpy(),
        np.asarray(j_tiling.tile_ids(jnew.positions(3), jg, jspec)))


def test_ragged_expand_plain_formula():
    """K3's plain version is tiling.py:293-296's gather plus the fills."""
    rng = np.random.default_rng(2)
    n_tiles, p_max, n_attr = 16, 128, 8
    key = np.sort(rng.integers(0, n_tiles + 1, 1500))
    key[:200] = 3  # tile 3 over capacity
    key = np.sort(key)
    offsets = np.searchsorted(key, np.arange(n_tiles)).astype(np.int32)
    counts = (np.searchsorted(key, np.arange(1, n_tiles + 1))
              - offsets).astype(np.int32)
    payload = rng.normal(size=(n_attr, key.size))
    fill = rng.normal(size=(n_attr, n_tiles))
    got = tiling.ragged_expand(torch.from_numpy(payload),
                               torch.from_numpy(offsets),
                               torch.from_numpy(counts),
                               torch.from_numpy(fill), p_max).numpy()
    slot = np.arange(p_max)[None, :]
    src = np.clip((offsets[:, None] + slot).reshape(-1), 0, key.size - 1)
    valid = (slot < counts[:, None]).reshape(-1)
    ref = np.where(valid, payload[:, src],
                   np.repeat(fill, p_max, axis=1))
    np.testing.assert_array_equal(got, ref)
    assert tiling.ragged_expand.launches == 0  # CPU tensors: plain version


# ---- the 2D XZ layout and the open fold --------------------------------------

def geoms2d(n=32):
    kw = dict(ndim=2, n_cell=(n,) * 2, prob_lo=(-LX / 2,) * 2,
              prob_hi=(LX / 2,) * 2, periodic=(True,) * 2)
    return JGeometry(**kw), Geometry(**kw)


def _specs(n_cell, **kw):
    return (tiling.TileSpec.create(n_cell, **kw),
            j_tiling.TileSpec.create(n_cell, **kw))


@pytest.mark.parametrize("order,tile", [(1, (8, 8)), (3, (8, 8)),
                                        (1, (16, 16))])
def test_extract_fold_2d_adjoint_and_match(order, tile):
    """2D windows are (n_tiles, W, W) in layout (x, z); (16, 16) tiles take
    the general fold path (w % tile != 0)."""
    jg, g = geoms2d()
    spec, jspec = _specs(g.n_cell, order=order, n_particles=1000, tile=tile,
                         margin=1, interval=1, p_max=128)
    assert dataclasses_equal(spec, jspec) and spec.ndim == 2
    rng = np.random.default_rng(order)
    grid = rng.normal(size=g.n_cell)
    wr = rng.normal(size=(spec.n_tiles, spec.w, spec.w))
    ext = tiling.extract_windows(torch.from_numpy(grid), spec)
    assert ext.shape == (spec.n_tiles, spec.w, spec.w)
    np.testing.assert_array_equal(
        ext.numpy(), np.asarray(j_tiling.extract_windows(jnp.asarray(grid),
                                                          jspec)))
    fold = tiling.fold_windows(torch.from_numpy(wr), spec, g.n_cell,
                               axes=(0, 1))
    ref = np.asarray(j_tiling.fold_windows(jnp.asarray(wr), jspec, jg.n_cell,
                                           axes=(0, 1)))
    assert np.abs(fold.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    lhs = float((ext * torch.from_numpy(wr)).sum())
    rhs = float((torch.from_numpy(grid) * fold).sum())
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


@pytest.mark.parametrize("overfull", [None, 300])
def test_rebin_2d_matches_jax(overfull):
    """Payload order x, z, ux, uy, uz, w, alive; y is not carried."""
    jg, g = geoms2d()
    spec, jspec = _specs(g.n_cell, order=1, n_particles=4096, margin=1,
                         interval=1, p_max=256)
    sp3, jsp3 = _particles(np.random.default_rng(4), 4096, overfull)
    sp, jsp = sp3.replace(y=None), jsp3.replace(y=None)
    new, ovf = tiling.rebin(sp, g, spec)
    jnew, jovf = j_tiling.rebin(jsp, jg, jspec)
    assert new.y is None
    assert int(ovf) == int(jovf)
    assert (int(ovf) > 0) == (overfull is not None)
    P = spec.p_max
    names = ("x", "z", "ux", "uy", "uz", "w")
    alive = new.alive.numpy()
    np.testing.assert_array_equal(alive, np.asarray(jnew.alive))
    got = np.stack([getattr(new, k).numpy() for k in names], axis=1)
    ref = np.stack([np.asarray(getattr(jnew, k)) for k in names], axis=1)
    np.testing.assert_array_equal(got[~alive], ref[~alive])
    counts = np.bincount(np.nonzero(alive)[0] // P, minlength=spec.n_tiles)
    for tt in range(spec.n_tiles):
        if counts[tt] >= P:
            continue  # which particles an overfull tile keeps is order-dependent
        sl = slice(tt * P, (tt + 1) * P)
        a = got[sl][alive[sl]]
        b = ref[sl][alive[sl]]
        np.testing.assert_array_equal(a[np.lexsort(a.T[::-1])],
                                      b[np.lexsort(b.T[::-1])])
    np.testing.assert_array_equal(
        tiling.tile_ids(new.positions(2), g, spec).numpy(),
        np.asarray(j_tiling.tile_ids(jnew.positions(2), jg, jspec)))


@pytest.mark.parametrize("ndim,axes", [
    (2, (0, 1)), (3, (0, 1, 2)), (3, (1, 0, 2)), (3, (2, 0, 1)),
])
def test_fold_windows_open_matches_jax(ndim, axes):
    n = (32, 16) if ndim == 2 else (16, 8, 24)
    spec, jspec = _specs(n, order=3 if ndim == 2 else 1, n_particles=1000,
                         tile=(8,) * ndim, margin=1, interval=1, p_max=128)
    wr = np.random.default_rng(ndim).normal(
        size=(spec.n_tiles, spec.w, spec.w ** (ndim - 1)))
    got = tiling.fold_windows_open(torch.from_numpy(wr), spec, axes=axes)
    ref = np.asarray(j_tiling.fold_windows_open(jnp.asarray(wr), jspec,
                                                axes=axes))
    assert got.shape == tuple(nd + spec.w - 8 for nd in n)
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    # wrapping the open fold's guard cells gives the periodic fold
    per = tiling.fold_windows(torch.from_numpy(wr), spec, n, axes=axes)
    idx = np.ix_(*[(np.arange(e) - spec.off) % nd
                   for e, nd in zip(got.shape, n)])
    wrapped = np.zeros(n)
    np.add.at(wrapped, idx, got.numpy())
    assert np.abs(wrapped - per.numpy()).max() <= 1e-12 * np.abs(wrapped).max()


def test_fold_windows_open_needs_divisible_window():
    spec = tiling.TileSpec.create((32, 32), order=1, n_particles=100,
                                  tile=(16, 16), margin=1, interval=1,
                                  p_max=128)
    with pytest.raises(NotImplementedError, match="w % tile"):
        tiling.fold_windows_open(
            torch.zeros(spec.n_tiles, spec.w, spec.w), spec)


@pytest.mark.parametrize("shift", [0.0, 2.25, -3.5])
def test_tile_ids_with_origin_match(shift):
    """tile_ids with the tiling anchored ``shift`` cells off prob_lo along
    z; positions beyond the tiling clip into the edge tiles."""
    rng = np.random.default_rng(4)
    jg, g = geoms(16)
    spec = tiling.TileSpec.create(g.n_cell, order=1, n_particles=1000,
                                  margin=1, interval=1)
    jspec = j_tiling.TileSpec.create(g.n_cell, order=1, n_particles=1000,
                                     margin=1, interval=1)
    pos = rng.uniform(-0.6 * LX, 0.6 * LX, (3, 2000))
    origin = (g.prob_lo[0], g.prob_lo[1], g.prob_lo[2] + shift * g.dx[2])
    ref = j_tiling.tile_ids([jnp.asarray(p) for p in pos], jg, jspec,
                            origin=origin)
    got = tiling.tile_ids([torch.tensor(p) for p in pos], g, spec,
                          origin=origin)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    centers = tiling.tile_centers(g, spec, torch.float64, "cpu",
                                  origin=origin)
    assert float(centers[2, 0]) == pytest.approx(
        origin[2] + 0.5 * spec.tile[2] * g.dx[2], rel=1e-14)
