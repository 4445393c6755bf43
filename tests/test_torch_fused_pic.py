"""The fused kernels' plain version against the JAX package's Pallas kernels.

``binned_push_deposit_plain`` (CPU, float64) and
``warpx_tpu.ops.pallas_pic.binned_push_deposit(..., interpret=True)`` take
the same tile layout, made with numpy from a seed: two species with dead
slots, one (species, tile) with no alive particle, and alive particles
whose deposit stencil is clipped at their window's low side.  Dead slots
lie at their tile's center, where the rebin puts them.  The pushed
particles (every slot) and the current windows agree to 1e-12 relative;
the violation counts are equal.  3D holds K1's plain version, 2D K2's, and
the moving-window mode (anchors, zshift, smax) holds both.  In 2D at order
1 a dead slot may have been gathered from either node of a box-edge tie
(see ``_compare``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.ops import pallas_pic
from warpx_tpu.ops.tiling import TileSpec as JTileSpec
from warpx_tpu_torch.core.grid import Geometry, yee_staggering
from warpx_tpu_torch.ops import fused_pic
from warpx_tpu_torch.ops.tiling import TileSpec

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

LX = 40e-6
C = 299792458.0
RTOL = 1e-12
PARAMS = np.array([[-1.602176634e-19, 9.1093837015e-31, 1e9, 0, 0, 0, 0, 1.0],
                   [1.602176634e-19, 1.67262192369e-27, 0, 0, 0, 0, 0, 0]])


def _layout(order, ndim=3, smax=0, anchor_off=0.0):
    """Geometry, tile spec, particle columns (ndim + 4, 2 * n_tiles, p_max),
    counts, the six padded fields (last axis longer by ``smax``) and the
    tiling origin, ``anchor_off`` cells above ``prob_lo``."""
    n = 16 if ndim == 3 else 32
    kw = dict(ndim=ndim, n_cell=(n,) * ndim, prob_lo=(-LX / 2,) * ndim,
              prob_hi=(LX / 2,) * ndim, periodic=(True,) * ndim)
    geom, jgeom = Geometry(**kw), JGeometry(**kw)
    skw = dict(order=order, n_particles=8 * 64, margin=1, interval=3,
               p_max=128)
    spec = TileSpec.create(geom.n_cell, **skw)
    jspec = JTileSpec.create(geom.n_cell, **skw)
    rng = np.random.default_rng(order if ndim == 3 else 20 + order)
    nt, P, dx = spec.n_tiles, spec.p_max, geom.dx[0]
    tpd = spec.tiles_per_dim
    lo = -LX / 2 + anchor_off * dx
    cols = np.zeros((ndim + 4, 2 * nt, P))
    counts = np.zeros(2 * nt, np.int32)
    for s in range(2):
        for t in range(nt):
            tix = np.unravel_index(t, tpd)
            row = s * nt + t
            k = 0 if (s == 1 and t == 0) else int(rng.integers(40, 100))
            counts[row] = k
            for d in range(ndim):
                cell = tix[d] * spec.tile[d] + spec.tile[d] / 2
                cols[d, row] = lo + cell * dx  # dead: tile center
                cols[d, row, :k] = lo + (
                    tix[d] * spec.tile[d]
                    + rng.uniform(-0.5, spec.tile[d] + 0.5, k)) * dx
            cols[ndim:ndim + 3, row, :k] = rng.normal(0, 0.1 * C, (3, k))
            cols[ndim + 3, row, :k] = rng.uniform(0.5, 1.5, k) * 1e10
    # alive particles at rest whose stencil starts at window row -1: slot 0
    # of tile 0 along x, slot 1 along the last axis
    edge = lo + (-spec.off + 0.25 + 0.5 * order) * dx
    cols[0, 0, 0] = edge
    cols[ndim - 1, 0, 1] = edge
    cols[ndim:ndim + 3, 0, :2] = 0.0
    shape = list(fused_pic.padded_shape(spec, geom.n_cell, smax))
    fields = [rng.normal(0, s, shape) for s in (1e10,) * 3 + (30.0,) * 3]
    return geom, jgeom, spec, jspec, cols, counts, fields, (lo,) * ndim


def _lane_pad(f):
    """The Pallas call wants the last field axis a multiple of 128 lanes."""
    pw = [(0, 0)] * (f.ndim - 1) + [(0, (-f.shape[-1]) % 128)]
    return jnp.asarray(np.pad(f, pw))


def _compare(ndim, order, pusher, smax=0, zshift=None, anchor_off=0.0,
             mxu="f32"):
    geom, jgeom, spec, jspec, cols, counts, fields, lo = _layout(
        order, ndim, smax, anchor_off)
    stag = tuple(sorted((k, tuple(v))
                        for k, v in yee_staggering(ndim).items()))
    kw = dict(order=order, galerkin=True, pusher_name=pusher,
              dt=0.999 * min(geom.dx) / (C * ndim ** 0.5), stag_items=stag,
              smax=smax, mxu=mxu)
    mode = {} if zshift is None else dict(anchors=lo, zshift=zshift)
    jmode = {} if zshift is None else dict(
        anchors=jnp.asarray(lo), zshift=jnp.asarray(zshift, jnp.int32))
    def port(c):
        return fused_pic.binned_push_deposit(
            torch.from_numpy(PARAMS),
            tuple(torch.from_numpy(f) for f in fields),
            tuple(torch.from_numpy(a.copy()) for a in c),
            counts=torch.from_numpy(counts), spec=spec, geom=geom, **mode,
            **kw)

    got = port(cols)
    ref = pallas_pic.binned_push_deposit(
        jnp.asarray(PARAMS), tuple(_lane_pad(f) for f in fields),
        tuple(jnp.asarray(c) for c in cols), counts=jnp.asarray(counts),
        spec=jspec, geom=jgeom, interpret=True, **jmode, **kw)
    assert len(got[0]) == len(ref[0]) == ndim + 3
    refp = [np.asarray(b) for b in ref[0]]
    for a, b in zip(got[1], ref[1]):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= RTOL * np.abs(b).max()

    def within(out):
        """Per slot: every pushed column within RTOL of the reference."""
        ok = np.ones(cols[0].shape, bool)
        for a, b in zip(out[0], refp):
            assert a.shape == b.shape
            ok &= np.abs(a.numpy() - b) <= RTOL * np.abs(b).max()
        return ok

    ok = within(got)
    if ndim == 2 and order == 1:
        # A dead slot lies at its tile's center, where the staggered
        # order-0 (Galerkin) gather is on the edge of its half-open box.
        # XLA contracts the window coordinate's multiply-subtract on the
        # CPU and the port does not, so either package may take either node
        # there (ROADMAP.md Queue C).  Alive slots are held as they are; a
        # dead slot must agree with the port's push from one of the two
        # nodes per axis, reached by moving it 2e-13 cells either way.
        dead = cols[ndim + 3] == 0
        assert ok[~dead].all()
        for sx in (-1, 1):
            for sz in (-1, 1):
                moved = cols.copy()
                moved[0][dead] += sx * 2e-13 * geom.dx[0]
                moved[1][dead] += sz * 2e-13 * geom.dx[1]
                ok |= within(port(moved)) & dead
    assert ok.all()
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert int(got[2].sum()) == 2
    # the empty (species, tile) copies its slots through
    for c in range(ndim + 3):
        np.testing.assert_array_equal(got[0][c][spec.n_tiles].numpy(),
                                      cols[c, spec.n_tiles])
    assert fused_pic.binned_push_deposit.launches == 0
    assert fused_pic.binned_push_deposit.launches_2d == 0


@pytest.mark.parametrize("pusher", ["boris", "vay", "higuera"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_plain_matches_pallas_interpret(order, pusher):
    _compare(3, order, pusher)


@pytest.mark.parametrize("pusher", ["boris", "vay", "higuera"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_plain_2d_matches_pallas_interpret(order, pusher):
    _compare(2, order, pusher)


@pytest.mark.parametrize("zshift", [0, 3, 8])
@pytest.mark.parametrize("ndim,order", [(2, 3), (3, 1)])
def test_moving_window_mode_matches_pallas_interpret(ndim, order, zshift):
    """smax = 8 slack cells on the last field axis, the window slid back by
    zshift, the tiles anchored 0.37 cells off prob_lo."""
    _compare(ndim, order, "boris", smax=8, zshift=zshift, anchor_off=0.37)


def test_zero_shift_equals_periodic_call():
    """anchors = prob_lo, zshift = 0, smax = 0 is the call without them."""
    geom, _, spec, _, cols, counts, fields, lo = _layout(2, 2)
    args = (torch.from_numpy(PARAMS),
            tuple(torch.from_numpy(f) for f in fields),
            tuple(torch.from_numpy(c.copy()) for c in cols))
    kw = dict(counts=torch.from_numpy(counts), spec=spec, geom=geom, order=2,
              galerkin=True, pusher_name="vay", dt=1e-16,
              stag_items=tuple(yee_staggering(2).items()))
    a = fused_pic.binned_push_deposit(*args, **kw)
    b = fused_pic.binned_push_deposit(*args, anchors=geom.prob_lo, zshift=0,
                                      smax=0, **kw)
    for x, y in zip(a[0] + a[1] + (a[2],), b[0] + b[1] + (b[2],)):
        assert torch.equal(x, y)


def test_unported_modes_raise():
    geom, _, spec, _, cols, counts, fields, _ = _layout(1)
    args = (torch.from_numpy(PARAMS),
            tuple(torch.from_numpy(f) for f in fields),
            tuple(torch.from_numpy(c.copy()) for c in cols))
    kw = dict(counts=torch.from_numpy(counts), spec=spec, geom=geom, order=1,
              galerkin=True, pusher_name="boris", dt=1e-15,
              stag_items=tuple(yee_staggering(3).items()))
    # 'mixed' and 'bf16' are ported (tests/test_torch_mxu.py)
    with pytest.raises(ValueError, match="tile_mxu"):
        fused_pic.binned_push_deposit(*args, mxu="tf32", **kw)
    for mxu in ("mixed", "bf16"):
        out = fused_pic.binned_push_deposit(*args, mxu=mxu, **kw)
        assert all(bool(torch.isfinite(j).all()) for j in out[1])
    with pytest.raises(ValueError, match="zshift"):
        fused_pic.binned_push_deposit(*args, zshift=3, smax=2, **kw)
    with pytest.raises(ValueError, match="particle arrays"):
        fused_pic.binned_push_deposit(args[0], args[1], args[2][:6], **kw)
