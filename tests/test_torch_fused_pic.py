"""Kernel K1's plain version against the JAX package's Pallas kernel.

``binned_push_deposit_plain`` (CPU, float64) and
``warpx_tpu.ops.pallas_pic.binned_push_deposit(..., interpret=True)`` take
the same tile layout, made with numpy from a seed: two species with dead
slots, one (species, tile) with no alive particle, and one alive particle
whose deposit stencil is clipped at its window's low side.  The pushed
particles (every slot) and the current windows agree to 1e-12 relative;
the violation counts are equal.
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

LX = 40e-6
C = 299792458.0
RTOL = 1e-12


def _layout(order, n=16, p_max=128):
    kw = dict(ndim=3, n_cell=(n,) * 3, prob_lo=(-LX / 2,) * 3,
              prob_hi=(LX / 2,) * 3, periodic=(True,) * 3)
    geom, jgeom = Geometry(**kw), JGeometry(**kw)
    skw = dict(order=order, n_particles=8 * 64, margin=1, interval=3,
               p_max=p_max)
    spec = TileSpec.create(geom.n_cell, **skw)
    jspec = JTileSpec.create(geom.n_cell, **skw)
    rng = np.random.default_rng(order)
    nt, P, dx = spec.n_tiles, spec.p_max, geom.dx[0]
    tpd = spec.tiles_per_dim
    cols = np.zeros((7, 2 * nt, P))
    counts = np.zeros(2 * nt, np.int32)
    for s in range(2):
        for t in range(nt):
            tix = (t // (tpd[1] * tpd[2]), (t // tpd[2]) % tpd[1], t % tpd[2])
            row = s * nt + t
            k = 0 if (s == 1 and t == 0) else int(rng.integers(40, 100))
            counts[row] = k
            for d in range(3):
                cell = tix[d] * spec.tile[d] + spec.tile[d] / 2
                cols[d, row] = LX * -0.5 + cell * dx  # dead: tile center
                cols[d, row, :k] = -LX / 2 + (
                    tix[d] * spec.tile[d]
                    + rng.uniform(-0.5, spec.tile[d] + 0.5, k)) * dx
                cols[3 + d, row, :k] = rng.normal(0, 0.1 * C, k)
            cols[6, row, :k] = rng.uniform(0.5, 1.5, k) * 1e10
    # an alive particle whose x stencil starts at window row -1
    cols[0, 0, 0] = -LX / 2 + (-spec.off + 0.25 + 0.5 * order) * dx
    cols[3, 0, 0] = 0.0
    fields = [rng.normal(0, s, geom.n_cell) for s in (1e10,) * 3 + (30.0,) * 3]
    params = np.array([[-1.602176634e-19, 9.1093837015e-31, 1e9, 0, 0, 0,
                        0, 1.0],
                       [1.602176634e-19, 1.67262192369e-27, 0, 0, 0, 0, 0,
                        0]])
    return geom, jgeom, spec, jspec, cols, counts, fields, params


@pytest.mark.parametrize("pusher", ["boris", "vay", "higuera"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_plain_matches_pallas_interpret(order, pusher):
    geom, jgeom, spec, jspec, cols, counts, fields, params = _layout(order)
    stag = tuple(sorted((k, tuple(v)) for k, v in yee_staggering(3).items()))
    kw = dict(order=order, galerkin=True, pusher_name=pusher,
              dt=0.999 * min(geom.dx) / (C * 3 ** 0.5), stag_items=stag)
    got = fused_pic.binned_push_deposit(
        torch.from_numpy(params),
        fused_pic.pad_fields(tuple(torch.from_numpy(f) for f in fields), spec),
        tuple(torch.from_numpy(c.copy()) for c in cols),
        counts=torch.from_numpy(counts), spec=spec, geom=geom, **kw)
    ref = pallas_pic.binned_push_deposit(
        jnp.asarray(params),
        pallas_pic.pad_fields(tuple(jnp.asarray(f) for f in fields), jspec),
        tuple(jnp.asarray(c) for c in cols), counts=jnp.asarray(counts),
        spec=jspec, geom=jgeom, interpret=True, **kw)
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= RTOL * np.abs(b).max()
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert int(got[2].sum()) == 1
    # the empty (species, tile) copies its slots through
    for c in range(6):
        np.testing.assert_array_equal(got[0][c][spec.n_tiles].numpy(),
                                      cols[c, spec.n_tiles])
    assert fused_pic.binned_push_deposit.launches == 0


def test_unported_modes_raise():
    geom, _, spec, _, cols, counts, fields, params = _layout(1)
    args = (torch.from_numpy(params),
            fused_pic.pad_fields(tuple(torch.from_numpy(f) for f in fields),
                                 spec),
            tuple(torch.from_numpy(c.copy()) for c in cols))
    kw = dict(counts=torch.from_numpy(counts), spec=spec, geom=geom, order=1,
              galerkin=True, pusher_name="boris", dt=1e-15,
              stag_items=tuple(yee_staggering(3).items()))
    with pytest.raises(NotImplementedError, match="K1d"):
        fused_pic.binned_push_deposit(*args, mxu="bf16", **kw)
    with pytest.raises(NotImplementedError, match="K1c"):
        fused_pic.binned_push_deposit(*args, anchors=(0.0, 0.0, 0.0), **kw)
