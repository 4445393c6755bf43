"""The port's first-order PSATD push and the J-linear (multi-J) branch of
its second-order push against the JAX package's, on the CPU in float64.

``PsatdFirstOrder.push_first_order`` on the same seeded fields, in every
combination the multi-J loop hands it (J constant or linear in time; with
F/G cleaning, rho constant or linear), and ``PsatdSolver.push`` with
``j_old`` (standard, padded and one box; current correction, whose padded
form returns the corrected J and whose one-box form does not, as in the JAX
package; Galilean with update-with-rho), in 2D XZ and 3D, agree to 1e-12 of
each output's largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpx_tpu.constants import c
from warpx_tpu.core.grid import yee_staggering
from warpx_tpu.core.state import FieldState as JFieldState
from warpx_tpu.solvers import psatd as jpsatd
from warpx_tpu_torch.solvers import psatd as tpsatd

from .test_torch_psatd import _FIELDS, _dt, _geoms, _random, assert_rel

torch.set_num_threads(1)

_E_B = ("Ex", "Ey", "Ez", "Bx", "By", "Bz")


def _pair(data, names):
    return (tuple(jnp.asarray(data[nm]) for nm in names),
            tuple(torch.from_numpy(data[nm]) for nm in names))


# (J linear, cleaning, rho linear)
FIRST_ORDER = [(False, False, False), (True, False, False),
               (False, True, False), (False, True, True),
               (True, True, False), (True, True, True)]


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("j_lin,clean,rho_lin", FIRST_ORDER)
def test_push_first_order_matches_jax(ndim, j_lin, clean, rho_lin):
    jgeom, tgeom = _geoms(ndim)
    stag = yee_staggering(ndim)
    dt = 0.5 * _dt(jgeom)  # a multi-J sub-step
    kw = dict(j_in_time="linear" if j_lin else "constant",
              rho_in_time="linear" if rho_lin else "constant",
              div_cleaning=clean, update_with_rho=clean)
    jsol = jpsatd.PsatdFirstOrder(jgeom, stag, dt, **kw)
    tsol = tpsatd.PsatdFirstOrder(tgeom, stag, dt, dtype=torch.float64,
                                  device="cpu", **kw)
    assert tsol.n_fft == jsol.n_fft
    names = _FIELDS + (("F", "G") if clean else ())
    seed = 100 * ndim + 10 * j_lin + 2 * clean + rho_lin
    data = _random(jgeom.n_cell, names, seed)
    src = _random(jgeom.n_cell, ("j0x", "j0y", "j0z", "j1x", "j1y", "j1z",
                                 "r0", "r1"), seed + 1)
    jj0, tj0 = _pair(src, ("j0x", "j0y", "j0z"))
    jj1, tj1 = _pair(src, ("j1x", "j1y", "j1z")) if j_lin else (None, None)
    jr0 = tr0 = jr1 = tr1 = None
    if clean:
        jr0, tr0 = jnp.asarray(src["r0"]), torch.from_numpy(src["r0"])
        if rho_lin:
            jr1, tr1 = jnp.asarray(src["r1"]), torch.from_numpy(src["r1"])
    jout = jsol.push_first_order(
        JFieldState(**{nm: jnp.asarray(a) for nm, a in data.items()}),
        jj0, jj1, jr0, jr1)
    tout = tsol.push_first_order(
        {nm: torch.from_numpy(a) for nm, a in data.items()},
        tj0, tj1, tr0, tr1)
    for nm in _E_B + (("F", "G") if clean else ()):
        assert_rel(tout[nm], getattr(jout, nm), nm)
        assert not np.array_equal(tout[nm].numpy(), data[nm]), nm


def test_first_order_refuses_what_the_reference_does():
    _, tgeom = _geoms(2)
    stag = yee_staggering(2)
    for kw in (dict(v_galilean=(0.0, 0.0, 0.5 * c)),
               dict(current_correction=True), dict(vay_deposition=True)):
        with pytest.raises(NotImplementedError):
            tpsatd.PsatdFirstOrder(tgeom, stag, 1e-16, dtype=torch.float64,
                                   device="cpu", **kw)


J_OLD = {
    "standard": (dict(), False),
    "single_box": (dict(single_box=True), False),
    "current_correction": (dict(current_correction=True), True),
    "current_correction_single_box": (
        dict(current_correction=True, single_box=True), True),
    "galilean_rho": (dict(v_galilean=(0.0, 0.0, 0.6 * c),
                          update_with_rho=True), True),
}


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("family", list(J_OLD))
def test_push_with_j_old_matches_jax(family, ndim):
    kw, with_rho = J_OLD[family]
    jgeom, tgeom = _geoms(ndim)
    stag = yee_staggering(ndim)
    dt = _dt(jgeom)
    jsol = jpsatd.PsatdSolver(jgeom, stag, dt, **kw)
    tsol = tpsatd.PsatdSolver(tgeom, stag, dt, dtype=torch.float64,
                              device="cpu", **kw)
    data = _random(jgeom.n_cell, _FIELDS, seed=7 * ndim + len(family))
    old = _random(jgeom.n_cell, ("jox", "joy", "joz"), seed=3 + ndim)
    j_old_j, j_old_t = _pair(old, ("jox", "joy", "joz"))
    rho_j = rho_t = None
    if with_rho:
        r = _random(jgeom.n_cell, ("r0", "r1"), seed=5 + ndim)
        rho_j, rho_t = _pair(r, ("r0", "r1"))
    jout = jsol.push(
        JFieldState(**{nm: jnp.asarray(a) for nm, a in data.items()}),
        rho_j, j_old=j_old_j)
    tout = tsol.push({nm: torch.from_numpy(a) for nm, a in data.items()},
                     rho_t, j_old=j_old_t)
    for nm in _FIELDS:
        assert_rel(tout[nm], getattr(jout, nm), (family, nm))
    # J linear in time moves E and B off the J-constant push's
    const = tsol.push({nm: torch.from_numpy(a) for nm, a in data.items()},
                      rho_t)
    assert not np.allclose(const["Ex"].numpy(), tout["Ex"].numpy())
