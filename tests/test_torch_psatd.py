"""The port's PSATD solvers (``warpx_tpu_torch/solvers/psatd.py``) against
the JAX package's (``warpx_tpu/solvers/psatd.py``) on the CPU in float64.

The Fornberg coefficients and the modified k agree to 1e-15; one push of
``PsatdSolver`` on the same seeded fields, for every coefficient family the
JAX class builds (standard at finite and infinite order, padded and single
box; update-with-rho; current correction, padded and single box; Galilean;
comoving; time-averaged; F/G cleaning; Vay deposition), in 2D XZ and 3D,
agrees to 1e-12 of each output's largest value; so do the spectral PML
push, with and without its F/G splits, and the spectral divE.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpx_tpu.constants import c
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.grid import yee_staggering
from warpx_tpu.core.state import FieldState as JFieldState
from warpx_tpu.solvers import psatd as jpsatd
from warpx_tpu_torch.core.grid import Geometry
from warpx_tpu_torch.solvers import psatd as tpsatd

torch.set_num_threads(1)

TOL = 1e-12
# per-component scales of the random fields: E [V/m], B [T], J [A/m^2], rho,
# F [V/m] and G [T m/s]
_SCALE = {"E": 1e10, "B": 30.0, "j": 1e12, "r": 1e3, "F": 1e10, "G": 1e9}
_FIELDS = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")


def _geoms(ndim):
    if ndim == 2:
        kw = dict(ndim=2, n_cell=(16, 32), prob_lo=(-2e-6, -4e-6),
                  prob_hi=(2e-6, 4e-6), periodic=(True, True))
    else:
        kw = dict(ndim=3, n_cell=(8, 12, 16), prob_lo=(-2e-6, -3e-6, -4e-6),
                  prob_hi=(2e-6, 3e-6, 4e-6), periodic=(True,) * 3)
    return JGeometry(**kw), Geometry(**kw)


def _dt(geom):
    return 0.5 * min(geom.dx) / c


def _random(shape, names, seed):
    rng = np.random.default_rng(seed)
    return {nm: rng.normal(size=shape) * _SCALE[nm[0]] for nm in names}


def assert_rel(got, ref, what):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    scale = np.abs(ref).max()
    assert err <= TOL * scale, (what, err, scale)


# ---- stencils ----------------------------------------------------------------

@pytest.mark.parametrize("order", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("collocated", [False, True])
def test_fornberg_and_modified_k(order, collocated):
    np.testing.assert_allclose(
        tpsatd.fornberg_coefficients(order, collocated),
        jpsatd.fornberg_coefficients(order, collocated), rtol=1e-15, atol=0)
    dx = 0.1e-6
    for n in (16, 17):
        k = 2.0 * np.pi * np.fft.fftfreq(n, d=dx)
        for o in (order, -1):
            np.testing.assert_allclose(
                tpsatd.modified_k(k, dx, o, collocated),
                jpsatd.modified_k(k, dx, o, collocated),
                rtol=1e-15, atol=1e-15 * np.abs(k).max())


# ---- PsatdSolver --------------------------------------------------------------

# family -> solver keywords and whether push takes a rho pair
FAMILIES = {
    "standard": (dict(), False),
    "order4": (dict(n_order=4), False),
    "single_box": (dict(single_box=True), False),
    "infinite": (dict(n_order=-1), False),
    "update_with_rho": (dict(update_with_rho=True), True),
    "current_correction": (dict(current_correction=True), True),
    "current_correction_single_box": (
        dict(current_correction=True, single_box=True), True),
    "galilean": (dict(v_galilean=(0.0, 0.0, 0.6 * c)), False),
    "galilean_rho": (dict(v_galilean=(0.2 * c, 0.0, 0.6 * c),
                          update_with_rho=True), True),
    "galilean_cc": (dict(v_galilean=(0.0, 0.0, 0.6 * c),
                         update_with_rho=True, current_correction=True),
                    True),
    "comoving": (dict(v_comoving=(0.0, 0.0, -0.7 * c),
                      update_with_rho=True), True),
    "comoving_cc": (dict(v_comoving=(0.0, 0.0, -0.7 * c),
                         update_with_rho=True, current_correction=True,
                         single_box=True), True),
    "time_averaged": (dict(v_galilean=(0.0, 0.0, 0.6 * c),
                           update_with_rho=True, time_averaging=True), True),
    "time_averaged_still": (dict(update_with_rho=True, time_averaging=True),
                            True),
    "fg_cleaning": (dict(update_with_rho=True, dive_cleaning=True,
                         divb_cleaning=True), True),
    "g_cleaning": (dict(divb_cleaning=True), False),
    "vay": (dict(vay_deposition=True), False),
}


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_psatd_push_matches_jax(family, ndim):
    kw, with_rho = FAMILIES[family]
    jgeom, tgeom = _geoms(ndim)
    stag = yee_staggering(ndim)
    dt = _dt(jgeom)
    jsol = jpsatd.PsatdSolver(jgeom, stag, dt, **kw)
    tsol = tpsatd.PsatdSolver(tgeom, stag, dt, dtype=torch.float64,
                              device="cpu", **kw)
    assert tsol.ng == jsol.ng and tsol.n_fft == jsol.n_fft
    names = _FIELDS + tuple(nm for nm in ("F", "G")
                            if kw.get("dive_cleaning" if nm == "F"
                                      else "divb_cleaning"))
    data = _random(jgeom.n_cell, names,
                   seed=10 * list(FAMILIES).index(family) + ndim)
    rho = None
    if with_rho:
        r = _random(jgeom.n_cell, ("r0", "r1"), seed=7 + ndim)
        rho = (r["r0"], r["r1"])
    jf = JFieldState(**{nm: jnp.asarray(a) for nm, a in data.items()})
    jout = jsol.push(jf, None if rho is None
                     else tuple(jnp.asarray(a) for a in rho))
    tout = tsol.push({nm: torch.from_numpy(a) for nm, a in data.items()},
                     None if rho is None
                     else tuple(torch.from_numpy(a) for a in rho))
    checked = 0
    for nm in names + tuple(f"{b}{a}_avg" for b in "EB" for a in "xyz"):
        ref = getattr(jout, nm)
        if ref is None:
            assert nm not in tout, nm
            continue
        assert_rel(tout[nm], ref, (family, nm))
        checked += 1
    assert checked >= 6


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("single_box", [False, True])
def test_spectral_div_e_matches_jax(ndim, single_box):
    jgeom, tgeom = _geoms(ndim)
    stag = yee_staggering(ndim)
    dt = _dt(jgeom)
    jsol = jpsatd.PsatdSolver(jgeom, stag, dt, single_box=single_box)
    tsol = tpsatd.PsatdSolver(tgeom, stag, dt, single_box=single_box,
                              dtype=torch.float64, device="cpu")
    data = _random(jgeom.n_cell, _FIELDS, seed=11)
    ref = jsol.spectral_div_e(
        JFieldState(**{nm: jnp.asarray(a) for nm, a in data.items()}))
    got = tsol.spectral_div_e({nm: torch.from_numpy(data[nm])
                               for nm in ("Ex", "Ey", "Ez")})
    assert_rel(got, ref, "divE")


# ---- PsatdPmlSolver -----------------------------------------------------------

@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("cleaning,v_gal", [
    (False, (0.0, 0.0, 0.0)), (True, (0.0, 0.0, 0.0)),
    (False, (0.0, 0.0, 0.5 * c))])
def test_psatd_pml_push_matches_jax(ndim, cleaning, v_gal):
    jgeom, tgeom = _geoms(ndim)
    stag = yee_staggering(ndim)
    dt = _dt(jgeom)
    kw = dict(dive_cleaning=cleaning, divb_cleaning=cleaning,
              v_galilean=v_gal)
    jsol = jpsatd.PsatdPmlSolver(jgeom, stag, dt, **kw)
    tsol = tpsatd.PsatdPmlSolver(tgeom, stag, dt, dtype=torch.float64,
                                 device="cpu", **kw)
    comps = ["Ex", "Ey", "Ez", "Bx", "By", "Bz"] + (["F", "G"] if cleaning
                                                    else [])
    keys = [(nm, ax) for nm in comps
            for ax in tpsatd.pml_split_dirs(nm, cleaning)]
    assert keys == [(nm, ax) for nm in comps
                    for ax in jpsatd.pml_split_dirs(nm, cleaning)]
    rng = np.random.default_rng(5 + ndim)
    splits = {k: rng.normal(size=jgeom.n_cell) * _SCALE[k[0][0]]
              for k in keys}
    ref = jsol.push({k: jnp.asarray(a) for k, a in splits.items()})
    got = tsol.push({k: torch.from_numpy(a) for k, a in splits.items()})
    assert set(got) == set(ref) == set(keys)
    for k in ref:
        assert_rel(got[k], ref[k], k)


def test_coefficients_move_once_to_the_precision():
    """Coefficients are built in float64 and cast once: a float32 solver
    holds float32/complex64 tensors equal to the float64 ones rounded."""
    _, tgeom = _geoms(2)
    stag = yee_staggering(2)
    dt = _dt(tgeom)
    s64 = tpsatd.PsatdSolver(tgeom, stag, dt, dtype=torch.float64,
                             device="cpu")
    s32 = tpsatd.PsatdSolver(tgeom, stag, dt, dtype=torch.float32,
                             device="cpu")
    for nm in ("_C", "_S_ck", "_X1", "_X2", "_X3"):
        a32, a64 = getattr(s32, nm), getattr(s64, nm)
        assert a32.dtype == torch.float32
        assert torch.equal(a32, a64.float()), nm
    assert s32._shift_fwd[0].dtype == torch.complex64
