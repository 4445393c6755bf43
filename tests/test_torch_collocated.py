"""The port's collocated grids, momentum-conserving gathering and hybrid QED
against the JAX package.

The centered curls and divergence-cleaning terms of ``solvers/yee.py``
(algo "nodal"); the staggered-to-nodal averages (``core/step.py::
_nodal_aux`` at orders 2 and 8, the bounded step's two-point one); whole
runs of a 2D plasma on a collocated grid under Yee and PSATD, with and
without momentum-conserving gathering, periodic and bounded, and of
momentum-conserving gathering on the staggered bounded grid; the output
fields of those runs; the hybrid grid type; ``hybrid_qed_push`` and a 2D
hybrid QED deck.  CPU, float64, within 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpx_tpu.core import step as jstep
from warpx_tpu.core.deck import config_from_deck as j_config_from_deck
from warpx_tpu.core.state import FieldState as JFieldState
from warpx_tpu.diagnostics.fields import \
    cell_centered_output as j_cell_centered_output
from warpx_tpu.solvers import hybrid_qed as jqed
from warpx_tpu.solvers import yee as jyee
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core import step as tstep
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.grid import Geometry, yee_staggering
from warpx_tpu_torch.core.state import FieldState
from warpx_tpu_torch.diagnostics.fields import cell_centered_output
from warpx_tpu_torch.solvers import hybrid_qed as tqed
from warpx_tpu_torch.solvers import yee as tyee
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import port_config
from .test_torch_draws_util import (assert_checksums_close, assert_runs_close,
                                    jax_run, port_run)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

_NAMES = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")


def _geoms(ndim):
    n = (8, 12) if ndim == 2 else (6, 8, 10)
    lo = tuple(-1e-6 * (d + 1) for d in range(ndim))
    hi = tuple(2e-6 * (d + 1) for d in range(ndim))
    kw = dict(ndim=ndim, n_cell=n, prob_lo=lo, prob_hi=hi,
              periodic=(True,) * ndim)
    from warpx_tpu.core.grid import Geometry as JGeometry
    return Geometry(**kw), JGeometry(**kw)


def _fields(ndim, seed=1, scale_e=1e10, scale_b=30.0):
    geom, _ = _geoms(ndim)
    rng = np.random.default_rng(seed)
    return {nm: rng.normal(size=geom.n_cell)
            * (scale_b if nm[0] == "B" else scale_e if nm[0] == "E"
               else 1e12) for nm in _NAMES}


def _both(arrs):
    return (FieldState(**{k: torch.from_numpy(v.copy())
                          for k, v in arrs.items()}),
            JFieldState(**{k: jnp.asarray(v) for k, v in arrs.items()}))


def _close(got, ref, tol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("ndim", [2, 3])
def test_nodal_curls_match_jax(ndim):
    geom, jgeom = _geoms(ndim)
    t, j = _both(_fields(ndim))
    for fn_t, fn_j in ((tyee.evolve_b, jyee.evolve_b),
                       (tyee.evolve_e, jyee.evolve_e)):
        got = fn_t(t, geom, 1e-16, "nodal")
        ref = fn_j(j, jgeom, 1e-16, "nodal")
        for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
            _close(getattr(got, nm), getattr(ref, nm))


@pytest.mark.parametrize("ndim", [2, 3])
def test_nodal_cleaning_matches_jax(ndim):
    """EvolveF, EvolveG and the gradient feedback with centered
    differences on a collocated grid."""
    geom, jgeom = _geoms(ndim)
    t, j = _both(_fields(ndim))
    rng = np.random.default_rng(5)
    F, G, rho = (rng.normal(size=geom.n_cell) * s for s in (1e3, 1e3, 1e2))
    dt = 1e-16
    _close(tyee.evolve_f(torch.from_numpy(F), t, torch.from_numpy(rho), geom,
                         dt, "nodal"),
           jyee.evolve_f(jnp.asarray(F), j, jnp.asarray(rho), jgeom, dt,
                         "nodal"))
    _close(tyee.evolve_g(torch.from_numpy(G), t, geom, dt, "nodal"),
           jyee.evolve_g(jnp.asarray(G), j, jgeom, dt, "nodal"))
    for fn_t, fn_j, arr in ((tyee.add_grad_f, jyee.add_grad_f, F),
                            (tyee.add_grad_g, jyee.add_grad_g, G)):
        got = fn_t(t, torch.from_numpy(arr), geom, dt, "nodal")
        ref = fn_j(j, jnp.asarray(arr), jgeom, dt, "nodal")
        for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
            _close(getattr(got, nm), getattr(ref, nm))


@pytest.mark.parametrize("order", [2, 8])
def test_nodal_aux_matches_jax(order):
    """The periodic staggered-to-nodal average, two-point and Fornberg
    order 8 (the hybrid grid's default)."""
    stag = yee_staggering(3)
    arrs = _fields(3)
    farr = {nm: arrs[nm] for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")}
    got = tstep._nodal_aux({k: torch.from_numpy(v) for k, v in farr.items()},
                           stag, (order,) * 3)
    ref = jstep._nodal_aux({k: jnp.asarray(v) for k, v in farr.items()},
                           stag, (order,) * 3)
    for nm in farr:
        _close(got[nm], ref[nm])
    np.testing.assert_allclose(tstep.fornberg_centering_coeffs(order),
                               jstep.fornberg_centering_coeffs(order),
                               rtol=1e-15)


DECK = """
max_step = 5
amr.n_cell = 32 32
geometry.dims = 2
geometry.prob_lo = -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6
warpx.cfl = 0.9
algo.particle_shape = 2
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.2
electrons.uy_th = 0.2
electrons.uz_th = 0.2
"""

COLLOCATED = "warpx.grid_type = collocated\n"
MC = "algo.field_gathering = momentum-conserving\n"
PSATD = "algo.maxwell_solver = psatd\nalgo.current_deposition = direct\n"
PEC = "boundary.field_lo = pec pec\nboundary.field_hi = pec pec\n"
PML_DAMPED = "boundary.field_lo = pml damped\nboundary.field_hi = pml damped\n"

# collocated Yee without momentum-conserving gathering runs in
# "yee-cleaning" (periodic) and "psatd-bounded" covers a bounded collocated
# grid without it
RUNS = {
    "yee-mc": COLLOCATED + MC,
    "yee-cleaning": COLLOCATED + "warpx.do_dive_cleaning = 1\n"
                    "warpx.do_divb_cleaning = 1\n",
    "psatd": COLLOCATED + PSATD,
    "psatd-mc": COLLOCATED + PSATD + MC,
    "yee-bounded-mc": COLLOCATED + PEC + MC,
    "psatd-bounded": COLLOCATED + PSATD + PML_DAMPED,
    "psatd-bounded-mc": COLLOCATED + PSATD + PML_DAMPED + MC,
    "staggered-bounded-mc": PEC.replace("pec pec", "pml pec") + MC,
    "hybrid-grid": "warpx.grid_type = hybrid\n",
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_runs_match_jax(case):
    """The step (curls or spectral push, gather) and the output fields of
    each grid, gathering and face combination."""
    text = DECK + RUNS[case]
    j = jax_run(text)
    p = port_run(text, replay=False)
    assert p.is_bounded == ("bounded" in case)
    assert_runs_close(p, j, 1e-9)
    got, ref = p.checksums(), j.checksums()
    if case == "yee-cleaning":
        # the centered divergence of a centered curl vanishes: G is the
        # roundoff of each package's sum order, far below c |B|
        c_b = 299792458.0 * ref["lev=0"]["Bx"]
        for sums in (got, ref):
            assert sums["lev=0"].pop("G") < 1e-15 * c_b
    assert_checksums_close(got, ref, 1e-9)
    got = cell_centered_output(p.state, p.cfg, p.staggering, psatd=p.psatd)
    ref = j_cell_centered_output(j.state, j.cfg, j.staggering, psatd=j.psatd)
    assert set(got) == set(ref), case
    for nm, a in ref.items():
        if nm in ("divE", "divB") or (nm == "G"
                                       and case == "yee-cleaning"):
            continue  # differences of roundoff
        b = got[nm].numpy()
        assert np.abs(b - a).max() <= 1e-9 * max(np.abs(a).max(), 1e-300), nm


def test_hybrid_grid_config_matches_jax():
    """warpx.grid_type = hybrid: Yee staggering, momentum-conserving
    gathering at centering order 8 by default; an order the deck names."""
    text = DECK + "warpx.grid_type = hybrid\nwarpx.field_centering_nox = 4\n"
    got = config_from_deck(Deck.from_string(text))
    ref = port_config(j_config_from_deck(JDeck.from_string(text)))
    assert got == ref
    assert got.field_gathering == "momentum-conserving"
    assert got.field_centering_no == (4, 8)


@pytest.mark.parametrize("ndim", [2, 3])
def test_hybrid_qed_push_matches_jax(ndim):
    """The 3x3 implicit solve at every node: E fields near the Schwinger
    scale's tail, so that the xi terms move E by far more than roundoff."""
    geom, jgeom = _geoms(ndim)
    arrs = _fields(ndim, seed=4, scale_e=1e16, scale_b=1e8)
    t, j = _both(arrs)
    xi_c2 = 1e-23 * 299792458.0 ** 2
    got = tqed.hybrid_qed_push(t, geom, 1e-17, xi_c2)
    ref = jqed.hybrid_qed_push(j, jgeom, 1e-17, xi_c2)
    moved = np.abs(np.asarray(ref.Ex) - arrs["Ex"]).max()
    assert moved > 1e-6 * np.abs(arrs["Ex"]).max()
    for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
        _close(getattr(got, nm), getattr(ref, nm), 1e-11)


QED_DECK = """
max_step = 20
amr.n_cell = 16 64
geometry.dims = 2
geometry.prob_lo = -4.e-6 -16.e-6
geometry.prob_hi =  4.e-6  16.e-6
warpx.grid_type = collocated
warpx.cfl = 0.7
warpx.use_filter = 0
algo.maxwell_solver = psatd
algo.current_deposition = direct
warpx.use_hybrid_QED = 1
warpx.quantum_xi = 1.e-23
particles.species_names =
warpx.E_ext_grid_init_style = parse_E_ext_grid_function
warpx.Ex_external_grid_function(x,y,z) = 0.
warpx.Ey_external_grid_function(x,y,z) = 1.e5 + 1.e2*exp(-(z/2.e-6)**2)
warpx.Ez_external_grid_function(x,y,z) = 0.
warpx.B_ext_grid_init_style = parse_B_ext_grid_function
warpx.Bx_external_grid_function(x,y,z) = -1.e2/299792458.*exp(-(z/2.e-6)**2)
warpx.By_external_grid_function(x,y,z) = 0.
warpx.Bz_external_grid_function(x,y,z) = 0.
"""


def test_hybrid_qed_deck_matches_jax():
    """A pulse along z on a static Ey under the Heisenberg-Euler
    correction (the reference's maxwell_hybrid_qed deck, cut to 16 x 64)."""
    j = jax_run(QED_DECK)
    p = port_run(QED_DECK, replay=False)
    assert p.cfg.use_hybrid_qed and p.cfg.quantum_xi_c2 == pytest.approx(
        1e-23 * 299792458.0 ** 2, rel=1e-15)
    assert_runs_close(p, j, 1e-9)
