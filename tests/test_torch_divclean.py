"""Hyperbolic divergence cleaning (F/G) off the spectral periodic path, and
the projection div B cleaner, in the port against the JAX package.

The field operators ``evolve_f``, ``evolve_g``, ``add_grad_f`` and
``add_grad_g`` on seeded fields at 1e-12; the 16^3 periodic plasma under
Yee and CKC with both cleanings, per particle, from a B with a non-zero
divergence (B0 sin(2 pi x / Lx) in Bx, as ``tests/test_div_cleaning.py``
seeds it, and the like in Ex) written into both packages' states, at 1e-9 with F and G
included, and the reference's gate G_new - G_old = 2 dt c^2 div B to 10 %;
the bounded 32 x 64 laser-wakefield deck with both cleanings under Yee with
PML faces and under PSATD with PML faces at 1e-9; ``project_div_b`` at
1e-12.  CPU, float64.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu import constants
from warpx_tpu.core.binned_step import (
    bounded_binned_supported as j_bounded_binned_supported)
from warpx_tpu.core.binned_step import binned_supported as j_binned_supported
from warpx_tpu.core.config import SimConfig as JSimConfig
from warpx_tpu.core.config import SpeciesConfig as JSpeciesConfig
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.core.state import FieldState as JFieldState
from warpx_tpu.solvers import yee as jyee
from warpx_tpu.solvers.div_cleaner import project_div_b as j_project_div_b
from warpx_tpu_torch.core.binned_step import (binned_supported,
                                              bounded_binned_supported)
from warpx_tpu_torch.core.grid import Geometry
from warpx_tpu_torch.core.state import FieldState
from warpx_tpu_torch.solvers import yee
from warpx_tpu_torch.solvers.div_cleaner import project_div_b

from .test_torch_bounded_util import (LWFA_2D, assert_checksums,
                                      assert_close, jax_config, port_config,
                                      run_jax, run_port)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

CLEAN = "warpx.do_dive_cleaning = 1\nwarpx.do_divb_cleaning = 1\n"
NAMES = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")


def _geoms(ndim):
    n = (16,) * 3 if ndim == 3 else (32, 16)
    lo, hi = (-5e-6,) * ndim, (5e-6,) * ndim
    return (JGeometry(ndim, n, lo, hi, (True,) * ndim),
            Geometry(ndim=ndim, n_cell=n, prob_lo=lo, prob_hi=hi,
                     periodic=(True,) * ndim))


def _fields(jg, seed):
    """Seeded E, B, J, F, G and rho as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {nm: rng.normal(size=jg.n_cell) * (30.0 if nm[0] == "B" else 1e10)
           for nm in NAMES}
    out["F"] = rng.normal(size=jg.n_cell) * 1e3
    out["G"] = rng.normal(size=jg.n_cell) * 1e11
    out["rho"] = rng.normal(size=jg.n_cell) * 1e-2
    return out


@pytest.mark.parametrize("ndim", [2, 3])
def test_cleaning_operators_match_jax(ndim):
    jg, tg = _geoms(ndim)
    a = _fields(jg, 3 + ndim)
    jf = JFieldState(**{nm: jnp.asarray(a[nm]) for nm in NAMES})
    tf = FieldState(**{nm: torch.from_numpy(a[nm]) for nm in NAMES})
    dt = 1e-15
    F, G, rho = (a[k] for k in ("F", "G", "rho"))
    pairs = [
        (jyee.evolve_f(jnp.asarray(F), jf, jnp.asarray(rho), jg, dt),
         yee.evolve_f(torch.from_numpy(F), tf, torch.from_numpy(rho), tg,
                      dt), "F"),
        (jyee.evolve_g(jnp.asarray(G), jf, jg, dt),
         yee.evolve_g(torch.from_numpy(G), tf, tg, dt), "G"),
    ]
    jE = jyee.add_grad_f(jf, jnp.asarray(F), jg, dt)
    tE = yee.add_grad_f(tf, torch.from_numpy(F), tg, dt)
    jB = jyee.add_grad_g(jf, jnp.asarray(G), jg, dt)
    tB = yee.add_grad_g(tf, torch.from_numpy(G), tg, dt)
    for nm in ("Ex", "Ey", "Ez"):
        pairs.append((getattr(jE, nm), getattr(tE, nm), nm))
    for nm in ("Bx", "By", "Bz"):
        pairs.append((getattr(jB, nm), getattr(tB, nm), nm))
    for ref, got, what in pairs:
        assert_close(got.numpy(), np.asarray(ref), what)
    # the collocated grid's centered differences (since Queue A 11.4)
    assert_close(
        yee.evolve_f(torch.from_numpy(F), tf, torch.from_numpy(rho), tg, dt,
                     algo="nodal").numpy(),
        np.asarray(jyee.evolve_f(jnp.asarray(F), jf, jnp.asarray(rho), jg,
                                 dt, "nodal")), "F nodal")


def _plasma_cfgs(algo, **kw):
    """The 16^3 periodic electron-positron plasma per particle with both
    cleanings, in each package."""
    jg, tg = _geoms(3)
    sp = dict(injection_style="nuniformpercell",
              num_particles_per_cell_each_dim=(1, 1, 1), profile="constant",
              density=2.0e24, momentum_distribution="gaussian",
              ux_th=0.05, uy_th=0.05, uz_th=0.05)
    species = [(nm, q) for nm, q in (("electrons", -constants.q_e),
                                     ("positrons", constants.q_e))]
    dt = jyee.compute_dt_yee(jg, 0.5)
    base = dict(max_step=4, dt=dt, particle_shape=1, em_solver=algo,
                tiled_particles="off", do_dive_cleaning=True,
                do_divb_cleaning=True, use_filter=False, **kw)
    jcfg = JSimConfig(geometry=jg, species=tuple(
        JSpeciesConfig(name=nm, charge=q, mass=constants.m_e, **sp)
        for nm, q in species), **base)
    return jcfg, port_config(jcfg)


def _seed(geom):
    """B0 sin(2 pi x / Lx) in Bx at its nodes along x, and E0 sin(2 pi x /
    Lx) in Ex at its cell centers: both divergent, so G and F grow."""
    lx = geom.prob_hi[0] - geom.prob_lo[0]
    out = {}
    for nm, amp, off in (("Bx", 1e-1, 0.0), ("Ex", 1e9, 0.5)):
        x = (np.arange(geom.n_cell[0]) + off) * geom.dx[0]
        a = amp * np.sin(2 * np.pi * x / lx)
        out[nm] = np.broadcast_to(a[:, None, None], geom.n_cell).copy()
    return out


def _periodic_run(algo):
    jcfg, tcfg = _plasma_cfgs(algo)
    seed = _seed(jcfg.geometry)
    jsim = JSimulation(jcfg)
    jsim.init()
    jsim.state = jsim.state.replace(fields=jsim.state.fields.replace(
        **{nm: jnp.asarray(a) for nm, a in seed.items()}))
    jsim.evolve()
    tsim = warpx_tpu_torch.Simulation(tcfg, dtype=torch.float64,
                                      device="cpu")
    tsim.init()
    tsim.state = tsim.state.replace(fields=tsim.state.fields.replace(
        **{nm: torch.from_numpy(a) for nm, a in seed.items()}))
    G, divb = [], []
    for _ in range(tcfg.max_step):
        G.append(tsim.state.fields.G.clone())
        divb.append(yee.compute_div_b(tsim.state.fields, tcfg.geometry))
        tsim.evolve(1)
    return jsim, tsim, G, divb


@pytest.fixture(scope="module")
def periodic_runs():
    """Both packages over the 16^3 deck from the same divergent fields,
    under Yee and CKC; the port's G and div B kept at every step."""
    return {algo: _periodic_run(algo) for algo in ("yee", "ckc")}


@pytest.mark.parametrize("algo", ["yee", "ckc"])
def test_periodic_cleaning_matches_jax(periodic_runs, algo):
    jsim, tsim, _, _ = periodic_runs[algo]
    assert not tsim.binned and tsim.state.step == 4
    assert float(tsim.state.fields.F.abs().max()) > 0
    for nm in NAMES + ("F", "G"):
        assert_close(getattr(tsim.state.fields, nm).numpy(),
                     np.asarray(getattr(jsim.state.fields, nm)), (algo, nm),
                     tol=1e-9)
    for nm, sp in jsim.state.species.items():
        tsp = tsim.state.species[nm]
        for k in ("x", "y", "z", "ux", "uy", "uz"):
            assert_close(getattr(tsp, k).numpy(), np.asarray(getattr(sp, k)),
                         (algo, nm, k), tol=1e-9)


def test_periodic_divb_cleaning_update_relation(periodic_runs):
    """G_new - G_old == 2 dt c^2 div B to 10 % under Yee, the reference's
    gate (Examples/Tests/divb_cleaning/analysis.py:44-54)."""
    _, tsim, G, divb = periodic_runs["yee"]
    x = (G[3] - G[1]).numpy()
    y = (2 * tsim.cfg.dt * constants.c**2 * divb[2]).numpy()
    assert np.abs(y).max() > 0
    assert np.abs(x - y).max() / np.abs(y).max() < 1e-1


@pytest.mark.parametrize("solver", ["yee", "psatd"])
def test_bounded_cleaning_matches_jax(solver):
    """The 32 x 64 laser-wakefield deck (PML faces, moving window, antenna,
    continuous injection, beam, filter) with both cleanings, per particle:
    checksums, F and G, and the PML's F/G splits at 1e-9."""
    deck = LWFA_2D.replace("max_step = 12", "max_step = 4") + CLEAN
    if solver == "psatd":
        deck += ("algo.maxwell_solver = psatd\n"
                 "algo.current_deposition = esirkepov\n")
    jsim, _ = run_jax(deck, "off")
    tsim = run_port(port_config(jsim.cfg))
    assert not tsim.binned and tsim.state.fields.F is not None
    for nm in ("F", "G"):
        assert_close(getattr(tsim.state.fields, nm).numpy(),
                     np.asarray(getattr(jsim.state.fields, nm)), nm,
                     tol=1e-9)
    splits = [k for k in jsim.state.aux if k.startswith("pml:")
              and k.split(":")[1] in ("F", "G")]
    assert splits and set(splits) <= set(tsim.state.aux)
    if solver == "yee":
        # the gradient terms' own splits in the E and B strips
        assert {"pml:Ex:x", "pml:Ez:z", "pml:Bx:x", "pml:Bz:z"} <= set(
            tsim.state.aux)
    for k in splits:
        assert_close(tsim.state.aux[k].numpy(), np.asarray(jsim.state.aux[k]),
                     k, tol=1e-9)
    assert_checksums(jsim.checksums(), tsim.checksums())


def test_project_div_b_matches_jax():
    """On cells of unequal sizes: where two are equal some modes have a
    zero complex symbol sum_d s_d^2 and stay unprojected in both packages
    (ROADMAP.md Queue C)."""
    for n in ((32, 16), (16, 12, 8)):
        ndim = len(n)
        lo, hi = (-5e-6,) * ndim, (5e-6,) * ndim
        jg = JGeometry(ndim, n, lo, hi, (True,) * ndim)
        tg = Geometry(ndim=ndim, n_cell=n, prob_lo=lo, prob_hi=hi,
                      periodic=(True,) * ndim)
        a = _fields(jg, 11 + ndim)
        jf = JFieldState(**{nm: jnp.asarray(a[nm]) for nm in NAMES})
        tf = FieldState(**{nm: torch.from_numpy(a[nm]) for nm in NAMES})
        ref = j_project_div_b(jf, jg)
        got = project_div_b(tf, tg)
        for nm in ("Bx", "By", "Bz"):
            assert_close(getattr(got, nm).numpy(),
                         np.asarray(getattr(ref, nm)), nm)
        before = np.abs(yee.compute_div_b(tf, tg).numpy()).max()
        after = np.abs(yee.compute_div_b(got, tg).numpy()).max()
        assert after <= 1e-12 * before, (before, after)


def test_divb_cleaning_external():
    """warpx.do_divb_cleaning_external projects the initial B on the
    periodic torus, and is refused on a bounded domain with the JAX
    package's message."""
    jcfg, tcfg = _plasma_cfgs("yee", do_divb_cleaning_external=True)
    tsim = warpx_tpu_torch.Simulation(tcfg, dtype=torch.float64,
                                      device="cpu")
    tsim.init()
    assert float(tsim.state.fields.Bx.abs().max()) == 0.0
    jb = jax_config(LWFA_2D, "off")
    with pytest.raises(NotImplementedError,
                       match="do_divb_cleaning_external on bounded"):
        warpx_tpu_torch.Simulation(
            port_config(jb, do_divb_cleaning_external=True),
            dtype=torch.float64, device="cpu")


def test_binned_gates_refuse_cleaning():
    jcfg, tcfg = _plasma_cfgs("yee")
    for kw in (dict(do_dive_cleaning=True, do_divb_cleaning=False),
               dict(do_dive_cleaning=False, do_divb_cleaning=True)):
        j = dataclasses.replace(jcfg, tiled_particles="on", **kw)
        t = dataclasses.replace(tcfg, tiled_particles="on", **kw)
        assert not j_binned_supported(j) and not binned_supported(t)
        assert not j_bounded_binned_supported(j)
        assert not bounded_binned_supported(t)
