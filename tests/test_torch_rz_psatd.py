"""RZ spectral PSATD (``warpx_tpu_torch/rz/spectral.py``) against the JAX
package's ``warpx_tpu/rz/spectral.py`` on the CPU in float64.

The Hankel matrices of every (order, mode) pair against
``HankelTransform``; the forward and backward transforms; one k-space push
of random fields (standard, with update-with-rho, with current correction,
Galilean); the cell-centered direct deposit; then the standard, the
current-correction and the Galilean decks end to end (fields, particles,
checksums with the spectral rho and div E) within 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpx_tpu.core.deck import config_from_deck as jax_config_from_deck
from warpx_tpu.core.state import FieldState as JFieldState
from warpx_tpu.rz import spectral as jspec
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.state import FieldState
from warpx_tpu_torch.rz import spectral as spec
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import port_config
from .test_torch_rz_util import (DECKS, assert_checksums, assert_fields,
                                 assert_species, close, jax_run,
                                 port_fields, port_run, port_species)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

RUNS = ("psatd", "psatd_cc", "psatd_galilean")


def _cfgs(name):
    text = DECKS[name]
    return (jax_config_from_deck(JDeck.from_string(text)),
            config_from_deck(Deck.from_string(text)))


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_hankel_matrices_match_jax(mode):
    """The forward and backward matrices and the kr of orders m - 1, m and
    m + 1 (the singular pairs by the pseudo-inverse), bit for bit."""
    for p in range(max(mode - 1, 0), mode + 2):
        ref = jspec.HankelTransform(p, mode, 12, 3e-5)
        got = spec.HankelTransform(p, mode, 12, 3e-5)
        for a in ("Mf", "Mb", "kr"):
            assert np.array_equal(getattr(got, a), getattr(ref, a)), (p, a)


@pytest.mark.parametrize("name", RUNS)
def test_transforms_match_jax(name):
    """The scalar and vector transforms and their inverses, every mode."""
    jcfg, cfg = _cfgs(name)
    js = jspec.PsatdRZ(jcfg, jnp.float64)
    ps = spec.PsatdRZ(cfg, torch.float64, "cpu")
    rng = np.random.default_rng(1)
    shp = (2 * cfg.n_rz_modes - 1,) + tuple(cfg.geometry.n_cell)
    a, b = rng.normal(size=shp), rng.normal(size=shp)
    close(ps.fwd_scalar(_t(a)), np.asarray(js.fwd_scalar(jnp.asarray(a))),
          "fwd_scalar")
    for g, r in zip(ps.fwd_vector(_t(a), _t(b)),
                    js.fwd_vector(jnp.asarray(a), jnp.asarray(b))):
        close(g, np.asarray(r), "fwd_vector")
    U = rng.normal(size=(cfg.n_rz_modes,) + shp[1:]) + 1j * rng.normal(
        size=(cfg.n_rz_modes,) + shp[1:])
    close(ps.bwd_scalar(_t(U), torch.float64),
          np.asarray(js.bwd_scalar(jnp.asarray(U), jnp.float64)),
          "bwd_scalar")
    for g, r in zip(ps.bwd_vector(_t(U), _t(U * 0.5j), torch.float64),
                    js.bwd_vector(jnp.asarray(U), jnp.asarray(U * 0.5j),
                                  jnp.float64)):
        close(g, np.asarray(r), "bwd_vector")


@pytest.mark.parametrize("name,rho", [("psatd", False), ("psatd_cc", True),
                                      ("psatd_galilean", True)])
def test_push_matches_jax(name, rho):
    """One k-space push of random cell-centered fields (and the sources'
    rho where the family updates with it or corrects the current)."""
    jcfg, cfg = _cfgs(name)
    js = jspec.PsatdRZ(jcfg, jnp.float64)
    ps = spec.PsatdRZ(cfg, torch.float64, "cpu")
    rng = np.random.default_rng(2)
    shp = (2 * cfg.n_rz_modes - 1,) + tuple(cfg.geometry.n_cell)
    scale = {"E": 1e10, "B": 30.0, "j": 1e12}
    arrs = {nm: rng.normal(size=shp) * scale[nm[0]]
            for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")}
    jf = JFieldState(**{k: jnp.asarray(v) for k, v in arrs.items()})
    f = FieldState(**{k: _t(v) for k, v in arrs.items()})
    pair = jpair = None
    if rho:
        r0, r1 = (rng.normal(size=shp) * 1e3 for _ in range(2))
        pair, jpair = (_t(r0), _t(r1)), (jnp.asarray(r0), jnp.asarray(r1))
    ref = js.push(jf, jpair)
    got = ps.push(f, pair)
    for k in arrs:
        close(getattr(got, k), np.asarray(getattr(ref, k)), k)


@pytest.mark.parametrize("name", ["psatd_cc", "psatd_galilean"])
def test_deposit_cc_matches_jax(name):
    """The cell-centered direct rho and (jr, jt, jz) at the mid position,
    every mode, with a drifted z origin."""
    jcfg, cfg = _cfgs(name)
    rng = np.random.default_rng(3)
    n = 300
    rmax = cfg.geometry.prob_hi[0]
    r = rng.uniform(0.0, rmax, n)
    r[:30] = rng.uniform(0.0, cfg.geometry.dx[0], 30)
    th = rng.uniform(-np.pi, np.pi, n)
    pos = (r * np.cos(th), r * np.sin(th),
           rng.uniform(cfg.geometry.prob_lo[1], cfg.geometry.prob_hi[1], n))
    u = rng.normal(size=(3, n)) * 1e8
    w = rng.uniform(0.5, 2.0, n)
    order = cfg.particle_shape
    z0 = cfg.geometry.prob_lo[1] + 0.4 * cfg.geometry.dx[1]
    q = 1.602176634e-19
    ref = jspec.deposit_cc_rz(tuple(map(jnp.asarray, pos)), jnp.asarray(w),
                              q, jcfg, order, order + 2, jnp.float64,
                              z_origin=z0)
    got = spec.deposit_cc_rz(tuple(map(_t, pos)), _t(w), q, cfg, order,
                             order + 2, torch.float64, z_origin=z0)
    close(got, np.asarray(ref), "rho")
    ref = jspec.deposit_cc_rz(tuple(map(jnp.asarray, pos)), jnp.asarray(w),
                              q, jcfg, order, order + 2, jnp.float64,
                              vel=tuple(map(jnp.asarray, u)), dt=jcfg.dt,
                              z_origin=z0)
    got = spec.deposit_cc_rz(tuple(map(_t, pos)), _t(w), q, cfg, order,
                             order + 2, torch.float64, vel=tuple(map(_t, u)),
                             dt=cfg.dt, z_origin=z0)
    for nm, g, r_ in zip(("jr", "jt", "jz"), got, ref):
        close(g, np.asarray(r_), nm)


@pytest.mark.parametrize("name", RUNS)
def test_run_matches_jax(name):
    """The spectral step from the deck: the configuration, the fields, the
    particles and the checksums (with the spectral rho and div E)."""
    jsim, jfields, jspecies, jchecks = jax_run(name)
    sim = port_run(name)
    assert sim.cfg == port_config(jsim.cfg)
    assert isinstance(sim.rz, spec.RZSpectralStepper)
    assert_fields(port_fields(sim), jfields)
    assert_species(port_species(sim), jspecies)
    checks = sim.checksums()
    assert "divE" in checks["lev=0"]
    assert_checksums(checks, jchecks)


def test_aux_fields_match_jax():
    """rho and the spectral div E of the Galilean run's last state."""
    jsim = jax_run("psatd_galilean")[0]
    sim = port_run("psatd_galilean")
    ref = jspec.rz_spectral_aux_fields(jsim.state, jsim.cfg)
    got = spec.rz_spectral_aux_fields(sim.state, sim.cfg, sim.rz.solver)
    for k in ("rho", "divE"):
        close(got[k], np.asarray(ref[k]), k)
