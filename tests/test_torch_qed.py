"""Strong-field QED of the port (``warpx_tpu_torch/ops/qed.py``: quantum
synchrotron, Breit-Wheeler, Schwinger, with photon species) against the JAX
package, CPU, float64.

The host tables are the JAX package's to 1e-12; chi, the rates and the
Schwinger pair number hold at 1e-12; the product-fraction sampling on JAX's
draws holds at 1e-12, and its binary search gives the count form's index
bit for bit; ``qed_update`` and ``schwinger_update`` on JAX's keys give the
same species and attributes; a periodic deck with both processes under the
reference decks' fields lands within 1e-9 of the JAX run over 3 steps; on
its own generator the port's yields sit within 5 sigma of the analytic
rates.  QED on a bounded deck raises, naming ROADMAP.md Queue C.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.integrate as integ
import scipy.special as spe
import torch

import warpx_tpu_torch
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.ops import qed as jqed
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.state import state_from_numpy
from warpx_tpu_torch.ops import qed as tqed
from warpx_tpu_torch.utils.parser import Deck

from .test_binned_bounded import _LWFA_2D
from .test_torch_bounded_util import port_config
from .test_torch_draws_util import (ReplayDraws, assert_checksums_close,
                                    assert_runs_close, assert_species_close,
                                    field_hook, jax_run, jax_species_numpy,
                                    port_run, port_species_numpy, qed_deck,
                                    schwinger_deck)

torch.set_num_threads(1)

ME = 9.1093837015e-31
C = 299792458.0
QE = 1.602176634e-19
HBAR = 6.62607015e-34 / (2 * np.pi)
ALPHA = 7.2973525693e-3
E_F = np.array([-2433321316961438.0, 973328526784575.0, 1459992790176863.0])
B_F = np.array([2857142.85714286, 4285714.28571428, 8571428.57142857])


@pytest.mark.parametrize("which", ["qs", "bw"])
def test_tables_match_jax(which):
    got = getattr(tqed, f"{which}_tables")()
    ref = getattr(jqed, f"{which}_tables")()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-300)


def _e6(rng, n, scale=1.0):
    return ([rng.normal(size=n) * 2e15 * scale for _ in range(3)]
            + [rng.normal(size=n) * 7e6 * scale for _ in range(3)])


def _u(rng, n, scale):
    return [rng.normal(size=n) * scale * C for _ in range(3)]


@pytest.mark.parametrize("fn,uscale", [("particle_chi", 300.0),
                                       ("photon_chi", 3000.0),
                                       ("qs_dndt", 300.0),
                                       ("bw_dndt", 3000.0)])
def test_chi_and_rates_match_jax(fn, uscale):
    rng = np.random.default_rng(2)
    n = 4096
    cols = _u(rng, n, uscale) + _e6(rng, n)
    cols[0][:8] = cols[1][:8] = cols[2][:8] = 0.0  # at rest / no momentum
    ref = np.asarray(getattr(jqed, fn)(*map(jnp.asarray, cols)))
    got = getattr(tqed, fn)(*map(torch.from_numpy, cols)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-300)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("scale", [0.05, 0.2, 1.0])
def test_schwinger_pair_number_matches_jax(scale):
    rng = np.random.default_rng(4)
    n = 2048
    e6 = [rng.normal(size=n) * 1.3e18 * scale for _ in range(3)] + [
        rng.normal(size=n) * 4e9 * scale for _ in range(3)]
    e6[3][:64] = e6[4][:64] = e6[5][:64] = 0.0  # pure E: eta = 0
    ref = np.asarray(jqed.schwinger_pair_number(*map(jnp.asarray, e6),
                                                1e-21, 1e-17))
    got = tqed.schwinger_pair_number(*map(torch.from_numpy, e6), 1e-21,
                                     1e-17).numpy()
    # exp(-pi/eps) reaches the subnormals, which XLA's CPU flushes to 0:
    # hold each value at 1e-12 relative and at 1e-12 of the largest
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def _frac_index_count(cum, row, r):
    """The JAX package's table index of ``_sample_frac``: how many entries
    of the row are below ``r``, clamped to [1, n_frac - 1]."""
    idx = (cum[row] < r[:, None]).to(torch.int64).sum(dim=1)
    return torch.clamp(idx, 1, cum.shape[1] - 1)


@pytest.mark.parametrize("which", ["qs", "bw"])
def test_sample_frac_on_jax_draws(which):
    """The product fraction on JAX's own draws at 1e-12, and the binary
    search's table index equal to the count form's, bit for bit."""
    rng = np.random.default_rng(8)
    n = 8192
    chis_np, _, fracs, cum = getattr(jqed, f"{which}_tables")()
    chi = np.exp(rng.uniform(np.log(chis_np[0]) - 1, np.log(chis_np[-1]) + 1,
                             n))
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jqed._sample_frac(key, jnp.asarray(chi), chis_np,
                                       fracs, cum, jnp.float64))
    r = torch.from_numpy(np.array(jax.random.uniform(key, (n,),
                                                      jnp.float64)))
    got = tqed.sample_frac(r, torch.from_numpy(chi), which, torch.float64)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-300)
    cum_t = torch.from_numpy(cum)
    row = tqed._frac_row(torch.from_numpy(chi), chis_np)
    # draws on the table's own entries and at its ends too
    r2 = torch.cat([r, cum_t[row[:512], rng.integers(0, cum.shape[1], 512)],
                    torch.zeros(8, dtype=torch.float64),
                    torch.ones(8, dtype=torch.float64)])
    row2 = torch.cat([row, row[:512], row[:16]])
    assert torch.equal(tqed.frac_index_search(cum_t, row2, r2),
                       _frac_index_count(cum_t, row2, r2))


def _jax_qed_state(text):
    sim = JSimulation.from_deck(JDeck.from_string(text))
    sim.init()
    return sim


def _port_state(jstate):
    data = {"fields": {nm: np.asarray(getattr(jstate.fields, nm))
                       for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz",
                                  "jx", "jy", "jz")},
            "species": {nm: jax_species_numpy(sp)
                        for nm, sp in jstate.species.items()},
            "step": int(jstate.step), "time": float(jstate.time)}
    return state_from_numpy(data, torch.float64, "cpu")


def test_qed_update_on_jax_keys():
    """One QED event pass on a state whose optical depths are partly spent
    (some at or below zero): every species and attribute equal to the JAX
    package's on its own key, momenta and depths at 1e-12."""
    text = qed_deck(ppc=4)
    sim = _jax_qed_state(text)
    rng = np.random.default_rng(12)
    state = sim.state
    species = dict(state.species)
    for nm, key in (("ele1", "opticalDepthQSR"), ("g1", "opticalDepthBW")):
        sp = species[nm]
        tau = np.asarray(sp.extra[key]) - rng.random(sp.capacity) * 0.6
        species[nm] = sp.replace(extra={**sp.extra, key: jnp.asarray(tau)})
    state = state.replace(species=species)
    fields = {nm: _e6(rng, state.species[nm].capacity)
              for nm in ("ele1", "g1", "bwe")}
    ref = jqed.qed_update(
        state, sim.cfg, lambda nm: tuple(map(jnp.asarray, fields[nm])),
        sim.cfg.dt)
    cfg = port_config(sim.cfg)
    got = tqed.qed_update(
        _port_state(state), cfg,
        lambda nm: tuple(map(torch.from_numpy, fields[nm])),
        ReplayDraws(state.rng))
    for nm, sp in ref.species.items():
        assert_species_close(port_species_numpy(got.species[nm]),
                             jax_species_numpy(sp), 1e-12, nm)
    assert int(np.asarray(ref.species["phot1"].alive).sum()) > 100
    assert int(np.asarray(ref.species["bwe"].alive).sum()) > 100


@pytest.mark.parametrize("threshold,fields", [
    (25.0, (0.0, 0.0, 2.5e20, 0.0, 833910140000.0, 0.0)),
    (3.0, (1.0e18, 0.0, 0.0, 1679288857.0516706, 525665014.1557486,
           1836353079.9561853)),
])
def test_schwinger_update_on_jax_keys(threshold, fields):
    """One Schwinger pass (the Poisson regime of the reference's case 4,
    the Gaussian regime of its case 2) on seeded fields around the case's
    values: the pairs equal the JAX package's on its own key."""
    text = schwinger_deck(threshold)
    sim = _jax_qed_state(text)
    rng = np.random.default_rng(1)
    arrs = {nm: f * (1 + 0.3 * rng.random((8, 8, 8)))
            for nm, f in zip(("Ex", "Ey", "Ez", "Bx", "By", "Bz"), fields)}
    state = sim.state.replace(fields=sim.state.fields.replace(
        **{k: jnp.asarray(v) for k, v in arrs.items()}))
    ref = jqed.schwinger_update(state, sim.cfg, sim.cfg.dt)
    got = tqed.schwinger_update(_port_state(state), port_config(sim.cfg),
                                sim.cfg.dt, ReplayDraws(state.rng))
    for nm in ("es", "ps"):
        assert_species_close(port_species_numpy(got.species[nm]),
                             jax_species_numpy(ref.species[nm]), 1e-12, nm)
    n = int(np.asarray(ref.species["es"].alive).sum())
    # the activation region holds half the cells along z
    assert 0 < n <= 8 * 8 * 4


def test_periodic_qed_deck_matches_jax():
    """``qed_deck`` through both packages on the same numbers, 3 steps:
    fields, every species with its optical depths, and checksums within
    1e-9."""
    text = qed_deck(ppc=2, steps=3)
    ref = jax_run(text)
    got = port_run(text)
    assert not got.binned
    for nm in ("phot1", "bwe", "bwp"):
        assert int(np.asarray(ref.state.species[nm].alive).sum()) > 20, nm
    assert_runs_close(got, ref, 1e-9)
    assert_checksums_close(got.checksums(), ref.checksums())


def test_periodic_schwinger_deck_matches_jax():
    """``schwinger_deck`` in the Poisson regime under the reference's case-4
    field plus a seeded ripple, 2 steps, both packages on the same numbers:
    within 1e-9."""
    rng = np.random.default_rng(6)
    arrs = {"Ez": 2.5e20 * (1 + 0.2 * rng.random((8, 8, 8))),
            "By": 833910140000.0 * np.ones((8, 8, 8))}
    ref = jax_run(schwinger_deck(), hook=field_hook(arrs, True))
    got = port_run(schwinger_deck(), hook=field_hook(arrs, False))
    assert int(np.asarray(ref.state.species["es"].alive).sum()) > 10
    assert_runs_close(got, ref, 1e-9)


def _boris(pp, dt, sign):
    econst = 0.5 * QE * dt * sign / ME
    u = pp / ME + econst * E_F
    inv_gamma = 1 / np.sqrt(1 + np.dot(u, u) / C**2)
    t = econst * B_F * inv_gamma
    s = 2 * t / (1 + np.dot(t, t))
    u = u + np.cross(u + np.cross(u, t), s) + econst * E_F
    return u * ME


def _chi_part(p):
    E_s = ME**2 * C**3 / (QE * HBAR)
    gam = np.sqrt(1.0 + np.dot(p, p) / (ME * C) ** 2)
    v = p / (gam * ME)
    Epv = E_F + np.cross(v, B_F)
    vdE = np.dot(v, E_F) / C
    return gam * np.sqrt(np.dot(Epv, Epv) - vdE * vdE) / E_s


def _chi_phot(p):
    E_s = ME**2 * C**3 / (QE * HBAR)
    pn = np.linalg.norm(p)
    v = C * (p / pn)
    Epv = E_F + np.cross(v, B_F)
    vdE = np.dot(v, E_F) / C
    return (pn / (ME * C)) * np.sqrt(np.dot(Epv, Epv) - vdE * vdE) / E_s


def _qs_G(chi):
    def inner(y):
        return integ.quad(
            lambda x: np.exp(-y * (1 + 4 * x**2 / 3) * np.sqrt(1 + x * x / 3))
            * (9 + 36 * x**2 + 16 * x**4)
            / (3 + 4 * x**2) / np.sqrt(1 + x**2 / 3), 0, np.inf,
        )[0] / np.sqrt(3)

    def S(xi):
        if xi in (0.0, 1.0):
            return 0.0
        Y = (2 / 3) * xi / (chi * (1 - xi))
        return np.sqrt(3) / 2 / np.pi * xi * (
            inner(Y) + xi**2 * spe.kv(2 / 3, Y) / (1 - xi))

    return integ.quad(lambda xi: S(xi) / xi if xi > 0 else 0.0, 0, 1,
                      limit=200)[0]


def _bw_T(chi):
    def bw_inner(x):
        return integ.quad(
            lambda s: np.sqrt(s) * spe.kv(1 / 3, 2 / 3 * s**1.5), x, np.inf
        )[0]

    def F(ce):
        if ce <= 0 or chi <= ce:
            return 0.0
        X = (chi / (ce * (chi - ce))) ** (2 / 3)
        return bw_inner(X) - (2.0 - chi * X**1.5) * spe.kv(
            2 / 3, 2 / 3 * X**1.5)

    return integ.quad(F, 0, chi, limit=200)[0] / (np.pi * np.sqrt(3) * chi**2)


def test_port_yields_match_the_analytic_rates():
    """The port alone, on its own generator: after two steps (the first
    step's push lowers the optical depths, the second step's events emit)
    4096 leptons at u_y = 100 m_e c give photons, and 4096 photons at
    u_z = 1000 m_e c give pairs, within 5 sigma of N0 (1 - exp(-dN/dt dt))
    (tests/test_qed.py's analysis); every pair is an electron and a
    positron."""
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(qed_deck(ppc=4, steps=4)), dtype=torch.float64,
        device="cpu")
    sim.init()
    sim.evolve(2)
    dt = sim.cfg.dt
    n0 = 4096
    pb = _boris(_boris(np.array([0.0, 100.0, 0.0]) * ME * C, -0.5 * dt, -1),
                dt, -1)
    gam = np.sqrt(1.0 + np.dot(pb, pb) / (ME * C) ** 2)
    dndt = (2 / 3) * ALPHA * ME * C**2 / HBAR * _qs_G(_chi_part(pb)) / gam
    p0 = np.array([0.0, 0.0, 1000.0]) * ME * C
    chi = _chi_phot(p0)
    dndt_bw = ALPHA * ME * C**2 / HBAR * _bw_T(chi) * chi / (
        np.linalg.norm(p0) / (ME * C))
    species = sim.state.species
    # the first step's pairs' own emission comes one step later
    nph = int(species["phot1"].alive.sum())
    ne = int(species["bwe"].alive.sum())
    assert ne == int(species["bwp"].alive.sum())
    for got, rate in ((nph, dndt), (ne, dndt_bw)):
        expected = n0 * (1 - np.exp(-rate * dt))
        assert abs(got - expected) < 5 * np.sqrt(expected), (got, expected)
    assert nph > 300 and ne > 100


@pytest.mark.parametrize("extra", [
    "electrons.do_qed_quantum_sync = 1\n"
    "electrons.qed_quantum_sync_phot_product_species = electrons\n",
    "warpx.do_qed_schwinger = 1\n"
    "qed_schwinger.ele_product_species = electrons\n"
    "qed_schwinger.pos_product_species = electrons\n",
])
def test_qed_on_bounded_deck_raises(extra):
    """The JAX package's bounded step runs no QED event, optical-depth
    evolution or Schwinger pair creation: the port refuses them on a
    bounded deck, naming ROADMAP.md Queue C."""
    cfg = config_from_deck(Deck.from_string(_LWFA_2D + extra))
    with pytest.raises(NotImplementedError,
                       match=r"bounded step.*ROADMAP\.md Queue C\)"):
        warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
