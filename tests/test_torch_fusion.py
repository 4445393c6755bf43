"""Nuclear fusion collisions of the port (``warpx_tpu_torch/ops/fusion.py``)
against the JAX package, CPU, float64.

The cross sections agree at 1e-12; the COM parameters are held against
the JAX package's formula evaluated in extended precision (its own float64
form cancels E* - (m1 + m2) c^2 and is off by ~1e-11 there); the product
kinematics and the whole operator (D-T, intra-species D-D, p-B11) on JAX's
own draws agree at 1e-12, with the products in the JAX package's slots;
whole runs within 1e-9; in float32 the port gives the float64 COM energy
and relative velocity where the JAX package's float32 form gives v_rel =
0; the reaction weight the reactants lose equals the products'; the deck
reader finds the JAX reader's fusion kind.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpx_tpu.core.deck import config_from_deck as jconfig_from_deck
from warpx_tpu.core.state import ParticleState as JParticleState
from warpx_tpu.ops import fusion as jfus
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.state import ParticleState
from warpx_tpu_torch.ops import fusion as tfus
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_draws_util import (_Leaf, assert_checksums_close,
                                    assert_runs_close, jax_run, port_run)

torch.set_num_threads(1)

C = 299792458.0
Q_E = 1.602176634e-19
MU = 1.66053906660e-27
M_D = 2.01410177812 * MU
M_T = 3.0160492779 * MU
M_P1 = 1.00782503223 * MU
M_B11 = 11.00930536 * MU
M_HE3 = 3.0160293201 * MU
M_HE4 = 4.00260325413 * MU
M_N = 1.0013784193052508 * 1.67262192369e-27
T = torch.from_numpy


def _close(got, ref, tol, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol * scale, (what,
                                                   np.abs(got - ref).max(),
                                                   scale)


@pytest.mark.parametrize("kind", ["dt", "ddp", "ddn", "dhe", "protonboron"])
def test_cross_sections_match_jax(kind):
    """sigma(E) from 1 keV to 20 MeV (the p-B11 resonance and the Buck
    power law included) at 1e-12; zero at zero energy, positive at low
    energy (the D-D fits turn negative past their range, in both)."""
    e_keV = np.concatenate([[0.0], np.geomspace(1.0, 2e4, 400), [148.0]])
    if kind == "protonboron":
        ref = jfus.proton_boron_cross_section(jnp.asarray(e_keV * 1e3 * Q_E))
        got = tfus.proton_boron_cross_section(T(e_keV))
    else:
        m2 = {"dt": M_T, "dhe": M_HE3}.get(kind, M_D)
        ref = jfus.bosch_hale_cross_section(jnp.asarray(e_keV * 1e3 * Q_E),
                                            kind, M_D, m2)
        got = tfus.bosch_hale_cross_section(T(e_keV), kind, M_D, m2)
    _close(got.numpy(), ref, 1e-12, kind)
    assert float(got[0]) == 0.0 and float(got[1:40].min()) > 0.0


def _pairs(n, seed, s1, s2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(3, n)) * s1, rng.normal(size=(3, n)) * s2


def _collision_parameters_decimal(u1, u2, m1, m2):
    """The JAX package's collision_parameters in 50-digit decimal
    arithmetic: its cancellation of E* - (m1 + m2) c^2 (up to ~10 digits
    for 1 eV ions) leaves 40 digits."""
    from decimal import Decimal, getcontext

    getcontext().prec = 50
    D = lambda x: Decimal(float(x))  # noqa: E731
    c2 = D(C) * D(C)
    out = []
    for k in range(u1.shape[1]):
        a = [D(x) for x in u1[:, k]]
        b = [D(x) for x in u2[:, k]]
        M1, M2 = D(m1), D(m2)
        g1 = (1 + sum(x * x for x in a) / c2).sqrt()
        g2 = (1 + sum(x * x for x in b) / c2).sqrt()
        p_sq = sum((M1 * x + M2 * y) ** 2 for x, y in zip(a, b))
        E_lab = (M1 * g1 + M2 * g2) * c2
        E_star = (E_lab * E_lab - c2 * p_sq).sqrt()
        E_kin = E_star - (M1 + M2) * c2
        er = E_star / ((M1 + M2) * c2)
        ps = M1 * M2 * c2 * (er ** 2 - 1) + (M1 - M2) ** 2 * c2 / 4 * (
            er - 1 / er) ** 2
        g1s = (1 + ps / (M1 * M1 * c2)).sqrt()
        g2s = (1 + ps / (M2 * M2 * c2)).sqrt()
        v_rel = ps.sqrt() * (1 / (M1 * g1s) + 1 / (M2 * g2s))
        out.append((float(E_kin / D(Q_E) / 1000), float(v_rel),
                    float(g1s * g2s / (g1 * g2))))
    return np.array(out).T


@pytest.mark.parametrize("speeds", [(2e6, 2e6), (3e4, 1e4), (3e7, 1e7)])
def test_collision_parameters_exact(speeds):
    """E_kin [keV], v_rel, lab-to-COM factor against the JAX formula in
    50-digit arithmetic: 1e-13; the JAX package's own float64 run of it is
    further off than the port."""
    u1, u2 = _pairs(48, 4, *speeds)
    ref = _collision_parameters_decimal(u1, u2, M_D, M_T)
    got = tfus.collision_parameters(tuple(T(x) for x in u1),
                                    tuple(T(x) for x in u2), M_D, M_T)
    for g, r, nm in zip(got, ref, ("E_kin", "v_rel", "lab_to_com")):
        _close(g.numpy(), r, 1e-13, nm)
    jax64 = jfus.collision_parameters(tuple(u1), tuple(u2), M_D, M_T)
    err_jax = np.abs(np.asarray(jax64[0]) / 1e3 / Q_E - ref[0]).max()
    err_port = np.abs(got[0].numpy() - ref[0]).max()
    assert err_port <= err_jax


def test_float32_fuses_where_float64_does():
    """6 D-T pairs at 2e6 m/s: the JAX package's float32 form gives v_rel =
    0 for every pair (so nothing fuses) and an E_kin off by up to an order
    of magnitude; the port's float32 lands within 1e-5 of float64."""
    u1, u2 = _pairs(6, 0, 2e6, 2e6)
    f = jnp.float32
    jk, jv, _ = jfus.collision_parameters(
        tuple(jnp.asarray(x, f) for x in u1),
        tuple(jnp.asarray(x, f) for x in u2), M_D, M_T)
    assert np.all(np.asarray(jv) == 0.0)
    g64 = tfus.collision_parameters(tuple(T(x) for x in u1),
                                    tuple(T(x) for x in u2), M_D, M_T)
    g32 = tfus.collision_parameters(tuple(T(x).float() for x in u1),
                                    tuple(T(x).float() for x in u2), M_D, M_T)
    for a, b in zip(g32, g64):
        assert float(b.abs().min()) > 0
        _close(a.double().numpy(), b.numpy(), 1e-5)
    ref_keV = g64[0].numpy()
    jax_keV = np.asarray(jk, np.float64) / 1e3 / Q_E
    assert np.abs(jax_keV / ref_keV - 1).max() > 0.5


@pytest.mark.parametrize("kind", ["dt", "ddn", "ddp"])
def test_two_product_momenta_match_jax(kind):
    """Two-body kinematics on the same key: 1e-12; momentum conserved."""
    m1, m2, o1, o2 = {"dt": (M_D, M_T, M_HE4, M_N),
                      "ddn": (M_D, M_D, M_HE3, M_N),
                      "ddp": (M_D, M_D, M_T, M_P1)}[kind]
    u1, u2 = _pairs(300, 5, 0.02 * C, 0.01 * C)
    key = jax.random.PRNGKey(3)
    e_fus = tfus._E_FUSION[kind]
    ref = jfus.two_product_momenta(key, tuple(u1), m1, tuple(u2), m2, o1, o2,
                                   e_fus)
    got = tfus.two_product_momenta(_Leaf(key, "cpu"), tuple(T(x) for x in u1),
                                   m1, tuple(T(x) for x in u2), m2, o1, o2,
                                   e_fus)
    for g, r in zip(got, ref):
        _close(np.array([x.numpy() for x in g]),
               np.array([np.asarray(x) for x in r]), 1e-12, kind)
    p_in = m1 * u1 + m2 * u2
    p_out = o1 * np.array([x.numpy() for x in got[0]]) \
        + o2 * np.array([x.numpy() for x in got[1]])
    _close(p_out, p_in, 1e-12)


def test_proton_boron_momenta_match_jax():
    u1, u2 = _pairs(300, 6, 0.03 * C, 0.001 * C)
    key = jax.random.PRNGKey(8)
    ref = jfus.proton_boron_momenta(key, tuple(u1), M_P1, tuple(u2), M_B11)
    got = tfus.proton_boron_momenta(_Leaf(key, "cpu"),
                                    tuple(T(x) for x in u1), M_P1,
                                    tuple(T(x) for x in u2), M_B11)
    for g, r in zip(got, ref):
        _close(np.array([x.numpy() for x in g]),
               np.array([np.asarray(x) for x in r]), 1e-12)
    p_out = sum(np.array([x.numpy() for x in g]) for g in got) * \
        tfus.M_ALPHA
    _close(p_out, M_P1 * u1 + M_B11 * u2, 1e-11)


def _fusion_deck(kind, steps=2, n=8, ppc=64, mult=1e28, target=0.002):
    """A frozen box (no field solve, no push) of fusing reactants."""
    sp = {
        "dt": ("deut trit", "hydrogen2", "hydrogen3", "alpha neutron",
               "helium4", "neutron"),
        "dd": ("deut deut", "hydrogen2", None, "he3 neutron", "helium3",
               "neutron"),
        "pb": ("prot boron", "hydrogen1", "boron11", "alpha", "helium4",
               None),
    }[kind]
    reac = sp[0].split()
    prods = sp[3].split()
    names = list(dict.fromkeys(reac)) + prods
    lines = [f"""
max_step = {steps}
amr.n_cell = {n} {n} {n}
geometry.dims = 3
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 1.e-5 1.e-5 1.e-5
warpx.const_dt = 1.e-12
algo.maxwell_solver = none
warpx.use_filter = 0
particles.species_names = {" ".join(names)}
collisions.collision_names = fus
fus.type = nuclearfusion
fus.species = {sp[0]}
fus.product_species = {sp[3]}
fus.fusion_multiplier = {mult}
fus.fusion_probability_target_value = {target}
"""]
    types = [sp[1], sp[2] if sp[2] else sp[1]]
    for i, nm in enumerate(dict.fromkeys(reac)):
        lines.append(f"""
{nm}.species_type = {types[i]}
{nm}.injection_style = NRandomPerCell
{nm}.num_particles_per_cell = {ppc if i == 0 else ppc // 2}
{nm}.profile = constant
{nm}.density = {1e26 if i == 0 else 2e26}
{nm}.momentum_distribution_type = gaussian
{nm}.ux_th = 0.01
{nm}.uy_th = 0.01
{nm}.uz_th = 0.01
{nm}.do_not_push = 1
{nm}.do_not_deposit = 1
""")
    for nm, st in zip(prods, sp[4:]):
        lines.append(f"""
{nm}.species_type = {st}
{nm}.injection_style = none
{nm}.do_not_push = 1
{nm}.do_not_deposit = 1
""")
    return "".join(lines)


@pytest.mark.parametrize("kind", ["dt", "dd", "pb"])
def test_fusion_runs_match_jax(kind):
    """Two steps of the frozen box through both packages on one key chain:
    alive masks equal, weights, momenta and positions within 1e-9 (the
    products in the JAX package's slots, the pair order); products made
    and the reaction weight lost equals the products' weight."""
    text = _fusion_deck(kind)
    ref = jax_run(text)
    got = port_run(text)
    assert_runs_close(got, ref, 1e-9, fields=False)
    assert_checksums_close(got.checksums(), ref.checksums(), 1e-9)
    cfg = got.cfg
    col = cfg.collisions[0]
    prods = [got.state.species[nm] for nm in col.product_species]
    n_made = [int(p.alive.sum()) for p in prods]
    assert min(n_made) > 10, n_made
    init = port_run(text, steps=0)
    lost = sum(float((init.state.species[nm].w - got.state.species[nm].w)
                     .sum()) for nm in set(col.species))
    made = sum(float(p.w[p.alive].sum()) for p in prods)
    # per reaction of weight w_r: each reactant loses w_r, each product
    # appears at both parents with w_r / 2 (D-T: lost 2 w_r, made 2 w_r;
    # p-B11: 3 alphas, made 3 w_r); intra-species the JAX package (and so
    # the port) takes w_r from the partner only (ROADMAP.md Queue C), so
    # D-D loses w_r and makes 2 w_r
    ratio = {"dt": 1.0, "pb": 2.0 / 3.0, "dd": 0.5}[kind]
    np.testing.assert_allclose(lost, made * ratio, rtol=1e-9)


@pytest.mark.parametrize("kinds", [("hydrogen2", "hydrogen3", "dt"),
                                   ("deuterium", "deuterium", "ddn"),
                                   ("hydrogen2", "helium3", "dhe"),
                                   ("hydrogen1", "boron11", "protonboron")])
def test_deck_fusion_kind_matches_jax(kinds):
    """The fusion kind from the reactants' species types, and the
    multiplier keys, as the JAX reader sets them."""
    t1, t2, kind = kinds
    text = _fusion_deck("dt").replace("hydrogen2", t1).replace(
        "hydrogen3", t2)
    got = config_from_deck(Deck.from_string(text)).collisions[0]
    ref = jconfig_from_deck(JDeck.from_string(text)).collisions[0]
    assert got.fusion_kind == ref.fusion_kind == kind
    for f in ("species", "product_species", "fusion_multiplier",
              "fusion_probability_threshold",
              "fusion_probability_target_value", "ndt"):
        assert getattr(got, f) == getattr(ref, f), f


@pytest.mark.parametrize("threshold", [1e300, 0.02])
def test_products_land_in_jax_slots(threshold):
    """The operator alone on a seeded D-T state with the JAX package's key:
    reactant weights and alive masks, product slots, weights and momenta
    at 1e-12.  Below the probability threshold (1e300: never crossed) the
    reaction weight is w_min / multiplier; above it (0.02) it scales as
    1 / sigma(E_kin), and the JAX package's float64 E_kin, which cancels
    ~5 digits (``test_collision_parameters_exact``), is ~1e-11 off: the
    weights there are held at 1e-10, the masks and momenta at 1e-12."""
    import dataclasses

    from warpx_tpu.core.state import SimState as JSimState
    from warpx_tpu_torch.core.state import SimState

    rng = np.random.default_rng(2)
    n = 3000

    def cols(th):
        c = {k: rng.random(n) * 1e-5 for k in ("x", "y", "z")}
        c.update({k: rng.normal(size=n) * th * C for k in ("ux", "uy",
                                                           "uz")})
        c["w"] = 1e8 * (1 + rng.random(n))
        c["alive"] = rng.random(n) < 0.95
        return c

    reac = {"deut": cols(0.01), "trit": cols(0.008)}
    empty = {k: np.zeros(4096) for k in ("w", "ux", "uy", "uz", "x", "y",
                                          "z")}
    empty["alive"] = np.zeros(4096, bool)
    species = dict(reac, alpha=empty, neutron=empty)
    text = _fusion_deck("dt", n=4)
    jcfg = jconfig_from_deck(JDeck.from_string(text))
    tcfg = config_from_deck(Deck.from_string(text))
    jstate = JSimState(fields=None, species={
        k: JParticleState(**{a: jnp.asarray(b) for a, b in v.items()})
        for k, v in species.items()}, step=0, time=0.0, rng=None)
    tstate = SimState(fields=None, species={
        k: ParticleState(**{a: T(b.copy()) for a, b in v.items()})
        for k, v in species.items()}, step=0, time=0.0)
    key = jax.random.PRNGKey(21)
    kw = dict(fusion_multiplier=1e32, fusion_probability_threshold=threshold)
    ref = jfus.fusion_collision_update(
        jstate, jcfg, dataclasses.replace(jcfg.collisions[0], **kw), 1e-12,
        key)
    got = tfus.fusion_collision_update(
        tstate, tcfg, dataclasses.replace(tcfg.collisions[0], **kw), 1e-12,
        _Leaf(key, "cpu"))
    for nm in species:
        r, g = ref.species[nm], got.species[nm]
        np.testing.assert_array_equal(g.alive.numpy(), np.asarray(r.alive))
        for a in ("w", "ux", "uy", "uz", "x", "y", "z"):
            tol = 1e-10 if a == "w" and threshold < 1.0 else 1e-12
            _close(getattr(g, a).numpy(), np.asarray(getattr(r, a)), tol,
                   (nm, a))
    assert int(got.species["alpha"].alive.sum()) > 10
