"""Pairwise Coulomb collisions of the port (``warpx_tpu_torch/ops/
collisions.py`` and their hook in ``core/step.py``) against the JAX
package, CPU, float64.

The Perez update, the intra- and inter-species operators on JAX's own
draws agree at 1e-12 of the largest momentum; whole runs of decks with
collisions land within 1e-9 of the JAX runs on the same key chain (3D and
2D, intra and inter, a fixed Coulomb logarithm, ``ndt`` 2, collisions with
field ionization); in float32 the port changes the momenta that float64
changes, where the JAX package's float32 form changes none; equal-weight
intra-species collisions conserve momentum and energy; the deck reader
builds the JAX reader's collisions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpx_tpu import constants as jconst
from warpx_tpu.core.deck import config_from_deck as jconfig_from_deck
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.state import ParticleState as JParticleState
from warpx_tpu.ops import collisions as jcol
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.grid import Geometry
from warpx_tpu_torch.core.state import ParticleState
from warpx_tpu_torch.ops import collisions as tcol
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_draws_util import (ION_2D, _Leaf, assert_checksums_close,
                                    assert_runs_close, assert_species_close,
                                    jax_run, jax_species_numpy, port_run,
                                    port_species_numpy)

torch.set_num_threads(1)

C = 299792458.0
Q_E = jconst.q_e
M_E = jconst.m_e
M_P = 1.67262192369e-27
GEOM = dict(ndim=3, n_cell=(4, 4, 4), prob_lo=(0.0, 0.0, 0.0),
            prob_hi=(4e-6, 4e-6, 4e-6), periodic=(True, True, True))


def _cols(n, seed, u_th, alive=0.9, w_spread=0.0, drift=0.0):
    rng = np.random.default_rng(seed)
    cols = {k: rng.random(n) * 4e-6 for k in ("x", "y", "z")}
    cols.update({k: rng.normal(size=n) * u_th * C for k in ("ux", "uy",
                                                            "uz")})
    cols["uz"] = cols["uz"] + drift * C
    cols["w"] = 1e10 * (1.0 + w_spread * rng.random(n))
    cols["alive"] = rng.random(n) < alive
    return cols


def _both(cols):
    j = JParticleState(**{k: jnp.asarray(v) for k, v in cols.items()})
    t = ParticleState(**{k: torch.from_numpy(v.copy())
                         for k, v in cols.items()})
    return j, t


def _np(t):
    return np.array([np.asarray(x) for x in t])


PEREZ_CASES = {
    # name: (m2/m_e, q2/q_e, u_th1, u_th2, n12, sigma_max, L, dt)
    "ee_thermal": (1.0, -1.0, 3e-3, 3e-3, 1e26, 1e-15, -1.0, 1e-13),
    "ei_thermal": (1836.15, 1.0, 3e-3, 1e-4, 1e26, 1e-15, -1.0, 1e-13),
    "ee_fixed_log": (1.0, -1.0, 1e-2, 1e-2, 1e25, 1e-15, 10.0, 1e-13),
    "ee_all_angles": (1.0, -1.0, 1e-3, 1e-3, 1e28, 1e-12, -1.0, 1e-11),
    "relativistic": (1.0, -1.0, 2.0, 0.5, 1e27, 1e-15, -1.0, 1e-12),
}


@pytest.mark.parametrize("case", sorted(PEREZ_CASES))
def test_perez_update_matches_jax(case):
    """UpdateMomentumPerezElastic in units of c and m1 against the JAX
    package's SI form, on the same draws: 1e-12 of the largest momentum;
    the case changes most momenta."""
    mr, qr, th1, th2, n12, smax, L, dt = PEREZ_CASES[case]
    rng = np.random.default_rng(1)
    n = 512
    u1 = rng.normal(size=(3, n)) * th1 * C
    u2 = rng.normal(size=(3, n)) * th2 * C
    w1 = 1e10 * (1 + rng.random(n))
    w2 = 1e10 * (1 + rng.random(n))
    r = rng.random((5, n))
    ref = jcol._perez_update(
        tuple(u1), tuple(u2), -Q_E, M_E, w1, qr * Q_E, mr * M_E, w2,
        np.full(n, n12), np.full(n, smax), L, np.full(n, 1e-7), dt, *r)
    T = torch.from_numpy
    got = tcol.perez_update(
        tuple(T(x) for x in u1), tuple(T(x) for x in u2), -Q_E, M_E, T(w1),
        qr * Q_E, mr * M_E, T(w2), T(np.full(n, n12)), T(np.full(n, smax)),
        L, T(np.full(n, 1e-7)), dt, *T(r))
    r = np.concatenate([_np(ref[0]), _np(ref[1])])
    g = np.concatenate([_np(got[0]), _np(got[1])])
    assert np.abs(g - r).max() <= 1e-12 * np.abs(r).max()
    assert (r != np.concatenate([u1, u2])).mean() > 0.5


@pytest.mark.parametrize("ndim, log", [(3, -1.0), (2, 5.0)])
def test_intra_species_on_jax_draws(ndim, log):
    """intra_species_coulomb on the same key: 1e-12; an odd count per cell
    leaves particles alone, and the result still matches."""
    cols = _cols(2001, 5, 5e-3, w_spread=1.0)
    geom = dict(GEOM)
    if ndim == 2:
        del cols["y"]
        geom = dict(ndim=2, n_cell=(8, 4), prob_lo=(0.0, 0.0),
                    prob_hi=(4e-6, 4e-6), periodic=(True, True))
    j, t = _both(cols)
    key = jax.random.PRNGKey(9)
    ref, _ = jcol.intra_species_coulomb(j, -Q_E, M_E, JGeometry(**geom),
                                        2e-14, key, coulomb_log=log)
    got = tcol.intra_species_coulomb(t, -Q_E, M_E, Geometry(**geom), 2e-14,
                                     _Leaf(key, "cpu"), coulomb_log=log)
    assert_species_close(port_species_numpy(got), jax_species_numpy(ref),
                         1e-12)
    changed = np.asarray(ref.ux) != cols["ux"]
    assert changed.mean() > 0.3


@pytest.mark.parametrize("n2", [700, 6000])
def test_inter_species_on_jax_draws(n2):
    """inter_species_coulomb with fewer and more ions than electrons per
    cell (several rounds, both passes, partners shared by unmasked slots):
    1e-12."""
    ce = _cols(2000, 6, 5e-3, w_spread=0.5)
    ci = _cols(n2, 7, 2e-4, w_spread=0.5, drift=1e-3)
    je, te = _both(ce)
    ji, ti = _both(ci)
    key = jax.random.PRNGKey(11)
    re_, ri, _ = jcol.inter_species_coulomb(
        je, -Q_E, M_E, ji, Q_E, M_P, JGeometry(**GEOM), 1e-13, key)
    ge, gi = tcol.inter_species_coulomb(
        te, -Q_E, M_E, ti, Q_E, M_P, Geometry(**GEOM), 1e-13,
        _Leaf(key, "cpu"))
    assert_species_close(port_species_numpy(ge), jax_species_numpy(re_),
                         1e-12, "electrons")
    assert_species_close(port_species_numpy(gi), jax_species_numpy(ri),
                         1e-12, "ions")
    assert (np.asarray(re_.ux) != ce["ux"]).mean() > 0.3


def test_scatter_last_is_the_last_writer():
    """Duplicate targets keep the largest writer's value, as a sequential
    loop over the writers does."""
    rng = np.random.default_rng(2)
    base = rng.random(50)
    idx = rng.integers(0, 50, 400)
    vals = rng.random(400)
    ref = base.copy()
    for i, v in zip(idx, vals):
        ref[i] = v
    got = tcol.put_last(torch.from_numpy(base),
                        tcol.last_writers(torch.from_numpy(idx), 50),
                        torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sort_by_cell_is_lexsort():
    rng = np.random.default_rng(3)
    cell = rng.integers(0, 20, 1000)
    r = rng.random(1000)
    got = tcol.sort_by_cell(torch.from_numpy(cell), torch.from_numpy(r))
    np.testing.assert_array_equal(got.numpy(), np.lexsort((r, cell)))


def test_cell_blocks_exact_above_2_pow_24():
    """Each cell's block start stays exact past float32's 2^24 integers:
    the starts that pair inter-species Coulomb, fusion and DSMC partners
    (a float32 prefix sum of these counts rounds 2^24 + 1 to 2^24)."""
    big = 2 ** 24 + 1
    cell = torch.cat([torch.zeros(big, dtype=torch.int64),
                      torch.tensor([1, 2, 3, 4])])
    alive = torch.ones(big + 4, dtype=torch.bool)
    alive[-1] = False
    starts, counts = tcol.cell_blocks(cell, alive, 4)
    np.testing.assert_array_equal(counts.numpy(), [big, 1, 1, 1, 0])
    ref = np.cumsum(counts.numpy().astype(np.float64)) - counts.numpy()
    np.testing.assert_array_equal(starts.numpy(), ref.astype(np.int64))
    f32 = torch.cumsum(counts.to(torch.float32), 0) - counts.to(torch.float32)
    assert int(f32[1]) != big


def test_float32_collides_where_float64_does():
    """Thermal electrons (1e6 m/s, n12 = 1e26, dt = 1e-12): in float32 the
    port changes the momenta float64 changes and lands near them; the JAX
    package's float32 form changes none, because (m u)^2 ~ 1e-48 lies
    under float32's smallest subnormal (ROADMAP.md Queue C)."""
    rng = np.random.default_rng(0)
    n = 4096
    u1 = rng.normal(size=(3, n)) * 1e6
    u2 = rng.normal(size=(3, n)) * 1e6
    w = np.full(n, 1e10)
    r = rng.random((5, n))
    args64 = dict(n12=np.full(n, 1e26), smax=np.full(n, 1e-16),
                  bmax=np.full(n, 1e-7))

    def port(dtype):
        T = lambda a: torch.from_numpy(np.array(a)).to(dtype)  # noqa: E731
        out = tcol.perez_update(
            tuple(T(x) for x in u1), tuple(T(x) for x in u2), -Q_E, M_E,
            T(w), -Q_E, M_E, T(w), T(args64["n12"]), T(args64["smax"]), -1.0,
            T(args64["bmax"]), 1e-12, *[T(x) for x in r])
        return np.concatenate([_np([x.double() for x in out[0]]),
                               _np([x.double() for x in out[1]])])

    u0 = np.concatenate([u1, u2])
    p64, p32 = port(torch.float64), port(torch.float32)
    ch64 = p64 != u0
    ch32 = p32 != u0.astype(np.float32)
    assert ch64.mean() > 0.9
    assert ch32.mean() >= 0.9 * ch64.mean()
    assert np.abs(p32 - p64).max() <= 1e-5 * np.abs(p64).max()
    f = jnp.float32
    ref32 = jcol._perez_update(
        tuple(jnp.asarray(x, f) for x in u1),
        tuple(jnp.asarray(x, f) for x in u2), -Q_E, M_E, jnp.asarray(w, f),
        -Q_E, M_E, jnp.asarray(w, f), jnp.asarray(args64["n12"], f),
        jnp.asarray(args64["smax"], f), -1.0, jnp.asarray(args64["bmax"], f),
        1e-12, *[jnp.asarray(x, f) for x in r])
    j32 = np.concatenate([_np(ref32[0]), _np(ref32[1])])
    assert (j32 != u0.astype(np.float32)).sum() == 0


def test_equal_weights_conserve_momentum_and_energy():
    """Equal weights: every pair takes both updates, so Sum m u and the
    kinetic energy stay at roundoff."""
    cols = _cols(4000, 8, 1e-2, alive=1.0)
    _, t = _both(cols)
    got = tcol.intra_species_coulomb(t, -Q_E, M_E, Geometry(**GEOM), 1e-13,
                                     _Leaf(jax.random.PRNGKey(2), "cpu"))
    u0 = np.array([cols[k] for k in ("ux", "uy", "uz")])
    u1 = np.array([getattr(got, k).numpy() for k in ("ux", "uy", "uz")])
    assert (u1 != u0).mean() > 0.5
    np.testing.assert_allclose(u1.sum(1), u0.sum(1), rtol=0,
                               atol=1e-12 * np.abs(u0).sum())
    ke = lambda u: (np.sqrt(1 + (u ** 2).sum(0) / C ** 2) - 1).sum()  # noqa
    np.testing.assert_allclose(ke(u1), ke(u0), rtol=1e-12)


COULOMB_3D = """
max_step = 3
amr.n_cell = 8 8 8
geometry.dims = 3
geometry.prob_lo = -4.e-6 -4.e-6 -4.e-6
geometry.prob_hi =  4.e-6  4.e-6  4.e-6
warpx.const_dt = 1.e-15
algo.particle_shape = 1
particles.species_names = electrons ions
electrons.species_type = electron
electrons.injection_style = NRandomPerCell
electrons.num_particles_per_cell = 5
electrons.profile = constant
electrons.density = 1.e26
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.01
electrons.uy_th = 0.01
electrons.uz_th = 0.01
ions.species_type = proton
ions.injection_style = NRandomPerCell
ions.num_particles_per_cell = 3
ions.profile = constant
ions.density = 1.e26
ions.momentum_distribution_type = gaussian
ions.ux_th = 0.0005
ions.uy_th = 0.0005
ions.uz_th = 0.0005
ions.uz_m = 0.001
collisions.collision_names = c_ee c_ei c_ii
c_ee.species = electrons electrons
c_ei.species = electrons ions
c_ii.species = ions ions
c_ii.CoulombLog = 15.
c_ii.ndt = 2
"""


def _coulomb_2d():
    """The ionization deck of the stochastic tests with e-e and ion-e
    collisions before the ionization (one key chain through both)."""
    return ION_2D.replace("max_step = 6", "max_step = 3") + """
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.01
electrons.uy_th = 0.01
electrons.uz_th = 0.01
collisions.collision_names = cie cee
cie.species = ions electrons
cee.species = electrons electrons
"""


@pytest.mark.parametrize("deck", ["3d", "2d_with_ionization"])
def test_runs_match_jax(deck):
    """Whole runs through Simulation.from_deck on the JAX package's key
    chain: every species and the fields within 1e-9, the checksums too;
    the collisions changed the momenta."""
    from .test_torch_draws_util import seeded_ex, field_hook

    text = COULOMB_3D if deck == "3d" else _coulomb_2d()
    hook = (None, None)
    if deck != "3d":
        ex = seeded_ex((16, 16))
        hook = (field_hook(ex, True), field_hook(ex, False))
    ref = jax_run(text, hook=hook[0])
    calls = []
    orig = tcol.intra_species_coulomb

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    tcol.intra_species_coulomb = counted
    try:
        got = port_run(text, hook=hook[1])
    finally:
        tcol.intra_species_coulomb = orig
    assert not got.binned and calls  # the collisions ran
    assert_runs_close(got, ref, 1e-9)
    assert_checksums_close(got.checksums(), ref.checksums(), 1e-9)


def test_deck_reader_matches_jax():
    """The deck's collisions as the JAX reader builds them."""
    got = config_from_deck(Deck.from_string(COULOMB_3D)).collisions
    ref = jconfig_from_deck(JDeck.from_string(COULOMB_3D)).collisions
    assert len(got) == 3
    for g, r in zip(got, ref):
        for f in ("name", "species", "kind", "coulomb_log", "ndt"):
            assert getattr(g, f) == getattr(r, f), f


def test_unread_collision_key_is_refused():
    """A collision key that neither reader reads still raises, naming its
    ROADMAP.md item."""
    with pytest.raises(NotImplementedError, match="c_ee.frobnicate"):
        config_from_deck(Deck.from_string(
            COULOMB_3D + "c_ee.frobnicate = 1\n"))


def test_collisions_run_grouped_by_kind():
    """The JAX package runs every Coulomb collision in the deck's order,
    then the other kinds (``core/step.py:296-386``), whatever the order of
    ``collisions.collision_names``: a deck listing D-T fusion before its
    Coulomb collisions, on one key chain, ends bitwise where the deck
    listing fusion last does."""
    fus = """
particles.species_names = electrons ions deut trit alpha neutron
deut.species_type = hydrogen2
deut.injection_style = NRandomPerCell
deut.num_particles_per_cell = 2
deut.profile = constant
deut.density = 1.e26
deut.momentum_distribution_type = gaussian
deut.ux_th = 0.003
deut.uy_th = 0.003
deut.uz_th = 0.003
trit.species_type = hydrogen3
trit.injection_style = NRandomPerCell
trit.num_particles_per_cell = 2
trit.profile = constant
trit.density = 1.e26
trit.momentum_distribution_type = gaussian
trit.ux_th = 0.003
trit.uy_th = 0.003
trit.uz_th = 0.003
alpha.species_type = helium4
alpha.injection_style = none
neutron.species_type = neutron
neutron.injection_style = none
fus.type = nuclearfusion
fus.species = deut trit
fus.product_species = alpha neutron
fus.fusion_multiplier = 1.e22
"""
    base = COULOMB_3D.replace("particles.species_names = electrons ions\n",
                              "")
    first = base.replace("collisions.collision_names = c_ee c_ei c_ii",
                         "collisions.collision_names = fus c_ee c_ei c_ii")
    last = base.replace("collisions.collision_names = c_ee c_ei c_ii",
                        "collisions.collision_names = c_ee c_ei c_ii fus")
    a = port_run(first + fus, steps=1)
    b = port_run(last + fus, steps=1)
    assert int(a.state.species["alpha"].alive.sum()) > 0
    for nm, sp in b.state.species.items():
        for k in ("w", "ux", "uy", "uz", "x", "y", "z", "alive"):
            assert torch.equal(getattr(a.state.species[nm], k),
                               getattr(sp, k)), (nm, k)
