"""ADK field ionization of the port (``warpx_tpu_torch/ops/ionization.py``
and its hooks in the periodic and bounded steps) against the JAX package,
CPU, float64.

The deterministic parts (the rate coefficients, the probability) hold at
1e-12; ``apply_ionization`` on JAX's own draws gives the same levels,
product slots and attributes bit for bit; whole runs on JAX's key chain
(``test_torch_draws_util.ReplayDraws``) land within 1e-9: a 16 x 16
periodic deck under a seeded Ex and the 32 x 64 laser-wakefield deck with a
nitrogen dopant.  The ion deposits its deck charge whatever its level, in
both packages.  A restart of an ionizing deck continues bit for bit:
attributes and generator.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.state import ParticleState as JParticleState
from warpx_tpu.ops import ionization as jion
from warpx_tpu_torch.core.state import ParticleState, state_to_numpy
from warpx_tpu_torch.io.checkpoint import load_checkpoint
from warpx_tpu_torch.ops import ionization as tion
from warpx_tpu_torch.utils.parser import Deck

from .test_binned_bounded import _LWFA_2D
from .test_torch_draws_util import (ION_2D, ReplayDraws,
                                    assert_checksums_close, assert_runs_close,
                                    assert_species_close, field_hook,
                                    jax_run, jax_species_numpy,
                                    lwfa_nitrogen_deck, port_run,
                                    port_species_numpy, seeded_ex)

torch.set_num_threads(1)


@pytest.mark.parametrize("element,dt", [("H", 1e-16), ("N", 1e-16),
                                        ("Ar", 1e-16), ("N", 3.1e-15)])
def test_adk_coefficients_match_jax(element, dt):
    got = tion.adk_coefficients(element, dt)
    ref = jion.adk_coefficients(element, dt)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=0)
    assert tion.IONIZATION_ENERGIES == jion.IONIZATION_ENERGIES


def _fields(rng, n, scale=4e12):
    e6 = [rng.normal(size=n) * scale for _ in range(3)]
    e6 += [rng.normal(size=n) * scale / 3e8 for _ in range(3)]
    return e6


@pytest.mark.parametrize("element", ["N", "Ar"])
def test_ionization_probability_matches_jax(element):
    """The exp(log) form against the JAX package's product form at 1e-12,
    over every level (and past the last), moving ions, fields 0 to ~1e13."""
    rng = np.random.default_rng(7)
    n = 4096
    z = len(jion.IONIZATION_ENERGIES[element])
    lev = rng.integers(0, z + 1, n).astype(np.int32)
    u = [rng.normal(size=n) * 3e7 for _ in range(3)]
    e6 = _fields(rng, n)
    e6[0][:16] = 0.0  # no field at all on some
    for a in e6[1:]:
        a[:16] = 0.0
    coeffs = jion.adk_coefficients(element, 1e-16)
    ref = np.asarray(jion.ionization_probability(
        jnp.asarray(lev), *map(jnp.asarray, u + e6), *coeffs, z))
    t = [torch.from_numpy(a) for a in u + e6]
    got = tion.ionization_probability(
        torch.from_numpy(lev), *t, tion.adk_coefficients(element, 1e-16),
        z).numpy()
    # 1 - exp(-w) cancels for tiny w: hold the probability at 1e-12 of
    # its largest value, as the other comparisons are held
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    assert 0.05 < (ref > 0.5).mean() < 0.95
    assert (got[:16] == 0.0).all() and (got[lev >= z] == 0.0).all()


def test_float32_probability_stays_finite():
    """Ar at dt = 1e-16 has a level-4 prefactor of ~3e44, past float32's
    largest number: the port's float32 probability stays finite and within
    1e-4 of its float64 value."""
    pre = tion.adk_coefficients("Ar", 1e-16)[0]
    assert pre.max() > float(np.finfo(np.float32).max)
    rng = np.random.default_rng(3)
    n = 2048
    lev = torch.from_numpy(rng.integers(0, 18, n).astype(np.int32))
    cols = [rng.normal(size=n) * 3e7 for _ in range(3)] + _fields(rng, n)
    coeffs = tion.adk_coefficients("Ar", 1e-16)
    p64 = tion.ionization_probability(
        lev, *[torch.from_numpy(a) for a in cols], coeffs, 18)
    p32 = tion.ionization_probability(
        lev, *[torch.from_numpy(a).float() for a in cols], coeffs, 18)
    assert bool(torch.isfinite(p32).all())
    assert float((p32.double() - p64).abs().max()) < 1e-4


def _species_pair(rng, n_ion, n_prod, n_prod_alive, z_max, with_extra):
    """An ion species and a product species (numpy), the product with
    ``n_prod_alive`` scattered live slots."""
    def cols(n):
        return {k: rng.normal(size=n) for k in ("x", "z", "ux", "uy", "uz")}
    ion = cols(n_ion)
    ion["w"] = rng.random(n_ion) + 0.5
    ion["alive"] = rng.random(n_ion) < 0.9
    ion["lev"] = rng.integers(0, z_max + 1, n_ion).astype(np.int32)
    prod = cols(n_prod)
    prod["w"] = rng.random(n_prod)
    alive = np.zeros(n_prod, bool)
    alive[rng.choice(n_prod, n_prod_alive, replace=False)] = True
    prod["alive"] = alive
    prod["lev"] = rng.integers(0, 3, n_prod).astype(np.int32)
    return ion, prod


def _jax_ps(c, key_extra):
    return JParticleState(
        w=jnp.asarray(c["w"]), ux=jnp.asarray(c["ux"] * 1e7),
        uy=jnp.asarray(c["uy"] * 1e7), uz=jnp.asarray(c["uz"] * 1e7),
        alive=jnp.asarray(c["alive"]), x=jnp.asarray(c["x"]),
        z=jnp.asarray(c["z"]),
        extra=({"ionizationLevel": jnp.asarray(c["lev"])} if key_extra
               else {}))


def _port_ps(c, key_extra):
    t = torch.from_numpy
    return ParticleState(
        w=t(c["w"]), ux=t(c["ux"] * 1e7), uy=t(c["uy"] * 1e7),
        uz=t(c["uz"] * 1e7), alive=t(c["alive"]), x=t(c["x"]), z=t(c["z"]),
        extra=({"ionizationLevel": t(c["lev"])} if key_extra else {}))


@pytest.mark.parametrize("n_prod,n_alive,prod_extra", [
    (3000, 1200, False),   # room for every event
    (600, 550, True),      # too few free slots: the excess is dropped
])
def test_apply_ionization_on_jax_draws(n_prod, n_alive, prod_extra):
    """One substep on JAX's own key: levels, product slots, positions,
    momenta, weights and the products' attributes bit for bit."""
    rng = np.random.default_rng(11)
    ion, prod = _species_pair(rng, 1000, n_prod, n_alive, 7, prod_extra)
    e6 = _fields(rng, 1000)
    coeffs = jion.adk_coefficients("N", 1e-16)
    key = jax.random.PRNGKey(5)
    j_ion, j_prod, _ = jion.apply_ionization(
        key, _jax_ps(ion, True), _jax_ps(prod, prod_extra),
        tuple(map(jnp.asarray, e6)), coeffs, 7)
    t_ion, t_prod = tion.apply_ionization(
        ReplayDraws(key), _port_ps(ion, True), _port_ps(prod, prod_extra),
        tuple(map(torch.from_numpy, e6)), tion.adk_coefficients("N", 1e-16),
        7, 2)
    assert_species_close(port_species_numpy(t_ion), jax_species_numpy(j_ion),
                         0.0, "ions")
    assert_species_close(port_species_numpy(t_prod),
                         jax_species_numpy(j_prod), 0.0, "products")
    events = int((np.asarray(j_ion.extra["ionizationLevel"])
                  - ion["lev"]).sum())
    placed = int(np.asarray(j_prod.alive).sum()) - n_alive
    assert events > 100
    assert (placed == events) == (n_prod - n_alive >= events)


def test_periodic_ionization_matches_jax():
    """ION_2D under a seeded Ex through both packages on the same numbers,
    6 steps: fields, species, levels and checksums within 1e-9."""
    ex = seeded_ex((16, 16))
    ref = jax_run(ION_2D, hook=field_hook(ex, True))
    got = port_run(ION_2D, hook=field_hook(ex, False))
    assert not got.binned
    lev = np.asarray(ref.state.species["ions"].extra["ionizationLevel"])
    assert lev.max() > 3 and int(np.asarray(
        ref.state.species["eprod"].alive).sum()) > 500
    assert_runs_close(got, ref, 1e-9)
    assert_checksums_close(got.checksums(), ref.checksums())


def test_bounded_lwfa_ionization_matches_jax():
    """The 32 x 64 laser-wakefield deck with a nitrogen dopant at level 2
    around the antenna, per particle, 8 steps: fields, species, levels and
    checksums within 1e-9 of the JAX package's run."""
    deck = lwfa_nitrogen_deck(_LWFA_2D)
    ref = jax_run(deck)
    got = port_run(deck)
    assert got.is_bounded and got.stepper.spec is None
    assert int(np.asarray(ref.state.species["electrons_n"].alive).sum()) > 500
    assert_runs_close(got, ref, 1e-9)
    assert_checksums_close(got.checksums(), ref.checksums())


def test_ion_current_ignores_its_level():
    """Both packages deposit an ionizable species with its deck charge at
    any level (WarpX would deposit q_e times the level; ROADMAP.md Queue C):
    one step of ION_2D without a field gives the same J whatever level the
    ions start at."""
    from warpx_tpu.core.simulation import Simulation as JSimulation
    from warpx_tpu.utils.parser import Deck as JDeck

    js = {}
    for level in (2, 5):
        text = ION_2D.replace("ionization_initial_level = 2",
                              f"ionization_initial_level = {level}").replace(
            "electrons.density = 1.e24", "electrons.density = 1.e2").replace(
            "max_step = 6", "max_step = 1").replace(
            "ions.density = 1.e22", "ions.density = 1.e22\n"
            "ions.momentum_distribution_type = constant\nions.uz = 0.001")
        j = JSimulation.from_deck(JDeck.from_string(text))
        j.init()
        j.evolve()
        p = port_run(text)
        assert int(np.asarray(j.state.species["ions"].extra[
            "ionizationLevel"]).min()) == level
        js[level] = (np.asarray(j.state.fields.jz),
                     p.state.fields.jz.numpy())
    np.testing.assert_array_equal(js[2][0], js[5][0])
    np.testing.assert_array_equal(js[2][1], js[5][1])
    assert np.abs(js[2][0]).max() > 0.0


def test_ionizing_restart_is_bitwise(tmp_path):
    """ION_2D with a checkpoint at step 3 on the port's own generator: a
    run restarted from it ends where the uninterrupted run ends, bit for
    bit, the levels and the generator included."""
    text = ION_2D + ("diagnostics.diags_names = chk\nchk.format = checkpoint"
                     "\nchk.intervals = 3:3\n")
    ex = seeded_ex((16, 16))

    def run(out, restart=None):
        sim = warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(text), dtype=torch.float64, device="cpu",
            output_dir=str(out))
        sim.init()
        field_hook(ex, False)(sim)
        if restart is not None:
            sim.state, sim.is_synchronized = load_checkpoint(
                restart, sim.state, sim.draws)
        sim.evolve()
        return state_to_numpy(sim.state)

    ref = run(tmp_path / "a")
    got = run(tmp_path / "b", str(tmp_path / "a" / "chk000003"))
    for nm, a in ref["fields"].items():
        np.testing.assert_array_equal(got["fields"][nm], a, err_msg=nm)
    for name, sp in ref["species"].items():
        for k, a in sp.items():
            if k == "extra":
                for ak, av in a.items():
                    np.testing.assert_array_equal(
                        got["species"][name]["extra"][ak], av)
            else:
                np.testing.assert_array_equal(got["species"][name][k], a,
                                              err_msg=f"{name}.{k}")
    assert ref["species"]["ions"]["extra"]["ionizationLevel"].max() > 3


def test_ionization_gates():
    """Ionizable species keep every run per particle: the port's periodic
    and bounded tile-binned gates refuse them, as the JAX package's do."""
    from warpx_tpu_torch.core.binned_step import (binned_supported,
                                                  bounded_binned_supported)
    from warpx_tpu_torch.core.deck import config_from_deck

    cfg = config_from_deck(Deck.from_string(ION_2D))
    assert not binned_supported(cfg)
    cfg_b = config_from_deck(Deck.from_string(lwfa_nitrogen_deck(_LWFA_2D)))
    cfg_b = dataclasses.replace(cfg_b, tiled_particles="auto")
    assert not bounded_binned_supported(cfg_b)


def test_outputs_carry_the_levels(tmp_path):
    """ION_2D with a plotfile and an openPMD output at step 4: both hold
    each live ion's ionizationLevel (the plotfile as an extra real
    component, openPMD as a record of its own), equal to the state's."""
    h5py = pytest.importorskip("h5py")
    from warpx_tpu_torch.io.plotfile import read_particles

    text = ION_2D + ("diagnostics.diags_names = plt opmd\n"
                     "plt.intervals = 4:4\nplt.diag_type = Full\n"
                     "opmd.intervals = 4:4\nopmd.format = openpmd\n")
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float64, device="cpu",
        output_dir=str(tmp_path))
    sim.init()
    field_hook(seeded_ex((16, 16)), False)(sim)
    sim.evolve(4)
    ion = sim.state.species["ions"]
    want = ion.extra["ionizationLevel"][ion.alive].numpy()
    assert want.max() > 2
    got = read_particles(str(tmp_path / "plt000004"), "ions")
    np.testing.assert_array_equal(got["ionizationLevel"], want)
    with h5py.File(tmp_path / "opmd.h5", "r") as fh:
        rec = fh["data/4/particles/ions/ionizationLevel/value"][()]
    np.testing.assert_array_equal(rec, want)
