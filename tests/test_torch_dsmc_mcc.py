"""DSMC, background MCC and background stopping of the port
(``warpx_tpu_torch/ops/{dsmc,mcc,stopping}.py``) against the JAX package,
CPU, float64.

Each operator on JAX's own draws agrees at 1e-12 (DSMC with partners
shared by several pairs, which XLA's CPU scatter resolves by the last
writer; MCC at energies where the JAX package's gamma - 1 keeps its
digits); whole runs of a periodic 32 x 32 deck with every kind and of the
bounded 32 x 64 laser-wakefield deck with MCC and stopping land within
1e-9 of the JAX runs on one key chain; the bounded step refuses the
pairwise kinds that the JAX package's bounded step skips; the deck reader
reads the cross-section tables (relative to the deck's directory) as the
JAX reader does; in float32 MCC and stopping keep their float64 values,
where the JAX package's float32 forms lose them.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.config import MCCProcessConfig as JProc
from warpx_tpu.core.deck import config_from_deck as jconfig_from_deck
from warpx_tpu.core.state import ParticleState as JParticleState
from warpx_tpu.core.state import SimState as JSimState
from warpx_tpu.ops import dsmc as jdsmc
from warpx_tpu.ops import mcc as jmcc
from warpx_tpu.ops import stopping as jstop
from warpx_tpu.utils.expression import compile_expression as jexpr
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.config import MCCProcessConfig
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.state import ParticleState, SimState
from warpx_tpu_torch.ops import dsmc as tdsmc
from warpx_tpu_torch.ops import mcc as tmcc
from warpx_tpu_torch.ops import stopping as tstop
from warpx_tpu_torch.utils.expression import compile_expression as texpr
from warpx_tpu_torch.utils.parser import Deck

from .test_binned_bounded import _LWFA_2D
from .test_torch_draws_util import (_Leaf, assert_checksums_close,
                                    assert_runs_close, assert_species_close,
                                    jax_run, jax_species_numpy, port_run,
                                    port_species_numpy)

torch.set_num_threads(1)

C = 299792458.0
Q_E = 1.602176634e-19
M_E = 9.1093837015e-31
M_HE = 4.002602 * 1.66053906660e-27
XYZ = ("x", "y", "z", "t")


def _cols(n, seed, u_th, box=4e-6, alive=0.95, w_spread=0.5, drift=0.0,
          ndim=3):
    rng = np.random.default_rng(seed)
    names = ("x", "y", "z") if ndim == 3 else ("x", "z")
    cols = {k: rng.random(n) * box for k in names}
    cols.update({k: rng.normal(size=n) * u_th * C for k in ("ux", "uy",
                                                            "uz")})
    cols["uz"] = cols["uz"] + drift * C
    cols["w"] = 1e8 * (1.0 + w_spread * rng.random(n))
    cols["alive"] = rng.random(n) < alive
    return cols


def _both(cols):
    j = JParticleState(**{k: jnp.asarray(v) for k, v in cols.items()})
    t = ParticleState(**{k: torch.from_numpy(v.copy())
                         for k, v in cols.items()})
    return j, t


def _close(got, ref, tol, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol * scale, (what, np.abs(
        got - ref).max(), scale)


def test_interp_sigma_is_jnp_interp():
    en = np.array([0.0, 1.0, 1.0, 5.0, 30.0, 1e3])
    sg = np.array([1e-20, 3e-20, 2e-20, 5e-21, 1e-21, 4e-22])
    E = np.concatenate([np.linspace(-1, 1.2e3, 997), en])
    ref = np.asarray(jnp.interp(E, en, sg, left=0.0, right=sg[-1]))
    got = tdsmc.interp_sigma(torch.from_numpy(E), en, sg).numpy()
    _close(got, ref, 1e-15)


@pytest.mark.parametrize("mode", ["elastic", "back"])
def test_com_scatter_matches_jax(mode):
    rng = np.random.default_rng(3)
    u1 = rng.normal(size=(3, 400)) * 3e4
    u2 = rng.normal(size=(3, 400)) * 1e4
    key = jax.random.PRNGKey(5)
    ref = jdsmc._com_scatter(tuple(u1), M_HE, tuple(u2), 0.99 * M_HE, key,
                             mode)
    got = tdsmc.com_scatter(tuple(torch.from_numpy(x) for x in u1), M_HE,
                            tuple(torch.from_numpy(x) for x in u2),
                            0.99 * M_HE, _Leaf(key, "cpu"), mode)
    for g, r in zip(got, ref):
        _close(np.array([x.numpy() for x in g]),
               np.array([np.asarray(x) for x in r]), 1e-12, mode)


def _flat(kind, sigma):
    return dict(kind=kind, energies=(0.0, 2.0, 1e9),
                sigmas=(sigma, 0.5 * sigma, 0.5 * sigma))


DSMC_CASES = {
    # name: (process list, species names, second species count)
    "elastic": ([_flat("elastic", 1e-17)], ("a", "b"), 900),
    "back": ([_flat("back", 1e-17)], ("a", "b"), 2400),
    "charge_exchange": ([_flat("charge_exchange", 1e-17)], ("a", "b"),
                        900),
    "three_processes": ([_flat("elastic", 5e-18), _flat("back", 3e-18),
                         _flat("charge_exchange", 4e-18)], ("a", "b"), 600),
    "intra": ([_flat("elastic", 1e-17), _flat("excitation", 1e-17)],
              ("a", "a"), 0),
}


def _dsmc_setup(procs, pair, n2):
    """A 4^3 box of 2000 'a' and ``n2`` 'b' particles (ions at 300 eV
    against neutrals), both sides' configurations and states."""
    from warpx_tpu.core.config import CollisionConfig as JCol
    from warpx_tpu.core.config import SimConfig as JSimConfig
    from warpx_tpu.core.config import SpeciesConfig as JSp
    from warpx_tpu.core.grid import Geometry as JGeometry
    from warpx_tpu_torch.core.config import (CollisionConfig, SimConfig,
                                             SpeciesConfig)
    from warpx_tpu_torch.core.grid import Geometry

    geom = dict(ndim=3, n_cell=(4, 4, 4), prob_lo=(0.0,) * 3,
                prob_hi=(4e-6,) * 3, periodic=(True,) * 3)
    cols = {"a": _cols(2000, 1, 1.5e-4, drift=4e-4),
            "b": _cols(max(n2, 1), 2, 5e-5)}
    cfgs = []
    for G, Sp, Col, Proc, Sim in ((JGeometry, JSp, JCol, JProc, JSimConfig),
                                  (Geometry, SpeciesConfig, CollisionConfig,
                                   MCCProcessConfig, SimConfig)):
        cfgs.append(Sim(
            geometry=G(**geom), max_step=1, dt=1e-9,
            species=(Sp(name="a", charge=Q_E, mass=M_HE),
                     Sp(name="b", charge=0.0, mass=0.99 * M_HE)),
            collisions=(Col(name="d", species=pair, kind="dsmc",
                            processes=tuple(Proc(**p) for p in procs)),)))
    js, ts = {}, {}
    for nm, c in cols.items():
        js[nm], ts[nm] = _both(c)
    jstate = JSimState(fields=None, species=js, step=0, time=0.0, rng=None)
    tstate = SimState(fields=None, species=ts, step=0, time=0.0)
    return cfgs, jstate, tstate, cols


@pytest.mark.parametrize("case", sorted(DSMC_CASES))
def test_dsmc_operator_matches_jax(case):
    """dsmc_collision_update on the JAX package's key: every slot at
    1e-12, most 'a' particles in a colliding pair; with 2000 'a' against
    fewer 'b' per cell, several pairs share a partner."""
    procs, pair, n2 = DSMC_CASES[case]
    (jcfg, tcfg), jstate, tstate, cols = _dsmc_setup(procs, pair, n2)
    key = jax.random.PRNGKey(7)
    ref = jdsmc.dsmc_collision_update(jstate, jcfg, jcfg.collisions[0],
                                      1e-9, key)
    got = tdsmc.dsmc_collision_update(tstate, tcfg, tcfg.collisions[0],
                                      1e-9, _Leaf(key, "cpu"))
    for nm in ("a", "b"):
        assert_species_close(port_species_numpy(got.species[nm]),
                             jax_species_numpy(ref.species[nm]), 1e-12, nm)
    moved = np.asarray(ref.species["a"].uz) != cols["a"]["uz"]
    assert moved.mean() > 0.05


def test_dsmc_shared_partner_keeps_the_last_writer():
    """One cell with four 'a' and one 'b' (charge exchange certain, unequal
    weights so that some pairs leave 'b' alone): 'b' ends with the value
    of the last pair in the (cell, random) order, collided or not, as on
    the JAX package's CPU run, on several keys."""
    procs = [_flat("charge_exchange", 1e-10)]
    (jcfg, tcfg), _, _, _ = _dsmc_setup(procs, ("a", "b"), 1)
    cols = {"a": _cols(4, 3, 1e-4, box=1e-6, alive=1.0, w_spread=3.0),
            "b": _cols(1, 4, 1e-5, box=1e-6, alive=1.0, w_spread=0.0)}
    js, ts = {}, {}
    for nm, c in cols.items():
        js[nm], ts[nm] = _both(c)
    shared = 0
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref = jdsmc.dsmc_collision_update(
            JSimState(fields=None, species=js, step=0, time=0.0, rng=None),
            jcfg, jcfg.collisions[0], 1e-9, key)
        got = tdsmc.dsmc_collision_update(
            SimState(fields=None, species=ts, step=0, time=0.0), tcfg,
            tcfg.collisions[0], 1e-9, _Leaf(key, "cpu"))
        for nm in ("a", "b"):
            assert_species_close(port_species_numpy(got.species[nm]),
                                 jax_species_numpy(ref.species[nm]), 1e-15,
                                 nm)
        # the 'a' particles that took b's velocity: several pairs wrote b
        took = np.isclose(np.asarray(ref.species["a"].uz), cols["b"]["uz"][0])
        shared += int(took.sum() > 1)
    assert shared > 0


def _inv_v_xsec(sigma0, E_ref, e_lo=0.2, e_hi=5000.0, de=0.2):
    """sigma(E) = sigma0 sqrt(E_ref / E) on a uniform grid: nu = n sigma v
    is then constant, and the null-collision method exact
    (tests/test_mcc.py::_inv_v_xsec)."""
    es = np.arange(e_lo, e_hi + de / 2, de)
    return tuple(es.tolist()), tuple((sigma0 * np.sqrt(E_ref / es)).tolist())


def _procs(kinds):
    out = []
    for kind in kinds:
        pen = {"excitation": 19.8, "ionization": 24.6}.get(kind, 0.0)
        es, sg = _inv_v_xsec(2e-20, 100.0, e_lo=max(pen, 0.2))
        if kind == "ionization":
            # zero at the threshold: the clamp below the grid keeps
            # electrons under it inert (tests/test_mcc.py)
            sg = (0.0,) + sg[1:]
        out.append(dict(kind=kind, energy_penalty=pen, energies=es,
                        sigmas=sg))
    return out


MCC_CASES = {
    "elastic": ["elastic"],
    "back": ["back"],
    "charge_exchange": ["charge_exchange"],
    "excitation": ["excitation"],
    "all": ["elastic", "excitation", "back", "charge_exchange"],
}


@pytest.mark.parametrize("case", sorted(MCC_CASES))
def test_mcc_scattering_matches_jax(case):
    """apply_mcc_scattering on the JAX package's key, electrons at ~2 keV
    on helium at 1e22 m^-3, 300 K (the JAX package's float64 gamma - 1
    keeps 13 digits there): 1e-12."""
    procs = _procs(MCC_CASES[case])
    cols = _cols(3000, 5, 0.05)
    j, t = _both(cols)
    nu_max = jmcc.mcc_nu_max([JProc(**p) for p in procs], M_E, 1e22)
    assert nu_max == tmcc.mcc_nu_max([MCCProcessConfig(**p) for p in procs],
                                     M_E, 1e22)
    p_coll = jmcc.total_collision_prob(nu_max, 2e-10)
    key = jax.random.PRNGKey(13)
    kw = dict(m=M_E, M=M_HE, nu_max=nu_max, p_coll=p_coll)
    ref = jmcc.apply_mcc_scattering(
        key, j, 3, 0.0, processes=[JProc(**p) for p in procs],
        n_a_fn=jexpr("1e22", XYZ), T_a_fn=jexpr("300", XYZ),
        dtype=jnp.float64, **kw)
    got = tmcc.apply_mcc_scattering(
        _Leaf(key, "cpu"), t, 3, 0.0,
        processes=[MCCProcessConfig(**p) for p in procs],
        n_a_fn=texpr("1e22", XYZ), T_a_fn=texpr("300", XYZ),
        dtype=torch.float64, **kw)
    assert_species_close(port_species_numpy(got), jax_species_numpy(ref),
                         1e-12)
    assert (np.asarray(ref.ux) != cols["ux"]).mean() > 0.1


def test_mcc_ionization_matches_jax():
    """apply_mcc_ionization on the JAX package's key: the source electrons,
    the secondaries in the electrons' free slots and the ions in theirs at
    1e-12."""
    proc = _procs(["ionization"])[0]
    cols = _cols(2000, 6, 0.05, alive=0.5)
    ions = {k: np.zeros(2500) for k in ("w", "ux", "uy", "uz", "x", "y",
                                         "z")}
    ions["alive"] = np.zeros(2500, bool)
    je, te = _both(cols)
    ji, ti = _both(ions)
    nu_max = jmcc.mcc_nu_max([JProc(**proc)], M_E, 1e22)
    key = jax.random.PRNGKey(17)
    kw = dict(m=M_E, M_bg=M_HE, nu_max_ioniz=nu_max,
              p_coll_ioniz=jmcc.total_collision_prob(nu_max, 4e-10))
    ref = jmcc.apply_mcc_ionization(
        key, je, ji, 3, 0.0, proc=JProc(**proc), n_a_fn=jexpr("1e22", XYZ),
        T_a_fn=jexpr("300", XYZ), dtype=jnp.float64, **kw)
    got = tmcc.apply_mcc_ionization(
        _Leaf(key, "cpu"), te, ti, 3, 0.0, proc=MCCProcessConfig(**proc),
        n_a_fn=texpr("1e22", XYZ), T_a_fn=texpr("300", XYZ),
        dtype=torch.float64, **kw)
    for g, r, nm in zip(got, ref, ("electrons", "ions")):
        assert_species_close(port_species_numpy(g), jax_species_numpy(r),
                             1e-12, nm)
    n_new = int(np.asarray(ref[1].alive).sum())
    assert n_new > 20
    assert int(got[0].alive.sum()) == int(cols["alive"].sum()) + n_new


@pytest.mark.parametrize("kind", ["electrons", "ions"])
def test_stopping_matches_jax(kind):
    """apply_background_stopping (a parsed density, a constant
    temperature) against the JAX package: 1e-12, and the particles slowed."""
    cols = _cols(1000, 8, 0.01 if kind == "ions" else 0.002)
    j, t = _both(cols)
    kw = dict(q=2 * Q_E, m=M_HE, kind=kind, M_bg=M_E if kind == "electrons"
              else 1.67e-27, Z_bg=1.0, dt=1e-12)
    dens = "1e26*(1+x/4e-6)"
    ref = jstop.apply_background_stopping(
        j, 3, 0.0, n_fn=jexpr(dens, XYZ), T_fn=jexpr("2e5", XYZ),
        dtype=jnp.float64, **kw)
    got = tstop.apply_background_stopping(
        t, 3, 0.0, n_fn=texpr(dens, XYZ), T_fn=texpr("2e5", XYZ), **kw)
    assert_species_close(port_species_numpy(got), jax_species_numpy(ref),
                         1e-12)
    slowed = np.abs(np.asarray(ref.ux)) < np.abs(cols["ux"])
    assert slowed[cols["alive"]].mean() > 0.9


class _Cast:
    """A JAX-key source whose draws are taken in float64 and rounded to
    the dtype asked for: float32 and float64 runs on the same numbers."""

    def __init__(self, leaf):
        self.leaf = leaf

    def split(self, n):
        return tuple(_Cast(k) for k in self.leaf.split(n))

    def uniform(self, shape, dtype, lo=0.0, hi=1.0):
        return self.leaf.uniform(shape, torch.float64, lo, hi).to(dtype)

    def normal(self, shape, dtype):
        return self.leaf.normal(shape, torch.float64).to(dtype)


def test_float32_mcc_and_stopping_keep_their_values():
    """In float32 the port's MCC scattering and its stopping land within
    1e-5 and 1e-6 of float64 on the same draws; the JAX package's float32
    collision energy is 0 for an electron on helium (m M ~ 7e-57 kg^2
    flushes to zero), so its float32 MCC picks every process at the
    energy 0."""
    cols = _cols(512, 9, 0.003)
    j, t = _both(cols)
    v2 = sum(jnp.asarray(cols[k], jnp.float32) ** 2 for k in ("ux", "uy",
                                                               "uz"))
    _, e32 = jmcc._collision_energy(v2, M_E, M_HE)
    assert float(jnp.abs(e32).max()) == 0.0
    procs = [MCCProcessConfig(**p) for p in _procs(["elastic"])]
    nu_max = tmcc.mcc_nu_max(procs, M_E, 1e22)
    outs = {}
    for dt_ in (torch.float64, torch.float32):
        sp = ParticleState(**{k: torch.from_numpy(v.copy()).to(
            dt_ if v.dtype != bool else torch.bool)
            for k, v in cols.items()})
        outs[dt_] = tmcc.apply_mcc_scattering(
            _Cast(_Leaf(jax.random.PRNGKey(1), "cpu")), sp, 3, 0.0, m=M_E,
            M=M_HE,
            processes=procs, n_a_fn=texpr("1e22", XYZ),
            T_a_fn=texpr("300", XYZ), nu_max=nu_max,
            p_coll=tmcc.total_collision_prob(nu_max, 1e-9), dtype=dt_)
    a, b = outs[torch.float32], outs[torch.float64]
    for k in ("ux", "uy", "uz"):
        _close(getattr(a, k).double().numpy(), getattr(b, k).numpy(), 1e-5)
    assert (b.ux.numpy() != cols["ux"]).mean() > 0.05
    outs = {}
    for dt_ in (torch.float64, torch.float32):
        sp = ParticleState(**{k: torch.from_numpy(v.copy()).to(
            dt_ if v.dtype != bool else torch.bool)
            for k, v in cols.items()})
        outs[dt_] = tstop.apply_background_stopping(
            sp, 3, 0.0, q=-Q_E, m=M_E, kind="electrons", M_bg=M_E,
            Z_bg=1.0, n_fn=texpr("1e24", XYZ), T_fn=texpr("2e5", XYZ),
            dt=1e-12)
    a, b = outs[torch.float32], outs[torch.float64]
    assert (b.ux.numpy() != cols["ux"]).mean() > 0.9
    _close(a.ux.double().numpy(), b.ux.numpy(), 1e-6)


def write_tables(d):
    """The cross-section files of the decks below, in ``d``."""
    for name, kinds in (("el", ["elastic"]), ("ex", ["excitation"]),
                        ("iz", ["ionization"])):
        p = _procs(kinds)[0]
        np.savetxt(os.path.join(d, f"{name}.dat"),
                   np.column_stack([p["energies"], p["sigmas"]]))
    for name, s in (("d_el", 4e-19), ("d_back", 2e-19), ("d_cx", 3e-19)):
        np.savetxt(os.path.join(d, f"{name}.dat"),
                   np.array([[0.0, s], [1.0, s], [1e4, 0.5 * s]]))


def periodic_deck(steps=4):
    """32 x 32 periodic, no field solve: electrons with MCC elastic,
    excitation and ionization on helium (products into 'hep'), 'hep' ions
    and 'he' neutrals with DSMC elastic, back and charge exchange, stopping
    of the electrons on an electron background and of 'hep' on an ion
    background.  Table paths are relative to the deck's directory."""
    return f"""
max_step = {steps}
amr.n_cell = 32 32
geometry.dims = 2
geometry.prob_lo = 0. 0.
geometry.prob_hi = 3.2e-5 3.2e-5
warpx.const_dt = 2.e-12
algo.maxwell_solver = none
warpx.use_filter = 0
particles.species_names = electrons hep he
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 2 2
electrons.profile = constant
electrons.density = 1.e18
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.03
electrons.uy_th = 0.03
electrons.uz_th = 0.03
electrons.do_not_deposit = 1
hep.species_type = helium
hep.charge = q_e
hep.injection_style = NUniformPerCell
hep.num_particles_per_cell_each_dim = 2 2
hep.profile = constant
hep.density = 1.e18
hep.momentum_distribution_type = gaussian
hep.ux_th = 0.0003
hep.uy_th = 0.0003
hep.uz_th = 0.0003
hep.uz_m = 0.0002
hep.do_not_deposit = 1
he.species_type = helium
he.charge = 0.
he.injection_style = NUniformPerCell
he.num_particles_per_cell_each_dim = 1 2
he.profile = constant
he.density = 1.e22
he.momentum_distribution_type = gaussian
he.ux_th = 0.00001
he.uy_th = 0.00001
he.uz_th = 0.00001
he.do_not_deposit = 1
collisions.collision_names = dsmc1 mcc1 stop_e stop_i
dsmc1.type = dsmc
dsmc1.species = hep he
dsmc1.scattering_processes = elastic back charge_exchange
dsmc1.elastic_cross_section = d_el.dat
dsmc1.back_cross_section = d_back.dat
dsmc1.charge_exchange_cross_section = d_cx.dat
mcc1.type = background_mcc
mcc1.species = electrons
mcc1.background_density = 1.e22
mcc1.background_temperature = 300.
mcc1.ionization_species = hep
mcc1.scattering_processes = elastic excitation1 ionization
mcc1.elastic_cross_section = el.dat
mcc1.excitation1_cross_section = ex.dat
mcc1.excitation1_energy = 19.8
mcc1.ionization_cross_section = iz.dat
mcc1.ionization_energy = 24.6
stop_e.type = background_stopping
stop_e.species = electrons
stop_e.background_type = electrons
stop_e.background_density = 1.e22
stop_e.background_temperature = 5.e4
stop_i.type = background_stopping
stop_i.species = hep
stop_i.background_type = ions
stop_i.background_mass = 6.6464731e-27
stop_i.background_charge_state = 1.
stop_i.background_density(x,y,z,t) = 1.e24*(1+x/3.2e-5)
stop_i.background_temperature = 1.e4
"""


def _in_dir(tmp_path, text, jax_side):
    """The deck as a file in ``tmp_path`` (its tables beside it), read
    back by one package's parser."""
    write_tables(tmp_path)
    p = tmp_path / "inputs"
    p.write_text(text)
    return (JDeck if jax_side else Deck).from_file(str(p))


def _run_deck(deck, jax_side):
    if jax_side:
        from warpx_tpu.core.simulation import Simulation as JSimulation

        sim = JSimulation.from_deck(deck)
        sim.init()
        sim.evolve()
        return sim
    from .test_torch_draws_util import ReplayDraws

    sim = warpx_tpu_torch.Simulation.from_deck(deck, dtype=torch.float64,
                                               device="cpu")
    sim.draws = ReplayDraws.from_seed(sim.cfg.seed)
    sim.init()
    sim.evolve()
    return sim


def test_periodic_run_matches_jax(tmp_path, monkeypatch):
    """Four steps of every DSMC, MCC and stopping kind from a deck file:
    species within 1e-9 of the JAX run, checksums too; ionizations made
    their pairs, DSMC and MCC moved particles.  (The JAX reader opens DSMC
    tables from the working directory, the port from the deck's.)"""
    monkeypatch.chdir(tmp_path)
    ref = _run_deck(_in_dir(tmp_path, periodic_deck(), True), True)
    got = _run_deck(_in_dir(tmp_path, periodic_deck(), False), False)
    assert not got.binned
    assert_runs_close(got, ref, 1e-9, fields=False)
    assert_checksums_close(got.checksums(), ref.checksums(), 1e-9)
    n0 = 32 * 32 * 4
    assert int(got.state.species["hep"].alive.sum()) > n0 + 10
    assert int(got.state.species["electrons"].alive.sum()) == int(
        got.state.species["hep"].alive.sum())


def lwfa_mcc_deck(steps=8):
    """The 32 x 64 laser-wakefield deck (PML, moving window, antenna,
    continuous injection, beam) with its electrons on a helium background
    (MCC elastic and ionization into 'hep') and stopping of the electrons
    and of 'hep'."""
    return _LWFA_2D.replace("max_step = 12", f"max_step = {steps}").replace(
        "particles.species_names = electrons beam",
        "particles.species_names = electrons beam hep") + """
hep.species_type = helium
hep.charge = q_e
hep.injection_style = none
collisions.collision_names = mcc1 stop_e stop_i
mcc1.type = background_mcc
mcc1.species = electrons
mcc1.background_density = 1.e25
mcc1.background_temperature = 300.
mcc1.ionization_species = hep
mcc1.scattering_processes = elastic ionization
mcc1.elastic_cross_section = el.dat
mcc1.ionization_cross_section = iz.dat
mcc1.ionization_energy = 24.6
stop_e.type = background_stopping
stop_e.species = electrons
stop_e.background_density = 1.e24
stop_e.background_temperature = 5.e4
stop_i.type = background_stopping
stop_i.species = hep
stop_i.background_type = ions
stop_i.background_mass = 6.6464731e-27
stop_i.background_charge_state = 1.
stop_i.background_density = 1.e24
stop_i.background_temperature = 1.e4
"""


def test_bounded_mcc_stopping_run_matches_jax(tmp_path):
    """The bounded laser-wakefield deck with MCC and stopping, per
    particle, 3 steps: fields, species and checksums within 1e-9 of the
    JAX package's bounded run."""
    ref = _run_deck(_in_dir(tmp_path, lwfa_mcc_deck(3), True), True)
    got = _run_deck(_in_dir(tmp_path, lwfa_mcc_deck(3), False), False)
    assert got.is_bounded and got.stepper.spec is None
    assert_runs_close(got, ref, 1e-9)
    assert_checksums_close(got.checksums(), ref.checksums(), 1e-9)


@pytest.mark.parametrize("kind", ["pairwisecoulomb", "nuclearfusion",
                                  "dsmc"])
def test_bounded_refuses_pairwise_kinds(tmp_path, kind):
    """The JAX package's bounded step skips pairwise Coulomb, fusion and
    DSMC without a word; the port refuses them, naming Queue C."""
    extra = {"pairwisecoulomb": "c1.species = electrons electrons\n",
             "nuclearfusion": "c1.type = nuclearfusion\n"
                              "c1.species = electrons electrons\n",
             "dsmc": "c1.type = dsmc\nc1.species = electrons electrons\n"
                     "c1.scattering_processes = elastic\n"
                     "c1.elastic_cross_section = d_el.dat\n"}[kind]
    text = _LWFA_2D + "collisions.collision_names = c1\n" + extra
    deck = _in_dir(tmp_path, text, False)
    try:
        sim = warpx_tpu_torch.Simulation.from_deck(deck, device="cpu")
    except NotImplementedError as e:
        assert "Queue C" in str(e) or kind == "nuclearfusion", e
        return
    raise AssertionError(f"{kind} on a bounded deck ran: {sim}")


def test_deck_reader_matches_jax(tmp_path, monkeypatch):
    """Every collision field of the periodic deck as the JAX reader sets
    it, the tables read from beside the deck."""
    got = config_from_deck(_in_dir(tmp_path, periodic_deck(), False))
    with monkeypatch.context() as mp:
        mp.chdir(tmp_path)  # the JAX reader opens DSMC tables from the cwd
        ref = jconfig_from_deck(_in_dir(tmp_path, periodic_deck(), True))
    assert len(got.collisions) == len(ref.collisions) == 4
    for g, r in zip(got.collisions, ref.collisions):
        for f in dataclasses.fields(r):
            if f.name == "processes":
                assert len(g.processes) == len(r.processes)
                for gp, rp in zip(g.processes, r.processes):
                    assert gp.kind == rp.kind
                    assert gp.energy_penalty == rp.energy_penalty
                    np.testing.assert_array_equal(gp.energies, rp.energies)
                    np.testing.assert_array_equal(gp.sigmas, rp.sigmas)
            else:
                assert getattr(g, f.name) == getattr(r, f.name), f.name


def test_missing_table_is_refused(tmp_path):
    text = periodic_deck().replace("d_el.dat", "absent.dat")
    with pytest.raises(FileNotFoundError, match="absent.dat"):
        config_from_deck(_in_dir(tmp_path, text, False))


def test_cross_section_file_roundtrip(tmp_path):
    """load_cross_section reads two-column uniform tables and refuses a
    non-uniform grid (ScatteringProcess.cpp:96)."""
    p = tmp_path / "xs.dat"
    np.savetxt(p, np.column_stack([np.linspace(0, 100, 11),
                                   np.full(11, 1e-20)]))
    e, s = tmcc.load_cross_section(str(p))
    assert e.shape == (11,) and np.allclose(s, 1e-20)
    bad = tmp_path / "bad.dat"
    np.savetxt(bad, np.column_stack([[0.0, 1.0, 3.0], [1, 1, 1]]))
    with pytest.raises(ValueError):
        tmcc.load_cross_section(str(bad))


def test_collisions_keep_the_per_particle_step(tmp_path):
    """Both binned gates refuse a collision deck, as the JAX package's do:
    'auto' runs per particle, 'on' raises."""
    from warpx_tpu_torch.core.binned_step import (bounded_binned_supported,
                                                  binned_supported)

    cfg = config_from_deck(_in_dir(tmp_path, periodic_deck(), False))
    assert not binned_supported(cfg)
    assert not bounded_binned_supported(cfg)
    with pytest.raises(NotImplementedError, match="tiled_particles=on"):
        warpx_tpu_torch.Simulation.from_deck(
            _in_dir(tmp_path, periodic_deck()
                    + "tpu.tiled_particles = on\n", False), device="cpu")


def test_cli_runs_a_collision_deck(tmp_path, capsys):
    """The CLI on the CPU: the periodic deck's checksums equal an
    in-process run's on the port's own generator."""
    import json

    from warpx_tpu_torch.__main__ import main

    write_tables(tmp_path)
    p = tmp_path / "inputs"
    p.write_text(periodic_deck(steps=2))
    rc = main([str(p), "--device", "cpu", "--checksums",
               "--output-dir", str(tmp_path / "diags")])
    assert rc == 0
    out = capsys.readouterr().out
    sums = json.loads(out[out.index("{"):])
    sim = warpx_tpu_torch.Simulation.from_deck(Deck.from_file(str(p)),
                                               dtype=torch.float64,
                                               device="cpu")
    sim.init()
    sim.evolve()
    assert_checksums_close(sums, sim.checksums(), 1e-12)


def test_chip_smoke_collision_deck_copies(tmp_path):
    """chip_smoke.py's collision decks and tables are the tests' (its own
    copies: it imports neither JAX nor the tests)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.mcc32_deck(steps=4) == periodic_deck(steps=4)
    assert smoke.lwfa_mcc_deck(steps=8) == lwfa_mcc_deck(steps=8)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    write_tables(tmp_path / "a")
    smoke.write_collision_tables(tmp_path / "b")
    for f in sorted(os.listdir(tmp_path / "a")):
        np.testing.assert_array_equal(np.loadtxt(tmp_path / "a" / f),
                                      np.loadtxt(tmp_path / "b" / f))
