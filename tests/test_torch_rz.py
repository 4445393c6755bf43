"""RZ geometry under FDTD (``warpx_tpu_torch/rz/core.py``) against the JAX
package's ``warpx_tpu/rz/core.py`` on the CPU in float64.

The layout, the axis and z guard fills, the injection, the gather, the
deposits and their folds, each field update and the filter on the same
inputs (made by numpy from a seed, with particles within a cell of the axis
and of rmax); then the periodic multi-mode step end to end on decks written
here (1, 2 and 3 modes, F cleaning): fields, particles and the RZ
checksums within 1e-9; the deck reader's RZ refusals, the JAX reader's and
the port's, as cases; the package imports nothing of JAX; the CLI.
"""

import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.deck import config_from_deck as jax_config_from_deck
from warpx_tpu.core.state import FieldState as JFieldState
from warpx_tpu.rz import core as jrz
from warpx_tpu.rz import spectral as jspec
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.state import FieldState
from warpx_tpu_torch.rz import core as rz
from warpx_tpu_torch.rz import spectral as spec
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import port_config
from .test_torch_rz_util import (DECKS, FIELDS, _LANGMUIR, _LWFA,
                                 _SILVER_MUELLER, assert_checksums,
                                 assert_fields, assert_species, close,
                                 jax_run, port_fields, port_run,
                                 port_species)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

RZ_PACKAGE = pathlib.Path(warpx_tpu_torch.__file__).parent / "rz"


def _cfgs(text):
    jcfg = jax_config_from_deck(JDeck.from_string(text))
    return jcfg, config_from_deck(Deck.from_string(text))


# small decks for the unit checks: periodic z at 1-3 modes, bounded PEC z,
# Silver-Mueller faces
_UNIT = {
    "periodic_m1": _LANGMUIR.format(steps=1, modes=1, order=1, extra=""),
    "periodic_m3": _LANGMUIR.format(steps=1, modes=3, order=2, extra=""),
    "bounded_m2": _LWFA.format(steps=1, modes=2, nr=16, nz=32, order=2,
                               plasma_extra="", extra=""),
    "sm_m2": _SILVER_MUELLER.format(steps=1, extra=""),
}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64).copy())


def _random_fields(jcfg, rng, names=("Er", "Et", "Ez", "Br", "Bt", "Bz",
                                     "jr", "jt", "jz")):
    scale = {"E": 1e10, "B": 30.0, "j": 1e12}
    return {nm: rng.normal(size=jrz.field_shape(jcfg, nm)) * scale[nm[0]]
            for nm in names}


def _particles(jcfg, rng, n=300):
    """Cartesian positions over the domain, a tenth within a cell of the
    axis and a tenth within two cells of rmax; momenta near c."""
    geom = jcfg.geometry
    dr = geom.dx[0]
    rmax = geom.prob_hi[0]
    r = rng.uniform(0.0, rmax, n)
    r[: n // 10] = rng.uniform(0.0, dr, n // 10)
    r[n // 10: n // 5] = rng.uniform(rmax - 2 * dr, rmax - 1e-3 * dr,
                                     n // 5 - n // 10)
    r[0] = 0.0
    th = rng.uniform(-np.pi, np.pi, n)
    zlo, zhi = geom.prob_lo[1], geom.prob_hi[1]
    z = rng.uniform(zlo + 3 * geom.dx[1], zhi - 3 * geom.dx[1], n)
    u = rng.normal(size=(3, n)) * 1e8
    w = rng.uniform(0.5, 2.0, n) * 1e8
    return r * np.cos(th), r * np.sin(th), z, u, w


# ------------------------------------------------------------ the layout
@pytest.mark.parametrize("case", sorted(_UNIT))
def test_layout_matches_jax(case):
    """Shapes of every component, the zero fields with the Silver-Mueller
    rings, the staggering, the RZ CFL and the readers' configurations."""
    jcfg, cfg = _cfgs(_UNIT[case])
    assert cfg == port_config(jcfg)
    for nm in rz.RZ_STAGGER:
        assert rz.field_shape(cfg, nm) == jrz.field_shape(jcfg, nm)
        assert rz.rz_stagger(cfg, nm) == jrz.rz_stagger(jcfg, nm)
    jf = jrz.rz_zero_fields(jcfg, jnp.float64)
    f = rz.rz_zero_fields(cfg, torch.float64, "cpu")
    for nm in FIELDS:
        assert tuple(getattr(f, nm).shape) == getattr(jf, nm).shape
    assert (f.smg is None) == (jf.smg is None)
    if jf.smg is not None:
        assert {k: tuple(v.shape) for k, v in f.smg.items()} == {
            k: v.shape for k, v in jf.smg.items()}
    for modes in (1, 2, 3, 7):
        assert rz.compute_dt_rz(1e-6, 2e-6, modes, 0.9) == \
            jrz.compute_dt_rz(1e-6, 2e-6, modes, 0.9)


@pytest.mark.parametrize("nodal", [True, False])
@pytest.mark.parametrize("name", ["Er", "Et", "Ez", "Br", "Bt", "Bz", "F",
                                  "rho"])
def test_extend_axis_matches_jax(name, nodal):
    """The mirrored rows below the axis, every component of modes 0-2 (the
    parity (-1)^(m+1), nodal and cell-centered sources)."""
    rng = np.random.default_rng(3)
    arr = rng.normal(size=(5, 9, 7))
    for ng in (1, 3, 5):
        ref = jrz._extend_axis(jnp.asarray(arr), name, ng, 9, nodal_r=nodal)
        got = rz._extend_axis(_t(arr), name, ng, nodal_r=nodal)
        assert np.array_equal(got.numpy(), np.asarray(ref)), (name, ng)


@pytest.mark.parametrize("name", ["Er", "Et", "Ez", "Br", "Bt", "Bz"])
def test_extend_z_matches_jax(name):
    """The z guards of the PEC walls and of periodic z."""
    rng = np.random.default_rng(4)
    for case in ("bounded_m2", "periodic_m3"):
        jcfg, cfg = _cfgs(_UNIT[case])
        arr = rng.normal(size=jrz.field_shape(jcfg, name))
        ref = jrz._extend_z(jnp.asarray(arr), name, jcfg, 3)
        got = rz._extend_z(_t(arr), name, cfg, 3)
        assert np.array_equal(got.numpy(), np.asarray(ref)), (case, name)


# ------------------------------------------------------------ injection
def _columns_equal(cols, ps, what):
    for k in ("w", "ux", "uy", "uz", "alive", "x", "y", "z"):
        close(cols[k], np.asarray(getattr(ps, k)), f"{what}.{k}")
    assert set(cols.get("extra", {})) == set(ps.extra), what
    for k, v in ps.extra.items():
        close(cols["extra"][k], np.asarray(v), f"{what}.{k}")


_INJECT = _LWFA.format(
    steps=20, modes=2, nr=8, nz=32, order=1,
    plasma_extra=(
        "electrons.momentum_distribution_type = gaussian\n"
        "electrons.ux_th = 0.1\nelectrons.uz_m = 0.3\n"
        "electrons.addRealAttributes = orig_z\n"
        "electrons.attribute.orig_z(x,y,z,ux,uy,uz,t) = z\n"),
    extra="")


def test_injection_matches_jax():
    """NUniformPerCell over (r, theta, z) with random_theta offsets drawn
    before the momenta, the window's padding and the runtime attributes;
    the Gaussian beam; the antenna's spokes: the same numpy draws."""
    jcfg, cfg = _cfgs(_INJECT)
    for j_sp, sp in zip(jcfg.species, cfg.species):
        if sp.injection_style == "laser":
            jps, jmob = jrz.rz_antenna_particles(jcfg.lasers[0], jcfg,
                                                 np.float64)
            cols, mob = rz.rz_antenna_particles(cfg.lasers[0], cfg,
                                                np.float64)
            assert mob == jmob
        else:
            jps = jrz.rz_inject_species(j_sp, jcfg, np.float64,
                                        np.random.default_rng(11))
            cols = rz.rz_inject_species(sp, cfg, np.float64,
                                        np.random.default_rng(11))
        _columns_equal(cols, jps, sp.name)


def test_parsed_injection_matches_jax():
    """A parsed density and parsed momenta, species bounds on the radius."""
    jcfg, cfg = _cfgs(DECKS["psatd_cc"])
    for j_sp, sp in zip(jcfg.species, cfg.species):
        jps = jrz.rz_inject_species(j_sp, jcfg, np.float64,
                                    np.random.default_rng(5))
        cols = rz.rz_inject_species(sp, cfg, np.float64,
                                    np.random.default_rng(5))
        _columns_equal(cols, jps, sp.name)


def test_update_antenna_matches_jax():
    jcfg, cfg = _cfgs(_UNIT["bounded_m2"])
    jps, jmob = jrz.rz_antenna_particles(jcfg.lasers[0], jcfg, np.float64)
    cols, mob = rz.rz_antenna_particles(cfg.lasers[0], cfg, np.float64)
    sp = rz.columns_to_state(cols, "cpu")
    for t in (0.0, 2.3e-14, 3.1e-14):
        ref = jrz.update_antenna_rz(jps, jcfg.lasers[0], jmob, t, jcfg.dt)
        got = rz.update_antenna_rz(sp, cfg.lasers[0], mob, t, cfg.dt)
        for k in ("ux", "uy", "uz", "x", "y", "z"):
            close(getattr(got, k), np.asarray(getattr(ref, k)), k)


# ------------------------------------------------------- gather, deposits
# the particle operations' cases (one mode runs through the langmuir_m1
# deck; the Silver-Mueller deck's particles see bounded z as the PEC
# deck's do)
PARTICLE_CASES = ("periodic_m3", "bounded_m2")


@pytest.mark.parametrize("case", PARTICLE_CASES)
def test_gather_matches_jax(case):
    """The six Cartesian fields at the particles, every mode."""
    jcfg, cfg = _cfgs(_UNIT[case])
    rng = np.random.default_rng(6)
    farr = _random_fields(jcfg, rng, ("Er", "Et", "Ez", "Br", "Bt", "Bz"))
    x, y, z, _, _ = _particles(jcfg, rng)
    order = cfg.particle_shape
    for z0 in (None, jcfg.geometry.prob_lo[1] + 0.3 * jcfg.geometry.dx[1]):
        ref = jrz.gather_rz(tuple(map(jnp.asarray, (x, y, z))),
                            {k: jnp.asarray(v) for k, v in farr.items()},
                            jcfg, order, order + 2, z_origin=z0)
        got = rz.gather_rz((_t(x), _t(y), _t(z)),
                           {k: _t(v) for k, v in farr.items()}, cfg, order,
                           order + 2, z_origin=z0)
        for i, (g, r) in enumerate(zip(got, ref)):
            close(g, np.asarray(r), f"{case} component {i}")


@pytest.mark.parametrize("case", PARTICLE_CASES)
def test_deposits_match_jax(case):
    """rho and the Esirkepov (jr, jt, jz) of every mode component, with the
    below-axis folds and the ring-volume scaling; particles within a cell
    of the axis and of rmax."""
    jcfg, cfg = _cfgs(_UNIT[case])
    rng = np.random.default_rng(7)
    x, y, z, u, w = _particles(jcfg, rng)
    order = cfg.particle_shape
    ng = order + 2
    q = -1.602176634e-19
    z0 = jcfg.geometry.prob_lo[1] + 0.25 * jcfg.geometry.dx[1]
    ref = jrz.deposit_rho_rz(tuple(map(jnp.asarray, (x, y, z))),
                             jnp.asarray(w), q, jcfg, order, ng,
                             jnp.float64, z_origin=z0)
    got = rz.deposit_rho_rz((_t(x), _t(y), _t(z)), _t(w), q, cfg, order, ng,
                            torch.float64, z_origin=z0)
    for c in range(ref.shape[0]):
        close(got[c], np.asarray(ref[c]), f"rho[{c}]",
              scale=float(np.abs(np.asarray(ref)).max()))
    dt = jcfg.dt
    ref = jrz.deposit_current_rz(
        tuple(map(jnp.asarray, (x, y, z))), *map(jnp.asarray, u),
        jnp.asarray(w), q, jcfg, dt, order, ng, jnp.float64)
    got = rz.deposit_current_rz((_t(x), _t(y), _t(z)), *map(_t, u), _t(w),
                                q, cfg, dt, order, ng, torch.float64)
    for nm, g, r in zip(("jr", "jt", "jz"), got, ref):
        r = np.asarray(r)
        for c in range(r.shape[0]):
            close(g[c], r[c], f"{nm}[{c}]", scale=float(np.abs(r).max()))


@pytest.mark.parametrize("kind", ["r", "t", "z", "rho"])
@pytest.mark.parametrize("name", ["jr", "jt", "jz", "rho"])
def test_fold_and_scale_matches_jax(name, kind):
    jcfg, cfg = _cfgs(_UNIT["periodic_m3"])
    rng = np.random.default_rng(8)
    ng = 4
    shp = jrz.field_shape(jcfg, name)
    ext = rng.normal(size=(shp[0], shp[1] + 2 * ng, shp[2]))
    ref = jrz._fold_and_scale_modes(jnp.asarray(ext), name, jcfg, ng, kind)
    got = rz._fold_and_scale_modes(_t(ext), name, cfg, ng, kind)
    close(got, np.asarray(ref), f"{name}/{kind}")


# ---------------------------------------------------------- field solve
def _field_states(jcfg, cfg, rng, with_F=False):
    arrs = _random_fields(jcfg, rng)
    attrs = dict(zip(("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"),
                     ("Er", "Et", "Ez", "Br", "Bt", "Bz", "jr", "jt", "jz")))
    jkw = {a: jnp.asarray(arrs[nm]) for a, nm in attrs.items()}
    kw = {a: _t(arrs[nm]) for a, nm in attrs.items()}
    jf0 = jrz.rz_zero_fields(jcfg, jnp.float64)
    if jf0.smg is not None:
        smg = {k: rng.normal(size=v.shape) * 30.0 for k, v in jf0.smg.items()}
        jkw["smg"] = {k: jnp.asarray(v) for k, v in smg.items()}
        kw["smg"] = {k: _t(v) for k, v in smg.items()}
    if with_F:
        F = rng.normal(size=jrz.field_shape(jcfg, "F")) * 1e9
        jkw["F"], kw["F"] = jnp.asarray(F), _t(F)
    return JFieldState(**jkw), FieldState(**kw)


def _same_fields(got, ref, what):
    for a in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
        r = np.asarray(getattr(ref, a))
        close(getattr(got, a), r, f"{what}.{a}")
    if ref.smg is not None:
        for k, v in ref.smg.items():
            close(got.smg[k], np.asarray(v), f"{what}.smg.{k}")


@pytest.mark.parametrize("case", ["periodic_m3", "bounded_m2"])
def test_field_updates_match_jax(case):
    """evolve_b_rz, evolve_e_rz (with and without F), evolve_f_rz and the
    PEC walls, with their on-axis rules."""
    jcfg, cfg = _cfgs(_UNIT[case])
    rng = np.random.default_rng(9)
    dt = jcfg.dt
    jf, f = _field_states(jcfg, cfg, rng, with_F=True)
    _same_fields(rz.evolve_b_rz(f, cfg, 0.5 * dt),
                 jrz.evolve_b_rz(jf, jcfg, 0.5 * dt), "evolve_b")
    _same_fields(rz.evolve_e_rz(f, cfg, dt),
                 jrz.evolve_e_rz(jf, jcfg, dt), "evolve_e")
    _same_fields(rz.evolve_e_rz(f, cfg, dt, F=f.F),
                 jrz.evolve_e_rz(jf, jcfg, dt, F=jf.F), "evolve_e F")
    rho = rng.normal(size=jrz.field_shape(jcfg, "rho")) * 1e3
    close(rz.evolve_f_rz(f.F, f, _t(rho), cfg, dt),
          np.asarray(jrz.evolve_f_rz(jf.F, jf, jnp.asarray(rho), jcfg, dt)),
          "evolve_f")
    _same_fields(rz.enforce_walls_rz(f, cfg),
                 jrz.enforce_walls_rz(jf, jcfg), "walls")


def test_silver_mueller_matches_jax():
    """The guard rings' recurrence on the z walls and the r wall, and the
    wall E fix that reads them, with the on-axis Et rules."""
    jcfg, cfg = _cfgs(_UNIT["sm_m2"])
    rng = np.random.default_rng(12)
    dt = jcfg.dt
    jf, f = _field_states(jcfg, cfg, rng)
    _same_fields(rz.apply_silver_mueller_rz(f, cfg, dt),
                 jrz.apply_silver_mueller_rz(jf, jcfg, dt), "sm")
    _same_fields(rz._sm_wall_e_fix(f, cfg, dt),
                 jrz._sm_wall_e_fix(jf, jcfg, dt), "sm_fix")


@pytest.mark.parametrize("npass", [(1, 1), (2, 1), (1, 3)])
@pytest.mark.parametrize("case", ["periodic_m3", "bounded_m2"])
def test_filter_matches_jax(case, npass):
    jcfg, cfg = _cfgs(_UNIT[case])
    rng = np.random.default_rng(10)
    for nm in ("jr", "jt", "jz", "rho"):
        arr = rng.normal(size=jrz.field_shape(jcfg, nm))
        ref = jspec.bilinear_filter_rz(jnp.asarray(arr), nm, jcfg,
                                       npass_each=npass)
        got = spec.bilinear_filter_rz(_t(arr), nm, cfg, npass_each=npass)
        close(got, np.asarray(ref), nm)
        ref = jspec.bilinear_filter_rz(jnp.asarray(arr), nm, jcfg, 2)
        got = spec.bilinear_filter_rz(_t(arr), nm, cfg, 2)
        close(got, np.asarray(ref), nm)


# ---------------------------------------------------------- whole runs
PERIODIC = ("langmuir_m1", "langmuir_m2", "langmuir_m3_dive")


@pytest.mark.parametrize("name", PERIODIC)
def test_periodic_run_matches_jax(name):
    """The periodic multi-mode FDTD step from the deck: the configuration,
    the fields (F included), the particles (theta included) and the
    checksums."""
    jsim, jfields, jspecies, jchecks = jax_run(name)
    sim = port_run(name)
    assert sim.cfg == port_config(jsim.cfg)
    assert isinstance(sim.rz, rz.RZStepper) and not sim.binned
    assert_fields(port_fields(sim), jfields)
    assert_species(port_species(sim), jspecies)
    assert_checksums(sim.checksums(), jchecks)


def test_rz_package_imports_no_jax():
    """The port's RZ sub-package imports neither JAX nor the JAX
    package."""
    for path in RZ_PACKAGE.glob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|warpx_tpu)\b", text,
                             re.M), path


def test_rz_runs_on_the_card_by_default():
    """Without a device the RZ deck goes to the card, which this machine
    lacks."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(DECKS["langmuir_m1"]), dtype=torch.float64)


def test_cli_runs_an_rz_deck(tmp_path, capsys):
    """``python -m warpx_tpu_torch <rz deck> --device cpu --checksums``."""
    from warpx_tpu_torch.__main__ import main

    deck = tmp_path / "inputs_rz"
    deck.write_text(DECKS["langmuir_m1"])
    assert main([str(deck), "--device", "cpu", "--checksums",
                 "--output-dir", str(tmp_path / "d")]) == 0
    out = capsys.readouterr().out
    checks = json.loads(out[out.index("{"):])
    assert_checksums(checks, jax_run("langmuir_m1")[3])


# ------------------------------------------------------------- refusals
_BASE = _LANGMUIR.format(steps=1, modes=2, order=1, extra="")
_BOUNDED = _UNIT["bounded_m2"]

# the JAX reader's RZ refusals (warpx_tpu/core/deck.py:1074-1230), mirrored
JAX_REFUSALS = {
    "radial PML": (_BASE.replace("boundary.field_hi = pec periodic",
                                 "boundary.field_hi = pml periodic"),
                   "RZ radial PML"),
    "ckc solver": (_BASE + "algo.maxwell_solver = ckc\n",
                   "RZ maxwell solver ckc"),
    "psatd bounded z": (_BOUNDED + "algo.maxwell_solver = psatd\n"
                        "algo.current_deposition = direct\n",
                        "RZ PSATD with bounded z"),
    "damped z face": (_BOUNDED.replace("boundary.field_lo = none pec",
                                       "boundary.field_lo = none damped"),
                      "RZ z boundary 'damped'"),
    "J linear": (DECKS["psatd"] + "psatd.J_in_time = linear\n",
                 "J_in_time=linear"),
    "time averaging": (DECKS["psatd"] + "psatd.do_time_averaging = 1\n",
                       "RZ PSATD time averaging"),
    "multi-J": (DECKS["psatd"] + "warpx.do_multi_J = 1\n",
                "RZ multi-J PSATD"),
    "psatd cleaning": (DECKS["psatd"] + "warpx.do_dive_cleaning = 1\n",
                       "RZ PSATD divergence cleaning"),
    "psatd esirkepov": (DECKS["psatd"].replace(
        "algo.current_deposition = direct",
        "algo.current_deposition = esirkepov"),
        "RZ PSATD with esirkepov deposition"),
    "window off z": (_BOUNDED.replace("warpx.moving_window_dir = z",
                                      "warpx.moving_window_dir = x"),
                     "RZ moving window must be along z"),
}


@pytest.mark.parametrize("case", sorted(JAX_REFUSALS))
def test_jax_refusals_are_mirrored(case):
    text, msg = JAX_REFUSALS[case]
    with pytest.raises(NotImplementedError, match=re.escape(msg)):
        jax_config_from_deck(JDeck.from_string(text))
    with pytest.raises(NotImplementedError, match=re.escape(msg)):
        config_from_deck(Deck.from_string(text))


# what the JAX package's RZ steps drop or run differently: refused, naming
# ROADMAP.md Queue C
PORT_REFUSALS = {
    "vay deposition under FDTD": _BASE + "algo.current_deposition = vay\n",
    "momentum-conserving gather":
        _BASE + "algo.field_gathering = momentum-conserving\n",
    "collocated FDTD": _BASE + "warpx.grid_type = collocated\n",
    "electrostatic": _BASE + "warpx.do_electrostatic = labframe\n",
    "collisions": _BASE + "collisions.collision_names = c1\n"
                          "c1.species = electrons electrons\n",
    "ionization": _BASE + "electrons.do_field_ionization = 1\n",
    "do_not_push": _BASE + "electrons.do_not_push = 1\n",
    "thermal wall u_th": _BASE + "boundary.electrons.u_th = 0.1\n",
    "num_particles_per_cell": _BASE + "electrons.num_particles_per_cell = 4\n",
    "single particle style": _BASE.replace(
        '"NUniformPerCell"', '"SingleParticle"'),
    "mesh refinement": _BASE + "amr.max_level = 1\n",
    "external particle field": _BASE + (
        "particles.E_ext_particle_init_style = constant\n"
        "particles.E_external_particle = 1. 0. 0.\n"),
    "reflecting r wall": _BOUNDED + "boundary.particle_hi = reflecting "
                                    "absorbing\n",
    "psatd antenna": DECKS["psatd"] + (
        "lasers.names = l1\nl1.position = 0. 0. 0.\nl1.e_max = 1.e9\n"),
    "openPMD output": _BASE + ("diagnostics.diags_names = d1\n"
                               "d1.intervals = 1\nd1.format = openpmd\n"),
    "radiation reaction": _BASE + "electrons.do_classical_radiation_"
                                  "reaction = 1\n",
}


@pytest.mark.parametrize("case", sorted(PORT_REFUSALS))
def test_dropped_parts_are_refused(case):
    with pytest.raises(NotImplementedError, match="Queue C"):
        config_from_deck(Deck.from_string(PORT_REFUSALS[case]))
