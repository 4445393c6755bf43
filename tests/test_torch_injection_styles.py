"""Injection styles and momentum distributions of the port
(``warpx_tpu_torch/core/injection.py``, ``core/deck.py``) against the JAX
package's ``inject_species``, CPU, float64.

``singleparticle``, ``multipleparticles`` and ``external_file`` (an
openPMD file written here as ``tests/test_from_file.py`` writes it, with
its bounds and z_shift), and the Maxwell-Boltzmann, Maxwell-Juttner,
uniform and parsed-Gaussian momenta (with parsed temperature and drift)
give bit-identical particles from the same ``np.random.Generator``; the
deck reader builds the JAX reader's species (the file's charge and mass
included); the decks run through ``Simulation.from_deck`` within 1e-9 of
the JAX package, and the CLI prints the in-process run's checksums for
them and for decks of plane emission, order-4 shapes and a lasy laser; the statistics of
``tests/test_from_file.py::test_parsed_theta_beta_uniform_injectors`` hold
and Maxwell-Juttner refuses theta < 0.1.
"""

import json
import re

import numpy as np
import pytest
import torch

from warpx_tpu.core.deck import config_from_deck as jconfig_from_deck
from warpx_tpu.core.injection import inject_species as jinject_species
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.__main__ import main as cli_main
from warpx_tpu_torch.core import injection
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.utils.parser import Deck

from .test_from_file import DECK_INJ, _write_particle_file
from .test_laser_from_file import E_MAX, WAVELENGTH, _write_lasy_cartesian
from .test_torch_flux_injection import FLUX_3D
from .test_torch_laser_file import _DECK as LASY_DECK
from .test_torch_bounded_util import port_config
from .test_torch_draws_util import (assert_checksums_close,
                                    assert_runs_close, jax_run, port_run)

torch.set_num_threads(1)

C = 299792458.0
_HEAD = """
max_step = 3
amr.n_cell = {n}
geometry.dims = {dims}
geometry.prob_lo = {lo}
geometry.prob_hi = {hi}
algo.particle_shape = 1
particles.species_names = {names}
"""

_SPECIES = {
    "single": """
single.species_type = electron
single.injection_style = SingleParticle
single.single_particle_pos = 1.e-6 -2.e-6 3.e-6
single.single_particle_u = 0.1 -0.2 0.5
single.single_particle_weight = 1.e10
""",
    "multi": """
multi.species_type = positron
multi.injection_style = MultipleParticles
multi.multiple_particles_pos_x = -3.e-6 1.e-6 4.e-6
multi.multiple_particles_pos_y = 0. 2.e-6 -1.e-6
multi.multiple_particles_pos_z = 5.e-6 -5.e-6 0.
multi.multiple_particles_ux = 0.3 0. -0.1
multi.multiple_particles_uy = 0. 0.2 0.
multi.multiple_particles_uz = 0.1 0.1 0.7
multi.multiple_particles_weight = 1.e9 2.e9 3.e9
""",
    "mb": """
mb.species_type = electron
mb.injection_style = NRandomPerCell
mb.num_particles_per_cell = 2
mb.profile = constant
mb.density = 1.e24
mb.momentum_distribution_type = maxwell_boltzmann
mb.theta = 1.e-3
mb.beta = 0.2
mb.bulk_vel_dir = -y
""",
    "mj": """
mj.species_type = electron
mj.injection_style = NUniformPerCell
mj.num_particles_per_cell_each_dim = 1 1 1
mj.profile = constant
mj.density = 1.e24
mj.momentum_distribution_type = maxwell_juttner
mj.theta = 0.5
mj.beta = 0.3
mj.bulk_vel_dir = z
""",
    "un": """
un.species_type = proton
un.injection_style = NUniformPerCell
un.num_particles_per_cell_each_dim = 1 1 1
un.profile = constant
un.density = 1.e24
un.momentum_distribution_type = uniform
un.ux_min = -0.002
un.ux_max = 0.003
un.uz_min = 0.01
un.uz_max = 0.011
""",
    "gp": """
gp.species_type = electron
gp.injection_style = NUniformPerCell
gp.num_particles_per_cell_each_dim = 1 1 1
gp.profile = constant
gp.density = 1.e24
gp.momentum_distribution_type = gaussian_parse_momentum_function
gp.momentum_function_ux_m(x,y,z) = "1.e3*z"
gp.momentum_function_ux_th(x,y,z) = "0.01 + 1.e3*abs(x)"
gp.momentum_function_uz_th(x,y,z) = "0.02"
""",
    "tp": """
tp.species_type = electron
tp.injection_style = NUniformPerCell
tp.num_particles_per_cell_each_dim = 1 1 1
tp.profile = constant
tp.density = 1.e24
tp.momentum_distribution_type = maxwell_juttner
tp.theta_distribution_type = parser
tp.theta_function(x,y,z) = "0.2 + heaviside(x,0)"
""",
    "bp": """
bp.species_type = electron
bp.injection_style = NUniformPerCell
bp.num_particles_per_cell_each_dim = 1 1 1
bp.profile = constant
bp.density = 1.e24
bp.momentum_distribution_type = maxwell_boltzmann
bp.theta = 1.e-4
bp.beta_distribution_type = parser
bp.beta_function(x,y,z) = "-0.2 + 0.4 * heaviside(z,0)"
bp.bulk_vel_dir = -y
""",
    # the predefined parabolic channel, read as the parsed density the
    # JAX reader makes of it
    "pc": """
pc.species_type = electron
pc.injection_style = NUniformPerCell
pc.num_particles_per_cell_each_dim = 1 1 1
pc.profile = predefined
pc.predefined_profile_name = parabolic_channel
pc.predefined_profile_params = -8.e-6 4.e-6 6.e-6 4.e-6 20.e-6 1.e24
pc.momentum_distribution_type = at_rest
""",
    # a Gaussian beam on the periodic domain: ``inject_species`` gives it
    # the JAX package's empty container, ``Simulation.init`` the beam
    "beam": """
beam.species_type = electron
beam.injection_style = gaussian_beam
beam.x_rms = 1.e-6
beam.y_rms = 1.e-6
beam.z_rms = 2.e-6
beam.z_m = 1.e-6
beam.npart = 50
beam.q_tot = -1.e-13
beam.momentum_distribution_type = gaussian
beam.uz_m = 10.
beam.ux_th = 0.1
beam.uy_th = 0.1
beam.uz_th = 1.
""",
}


def _deck(dims, names, n=8):
    ext = 8e-6
    head = _HEAD.format(n=" ".join([str(n)] * dims), dims=dims,
                        lo=" ".join([f"{-ext}"] * dims),
                        hi=" ".join([f"{ext}"] * dims),
                        names=" ".join(names))
    return head + "".join(_SPECIES[nm] for nm in names)


def _cols(ps, names):
    return {k: np.asarray(getattr(ps, k)) for k in ("w", "ux", "uy", "uz",
                                                   "alive") + names}


@pytest.mark.parametrize("dims", [3, 2])
def test_inject_species_bitwise(dims):
    """Every style and momentum distribution, species by species, from one
    generator in order: the JAX package's particles, bit for bit."""
    text = _deck(dims, list(_SPECIES))
    jcfg = jconfig_from_deck(JDeck.from_string(text))
    cfg = config_from_deck(Deck.from_string(text))
    assert cfg == port_config(jcfg)
    names = ("x", "z") if dims == 2 else ("x", "y", "z")
    jrng, rng = np.random.default_rng(3), np.random.default_rng(3)
    for jsp, sp in zip(jcfg.species, cfg.species):
        ref = _cols(jinject_species(jsp, jcfg.geometry, np.float64, jrng),
                    names)
        got = _cols(injection.inject_species(
            sp, cfg.geometry, rng, dtype=torch.float64, device="cpu"),
            names)
        for k, a in ref.items():
            assert got[k].dtype == a.dtype, (sp.name, k)
            np.testing.assert_array_equal(got[k], a, err_msg=f"{sp.name} {k}")
    # the generators were drawn alike to the end
    assert jrng.random() == rng.random()


_ROWS_CASES = {
    "uniform_at_rest_bounded": dict(
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=(2, 3, 2),
        momentum_distribution="at_rest",
        bounds_lo=(-0.5e-6, -1e-6, -0.2e-6),
        bounds_hi=(0.6e-6, 1e-6, float("inf"))),
    "random_gaussian": dict(
        injection_style="nrandompercell", num_particles_per_cell=5,
        momentum_distribution="gaussian", ux=0.1, uz=0.3, ux_th=0.01,
        uy_th=0.02, uz_th=0.03),
    "uniform_boltzmann_bounded": dict(
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=(1, 2, 2),
        momentum_distribution="maxwell_boltzmann", theta=0.01,
        bounds_lo=(0.0, -2e-6, -2e-6), bounds_hi=(2e-6, 0.5e-6, 2e-6)),
    "uniform_constant": dict(
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=(2, 1, 1),
        momentum_distribution="constant", uz=2.0),
}


@pytest.mark.parametrize("dims", [3, 2])
@pytest.mark.parametrize("gamma_boost", [1.0, 10.0])
@pytest.mark.parametrize("case", list(_ROWS_CASES))
def test_constant_density_rows_match_the_general_rows(case, gamma_boost,
                                                      dims):
    """A constant density whose momenta do not depend on the position is
    injected at its kept rows only (``_constant_density_rows``): the same
    rows, bit for bit, and the same draws as the general path over every
    candidate (``_rows``), boosted or not, in float32 and float64."""
    from warpx_tpu_torch.core.config import SpeciesConfig
    from warpx_tpu_torch.core.grid import Geometry

    kw = dict(_ROWS_CASES[case])
    if dims == 2:
        for k in ("bounds_lo", "bounds_hi"):
            if k in kw:
                kw[k] = (kw[k][0], kw[k][2])
    sp = SpeciesConfig(name="e", charge=-1.6e-19, mass=9.1e-31,
                       species_type="electron", profile="constant",
                       density=2e23, **kw)
    geom = Geometry(ndim=dims, n_cell=(12, 10, 14)[3 - dims:],
                    prob_lo=(-1e-6, -2e-6, -1.5e-6)[3 - dims:],
                    prob_hi=(1e-6, 2e-6, 1.5e-6)[3 - dims:],
                    periodic=(False,) * dims)
    assert not injection._momenta_use_positions(sp)
    for dtype in (np.float32, np.float64):
        got_rng, ref_rng = np.random.default_rng(5), np.random.default_rng(5)
        unit = injection._regular_unit_positions(
            sp.num_particles_per_cell_each_dim, dims) \
            if sp.injection_style == "nuniformpercell" \
            else ref_rng.random((sp.num_particles_per_cell, 3))
        if sp.injection_style == "nrandompercell":
            got_rng.random((sp.num_particles_per_cell, 3))
        got = injection._constant_density_rows(sp, geom, unit, got_rng,
                                               dtype, gamma_boost)
        ref = injection._rows(sp, geom, unit, ref_rng, dtype, gamma_boost)
        assert set(got) == set(ref)
        assert 0 < ref["w"].shape[0]
        for k, a in ref.items():
            assert got[k].dtype == a.dtype, k
            np.testing.assert_array_equal(got[k], a, err_msg=k)
        assert got_rng.random() == ref_rng.random()


@pytest.mark.parametrize("dims", [3, 2])
def test_injection_deck_runs_as_jax(dims):
    """The species of every style, pushed 3 steps per particle through
    ``Simulation.from_deck`` in both packages: species and fields within
    1e-9, checksums within 1e-9."""
    text = _deck(dims, list(_SPECIES), n=8 if dims == 3 else 16) + (
        "tpu.tiled_particles = off\n")
    j = jax_run(text)
    p = port_run(text, replay=False)
    assert_runs_close(p, j, 1e-9)
    assert_checksums_close(p.checksums(), j.checksums(), 1e-9)


def test_injection_from_openpmd_file(tmp_path):
    """An openPMD file of one species (position + positionOffset with their
    unitSI, z_shift, momentum / mass, weights): the deck reader takes the
    charge and mass from the file as the JAX reader does, the particles
    equal the JAX package's and the file's, and one step of the deck runs
    as the JAX package runs it."""
    path = str(tmp_path / "beam.h5")
    x, y, z, vux, vuy, vuz, w, mass = _write_particle_file(path)
    text = DECK_INJ.format(path=path, z_shift=2.0e-6) + (
        "tpu.tiled_particles = off\n")
    jcfg = jconfig_from_deck(JDeck.from_string(text))
    cfg = config_from_deck(Deck.from_string(text))
    assert cfg == port_config(jcfg)
    sp = cfg.species[0]
    assert sp.mass == pytest.approx(mass, rel=1e-12)
    assert sp.charge == pytest.approx(-1.602176634e-19, rel=1e-12)
    ref = _cols(jinject_species(jcfg.species[0], jcfg.geometry, np.float64,
                                np.random.default_rng(0)), ("x", "y", "z"))
    got = _cols(injection.inject_species(
        sp, cfg.geometry, np.random.default_rng(0), dtype=torch.float64,
        device="cpu"), ("x", "y", "z"))
    for k, a in ref.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    assert got["alive"].sum() == len(x)
    order, ref_order = np.argsort(got["x"]), np.argsort(x)
    for g, r in ((got["x"][order], x[ref_order]),
                 (got["z"][order], z[ref_order] + 2.0e-6),
                 (got["ux"][order], vux[ref_order]),
                 (got["w"][order], w[ref_order])):
        np.testing.assert_allclose(g, r, rtol=1e-12)
    j = jax_run(text)
    p = port_run(text, replay=False)
    assert_runs_close(p, j, 1e-9)


def test_injection_from_file_bounds(tmp_path):
    """Particles outside the species bounds are dead slots with zero
    weight (the insideBounds filter), as in the JAX package."""
    path = str(tmp_path / "beam.h5")
    x, y, z, *_ = _write_particle_file(path)
    text = DECK_INJ.format(path=path, z_shift=0.0) + "beam.zmin = 0.0\n"
    cfg = config_from_deck(Deck.from_string(text))
    jcfg = jconfig_from_deck(JDeck.from_string(text))
    got = _cols(injection.inject_species(
        cfg.species[0], cfg.geometry, np.random.default_rng(0),
        dtype=torch.float64, device="cpu"), ("x", "y", "z"))
    ref = _cols(jinject_species(jcfg.species[0], jcfg.geometry, np.float64,
                                np.random.default_rng(0)), ("x", "y", "z"))
    for k, a in ref.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    assert int(got["alive"].sum()) == int((z >= 0.0).sum())
    assert (got["w"][~got["alive"]] == 0).all()


def test_parsed_theta_beta_uniform_injectors():
    """``tests/test_from_file.py::test_parsed_theta_beta_uniform_injectors``
    on the port: a parsed temperature, a parsed drift along -y, the
    uniform cuboid and a zero-spread parsed Gaussian."""
    deck = Deck.from_string("""
max_step = 1
amr.n_cell = 8 8 8
geometry.dims = 3
geometry.prob_lo = -1. -1. -1.
geometry.prob_hi = 1. 1. 1.
algo.particle_shape = 1
particles.species_names = mj vp un gp
mj.charge = -q_e
mj.mass = m_e
mj.injection_style = NRandomPerCell
mj.num_particles_per_cell = 2
mj.profile = constant
mj.density = 1.0e21
mj.momentum_distribution_type = maxwell_juttner
mj.theta_distribution_type = parser
mj.theta_function(x,y,z) = "1.0 + heaviside(x,0)"
vp.charge = -q_e
vp.mass = m_e
vp.injection_style = NRandomPerCell
vp.num_particles_per_cell = 2
vp.profile = constant
vp.density = 1.0e21
vp.momentum_distribution_type = maxwell_boltzmann
vp.theta = 1e-9
vp.beta_distribution_type = parser
vp.beta_function(x,y,z) = "-0.2 + 0.4 * heaviside(z,0)"
vp.bulk_vel_dir = -y
un.charge = q_e
un.mass = m_e
un.injection_style = NRandomPerCell
un.num_particles_per_cell = 2
un.profile = constant
un.density = 1.0e21
un.momentum_distribution_type = uniform
un.ux_min = -0.2
un.ux_max = 0.3
un.uz_min = 10.
un.uz_max = 11.
gp.charge = -q_e
gp.mass = m_e
gp.injection_style = NRandomPerCell
gp.num_particles_per_cell = 2
gp.profile = constant
gp.density = 1.0e21
gp.momentum_distribution_type = gaussian_parse_momentum_function
gp.momentum_function_ux_m(x,y,z) = 0.1*z
gp.momentum_function_ux_th(x,y,z) = 0.0
""")
    cfg = config_from_deck(deck)
    rng = np.random.default_rng(3)
    sps = {s.name: s for s in cfg.species}

    def inject(nm):
        return injection.inject_species(sps[nm], cfg.geometry, rng,
                                        dtype=torch.float64, device="cpu")

    ps = inject("mj")
    x = ps.x.numpy()
    u2 = (ps.ux.numpy() ** 2 + ps.uy.numpy() ** 2 + ps.uz.numpy() ** 2) / C**2
    assert u2[x > 0].mean() > 1.5 * u2[x < 0].mean()
    ps = inject("vp")
    z, uy = ps.z.numpy(), ps.uy.numpy() / C
    assert uy[z < 0].mean() > 0.15 and uy[z > 0].mean() < -0.15
    ps = inject("un")
    ux, uz = ps.ux.numpy() / C, ps.uz.numpy() / C
    assert -0.2 <= ux.min() and ux.max() <= 0.3
    assert 10.0 <= uz.min() and uz.max() <= 11.0
    ps = inject("gp")
    np.testing.assert_allclose(ps.ux.numpy(), 0.1 * ps.z.numpy() * C,
                               rtol=1e-12)


def test_juttner_low_theta_aborts():
    """theta < 0.1 raises as the reference aborts (InjectorMomentum.H:313)
    and the JAX package raises, before any draw."""
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="Maxwell-Juttner"):
        injection._sample_juttner(rng, 10, 0.01, 0.0, 0, np.float64)
    assert rng.random() == np.random.default_rng(0).random()


def _cli_deck(kind, tmp_path):
    if kind == "styles":
        return _deck(3, list(_SPECIES))
    if kind == "flux_ext_grid":
        return FLUX_3D
    if kind == "order4":
        return _deck(2, ["mb", "un"], n=16) + "algo.particle_shape = 4\n"
    fname = _write_lasy_cartesian(str(tmp_path / "gauss2d.h5"))
    return LASY_DECK.format(emax=E_MAX, wl=WAVELENGTH) + (
        f"lasy.profile = from_file\nlasy.lasy_file_name = {fname}\n")


@pytest.mark.parametrize("kind", ["styles", "flux_ext_grid", "order4",
                                  "lasy"])
def test_cli_runs_an_injection_deck(tmp_path, capsys, kind):
    """The CLI on the CPU runs a deck of every style and distribution, of
    plane emission under an external grid field, of order-4 shapes and of
    a lasy laser, and prints the checksums of the in-process run."""
    deck = tmp_path / "inputs"
    deck.write_text(_cli_deck(kind, tmp_path))
    assert cli_main([str(deck), "--device", "cpu", "--steps", "2",
                     "--checksums"]) == 0
    out, _ = capsys.readouterr()
    printed = json.loads(out[out.index("\n") + 1:])
    sim = port_run(deck.read_text(), steps=2, replay=False)
    assert printed == json.loads(json.dumps(sim.checksums()))


@pytest.mark.parametrize("extra,item", [
    # runtime attributes and the window's step range are read since Queue
    # A 11.6 (tests/test_torch_attributes.py): an attribute's expression
    # without its declaration is read by neither reader, and a step range
    # the JAX package does not run is refused (the cases keep their ids)
    pytest.param("single.attribute.orig_z(x,y,z,ux,uy,uz,t) = z", "Queue C",
                 id="single.addRealAttributes = orig_z\n"
                    "single.attribute.orig_z(x,y,z,ux,uy,uz,t) = z-"
                    "Queue A 11.6"),
    pytest.param("warpx.start_moving_window_step = 3", "Queue C",
                 id="warpx.start_moving_window_step = 3-Queue A 11.6"),
    # the thermal walls' spread and the scraping buffers are read since
    # Queue A 11.4 (tests/test_torch_particle_walls.py): the spread of a
    # species the deck lacks and a face that is none are read by neither
    # reader, and a parsed-field laser keeps the JAX reader's refusal (the
    # cases keep their ids)
    pytest.param("boundary.nosuch.u_th = 0.1", "Queue C",
                 id="boundary.single.u_th = 0.1-Queue A 11.4"),
    pytest.param("single.save_particles_at_zmid = 1", "Queue C",
                 id="single.save_particles_at_zlo = 1-Queue A 11.4"),
    # RZ's keys are read since Queue A 12.3 (tests/test_torch_rz.py), on
    # RZ decks only: on a Cartesian deck neither reader's path uses them
    # (the case keeps its id)
    pytest.param("single.random_theta = 0", "Queue C",
                 id="single.random_theta = 0-Queue A 12"),
    # warpx.poisson_solver is read since Queue A 11.3's first half, the
    # embedded boundary since its second half (the case keeps its id)
    pytest.param("warpx.eb_implicit_function = x\n"
                 "single.save_particles_at_eb = 1\n"
                 "lasers.names = l1\nl1.profile = parse_field", "Queue C",
                 id="warpx.poisson_solver = fft-Queue A 11.3"),
    ("warpx.do_pml_j_damping = 1", "Queue C"),
    ("single.frobnicate = 1", "Queue C"),
    # read for the external_file style only, as in the JAX reader
    ("single.injection_file = beam.h5", "Queue C"),
])
def test_unread_keys_name_their_item(extra, item):
    """A key the JAX reader reads that the port lacks names its ROADMAP.md
    item; a key neither reader reads names Queue C."""
    text = _deck(3, ["single"]) + extra + "\n"
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md {re.escape(item)}\)"):
        config_from_deck(Deck.from_string(text))
