"""Mesh refinement on the periodic step (``warpx_tpu_torch/core/mr.py``)
against the JAX package's ``warpx_tpu/core/mr.py`` on the CPU in float64.

The patch's index tables, its split-field PML advance on random parts, the
aux interpolation, the average-down and the lev=1 output on the same
inputs (made by numpy from a seed); then whole runs of decks built from
strings (2D with the filter, subcycled, the NCI corrector under
subcycling, momentum-conserving gathering, CKC without the filter, 3D):
fields, patch state, particles and the lev=0 and lev=1 checksums within
1e-9; a checkpoint that restarts onto the same trajectory; and every
refusal of the JAX reader mirrored.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core import mr as jmr
from warpx_tpu.core.config import SimConfig as JSimConfig
from warpx_tpu.core.deck import config_from_deck as jax_config_from_deck
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.grid import yee_staggering
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core import mr
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.state import state_from_numpy, state_to_numpy
from warpx_tpu_torch.io.checkpoint import load_checkpoint
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import (assert_checksums, jax_state_numpy,
                                      port_config)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

RTOL = 1e-9
COMPS = ("Ex", "Ey", "Ez", "Bx", "By", "Bz")


def close(got, ref, what, rtol=RTOL):
    """Within ``rtol`` of the reference's largest magnitude."""
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max() if ref.size else 0.0
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= rtol * scale + 1e-300, (what, err, scale)


# ------------------------------------------------------------ the layout
def _cfgs(ndim, ratio=2, lo=-8.0, hi=8.0, n=16, **over):
    geom = JGeometry(ndim=ndim, n_cell=(n,) * ndim,
                     prob_lo=(-16.0,) * ndim, prob_hi=(16.0,) * ndim,
                     periodic=(True,) * ndim)
    base = dict(geometry=geom, max_step=1, dt=1e-9, species=(),
                max_level=1, ref_ratio=(ratio,) * ndim,
                fine_tag_lo=(lo,) * ndim, fine_tag_hi=(hi,) * ndim,
                pml_ncell=4)
    base.update(over)
    jcfg = JSimConfig(**base)
    return jcfg, port_config(jcfg)


LAYOUTS = {
    "2d": dict(ndim=2),
    "3d": dict(ndim=3),
    "2d_ratio4": dict(ndim=2, ratio=4),
    # the tag box snaps out to the blocking factor
    "2d_blocked": dict(ndim=2, lo=-7.0, hi=5.0),
    "2d_whole_domain": dict(ndim=2, lo=-16.0, hi=16.0),
}


def _layouts(case):
    jcfg, cfg = _cfgs(**LAYOUTS[case])
    stag = yee_staggering(jcfg.geometry.ndim)
    return jmr.MRLayout(jcfg, stag), mr.MRLayout(cfg, stag), stag


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_layout_matches_jax(case):
    jl, pl, stag = _layouts(case)
    for name in ("rv", "i0", "i1", "nc", "nf", "npml_f", "npml_c",
                 "n_fext", "n_cext", "f_off", "c_off", "spanning",
                 "full_domain", "gather_buf", "dep_buf", "patch_lo",
                 "patch_hi", "dxf"):
        assert getattr(pl, name) == getattr(jl, name), name
    for g in ("geom_f_ext", "geom_c_ext"):
        jg, pg = getattr(jl, g), getattr(pl, g)
        assert (pg.n_cell, pg.prob_lo, pg.prob_hi) == (
            jg.n_cell, jg.prob_lo, jg.prob_hi), g
    for a, b in zip(pl.window_indices(), jl.window_indices()):
        np.testing.assert_array_equal(a, b)
    for comp, flags in stag.items():
        for (pi, pw, pv), (ji, jw, jv) in zip(
                pl.coarsen_tables(flags, pl.n_fext),
                jl.coarsen_tables(flags, jl.n_fext)):
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pw, jw)
            assert (pv is None) == (jv is None)
            if pv is not None:
                np.testing.assert_array_equal(pv, jv)
        for (pi, pw), (ji, jw) in zip(pl.interp_tables(flags),
                                      jl.interp_tables(flags)):
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pw, jw)
        for grid in ("c", "f"):
            assert pl.patch_slices(flags, grid) == jl.patch_slices(flags,
                                                                   grid)


@pytest.mark.parametrize("fine", [True, False])
@pytest.mark.parametrize("case", ["2d", "3d"])
def test_damping_tables_match_jax(case, fine):
    jl, pl, stag = _layouts(case)
    ref = jl.damping_tables(stag, 1.5e-9, 3e-9, fine, jnp.float64)
    got = pl.damping_tables(stag, 1.5e-9, 3e-9, fine, torch.float64, "cpu")
    assert set(got) == set(ref)
    for key in ref:
        for g, r in zip(got[key], ref[key]):
            close(g, np.asarray(r), key, rtol=1e-14)


def test_fine_mask_matches_jax():
    jl, pl, _ = _layouts("2d")
    rng = np.random.default_rng(3)
    pos = [rng.uniform(-16.0, 16.0, 4000) for _ in range(2)]
    # particles on the buffers' edges, where a floor decides the level
    pos[0][:200] = jl.patch_lo[0] + jl.dxf[0] * rng.integers(0, 33, 200)
    for nbuf in (0, 2, 3):
        ref = np.asarray(jl.fine_mask([jnp.asarray(p) for p in pos], nbuf))
        got = pl.fine_mask([torch.from_numpy(p) for p in pos], nbuf)
        np.testing.assert_array_equal(got.numpy(), ref)


def _random_parts(layout, fine, rng):
    shape = layout.n_fext if fine else layout.n_cext
    return {k: rng.normal(size=shape) * (1e-8 if k[0] == "B" else 1.0)
            for k in jmr._part_keys(layout)}


@pytest.mark.parametrize("algo", ["yee", "ckc"])
@pytest.mark.parametrize("fine", [True, False])
@pytest.mark.parametrize("case", ["2d", "3d"])
def test_patch_advance_matches_jax(case, fine, algo):
    """b_step, e_step and b_step on random split parts and currents."""
    jl, pl, stag = _layouts(case)
    rng = np.random.default_rng(11)
    parts = _random_parts(jl, fine, rng)
    shape = jl.n_fext if fine else jl.n_cext
    j3 = [rng.normal(size=shape) * 1e10 for _ in range(3)]
    jb, je = jmr.make_patch_advance(jl, stag, algo, 2e-17, 4e-17, fine,
                                    jnp.float64)
    pb, pe = mr.make_patch_advance(pl, stag, algo, 2e-17, 4e-17, fine,
                                   torch.float64, "cpu")
    ref = jb(je(jb({k: jnp.asarray(v) for k, v in parts.items()}),
                tuple(jnp.asarray(a) for a in j3)))
    got = pb(pe(pb({k: torch.from_numpy(v) for k, v in parts.items()}),
                tuple(torch.from_numpy(a) for a in j3)))
    assert set(got) == set(ref) == set(mr.part_keys(pl))
    for k in ref:
        close(got[k], np.asarray(ref[k]), k, rtol=1e-12)


def _random_aux(layout, rng):
    aux = {}
    for fine, tag in ((True, "f"), (False, "c")):
        for k, v in _random_parts(layout, fine, rng).items():
            aux[f"mr:{tag}:{k}"] = v
    for jn in ("jx", "jy", "jz"):
        aux[f"mr:j:{jn}"] = rng.normal(size=layout.n_fext) * 1e10
    return aux


@pytest.mark.parametrize("case", ["2d", "3d", "2d_ratio4", "2d_whole_domain"])
def test_compute_aux1_matches_jax(case):
    jl, pl, stag = _layouts(case)
    rng = np.random.default_rng(5)
    farr0 = {nm: rng.normal(size=jl.n0) * (1e-8 if nm[0] == "B" else 1.0)
             for nm in COMPS}
    aux = _random_aux(jl, rng)
    ref = jmr.compute_aux1({k: jnp.asarray(v) for k, v in farr0.items()},
                           {k: jnp.asarray(v) for k, v in aux.items()}, jl,
                           stag)
    got = mr.compute_aux1({k: torch.from_numpy(v) for k, v in farr0.items()},
                          {k: torch.from_numpy(v) for k, v in aux.items()},
                          pl, stag)
    for nm in COMPS:
        close(got[nm], np.asarray(ref[nm]), nm, rtol=1e-12)


@pytest.mark.parametrize("comp", ["jx", "jy", "jz", "Ex", "Bz"])
@pytest.mark.parametrize("case", ["2d", "3d", "2d_ratio4", "2d_whole_domain"])
def test_coarsen_field_matches_jax(case, comp):
    jl, pl, stag = _layouts(case)
    arr = np.random.default_rng(9).normal(size=jl.n_fext)
    ref = jmr.coarsen_field(jnp.asarray(arr), stag[comp], jl)
    got = mr.coarsen_field(torch.from_numpy(arr), stag[comp], pl)
    close(got, np.asarray(ref), comp, rtol=1e-12)


# ------------------------------------------------------------ whole runs
BASE = """
max_step = {steps}
amr.n_cell = {cells}
amr.max_level = 1
amr.ref_ratio = 2
geometry.dims = {dims}
geometry.prob_lo = {lo}
geometry.prob_hi = {hi}
warpx.fine_tag_lo = {tag_lo}
warpx.fine_tag_hi = {tag_hi}
warpx.cfl = 0.9
warpx.use_filter = 1
algo.particle_shape = {order}
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 2 2 2
electrons.profile = constant
electrons.density = 1.e25
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.05
electrons.uy_th = 0.05
electrons.uz_th = 0.05
"""


def _deck2d(order=1, steps=4, extra=""):
    return BASE.format(steps=steps, cells="32 32", dims=2,
                       lo="-20.e-6 -20.e-6", hi="20.e-6 20.e-6",
                       tag_lo="-8.e-6 -8.e-6", tag_hi="8.e-6 8.e-6",
                       order=order) + extra


DECKS = {
    "2d_filter": _deck2d(),
    "2d_subcycled": _deck2d(extra="warpx.do_subcycling = 1\n"),
    "2d_nci_subcycled": _deck2d(order=3, steps=3, extra=(
        "warpx.do_subcycling = 1\nwarpx.use_fdtd_nci_corr = 1\n")),
    "2d_momentum_conserving": _deck2d(order=2, extra=(
        "algo.field_gathering = momentum-conserving\n")),
    "2d_ckc_nofilter": _deck2d(order=2, extra=(
        "algo.maxwell_solver = ckc\nwarpx.use_filter = 0\n"
        "warpx.n_field_gather_buffer = 2\n"
        "warpx.n_current_deposition_buffer = 1\n")),
    "3d": BASE.format(steps=3, cells="16 16 16", dims=3,
                      lo="-8.e-6 -8.e-6 -8.e-6", hi="8.e-6 8.e-6 8.e-6",
                      tag_lo="-4.e-6 -4.e-6 -4.e-6",
                      tag_hi="4.e-6 4.e-6 4.e-6", order=1).replace(
        "num_particles_per_cell_each_dim = 2 2 2",
        "num_particles_per_cell_each_dim = 1 1 1"),
}


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """The JAX package's run of a deck: (its state as numpy, checksums)."""
    sim = JSimulation(jax_config_from_deck(JDeck.from_string(DECKS[name])))
    sim.init()
    sim.evolve()
    return sim, jax_state_numpy(sim.state), sim.checksums()


@functools.lru_cache(maxsize=None)
def port_run(name):
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(DECKS[name]), dtype=torch.float64, device="cpu")
    sim.init()
    sim.evolve()
    return sim


@pytest.mark.parametrize("name", sorted(DECKS))
def test_config_and_path_match_jax(name):
    """The deck readers agree (dt from the finest level, subcycled dt twice
    that) and the run takes the MR step, per particle."""
    jsim = jax_run(name)[0]
    sim = port_run(name)
    assert sim.cfg == port_config(jsim.cfg)
    assert sim.mr_step is not None and not sim.binned
    assert not sim.is_bounded
    assert sim.mr_layout.nf == jsim.mr_layout.nf


@pytest.mark.parametrize("name", sorted(DECKS))
def test_checksums_match_jax(name):
    ref = jax_run(name)[2]
    got = port_run(name).checksums()
    assert {"lev=0", "lev=1", "electrons"} <= set(ref)
    assert_checksums(ref, got)


@pytest.mark.parametrize("name", sorted(DECKS))
def test_state_matches_jax(name):
    """Every field, patch array and particle array within 1e-9 of its
    largest magnitude."""
    ref = jax_run(name)[1]
    got = state_to_numpy(port_run(name).state)
    for nm, a in ref["fields"].items():
        close(got["fields"][nm], a, nm)
    keys = [k for k in ref["aux"] if k.startswith("mr:")]
    assert set(keys) == {k for k in got["aux"] if k.startswith("mr:")}
    for k in keys:
        close(got["aux"][k], ref["aux"][k], k)
    for k, a in ref["species"]["electrons"].items():
        if a is not None:
            close(got["species"]["electrons"][k], a, k)


@pytest.mark.parametrize("name", ["2d_filter", "3d"])
def test_mr_output_fields_match_jax(name):
    """lev=1's covering grid of the JAX run's end state, each component."""
    jsim, data, _ = jax_run(name)
    ref = jmr.mr_output_fields(jsim.state, jsim.cfg, jsim.staggering,
                               jsim.mr_layout)
    state = state_from_numpy(data, torch.float64, "cpu")
    sim = port_run(name)
    got = mr.mr_output_fields(state, sim.cfg, sim.staggering, sim.mr_layout)
    assert list(got) == list(ref)
    for nm in ref:
        close(got[nm], np.asarray(ref[nm]), nm, rtol=1e-12)


RESTART = _deck2d(steps=6, extra=(
    "warpx.do_subcycling = 1\n"
    "diagnostics.diags_names = chk\nchk.format = checkpoint\n"
    "chk.intervals = 3:3\n"))


def test_restart_is_bitwise(tmp_path):
    """A subcycled MR run's checkpoint at step 3 restarts onto the
    uninterrupted run's trajectory bit for bit, patch state included."""
    kw = dict(dtype=torch.float64, device="cpu")
    full = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(RESTART), output_dir=str(tmp_path / "a"), **kw)
    full.init()
    full.evolve()
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(RESTART), output_dir=str(tmp_path / "b"), **kw)
    sim.init()
    sim.state, sim.is_synchronized = load_checkpoint(
        str(tmp_path / "a" / "chk000003"), sim.state)
    assert sim.state.step == 3 and not sim.is_synchronized
    assert sum(k.startswith("mr:") for k in sim.state.aux) == (
        2 * len(mr.part_keys(sim.mr_layout)) + 3)
    sim.evolve()
    got, ref = state_to_numpy(sim.state), state_to_numpy(full.state)
    for nm, a in ref["fields"].items():
        np.testing.assert_array_equal(got["fields"][nm], a, err_msg=nm)
    for k, a in ref["aux"].items():
        np.testing.assert_array_equal(got["aux"][k], a, err_msg=k)
    for k, a in ref["species"]["electrons"].items():
        if a is not None:
            np.testing.assert_array_equal(got["species"]["electrons"][k], a,
                                          err_msg=k)


def test_plotfile_has_the_fine_level(tmp_path):
    """A plotfile of an MR run holds level 1's covering grid beside level
    0 (the JAX package's simulation.py:558-568)."""
    from warpx_tpu_torch.io.plotfile import read_plotfile

    text = _deck2d(steps=2, extra=(
        "diagnostics.diags_names = plt\nplt.format = plotfile\n"
        "plt.intervals = 2\nplt.fields_to_plot = Ex jx rho\n"))
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float64, device="cpu",
        output_dir=str(tmp_path))
    sim.init()
    sim.evolve()
    levels, _ = read_plotfile(str(tmp_path / "plt000002"))
    lev1 = mr.mr_output_fields(sim.state, sim.cfg, sim.staggering,
                               sim.mr_layout)
    assert len(levels) == 2
    for nm in ("Ex", "jx", "rho"):
        np.testing.assert_array_equal(levels[1][nm], lev1[nm])


# ------------------------------------------------------------ refusals
REFUSED = {
    "two_levels": "amr.max_level = 2\n",
    "subcycling_ratio_4": "warpx.do_subcycling = 1\namr.ref_ratio = 4\n",
    "psatd": "algo.maxwell_solver = psatd\n",
    "electrostatic": "warpx.do_electrostatic = labframe\n",
    "collocated": "warpx.grid_type = collocated\n",
    "collisions": ("collisions.collision_names = c1\n"
                   "c1.species = electrons electrons\n"),
    "direct_deposition": "algo.current_deposition = direct\n",
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_jax_refusals_are_mirrored(case):
    text = _deck2d(steps=1) + REFUSED[case]
    with pytest.raises(NotImplementedError):
        JSimulation.from_deck(JDeck.from_string(text))
    with pytest.raises(NotImplementedError):
        warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(text), dtype=torch.float64, device="cpu")


PORT_REFUSED = {
    # the JAX package's MR step drops these silently
    "external_fields": dict(e_ext_particle=(1e9, 0.0, 0.0)),
    "implicit": dict(evolve_scheme="theta_implicit_em"),
    "divergence_cleaning": dict(do_dive_cleaning=True),
    "centering_order_4": dict(field_gathering="momentum-conserving",
                              field_centering_no=(4, 4)),
}


@pytest.mark.parametrize("case", sorted(PORT_REFUSED))
def test_dropped_parts_are_refused(case):
    cfg = config_from_deck(Deck.from_string(_deck2d(steps=1)))
    import dataclasses

    cfg = dataclasses.replace(cfg, **PORT_REFUSED[case])
    with pytest.raises(NotImplementedError,
                       match=re.escape("ROADMAP.md Queue C")):
        warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")


INJECT = """
max_step = 1
amr.n_cell = 24 32
geometry.dims = 2
geometry.prob_lo = -12.e-6 -16.e-6
geometry.prob_hi = 12.e-6 16.e-6
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 2 2
electrons.xmin = -9.e-6
electrons.xmax = 9.e-6
electrons.zmin = -10.e-6
electrons.do_continuous_injection = 1
"""
INJECT_CASES = {
    "constant_at_rest": ("electrons.profile = constant\n"
                         "electrons.density = 2.e23\n"
                         "electrons.momentum_distribution_type = at_rest\n"),
    "constant_gaussian": ("electrons.profile = constant\n"
                          "electrons.density = 2.e23\n"
                          "electrons.momentum_distribution_type = gaussian\n"
                          "electrons.ux_th = 0.1\nelectrons.uz_th = 0.2\n"),
    "parsed_density": (
        "electrons.profile = parse_density_function\n"
        'electrons.density_function(x,y,z) = "2.e23*(1+x*z*1.e9)"\n'
        "electrons.momentum_distribution_type = constant\n"
        "electrons.uz = 0.5\n"),
}


@pytest.mark.parametrize("case", sorted(INJECT_CASES))
def test_refined_injection_host_matches_jax(case):
    """warpx.refine_plasma's lattice at init (the JAX package's
    ``inject_species`` with its ``refine_spec``): the same rows, in the same
    order, for the table path of a constant density and the general one."""
    from warpx_tpu.core.injection import inject_species
    from warpx_tpu_torch.core.injection import inject_species_host

    jcfg = jax_config_from_deck(JDeck.from_string(INJECT
                                                  + INJECT_CASES[case]))
    cfg = port_config(jcfg)
    spec = ((8, 0), (16, 32), (2, 2), 1)
    ref = inject_species(jcfg.species[0], jcfg.geometry, np.float64,
                         np.random.default_rng(4), refine_spec=spec)
    got = inject_species_host(cfg.species[0], cfg.geometry,
                              np.random.default_rng(4), np.float64,
                              refine_spec=spec)
    n = int(ref.alive.sum())
    assert got["w"].shape[0] == n and 0 < n < ref.alive.shape[0] + 1
    for k in ("x", "z", "w", "ux", "uy", "uz"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(ref, k))[:n],
                                      err_msg=k)
    # the footprint's cells carry a quarter of a coarse particle's weight
    assert len(np.unique(got["w"])) > 1 or case == "parsed_density"


def test_cli_runs_an_mr_deck(tmp_path, capsys):
    """The CLI on the CPU runs a subcycled MR deck and prints the in-process
    run's checksums, lev=1 among them."""
    import json

    from warpx_tpu_torch.__main__ import main as cli_main

    deck = tmp_path / "inputs"
    deck.write_text(DECKS["2d_subcycled"])
    assert cli_main([str(deck), "--device", "cpu", "--checksums",
                     "--output-dir", str(tmp_path / "out")]) == 0
    out, _ = capsys.readouterr()
    printed = json.loads(out[out.index("\n") + 1:])
    assert "lev=1" in printed
    assert printed == json.loads(json.dumps(
        port_run("2d_subcycled").checksums()))
