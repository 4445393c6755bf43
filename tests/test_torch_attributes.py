"""Runtime attributes, backward-propagating beams and the window's step
range in the port against the JAX package, CPU, float64.

``<sp>.addRealAttributes`` / ``addIntegerAttributes`` with their
``<sp>.attribute.<name>(x,y,z,ux,uy,uz,t)`` expressions evaluated at
injection (the plasma styles in 1D, 2D and 3D, lab and boosted frame; the
Gaussian beam), on continuous injection under a moving window, through the
rebin (the attributes ride as payload rows in sorted name order: K3's
plain version here), in the checksums and through a checkpoint;
``<sp>.do_backward_propagation``; the refusal of a window step range other
than the one the JAX package runs.  The JAX package's binned steps raise
on an integer attribute (its rebin floats it, and the two branches of its
rebin ``lax.cond`` then differ in type: ROADMAP.md Queue C), so the
tile-binned run with one is held to the port's per-particle run.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core import injection as jinj
from warpx_tpu.core.config import SpeciesConfig as JSpeciesConfig
from warpx_tpu.core.deck import config_from_deck as j_config_from_deck
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.state import ParticleState as JParticleState
from warpx_tpu.ops import tiling as j_tiling
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core import config as tconfig
from warpx_tpu_torch.core import injection as tinj
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.grid import Geometry
from warpx_tpu_torch.core.state import ParticleState, state_to_numpy
from warpx_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from warpx_tpu_torch.ops import tiling
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import port_config
from .test_torch_draws_util import (assert_checksums_close, assert_runs_close,
                                    jax_run, port_run)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

C = 299792458.0
ATTRS = (("orig_z", "z + 0.5*x - y", False),
         ("e0", "ux*ux + uy*uy + uz*uz + t*1.e20", False),
         ("roi", "(z > 0) + 2*(x > 1.e-6) + 4*(uz > 0)", True))


def _geoms(ndim):
    n = {1: (16,), 2: (8, 12), 3: (4, 6, 8)}[ndim]
    lo = (-4e-6, -5e-6, -6e-6)[3 - ndim:]
    hi = (4e-6, 5e-6, 6e-6)[3 - ndim:]
    kw = dict(ndim=ndim, n_cell=n, prob_lo=lo, prob_hi=hi,
              periodic=(True,) * ndim)
    return JGeometry(**kw), Geometry(**kw)


def _species(ndim, **kw):
    base = dict(
        name="electrons", charge=-1.602176634e-19, mass=9.1093837015e-31,
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=(2, 1, 3)[3 - ndim:],
        profile="parse_density_function",
        density_expr="1.e24*(1 + 0.5*sin(z*1.e6))*(x*x < 1.e-11)",
        momentum_distribution="gaussian", ux_th=0.01, uy_th=0.02,
        uz_th=0.3, uz=0.1, bounds_lo=(-3e-6, -4e-6, -5e-6)[3 - ndim:],
        bounds_hi=(3e-6, 4e-6, 5e-6)[3 - ndim:], attributes=ATTRS)
    base.update(kw)
    jsp = JSpeciesConfig(**base)
    return jsp, port_config(jsp, tconfig.SpeciesConfig)


def _assert_attributes(got, ref):
    assert sorted(got) == sorted(ref) == ["e0", "orig_z", "roi"]
    for k, r in ref.items():
        g, r = np.asarray(got[k]), np.asarray(r)
        assert g.dtype == r.dtype, k
        if k == "roi":
            np.testing.assert_array_equal(g, r)
            assert g.dtype == np.int32 and len(set(r.tolist())) > 1
        else:
            scale = np.abs(r).max()
            assert np.abs(g - r).max() <= 1e-12 * scale, k


@pytest.mark.parametrize("ndim,gamma_boost", [(1, 1.0), (2, 1.0), (3, 1.0),
                                              (2, 5.0)])
def test_plasma_injection_attributes_match_jax(ndim, gamma_boost):
    """The plasma styles' attributes at each particle's lab position and
    boosted momenta (JAX injection.py:366-377), padded to the capacity."""
    jg, tg = _geoms(ndim)
    jsp, tsp = _species(ndim)
    ref = jinj.inject_species(jsp, jg, np.float64, np.random.default_rng(4),
                              capacity=None, gamma_boost=gamma_boost)
    got = tinj.inject_species_host(tsp, tg, np.random.default_rng(4),
                                   np.float64, gamma_boost=gamma_boost)
    alive = np.asarray(ref.alive)
    assert alive.sum() > 10
    np.testing.assert_array_equal(got["alive"], alive)
    np.testing.assert_array_equal(got["uz"], np.asarray(ref.uz))
    _assert_attributes(got["extra"], ref.extra)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_gaussian_beam_backward_propagation_and_attributes(ndim):
    """A boosted Gaussian beam with do_backward_propagation: u_z flips
    after the boost, the positions keep the unflipped map
    (PhysicalParticleContainer.cpp:487-498), the attributes take the
    float64 positions and momenta; the 1D weight divides by x_rms y_rms."""
    jg, tg = _geoms(ndim)
    kw = dict(injection_style="gaussian_beam", npart=400, x_rms=1e-6,
              y_rms=2e-6, z_rms=1.5e-6, z_m=1e-6, q_tot=-1e-12,
              momentum_distribution="gaussian", ux_th=0.1, uy_th=0.1,
              uz_th=2.0, uz=50.0, do_backward_propagation=True)
    jsp, tsp = _species(ndim, **kw)
    ref = jinj.inject_gaussian_beam(jsp, jg, np.float64,
                                    np.random.default_rng(9), 10.0)
    got = tinj.inject_gaussian_beam_host(tsp, tg, np.random.default_rng(9),
                                         np.float64, 10.0)
    for k in ("w", "ux", "uy", "uz", "alive") + ("x", "y", "z")[3 - ndim:]:
        if ndim == 2 and k == "y":
            continue
        np.testing.assert_array_equal(got[k], np.asarray(getattr(ref, k)),
                                      err_msg=k)
    _assert_attributes(got["extra"], ref.extra)
    fwd = tinj.inject_gaussian_beam_host(
        dataclasses.replace(tsp, do_backward_propagation=False), tg,
        np.random.default_rng(9), np.float64, 10.0)
    np.testing.assert_array_equal(got["uz"], -fwd["uz"])
    np.testing.assert_array_equal(got["z"], fwd["z"])
    assert (got["uz"] != 0).all()


def _particles_with_attributes(rng, cap, lx=40e-6):
    pos = rng.uniform(-lx / 2, lx / 2, (2, cap))
    pos[0, :10] += lx  # out of the domain: must wrap
    alive = rng.random(cap) > 0.2
    vals = dict(x=pos[0], z=pos[1], ux=rng.normal(size=cap),
                uy=rng.normal(size=cap), uz=rng.normal(size=cap),
                w=(rng.random(cap) + 0.5) * alive)
    extra = {"roi": rng.integers(-1000, 1000, cap).astype(np.int32),
             "e0": rng.normal(size=cap), "a_first": rng.normal(size=cap)}
    sp = ParticleState(
        alive=torch.from_numpy(alive),
        extra={k: torch.from_numpy(v.copy()) for k, v in extra.items()},
        **{k: torch.from_numpy(v.copy()) for k, v in vals.items()})
    jsp = JParticleState(alive=jnp.asarray(alive),
                         extra={k: jnp.asarray(v) for k, v in extra.items()},
                         **{k: jnp.asarray(v) for k, v in vals.items()})
    return sp, jsp


def test_rebin_carries_attributes_as_jax():
    """The attributes ride the rebin as payload rows in sorted name order
    (JAX tiling.py:257-264, 322-329): per tile the same multisets of
    (x, z, u, w, attributes) rows as the JAX package's rebin, dead slots 0;
    the integer attribute comes back int32, equal to the JAX package's
    floated value."""
    lx = 40e-6
    kw = dict(ndim=2, n_cell=(16, 16), prob_lo=(-lx / 2,) * 2,
              prob_hi=(lx / 2,) * 2, periodic=(True, True))
    jg, g = JGeometry(**kw), Geometry(**kw)
    spec = tiling.TileSpec.create(g.n_cell, order=1, n_particles=4096,
                                  margin=1, interval=1, p_max=1024)
    jspec = j_tiling.TileSpec.create(jg.n_cell, order=1, n_particles=4096,
                                     margin=1, interval=1, p_max=1024)
    sp, jsp = _particles_with_attributes(np.random.default_rng(2), 4096)
    new, ovf = tiling.rebin(sp, g, spec)
    jnew, jovf = j_tiling.rebin(jsp, jg, jspec)
    assert int(ovf) == int(jovf) == 0
    assert new.extra["roi"].dtype == torch.int32
    assert np.asarray(jnew.extra["roi"]).dtype == np.float64
    names = ("x", "z", "ux", "uy", "uz", "w")
    extras = ("a_first", "e0", "roi")
    alive = new.alive.numpy()
    np.testing.assert_array_equal(alive, np.asarray(jnew.alive))
    got = np.stack([getattr(new, k).numpy() for k in names]
                   + [new.extra[k].numpy().astype(np.float64)
                      for k in extras], axis=1)
    ref = np.stack([np.asarray(getattr(jnew, k)) for k in names]
                   + [np.asarray(jnew.extra[k]) for k in extras], axis=1)
    np.testing.assert_array_equal(got[~alive], ref[~alive])
    assert (got[~alive][:, len(names):] == 0).all()
    P = spec.p_max
    for tt in range(spec.n_tiles):
        sl = slice(tt * P, (tt + 1) * P)
        a, b = got[sl][alive[sl]], ref[sl][alive[sl]]
        np.testing.assert_array_equal(a[np.lexsort(a.T[::-1])],
                                      b[np.lexsort(b.T[::-1])])
    # every particle's attributes moved with it
    before = {(float(x), float(z)): (int(r), float(e))
              for x, z, r, e, a in zip(
                  torch.remainder(sp.x + lx / 2, lx) - lx / 2, sp.z,
                  sp.extra["roi"], sp.extra["e0"], sp.alive) if a}
    after = {(float(x), float(z)): (int(r), float(e))
             for x, z, r, e, a in zip(new.x, new.z, new.extra["roi"],
                                      new.extra["e0"], new.alive) if a}
    assert before == after


BINNED_2D = """
max_step = 4
amr.n_cell = 32 32
geometry.dims = 2
geometry.prob_lo = -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6
warpx.sort_intervals = 2
algo.particle_shape = 2
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 3 3
electrons.profile = constant
electrons.density = 1.e24
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.01
electrons.uy_th = 0.01
electrons.uz_th = 0.01
electrons.addIntegerAttributes = roi
electrons.attribute.roi(x,y,z,ux,uy,uz,t) = "(z>-2.0e-6) * (z<3.0e-6) + 3*(x>0)"
electrons.addRealAttributes = e0 orig_z
electrons.attribute.e0(x,y,z,ux,uy,uz,t) = "ux*ux + uy*uy + uz*uz"
electrons.attribute.orig_z(x,y,z,ux,uy,uz,t) = "z"
"""


def test_binned_run_with_attributes_matches_per_particle():
    """9216 electrons with an integer and two real attributes through the
    tile-binned step (rebins at steps 0 and 2, K3's plain version with
    three attribute rows): the attributes and every checksum within 1e-9
    of the per-particle run, the integer one int32 and its sum exact."""
    runs = {t: port_run(BINNED_2D + f"tpu.tiled_particles = {t}\n",
                        replay=False) for t in ("on", "off")}
    assert runs["on"].binned and not runs["off"].binned
    sums = {t: r.checksums() for t, r in runs.items()}
    assert_checksums_close(sums["on"], sums["off"], 1e-9)
    assert (sums["on"]["electrons"]["particle_roi"]
            == sums["off"]["electrons"]["particle_roi"] > 0)
    sp = runs["on"].state.species["electrons"]
    assert sp.extra["roi"].dtype == torch.int32
    assert sp.capacity == runs["on"].tile_spec.capacity


WINDOW_ATTR = """
max_step = 6
amr.n_cell = 8 32
geometry.dims = 2
geometry.prob_lo = -8.e-6 -24.e-6
geometry.prob_hi =  8.e-6   8.e-6
boundary.field_lo = pec pml
boundary.field_hi = pec pml
warpx.cfl = 0.98
warpx.do_moving_window = 1
warpx.moving_window_dir = z
warpx.moving_window_v = 1.0
warpx.start_moving_window_step = 0
warpx.end_moving_window_step = -1
algo.particle_shape = 2
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 2
electrons.xmin = -6.e-6
electrons.xmax =  6.e-6
electrons.zmin = -20.e-6
electrons.profile = parse_density_function
electrons.density_function(x,y,z) = "2.e23*(1+0.5*sin(z*1.e6))"
electrons.momentum_distribution_type = constant
electrons.ux = 0.01
electrons.uz = 0.02
electrons.do_continuous_injection = 1
electrons.addIntegerAttributes = roi
electrons.attribute.roi(x,y,z,ux,uy,uz,t) = "(z>4.e-6) + 2*(x>0)"
electrons.addRealAttributes = t0 orig_z
electrons.attribute.t0(x,y,z,ux,uy,uz,t) = "t*1.e15 + uz*1.e-8"
electrons.attribute.orig_z(x,y,z,ux,uy,uz,t) = "z"
tpu.tiled_particles = off
"""


@pytest.fixture(scope="module")
def window_runs():
    j = jax_run(WINDOW_ATTR)
    return j, port_run(WINDOW_ATTR, replay=False)


def test_continuous_injection_attributes_match_jax(window_runs):
    """Under the moving window the injected electrons take the attributes
    at their position, momenta and the step's time (JAX
    bounded_step.py:1600-1605): every slot and checksum within 1e-9."""
    j, p = window_runs
    assert_runs_close(p, j, 1e-9)
    sums = p.checksums()
    assert_checksums_close(sums, j.checksums(), 1e-9)
    assert {"particle_roi", "particle_t0", "particle_orig_z"} <= set(
        sums["electrons"])
    sp = p.state.species["electrons"]
    injected = sp.alive & (sp.extra["t0"] > 1e-3)
    assert int(injected.sum()) > 0  # the window injected with t > 0


def test_attributes_survive_a_checkpoint(window_runs, tmp_path):
    """save_checkpoint / load_checkpoint keep every attribute's values and
    type; the restarted run's next step equals the uninterrupted one's."""
    _, p = window_runs
    save_checkpoint(str(tmp_path / "chk"), p.state, p.is_synchronized)
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(WINDOW_ATTR), dtype=torch.float64, device="cpu")
    sim.init()
    sim.state, sim.is_synchronized = load_checkpoint(str(tmp_path / "chk"),
                                                     sim.state)
    for k, v in p.state.species["electrons"].extra.items():
        got = sim.state.species["electrons"].extra[k]
        assert got.dtype == v.dtype, k
        assert torch.equal(got, v), k
    a = state_to_numpy(p.state)
    b = state_to_numpy(sim.state)
    np.testing.assert_array_equal(a["species"]["electrons"]["z"],
                                  b["species"]["electrons"]["z"])


def test_attribute_deck_reads_as_jax():
    """The reader's attributes (reals first, then integers), the window's
    step range at its defaults and do_backward_propagation equal the JAX
    reader's."""
    text = WINDOW_ATTR + "electrons.do_backward_propagation = 1\n"
    got = config_from_deck(Deck.from_string(text))
    ref = port_config(j_config_from_deck(JDeck.from_string(text)))
    assert got == ref
    sp = got.species[0]
    assert [a[0] for a in sp.attributes] == ["t0", "orig_z", "roi"]
    assert sp.do_backward_propagation


@pytest.mark.parametrize("key", ["warpx.start_moving_window_step = 3",
                                 "warpx.end_moving_window_step = 10"])
def test_window_step_range_is_refused(key):
    """The JAX package reads the range and moves the window from step 0 to
    the end whatever it says: a range other than 0 / -1 names Queue C, in
    the reader and on the bounded step."""
    text = WINDOW_ATTR + key + "\n"
    with pytest.raises(NotImplementedError,
                       match=r"moving_window_step.*ROADMAP\.md Queue C"):
        config_from_deck(Deck.from_string(text))
    cfg = config_from_deck(Deck.from_string(WINDOW_ATTR))
    field = key.split(".")[1].split(" ")[0]
    cfg = dataclasses.replace(cfg, **{field: int(key.split("=")[1])})
    with pytest.raises(NotImplementedError,
                       match=r"step range.*ROADMAP\.md Queue C"):
        warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")


def test_attributes_of_a_single_particle_are_refused():
    """The JAX package gives a singleparticle species no attributes: the
    port refuses the combination, naming Queue C."""
    cfg = config_from_deck(Deck.from_string(WINDOW_ATTR))
    sp = dataclasses.replace(cfg.species[0],
                             injection_style="singleparticle",
                             single_particle_weight=1.0)
    cfg = dataclasses.replace(cfg, species=(sp,))
    with pytest.raises(NotImplementedError, match="Queue C"):
        warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
