"""The port's pywarpx-style data views (``warpx_tpu_torch.fields``,
``particle_containers``) against the JAX package's (``tests/
test_data_views.py``), float64 on the CPU at 1e-9.

Reads must give numpy's results for every index numpy takes; a write goes
into the live state and the next step must see it as JAX's does, on the
tile-binned periodic step, the bounded moving-window step and PSATD;
``add_particles`` fills the first free slots in flat order, also on the
tile-binned layout, whose safety counters then count as JAX's do; the
boundary buffer reads what a scraping deck absorbed; the views of a run
spread over ranks refuse (ROADMAP.md Queue A 14.4)."""

import functools

import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu import constants, fields as jfields
from warpx_tpu import particle_containers as jpc
from warpx_tpu.core.config import SimConfig as JSimConfig
from warpx_tpu.core.config import SpeciesConfig as JSpeciesConfig
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.solvers.yee import compute_dt_yee
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch import fields as tfields
from warpx_tpu_torch import particle_containers as tpc
from warpx_tpu_torch.utils.parser import Deck as TDeck

from .test_torch_bounded_util import LWFA_2D, port_config
from .test_torch_frontend_util import (CPU64, clean_frontends,  # noqa: F401
                                       states, states_close, sums_close)

pytestmark = pytest.mark.usefixtures("clean_frontends")


def _cfg():
    """tests/test_data_views.py's 8^3 plasma, as the JAX package builds
    it."""
    geom = JGeometry(3, (8, 8, 8), (0.0,) * 3, (1.0,) * 3, (True,) * 3)
    sp = JSpeciesConfig(
        name="electrons", charge=-constants.q_e, mass=constants.m_e,
        injection_style="nuniformpercell",
        num_particles_per_cell_each_dim=(1, 1, 1),
        profile="constant", density=1.0e20, capacity_factor=2.0,
    )
    return JSimConfig(geometry=geom, max_step=2,
                      dt=compute_dt_yee(geom, 0.9), species=(sp,))


def _pair(jcfg):
    """(JAX, port) simulations of one configuration, each initialised, both
    per particle (JAX's "auto" on the CPU); the port's is the active
    one."""
    jsim = JSimulation(jcfg)
    jsim.init()
    tsim = warpx_tpu_torch.Simulation(
        port_config(jcfg, tiled_particles="off"), **CPU64)
    tsim.init()
    return jsim, tsim


def test_field_wrapper_read_write_mesh():
    """tests/test_data_views.py's field case on the port, then the same
    write in both packages and the run to its end."""
    jsim, sim = _pair(_cfg())
    Ex = tfields.ExWrapper()
    assert Ex.sim is sim
    assert Ex.shape == (8, 8, 8) and len(Ex) == 8
    Ex[:, :, 4] = 3.0
    assert float(np.abs(Ex[:, :, 4] - 3.0).max()) == 0.0
    assert Ex[0, 0, 3] == 0.0
    # the write landed in the live state, on its device and dtype
    assert float(sim.state.fields.Ex[2, 5, 4]) == 3.0
    assert sim.state.fields.Ex.dtype == torch.float64
    # Ex is cell-centered in x, nodal in y, as in JAX
    jEx = jfields.FieldWrapper("Ex", sim=jsim)
    for d in "xyz":
        np.testing.assert_array_equal(Ex.mesh(d), jEx.mesh(d))
    assert np.isclose(Ex.mesh("x")[0], 0.5 / 8)
    assert Ex.norm0() == 3.0 and Ex.max() == 3.0 and Ex.min() == 0.0
    assert Ex.sum() == 3.0 * 64
    with pytest.raises(NotImplementedError, match="mesh-refinement"):
        tfields.ExWrapper(level=1)
    with pytest.raises(RuntimeError, match="not allocated"):
        tfields.RhoFPWrapper()[...]
    jEx[:, :, 4] = 3.0
    jsim.evolve()
    sim.evolve()
    states_close(*states(jsim, sim))


INDICES = [
    (0, 0, 3), (-1, 2, -3), (slice(None), 1), (slice(None, None, -1),),
    (slice(-3, None), slice(1, 7, 2), -2),
    (slice(6, 1, -2), Ellipsis, 0), (Ellipsis, None, 5),
    (np.array([0, 3, 7]), slice(None), 2), (np.int64(-2), 4, 4),
    (slice(2, 100),),
]


def test_reads_follow_numpy_indexing():
    """Every index gives JAX's (numpy's) result, of its shape and type:
    negative integers, reversed and strided slices, None, index arrays."""
    jsim, sim = _pair(_cfg())
    rng = np.random.default_rng(3)
    data = rng.normal(size=(8, 8, 8))
    jfields.FieldWrapper("Bz", sim=jsim)[...] = data
    Bz = tfields.BzWrapper()
    Bz[...] = data
    jBz = jfields.FieldWrapper("Bz", sim=jsim)
    for ix in INDICES:
        got, ref = Bz[ix], jBz[ix]
        assert np.shape(got) == np.shape(ref), ix
        assert type(got) is type(ref), ix
        np.testing.assert_array_equal(got, ref)
    assert [np.asarray(r).shape for r in Bz] == [(8, 8)] * 8
    for red in ("min", "max", "sum", "norm0"):
        assert getattr(Bz, red)() == pytest.approx(getattr(jBz, red)(),
                                                   rel=1e-14)
    # a write through a reversed slice and an index array, as numpy does it
    for w in (jBz, Bz):
        w[::-2, np.array([1, 5]), -1] = -7.5
    np.testing.assert_array_equal(Bz[...], jBz[...])


def test_particle_container_wrapper():
    """tests/test_data_views.py's particle case in both packages: the
    getters, add_particles into the first free slots, the run on."""
    jsim, sim = _pair(_cfg())
    pc = tpc.ParticleContainerWrapper("electrons")
    jp = jpc.ParticleContainerWrapper("electrons", sim=jsim)
    n0 = pc.get_particle_count()
    assert n0 == pc.nps == 512
    assert pc.xp.shape == (n0,)
    assert np.all(pc.wp > 0)
    for attr in ("xp", "yp", "zp", "wp", "uxp", "uyp", "uzp"):
        np.testing.assert_array_equal(getattr(pc, attr), getattr(jp, attr))
    for comp in ("w", "ux", "x", "z"):
        np.testing.assert_array_equal(
            pc.get_particle_real_arrays(comp)[0],
            jp.get_particle_real_arrays(comp)[0])
    with pytest.raises(KeyError):
        pc.get_particle_real_arrays("nothing")
    q = pc.get_species_charge_sum()
    assert q == jp.get_species_charge_sum()
    assert np.isclose(q, -constants.q_e * float(pc.wp.sum()))
    kw = dict(x=[0.1, 0.2], y=[0.3, 0.4], z=[0.5, 0.6], ux=1e5, uy=0.0,
              uz=0.0, w=[1e10, 2e10])
    pc.add_particles(**kw)
    jp.add_particles(**kw)
    assert pc.get_particle_count() == n0 + 2
    assert 2e10 in pc.wp
    states_close(*states(jsim, sim), rtol=0.0)
    free = int((~sim.state.species["electrons"].alive).sum())
    with pytest.raises(RuntimeError, match=f"has {free} free slots"):
        pc.add_particles(x=np.zeros(free + 1))
    jsim.evolve()
    sim.evolve()
    assert pc.get_particle_count() == n0 + 2
    states_close(*states(jsim, sim))


# -- a write through a data view reaches the next step -----------------------

PERIODIC_2D = """
max_step = 4
amr.n_cell = 32 32
geometry.dims = 2
geometry.prob_lo = -20.e-6 -20.e-6
geometry.prob_hi =  20.e-6  20.e-6
boundary.field_lo = periodic periodic
boundary.field_hi = periodic periodic
warpx.cfl = 0.999
warpx.sort_intervals = 3
algo.particle_shape = 1
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 2 2 1
electrons.profile = constant
electrons.density = 2.e24
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.05
electrons.uy_th = 0.05
electrons.uz_th = 0.05
"""

PSATD_2D = PERIODIC_2D + """
algo.maxwell_solver = psatd
algo.current_deposition = esirkepov
psatd.nox = 4
psatd.noz = 4
"""

WRITE_DECKS = {
    "periodic_binned": PERIODIC_2D + "tpu.tiled_particles = on\n",
    "window": (LWFA_2D.replace("max_step = 12", "max_step = 4")
               + "tpu.tiled_particles = off\n"),
    "psatd": PSATD_2D + "tpu.tiled_particles = off\n",
}


def _deck_pair(text):
    jsim = JSimulation.from_deck(JDeck.from_string(text))
    jsim.init()
    tsim = warpx_tpu_torch.Simulation.from_deck(TDeck.from_string(text),
                                                **CPU64)
    tsim.init()
    return jsim, tsim


def _write(mod, sim, lo, hi):
    """Through the data views of ``mod`` (either package's): scale a strip
    of Ex, set one of Bz, add five electrons within [lo, hi) in x and z;
    returns the sum of Ex and the electrons' count as the views read them,
    and the refusal of a layout without free slots."""
    f, pc = mod
    Ex = f.FieldWrapper("Ex", sim=sim)
    Bz = f.FieldWrapper("Bz", sim=sim)
    n0, n1 = Ex.shape[0] // 4, Ex.shape[0] // 2
    Ex[n0:n1] = 1.5 * Ex[n0:n1] + 1.0e9
    Bz[:, -6:-2] = 0.3
    rng = np.random.default_rng(11)
    e = pc.ParticleContainerWrapper("electrons", sim=sim)
    try:
        e.add_particles(x=rng.uniform(lo[0], hi[0], 5),
                        z=rng.uniform(lo[1], hi[1], 5),
                        ux=rng.normal(size=5) * 1e7, uz=0.0, w=1.0e9)
        refused = None
    except RuntimeError as err:  # a layout with no free slot
        refused = str(err)
    return Ex.sum(), e.get_particle_count(), refused


@pytest.mark.parametrize("case", list(WRITE_DECKS))
def test_write_then_step(case):
    """Writes through the data views after the second step change the
    steps that follow exactly as in JAX: on the tile-binned periodic step
    (K2's plain version; add_particles fills slots of whatever tiles hold
    them, and the step's safety counters count alike), the bounded window
    step through PML and the periodic PSATD step."""
    jsim, tsim = _deck_pair(WRITE_DECKS[case])
    assert tsim.binned == (case == "periodic_binned")
    jsim.evolve(2)
    tsim.evolve(2)
    geom = tsim.cfg.geometry
    lo = [0.5 * (a + b) for a, b in zip(geom.prob_lo, geom.prob_hi)]
    got = _write((tfields, tpc), tsim, lo, geom.prob_hi)
    ref = _write((jfields, jpc), jsim, lo, geom.prob_hi)
    assert got[1:] == ref[1:]
    assert (got[2] is None) == (case != "psatd")
    assert got[0] == pytest.approx(ref[0], rel=1e-9)
    states_close(*states(jsim, tsim))
    jsim.evolve()
    tsim.evolve()
    assert tsim.state.step == 4
    ref, got = states(jsim, tsim)
    assert not np.array_equal(ref["fields"]["Bz"], 0.0)
    states_close(ref, got)
    if not tsim.binned:
        sums_close(jsim.checksums(), tsim.checksums())
        return
    # the electrons added in tiles that do not hold them are counted, and
    # both packages then refuse the positions' wrap
    for k in ("tile_overflow", "tile_violations"):
        assert int(tsim.state.aux[k]) == int(jsim.state.aux[k]), k
    assert int(tsim.state.aux["tile_violations"]) > 0
    with pytest.raises(RuntimeError) as jerr:
        jsim.checksums()
    with pytest.raises(RuntimeError, match="invariant violated") as terr:
        tsim.checksums()
    assert str(terr.value) == str(jerr.value)


SCRAPE_2D = """
max_step = 4
amr.n_cell = 16 16
geometry.dims = 2
geometry.prob_lo = 0. 0.
geometry.prob_hi = 1.e-5 1.e-5
boundary.field_lo = pec pec
boundary.field_hi = pec pec
boundary.particle_lo = absorbing absorbing
boundary.particle_hi = absorbing absorbing
warpx.cfl = 0.9
algo.particle_shape = 1
particles.species_names = electrons
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.profile = constant
electrons.density = 1.e18
electrons.momentum_distribution_type = gaussian
electrons.ux_th = 0.3
electrons.uy_th = 0.3
electrons.uz_th = 0.3
electrons.save_particles_at_xlo = 1
electrons.save_particles_at_zhi = 1
tpu.tiled_particles = off
"""


def test_boundary_buffer_reads_the_scraped_particles():
    """ParticleBoundaryBufferWrapper reads the port's scrape buffers as
    the JAX one reads JAX's: sizes and records per face, then cleared."""
    jsim, tsim = _deck_pair(SCRAPE_2D)
    jsim.evolve()
    tsim.evolve()
    buf = tpc.ParticleBoundaryBufferWrapper()
    assert buf.sim is tsim
    jbuf = jpc.ParticleBoundaryBufferWrapper()
    assert jbuf.sim is jsim
    for face in ("xlo", "zhi"):
        n = buf.get_particle_boundary_buffer_size("electrons", face)
        assert n > 0 and n == jbuf.get_particle_boundary_buffer_size(
            "electrons", face)
        for comp in ("w", "ux", "uz", "p0", "p1", "step"):
            got = buf.get_particle_boundary_buffer("electrons", face, comp)
            ref = jbuf.get_particle_boundary_buffer("electrons", face, comp)
            assert got[0].shape == (n,)
            np.testing.assert_allclose(got[0], ref[0], rtol=1e-9, atol=0)
    buf.clear_buffer()
    assert buf.get_particle_boundary_buffer_size("electrons", "xlo") == 0
    assert tsim.state.aux["scrape:electrons:xlo:n"].dtype == torch.int32


@functools.lru_cache(maxsize=None)
def _periodic_cfg():
    from warpx_tpu_torch.core.deck import config_from_deck

    return config_from_deck(TDeck.from_string(
        PERIODIC_2D.replace("max_step = 4", "max_step = 2")
        + "warpx.use_filter = 0\n"))


@pytest.mark.parametrize("kind", ["dist", "particle_dist"])
def test_views_of_a_distributed_run_refuse(kind):
    """Each rank holds one segment of the run: the views raise, naming
    Queue A 14.4; the callbacks fire on every rank all the same."""
    import torch.distributed as dist

    from warpx_tpu_torch.core.particle_dist import ParticleDistSimulation
    from warpx_tpu_torch.core.simulation import DistSimulation
    from warpx_tpu_torch.parallel.launch import init_single_rank
    from warpx_tpu_torch.utils.callbacks import installcallback

    init_single_rank("gloo")
    try:
        cfg = _periodic_cfg()
        if kind == "dist":
            sim = DistSimulation(cfg, {"z": 1}, dtype=torch.float64,
                                 device="cpu")
        else:
            from warpx_tpu_torch.core.deck import config_from_deck

            sim = ParticleDistSimulation(config_from_deck(TDeck.from_string(
                LWFA_2D.replace("max_step = 12", "max_step = 2"))),
                dtype=torch.float64, device="cpu")
        calls = []
        installcallback("afterstep", lambda: calls.append(sim.state.step))
        sim.init()
        sim.evolve()
        assert calls == [1, 2]
        for view in (lambda: tfields.ExWrapper()[0],
                     lambda: tpc.ParticleContainerWrapper("electrons").nps,
                     lambda: tpc.ParticleBoundaryBufferWrapper().sim):
            with pytest.raises(NotImplementedError, match="Queue A 14.4"):
                view()
    finally:
        dist.destroy_process_group()
