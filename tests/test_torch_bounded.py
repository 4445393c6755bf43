"""The port's bounded step (2D laser-wakefield deck) against the JAX package.

The 32 x 64 deck of ``tests/test_binned_bounded.py`` (PML on four faces,
moving window, Gaussian laser antenna, continuously injected plasma, a
100-particle beam, current filter, order 3, ``sort_intervals=4``) runs
through ``warpx_tpu.Simulation`` once per module (tile-binned, Pallas in
interpret mode) and through ``warpx_tpu_torch.Simulation`` on the CPU in
float64 (the kernels' plain versions): checksums within 1e-9, the modules
of the step within 1e-12.  The 3D deck with PEC walls is in
``test_torch_bounded_3d.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core import laser as jlaser
from warpx_tpu.core.binned_step import \
    bounded_binned_supported as j_bounded_binned_supported
from warpx_tpu.core.bounded_step import make_bounded_kernels
from warpx_tpu.core.domain import DomainLayout as JDomainLayout
from warpx_tpu.core.injection import inject_gaussian_beam as j_beam
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.core.state import ParticleState as JParticleState
from warpx_tpu.ops import deposit as jdeposit
from warpx_tpu.ops import gather as jgather
from warpx_tpu.ops import tiling as jtiling
from warpx_tpu.solvers.filter import bilinear_filter_padded as j_filter_padded
from warpx_tpu_torch.core import laser as tlaser
from warpx_tpu_torch.core.binned_step import (bounded_binned_supported,
                                               pusher_groups)
from warpx_tpu_torch.core.bounded_step import BoundedStepper
from warpx_tpu_torch.core.domain import DomainLayout
from warpx_tpu_torch.core.grid import yee_staggering
from warpx_tpu_torch.core.injection import (columns_to_state,
                                            inject_gaussian_beam)
from warpx_tpu_torch.core.state import state_from_numpy, state_to_numpy
from warpx_tpu_torch.ops import deposit as tdeposit
from warpx_tpu_torch.ops import gather as tgather
from warpx_tpu_torch.ops import tiling as ttiling
from warpx_tpu_torch.ops.fused_pic import binned_push_deposit
from warpx_tpu_torch.ops.push import PUSHERS, position_step
from warpx_tpu_torch.ops.tiling import fold_windows_open
from warpx_tpu_torch.solvers.filter import bilinear_filter_padded

from .test_torch_bounded_util import (LWFA_2D, assert_checksums,
                                      assert_close, assert_states_close,
                                      jax_config, jax_state_numpy,
                                      jax_state_replace, port_config,
                                      randomize_fields, run_jax, run_port)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

T64 = dict(dtype=torch.float64)


@pytest.fixture(scope="module")
def jax_lwfa():
    """The JAX package's binned run of the deck: its checksums, its state
    after 6 steps, what its window and its species ended as."""
    sim, s6 = run_jax(LWFA_2D, "on", keep_at=6)
    assert sim.tile_spec is not None
    return {
        "cfg": sim.cfg, "sums": sim.checksums(), "s6": s6,
        "aux": {k: np.asarray(v) for k, v in sim.state.aux.items()
                if not k.startswith("pml:")},
        "alive": {nm: int(sp.alive.sum())
                  for nm, sp in sim.state.species.items()},
        "p_max": sim.tile_spec.p_max,
    }


@pytest.fixture(scope="module")
def port_lwfa(jax_lwfa):
    return {tiled: run_port(port_config(jax_lwfa["cfg"],
                                        tiled_particles=tiled))
            for tiled in ("on", "off")}


# ---- the slice -------------------------------------------------------------

@pytest.mark.parametrize("tiled", ["on", "off"])
def test_lwfa_checksums_match_jax(jax_lwfa, port_lwfa, tiled):
    sim = port_lwfa[tiled]
    assert sim.is_bounded and sim.binned == (tiled == "on")
    assert_checksums(jax_lwfa["sums"], sim.checksums())


@pytest.mark.parametrize("tiled", ["on", "off"])
def test_lwfa_window_and_counts_match_jax(jax_lwfa, port_lwfa, tiled):
    """The window moved as far, as much was injected and absorbed."""
    sim = port_lwfa[tiled]
    aux, ref = sim.state.aux, jax_lwfa["aux"]
    assert aux["window_lo"] > -28.0e-6
    assert aux["window_offset"] == int(ref["window_offset"]) > 0
    for k in ("window_x", "window_lo", "window_hi"):
        assert float(aux[k]) == float(ref[k]), k
    # the per-particle step injects every step, the binned one every fourth:
    # the front accumulates in another order
    assert float(aux["inject_pos:electrons"]) == pytest.approx(
        float(ref["inject_pos:electrons"]), rel=1e-13)
    alive = {nm: int(sp.alive.sum()) for nm, sp in sim.state.species.items()}
    assert alive == jax_lwfa["alive"]
    if tiled == "on":
        assert float(aux["tile_anchor"]) == float(ref["tile_anchor"])
        assert int(aux["tile_overflow"]) == int(aux["tile_violations"]) == 0
        assert sim.tile_spec.p_max == jax_lwfa["p_max"]
        assert sorted(sim.stepper.zshifts_seen) == [0, 1, 2, 3]
        assert sim.stepper.slow_species == {"beam"}


def test_lwfa_state_carried_across(jax_lwfa):
    """The JAX state after 6 steps (PML splits, window scalars, tile anchor,
    injection front included) continues in the port to the JAX package's
    step 12."""
    sim = warpx_tpu_torch.Simulation(
        port_config(jax_lwfa["cfg"]), dtype=torch.float64, device="cpu")
    sim.init()  # builds the tile spec and the stepper
    state = state_from_numpy(jax_lwfa["s6"], torch.float64, "cpu")
    assert state.step == 6 and isinstance(state.aux["window_offset"], int)
    assert isinstance(state.aux["window_lo"], np.float64)
    assert isinstance(state.aux["pml:Ex:z"], torch.Tensor)
    back = state_to_numpy(state)
    for k, a in jax_lwfa["s6"]["aux"].items():
        np.testing.assert_array_equal(back["aux"][k], a)
    sim.state = state
    sim.is_synchronized = False
    sim.evolve()
    assert sim.state.step == 12 and sim.is_synchronized
    assert_checksums(jax_lwfa["sums"], sim.checksums())


def test_lwfa_needs_gpu_or_cpu_request(jax_lwfa, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warpx_tpu_torch.Simulation(port_config(jax_lwfa["cfg"]))


# ---- the step's functions against the JAX closures ---------------------------

@pytest.fixture(scope="module")
def one_steps(jax_lwfa):
    """Three rounds of step_main + step_window and a half push, per-particle,
    from the deck's state after 5 steps with random fields and PML splits:
    (JAX states, port states), as numpy."""
    jcfg = dataclasses.replace(jax_lwfa["cfg"], tiled_particles="off")
    jsim = JSimulation(jcfg)
    jsim.init()
    jsim.evolve(5)
    data = randomize_fields(jax_state_numpy(jsim.state), seed=11)
    step_main, step_window, half_push, _ = make_bounded_kernels(
        jcfg, jsim.staggering, jnp.float64)
    js = jax_state_replace(jsim.state, data)
    cfg = port_config(jcfg)
    stepper = BoundedStepper(cfg, yee_staggering(2), torch.float64, "cpu")
    ts = state_from_numpy(data, torch.float64, "cpu")
    out_j, out_t = [], []
    for move_j in (False, True, False):
        js = step_main(js)
        ts = stepper.step_main(ts)
        out_j.append(jax_state_numpy(js))
        out_t.append(state_to_numpy(ts))
        js = step_window(js, jnp.asarray(move_j))
        ts = stepper.step_window(ts, move_j)
        out_j.append(jax_state_numpy(js))
        out_t.append(state_to_numpy(ts))
    out_j.append(jax_state_numpy(half_push(js, dt_half=0.5 * jcfg.dt)))
    out_t.append(state_to_numpy(stepper.half_push(ts, 0.5 * cfg.dt)))
    return out_j, out_t


@pytest.mark.parametrize("k,what", [
    (0, "step_main"), (1, "step_window"), (2, "step_main, second"),
    (3, "step_window with J moved"), (4, "step_main, third"),
    (5, "step_window, third"), (6, "half_push"),
])
def test_bounded_functions_match_jax(one_steps, k, what):
    """pad_eb, the curl terms, the PML splits and their damping, the padded
    filter, fold_and_crop (step_main); shift_field, continuous injection
    into the first free slots, absorbing faces (step_window); the padded
    gather (half_push): slot by slot at 1e-12."""
    out_j, out_t = one_steps
    if k == 5:
        # injection happened by now, into the same slots
        n0 = out_j[0]["species"]["electrons"]["alive"].sum()
        assert out_j[5]["species"]["electrons"]["alive"].sum() != n0
        assert int(out_j[5]["aux"]["window_offset"]) > \
            int(out_j[0]["aux"]["window_offset"])
    assert_states_close(out_t[k], out_j[k])


@pytest.mark.parametrize("shape,npass", [((12, 17), (1, 1)),
                                         ((9, 8, 11), (2, 0, 1))])
def test_bilinear_filter_padded_matches_jax(shape, npass):
    a = np.random.default_rng(5).normal(size=shape)
    got = bilinear_filter_padded(torch.tensor(a), npass).numpy()
    assert_close(got, j_filter_padded(jnp.asarray(a), npass), "filter")


@pytest.mark.parametrize("bc", [("pml", "pml"), ("periodic", "pec"),
                                ("pec", "periodic", "pml")])
def test_domain_layout_matches_jax(jax_lwfa, bc):
    ndim = len(bc)
    geom = dataclasses.replace(
        jax_lwfa["cfg"].geometry, ndim=ndim, n_cell=(8, 12, 16)[:ndim],
        prob_lo=(-1e-6,) * ndim, prob_hi=(2e-6,) * ndim,
        periodic=tuple(b == "periodic" for b in bc))
    jcfg = dataclasses.replace(jax_lwfa["cfg"], geometry=geom, field_bc_lo=bc,
                               field_bc_hi=bc, pml_ncell=4, species=(),
                               lasers=(), do_moving_window=False)
    ref = JDomainLayout.from_config(jcfg)
    got = DomainLayout.from_config(port_config(jcfg))
    stag = yee_staggering(ndim)
    assert got.field_shapes(stag) == ref.field_shapes(stag)
    assert got.static_origin() == ref.static_origin()
    assert got.has_pml == ref.has_pml and got.has_ext == ref.has_ext
    for nm, flags in stag.items():
        assert got.phys_slice(flags) == ref.phys_slice(flags)
        np.testing.assert_array_equal(got.in_pml_mask(flags),
                                      ref.in_pml_mask(flags))
    for d in range(ndim):
        for a, b in zip(got.sigma_factors(d, 1e-16),
                        ref.sigma_factors(d, 1e-16)):
            np.testing.assert_array_equal(a, b)


# ---- guard-padded gather and deposit -----------------------------------------

def _padded_case(ndim, order, seed=2):
    rng = np.random.default_rng(seed)
    n_cell = (10, 12) if ndim == 2 else (6, 7, 8)
    geom = dataclasses.replace(
        jax_config(LWFA_2D, "off").geometry, ndim=ndim, n_cell=n_cell,
        prob_lo=(-2e-6,) * ndim, prob_hi=(3e-6,) * ndim,
        periodic=(False,) * ndim)
    ng = order + 3
    origin = tuple(lo - 0.3 * d for lo, d in zip(geom.prob_lo, geom.dx))
    shape = tuple(n + 1 + 2 * ng for n in n_cell)
    npart = 300
    pos = [rng.uniform(lo, hi, npart)
           for lo, hi in zip(geom.prob_lo, geom.prob_hi)]
    u = rng.normal(0.0, 0.3 * 299792458.0, (3, npart))
    w = rng.uniform(0.5, 1.5, npart) * 1e9
    fields = {nm: rng.normal(size=shape)
              for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")}
    return geom, ng, origin, shape, pos, u, w, fields


@pytest.mark.parametrize("ndim,order", [(2, 1), (2, 3), (3, 2)])
def test_padded_gather_matches_jax(ndim, order):
    geom, ng, origin, shape, pos, _, _, fields = _padded_case(ndim, order)
    stag = yee_staggering(ndim)
    tgeom = port_config(dataclasses.replace(
        jax_config(LWFA_2D, "off"), geometry=geom)).geometry
    ref = jgather.gather_eb([jnp.asarray(p) for p in pos],
                            {k: jnp.asarray(v) for k, v in fields.items()},
                            stag, geom, order, True, origin=origin,
                            wrap=False, offset=ng)
    got = tgather.gather_eb([torch.tensor(p) for p in pos],
                            {k: torch.tensor(v) for k, v in fields.items()},
                            stag, tgeom, order, True, origin=origin,
                            wrap=False, offset=ng)
    for nm, a, b in zip(fields, got, ref):
        assert_close(a.numpy(), b, nm)


@pytest.mark.parametrize("ndim,order,chunk", [(2, 1, None), (2, 3, 64),
                                              (3, 2, None), (3, 1, 100)])
def test_padded_deposits_match_jax(ndim, order, chunk):
    """deposit_current_esirkepov and deposit_rho into a guard-padded block
    at an origin off the domain's corner, whole and in chunks."""
    geom, ng, origin, shape, pos, u, w, _ = _padded_case(ndim, order)
    tgeom = port_config(dataclasses.replace(
        jax_config(LWFA_2D, "off"), geometry=geom)).geometry
    q, dt = -1.602176634e-19, 0.4 * min(geom.dx) / 299792458.0
    kw = dict(origin=origin, wrap=False, offset=ng, out_shape=shape)
    ref = jdeposit.deposit_current_esirkepov(
        [jnp.asarray(p) for p in pos], *[jnp.asarray(a) for a in u],
        jnp.asarray(w), q, geom, dt, order, **kw)
    got = tdeposit.deposit_current_esirkepov(
        [torch.tensor(p) for p in pos], *[torch.tensor(a) for a in u],
        torch.tensor(w), q, tgeom, dt, order, chunk_size=chunk, **kw)
    for nm, a, b in zip(("jx", "jy", "jz"), got, ref):
        assert_close(a.numpy(), b, nm)
    again = tdeposit.deposit_current_esirkepov(
        [torch.tensor(p) for p in pos], *[torch.tensor(a) for a in u],
        torch.tensor(w), q, tgeom, dt, order, out=got, **kw)
    assert again is got  # added to in place
    assert_close(got[0].numpy(), 2 * np.asarray(ref[0]), "jx twice")
    rho_ref = jdeposit.deposit_rho([jnp.asarray(p) for p in pos],
                                   jnp.asarray(w), q, geom, order, **kw)
    rho = tdeposit.deposit_rho([torch.tensor(p) for p in pos],
                               torch.tensor(w), q, tgeom, order,
                               chunk_size=chunk, **kw)
    assert_close(rho.numpy(), rho_ref, "rho")


# ---- rebin at an anchor ------------------------------------------------------

def test_rebin_with_origin_matches_jax():
    """rebin(origin, wrap_dims) as per-tile multisets: the tiling anchored
    2.25 cells above prob_lo along z, x periodic, z open with particles
    beyond both ends clipped into the edge tiles, dead slots freed."""
    rng = np.random.default_rng(9)
    jcfg = jax_config(LWFA_2D, "off")
    geom = jcfg.geometry
    tgeom = port_config(jcfg).geometry
    n = 3000
    lo, hi = np.array(geom.prob_lo), np.array(geom.prob_hi)
    pos = rng.uniform(lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo), (n, 2)).T
    alive = rng.random(n) > 0.2
    cols = dict(w=rng.uniform(1, 2, n), ux=rng.normal(size=n),
                uy=rng.normal(size=n), uz=rng.normal(size=n), alive=alive,
                x=pos[0], z=pos[1])
    origin = (geom.prob_lo[0], geom.prob_lo[1] + 2.25 * geom.dx[1])
    wrap_dims = (True, False)
    jspec = jtiling.TileSpec.create(geom.n_cell, order=3, n_particles=n,
                                    tile=(8, 8), margin=2, interval=4)
    tspec = ttiling.TileSpec.create(geom.n_cell, order=3, n_particles=n,
                                    tile=(8, 8), margin=2, interval=4)
    jsp = JParticleState(**{k: jnp.asarray(v) for k, v in cols.items()})
    ref, ovf_ref = jtiling.rebin(jsp, geom, jspec, origin=origin,
                                 wrap_dims=wrap_dims)
    got, ovf = ttiling.rebin(columns_to_state(cols, "cpu"), tgeom, tspec,
                             origin=origin, wrap_dims=wrap_dims)
    assert int(ovf) == int(ovf_ref)
    P = tspec.p_max
    ralive = np.asarray(ref.alive).reshape(-1, P)
    galive = got.alive.numpy().reshape(-1, P)
    np.testing.assert_array_equal(galive.sum(1), ralive.sum(1))
    assert galive.sum() == alive.sum()
    for k in ("x", "z", "ux", "uy", "uz", "w"):
        a = np.asarray(getattr(ref, k)).reshape(-1, P)
        b = getattr(got, k).numpy().reshape(-1, P)
        # alive slots as multisets per tile; dead slots hold the fills
        np.testing.assert_array_equal(
            np.sort(np.where(galive, b, np.inf), axis=1),
            np.sort(np.where(ralive, a, np.inf), axis=1))
        np.testing.assert_array_equal(b[~galive], a[~ralive])


# ---- laser antenna and beam --------------------------------------------------

def test_antenna_matches_jax(jax_lwfa):
    jcfg = jax_lwfa["cfg"]
    cfg = port_config(jcfg)
    jps, jw, jmob = jlaser.antenna_particles(jcfg.lasers[0], jcfg.geometry,
                                             np.float64)
    cols, w, mob = tlaser.antenna_particles(cfg.lasers[0], cfg.geometry,
                                            np.float64)
    assert (w, mob) == (jw, jmob)
    for k, a in cols.items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jps, k)))
    np.testing.assert_array_equal(
        np.stack(tlaser.antenna_unit_vectors(cfg.lasers[0], 2)),
        np.stack(jlaser.antenna_unit_vectors(jcfg.lasers[0], 2)))
    jsp = JParticleState(**{k: jnp.asarray(getattr(jps, k))
                            for k in ("w", "ux", "uy", "uz", "alive", "x",
                                      "z")})
    sp = columns_to_state(cols, "cpu")
    for t in (0.0, 2.3e-14, 4.1e-14):
        ref = jlaser.update_antenna(jsp, jcfg.lasers[0], jcfg.geometry, jmob,
                                    jnp.asarray(t), jcfg.dt)
        got = tlaser.update_antenna(sp, cfg.lasers[0], cfg.geometry, mob, t,
                                    cfg.dt)
        for k in ("x", "z", "ux", "uy", "uz"):
            assert_close(getattr(got, k).numpy(), getattr(ref, k), (t, k))
        assert float(np.abs(np.asarray(ref.uy)).max()) > 0.0


def test_unported_laser_profile_raises(jax_lwfa):
    """A lasy laser runs since Queue A 11.2 (tests/test_torch_laser_file.py);
    a parsed-field laser is refused, as the JAX reader refuses it (ROADMAP
    Queue C)."""
    laser = dataclasses.replace(port_config(jax_lwfa["cfg"]).lasers[0],
                                profile="parse_field")
    x = torch.zeros(3, **T64)
    with pytest.raises(NotImplementedError, match="Queue C"):
        tlaser.fill_amplitude(laser, 2, x, x, 0.0)


@pytest.mark.parametrize("ndim", [2, 3])
def test_gaussian_beam_bit_identical(jax_lwfa, ndim):
    jcfg = jax_lwfa["cfg"]
    jgeom = jcfg.geometry
    if ndim == 3:
        jgeom = dataclasses.replace(
            jgeom, ndim=3, n_cell=(8, 8, 8), prob_lo=(-1e-5,) * 3,
            prob_hi=(1e-5,) * 3, periodic=(False,) * 3)
    beam = dataclasses.replace(jcfg.species[1], z_cut=1.5)
    ref = j_beam(beam, jgeom, np.float64, np.random.default_rng(4))
    tgeom = port_config(dataclasses.replace(jcfg, geometry=jgeom)).geometry
    got = inject_gaussian_beam(
        port_config(beam, type(port_config(jcfg).species[1])), tgeom,
        np.random.default_rng(4), dtype=torch.float64, device="cpu")
    assert 0 < int(got.alive.sum()) < beam.npart  # z_cut dropped some
    for k in ("w", "ux", "uy", "uz", "alive", "x", "y", "z"):
        a = getattr(ref, k)
        if a is None:
            assert getattr(got, k) is None
        else:
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(a))


def test_bounded_init_matches_jax(jax_lwfa):
    """Species in cfg order from one generator, the continuously injected
    one injected twice: the beam's draws, the electrons' lattice, the whole-
    run capacity and the PML split fields equal the JAX package's."""
    jcfg = dataclasses.replace(jax_lwfa["cfg"], tiled_particles="off")
    jsim = JSimulation(jcfg)
    ref = jax_state_numpy(jsim.init())
    sim = warpx_tpu_torch.Simulation(port_config(jcfg), dtype=torch.float64,
                                     device="cpu")
    got = state_to_numpy(sim.init())
    assert sum(k.startswith("pml:") for k in got["aux"]) == 8
    assert_states_close(got, ref, tol=0.0)


# ---- kernel frame and embedding ----------------------------------------------

@pytest.mark.parametrize("zshift", [0, 3, 8])
def test_kernel_frame_and_embedding(port_lwfa, zshift):
    """to_kernel_frame + the fused kernel's plain version + fold_windows_open
    + embed_folded against the per-particle gather, push and Esirkepov
    deposit into the big_shape block, with the window ``zshift`` cells above
    the tiles' anchor (smax = 8): particles and the J block to 1e-12."""
    sim = port_lwfa["on"]
    stepper, spec, cfg = sim.stepper, sim.tile_spec, sim.cfg
    geom = cfg.geometry
    assert stepper.smax == 8
    state = sim.state
    rng = np.random.default_rng(zshift)
    fields = state.fields.replace(**{
        nm: torch.tensor(rng.normal(size=stepper.shapes[nm])
                         * (30.0 if nm[0] == "B" else 1e10))
        for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")})
    state = state.replace(fields=fields)
    dz = geom.dx[1]
    anchor = state.aux["window_lo"] - zshift * dz
    origin_t = (geom.prob_lo[0], anchor)
    # between rebins nothing alive sits above the tiling's top: injection
    # waits for the step before a rebin
    el = state.species["electrons"]
    el = el.replace(alive=el.alive & (el.z < anchor + geom.n_cell[1] * dz))
    el, ovf = ttiling.rebin(el, geom, spec, origin=origin_t,
                            wrap_dims=stepper.wrap_dims)
    assert int(ovf) == 0 and int(el.alive.sum()) > 1000
    state = state.replace(species={**state.species, "electrons": el})

    farr_pad = stepper._padded_eb(fields)
    fields6 = stepper.to_kernel_frame(farr_pad)
    ((pname, _, params, parts, counts),) = list(
        pusher_groups(state, spec, stepper.params))
    newp, jw, viol = binned_push_deposit(
        params, fields6, parts, origin_t, zshift, counts=counts, spec=spec,
        geom=geom, order=3, galerkin=True, pusher_name=pname, dt=cfg.dt,
        stag_items=stepper.stag_items, smax=stepper.smax)
    assert int(viol.sum()) == 0
    j_binned = [stepper.embed_folded(fold_windows_open(jw[i], spec), zshift)
                for i in range(3)]

    origin = stepper.origin_of(state)
    pos = el.positions(2)
    e6 = stepper._gather(pos, farr_pad, origin)
    sp_cfg = cfg.species[0]
    u = PUSHERS["boris"](el.ux, el.uy, el.uz, *e6, sp_cfg.charge,
                         sp_cfg.mass, cfg.dt)
    new_pos = position_step(pos, *u, cfg.dt, 2)
    w_eff = torch.where(el.alive, el.w, torch.zeros_like(el.w))
    j_ref = stepper._deposit(new_pos, u, w_eff, sp_cfg.charge, origin,
                             stepper.big_shape)
    alive = el.alive.numpy()
    for a, b, nm in zip(newp, (*new_pos, *u), ("x", "z", "ux", "uy", "uz")):
        assert_close(a.reshape(-1).numpy()[alive], b.numpy()[alive], nm)
    for a, b, nm in zip(j_binned, j_ref, ("jx", "jy", "jz")):
        assert float(b.abs().max()) > 0.0
        assert_close(a.numpy(), b.numpy(), nm)


def test_dead_slot_inside_count_deposits_nothing(port_lwfa):
    """A particle the window left behind dies in step_window but keeps its
    slot until the next rebin: with weight 0 among the first ``count`` slots
    of its tile it deposits nothing and raises no violation, wherever it
    has drifted to."""
    sim = port_lwfa["on"]
    stepper, spec, cfg = sim.stepper, sim.tile_spec, sim.cfg
    geom = cfg.geometry
    state = sim.state
    el = state.species["electrons"]
    origin_t = (geom.prob_lo[0], state.aux["window_lo"])
    el, _ = ttiling.rebin(el, geom, spec, origin=origin_t,
                          wrap_dims=stepper.wrap_dims)
    fields6 = stepper.to_kernel_frame(stepper._padded_eb(state.fields))

    def run(sp):
        st = state.replace(species={**state.species, "electrons": sp})
        ((pname, _, params, parts, counts),) = list(
            pusher_groups(st, spec, stepper.params))
        return binned_push_deposit(
            params, fields6, parts, origin_t, 0, counts=counts, spec=spec,
            geom=geom, order=3, galerkin=True, pusher_name=pname, dt=cfg.dt,
            stag_items=stepper.stag_items, smax=stepper.smax)

    base = run(el)
    k = int(torch.nonzero(el.alive)[0])  # first slot of an occupied tile
    alive = el.alive.clone()
    alive[k] = False
    z = el.z.clone()
    z[k] = z[k] - 40 * geom.dx[1]  # far below its window
    dead = run(el.replace(alive=alive, z=z))
    assert int(dead[2].sum()) == int(base[2].sum()) == 0
    w_k = float(el.w[k])
    lone = run(el.replace(w=torch.where(
        torch.arange(el.capacity) == k, el.w, torch.zeros_like(el.w))))
    for a, b, one in zip(dead[1], base[1], lone[1]):
        assert w_k > 0 and float(one.abs().max()) > 0
        assert_close((a + one).numpy(), b.numpy(), "J less the dead slot")


# ---- the gates ---------------------------------------------------------------

def test_bounded_binned_gate(jax_lwfa):
    """As tests/test_binned_bounded.py::test_bounded_binned_gate, on both
    packages."""
    jcfg = jax_lwfa["cfg"]
    cfg = port_config(jcfg)
    assert bounded_binned_supported(cfg) and j_bounded_binned_supported(jcfg)
    for kw in (dict(current_deposition="direct"), dict(moving_window_dir=0),
               dict(tiled_particles="off"), dict(tile_size=(8, 8, 5)),
               dict(do_dive_cleaning=True)):
        assert not bounded_binned_supported(dataclasses.replace(cfg, **kw))
        assert not j_bounded_binned_supported(
            dataclasses.replace(jcfg, **kw))
    # the standard PSATD solver rides the tile-binned step, as in JAX
    assert bounded_binned_supported(
        dataclasses.replace(cfg, em_solver="psatd"))
    assert j_bounded_binned_supported(
        dataclasses.replace(jcfg, em_solver="psatd"))
    with pytest.raises(NotImplementedError, match="bounded_binned_supported"):
        warpx_tpu_torch.Simulation(
            dataclasses.replace(cfg, moving_window_dir=0),
            dtype=torch.float64, device="cpu")
    auto = dataclasses.replace(cfg, moving_window_dir=0,
                               tiled_particles="auto")
    assert not warpx_tpu_torch.Simulation(auto, dtype=torch.float64,
                                          device="cpu").binned


def _with_species(cfg, i, **kw):
    sp = list(cfg.species)
    sp[i] = dataclasses.replace(sp[i], **kw)
    return dataclasses.replace(cfg, species=tuple(sp))


def _case(change, match, old_id):
    """A case under the id it had when every item below matched a bare
    "Queue A 11" (the ids stay; the matches name the sub-item)."""
    return pytest.param(change, match, id=f"<lambda>-{old_id}")


@pytest.mark.parametrize("change,match", [
    (lambda c: dataclasses.replace(c, em_solver="psatd",
                                   current_deposition="vay"), "Queue C"),
    # ECT runs since Queue A 11.3's second half (tests/test_torch_ect.py);
    # without an embedded boundary the JAX package runs plain Yee for it
    _case(lambda c: dataclasses.replace(c, em_solver="ect"),
          "Queue C", "Queue A 11_0"),
    # Queue A 11.4 ported Silver-Mueller faces, thermal walls, collocated
    # grids, momentum-conserving gathering, do_not_* species and Gaussian
    # continuous injection (tests/test_torch_field_boundaries.py,
    # test_torch_particle_walls.py, test_torch_collocated.py,
    # test_torch_beamline.py, test_torch_continuous_injection.py); what the
    # JAX package refuses there, or runs as something else, names Queue C
    # (the cases keep their ids): Silver-Mueller beside PML, damped and open
    # faces under FDTD, a face periodic on one side, hybrid QED on the
    # bounded step, a 2D lattice, a bounded centering order above 2, PSATD
    # with a Silver-Mueller face, Maxwell-Boltzmann continuous injection
    _case(lambda c: dataclasses.replace(
        c, field_bc_lo=("absorbing_silver_mueller", "pml")),
        "Queue C", "Queue A 11_1"),
    _case(lambda c: dataclasses.replace(c, field_bc_hi=("damped", "pml")),
          "Queue C", "Queue A 11_2"),
    _case(lambda c: dataclasses.replace(c, field_bc_lo=("periodic", "pml")),
          "Queue C", "Queue A 11_3"),
    _case(lambda c: dataclasses.replace(c, use_hybrid_qed=True),
          "Queue C", "Queue A 11_4"),
    # the JAX package refuses a medium off the periodic torus
    _case(lambda c: dataclasses.replace(c, em_solver_medium="macroscopic"),
          "Queue C", "Queue A 11_5"),
    _case(lambda c: dataclasses.replace(c, field_bc_lo=("open", "pml")),
          "Queue C", "Queue A 11_6"),
    # villasenor runs since Queue A 3-4 (tests/test_torch_dims1.py); a
    # window step range the JAX package does not run is refused (the case
    # keeps its id)
    _case(lambda c: dataclasses.replace(c, start_moving_window_step=2),
          "Queue C", "Queue A 3"),
    _case(lambda c: dataclasses.replace(
        c, lattice_elements=(("quad", 0.0, 1e-6, 1e12, 1.0),)), "Queue C",
        "Queue A 11_7"),
    _case(lambda c: dataclasses.replace(
        c, field_gathering="momentum-conserving", field_centering_no=(8, 8)),
        "Queue C", "Queue A 11_8"),
    # the NCI corrector runs on the bounded step since Queue A 11.3
    # (tests/test_torch_nci.py); the hybrid solver, which the JAX package's
    # bounded step advances by Yee, is refused (the case keeps its id)
    pytest.param(lambda c: dataclasses.replace(c, em_solver="hybrid"),
                 "Queue C", id="<lambda>-Queue A 11.3"),
    # the JAX package reads a laser's continuous injection and runs
    # without it; a lasy laser runs since Queue A 11.2
    # (tests/test_torch_laser_file.py), a parsed-field laser is refused by
    # the JAX reader
    _case(lambda c: dataclasses.replace(c, lasers=(dataclasses.replace(
        c.lasers[0], do_continuous_injection=True),)), "Queue C",
        "Queue A 11_9"),
    _case(lambda c: dataclasses.replace(c, lasers=(dataclasses.replace(
        c.lasers[0], profile="parse_field"),)), "Queue C",
        "Queue A 11_10"),
    _case(lambda c: dataclasses.replace(
        c, em_solver="psatd",
        field_bc_lo=("absorbing_silver_mueller", "pml")),
        "Queue C", "Queue A 11_11"),
    (lambda c: _with_species(c, 1, do_qed_quantum_sync=True,
                             qed_product="electrons"), "Queue C"),
    _case(lambda c: _with_species(c, 0,
                                  momentum_distribution="maxwell_boltzmann",
                                  theta=0.01), "Queue C", "Queue A 11_12"),
    _case(lambda c: _with_species(c, 0, profile="predefined"),
          "Queue C", "Queue A 11_13"),
    _case(lambda c: _with_species(c, 0, injection_style="nrandompercell",
                                  num_particles_per_cell=2),
          "Queue C", "Queue A 11_14"),
])
def test_unported_bounded_branches_raise(jax_lwfa, change, match):
    """Every branch of the JAX package's bounded step that the port lacks
    raises NotImplementedError naming its ROADMAP item; none is skipped."""
    cfg = change(port_config(jax_lwfa["cfg"], tiled_particles="off"))
    with pytest.raises(NotImplementedError, match=match):
        warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")


def test_unported_precision_modes_raise_on_bounded_path(jax_lwfa):
    """The bounded step runs K2 at 'mixed' and 'bf16' (their step differs
    from the 'f32' step); a mode the kernel does not have raises."""
    jy = {}
    for mxu in ("f32", "mixed", "bf16", "tf32"):
        cfg = port_config(jax_lwfa["cfg"], tile_mxu=mxu, max_step=2)
        sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64,
                                         device="cpu")
        sim.init()
        if mxu == "tf32":
            with pytest.raises(ValueError, match="tile_mxu"):
                sim.evolve()
            continue
        sim.evolve()
        jy[mxu] = sim.state.fields.jy
    for mxu in ("mixed", "bf16"):
        assert bool(torch.isfinite(jy[mxu]).all())
        assert not torch.equal(jy[mxu], jy["f32"])


def test_lwfa_float32_run(jax_lwfa, port_lwfa):
    """A float32 run keeps float32 tensors and float32 window scalars
    throughout and lands within 1e-4 of the float64 run's checksums."""
    sim = warpx_tpu_torch.Simulation(port_config(jax_lwfa["cfg"]),
                                     dtype=torch.float32, device="cpu")
    sim.init()
    sim.evolve()
    state = sim.state
    for k in ("window_x", "window_lo", "window_hi", "tile_anchor",
              "inject_pos:electrons"):
        assert isinstance(state.aux[k], np.float32), k
    assert state.aux["window_offset"] == 10
    tensors = [state.fields.Ex, state.fields.jz, state.aux["pml:Ex:z"]]
    for sp in state.species.values():
        tensors += [sp.x, sp.z, sp.ux, sp.w]
    assert all(t.dtype == torch.float32 for t in tensors)
    assert_checksums(port_lwfa["on"].checksums(), sim.checksums(), rtol=1e-4)
