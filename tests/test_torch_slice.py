"""The port's periodic slices, 3D and 2D XZ, against the JAX package.

``warpx_tpu_torch.Simulation`` (CPU, float64, the kernels' plain versions)
runs the configurations of ``test_binned.py``'s order-1 cases (16^3 and
32^2, two species, 8 steps, ``sort_interval=3``) and must land on
``warpx_tpu.Simulation``'s checksums, with the JAX package's binned path
(Pallas in interpret mode) and with its per-particle path, at the 1e-9 bar
of ``test_binned.py``.  The port's per-particle step ``pic_step``
(``tiled_particles="off"``) is held to the same bar, once with the current
filter on.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.config import SimConfig as JSimConfig
from warpx_tpu.core.config import SpeciesConfig as JSpeciesConfig
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.solvers.yee import compute_dt_yee as j_compute_dt_yee
from warpx_tpu_torch.core.binned_step import binned_pic_step
from warpx_tpu_torch.core.config import SimConfig, SpeciesConfig
from warpx_tpu_torch.core.grid import Geometry
from warpx_tpu_torch.core.state import state_from_numpy, state_to_numpy
from warpx_tpu_torch.solvers.yee import compute_dt_yee

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-9


def _species(sc):
    return tuple(
        sc(
            name=nm, charge=q, mass=9.1093837015e-31,
            injection_style="nuniformpercell",
            num_particles_per_cell_each_dim=(2, 1, 1),
            profile="constant", density=2.0e24,
            momentum_distribution="gaussian",
            ux_th=0.1, uy_th=0.1, uz_th=0.1,
        )
        for nm, q in (("electrons", -1.602176634e-19),
                      ("positrons", 1.602176634e-19))
    )


def _geom(gc, ndim=3, lx=40e-6):
    n = 16 if ndim == 3 else 32
    return gc(ndim=ndim, n_cell=(n,) * ndim, prob_lo=(-lx / 2,) * ndim,
              prob_hi=(lx / 2,) * ndim, periodic=(True,) * ndim)


def jax_cfg(tiled, ndim=3, **kw):
    geom = _geom(JGeometry, ndim)
    return JSimConfig(
        geometry=geom, max_step=8, dt=j_compute_dt_yee(geom, 0.999),
        particle_shape=1, species=_species(JSpeciesConfig), em_solver="yee",
        tiled_particles=tiled, sort_interval=3, **kw,
    )


def torch_cfg(tiled="on", ndim=3, **kw):
    geom = _geom(Geometry, ndim)
    return SimConfig(
        geometry=geom, max_step=8, dt=compute_dt_yee(geom, 0.999),
        particle_shape=1, species=_species(SpeciesConfig), em_solver="yee",
        tiled_particles=tiled, sort_interval=3, **kw,
    )


def _jax_state_numpy(state):
    f = state.fields
    return {
        "fields": {nm: np.asarray(getattr(f, nm))
                   for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz",
                              "jx", "jy", "jz")},
        "species": {
            nm: {k: None if getattr(sp, k) is None
                 else np.asarray(getattr(sp, k))
                 for k in ("w", "ux", "uy", "uz", "alive", "x", "y", "z")}
            for nm, sp in state.species.items()
        },
        "step": int(state.step),
        "time": float(state.time),
        "aux": {k: np.asarray(v) for k, v in state.aux.items()},
    }


def _jax_runs(ndim):
    """The JAX package's binned run (with its state at step 4 kept, and
    the state one step later) and its per-particle run, both 8 steps."""
    sim_on = JSimulation(jax_cfg("on", ndim))
    sim_on.init()
    sim_on.evolve(4)
    s4 = _jax_state_numpy(sim_on.state)
    s5 = _jax_state_numpy(sim_on._step(sim_on.state))
    sim_on.evolve()
    sim_off = JSimulation(jax_cfg("off", ndim))
    sim_off.init()
    sim_off.evolve()
    return {"on": sim_on.checksums(), "off": sim_off.checksums(),
            "s4": s4, "s5": s5}


@pytest.fixture(scope="module")
def jax_runs():
    return _jax_runs(3)


@pytest.fixture(scope="module")
def jax_runs_2d():
    return _jax_runs(2)


def _torch_checksums(cfg):
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
    sim.init()
    sim.evolve()
    return sim.checksums()


@pytest.fixture(scope="module")
def torch_checksums():
    return _torch_checksums(torch_cfg())


@pytest.fixture(scope="module")
def torch_checksums_2d():
    return _torch_checksums(torch_cfg(ndim=2))


def _assert_checksums(ref, got):
    assert set(ref) == set(got)
    for group in ref:
        assert set(ref[group]) == set(got[group])
        for q in ref[group]:
            if q in ("divB", "divE"):
                continue  # roundoff noise whose value depends on sum order
            a, b = ref[group][q], got[group][q]
            assert abs(a - b) <= RTOL * abs(a) + 1e-300, (group, q, a, b)


@pytest.mark.parametrize("path", ["on", "off"])
def test_slice_checksums_match_jax(jax_runs, torch_checksums, path):
    _assert_checksums(jax_runs[path], torch_checksums)


@pytest.mark.parametrize("path", ["on", "off"])
def test_slice_2d_checksums_match_jax(jax_runs_2d, torch_checksums_2d, path):
    assert "particle_position_y" in torch_checksums_2d["electrons"]
    assert "particle_position_z" not in torch_checksums_2d["electrons"]
    _assert_checksums(jax_runs_2d[path], torch_checksums_2d)


@pytest.mark.parametrize("ndim", [2, 3])
def test_pic_step_matches_jax(jax_runs, jax_runs_2d, ndim):
    """The port's per-particle step against the JAX package's."""
    ref = (jax_runs if ndim == 3 else jax_runs_2d)["off"]
    _assert_checksums(ref, _torch_checksums(torch_cfg("off", ndim)))


@pytest.mark.parametrize("tiled", ["off", "on"])
def test_current_filter_matches_jax(tiled):
    """use_filter with two passes along x and one along z, on the
    per-particle and the binned step, against the JAX per-particle step."""
    kw = dict(use_filter=True, filter_npass_each_dir=(2, 1))
    sim = JSimulation(jax_cfg("off", 2, **kw))
    sim.init()
    sim.evolve()
    got = _torch_checksums(torch_cfg(tiled, 2, **kw))
    _assert_checksums(sim.checksums(), got)
    unfiltered = _torch_checksums(torch_cfg(tiled, 2))
    assert got["lev=0"]["jx"] != unfiltered["lev=0"]["jx"]


@pytest.mark.parametrize("ndim", [3, 2])
def test_state_round_trip_step(jax_runs, jax_runs_2d, ndim):
    """A JAX state at step 4 carried across, stepped once by the port, lands
    on the JAX package's step 5 (no rebin between: the slots line up)."""
    jax_runs = jax_runs if ndim == 3 else jax_runs_2d
    cfg = torch_cfg(ndim=ndim)
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
    sim.init()  # builds the tile spec the JAX run also used
    state = state_from_numpy(jax_runs["s4"], torch.float64, "cpu")
    back = state_to_numpy(state)
    for nm in back["fields"]:
        np.testing.assert_array_equal(back["fields"][nm],
                                      jax_runs["s4"]["fields"][nm])
    out = state_to_numpy(binned_pic_step(state, cfg, sim.staggering,
                                         sim.tile_spec, sim.params))
    ref = jax_runs["s5"]
    assert out["step"] == ref["step"] == 5
    for nm, a in ref["fields"].items():
        scale = np.abs(a).max()
        assert np.abs(out["fields"][nm] - a).max() <= 1e-12 * scale, nm
    for sp, arrs in ref["species"].items():
        np.testing.assert_array_equal(out["species"][sp]["alive"],
                                      arrs["alive"])
        for k in ("x", "y", "z", "ux", "uy", "uz", "w"):
            a = arrs[k]
            if a is None:  # 2D carries no y
                assert ndim == 2 and k == "y"
                assert out["species"][sp][k] is None
                continue
            err = np.abs(out["species"][sp][k] - a).max()
            assert err <= 1e-12 * np.abs(a).max(), (sp, k, err)
    for k in ("tile_overflow", "tile_violations"):
        assert int(out["aux"][k]) == int(ref["aux"][k]) == 0


@pytest.mark.parametrize("kw,match", [
    # villasenor runs since Queue A 3-4 (tests/test_torch_dims1.py); Vay
    # deposition off PSATD is refused (the case keeps its id)
    pytest.param(dict(current_deposition="vay"),
                 "Vay deposition requires the PSATD solver",
                 id="kw0-Queue A 3"),
    # momentum-conserving gathering and collocated grids run since Queue A
    # 11.4 (tests/test_torch_collocated.py); a 2D lattice, whose fields the
    # JAX package adds in 3D only, and hybrid QED off PSATD on a collocated
    # grid are refused (the cases keep their ids)
    pytest.param(dict(lattice_elements=(("quad", 0.0, 1e-6, 1e12, 1.0),)),
                 "Queue C", id="kw1-Queue A 11"),
    # the NCI corrector runs since Queue A 11.3's first half
    # (tests/test_torch_nci.py); ECT runs on the bounded step since its
    # second half, and on the periodic step, where the JAX package drops
    # it for plain Yee, it is refused (the case keeps its id)
    pytest.param(dict(em_solver="ect"), "Queue C",
                 id="kw2-Queue A 11.3"),
    pytest.param(dict(use_hybrid_qed=True), "Queue C",
                 id="kw3-Queue A 11"),
])
def test_pic_step_unported_features_raise(kw, match):
    """What the per-particle step does not cover names its ROADMAP item."""
    import dataclasses

    cfg = dataclasses.replace(torch_cfg("off", 2), max_step=1, **kw)
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
    assert not sim.binned
    sim.init()
    with pytest.raises(NotImplementedError, match=match):
        sim.evolve()


def test_tiled_on_outside_binned_path_raises():
    import dataclasses

    cfg = dataclasses.replace(torch_cfg("on", 2), current_deposition="direct")
    with pytest.raises(NotImplementedError, match="binned_supported"):
        warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
    auto = dataclasses.replace(cfg, tiled_particles="auto")
    assert not warpx_tpu_torch.Simulation(auto, dtype=torch.float64,
                                          device="cpu").binned


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "warpx_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "warpx_tpu"), (path, mod)


def test_simulation_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warpx_tpu_torch.Simulation(torch_cfg())


def test_unported_precision_modes_raise():
    """The TPU kernel's precision modes run ('mixed', 'bf16': their step
    differs from the 'f32' step, ROADMAP.md Queue B K1d); a mode it does
    not have raises."""
    import dataclasses

    ex = {}
    for mxu in ("f32", "mixed", "bf16", "tf32"):
        cfg = dataclasses.replace(torch_cfg(), tile_mxu=mxu, max_step=1)
        sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64,
                                         device="cpu")
        sim.init()
        if mxu == "tf32":
            with pytest.raises(ValueError, match="tile_mxu"):
                sim.evolve()
            continue
        sim.evolve()
        ex[mxu] = sim.state.fields.Ex
    for mxu in ("mixed", "bf16"):
        assert bool(torch.isfinite(ex[mxu]).all())
        assert not torch.equal(ex[mxu], ex["f32"])

