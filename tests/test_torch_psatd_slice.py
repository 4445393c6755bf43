"""The port's periodic PSATD slices, 3D and 2D XZ, against the JAX package.

The two-species plasma of ``test_torch_slice.py`` with the standard PSATD
solver: 16^3 at order 1 with ``psatd_order = 16`` on the guard-padded
boxes (6 steps), and 32^2 at order 3 with one periodic box (6 steps).
``warpx_tpu_torch.Simulation`` on the CPU in float64, binned (the kernels'
plain versions) and per particle, lands on the checksums of
``warpx_tpu.Simulation``'s per-particle run at 1e-9 (the JAX package's
binned run, Pallas in interpret mode, lands on the same checksums but
would double this file's time); divE (spectral in both packages) and divB
agree to 1e-9 of their largest value cell by cell.
"""

import dataclasses

import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.config import SimConfig as JSimConfig
from warpx_tpu.core.config import SpeciesConfig as JSpeciesConfig
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu_torch.core.config import SimConfig, SpeciesConfig
from warpx_tpu_torch.core.grid import Geometry
from warpx_tpu_torch.solvers.psatd import PsatdSolver

from .test_torch_slice import _assert_checksums, _geom, _species

torch.set_num_threads(1)

RTOL = 1e-9
C = 299792458.0
# ndim -> (particle order, stencil order, one periodic box)
CASES = {3: (1, 16, False), 2: (3, 16, True)}


def _cfg(sim_cls, spec_cls, geom_cls, ndim, tiled):
    order, psatd_order, single = CASES[ndim]
    geom = _geom(geom_cls, ndim)
    return sim_cls(
        geometry=geom, max_step=6, dt=0.999 * min(geom.dx) / C,
        particle_shape=order, species=_species(spec_cls), em_solver="psatd",
        psatd_order=psatd_order, psatd_periodic_single_box=single,
        tiled_particles=tiled, sort_interval=3,
    )


def jax_cfg(ndim, tiled):
    return _cfg(JSimConfig, JSpeciesConfig, JGeometry, ndim, tiled)


def torch_cfg(ndim, tiled):
    return _cfg(SimConfig, SpeciesConfig, Geometry, ndim, tiled)


def _run(sim):
    sim.init()
    sim.evolve()
    return {"sums": sim.checksums(),
            "div": {k: np.asarray(v)
                    for k, v in sim.field_diagnostics().items()
                    if k in ("divE", "divB")}}


@pytest.fixture(scope="module", params=[3, 2])
def runs(request):
    """The JAX package's per-particle run and the port's runs, binned and
    per particle, of one dimensionality."""
    ndim = request.param
    out = {"ndim": ndim, "jax": _run(JSimulation(jax_cfg(ndim, "off")))}
    for tiled in ("on", "off"):
        tsim = warpx_tpu_torch.Simulation(torch_cfg(ndim, tiled),
                                          dtype=torch.float64, device="cpu")
        assert tsim.binned == (tiled == "on")
        assert isinstance(tsim.psatd, PsatdSolver)
        assert tsim.psatd.ng == (0 if CASES[ndim][2] else 8)
        out["port", tiled] = _run(tsim)
        if tiled == "on":
            aux = tsim.state.aux
            assert int(aux["tile_overflow"]) == int(aux["tile_violations"]) \
                == 0
    return out


@pytest.mark.parametrize("path", ["on", "off"])
def test_psatd_slice_checksums_match_jax(runs, path):
    """Every checksum but divE/divB of the port's run on ``path``."""
    _assert_checksums(runs["jax"]["sums"], runs["port", path]["sums"])


@pytest.mark.parametrize("path", ["on", "off"])
def test_psatd_slice_div_matches_jax(runs, path):
    """The spectral divE and divB, cell by cell."""
    ref, got = runs["jax"]["div"], runs["port", path]["div"]
    for k in ("divE", "divB"):
        scale = np.abs(ref[k]).max()
        assert scale > 0, k
        assert np.abs(got[k] - ref[k]).max() <= RTOL * scale, k


def test_psatd_fields_moved(runs):
    """The spectral solver did advance the fields: the plasma's current
    made E and B nonzero, and the run differs from a Yee run."""
    sums = runs["port", "on"]["sums"]["lev=0"]
    assert sums["Ex"] > 0 and sums["By"] > 0
    ndim = runs["ndim"]
    cfg = dataclasses.replace(torch_cfg(ndim, "on"), em_solver="yee",
                              max_step=1)
    yee = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
    assert yee.psatd is None
    cfg = dataclasses.replace(torch_cfg(ndim, "on"), max_step=1)
    spec = warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")
    a, b = _run(yee)["sums"]["lev=0"], _run(spec)["sums"]["lev=0"]
    assert a["Ex"] != b["Ex"]
