"""The PSATD families on the port's tile-binned periodic step, against the
JAX package's binned step (Pallas in interpret mode; CPU, float64).

``binned_supported`` is the JAX package's gate line for line: it admits
PSATD without rho deposits (no update-with-rho, no current correction, J
constant in time, no Galilean drift) and does not look at the solution
type, time averaging or the comoving velocity.

* Time averaging and comoving PSATD need update-with-rho in both packages'
  solvers, which the gate refuses: with it off they raise when the solver
  is built, binned or not, so neither family runs binned.
* First-order PSATD with J constant passes the gate.  Both packages' binned
  steps then advance the fields with the solver's standard second-order
  push (at the solution's dt), where the per-particle steps run the
  first-order push: the 32^2 drifting plasma of ``test_torch_psatd_variants
  .py``, 3 steps, lands on JAX's binned checksums at 1e-9 on the binned
  path and on JAX's per-particle ones on the per-particle path, and the
  two paths differ by far more (ROADMAP.md Queue C).
"""

import dataclasses

import pytest
import torch

from warpx_tpu.core.binned_step import binned_supported as j_binned_supported
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu_torch.core.binned_step import binned_supported

from .test_torch_psatd_variants import (C, assert_family_matches, family_cfg,
                                        port_sim, run)

torch.set_num_threads(1)

FIRST_ORDER_J_CONSTANT = dict(psatd_solution_type="first-order")


def _cfgs(tiled, **kw):
    return (dataclasses.replace(family_cfg("jax", 2, None, tiled), **kw),
            dataclasses.replace(family_cfg("port", 2, None, tiled), **kw))


@pytest.mark.parametrize("kw", [
    dict(psatd_time_averaging=True),
    dict(psatd_v_comoving=(0.0, 0.0, 0.4 * C)),
], ids=["averaged", "comoving"])
def test_rho_free_averaged_and_comoving_raise_in_both(kw):
    jcfg, cfg = _cfgs("on", **kw)
    assert binned_supported(cfg) and j_binned_supported(jcfg)
    with pytest.raises(NotImplementedError, match="update_with_rho"):
        JSimulation(jcfg)
    with pytest.raises(NotImplementedError, match="update_with_rho"):
        port_sim(cfg)
    # with update-with-rho on, both gates refuse the binned step
    for c, gate in ((jcfg, j_binned_supported), (cfg, binned_supported)):
        assert not gate(dataclasses.replace(c, psatd_update_with_rho=True))


@pytest.fixture(scope="module")
def first_order_runs():
    out = {}
    for tiled in ("on", "off"):
        jcfg, cfg = _cfgs(tiled, **FIRST_ORDER_J_CONSTANT)
        out["jax", tiled] = run(JSimulation(jcfg))
        sim = port_sim(cfg)
        assert sim.binned == (tiled == "on")
        out["port", tiled] = run(sim)
        if tiled == "on":
            aux = sim.state.aux
            assert int(aux["tile_overflow"]) == 0
            assert int(aux["tile_violations"]) == 0
    return out


@pytest.mark.parametrize("tiled", ["on", "off"])
def test_first_order_j_constant_matches_jax_path(first_order_runs, tiled):
    assert_family_matches(first_order_runs["jax", tiled],
                          first_order_runs["port", tiled])


def test_first_order_binned_and_per_particle_paths_differ(first_order_runs):
    """The JAX package's two paths run different pushes for this family;
    the port keeps the difference rather than hiding it."""
    for pkg in ("jax", "port"):
        a = first_order_runs[pkg, "on"]["sums"]["lev=0"]["By"]
        b = first_order_runs[pkg, "off"]["sums"]["lev=0"]["By"]
        assert abs(a - b) > 1e-3 * abs(b)
