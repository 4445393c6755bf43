"""Back-transformed diagnostics in the port against the JAX package.

A 2D cut of ``tests/test_btd.py::test_btd_vacuum_pulse`` (that test is 1D
and slow): an x-uniform right-moving vacuum pulse in the boosted frame at
gamma = 2, x and z periodic, 256 cells along z (a pulse of 25 of them:
the plane samples the nearest cell, off by up to one, so the 5 % gate
needs ~20 cells per sigma), 120 steps, through both
packages' ``BTDSnapshots`` on the same run: rows, ``filled`` and
``z_lab_centers`` at 1e-9, and the analytic lab-frame pulse at the JAX
test's 5 % gate.  The deck route (``diag_type = BackTransformed`` on the
boosted 32 x 64 laser-wakefield deck): the ``.npz`` files equal the JAX
package's at 1e-9.  The slab path (``cell_centered_slice``, rho from the
particles near the plane) bitwise against the whole-grid
``cell_centered_output``.  CPU, float64.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.config import SimConfig as JSimConfig
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.diagnostics.btd import BTDSnapshots as JBTDSnapshots
from warpx_tpu.solvers.yee import compute_dt_yee as j_compute_dt_yee
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.diagnostics.btd import BTDSnapshots
from warpx_tpu_torch.diagnostics.fields import (cell_centered_output,
                                                cell_centered_slice)
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_bounded_util import LWFA_2D, assert_close, port_config

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

C = 299792458.0
BOOST = "warpx.gamma_boost = 10.\nwarpx.boost_direction = z\n"
# the deck's lab window moved to z in [-10, 24] um: the JAX package's lab
# snapshot domain starts at prob_lo_boost / gamma, so on the deck's own
# [-28, 6] um positive lab times would fill no row for hundreds of steps
BTD_DECK = (LWFA_2D.replace("max_step = 12", "max_step = 6")
            .replace("geometry.prob_lo = -15.e-6 -28.e-6",
                     "geometry.prob_lo = -15.e-6 -10.e-6")
            .replace("geometry.prob_hi =  15.e-6   6.e-6",
                     "geometry.prob_hi =  15.e-6  24.e-6")
            .replace("laser1.position = 0. 0. -10.e-6",
                     "laser1.position = 0. 0. 20.e-6")
            + BOOST
            + "diagnostics.diags_names = btd1\n"
              "btd1.diag_type = BackTransformed\n"
              "btd1.num_snapshots_lab = 4\n"
              "btd1.dt_snapshots_lab = 2.e-12\n"
              "tpu.tiled_particles = off\n")


@pytest.fixture(scope="module")
def pulse(tmp_path_factory):
    """The vacuum pulse through both packages, one BTD snapshot each."""
    gamma = 2.0
    beta = np.sqrt(1.0 - 1.0 / gamma**2)
    L, n = 100e-6, 256
    dz = L / n
    jgeom = JGeometry(2, (8, n), (0.0, 0.0), (8 * 4 * dz, L), (True, True))
    jcfg = JSimConfig(geometry=jgeom, max_step=120,
                      dt=j_compute_dt_yee(jgeom, 0.999), species=(),
                      em_solver="yee", gamma_boost=gamma, use_filter=False,
                      tiled_particles="off")
    tcfg = port_config(jcfg)
    jsim = JSimulation(jcfg)
    jsim.init()
    tsim = warpx_tpu_torch.Simulation(tcfg, dtype=torch.float64,
                                      device="cpu")
    tsim.init()
    # boosted-frame pulse: Ex' = E0' exp(-(z'-zc')^2 / 2 sigma'^2), By' =
    # Ex'/c, each at its own staggered z
    E0p, zcp, sigp = 1.0e8, 30e-6, 10e-6
    init = {}
    for nm, amp in (("Ex", E0p), ("By", E0p / C)):
        off = 0.0 if jsim.staggering[nm][1] else 0.5
        z = (np.arange(n) + off) * dz
        prof = amp * np.exp(-((z - zcp) ** 2) / (2 * sigp**2))
        init[nm] = np.broadcast_to(prof, (8, n)).copy()
    jsim.state = jsim.state.replace(fields=jsim.state.fields.replace(
        **{nm: jnp.asarray(a) for nm, a in init.items()}))
    tsim.state = tsim.state.replace(fields=tsim.state.fields.replace(
        **{nm: torch.from_numpy(a) for nm, a in init.items()}))
    # one snapshot timed so that the plane crosses the pulse early on
    t_lab = gamma * beta * (zcp + 20e-6) / C
    out = tmp_path_factory.mktemp("btd")
    jbtd = JBTDSnapshots("btd", jcfg, 1, t_lab, ["Ex", "By"],
                         str(out / "jax"))
    tbtd = BTDSnapshots("btd", tcfg, 1, t_lab, ["Ex", "By"],
                        str(out / "port"))
    # snapshot i sits at i * dt_snapshots_lab: move the one snapshot to
    # t_lab, as tests/test_btd.py does
    jbtd.t_lab = tbtd.t_lab = [t_lab]
    for _ in range(jcfg.max_step):
        jsim.evolve(1)
        jbtd.update(jsim)
        tsim.evolve(1)
        tbtd.update(tsim)
    return dict(gamma=gamma, beta=beta, t_lab=t_lab, E0p=E0p, zcp=zcp,
                sigp=sigp, jbtd=jbtd, tbtd=tbtd, out=out)


def test_pulse_rows_match_jax(pulse):
    jbtd, tbtd = pulse["jbtd"], pulse["tbtd"]
    # the plane left the domain: the snapshot was written and closed
    assert jbtd.done == tbtd.done == [True]
    np.testing.assert_array_equal(tbtd.filled[0], jbtd.filled[0])
    np.testing.assert_array_equal(tbtd.z_lab_centers(0),
                                  jbtd.z_lab_centers(0))
    got, ref = tbtd.snapshot(0), jbtd.snapshot(0)
    for nm in ("Ex", "By"):
        assert_close(got[nm], ref[nm], nm, tol=1e-9)
    with np.load(pulse["out"] / "jax" / "btd_snapshot00000.npz") as a, \
            np.load(pulse["out"] / "port" / "btd_snapshot00000.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert b[k].dtype == a[k].dtype, k
            assert_close(b[k], a[k], k, tol=1e-9)


def test_pulse_is_the_analytic_lab_pulse(pulse):
    """The snapshot at t_lab is Ex_lab(z_lab) = gamma (1 + beta) Ex'(zeta')
    with the contraction zeta_lab = gamma (1 - beta) zeta', to 5 % (the
    gate of tests/test_btd.py)."""
    tbtd = pulse["tbtd"]
    g, b = pulse["gamma"], pulse["beta"]
    filled = tbtd.filled[0]
    assert filled.sum() > 40
    zl = tbtd.z_lab_centers(0)
    contr = g * (1.0 - b)
    amp = g * (1.0 + b) * pulse["E0p"]
    th = amp * np.exp(-((zl - C * pulse["t_lab"] - contr * pulse["zcp"]) ** 2)
                      / (2 * (contr * pulse["sigp"]) ** 2))
    m = filled & (np.abs(th) > 0.05 * amp)
    assert m.sum() > 5
    snap = tbtd.snapshot(0)
    for nm, scale in (("Ex", 1.0), ("By", C)):
        rows = snap[nm][0]  # x-uniform: any x
        np.testing.assert_array_equal(snap[nm], np.broadcast_to(
            rows, snap[nm].shape))
        assert np.abs(rows[m] * scale - th[m]).max() / amp < 0.05, nm


def test_btd_deck_route_matches_jax(tmp_path):
    """diag_type = BackTransformed on the boosted 32 x 64 deck, 4 snapshots
    with the default fields (rho included): the files written by
    ``finalize`` (the JAX package's Simulation never calls it) equal the
    JAX package's."""
    jsim = JSimulation.from_deck(JDeck.from_string(BTD_DECK),
                                 output_dir=str(tmp_path / "jax"))
    tsim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(BTD_DECK), dtype=torch.float64, device="cpu",
        output_dir=str(tmp_path / "port"))
    assert [b.fields for b in tsim.btd] == [b.fields for b in jsim.btd]
    for sim in (jsim, tsim):
        sim.init()
        sim.evolve()
    (jb,), (tb,) = jsim.btd, tsim.btd
    assert tb.filled[0].sum() >= 5 and not any(tb.done)
    for i in range(4):
        np.testing.assert_array_equal(tb.filled[i], jb.filled[i])
    jb.finalize()
    tb.finalize()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    for nm in names:
        with np.load(tmp_path / "jax" / nm) as a, \
                np.load(tmp_path / "port" / nm) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert_close(b[k], a[k], (nm, k), tol=1e-9)


@pytest.mark.parametrize("tiled", ["on", "off"])
def test_slab_slice_bitwise(tiled):
    """``cell_centered_slice`` (as ``BTDSnapshots`` calls it) equals the
    whole-grid ``cell_centered_output`` bit for bit on every plane, its rho
    deposited, tile-binned, by the slots of the tiles that reach the plane
    or by the particles selected near it (the plan of a step that
    injected: no particle without room), and near the bounded faces or per
    particle by all of them."""
    text = (LWFA_2D.replace("amr.n_cell = 32 64", "amr.n_cell = 32 256")
            .replace("max_step = 12", "max_step = 6") + BOOST
            + f"tpu.tiled_particles = {tiled}\n")
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float64, device="cpu")
    sim.init()
    sim.evolve()
    names = ["Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz", "rho"]
    whole = cell_centered_output(sim.state, sim.cfg, sim.staggering,
                                 names=names)
    assert float(whole["rho"].abs().max()) > 0
    btd = BTDSnapshots("b", sim.cfg, 1, 0.0, ["Ex"], "")
    overflow, kinds = [], set()
    for k in range(0, 256, 5):
        for injected in (False, True):
            plan = btd.slab_plan(sim, k, injected)
            assert bool(plan) == (tiled == "on")
            kinds.update(how for how, _ in plan.values())
            got = cell_centered_slice(sim.state, sim.cfg, sim.staggering,
                                      names, k, overflow, plan)
            for nm in names:
                assert torch.equal(got[nm], whole[nm][..., k]), (k, nm)
    if tiled == "on":
        assert kinds == {"slots", "room"}
        assert len(overflow) > 10 and all(int(o) == 0 for o in overflow)
        assert btd.slab_plan(sim, 100)["electrons"][1].numel() < (
            sim.tile_spec.capacity)
    else:  # no bound on a slab's particles: all of them deposit
        assert not overflow
