"""The PSATD families beyond the standard one on the port's periodic
per-particle step, 2D XZ, against the JAX package.

The two-species plasma of ``test_torch_slice.py`` drifting along z at
0.3 c, 32^2 at order 1 with ``psatd_order = 16`` on the guard-padded box
and the bilinear filter on, 3 steps, one run per family:

* Galilean PSATD (update-with-rho on, as the deck reader's default for a
  Galilean run), with and without time averaging;
* current correction with direct deposition;
* multi-J, second order (J linear in time, direct deposition, current
  correction as the deck's default);
* multi-J, first order with two depositions, J and rho linear, F/G
  cleaning;
* Vay deposition; direct deposition;
* standard PSATD with ``do_dive_cleaning`` and ``do_divb_cleaning``;
* comoving PSATD (direct deposition, update-with-rho on).

``warpx_tpu_torch.Simulation`` (CPU, float64) lands on the checksums of
``warpx_tpu.Simulation`` at 1e-9, and divE (spectral) and divB agree to
1e-9 of their largest value cell by cell.  The one exception is G, the
div(B) cleaning scalar of the first-order family: div B is zero up to
roundoff, so G is roundoff that the two packages' FFTs sum in different
orders; it is held at 1e-9 of c times the B checksums, the scale the
update G += i c S/|k| k.B gives it.  ``tests/test_torch_psatd_variants_3d
.py`` runs the same families at 16^3.

Also here: the PSATD combinations the JAX deck reader refuses raise
``NotImplementedError`` in both packages, and a restart of a time-averaged
Galilean deck from a checkpoint repeats the uninterrupted run bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.config import SimConfig as JSimConfig
from warpx_tpu.core.config import SpeciesConfig as JSpeciesConfig
from warpx_tpu.core.deck import config_from_deck as jax_config_from_deck
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.config import SimConfig, SpeciesConfig
from warpx_tpu_torch.core.deck import config_from_deck
from warpx_tpu_torch.core.grid import Geometry
from warpx_tpu_torch.core.state import state_to_numpy
from warpx_tpu_torch.io.checkpoint import load_checkpoint
from warpx_tpu_torch.solvers.psatd import PsatdFirstOrder, PsatdSolver
from warpx_tpu_torch.utils.parser import Deck

torch.set_num_threads(1)

RTOL = 1e-9
C = 299792458.0

# family -> the SimConfig fields that select it
FAMILIES = {
    "galilean": dict(psatd_v_galilean=(0.0, 0.0, 0.5 * C),
                     psatd_update_with_rho=True),
    "averaged": dict(psatd_v_galilean=(0.0, 0.0, 0.3 * C),
                     psatd_update_with_rho=True, psatd_time_averaging=True),
    "current_correction": dict(current_deposition="direct",
                               psatd_current_correction=True),
    "multi_j": dict(current_deposition="direct", psatd_j_in_time="linear",
                    psatd_current_correction=True),
    "first_order": dict(current_deposition="direct",
                        psatd_solution_type="first-order",
                        psatd_j_in_time="linear", multi_j_n_depositions=2,
                        do_dive_cleaning=True, do_divb_cleaning=True,
                        psatd_update_with_rho=True),
    "vay": dict(current_deposition="vay"),
    "direct": dict(current_deposition="direct"),
    "cleaning": dict(do_dive_cleaning=True, do_divb_cleaning=True,
                     psatd_update_with_rho=True),
    "comoving": dict(current_deposition="direct",
                     psatd_v_comoving=(0.0, 0.0, 0.4 * C),
                     psatd_update_with_rho=True),
}


def _species(sc):
    return tuple(
        sc(name=nm, charge=q, mass=9.1093837015e-31,
           injection_style="nuniformpercell",
           num_particles_per_cell_each_dim=(2, 1, 1), profile="constant",
           density=2.0e24, momentum_distribution="gaussian",
           ux_th=0.1, uy_th=0.1, uz_th=0.1, uz=0.3)
        for nm, q in (("electrons", -1.602176634e-19),
                      ("positrons", 1.602176634e-19)))


def family_cfg(package, ndim, family, tiled="off", steps=3):
    """The configuration of ``family`` in ``package`` ("jax" | "port")."""
    sim_cls, spec_cls, geom_cls = {
        "jax": (JSimConfig, JSpeciesConfig, JGeometry),
        "port": (SimConfig, SpeciesConfig, Geometry)}[package]
    n = 16 if ndim == 3 else 32
    lx = 40e-6
    geom = geom_cls(ndim=ndim, n_cell=(n,) * ndim,
                    prob_lo=(-lx / 2,) * ndim, prob_hi=(lx / 2,) * ndim,
                    periodic=(True,) * ndim)
    return sim_cls(
        geometry=geom, max_step=steps, dt=0.999 * min(geom.dx) / C,
        particle_shape=1, species=_species(spec_cls), em_solver="psatd",
        psatd_order=16, tiled_particles=tiled, sort_interval=3,
        use_filter=True, **FAMILIES.get(family, {}))


def run(sim):
    sim.init()
    sim.evolve()
    return {"sums": sim.checksums(),
            "div": {k: np.asarray(v)
                    for k, v in sim.field_diagnostics().items()
                    if k in ("divE", "divB")}}


def assert_family_matches(ref, got):
    """Every checksum at RTOL (G at RTOL of c times the B checksums, see
    the module docstring) and divE/divB cell by cell."""
    a, b = ref["sums"], got["sums"]
    assert set(a) == set(b)
    for group in a:
        assert set(a[group]) == set(b[group]), group
        for q, v in a[group].items():
            if q in ("divE", "divB"):
                continue
            scale = abs(v)
            if q == "G":
                scale = C * sum(a[group][k] for k in ("Bx", "By", "Bz"))
            assert abs(b[group][q] - v) <= RTOL * scale + 1e-300, (
                group, q, v, b[group][q])
    assert np.abs(ref["div"]["divE"]).max() > 0
    for k in ("divE", "divB"):
        # divB is exactly zero in some families: then so must the port's be
        scale = np.abs(ref["div"][k]).max()
        assert np.abs(got["div"][k] - ref["div"][k]).max() <= RTOL * scale, k


def port_sim(cfg):
    return warpx_tpu_torch.Simulation(cfg, dtype=torch.float64, device="cpu")


def check_family(ndim, family):
    jax_run = run(JSimulation(family_cfg("jax", ndim, family)))
    sim = port_sim(family_cfg("port", ndim, family))
    assert not sim.binned
    want = PsatdFirstOrder if family == "first_order" else PsatdSolver
    assert type(sim.psatd) is want
    got = run(sim)
    assert_family_matches(jax_run, got)
    return sim


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_2d_matches_jax(family):
    sim = check_family(2, family)
    f = sim.state.fields
    assert (f.F is not None) == sim.cfg.do_dive_cleaning
    assert (f.G is not None) == sim.cfg.do_divb_cleaning
    assert (f.Ex_avg is not None) == sim.cfg.psatd_time_averaging
    if family in ("first_order",):
        # F/G evolve in the first-order family only: the second-order
        # periodic solver of the JAX package is built without cleaning
        assert float(f.F.abs().max()) > 0
    if family == "cleaning":
        assert float(f.F.abs().max()) == 0.0
    if family == "averaged":
        assert float(f.Ex_avg.abs().max()) > 0


# ----------------------------------------------------------------- deck gates
_GATE_BASE = """
max_step = 2
amr.n_cell = 16 16
geometry.dims = 2
geometry.prob_lo = -8.e-6 -8.e-6
geometry.prob_hi =  8.e-6  8.e-6
algo.maxwell_solver = psatd
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.profile = constant
electrons.density = 1.e24
"""


@pytest.mark.parametrize("extra,match", [
    ("psatd.rho_in_time = constant", "rho_in_time=constant"),
    ("warpx.do_multi_J = 1\nwarpx.do_multi_J_n_depositions = 2",
     "n_depositions > 1"),
    ("psatd.solution_type = first-order\nwarpx.do_multi_J = 1\n"
     "boundary.field_lo = pml periodic\nboundary.field_hi = pml periodic",
     "non-periodic"),
    ("psatd.solution_type = first-order\nwarpx.do_multi_J = 1\n"
     "psatd.do_time_averaging = 1", "time averaging"),
    ("warpx.do_multi_J = 1\nalgo.current_deposition = vay", "multi-J"),
    ("psatd.v_comoving = 0. 0. 0.5\nalgo.current_deposition = esirkepov",
     "comoving"),
])
def test_jax_deck_gates_raise_in_both(extra, match):
    """The combinations the reference aborts on raise in both readers."""
    text = _GATE_BASE + extra + "\n"
    with pytest.raises(NotImplementedError, match=match):
        jax_config_from_deck(JDeck.from_string(text))
    with pytest.raises(NotImplementedError, match=match):
        config_from_deck(Deck.from_string(text))


@pytest.mark.parametrize("extra", [
    "", "warpx.do_multi_J = 1",
    "psatd.solution_type = first-order\nwarpx.do_multi_J = 1\n"
    "warpx.do_multi_J_n_depositions = 2\npsatd.rho_in_time = constant\n"
    "psatd.J_in_time = constant\nwarpx.do_dive_cleaning = 1\n"
    "warpx.do_divb_cleaning = 1",
    "psatd.v_galilean = 0. 0. 0.5\npsatd.do_time_averaging = 1",
    "algo.current_deposition = vay",
])
def test_psatd_decks_read_as_jax_reads_them(extra):
    """A PSATD deck without a deposition key gets direct deposition (and
    current correction by default), and each family's keys land on the
    same configuration as the JAX reader's."""
    from .test_torch_bounded_util import port_config

    text = _GATE_BASE + extra + "\n"
    got = config_from_deck(Deck.from_string(text))
    assert got == port_config(jax_config_from_deck(JDeck.from_string(text)))
    if not extra:
        assert got.current_deposition == "direct"
        assert got.psatd_current_correction


# -------------------------------------------------------------------- restart
_AVG_DECK = _GATE_BASE.replace("max_step = 2", "max_step = 6") + """
algo.current_deposition = esirkepov
psatd.v_galilean = 0. 0. 0.4
psatd.do_time_averaging = 1
electrons.momentum_distribution_type = constant
electrons.uz = 0.4
diagnostics.diags_names = chk
chk.format = checkpoint
chk.intervals = 3:3
"""


def test_time_averaged_restart_is_bitwise(tmp_path):
    """A checkpoint at step 3 of the time-averaged Galilean deck carries
    the averaged fields; the restarted run repeats steps 4-6 bit for bit."""
    def make(out):
        sim = warpx_tpu_torch.Simulation.from_deck(
            Deck.from_string(_AVG_DECK), dtype=torch.float64, device="cpu",
            output_dir=str(out))
        sim.init()
        return sim

    ref = make(tmp_path / "a")
    assert not ref.binned and ref.psatd.time_averaging
    ref.evolve()
    want = state_to_numpy(ref.state)
    assert "Ex_avg" in want["fields"]
    with np.load(tmp_path / "a" / "chk000003" / "state.npz") as data:
        assert {"fields/Ex_avg", "fields/Bz_avg"} <= set(data.files)
    sim = make(tmp_path / "b")
    sim.state, sim.is_synchronized = load_checkpoint(
        str(tmp_path / "a" / "chk000003"), sim.state)
    assert sim.state.step == 3
    assert float(sim.state.fields.Ez_avg.abs().max()) > 0
    sim.evolve()
    got = state_to_numpy(sim.state)
    assert got["step"] == want["step"] == 6 and got["time"] == want["time"]
    assert set(got["fields"]) == set(want["fields"])
    for nm, a in want["fields"].items():
        np.testing.assert_array_equal(got["fields"][nm], a, err_msg=nm)
    for name, sp in want["species"].items():
        for k, a in sp.items():
            np.testing.assert_array_equal(got["species"][name][k], a,
                                          err_msg=f"{name}.{k}")


def test_cleaning_fields_in_state_and_output():
    """F and G ride the state (zero-initialized) and the diagnostics where
    the configuration carries them, as in the JAX package."""
    cfg = dataclasses.replace(family_cfg("port", 2, "first_order"),
                              max_step=1)
    sim = port_sim(cfg)
    sim.init()
    f = sim.state.fields
    assert f.F.shape == f.G.shape == f.Ex.shape
    assert float(f.F.abs().max()) == float(f.G.abs().max()) == 0.0
    sim.evolve()
    out = sim.field_diagnostics()
    assert {"F", "G"} <= set(out)
    assert state_to_numpy(sim.state)["fields"]["F"].shape == (32, 32)
