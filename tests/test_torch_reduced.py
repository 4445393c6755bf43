"""The port's reduced diagnostics (``diagnostics/reduced.py``) against the
JAX package's ``compute_reduced``, kind by kind.

Each case starts from a JAX state carried across with ``state_from_numpy``
after its fields and momenta were made random (so that no value is a
trivial zero): the 32 x 64 laser-wakefield deck as initialised (2D,
PML, a moving window, electrons, beam and antenna) and the two-beam 8^3
periodic plasma of ``tests/test_reduced_new.py`` (3D).  The parameterized
kinds take the parameters of ``tests/test_reduced_new.py`` and
``tests/test_io.py``, and more.  The columns must be the JAX package's, in
its order, and every value within 1e-9 of its own.  CPU, float64.
"""

import numpy as np
import pytest
import torch

from warpx_tpu import constants as jconstants
from warpx_tpu.core.config import SimConfig as JSimConfig
from warpx_tpu.core.config import SpeciesConfig as JSpeciesConfig
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.diagnostics.reduced import REDUCED_DIAGS as J_REDUCED
from warpx_tpu.diagnostics.reduced import compute_reduced as j_compute
from warpx_tpu.solvers.yee import compute_dt_yee
from warpx_tpu_torch.core.grid import yee_staggering
from warpx_tpu_torch.core.state import state_from_numpy
from warpx_tpu_torch.diagnostics.reduced import REDUCED_DIAGS, compute_reduced

from .test_torch_bounded_util import (LWFA_2D, jax_config, jax_state_numpy,
                                      jax_state_replace, port_config,
                                      randomize_fields)

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

RTOL = 1e-9
Q_E, M_E = jconstants.q_e, jconstants.m_e


def _two_beam_cfg(uz=1000.0):
    """tests/test_reduced_new.py::_two_beam_sim's configuration."""
    geom = JGeometry(3, (8, 8, 8), (-1e-5,) * 3, (1e-5,) * 3, (True,) * 3)

    def beam(nm, q, uzv):
        return JSpeciesConfig(
            name=nm, charge=q, mass=M_E, injection_style="nrandompercell",
            num_particles_per_cell=8, profile="constant", density=1e20,
            momentum_distribution="constant", uz=uzv)

    return JSimConfig(
        geometry=geom, max_step=2, dt=compute_dt_yee(geom, 0.9),
        species=(beam("beam1", -Q_E, uz), beam("beam2", Q_E, -uz)),
        use_filter=False)


def _one_per_cell(data, name, geom):
    """Keep the first particle of each cell alive in species ``name``: a
    cell then holds at most one, and DifferentialLuminosity's pairing does
    not depend on its in-cell shuffle."""
    sp = data["species"][name]
    cell = np.zeros(sp["w"].shape[0], np.int64)
    for d, ax in enumerate("xyz"):
        i = np.floor((sp[ax] - geom.prob_lo[d]) / geom.dx[d]).astype(np.int64)
        cell = cell * geom.n_cell[d] + np.clip(i, 0, geom.n_cell[d] - 1)
    cell = np.where(sp["alive"], cell, -1)
    _, first = np.unique(cell, return_index=True)
    alive = np.zeros_like(sp["alive"])
    alive[first] = True
    sp["alive"] = alive & sp["alive"]


def _randomize_momenta(data, seed):
    rng = np.random.default_rng(seed)
    for sp in data["species"].values():
        for k in ("ux", "uy", "uz"):
            sp[k] = sp[k] + rng.normal(size=sp[k].shape) * 3e6


@pytest.fixture(scope="module")
def states():
    """{"2d"|"3d": (JAX simulation, numpy state)}."""
    out = {}
    jsim = JSimulation(jax_config(LWFA_2D, "on"))
    jsim.init()
    data = randomize_fields(jax_state_numpy(jsim.state), seed=3)
    _randomize_momenta(data, seed=4)
    # off the axis: the electrons' mean x is no roundoff around zero
    el = data["species"]["electrons"]
    el["x"] = el["x"] + 1e-6
    out["2d"] = (jsim, data)
    jsim = JSimulation(_two_beam_cfg())
    jsim.init()
    data = randomize_fields(jax_state_numpy(jsim.state), seed=5)
    _randomize_momenta(data, seed=6)
    _one_per_cell(data, "beam2", jsim.cfg.geometry)
    out["3d"] = (jsim, data)
    return out


_PLAIN = ["FieldEnergy", "ParticleEnergy",
          "ParticleMomentum", "ParticleNumber", "ParticleExtrema",
          "RhoMaximum", "LoadBalanceEfficiency", "Timestep",
          "LoadBalanceCosts"]

CASES = {
    **{(dim, kind, None): None for dim in ("2d", "3d") for kind in _PLAIN},
    # on the bounded 2D block see test_field_maximum_and_momentum_bounded
    ("3d", "FieldMaximum", None): None,
    ("3d", "FieldMomentum", None): None,
    ("2d", "BeamRelevant", "beam"): {"species": "beam"},
    ("3d", "BeamRelevant", "beam1"): {"species": "beam1"},
    ("2d", "ParticleHistogram", "uz"): {
        "species": "electrons", "bin_number": 8, "bin_min": -0.02,
        "bin_max": 0.02, "histogram_function": "uz"},
    ("3d", "ParticleHistogram", "test_io"): {
        "species": "beam1", "bin_number": 8, "bin_min": 990.0,
        "bin_max": 1010.0, "histogram_function": "uz"},
    ("2d", "ParticleHistogram", "filter_unity"): {
        "species": "beam", "bin_number": 12, "bin_min": -2e-5,
        "bin_max": 2e-5, "histogram_function": "x + 0.1e-6*ux",
        "filter_function": "z > -14.e-6", "normalization":
        "unity_particle_weight"},
    ("2d", "ParticleHistogram2D", "x_uz"): {
        "species": "electrons", "bin_number_abs": 6, "bin_number_ord": 5,
        "bin_min_abs": -12e-6, "bin_max_abs": 12e-6, "bin_min_ord": -0.02,
        "bin_max_ord": 0.02, "histogram_function_abscissa": "x",
        "histogram_function_ordinate": "uz", "value_function": "w*ux",
        "filter_function": "z > -10.e-6"},
    ("2d", "FieldProbe", "window"): {"x_probe": 2e-6, "z_probe": -9e-6},
    ("3d", "FieldProbe", "test_io"): {"x_probe": 0.0, "y_probe": 0.0,
                                      "z_probe": 0.0},
    ("2d", "FieldReduction", "integral"): {
        "reduced_function": "x*Ey*Ey + z*jz", "reduction_type": "Integral"},
    ("3d", "FieldReduction", "test_io"): {
        "reduced_function": "Ex*Ex+Ey*Ey+Ez*Ez", "reduction_type": "Maximum"},
    ("3d", "FieldReduction", "minimum"): {
        "reduced_function": "y*Bz - Ex", "reduction_type": "Minimum"},
    ("2d", "ColliderRelevant", "electrons_beam"): {
        "species": "electrons beam"},
    ("3d", "ColliderRelevant", "test_reduced_new"): {
        "species": ["beam1", "beam2"]},
    ("3d", "DifferentialLuminosity", "test_reduced_new"): {
        "species": ["beam1", "beam2"], "bin_number": 40,
        "bin_min": 0.5 * 2 * np.sqrt(1 + 1000.0**2) * M_E * 299792458.0**2
        / Q_E, "bin_max": 1.5 * 2 * np.sqrt(1 + 1000.0**2) * M_E
        * 299792458.0**2 / Q_E},
    ("2d", "DifferentialLuminosity", "beam_electrons"): {
        "species": "beam electrons", "bin_number": 30, "bin_min": 0.0,
        "bin_max": 3e7},
}


def test_the_port_has_the_jax_kinds():
    assert list(REDUCED_DIAGS) == list(J_REDUCED)
    ported = {kind for _, kind, _ in CASES} | {"FieldMaximum",
                                                "FieldMomentum"}
    # ChargeOnEB is held to the JAX package in tests/test_torch_ect.py
    assert ported | {"ChargeOnEB"} == set(J_REDUCED)


@pytest.mark.parametrize("case", sorted(CASES, key=str),
                         ids=lambda c: "-".join(str(x) for x in c))
def test_reduced_matches_jax(states, case):
    dim, kind, _ = case
    params = CASES[case]
    jsim, data = states[dim]
    jstate = jax_state_replace(jsim.state, data)
    ref = j_compute(kind, jstate, jsim.cfg, jsim.staggering, params=params)
    cfg = port_config(jsim.cfg)
    state = state_from_numpy(data, torch.float64, "cpu")
    got = compute_reduced(kind, state, cfg, yee_staggering(cfg.geometry.ndim),
                          params=params)
    assert list(got) == list(ref)
    vals = np.array(list(ref.values()))
    assert np.all(np.isfinite(vals)) and np.any(vals != 0), ref
    for k, v in ref.items():
        assert abs(got[k] - v) <= RTOL * abs(v) + 1e-300, (k, got[k], v)


def test_field_maximum_and_momentum_bounded(states):
    """On the bounded 2D block the staggered arrays differ in shape and the
    JAX package's FieldMaximum and FieldMomentum raise; the port combines
    the physical region's cell-centered E and B there (the reference's
    Interp to cell centers), held against the JAX package's
    cell_centered_output.  The per-component maxima stay the arrays'."""
    from warpx_tpu.diagnostics.fields import cell_centered_output
    from warpx_tpu_torch.constants import ep0

    jsim, data = states["2d"]
    jstate = jax_state_replace(jsim.state, data)
    for kind in ("FieldMaximum", "FieldMomentum"):
        with pytest.raises(TypeError, match="incompatible shapes"):
            j_compute(kind, jstate, jsim.cfg, jsim.staggering)
    cc = cell_centered_output(jstate, jsim.cfg, jsim.staggering)
    cfg = port_config(jsim.cfg)
    state = state_from_numpy(data, torch.float64, "cpu")
    stag = yee_staggering(2)
    got = compute_reduced("FieldMaximum", state, cfg, stag)
    want = {f"max_{nm}_lev0": np.abs(data["fields"][nm]).max()
            for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")}
    for v in "EB":
        want[f"max_|{v}|_lev0"] = np.sqrt(sum(
            cc[v + c] ** 2 for c in "xyz")).max()
    assert list(got) == list(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= RTOL * abs(v), (k, got[k], v)
    got = compute_reduced("FieldMomentum", state, cfg, stag)
    dv = jsim.cfg.geometry.cell_volume
    cross = {"x": ("y", "z"), "y": ("z", "x"), "z": ("x", "y")}
    for c, (a, b) in cross.items():
        p = ep0 * dv * np.sum(cc["E" + a] * cc["B" + b]
                              - cc["E" + b] * cc["B" + a])
        v = got[f"momentum_{c}_lev0(kg*m/s)"]
        assert abs(v - p) <= RTOL * abs(p), (c, v, p)


def test_charge_on_eb_raises():
    """ChargeOnEB runs since Queue A 11.3's second half
    (tests/test_torch_ect.py); without an embedded boundary it raises as
    the JAX package's does."""
    jsim = JSimulation(_two_beam_cfg())
    cfg = port_config(jsim.cfg)
    with pytest.raises(ValueError,
                       match="ChargeOnEB requires an embedded boundary"):
        J_REDUCED["ChargeOnEB"](None, jsim.cfg, {}, {})
    with pytest.raises(ValueError,
                       match="ChargeOnEB requires an embedded boundary"):
        compute_reduced("ChargeOnEB", None, cfg, {}, params={})
