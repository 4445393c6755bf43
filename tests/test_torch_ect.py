"""Embedded boundaries of the port (``warpx_tpu_torch/solvers/ect.py``,
the embedded boundary of ``core/bounded_step.py``, the ``eb2.*`` builders
of ``core/deck.py`` and ``diagnostics/reduced.py::charge_on_eb``) against
the JAX package's on the CPU in float64: the ECT cut-cell geometry (the
plane cut of ``tests/test_ect.py``, rotated cubes, spheres), the ECT
Faraday update, a 2D ECT rotated-cube run against the JAX package and the
reference's analytic mode, the staircase boundary on the bounded Yee step
with a plasma (particles inside the body removed, covered components
frozen), the ``eb2`` builders and ChargeOnEB."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warpx_tpu_torch
from warpx_tpu.core.deck import _eb2_implicit_function as j_eb2
from warpx_tpu.core.grid import Geometry as JGeometry
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.diagnostics.reduced import compute_reduced as j_reduced
from warpx_tpu.solvers import ect as ject
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.core.deck import _eb2_implicit_function, config_from_deck
from warpx_tpu_torch.core.grid import Geometry
from warpx_tpu_torch.core.state import state_to_numpy
from warpx_tpu_torch.diagnostics.reduced import compute_reduced
from warpx_tpu_torch.solvers import ect
from warpx_tpu_torch.utils.expression import compile_expression
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_models_util import RTOL, assert_runs_agree, rel_err

C = 299792458.0
MU0 = 1.25663706212e-06


def _geo_pair(ndim, n, expr, consts=()):
    lo, hi = (-0.8,) * ndim, (0.8,) * ndim
    jg = JGeometry(ndim, (n,) * ndim, lo, hi, (False,) * ndim)
    g = Geometry(ndim, (n,) * ndim, lo, hi, (False,) * ndim)
    ref = ject.cached_ect_geometry(expr, tuple(consts), jg, lo)
    got = ect.cached_ect_geometry(expr, tuple(consts), g, lo)
    return jg, g, ref, got


def _assert_geo_equal(got, ref):
    assert got["ndim"] == ref["ndim"]
    for k in ("Ex", "Ey", "Ez"):
        assert rel_err(got["edges"][k], ref["edges"][k]) <= 1e-12, k
    for key in ("S", "S_mod"):
        assert set(got[key]) == set(ref[key])
        for d in ref[key]:
            assert rel_err(got[key][d], ref[key][d]) <= 1e-12, (key, d)
    for d in ref["flags"]:
        np.testing.assert_array_equal(got["flags"][d], ref["flags"][d])
        assert set(got["borrow"][d]) == set(ref["borrow"][d])
        for off, a in ref["borrow"][d].items():
            assert rel_err(got["borrow"][d][off], a) <= 1e-12, (d, off)


def test_ect_geometry_plane_cut():
    """Edge and face fractions are exact for a planar cut (the JAX
    package's tests/test_ect.py:29-52)."""
    geom = Geometry(ndim=3, n_cell=(4, 4, 4), prob_lo=(0, 0, 0),
                    prob_hi=(1, 1, 1), periodic=(False,) * 3)

    def phi_at(c):
        return c[0] - 0.31  # covered where x > 0.31

    geo = ect.ect_geometry(phi_at, geom, geom.prob_lo)
    dA = 0.0625
    np.testing.assert_allclose(geo["S"][0][:, 0, 0] / dA, [1, 1, 0, 0, 0])
    np.testing.assert_allclose(geo["edges"]["Ex"][:, 0, 0] / 0.25,
                               [1.0, 0.24, 0, 0])
    assert (geo["flags"][1][1, :, :] == 0).all()
    np.testing.assert_allclose(geo["S_mod"][1][1, :, :] / dA, 0.5)


CUBE_3D = ("yy=y*cos(-theta)-z*sin(-theta); zz=y*sin(-theta)+z*cos(-theta);"
           " max(max(max(x-0.5,-(x+0.5)),max(yy-0.5,-(yy+0.5))),"
           "max(zz-0.5,-(zz+0.5)))")
CUBE_2D = ("xx = x*cos(-theta) + z*sin(-theta); zz = -x*sin(-theta) + "
           "z*cos(-theta); max(max(xx+xmin,-(xx+xmax)), "
           "max(zz+zmin,-(zz+zmax)))")
CUBE_2D_CONSTS = (("theta", np.pi / 8), ("xmax", 0.53), ("xmin", -0.53),
                  ("zmax", 0.53), ("zmin", -0.53))


@pytest.mark.parametrize("ndim,n,expr,consts", [
    (3, 12, CUBE_3D, (("theta", np.pi / 6),)),
    (3, 10, "(x-0.05)**2 + y**2 + (z+0.1)**2 - 0.3", ()),
    (2, 24, CUBE_2D, CUBE_2D_CONSTS),
    (2, 20, "0.45 - sqrt(x*x + z*z)", ()),
])
def test_ect_geometry_matches_jax(ndim, n, expr, consts):
    _, _, ref, got = _geo_pair(ndim, n, expr, consts)
    _assert_geo_equal(got, ref)
    assert any(ref["borrow"][d] for d in ref["borrow"])


@pytest.mark.parametrize("ndim,n,expr,consts", [
    (3, 12, CUBE_3D, (("theta", np.pi / 6),)),
    (2, 24, CUBE_2D, CUBE_2D_CONSTS),
])
def test_ect_evolve_b_matches_jax(ndim, n, expr, consts):
    _, _, ref, got = _geo_pair(ndim, n, expr, consts)
    rng = np.random.default_rng(5)
    shapes = {"Ex": ref["edges"]["Ex"].shape, "Ey": ref["edges"]["Ey"].shape,
              "Ez": ref["edges"]["Ez"].shape}
    if ndim == 3:
        shapes.update(Bx=ref["S"][0].shape, By=ref["S"][1].shape,
                      Bz=ref["S"][2].shape)
    else:
        shapes.update(Bx=(n + 1, n), By=ref["S"][1].shape, Bz=(n, n + 1))
    arr = {k: rng.standard_normal(v) for k, v in shapes.items()}
    jf = ject.make_ect_evolve_b(ref, jnp.float64)
    tf = ect.make_ect_evolve_b(got, torch.float64, "cpu")
    dth = 1.3e-3
    b_ref = jf(*(jnp.asarray(arr[k]) for k in ("Ex", "Ey", "Ez")),
               tuple(jnp.asarray(arr[k]) for k in ("Bx", "By", "Bz")), dth)
    b_got = tf(*(torch.from_numpy(arr[k]) for k in ("Ex", "Ey", "Ez")),
               tuple(torch.from_numpy(arr[k]) for k in ("Bx", "By", "Bz")),
               dth)
    for a, b in zip(b_got, b_ref):
        assert rel_err(a.numpy(), np.asarray(b)) <= RTOL


ROTATED_CUBE_2D = """
max_step = {steps}
amr.n_cell = 32 32
geometry.dims = 2
geometry.prob_lo = -0.8 -0.8
geometry.prob_hi = 0.8 0.8
warpx.cfl = 1
warpx.use_filter = 0
boundary.field_lo = pec pec
boundary.field_hi = pec pec
algo.maxwell_solver = {solver}
my_constants.xmin = -0.53
my_constants.zmin = -0.53
my_constants.xmax = 0.53
my_constants.zmax = 0.53
my_constants.theta = pi/8
warpx.eb_implicit_function = "{cube}"
my_constants.m = 0
my_constants.p = 1
my_constants.Lx = 1.06
my_constants.Lz = 1.06
warpx.B_ext_grid_init_style = parse_B_ext_grid_function
warpx.Bx_external_grid_function(x,y,z) = 0
warpx.By_external_grid_function(x,y,z) = "mu0 * cos(m * pi / Lx * (x*cos(-theta) + z*sin(-theta) - Lx / 2)) * cos(p * pi / Lz * (-x*sin(-theta) + z*cos(-theta) - Lz / 2))"
warpx.Bz_external_grid_function(x,y,z) = 0
"""


def rotated_cube_2d_error(sim):
    """The relative l2 error of By against the TM eigenmode
    (analysis_fields_2d.py; the JAX package's tests/test_ect.py:64-89)."""
    t = float(sim.state.time)
    theta = np.pi / 8
    L = 1.06
    dx = 1.6 / 32
    by = state_to_numpy(sim.state)["fields"]["By"][:32, :32]
    x = np.arange(32) * dx - 0.8
    X, Z = np.meshgrid(x, x, indexing="ij")
    xr = X * np.cos(-theta) + Z * np.sin(-theta)
    zr = -X * np.sin(-theta) + Z * np.cos(-theta)
    th = (MU0 * np.cos(np.pi / L * (zr - L / 2)) * np.cos(np.pi / L * C * t)
          * (by != 0))
    return np.sqrt(np.sum((by - th) ** 2) / np.sum(th ** 2))


def test_ect_rotated_cube_2d_matches_jax():
    """The reference's rotated-cube TM mode in 2D, 68 steps (~1.125
    periods) under ECT: the port against the JAX package at 1e-9, and the
    mode's l2 error below the reference's 1e-1."""
    text = ROTATED_CUBE_2D.format(steps=68, solver="ect", cube=CUBE_2D)
    jsim = JSimulation.from_deck(JDeck.from_string(text))
    jsim.init()
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(text), dtype=torch.float64, device="cpu")
    sim.init()
    # covered faces of the initial field stay 0 (the parser fill skips them)
    by0, jby0 = sim.state.fields.By.numpy(), np.asarray(jsim.state.fields.By)
    np.testing.assert_array_equal(by0 == 0, jby0 == 0)
    assert (by0 == 0).any() and rel_err(by0, jby0) <= RTOL
    jsim.evolve()
    sim.evolve()
    assert sim.is_bounded and sim.stepper.ect_evolve_b is not None
    assert_runs_agree(jsim, sim)
    err = rotated_cube_2d_error(sim)
    assert err < 1e-1, err


# ----------------------------------------------------------- staircase EB
EB_PLASMA_3D = """
max_step = 4
amr.n_cell = 16 16 16
geometry.dims = 3
geometry.prob_lo = -8.e-6 -8.e-6 -8.e-6
geometry.prob_hi = 8.e-6 8.e-6 8.e-6
warpx.cfl = 0.9
warpx.use_filter = 1
boundary.field_lo = pec pec pec
boundary.field_hi = pec pec pec
boundary.particle_lo = reflecting absorbing reflecting
boundary.particle_hi = reflecting absorbing reflecting
eb2.geom_type = sphere
eb2.sphere_center = 1.e-6 0. -1.e-6
eb2.sphere_radius = 4.e-6
eb2.sphere_has_fluid_inside = 0
particles.species_names = electrons
electrons.species_type = electron
electrons.injection_style = NUniformPerCell
electrons.num_particles_per_cell_each_dim = 1 1 1
electrons.profile = constant
electrons.density = 1.e25
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "0.3*(1 - 2*(x > 1.e-6))"
electrons.momentum_function_uy(x,y,z) = "0.1"
electrons.momentum_function_uz(x,y,z) = "0.3*(1 - 2*(z > -1.e-6))"
"""


def test_staircase_eb_with_plasma_matches_jax():
    """A PEC box holding a plasma and an eb2 sphere, the plasma streaming
    into it: 4 bounded Yee steps agree with the JAX package at 1e-9; no
    alive particle lies inside the body; the covered E edges and B faces
    keep their initial zeros."""
    jsim = JSimulation.from_deck(JDeck.from_string(EB_PLASMA_3D))
    jsim.init()
    jsim.evolve()
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(EB_PLASMA_3D), dtype=torch.float64, device="cpu")
    sim.init()
    n0 = int(sim.state.species["electrons"].alive.sum())
    sim.evolve()
    assert sim.is_bounded and not sim.binned
    assert_runs_agree(jsim, sim)
    el = sim.state.species["electrons"]
    inside = sim.stepper.inside_eb(el.positions(3))
    assert not bool((inside & el.alive).any())
    assert int(el.alive.sum()) < n0
    for nm, mask in sim.stepper.eb_mask.items():
        covered = getattr(sim.state.fields, nm)[~mask]
        assert covered.numel() > 0 and bool((covered == 0).all()), nm
    # ChargeOnEB on the run's state
    ref = j_reduced("ChargeOnEB", jsim.state, jsim.cfg, jsim.staggering, {})
    got = compute_reduced("ChargeOnEB", sim.state, sim.cfg, sim.staggering,
                          {})
    assert abs(got["Charge (C)"] - ref["Charge (C)"]) <= RTOL * abs(
        ref["Charge (C)"])


@pytest.mark.parametrize("extra", [
    "eb2.geom_type = box\neb2.box_lo = -0.2 -0.1 0.\n"
    "eb2.box_hi = 0.3 0.2 0.4\n",
    "eb2.geom_type = box\neb2.box_lo = -0.2 -0.1 0.\n"
    "eb2.box_hi = 0.3 0.2 0.4\neb2.box_has_fluid_inside = 0\n",
    "eb2.geom_type = sphere\neb2.sphere_center = 0.1 0.2 -0.1\n"
    "eb2.sphere_radius = 0.3\n",
    "eb2.geom_type = cylinder\neb2.cylinder_direction = 0\n"
    "eb2.cylinder_center = 9.0 0.1 0.2\neb2.cylinder_radius = 0.25\n"
    "eb2.cylinder_has_fluid_inside = 0\n",
    "eb2.geom_type = cylinder\neb2.cylinder_direction = 2\n"
    "eb2.cylinder_center = 0. 0. 0.1\neb2.cylinder_radius = 0.3\n"
    "eb2.cylinder_height = 0.4\n",
    "geometry.dims = 2\neb2.geom_type = cylinder\n"
    "eb2.cylinder_direction = 1\neb2.cylinder_center = 0.1 0. -0.2\n"
    "eb2.cylinder_radius = 0.3\n",
    'warpx.eb_implicit_function = "x*x - 0.1"\neb2.geom_type = sphere\n',
])
def test_eb2_builders_match_jax(extra):
    text = ("geometry.dims = 3\n" if "dims" not in extra else "") + extra
    ref = j_eb2(JDeck.from_string(text))
    got = _eb2_implicit_function(Deck.from_string(text))
    assert got == ref
    if got:
        pts = np.random.default_rng(1).uniform(-0.6, 0.6, (3, 50))
        val = compile_expression(got, ("x", "y", "z"))(*pts)
        assert (val > 0).any() and (val < 0).any()


def test_eb_deck_keys_and_refusals():
    """The deck reader reads the embedded boundary into the configuration
    as the JAX reader does; an embedded boundary with a moving window or
    with the ECT solver on a PML face raises as in the JAX package."""
    cfg = config_from_deck(Deck.from_string(EB_PLASMA_3D))
    assert cfg.eb_implicit_function == j_eb2(JDeck.from_string(EB_PLASMA_3D))
    assert "sqrt" in cfg.eb_implicit_function
    win = dataclasses.replace(cfg, do_moving_window=True,
                              moving_window_dir=2)
    with pytest.raises(NotImplementedError, match="moving window"):
        warpx_tpu_torch.Simulation(win, dtype=torch.float64, device="cpu")
    pml = dataclasses.replace(cfg, em_solver="ect",
                              field_bc_lo=("pml",) * 3)
    with pytest.raises(NotImplementedError, match="ECT with pml"):
        warpx_tpu_torch.Simulation(pml, dtype=torch.float64, device="cpu")


def test_charge_on_eb_gauss_matches_jax():
    """A linear E = k x inside a staircased ball on a PEC box: ChargeOnEB's
    Gauss sum against the JAX package's, and within 15 % of eps0 div(E)
    times the ball's volume (the JAX package's test_reduced_new.py)."""
    from warpx_tpu.core.config import SimConfig as JSimConfig
    from warpx_tpu.core.state import FieldState as JFieldState
    from warpx_tpu.core.state import SimState as JSimState
    from warpx_tpu_torch.core.state import FieldState, SimState

    from .test_torch_bounded_util import port_config

    jg = JGeometry(3, (16, 16, 16), (-1.0,) * 3, (1.0,) * 3, (True,) * 3)
    jcfg = JSimConfig(geometry=jg, max_step=1, dt=1e-12,
                      eb_implicit_function="0.25 - (x*x + y*y + z*z)",
                      field_bc_lo=("pec",) * 3, field_bc_hi=("pec",) * 3,
                      use_filter=False)
    flags = {"Ex": (0, 1, 1), "Ey": (1, 0, 1), "Ez": (1, 1, 0),
             "Bx": (1, 0, 0), "By": (0, 1, 0), "Bz": (0, 0, 1),
             "jx": (0, 1, 1), "jy": (1, 0, 1), "jz": (1, 1, 0)}
    arrs = {}
    for nm, fl in flags.items():
        coords = [-1.0 + (np.arange(17 if f else 16) + (0 if f else 0.5))
                  * 0.125 for f in fl]
        mesh = np.meshgrid(*coords, indexing="ij")
        arrs[nm] = (7.5 * mesh["xyz".index(nm[1])] if nm[0] == "E"
                    else np.zeros(mesh[0].shape))
    jstate = JSimState(fields=JFieldState(**{k: jnp.asarray(v)
                                             for k, v in arrs.items()}),
                       species={}, step=0, time=0.0,
                       rng=jnp.zeros(2, jnp.uint32), aux={})
    state = SimState(fields=FieldState(**{k: torch.from_numpy(v)
                                          for k, v in arrs.items()}),
                     species={}, step=0, time=0.0, aux={})
    ref = j_reduced("ChargeOnEB", jstate, jcfg, {}, {})
    cfg = port_config(jcfg)
    got = compute_reduced("ChargeOnEB", state, cfg, {}, params={})
    assert abs(got["Charge (C)"] - ref["Charge (C)"]) <= RTOL * abs(
        ref["Charge (C)"])
    expected = 8.8541878128e-12 * 3 * 7.5 * 4.0 / 3.0 * np.pi * 0.5 ** 3
    assert abs(got["Charge (C)"] - expected) < 0.15 * abs(expected)
    # a weighting function (the diagnostic's parameter; the deck reader
    # refuses it, as the JAX reader never passes it)
    params = {"weighting_function": "1 + x"}
    ref = j_reduced("ChargeOnEB", jstate, jcfg, {}, params)
    got = compute_reduced("ChargeOnEB", state, cfg, {}, params=params)
    assert abs(got["Charge (C)"] - ref["Charge (C)"]) <= RTOL * abs(
        ref["Charge (C)"])
