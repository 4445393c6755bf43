"""Helpers shared by the RZ tests of the port (``tests/test_torch_rz*.py``):
the decks, written here (the reference's RZ decks are not part of the
repository), each run once through both packages, and the comparisons."""

import functools

import jax
import numpy as np
import torch

import warpx_tpu_torch
from warpx_tpu.core.deck import config_from_deck as jax_config_from_deck
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch.utils.parser import Deck

from .test_torch_draws_util import ReplayDraws

# one intra-op thread: the test runner's workers share the machine's
# cores, and more threads each oversubscribe them
torch.set_num_threads(1)

RTOL = 1e-9
FIELDS = ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz")

# the RZ Langmuir wave (the reference's inputs_test_rz_langmuir_multi,
# cut to 16 x 32) with an x-polarized m = 1 velocity on top of the radial
# m = 0 one, so that every mode carries physics
_LANGMUIR = """
max_step = {steps}
amr.n_cell = 16 32
geometry.dims = RZ
geometry.prob_lo = 0. -20.e-6
geometry.prob_hi = 20.e-6 20.e-6
boundary.field_lo = none periodic
boundary.field_hi = pec periodic
warpx.n_rz_azimuthal_modes = {modes}
warpx.cfl = 0.9
algo.particle_shape = {order}
my_constants.epsilon = 0.01
my_constants.n0 = 2.e24
my_constants.w0 = 5.e-6
my_constants.k0 = 2*pi*2/40.e-6
particles.species_names = electrons
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = "NUniformPerCell"
electrons.num_particles_per_cell_each_dim = 2 4 1
electrons.profile = constant
electrons.density = n0
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "epsilon*(2*x/w0**2 + 1/w0)*w0*exp(-(x**2+y**2)/w0**2)*sin(k0*z)"
electrons.momentum_function_uy(x,y,z) = "epsilon*2*y/w0*exp(-(x**2+y**2)/w0**2)*sin(k0*z)"
electrons.momentum_function_uz(x,y,z) = "-epsilon*exp(-(x**2+y**2)/w0**2)*cos(k0*z)"
{extra}
"""

# the RZ LWFA (the reference's inputs_test_rz_laser_acceleration, cut to
# 16 x 64 and a few steps): PEC z walls, the window at c, the antenna,
# continuous injection with random_theta and a Gaussian beam
_LWFA = """
max_step = {steps}
amr.n_cell = {nr} {nz}
geometry.dims = RZ
geometry.prob_lo = 0. -56.e-6
geometry.prob_hi = 30.e-6 12.e-6
boundary.field_lo = none pec
boundary.field_hi = pec pec
warpx.n_rz_azimuthal_modes = {modes}
warpx.cfl = 1.
warpx.do_moving_window = 1
warpx.moving_window_dir = z
warpx.moving_window_v = 1.0
algo.particle_shape = {order}
particles.species_names = electrons beam
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = "NUniformPerCell"
electrons.num_particles_per_cell_each_dim = 1 4 1
electrons.xmax = 25.e-6
electrons.zmin = 5.e-6
electrons.profile = constant
electrons.density = 2.e23
electrons.do_continuous_injection = 1
{plasma_extra}
beam.charge = -q_e
beam.mass = m_e
beam.injection_style = "gaussian_beam"
beam.x_rms = 1.e-6
beam.y_rms = 1.e-6
beam.z_rms = 1.e-6
beam.x_m = 0.
beam.y_m = 0.
beam.z_m = -40.e-6
beam.npart = 128
beam.q_tot = -1.e-12
beam.momentum_distribution_type = "gaussian"
beam.ux_m = 0.0
beam.uy_m = 0.0
beam.uz_m = 200.
beam.ux_th = .2
beam.uy_th = .2
beam.uz_th = 2.
lasers.names = laser1
laser1.profile = Gaussian
laser1.position = 0. 0. 9.e-6
laser1.direction = 0. 0. 1.
laser1.polarization = 1. 0. 0.
laser1.a0 = 2.
laser1.wavelength = 0.8e-6
laser1.profile_waist = 5.e-6
laser1.profile_duration = 15.e-15
laser1.profile_t_peak = 30.e-15
laser1.profile_focal_distance = 100.e-6
{extra}
"""

# absorbing Silver-Mueller z faces and r wall around an antenna
_SILVER_MUELLER = """
max_step = {steps}
amr.n_cell = 16 64
geometry.dims = RZ
geometry.prob_lo = 0. -10.e-6
geometry.prob_hi = 8.e-6 10.e-6
boundary.field_lo = none absorbing_silver_mueller
boundary.field_hi = absorbing_silver_mueller absorbing_silver_mueller
warpx.n_rz_azimuthal_modes = 2
warpx.cfl = 0.9
algo.particle_shape = 1
lasers.names = laser1
laser1.profile = Gaussian
laser1.position = 0. 0. -6.e-6
laser1.direction = 0. 0. 1.
laser1.polarization = 1. 0. 0.
laser1.e_max = 1.e12
laser1.wavelength = 1.e-6
laser1.profile_waist = 3.e-6
laser1.profile_duration = 4.e-15
laser1.profile_t_peak = 8.e-15
laser1.profile_focal_distance = 0.
{extra}
"""

# a laser diffracting around a conducting disk (the reference's
# inputs_test_rz_embedded_boundary_diffraction, cut to 16 x 64)
_EB = """
max_step = {steps}
amr.n_cell = 16 64
geometry.dims = RZ
geometry.prob_lo = 0. -8.e-6
geometry.prob_hi = 8.e-6 8.e-6
boundary.field_lo = none pec
boundary.field_hi = pec pec
warpx.n_rz_azimuthal_modes = 2
warpx.cfl = 0.9
warpx.eb_implicit_function = "-max(x - 3.e-6, abs(z) - 0.1e-6)"
lasers.names = laser1
laser1.profile = Gaussian
laser1.position = 0. 0. -6.e-6
laser1.direction = 0. 0. 1.
laser1.polarization = 1. 0. 0.
laser1.e_max = 1.e12
laser1.wavelength = 1.e-6
laser1.profile_waist = 4.e-6
laser1.profile_duration = 4.e-15
laser1.profile_t_peak = 8.e-15
laser1.profile_focal_distance = 0.
{extra}
"""

# the Galilean RZ PSATD plasma (the reference's nci_psatd_stability
# inputs_test_rz_galilean_psatd, cut to 16 x 32): electrons and ions
# drifting along z
_PSATD = """
max_step = {steps}
amr.n_cell = 16 32
geometry.dims = RZ
geometry.prob_lo = 0. -16.e-6
geometry.prob_hi = 16.e-6 16.e-6
boundary.field_lo = none periodic
boundary.field_hi = pec periodic
warpx.n_rz_azimuthal_modes = 2
warpx.cfl = 0.9
algo.maxwell_solver = psatd
algo.current_deposition = direct
algo.particle_shape = {order}
psatd.noz = 8
my_constants.n0 = 1.e24
my_constants.w0 = 5.e-6
particles.species_names = electrons ions
electrons.charge = -q_e
electrons.mass = m_e
electrons.injection_style = "NUniformPerCell"
electrons.num_particles_per_cell_each_dim = 1 4 1
electrons.profile = parse_density_function
electrons.density_function(x,y,z) = "n0*exp(-(x**2+y**2)/(4*w0**2))*(1 + 0.05*x/w0)"
electrons.momentum_distribution_type = parse_momentum_function
electrons.momentum_function_ux(x,y,z) = "0.01*exp(-(x**2+y**2)/w0**2)"
electrons.momentum_function_uy(x,y,z) = "0."
electrons.momentum_function_uz(x,y,z) = "{uz}"
ions.charge = q_e
ions.mass = m_p
ions.injection_style = "NUniformPerCell"
ions.num_particles_per_cell_each_dim = 1 4 1
ions.profile = parse_density_function
ions.density_function(x,y,z) = "n0*exp(-(x**2+y**2)/(4*w0**2))"
ions.momentum_distribution_type = constant
ions.uz = {uz}
{extra}
"""

DECKS = {
    "langmuir_m2": _LANGMUIR.format(steps=2, modes=2, order=2, extra=""),
    "langmuir_m1": _LANGMUIR.format(steps=1, modes=1, order=1, extra=""),
    "langmuir_m3_dive": _LANGMUIR.format(
        steps=1, modes=3, order=2,
        extra="warpx.do_dive_cleaning = 1\nwarpx.filter_npass_each_dir "
              "= 2 1\nwarpx.use_filter = 1"),
    # warm plasma: the continuous injection draws its theta offsets and
    # its momenta
    "lwfa": _LWFA.format(
        steps=3, modes=2, nr=16, nz=64, order=1,
        plasma_extra="electrons.momentum_distribution_type = gaussian\n"
                     "electrons.ux_th = 0.01\nelectrons.uy_th = 0.01\n"
                     "electrons.uz_th = 0.01\nelectrons.random_theta = 1",
        extra=""),
    "silver_mueller": _SILVER_MUELLER.format(steps=5, extra=""),
    "eb": _EB.format(steps=5, extra=""),
    "psatd": _PSATD.format(steps=3, order=1, uz="0.",
                           extra="psatd.current_correction = 0\n"
                                 "psatd.update_with_rho = 0"),
    "psatd_cc": _PSATD.format(steps=3, order=1, uz="0.", extra=""),
    "psatd_galilean": _PSATD.format(
        steps=3, order=1, uz="10.",
        extra="psatd.v_galilean = 0. 0. 0.99498743710662"),
}


def _jax_aux(sim):
    out = {}
    for k, v in sim.state.aux.items():
        out[k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """The JAX package's run of a deck: (sim, fields, species, checksums).
    Op by op: its RZ steps compile for longer than these decks run."""
    with jax.disable_jit():
        sim = JSimulation(jax_config_from_deck(JDeck.from_string(
            DECKS[name])))
        sim.init()
        sim.evolve()
        checks = sim.checksums()
    f = sim.state.fields
    fields = {nm: np.asarray(getattr(f, nm)) for nm in FIELDS}
    if f.F is not None:
        fields["F"] = np.asarray(f.F)
    if f.smg is not None:
        fields.update({"smg:" + k: np.asarray(v) for k, v in f.smg.items()})
    species = {nm: {k: np.asarray(getattr(sp, k))
                    for k in ("w", "ux", "uy", "uz", "alive", "x", "y", "z")}
               for nm, sp in sim.state.species.items()}
    for nm, sp in sim.state.species.items():
        species[nm].update({"extra:" + k: np.asarray(v)
                            for k, v in sp.extra.items()})
    return sim, fields, species, checks


def port_sim(name, **kw):
    sim = warpx_tpu_torch.Simulation.from_deck(
        Deck.from_string(DECKS[name]), dtype=torch.float64, device="cpu",
        **kw)
    if sim.draws is not None:
        # the continuous injection's draws on the JAX package's key chain
        sim.draws = ReplayDraws(jax.random.PRNGKey(sim.cfg.seed))
    return sim


@functools.lru_cache(maxsize=None)
def port_run(name):
    sim = port_sim(name)
    sim.init()
    sim.evolve()
    return sim


def port_fields(sim):
    f = sim.state.fields
    out = {nm: getattr(f, nm).numpy() for nm in FIELDS}
    if f.F is not None:
        out["F"] = f.F.numpy()
    if f.smg is not None:
        out.update({"smg:" + k: v.numpy() for k, v in f.smg.items()})
    return out


def port_species(sim):
    out = {}
    for nm, sp in sim.state.species.items():
        out[nm] = {k: getattr(sp, k).numpy()
                   for k in ("w", "ux", "uy", "uz", "alive", "x", "y", "z")}
        out[nm].update({"extra:" + k: v.numpy() for k, v in sp.extra.items()})
    return out


def close(got, ref, what, rtol=RTOL, scale=None):
    """Within ``rtol`` of ``scale`` (by default the reference's largest
    magnitude)."""
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got)
    ref = np.asarray(ref)
    kind = (np.complex128 if np.iscomplexobj(got) or np.iscomplexobj(ref)
            else np.float64)
    got, ref = got.astype(kind), ref.astype(kind)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if scale is None:
        scale = np.abs(ref).max() if ref.size else 0.0
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= rtol * scale + 1e-300, (what, err, scale)


def assert_fields(got, ref):
    """Every field array within 1e-9 of its group's scale (E, B, J, F and
    the rings as groups: a component at roundoff, such as a mode that the
    run does not drive, compares at its group's)."""
    assert set(got) == set(ref)
    groups = {}
    for nm, a in ref.items():
        g = "smg" if nm.startswith("smg:") else nm[0]
        groups[g] = max(groups.get(g, 0.0), float(np.abs(a).max()))
    for nm in ref:
        g = "smg" if nm.startswith("smg:") else nm[0]
        close(got[nm], ref[nm], nm, scale=groups[g])


def assert_species(got, ref):
    assert set(got) == set(ref)
    for nm in ref:
        assert set(got[nm]) == set(ref[nm]), nm
        alive = ref[nm]["alive"]
        assert np.array_equal(got[nm]["alive"], alive), nm
        for k, a in ref[nm].items():
            if k == "alive":
                continue
            # the dead slots keep whatever their last push left
            close(got[nm][k][alive], a[alive], f"{nm}.{k}")


def assert_checksums(got, ref, rtol=RTOL):
    """Each checksum within ``rtol`` of its group's largest (the E, B, J,
    rho and div E sums each a group, a component at roundoff comparing at
    its group's; a species' sums each on its own)."""
    assert set(got) == set(ref)
    for lev in ref:
        assert set(got[lev]) == set(ref[lev]), lev
        scale = {}
        for k, v in ref[lev].items():
            g = k[0] if lev == "lev=0" else k
            scale[g] = max(scale.get(g, 0.0), abs(v))
        for k, v in ref[lev].items():
            g = k[0] if lev == "lev=0" else k
            assert abs(got[lev][k] - v) <= rtol * scale[g] + 1e-300, (
                lev, k, got[lev][k], v)
