"""The port's PICMI front end (``warpx_tpu_torch.picmi``) against the JAX
package's (``warpx_tpu.picmi``; ``tests/test_picmi.py`` and
``test_picmi_scripts.py`` need the WarpX reference checkout, so the scenes
are built here).

Every PICMI class lowers to the same deck text, byte for byte (one scene a
class); the reader's verdict on each scene is the JAX reader's, or the
port refuses naming a ROADMAP.md item; runs of a 3D Langmuir wave, a small
2D laser-wakefield window and an electrostatic scene agree with JAX's in
float64 on the CPU at 1e-9; a PICMI script runs unchanged with ``pywarpx``
aliased to either package; without ``device`` the run takes the card."""

import pathlib
import re
import sys

import pytest
import torch

import warpx_tpu_torch
from warpx_tpu import picmi as jpicmi
from warpx_tpu.core.simulation import Simulation as JSimulation
from warpx_tpu.utils.parser import Deck as JDeck
from warpx_tpu_torch import picmi as tpicmi
from warpx_tpu_torch.utils.parser import Deck as TDeck

from .test_torch_frontend_util import (CPU64, clean_frontends,  # noqa: F401
                                       fields_close, particles_close, states,
                                       sums_close)

pytestmark = pytest.mark.usefixtures("clean_frontends")

C = 299792458.0
ROADMAP = pathlib.Path(__file__).resolve().parents[1] / "ROADMAP.md"


# -- scenes, one a PICMI class -----------------------------------------------

def _grid(p, ndim=3, n=8, bc="periodic", **kw):
    cls = {1: p.Cartesian1DGrid, 2: p.Cartesian2DGrid,
           3: p.Cartesian3DGrid}[ndim]
    return cls(number_of_cells=[n] * ndim, lower_bound=[-1e-5] * ndim,
               upper_bound=[1e-5] * ndim,
               lower_boundary_conditions=[bc] * ndim,
               upper_boundary_conditions=[bc] * ndim, **kw)


def _sim(p, solver=None, species=(), layout=None, **kw):
    sim = p.Simulation(solver=solver or p.ElectromagneticSolver(
        grid=_grid(p), cfl=0.9), max_steps=2, **kw)
    for sp in species:
        sim.add_species(sp, layout=layout)
    return sim


def _electrons(p, dist, **kw):
    return p.Species(particle_type="electron", name="electrons",
                     initial_distribution=dist, **kw)


def s_uniform(p):
    return _sim(p, species=[_electrons(p, p.UniformDistribution(
        density=1e24, lower_bound=[-5e-6, None, None],
        upper_bound=[5e-6, None, None], rms_velocity=[0.01 * C] * 3,
        directed_velocity=[0.0, 0.0, 0.1 * C]))],
        layout=p.GriddedLayout([1, 1, 2]))


def s_uniform_fill_in(p):
    return _sim(p, species=[_electrons(p, p.UniformDistribution(
        density=1e24, directed_velocity=[0.0, 0.1 * C, 0.0], fill_in=True))],
        layout=p.GriddedLayout([2, 1]))


def s_analytic(p):
    return _sim(p, species=[_electrons(p, p.AnalyticDistribution(
        density_expression="n0*(1+0.1*cos(k*x))", n0=1e24, k=3e5,
        momentum_expressions=["1e6*sin(k*x)", None, "2e5"],
        lower_bound=[None, None, -8e-6]))],
        layout=p.PseudoRandomLayout(n_macroparticles_per_cell=2))


def s_analytic_rms(p):
    return _sim(p, species=[_electrons(p, p.AnalyticDistribution(
        density_expression="1e24", rms_velocity=[1e6] * 3, fill_in=True))])


def s_gaussian_bunch(p):
    beam = p.Species(particle_type="electron", name="beam",
                     initial_distribution=p.GaussianBunchDistribution(
                         n_physical_particles=6.25e6,
                         rms_bunch_size=[1e-6, 1e-6, 2e-6],
                         rms_velocity=[0.01 * C, 0.01 * C, 1.0 * C],
                         centroid_position=[0.0, 0.0, -2e-6],
                         centroid_velocity=[0.0, 0.0, 100.0 * C]))
    return _sim(p, species=[beam], layout=p.PseudoRandomLayout(
        n_macroparticles=300))


def s_flux(p):
    return _sim(p, solver=p.ElectromagneticSolver(
        grid=_grid(p, bc="open"), cfl=0.9), species=[_electrons(
            p, p.UniformFluxDistribution(
                flux=1e28, flux_normal_axis="z", surface_flux_position=-5e-6,
                flux_direction=1, flux_tmin=0.0, flux_tmax=1e-14,
                directed_velocity=[0.0, 0.0, 0.1 * C],
                rms_velocity=[0.01 * C] * 3))],
        layout=p.GriddedLayout([3, 1, 1]))


def s_particle_list(p):
    return _sim(p, species=[_electrons(p, p.ParticleListDistribution(
        x=[0.0, 1e-6], y=0.0, z=[2e-6, -2e-6], ux=1e6, uz=[0.0, 2e6],
        weight=[1e10, 2e10]))])


def s_multispecies(p):
    ms = p.MultiSpecies(particle_types=["He", "electron"],
                        names=["helium", "electrons"],
                        charge_states=[1, None],
                        initial_distribution=p.UniformDistribution(
                            density=1e24),
                        proportions=[1.0, 1.0])
    sim = _sim(p)
    sim.add_species(ms, layout=p.GriddedLayout([1, 1, 1]))
    return sim


def s_species_extras(p):
    return _sim(p, species=[_electrons(
        p, p.UniformDistribution(density=1e24), warpx_do_not_deposit=1,
        warpx_do_not_gather=True, warpx_do_not_push=True,
        warpx_save_particles_at=["xlo", "zhi"], warpx_do_resampling=True,
        warpx_resampling_trigger_intervals=5,
        warpx_random_theta=0, warpx_plot_filter_function="x>0")])


def s_grid_1d(p):
    return _sim(p, solver=p.ElectromagneticSolver(
        grid=_grid(p, ndim=1, n=16, bc="dirichlet"), cfl=0.5))


def s_grid_2d_window(p):
    grid = _grid(p, ndim=2, bc="open", moving_window_velocity=[0.0, C],
                 lower_boundary_conditions_particles=["Absorbing"] * 2,
                 upper_boundary_conditions_particles=["absorbing"] * 2,
                 warpx_max_grid_size=32)
    return _sim(p, solver=p.ElectromagneticSolver(grid=grid, method="CKC"))


def s_grid_3d_refined(p):
    grid = _grid(p, n=16, refined_regions=[
        [1, [-4e-6] * 3, [4e-6] * 3, [2, 2, 2]]])
    return _sim(p, solver=p.ElectromagneticSolver(grid=grid, cfl=0.9))


def s_cylindrical(p):
    grid = p.CylindricalGrid(number_of_cells=[16, 32],
                             lower_bound=[0.0, -1e-5],
                             upper_bound=[1e-5, 1e-5],
                             lower_boundary_conditions=["none", "dirichlet"],
                             upper_boundary_conditions=["dirichlet",
                                                        "dirichlet"],
                             n_azimuthal_modes=2,
                             moving_window_velocity=[0.0, C])
    return _sim(p, solver=p.ElectromagneticSolver(grid=grid, cfl=0.9))


def s_smoother(p):
    return _sim(p, solver=p.ElectromagneticSolver(
        grid=_grid(p, ndim=2), cfl=0.9,
        source_smoother=p.BinomialSmoother(n_pass=[1, 2])))


def s_smoother_scalar(p):
    return _sim(p, solver=p.ElectromagneticSolver(
        grid=_grid(p), source_smoother=p.BinomialSmoother(n_pass=2),
        warpx_grid_type="collocated", divE_cleaning=1, divB_cleaning=1,
        warpx_pml_ncell=12))


def s_psatd(p):
    return _sim(p, solver=p.ElectromagneticSolver(
        grid=_grid(p), method="PSATD", cfl=0.9, stencil_order=[8, 8, 8],
        galilean_velocity=[0.0, 0.0, 0.5 * C],
        warpx_psatd_update_with_rho=True,
        warpx_psatd_do_time_averaging=False,
        warpx_current_correction=True,
        warpx_periodic_single_box_fft=True))


def s_psatd_2d(p):
    return _sim(p, solver=p.ElectromagneticSolver(
        grid=_grid(p, ndim=2), method="PSATD", stencil_order=[16, 16],
        galilean_velocity=[0.3 * C]),
        warpx_current_deposition_algo="esirkepov")


def s_electrostatic(p):
    return _sim(p, solver=p.ElectrostaticSolver(
        grid=_grid(p, ndim=2, bc="dirichlet"), required_precision=1e-8,
        warpx_const_dt=1e-15),
        species=[_electrons(p, p.UniformDistribution(density=1e22))])


def s_electrostatic_relativistic(p):
    return _sim(p, solver=p.ElectrostaticSolver(
        grid=_grid(p, bc="open"), warpx_relativistic=True,
        warpx_poisson_solver="fft"), time_step_size=1e-16)


def s_hybrid(p):
    return _sim(p, solver=p.HybridPICSolver(
        grid=_grid(p), Te=10.0, n0=1e20, n_floor=1e16,
        plasma_resistivity="1e-6*rho", plasma_hyper_resistivity=1e-8,
        substeps=10, Jz_external_function="0.0", warpx_const_dt=1e-12),
        species=[p.Species(particle_type="proton", name="ions",
                           initial_distribution=p.UniformDistribution(
                               density=1e20, rms_velocity=[1e5] * 3))])


def s_hybrid_scalar_resistivity(p):
    return _sim(p, solver=p.HybridPICSolver(
        grid=_grid(p, ndim=2), Te=1.0, n0=1e20, plasma_resistivity=1e-7))


def s_explicit(p):
    return _sim(p, solver=p.ElectromagneticSolver(
        grid=_grid(p), warpx_evolve_scheme=p.ExplicitEvolveScheme()))


def s_theta_picard(p):
    return _sim(p, solver=p.ElectromagneticSolver(
        grid=_grid(p), warpx_evolve_scheme=p.ThetaImplicitEMEvolveScheme(
            theta=0.5, nonlinear_solver=p.PicardNonlinearSolver(
                relative_tolerance=1e-12, max_iterations=50,
                require_convergence=False))))


def s_semi_newton_gmres(p):
    return _sim(p, solver=p.ElectromagneticSolver(
        grid=_grid(p, ndim=2), warpx_evolve_scheme=p.SemiImplicitEMEvolveScheme(
            nonlinear_solver=p.NewtonNonlinearSolver(
                relative_tolerance=1e-10, max_iterations=10,
                max_particle_iterations=21, particle_tolerance=1e-11,
                linear_solver=p.GMRESLinearSolver(restart_length=20,
                                                  max_iterations=100)))))


def s_gaussian_laser(p):
    sim = _sim(p, solver=p.ElectromagneticSolver(
        grid=_grid(p, ndim=2, bc="open"), cfl=0.98))
    sim.add_laser(p.GaussianLaser(
        wavelength=0.8e-6, waist=5e-6, duration=15e-15,
        focal_position=[0.0, 0.0, 100e-6],
        centroid_position=[0.0, 0.0, -9e-6 - C * 30e-15],
        propagation_direction=[0, 0, 1], polarization_direction=[0, 1, 0],
        a0=2.0, phi0=0.1, phi2=1e-30, beta=0.0, zeta=0.0, name="laser1"),
        injection_method=p.LaserAntenna(position=[0.0, 0.0, -9e-6],
                                        normal_vector=[0, 0, 1]))
    return sim


def s_gaussian_laser_centroid(p):
    sim = _sim(p)
    sim.add_laser(p.GaussianLaser(wavelength=1e-6, waist=3e-6,
                                  duration=10e-15, E0=1e12))
    return sim


def s_analytic_laser(p):
    sim = _sim(p, solver=p.ElectromagneticSolver(
        grid=_grid(p, ndim=2, bc="open")))
    sim.add_laser(p.AnalyticLaser(
        field_expression="E0*exp(-(t-t0)**2/tau**2)*sin(w*t)",
        wavelength=0.8e-6, E0=1e10, t0=2e-14, tau=5e-15, w=2.35e15),
        injection_method=p.LaserAntenna(position=[0.0, 0.0, 0.0]))
    return sim


def s_constant_applied(p):
    sim = _sim(p, species=[_electrons(p, p.UniformDistribution(1e22))])
    sim.add_applied_field(p.ConstantAppliedField(Ex=1e6, Bz=0.5))
    return sim


def s_analytic_applied(p):
    sim = _sim(p)
    sim.add_applied_field(p.AnalyticAppliedField(Ex_expression="x"))
    return sim


def s_analytic_initial(p):
    sim = _sim(p)
    sim.add_applied_field(p.AnalyticInitialField(
        Ex_expression="E0*sin(k*z)", Bz_expression="B0", E0=1e8, B0=0.1,
        k=2e5))
    return sim


def s_load_initial(p):
    sim = _sim(p)
    sim.add_applied_field(p.LoadInitialField(
        read_fields_from_path="fields.h5", load_B=False))
    return sim


def s_load_applied(p):
    sim = _sim(p)
    sim.add_applied_field(p.LoadAppliedField("fields.h5"))
    return sim


def s_mirror(p):
    sim = _sim(p)
    sim.add_applied_field(p.Mirror(z_front_location=1e-6, depth=1e-7,
                                   number_of_cells=2))
    return sim


def s_plasma_lens(p):
    sim = _sim(p)
    sim.add_applied_field(p.PlasmaLens(period=1e-5, starts=[0.0],
                                       lengths=[1e-6], strengths_E=[1.0]))
    return sim


def s_ionization(p):
    ions = p.Species(particle_type="N", name="nitrogen", charge_state=2,
                     charge="q_e", mass="14*m_p",
                     initial_distribution=p.UniformDistribution(1e22))
    el = _electrons(p, None)
    sim = _sim(p, species=[ions, el])
    sim.add_interaction(p.FieldIonization(model="ADK", ionized_species=ions,
                                          product_species=el))
    return sim


def s_coulomb(p):
    el = _electrons(p, p.UniformDistribution(1e24, rms_velocity=[1e6] * 3))
    sim = _sim(p, species=[el], collisions=[p.CoulombCollisions(
        "coll_ee", species=[el, el], CoulombLog=15.9, ndt=2)])
    return sim


def s_mcc(p):
    el = _electrons(p, p.UniformDistribution(1e20))
    sim = _sim(p, species=[el])
    sim.collisions.append(p.MCCCollisions(
        "coll_mcc", species=el, background_density="1e22*(1+x)",
        background_temperature=300.0, background_mass=6.6e-27, ndt=1,
        scattering_processes={
            "elastic": {"cross_section": "elastic.dat"},
            "ionization": {"cross_section": "ion.dat", "energy": 24.55,
                           "species": "helium_ions"}}))
    return sim


def s_dsmc(p):
    sim = _sim(p)
    sim.collisions.append(p.DSMCCollisions(
        "coll_dsmc", species=["ions", "neutrals"], ndt=3,
        scattering_processes={"forward": {"cross_section": "fwd.dat"},
                              "charge_exchange": None}))
    return sim


def s_embedded_boundary(p):
    return _sim(p, warpx_embedded_boundary=p.EmbeddedBoundary(
        implicit_function="-(x**2+y**2+z**2-R**2)", potential="V0",
        R=3e-6, V0=1.0, warpx_extra=1))


def s_field_diagnostic(p):
    sim = _sim(p)
    sim.add_diagnostic(p.FieldDiagnostic(
        grid=None, period=5, data_list=["E", "Bz", "J", "rho", "phi",
                                        "part_per_cell", "divE"],
        warpx_format="openpmd"))
    sim.add_diagnostic(p.FieldDiagnostic(period=3, name="plt"))
    return sim


def s_time_averaged(p):
    sim = _sim(p)
    sim.add_diagnostic(p.TimeAveragedFieldDiagnostic(period=4))
    return sim


def s_particle_diagnostic(p):
    el = _electrons(p, p.UniformDistribution(1e22))
    sim = _sim(p, species=[el])
    sim.add_diagnostic(p.ParticleDiagnostic(period=2, species=[el, "beam"],
                                            warpx_format="plotfile"))
    return sim


def s_checkpoint(p):
    sim = _sim(p)
    sim.add_diagnostic(p.Checkpoint(period=7, name="chk"))
    return sim


def s_reduced(p):
    sim = _sim(p)
    sim.add_diagnostic(p.ReducedDiagnostic(diag_type="FieldEnergy",
                                           period=2, name="fe"))
    sim.add_diagnostic(p.ReducedDiagnostic(
        diag_type="ParticleHistogram", period=3, name="hist",
        species="electrons", bin_number=10, bin_min=0.0, bin_max=1.0,
        histogram_function="ux", normalization="unity_particle_weight"))
    sim.add_diagnostic(p.ReducedDiagnostic(
        diag_type="FieldProbe", name="probe", probe_geometry="Point",
        x_probe=0.0, y_probe=0.0, z_probe=1e-6))
    return sim


def s_lab_frame(p):
    sim = _sim(p, gamma_boost=10.0)
    sim.add_diagnostic(p.LabFrameFieldDiagnostic(
        num_snapshots=4, dt_snapshots=1e-13, data_list=["E", "B", "rho"],
        name="btd"))
    sim.add_diagnostic(p.LabFrameParticleDiagnostic(
        num_snapshots=2, dz_snapshots=1e-6, species=["electrons"]))
    return sim


def s_scraping(p):
    sim = _sim(p)
    sim.add_diagnostic(p.ParticleBoundaryScrapingDiagnostic(
        period=1, species=["electrons"], name="scrape"))
    return sim


def s_simulation_keys(p):
    """Simulation's own keywords and the ``warpx_*`` pass-through (``_``
    becomes ``.``)."""
    return _sim(p, max_time=1e-12, verbose=0, particle_shape="cubic",
                warpx_current_deposition_algo="direct",
                warpx_particle_pusher_algo="vay",
                warpx_field_gathering_algo="momentum-conserving",
                warpx_use_filter=0, warpx_sort_intervals=8,
                warpx_serialize_initial_conditions=1,
                warpx_load_balance_intervals=10, warpx_random_seed=5,
                warpx_amr_restart="chk000010", warpx_zmax_plasma_to_compute_max_step=1e-5)


def s_cylindrical_refined(p):
    grid = p.CylindricalGrid(number_of_cells=[16, 32],
                             lower_bound=[0.0, -1e-5],
                             upper_bound=[1e-5, 1e-5],
                             lower_boundary_conditions=["none", "periodic"],
                             upper_boundary_conditions=["dirichlet",
                                                        "periodic"],
                             refined_regions=[[1, [0.0, -2e-6],
                                               [4e-6, 2e-6], None]])
    return _sim(p, solver=p.ElectromagneticSolver(grid=grid, cfl=0.9))


SCENES = {nm[2:]: fn for nm, fn in list(globals().items())
          if nm.startswith("s_") and callable(fn)}

# the scenes both packages refuse while lowering, with the same message
LOWER_REFUSED = {"analytic_applied", "load_applied", "mirror", "plasma_lens",
                 "time_averaged"}

# the scenes JAX reads and the port refuses, naming Queue C: keys neither
# package reads (JAX lists them as unused), which the port refuses rather
# than drop silently; ROADMAP.md's Queue C lists each of them
PORT_REFUSES = {
    "species_extras": r"electrons\.plot_filter_function \(ROADMAP\.md "
                      r"Queue C\), electrons\.random_theta \(ROADMAP\.md "
                      r"Queue C\)",
    "cylindrical_refined": r"amr\.max_level > 0 under RZ.*Queue C",
    "electrostatic_relativistic": r"algo\.poisson_solver \(ROADMAP\.md "
                                  r"Queue C\)",
    "theta_picard": r"picard\.require_convergence \(ROADMAP\.md Queue C\)",
    "semi_newton_gmres": r"implicit_evolve\.particle_tolerance \(ROADMAP"
                         r"\.md Queue C\), newton\.require_convergence",
    "scraping": r"scrape\.diag_type = boundaryscraping.*Queue C",
    "simulation_keys": r"amr\.restart \(ROADMAP\.md Queue C\), "
                       r"zmax\.plasma\.to\.compute\.max\.step "
                       r"\(ROADMAP\.md Queue C\)",
}


def _text(p, scene):
    return SCENES[scene](p)._build_deck_text()


@pytest.mark.parametrize("scene", list(SCENES))
def test_deck_text_is_jax_s_byte_for_byte(scene, tmp_path):
    """The same PICMI objects lower to the same deck text, and
    write_input_file writes it; what JAX refuses while lowering the port
    refuses with the same message."""
    if scene in LOWER_REFUSED:
        with pytest.raises(NotImplementedError) as ref:
            _text(jpicmi, scene)
        with pytest.raises(NotImplementedError) as got:
            _text(tpicmi, scene)
        assert str(got.value) == str(ref.value)
        return
    ref = _text(jpicmi, scene)
    sim = SCENES[scene](tpicmi)
    assert sim._build_deck_text() == ref
    sim.write_input_file(str(tmp_path / "inputs"))
    assert (tmp_path / "inputs").read_bytes() == ref.encode()


def _verdict(build, text):
    """None where ``build`` (a simulation built from the deck text, not
    initialised) accepts the deck, else the error's type and message."""
    try:
        build(text)
    except (NotImplementedError, ValueError, KeyError, OSError) as err:
        return type(err).__name__, str(err)
    return None


def _jax_build(text):
    return JSimulation.from_deck(JDeck.from_string(text))


def _port_build(text):
    return warpx_tpu_torch.Simulation.from_deck(TDeck.from_string(text),
                                                **CPU64)


@pytest.mark.parametrize("scene", [s for s in SCENES
                                   if s not in LOWER_REFUSED])
def test_reader_verdicts_match_jax(scene):
    """The refusal sweep: each scene's deck through both readers, into a
    simulation.  A deck JAX refuses the port refuses; a deck JAX reads the
    port reads, but for the PORT_REFUSES scenes, refused naming Queue C
    with every unread key listed in ROADMAP.md."""
    text = _text(jpicmi, scene)
    ref = _verdict(_jax_build, text)
    got = _verdict(_port_build, text)
    if scene not in PORT_REFUSES:
        assert (got is None) == (ref is None), (ref, got)
        return
    assert ref is None
    assert got is not None and got[0] == "NotImplementedError", got
    assert re.search(PORT_REFUSES[scene], got[1]), got[1]
    roadmap = open(ROADMAP).read()
    unread = re.findall(r"([\w.()]+) \(ROADMAP\.md Queue C\)", got[1]
                        if got[1].startswith("deck keys") else "")
    for key in unread:
        generic = "<species>." + key.partition(".")[2]
        assert f"`{key}`" in roadmap or f"`{generic}`" in roadmap, key


# -- runs through both packages ------------------------------------------------

def langmuir_3d(p, n=8, steps=2, **simkw):
    """A 3D Langmuir wave: electrons with u_x = u0 sin(2 pi x / L)."""
    grid = p.Cartesian3DGrid(
        number_of_cells=[n] * 3, lower_bound=[-20e-6] * 3,
        upper_bound=[20e-6] * 3, lower_boundary_conditions=["periodic"] * 3,
        upper_boundary_conditions=["periodic"] * 3)
    sim = p.Simulation(solver=p.ElectromagneticSolver(grid=grid, cfl=0.999),
                       max_steps=steps, particle_shape="linear",
                       warpx_use_filter=0, **simkw)
    dist = p.AnalyticDistribution(
        density_expression="2e24",
        momentum_expressions=["u0*sin(2*pi*x/40e-6)", None, None],
        u0=0.01 * C)
    sim.add_species(p.Species(particle_type="electron", name="electrons",
                              initial_distribution=dist),
                    layout=p.GriddedLayout([1, 1, 2], grid))
    return sim


def lwfa_2d(p, steps=3, **simkw):
    """tests/test_binned_bounded.py's 32 x 64 laser-wakefield deck written
    as PICMI objects: PML faces, the moving window, a continuously
    injected plasma, a Gaussian beam, a Gaussian laser from an antenna,
    the bilinear filter, order 3."""
    c = p.constants.c
    grid = p.Cartesian2DGrid(
        number_of_cells=[32, 64], lower_bound=[-15e-6, -28e-6],
        upper_bound=[15e-6, 6e-6], lower_boundary_conditions=["open"] * 2,
        upper_boundary_conditions=["open"] * 2,
        moving_window_velocity=[0.0, c])
    solver = p.ElectromagneticSolver(grid=grid, method="Yee", cfl=0.98,
                                     source_smoother=p.BinomialSmoother(1))
    sim = p.Simulation(solver=solver, max_steps=steps,
                       particle_shape="cubic", warpx_sort_intervals=4,
                       **simkw)
    plasma = p.UniformDistribution(density=2e23,
                                   lower_bound=[-12e-6, None, -20e-6],
                                   upper_bound=[12e-6, None, None],
                                   fill_in=True)
    sim.add_species(p.Species(particle_type="electron", name="electrons",
                              initial_distribution=plasma),
                    layout=p.GriddedLayout([1, 1], grid))
    bunch = p.GaussianBunchDistribution(
        n_physical_particles=1e-12 / p.constants.q_e,
        rms_bunch_size=[0.5e-6] * 3, rms_velocity=[2 * c, 2 * c, 50 * c],
        centroid_position=[0.0, 0.0, -14e-6],
        centroid_velocity=[0.0, 0.0, 500 * c])
    sim.add_species(p.Species(particle_type="electron", name="beam",
                              initial_distribution=bunch),
                    layout=p.PseudoRandomLayout(n_macroparticles=100))
    sim.add_laser(p.GaussianLaser(
        wavelength=0.8e-6, waist=5e-6, duration=15e-15,
        focal_position=[0.0, 0.0, 90e-6],
        centroid_position=[0.0, 0.0, -10e-6 - c * 30e-15],
        propagation_direction=[0, 0, 1], polarization_direction=[0, 1, 0],
        E0=16e12, name="laser1"),
        injection_method=p.LaserAntenna(position=[0.0, 0.0, -10e-6]))
    return sim


def electrostatic_2d(p, steps=3, **simkw):
    """Electrons drifting between grounded walls under the lab-frame
    electrostatic solver (tests/test_torch_electrostatic.py's deck without
    the driven wall, which PICMI cannot write)."""
    grid = p.Cartesian2DGrid(
        number_of_cells=[16, 16], lower_bound=[0.0, 0.0],
        upper_bound=[1e-5, 1e-5],
        lower_boundary_conditions=["dirichlet"] * 2,
        upper_boundary_conditions=["dirichlet"] * 2,
        lower_boundary_conditions_particles=["absorbing"] * 2,
        upper_boundary_conditions_particles=["absorbing"] * 2)
    sim = p.Simulation(solver=p.ElectrostaticSolver(grid=grid,
                                                    warpx_const_dt=1e-15),
                       max_steps=steps, warpx_use_filter=0, **simkw)
    dist = p.UniformDistribution(
        density=1e22, lower_bound=[2e-6, None, 2e-6],
        upper_bound=[6e-6, None, 7e-6],
        rms_velocity=[0.001 * C, 0.001 * C, 0.01 * C],
        directed_velocity=[0.0, 0.0, 0.5 * C])
    sim.add_species(p.Species(particle_type="electron", name="electrons",
                              initial_distribution=dist),
                    layout=p.GriddedLayout([1, 1], grid))
    return sim


@pytest.mark.parametrize("scene", ["langmuir_3d", "lwfa_2d",
                                   "electrostatic_2d"])
def test_picmi_runs_match_jax(scene):
    """The same PICMI scene stepped by both packages: the fields, the
    particles and the checksums within 1e-9.  JAX runs per particle on the
    CPU, the port takes its tile-binned step where it covers the scene
    (the 3D Langmuir wave), so the particles are compared as
    multisets."""
    build = globals()[scene]
    jsim = build(jpicmi)
    tsim = build(tpicmi, **CPU64)
    if scene == "lwfa_2d":
        # both per particle: the tile-binned bounded step of either package
        # injects and absorbs on its own schedule (52 electrons fewer after
        # 3 steps in both), so the paths must match
        for sim in (jsim, tsim):
            sim.extra_keys["tpu.tiled_particles"] = "off"
    assert tsim._build_deck_text() == jsim._build_deck_text()
    jsim.step()
    tsim.step()
    j, t = jsim.extension, tsim.extension
    assert t.binned == (scene == "langmuir_3d")
    assert t.state.step == j.state.step == {"langmuir_3d": 2}.get(scene, 3)
    assert warpx_tpu_torch.runtime.get_simulation() is t
    ref, got = states(j, t)
    fields_close(ref, got)
    particles_close(ref, got)
    sums_close(j.checksums(), t.checksums())
    if scene == "lwfa_2d":
        assert t.state.aux["window_offset"] > 0


SCRIPT = """
from pywarpx import picmi

c = picmi.constants.c
grid = picmi.Cartesian2DGrid(
    number_of_cells=[16, 16], lower_bound=[-1e-5, -1e-5],
    upper_bound=[1e-5, 1e-5], lower_boundary_conditions=["periodic"] * 2,
    upper_boundary_conditions=["periodic"] * 2)
solver = picmi.ElectromagneticSolver(grid=grid, method="Yee", cfl=0.9)
sim = picmi.Simulation(solver=solver, max_steps=3, warpx_use_filter=0)
electrons = picmi.Species(
    particle_type="electron", name="electrons",
    initial_distribution=picmi.UniformDistribution(
        density=1e24, rms_velocity=[0.01 * c] * 3))
sim.add_species(electrons, layout=picmi.GriddedLayout([2, 2], grid))
sim.write_input_file("inputs_from_picmi")
sim.step(2)
sim.step(1)
"""


def _exec_script(pywarpx, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "pywarpx", pywarpx)
    monkeypatch.chdir(tmp_path)
    glb = {"__name__": "__main__"}
    exec(compile(SCRIPT, "picmi_script.py", "exec"), glb)
    return glb["sim"]


def test_unchanged_picmi_script_runs_on_both(monkeypatch, tmp_path):
    """The pattern of tests/test_picmi_scripts.py: one script, ``from
    pywarpx import picmi``, exec'd with pywarpx aliased to the JAX package
    and then to the port (its keyword-only defaults set to the CPU in
    float64 here, as a user would pass them): the same written deck, the
    same run within 1e-9."""
    import warpx_tpu.pywarpx
    import warpx_tpu_torch.pywarpx

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jsim = _exec_script(warpx_tpu.pywarpx, monkeypatch, tmp_path / "jax")
    monkeypatch.setattr(tpicmi.Simulation.__init__, "__kwdefaults__",
                        dict(CPU64))
    tsim = _exec_script(warpx_tpu_torch.pywarpx, monkeypatch,
                        tmp_path / "port")
    assert isinstance(tsim, tpicmi.Simulation)
    assert ((tmp_path / "port" / "inputs_from_picmi").read_bytes()
            == (tmp_path / "jax" / "inputs_from_picmi").read_bytes())
    j, t = jsim.extension, tsim.extension
    assert t.state.step == 3 and t.device.type == "cpu"
    ref, got = states(j, t)
    fields_close(ref, got)
    particles_close(ref, got)
    sums_close(j.checksums(), t.checksums())


def test_picmi_without_a_device_takes_the_card():
    """``picmi.Simulation(...).step()`` without ``device``: the card, in
    float32; with no GPU it raises rather than run on the CPU."""
    sim = langmuir_3d(tpicmi, steps=1)
    if torch.cuda.is_available():
        sim.step()
        assert sim.extension.device.type == "cuda"
        assert sim.extension.state.fields.Ex.dtype == torch.float32
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sim.step()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sim.initialize_warpx()
