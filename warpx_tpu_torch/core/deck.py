"""Input deck -> ``SimConfig``.

The counterpart of ``warpx_tpu.core.deck.config_from_deck`` for the fields
the port's ``SimConfig`` holds (2D XZ and 3D explicit electromagnetic runs
with the Yee, CKC or PSATD solver, periodic or bounded with PML/PEC faces
(PML/damped under PSATD), moving window, Gaussian and lasy laser
antennas, continuous injection, Gaussian beams, single, multiple and
openPMD-file particles, NFluxPerCell plane emission, constant, parsed or
parabolic-channel density, constant, Gaussian, thermal, uniform and parsed
momenta, initial external grid fields, shape orders 1-4, divergence
cleaning, the Lorentz-boosted frame (the
geometry along the boost axis and the antenna converted from the lab's
coordinates), field ionization, QED (quantum synchrotron, Breit-Wheeler,
Schwinger) with photon species, classical radiation reaction, resampling,
binary collisions (pairwise Coulomb, nuclear fusion, DSMC, background MCC
and stopping; cross-section tables read relative to the deck's directory),
the electrostatic solvers with wall potentials, the Ohm's-law hybrid
solver, the macroscopic medium, the Godfrey NCI corrector, the theta- and
semi-implicit schemes with their Picard and Newton-GMRES keys, cold fluid
species, embedded boundaries (``warpx.eb_implicit_function`` and the
``eb2.*`` builders) with the ECT solver, absorbing Silver-Mueller faces,
thermal walls (``boundary.<species>.u_th``), the scraping buffers
(``<species>.save_particles_at_*``), collocated and hybrid grids
(``warpx.grid_type``, ``warpx.field_centering_no*``), hybrid QED
(``warpx.use_hybrid_QED``, ``warpx.quantum_xi``), rigid injection
(``particles.rigid_injected_species``, ``<species>.zinject_plane``,
``rigid_advance``), the accelerator lattice (``lattice.elements``), the
tile-binned layout and its ``tpu.*`` keys), with
the JAX reader's defaults and derived values (reference: Source/WarpX.cpp:466
ReadParameters; Source/Initialization/PlasmaInjector.cpp), and the deck's
outputs (``outputs_from_deck``: Full diagnostics in plotfile, openPMD or
checkpoint format, BackTransformed diagnostics, reduced diagnostics, signal
handling) as the JAX package's ``Simulation._setup_diagnostics`` reads
them.

Nothing is dropped silently.  A deck key that this reader does not read, or
a value it reads but the port does not run, raises ``NotImplementedError``
naming the ROADMAP.md item it waits for: running a deck with a feature
dropped would give wrong physics while reporting success (the rule of
``warpx_tpu/core/deck.py::_gate_unimplemented``).  The exceptions are the
keys of ``NO_PHYSICS`` and the keys of a declared output that the JAX
package does not read either (``diag1.file_prefix``), which change no
physics on one device; the CLI lists them as unused.
"""

from __future__ import annotations

import dataclasses
import math
import os

from ..solvers.yee import compute_dt_ckc, compute_dt_yee
from ..utils.intervals import IntervalsParser
from ..utils.parser import Deck
from .config import (CollisionConfig, LaserConfig, MCCProcessConfig,
                     SimConfig, SpeciesConfig)
from .grid import Geometry
from .laser import boost_laser_position

__all__ = ["NO_PHYSICS", "config_from_deck", "outputs_from_deck"]

_C = 299792458.0
_QE = 1.602176634e-19
_ME = 9.1093837015e-31
_MU = 1.66053906660e-27  # atomic mass unit (ablastr m_u)

# species_type -> (charge, mass) in SI (reference:
# Source/Particles/SpeciesPhysicalProperties.cpp; warpx_tpu/core/config.py)
SPECIES_TYPES = {
    "electron": (-_QE, _ME),
    "positron": (_QE, _ME),
    "muon": (-_QE, 206.7682830 * _ME),
    "antimuon": (_QE, 206.7682830 * _ME),
    "photon": (0.0, 0.0),
    "neutron": (0.0, 1.0013784193052508 * 1.67262192369e-27),
    "proton": (_QE, 1.67262192369e-27),
    "hydrogen": (_QE, 1.00797 * _MU),
    "hydrogen1": (_QE, 1.00782503223 * _MU),
    "hydrogen2": (_QE, 2.01410177812 * _MU),
    "hydrogen3": (_QE, 3.0160492779 * _MU),
    "helium": (2 * _QE, 4.002602 * _MU),
    "helium3": (2 * _QE, 3.0160293201 * _MU),
    "helium4": (2 * _QE, 4.00260325413 * _MU),
    "alpha": (2 * _QE, 4.001506179127 * _MU),
    "lithium": (3 * _QE, 6.967 * _MU),
    "lithium6": (3 * _QE, 6.0151228874 * _MU),
    "lithium7": (3 * _QE, 7.0160034366 * _MU),
    "beryllium": (4 * _QE, 9.0121831 * _MU),
    "beryllium9": (4 * _QE, 9.012183065 * _MU),
    "boron": (5 * _QE, 10.813 * _MU),
    "boron10": (5 * _QE, 10.01293695 * _MU),
    "boron11": (5 * _QE, 11.00930536 * _MU),
    "carbon": (6 * _QE, 12.0106 * _MU),
    "carbon12": (6 * _QE, 12.0 * _MU),
    "carbon13": (6 * _QE, 13.00335483507 * _MU),
    "carbon14": (6 * _QE, 14.0032419884 * _MU),
    "nitrogen": (7 * _QE, 14.00685 * _MU),
    "nitrogen14": (7 * _QE, 14.00307400443 * _MU),
    "nitrogen15": (7 * _QE, 15.00010889888 * _MU),
    "oxygen": (8 * _QE, 15.999 * _MU),
    "oxygen16": (8 * _QE, 15.99491461957 * _MU),
    "oxygen17": (8 * _QE, 16.9991317565 * _MU),
    "oxygen18": (8 * _QE, 17.99915961286 * _MU),
    "fluorine": (9 * _QE, 18.998403163 * _MU),
    "fluorine19": (9 * _QE, 18.99840316273 * _MU),
    "neon": (10 * _QE, 20.1797 * _MU),
    "neon20": (10 * _QE, 19.9924401762 * _MU),
    "neon21": (10 * _QE, 20.993846685 * _MU),
    "neon22": (10 * _QE, 21.991385114 * _MU),
    "aluminium": (13 * _QE, 26.98153853 * _MU),
    "argon": (18 * _QE, 39.948 * _MU),
    "copper": (29 * _QE, 63.546 * _MU),
    "xenon": (54 * _QE, 131.293 * _MU),
    "gold": (79 * _QE, 196.966569 * _MU),
}

# the reference's species_type aliases (SpeciesPhysicalProperties.cpp:36-40)
_SPECIES_TYPE_ALIASES = {
    "protium": "hydrogen1",
    "deuterium": "hydrogen2",
    "tritium": "hydrogen3",
}

# keys that change no physics: the reference's box decomposition, warning
# policy and OpenMP scheduling (the load-balancing keys are read into the
# configuration: ``_load_balance_from_deck``)
NO_PHYSICS = (
    "amr.max_grid_size", "amr.max_grid_size_x", "amr.max_grid_size_y",
    "amr.max_grid_size_z",
    "amr.blocking_factor", "amr.blocking_factor_x", "amr.blocking_factor_y",
    "amr.blocking_factor_z",
    "warpx.numprocs",
    "warpx.abort_on_warning_threshold", "warpx.always_warn_immediately",
    "warpx.do_dynamic_scheduling",
)

_AXES3 = {1: (2,), 2: (0, 2), 3: (0, 1, 2)}
_AXIS_NAMES = {1: ("z",), 2: ("x", "z"), 3: ("x", "y", "z")}


def _no(what: str, item: str):
    raise NotImplementedError(f"deck: {what} (ROADMAP.md {item})")


def _lower(deck: Deck, key: str, default: str) -> str:
    return (deck.get_string(key, default) or default).strip('"').lower()


def _predefined_profile(deck: Deck, name: str, profile: str):
    """A predefined density profile as the JAX reader reads it
    (warpx_tpu/core/deck.py:44-64): the parabolic channel
    (InjectorDensity.H:74-107) becomes the equivalent parsed expression;
    any other stays ``predefined``, which the injection refuses."""
    pname = _lower(deck, f"{name}.predefined_profile_name", "")
    params = deck.get_reals(f"{name}.predefined_profile_params", [])
    if not (pname == "parabolic_channel" and len(params) >= 6):
        return profile, None
    zs, ru, pl, rd, rc, n0 = params[:6]
    kp = _QE / _C * math.sqrt(n0 / (_ME * 8.8541878128e-12))
    inv = 4.0 / (kp * kp * rc ** 4)
    lon = (
        f"(0.5*(1-cos(pi*((z-({zs}))/({ru}))))"
        f"*(((z-({zs}))>=0)&((z-({zs}))<({ru})))"
        f" + (((z-({zs}))>=({ru}))&((z-({zs}))<({ru + pl})))"
        f" + 0.5*(1+cos(pi*((z-({zs}))-({ru + pl}))/({rd})))"
        f"*(((z-({zs}))>=({ru + pl}))&((z-({zs}))<({ru + pl + rd}))))"
    )
    return "parse_density_function", f"({n0})*(1+({inv})*(x*x+y*y))*{lon}"


def _species_from_deck(deck: Deck, name: str, ndim: int,
                       rz: bool = False) -> SpeciesConfig:
    def g(k, default=None):
        return deck.get_real(f"{name}.{k}", default)

    def gs(k, default=""):
        return deck.get_string(f"{name}.{k}", default) or ""

    style = _lower(deck, f"{name}.injection_style", "none").replace('"', "")
    species_type = _lower(deck, f"{name}.species_type", "")
    species_type = _SPECIES_TYPE_ALIASES.get(species_type, species_type)
    type_q, type_m = SPECIES_TYPES.get(species_type, (None, None))
    profile = _lower(deck, f"{name}.profile", "constant")
    density_expr = None
    if profile in ("parse", "parse_density_function"):
        found = deck.get_expr_string(name, "density_function")
        if found:
            density_expr = found[0]
    if profile == "predefined":
        profile, density_expr = _predefined_profile(deck, name, profile)
    mom = _lower(deck, f"{name}.momentum_distribution_type", "at_rest")
    momentum_exprs = momentum_th_exprs = None
    if mom == "parse_momentum_function":
        momentum_exprs = tuple(
            (deck.get_expr_string(name, f"momentum_function_{comp}")
             or ("0",))[0]
            for comp in ("ux", "uy", "uz"))
    elif mom == "gaussian_parse_momentum_function":
        # per-position means and spreads (InjectorMomentumGaussianParser)
        momentum_exprs, momentum_th_exprs = (tuple(
            (deck.get_expr_string(name, f"momentum_function_{comp}_{k}")
             or ("0",))[0]
            for comp in ("ux", "uy", "uz")) for k in ("m", "th"))

    def parsed(what):
        # a parsed temperature or drift (<what>_distribution_type = parser)
        if _lower(deck, f"{name}.{what}_distribution_type",
                  "constant") != "parser":
            return None
        found = deck.get_expr_string(name, f"{what}_function")
        return found[0] if found else None

    inf = math.inf
    full_lo = (g("xmin", -inf), g("ymin", -inf), g("zmin", -inf))
    full_hi = (g("xmax", inf), g("ymax", inf), g("zmax", inf))
    axes = _AXES3[ndim]
    # runtime attributes (PhysicalParticleContainer addRealAttributes /
    # addIntegerAttributes; the JAX reader, warpx_tpu/core/deck.py:105-115)
    attributes = []
    for key, is_int in (("addRealAttributes", False),
                        ("addIntegerAttributes", True)):
        for attr in deck.get_strings(f"{name}.{key}", []):
            found = deck.get_expr_string(f"{name}.attribute", attr)
            if found:
                attributes.append((attr, found[0], is_int))
    charge = g("charge", type_q if type_q is not None else 0.0)
    mass = g("mass", type_m if type_m is not None else 0.0)
    injection_file = None
    if style == "external_file":
        # PlasmaInjector::setupExternalFile: the charge and mass come from
        # the file's records unless the deck gives them (<species>.charge,
        # .mass or species_type), which takes precedence
        injection_file = gs("injection_file").strip('"')
        if not injection_file:
            raise ValueError(f"{name}.injection_file is required")
        from ..io.openpmd import read_openpmd_particles

        meta = read_openpmd_particles(injection_file)
        if type_q is None and g("charge", None) is None \
                and meta["charge"] is not None:
            charge = meta["charge"]
        if type_m is None and g("mass", None) is None \
                and meta["mass"] is not None:
            mass = meta["mass"]
    return SpeciesConfig(
        name=name,
        charge=charge,
        mass=mass,
        injection_style=style,
        injection_file=injection_file,
        z_shift=g("z_shift", 0.0),
        num_particles_per_cell_each_dim=tuple(
            deck.get_ints(f"{name}.num_particles_per_cell_each_dim", ())),
        num_particles_per_cell=deck.get_int(
            f"{name}.num_particles_per_cell", 0),
        profile=profile,
        density=g("density", 0.0),
        density_expr=density_expr,
        momentum_distribution=mom,
        # "constant" reads ux/uy/uz; "gaussian" reads the ux_m/... means
        ux=g("ux_m", g("ux", 0.0)),
        uy=g("uy_m", g("uy", 0.0)),
        uz=g("uz_m", g("uz", 0.0)),
        ux_th=g("ux_th", 0.0), uy_th=g("uy_th", 0.0), uz_th=g("uz_th", 0.0),
        theta=g("theta", 0.0),
        beta_bulk=g("beta", 0.0),
        bulk_vel_dir=(gs("bulk_vel_dir") or "x").lower(),
        theta_expr=parsed("theta"),
        beta_expr=parsed("beta"),
        u_min=(g("ux_min", 0.0), g("uy_min", 0.0), g("uz_min", 0.0)),
        u_max=(g("ux_max", 0.0), g("uy_max", 0.0), g("uz_max", 0.0)),
        momentum_exprs=momentum_exprs,
        momentum_th_exprs=momentum_th_exprs,
        single_particle_pos=tuple(deck.get_reals(
            f"{name}.single_particle_pos", (0.0, 0.0, 0.0))),
        single_particle_u=tuple(deck.get_reals(
            f"{name}.single_particle_u", (0.0, 0.0, 0.0))),
        single_particle_weight=g("single_particle_weight", 0.0),
        multiple_particles=tuple(
            tuple(deck.get_reals(f"{name}.multiple_particles_{c}", ()))
            for c in ("pos_x", "pos_y", "pos_z", "ux", "uy", "uz", "weight")
        ) if style == "multipleparticles" else (),
        surface_flux_pos=g("surface_flux_pos", 0.0),
        flux_normal_axis=(gs("flux_normal_axis") or "z").lower(),
        flux_direction=deck.get_int(f"{name}.flux_direction", 1),
        flux=g("flux", 0.0),
        flux_expr=(
            (deck.get_expr_string(name, "flux_function") or ("",))[0]
            if (gs("flux_profile") or "").lower().startswith("parse")
            else ""),
        flux_tmin=g("flux_tmin", -1.0),
        flux_tmax=g("flux_tmax", -1.0),
        bounds_lo=tuple(full_lo[a] for a in axes),
        bounds_hi=tuple(full_hi[a] for a in axes),
        do_not_push=bool(deck.get_int(f"{name}.do_not_push", 0)),
        do_not_gather=bool(deck.get_int(f"{name}.do_not_gather", 0)),
        do_not_deposit=bool(deck.get_int(f"{name}.do_not_deposit", 0)),
        user_constants=tuple(sorted(deck.my_constants.items())),
        do_continuous_injection=bool(
            deck.get_int(f"{name}.do_continuous_injection", 0)),
        # the scraping buffers, rigid injection and the thermal walls'
        # spread as the JAX reader reads them (warpx_tpu/core/deck.py:
        # 184-198, 214): zinject_plane only for a listed rigid species
        save_particles_at=tuple(
            f"{ax}{side}" for ax in "xyz" for side in ("lo", "hi")
            if deck.get_bool(f"{name}.save_particles_at_{ax}{side}", False)
        ) + (("eb",) if deck.get_bool(f"{name}.save_particles_at_eb", False)
             else ()),
        zinject_plane=(
            g("zinject_plane", None) if name in deck.get_strings(
                "particles.rigid_injected_species", []) else None),
        rigid_advance=deck.get_bool(f"{name}.rigid_advance", True),
        do_backward_propagation=deck.get_bool(
            f"{name}.do_backward_propagation", False),
        attributes=tuple(attributes),
        boundary_u_th=deck.get_real(f"boundary.{name}.u_th", 0.0),
        species_type=species_type,
        x_rms=g("x_rms", 0.0), y_rms=g("y_rms", 0.0), z_rms=g("z_rms", 0.0),
        x_m=g("x_m", 0.0), y_m=g("y_m", 0.0), z_m=g("z_m", 0.0),
        npart=deck.get_int(f"{name}.npart", 0),
        q_tot=g("q_tot", 0.0),
        # field ionization, QED and resampling as the JAX reader reads them
        # (warpx_tpu/core/deck.py:183-252)
        do_field_ionization=bool(
            deck.get_int(f"{name}.do_field_ionization", 0)),
        physical_element=gs("physical_element"),
        ionization_initial_level=deck.get_int(
            f"{name}.ionization_initial_level", 0),
        ionization_product_species=gs("ionization_product_species"),
        do_qed_quantum_sync=deck.get_bool(f"{name}.do_qed_quantum_sync",
                                          False),
        qed_product=gs("qed_quantum_sync_phot_product_species"),
        do_qed_breit_wheeler=deck.get_bool(f"{name}.do_qed_breit_wheeler",
                                           False),
        qed_bw_ele_product=gs("qed_breit_wheeler_ele_product_species"),
        qed_bw_pos_product=gs("qed_breit_wheeler_pos_product_species"),
        do_resampling=bool(deck.get_int(f"{name}.do_resampling", 0)),
        resampling_algorithm=(gs("resampling_algorithm")
                              or "leveling_thinning").lower(),
        resampling_trigger_intervals=tuple(deck.get_strings(
            f"{name}.resampling_trigger_intervals", ["0"])),
        resampling_trigger_max_avg_ppc=g("resampling_trigger_max_avg_ppc",
                                         math.inf),
        resampling_target_ratio=g("resampling_algorithm_target_ratio", 1.5),
        resampling_min_ppc=deck.get_int(f"{name}.resampling_min_ppc", 1),
        resampling_velocity_grid_type=(
            gs("resampling_algorithm_velocity_grid_type")
            or "spherical").lower(),
        resampling_delta_ur=g("resampling_algorithm_delta_ur", 0.0),
        resampling_n_theta=deck.get_int(
            f"{name}.resampling_algorithm_n_theta", 1),
        resampling_n_phi=deck.get_int(f"{name}.resampling_algorithm_n_phi",
                                      1),
        resampling_delta_u=tuple(deck.get_reals(
            f"{name}.resampling_algorithm_delta_u", (0.0, 0.0, 0.0))),
        # RZ only (the JAX reader reads it for every deck and only its RZ
        # injection uses it, warpx_tpu/core/deck.py:171)
        **({"random_theta": deck.get_bool(f"{name}.random_theta", True)}
           if rz else {}),
    )


def _laser_from_deck(deck: Deck, name: str) -> LaserConfig:
    def g(k, default=None):
        return deck.get_real(f"{name}.{k}", default)

    def gv(k, default):
        return tuple(deck.get_reals(f"{name}.{k}", default))

    wavelength = g("wavelength", 1e-6)
    return LaserConfig(
        name=name,
        profile=(deck.get_string(f"{name}.profile", "gaussian") or "").lower(),
        position=gv("position", (0.0, 0.0, 0.0)),
        direction=gv("direction", (0.0, 0.0, 1.0)),
        polarization=gv("polarization", (1.0, 0.0, 0.0)),
        e_max=(g("e_max", 0.0)
               or g("a0", 0.0) * _ME * (2.0 * math.pi * 299792458.0
                                       / wavelength) * 299792458.0 / _QE),
        wavelength=wavelength,
        profile_waist=g("profile_waist", 1e-6),
        profile_duration=g("profile_duration", 1e-15),
        profile_t_peak=g("profile_t_peak", 0.0),
        profile_focal_distance=g("profile_focal_distance", 0.0),
        phi0=g("phi0", 0.0),
        zeta=g("zeta", 0.0),
        beta=g("beta", 0.0),
        phi2=g("phi2", 0.0),
        theta_stc=g("theta_stc", 0.0),
        do_continuous_injection=bool(
            deck.get_int(f"{name}.do_continuous_injection", 0)),
        lasy_file_name=(deck.get_string(f"{name}.lasy_file_name", "")
                        or "").strip('"'),
        delay=g("delay", 0.0),
    )


def _ext_grid(deck: Deck, which: str):
    """warpx.<E|B>_ext_grid_init_style as the JAX reader reads it
    (warpx_tpu/core/deck.py:850-874; reference WarpXInitData.cpp
    InitLevelData, ReadExternalFieldFromFile): ("constant", (x, y, z)),
    ("parse", (fx, fy, fz)), ("file", (path,)) or None."""
    style = _lower(deck, f"warpx.{which}_ext_grid_init_style", "")
    if style == "constant":
        return ("constant", tuple(deck.get_reals(
            f"warpx.{which}_external_grid", (0.0,) * 3)))
    if style.startswith("parse"):
        return ("parse", tuple(
            (deck.get_expr_string("warpx", f"{which}{c}_external_grid_function")
             or ("0",))[0] for c in "xyz"))
    if style == "read_from_file":
        path = (deck.get_string("warpx.read_fields_from_path", "")
                or "").strip('"')
        if not path:
            raise ValueError("warpx.read_fields_from_path is required")
        return ("file", (path,))
    return None


def _tiling_from_deck(deck: Deck, ndim: int) -> dict:
    """warpx.sort_intervals / warpx.sort_bin_size (the reference's particle
    sorting keys, WarpXEvolve.cpp:575-580) and the tile-binned layout's
    ``tpu.*`` keys (warpx_tpu/core/deck.py:1458-1492)."""
    out = {}
    iv = deck.get_strings("warpx.sort_intervals", [])
    if iv:
        try:
            period = int(str(iv[-1]).split(":")[-1])
            if period > 0:
                out["sort_interval"] = period
        except ValueError:
            pass
    if ndim == 3:
        bins = tuple(deck.get_ints("warpx.sort_bin_size", ()))
        if len(bins) == 3 and all(b > 0 for b in bins):
            out["tile_size"] = bins
    out["tiled_particles"] = _lower(deck, "tpu.tiled_particles", "auto")
    m = deck.get_int("tpu.sort_margin", 0)
    if m:
        out["sort_margin"] = m
    hr = deck.get_real("tpu.tile_headroom", 0.0)
    if hr:
        out["tile_headroom"] = hr
    mxu = _lower(deck, "tpu.tile_mxu", "f32")
    if mxu not in ("f32", "mixed", "bf16"):
        raise ValueError(f"tpu.tile_mxu must be f32|mixed|bf16, got {mxu}")
    out["tile_mxu"] = mxu
    out.update(_load_balance_from_deck(deck))
    return out


def _load_balance_from_deck(deck: Deck) -> dict:
    """The dynamic load balancing keys of ``DistSimulation.load_balance``
    (WarpX.cpp:1264-1281; the JAX reader's, warpx_tpu/core/deck.py:
    1492-1518), with its refusal of per-box timer costs."""
    out = {}
    lb_iv = deck.get_strings("algo.load_balance_intervals", [])
    if lb_iv:
        out["load_balance_intervals"] = " ".join(lb_iv)
    out["load_balance_with_sfc"] = bool(
        deck.get_int("algo.load_balance_with_sfc", 0)
    )
    kf = deck.get_real("algo.load_balance_knapsack_factor", 0.0)
    if kf:
        out["load_balance_knapsack_factor"] = kf
    th = deck.get_real("algo.load_balance_efficiency_ratio_threshold", -1.0)
    if th >= 0.0:
        out["load_balance_efficiency_ratio_threshold"] = th
    cu = (deck.get_string("algo.load_balance_costs_update", "heuristic")
          or "heuristic").lower().replace("-", "").replace("_", "")
    if cu == "timers":
        raise NotImplementedError(
            "algo.load_balance_costs_update = timers (per-box profiler "
            "costs) is not implemented; use heuristic"
        )
    out["load_balance_costs_update"] = "heuristic"
    cw = deck.get_real("algo.costs_heuristic_cells_wt", -1.0)
    if cw >= 0.0:
        out["costs_heuristic_cells_wt"] = cw
    pw = deck.get_real("algo.costs_heuristic_particles_wt", -1.0)
    if pw >= 0.0:
        out["costs_heuristic_particles_wt"] = pw
    return out


# warpx.do_electrostatic values and the solver each runs (the JAX reader's
# es_map, warpx_tpu/core/deck.py:594-597)
_ES_SOLVERS = {
    "none": "none", "labframe": "labframe", "relativistic": "relativistic",
    "labframe-electromagnetostatic": "labframe-electromagnetostatic",
    "labframe-effective-potential": "labframe"}


def _es_solver(deck: Deck) -> str:
    return _lower(deck, "warpx.do_electrostatic",
                  _lower(deck, "algo.do_electrostatic", "none"))


def _dep_default(solver: str, es: str = "none") -> str:
    """The deposition's default depends on the solver (WarpX.cpp:1614-1621):
    direct for PSATD, hybrid and electrostatic runs, Esirkepov
    otherwise."""
    return ("direct" if solver in ("psatd", "hybrid") or es != "none"
            else "esirkepov")


def _macroscopic_from_deck(deck: Deck) -> dict:
    """algo.em_solver_medium = macroscopic: macroscopic.{sigma, epsilon,
    mu} constant or as ``*_function(x,y,z)`` and
    algo.macroscopic_sigma_method (MacroscopicProperties::ReadParameters;
    the JAX reader, warpx_tpu/core/deck.py:899-930)."""
    if _lower(deck, "algo.em_solver_medium", "vacuum") != "macroscopic":
        return {}

    def prop(nm):
        found = deck.get_expr_string("macroscopic", f"{nm}_function")
        return (deck.get_real(f"macroscopic.{nm}", None),
                found[0] if found else "")

    (s_v, s_f), (e_v, e_f), (m_v, m_f) = (prop(nm) for nm in
                                          ("sigma", "epsilon", "mu"))
    return dict(
        em_solver_medium="macroscopic",
        macroscopic_sigma_method=_lower(
            deck, "algo.macroscopic_sigma_method", "backwardeuler"
        ).replace("_", "").replace("-", ""),
        macro_sigma=s_v, macro_sigma_function=s_f,
        macro_epsilon=e_v, macro_epsilon_function=e_f,
        macro_mu=m_v, macro_mu_function=m_f)


def _hybrid_from_deck(deck: Deck, em_solver: str) -> dict:
    """The hybrid_pic_model.* keys (HybridPICModel::ReadParameters; the
    JAX reader's ``_hybrid_from_deck``, warpx_tpu/core/deck.py:1223-1260):
    elec_temp is required, in eV."""
    if em_solver != "hybrid":
        return {}
    p = "hybrid_pic_model"
    elec_temp = deck.get_real(f"{p}.elec_temp", None)
    if elec_temp is None:
        raise ValueError("hybrid_pic_model.elec_temp must be specified when "
                         "using the hybrid solver")
    eta = (deck.get_string(f"{p}.plasma_resistivity(rho,J)", None)
           or str(deck.get_real(f"{p}.plasma_resistivity", 0.0)))
    return dict(
        hybrid_substeps=deck.get_int(f"{p}.substeps", 10),
        hybrid_elec_temp=elec_temp,
        hybrid_n0_ref=deck.get_real(f"{p}.n0_ref", 1.0),
        hybrid_gamma=deck.get_real(f"{p}.gamma", 5.0 / 3.0),
        hybrid_n_floor=deck.get_real(f"{p}.n_floor", 1.0),
        hybrid_eta=eta,
        hybrid_eta_h=deck.get_real(f"{p}.plasma_hyper_resistivity", 0.0),
        hybrid_resistivity_has_J="J" in eta,
        hybrid_j_ext=tuple(
            deck.get_string(f"{p}.J{ax}_external_grid_function(x,y,z,t)", "")
            or deck.get_string(f"{p}.J{ax}_external_function(x,y,z,t)", "")
            or "" for ax in "xyz"))


def _psatd_from_deck(deck: Deck, solver: str, dep: str) -> dict:
    """The psatd.* keys and the multi-J and PML-cleaning keys of
    warpx.*, with the JAX reader's defaults (warpx_tpu/core/deck.py:661-713,
    1013-1047; reference WarpX.cpp:848-870, 1409-1621); velocities in m/s.
    Read for every solver, as the JAX reader reads them."""
    order = deck.get_int("psatd.nox", 16)
    for key in ("psatd.noy", "psatd.noz"):
        o = deck.get_int(key, order)
        if o != order:
            raise NotImplementedError(
                f"anisotropic PSATD stencil orders ({key}={o} != "
                f"nox={order})")
    dive = deck.get_bool("warpx.do_dive_cleaning", False)
    gamma_boost = deck.get_real("warpx.gamma_boost", 1.0)

    def velocity(kind):
        # in units of c; the boost frame's default -sqrt(1-1/gamma^2) e_z
        # (WarpX.cpp:1515-1551)
        if deck.get_bool(f"psatd.use_default_v_{kind}", False):
            if gamma_boost <= 1.0:
                raise ValueError(f"psatd.use_default_v_{kind} = 1 requires "
                                 "warpx.gamma_boost")
            return (0.0, 0.0,
                    -math.sqrt(1.0 - 1.0 / (gamma_boost * gamma_boost)) * _C)
        return tuple(v * _C for v in deck.get_reals(f"psatd.v_{kind}",
                                                    (0.0, 0.0, 0.0)))

    v_gal = velocity("galilean")
    v_com = velocity("comoving")
    multi_j = deck.get_bool("warpx.do_multi_J", False)
    return dict(
        psatd_order=order,
        psatd_periodic_single_box=deck.get_bool(
            "psatd.periodic_single_box_fft", False),
        psatd_current_correction=deck.get_bool(
            "psatd.current_correction",
            not (dep in ("esirkepov", "villasenor", "vay") or dive)),
        # true for Galilean/comoving PSATD (WarpX.cpp:1591-1599), else
        # do_dive_cleaning
        psatd_update_with_rho=deck.get_bool(
            "psatd.update_with_rho",
            dive or any(v_gal) or any(v_com)),
        psatd_time_averaging=deck.get_bool("psatd.do_time_averaging", False),
        psatd_v_galilean=v_gal,
        psatd_v_comoving=v_com,
        psatd_j_in_time=_lower(deck, "psatd.J_in_time",
                               "linear" if multi_j else "constant"),
        multi_j_n_depositions=deck.get_int(
            "warpx.do_multi_J_n_depositions", 1),
        psatd_solution_type=_lower(deck, "psatd.solution_type",
                                   "second-order").replace("_", "-"),
        psatd_rho_in_time=_lower(deck, "psatd.rho_in_time", "linear"),
        do_pml_dive_cleaning=deck.get_bool(
            "warpx.do_pml_dive_cleaning", solver == "psatd" or dive),
        do_pml_divb_cleaning=deck.get_bool(
            "warpx.do_pml_divb_cleaning", solver == "psatd"),
    )


_COLLISION_KINDS = ("pairwisecoulomb", "background_mcc",
                    "background_stopping", "nuclearfusion", "dsmc")


def _table_path(deck: Deck, path: str) -> str:
    """A cross-section file path, relative ones against the deck's
    directory."""
    if deck.base_dir is not None and not os.path.isabs(path):
        path = os.path.normpath(str(deck.base_dir / path))
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"cross-section table {path} (WarpX's come from the warpx-data "
            "repository, which is not part of this one)")
    return path


def _background_expr(deck: Deck, nm: str, what: str) -> str:
    """A background density or temperature: a number, or the
    ``(x,y,z,t)`` expression."""
    val = deck.get_real(f"{nm}.{what}", None)
    if val is not None:
        return str(val)
    return deck.get_string(f"{nm}.{what}(x,y,z,t)", "") or ""


def _mcc_from_deck(deck: Deck, nm: str) -> dict:
    """background_mcc keys -> CollisionConfig fields (the JAX reader's
    ``_mcc_from_deck``; BackgroundMCCCollision.cpp's constructor)."""
    from ..ops.mcc import load_cross_section

    dens = deck.get_real(f"{nm}.background_density", None)
    max_dens = deck.get_real(f"{nm}.max_background_density", 0.0)
    if max_dens == 0.0 and dens is not None:
        max_dens = dens
    procs = []
    for tok in deck.get_strings(f"{nm}.scattering_processes", []):
        path = deck.get_string(f"{tok}.cross_section", None) or \
            deck.get_string(f"{nm}.{tok}_cross_section", None)
        if path is None:
            raise ValueError(f"{nm}: no cross section for process {tok}")
        e_arr, s_arr = load_cross_section(_table_path(deck, path))
        base = "excitation" if tok.startswith("excitation") else (
            "ionization" if tok.startswith("ionization") else tok)
        procs.append(MCCProcessConfig(
            kind=base, energy_penalty=deck.get_real(f"{nm}.{tok}_energy",
                                                    0.0),
            energies=tuple(e_arr.tolist()), sigmas=tuple(s_arr.tolist())))
    return dict(
        background_density=_background_expr(deck, nm, "background_density"),
        background_temperature=_background_expr(deck, nm,
                                                 "background_temperature"),
        background_mass=deck.get_real(f"{nm}.background_mass", -1.0),
        max_background_density=max_dens,
        ionization_species=deck.get_string(f"{nm}.ionization_species", "")
        or "",
        processes=tuple(procs))


def _fusion_kind(deck: Deck, nm: str, pair) -> str:
    """The fusion type from the reactants' species types
    (BinaryCollisionUtils::get_nuclear_fusion_type)."""
    def stype(sp):
        t = _lower(deck, f"{sp}.species_type", "")
        return _SPECIES_TYPE_ALIASES.get(t, t)

    tset = {stype(sp) for sp in pair[:2]}
    if tset == {"hydrogen1", "boron11"}:
        return "protonboron"
    if tset == {"hydrogen2", "hydrogen3"}:
        return "dt"
    if tset == {"hydrogen2"}:
        prods = {stype(p) for p in deck.get_strings(
            f"{nm}.product_species", [])}
        return "ddp" if "hydrogen3" in prods else "ddn"
    if tset == {"hydrogen2", "helium3"}:
        return "dhe"
    raise NotImplementedError(f"nuclear fusion between species types {tset}")


def _collisions_from_deck(deck: Deck):
    """``collisions.collision_names`` -> CollisionConfig, in the deck's
    order (the JAX reader, ``deck.py:755-845``)."""
    from ..ops.dsmc import load_cross_section

    out = []
    for nm in deck.get_strings("collisions.collision_names", []):
        pair = deck.get_strings(f"{nm}.species", [])
        kind = _lower(deck, f"{nm}.type", "pairwisecoulomb")
        if kind not in _COLLISION_KINDS:
            raise NotImplementedError(f"deck: collision type {kind!r}")
        kw = {}
        if kind == "background_mcc":
            kw = _mcc_from_deck(deck, nm)
        elif kind == "dsmc":
            procs = []
            for proc in deck.get_strings(f"{nm}.scattering_processes", []):
                en, sg = load_cross_section(_table_path(
                    deck, deck.get_string(f"{nm}.{proc}_cross_section", "")
                    or ""))
                procs.append(MCCProcessConfig(kind=proc, energies=tuple(en),
                                              sigmas=tuple(sg)))
            kw = dict(processes=tuple(procs))
        elif kind == "nuclearfusion":
            kw = dict(
                product_species=tuple(deck.get_strings(
                    f"{nm}.product_species", [])),
                fusion_kind=_fusion_kind(deck, nm, pair),
                fusion_multiplier=deck.get_real(f"{nm}.fusion_multiplier",
                                                1.0),
                fusion_probability_threshold=deck.get_real(
                    f"{nm}.fusion_probability_threshold", 0.02),
                fusion_probability_target_value=deck.get_real(
                    f"{nm}.fusion_probability_target_value", 0.002))
        elif kind == "background_stopping":
            kw = dict(
                background_density=_background_expr(deck, nm,
                                                    "background_density"),
                background_temperature=_background_expr(
                    deck, nm, "background_temperature"),
                background_mass=deck.get_real(f"{nm}.background_mass",
                                              -1.0),
                background_type=_lower(deck, f"{nm}.background_type",
                                       "electrons"),
                background_charge_state=deck.get_real(
                    f"{nm}.background_charge_state", 0.0))
        out.append(CollisionConfig(
            name=nm,
            species=(tuple(pair[:2]) if len(pair) >= 2
                     else (pair[0], pair[0])),
            kind=kind,
            coulomb_log=deck.get_real(f"{nm}.CoulombLog", -1.0),
            ndt=deck.get_int(f"{nm}.ndt", 1),
            **kw))
    return tuple(out)


def _eb_function(deck: Deck) -> str:
    return (deck.get_string("warpx.eb_implicit_function", "")
            or "").strip('"')


def _eb2_implicit_function(deck: Deck) -> str:
    """The ``eb2.*`` geometry builders as an implicit function (the JAX
    reader's ``_eb2_implicit_function``, deck.py:1351-1415; AMReX's
    convention: > 0 covered; ``*_has_fluid_inside`` picks the side).  The
    reference ignores ``eb2.*`` when ``warpx.eb_implicit_function`` is set
    (WarpXInitEB.cpp:103-114)."""
    if _eb_function(deck):
        return ""
    geom_type = (deck.get_string("eb2.geom_type", "") or "").strip(
        '"').lower()
    if not geom_type:
        return ""
    ndim = deck.get_int("geometry.dims", 3)
    axes = ("x", "y", "z")[:ndim] if ndim != 2 else ("x", "z")
    if geom_type == "box":
        lo = deck.get_reals("eb2.box_lo")
        hi = deck.get_reals("eb2.box_hi")
        fluid_inside = deck.get_bool("eb2.box_has_fluid_inside", True)
        terms = [f"max({ax}-({h!r}),({l!r})-{ax})"
                 for ax, l, h in zip(axes, lo, hi)]
        expr = terms[0]
        for t in terms[1:]:
            expr = f"max({expr},{t})"
    elif geom_type in ("sphere", "cylinder"):
        center = deck.get_reals(f"eb2.{geom_type}_center", [0.0] * 3)
        radius = deck.get_real(f"eb2.{geom_type}_radius")
        fluid_inside = deck.get_bool(f"eb2.{geom_type}_has_fluid_inside",
                                     True)
        if geom_type == "cylinder":
            cyl_dir = deck.get_int("eb2.cylinder_direction", -1)
            if cyl_dir < 0 or cyl_dir >= ndim:
                raise ValueError(
                    "eb2.cylinder_direction is required and must be in "
                    f"[0, {ndim}) (got {cyl_dir})")
            # each transverse axis with its own center component (AMReX
            # CylinderIF skips the entry along the axis)
            pairs = [(ax, center[d]) for d, ax in enumerate(axes)
                     if d != cyl_dir]
        else:
            pairs = list(zip(axes, center))
        r2 = "+".join(f"({ax}-({c!r}))**2" for ax, c in pairs)
        expr = f"sqrt({r2})-({radius!r})"
        if geom_type == "cylinder":
            height = deck.get_real("eb2.cylinder_height", -1.0)
            if height is not None and height >= 0.0:
                # a finite cylinder: the infinite one cut by a slab
                ax_axis, c_axis = axes[cyl_dir], center[cyl_dir]
                expr = (f"max({expr},"
                        f"abs({ax_axis}-({c_axis!r}))-({height / 2.0!r}))")
    else:
        raise NotImplementedError(
            f"EB geometry from eb2.geom_type={geom_type}")
    return expr if fluid_inside else f"-({expr})"


def _implicit_from_deck(deck: Deck) -> dict:
    """algo.evolve_scheme with the implicit_evolve.*, picard.*, newton.*
    and gmres.* keys (the JAX reader's ``_implicit_from_deck``,
    deck.py:1418-1455; ImplicitSolver.H:116-136, PicardSolver.H:118-127)."""
    scheme = _lower(deck, "algo.evolve_scheme", "explicit")
    if scheme == "explicit":
        return {}
    nl = _lower(deck, "implicit_evolve.nonlinear_solver", "picard").strip('"')
    out = {
        "evolve_scheme": scheme,
        "implicit_theta": deck.get_real("implicit_evolve.theta", 0.5),
        "implicit_nonlinear": nl,
        "picard_max_iterations": deck.get_int("picard.max_iterations", 100),
        "picard_rtol": deck.get_real("picard.relative_tolerance", 1.0e-6),
        "picard_atol": deck.get_real("picard.absolute_tolerance", 0.0),
    }
    if nl == "picard":
        # the reference fixes one particle iteration under Picard
        # (ImplicitSolver.H:127)
        out["implicit_max_particle_iterations"] = 1
    else:
        out["implicit_max_particle_iterations"] = deck.get_int(
            "implicit_evolve.max_particle_iterations", 21)
        out.update(
            newton_max_iterations=deck.get_int("newton.max_iterations", 100),
            newton_rtol=deck.get_real("newton.relative_tolerance", 1.0e-6),
            newton_atol=deck.get_real("newton.absolute_tolerance", 0.0),
            gmres_max_iterations=deck.get_int("gmres.max_iterations", 1000),
            gmres_restart=deck.get_int("gmres.restart_length", 30),
            gmres_rtol=deck.get_real("gmres.relative_tolerance", 1.0e-4),
            gmres_atol=deck.get_real("gmres.absolute_tolerance", 0.0),
        )
    return out


def _gate_values(deck: Deck) -> None:
    """Keys the reader reads whose value selects what the port lacks."""
    dims = _lower(deck, "geometry.dims", "3")
    if dims not in ("1", "2", "3"):
        raise ValueError(f"geometry.dims = {dims}")
    solver = _lower(deck, "algo.maxwell_solver", "yee")
    if solver not in ("yee", "ckc", "psatd", "hybrid", "ect", "none"):
        # the JAX reader's refusal (warpx_tpu/core/deck.py:601)
        raise NotImplementedError(f"maxwell solver {solver}")
    if _eb2_implicit_function(deck) or _eb_function(deck):
        # the JAX reader's embedded-boundary refusals (deck.py:355-370)
        if solver == "psatd":
            _no("embedded boundaries with the psatd solver (spectral EB; "
                "the JAX package refuses it too)", "Queue C")
        if deck.get_expr_string("warpx", "eb_potential"):
            _no("warpx.eb_potential (Dirichlet phi on the embedded "
                "boundary in the Poisson solve; the JAX package refuses it "
                "too)", "Queue C")
    es = _es_solver(deck)
    if es not in _ES_SOLVERS:
        raise NotImplementedError(f"electrostatic solver {es!r}")
    medium = _lower(deck, "algo.em_solver_medium", "vacuum")
    if medium not in ("vacuum", "macroscopic"):
        raise NotImplementedError(f"em_solver_medium = {medium}")
    if medium == "macroscopic" and _lower(
            deck, "warpx.grid_type", "staggered") == "collocated":
        # the JAX reader's refusal (warpx_tpu/core/deck.py:904-909)
        raise NotImplementedError(
            "macroscopic medium on collocated grids (reference "
            "MacroscopicEvolveE.cpp:95 also forbids this)")
    if deck.get_bool("warpx.use_hybrid_QED", False) and (
            solver != "psatd" or _lower(deck, "warpx.grid_type",
                                        "staggered") != "collocated"):
        # the JAX reader's refusal (warpx_tpu/core/deck.py:456-463)
        _no("hybrid QED Maxwell requires PSATD + collocated grid (as in "
            "the reference's Hybrid_QED_Push; the JAX reader refuses it "
            "too)", "Queue C")
    if _lower(deck, "warpx.grid_type", "staggered") == "hybrid" and (
            deck.get_bool("warpx.do_current_centering", False)):
        # the JAX reader's refusal (warpx_tpu/core/deck.py:572-579)
        _no("hybrid grid with warpx.do_current_centering = 1 (the JAX "
            "reader refuses it too)", "Queue C")
    scheme = _lower(deck, "algo.evolve_scheme", "explicit")
    if scheme not in ("explicit", "theta_implicit_em", "semi_implicit_em"):
        # the JAX reader's refusals (warpx_tpu/core/deck.py:306-316)
        raise NotImplementedError(f"algo.evolve_scheme = {scheme}")
    if scheme != "explicit":
        nl = _lower(deck, "implicit_evolve.nonlinear_solver",
                    "picard").strip('"')
        if nl not in ("picard", "newton"):
            raise NotImplementedError(f"implicit nonlinear solver {nl}")
    if deck.get_real("warpx.gamma_boost", 1.0) > 1.0:
        # the JAX reader's refusals in a boosted frame
        # (warpx_tpu/core/deck.py:393-400)
        if deck.get_strings("fluids.species_names", []):
            _no("fluid species in a boosted frame (the JAX reader refuses "
                "them)", "Queue C")
        if deck.get_strings("lattice.elements", []):
            # the JAX reader's refusal (warpx_tpu/core/deck.py:397-400)
            _no("accelerator lattice in a boosted frame (the JAX reader "
                "refuses it)", "Queue C")
    dep = _lower(deck, "algo.current_deposition",
                 _dep_default(solver, es))
    if dep not in ("esirkepov", "direct", "vay", "villasenor"):
        raise NotImplementedError(f"algo.current_deposition = {dep}")
    if (deck.get_int("warpx.start_moving_window_step", 0) != 0
            or deck.get_int("warpx.end_moving_window_step", -1) != -1):
        # the JAX package reads the window's step range and never uses it
        # (warpx_tpu/core/deck.py:988-989): its window moves from step 0
        # to the end whatever the deck says
        _no("warpx.start_moving_window_step / end_moving_window_step "
            "other than 0 / -1 (the JAX package reads them and moves the "
            "window from step 0 to the end)", "Queue C")
    _psatd_gates(deck)
    for which in ("E", "B"):
        style = _lower(deck, f"particles.{which}_ext_particle_init_style",
                       "none")
        if style not in ("none", "constant"):
            # the JAX reader reads only "constant" and runs any other
            # style with no external field (warpx_tpu/core/deck.py:738-743)
            _no(f"particles.{which}_ext_particle_init_style = {style} (the "
                "JAX package runs it with no external field)", "Queue C")
    _laser_gates(deck)


def _mr_ref_ratio(deck: Deck, ndim: int) -> tuple:
    """The refinement ratio per active axis (amr.ref_ratio_vect wins over
    the scalar amr.ref_ratio; the JAX reader's ``_mr_ref_ratio``,
    deck.py:487)."""
    vect = deck.get_reals("amr.ref_ratio_vect", ())
    if vect:
        rv = [max(int(v), 1) for v in vect[:ndim]]
        while len(rv) < ndim:
            rv.append(rv[-1])
        return tuple(rv)
    r = max(int(deck.get_real("amr.ref_ratio", 2)), 1)
    return (r,) * ndim


def _laser_gates(deck: Deck) -> None:
    """The laser profiles the JAX reader refuses, with its messages
    (warpx_tpu/core/deck.py:464-481): from_file reads lasy files only, and
    the file must exist (or be loaded already: ``core/laser_file.py``
    keeps each file it read); every profile but Gaussian and from_file is
    refused."""
    from .laser_file import is_loaded

    for nm in deck.get_strings("lasers.names", []):
        prof = _lower(deck, f"{nm}.profile", "gaussian")
        if prof == "from_file":
            fp = (deck.get_string(f"{nm}.lasy_file_name", "")
                  or "").strip('"')
            if not fp:
                raise NotImplementedError(
                    f"laser profile from binary_file_name ({nm}): only the "
                    "lasy (openPMD) format is implemented, as in the JAX "
                    "package (ROADMAP.md Queue C)")
            if not (is_loaded(fp) or os.path.exists(fp)):
                raise FileNotFoundError(f"{nm}.lasy_file_name: {fp}")
        elif prof != "gaussian":
            # reference: LaserProfilesImpl/LaserProfileParseField.cpp; the
            # JAX reader refuses it too (warpx_tpu/core/deck.py:481-482)
            _no(f"laser profile {prof!r} ({nm}.profile; the JAX reader "
                "refuses it)", "Queue C")


def _psatd_gates(deck: Deck) -> None:
    """The PSATD combinations the JAX reader refuses, with its messages
    (warpx_tpu/core/deck.py:406-455; the reference aborts on them)."""
    if (any(deck.get_reals("psatd.v_comoving", (0.0, 0.0, 0.0)))
            or deck.get_bool("psatd.use_default_v_comoving", False)):
        if _lower(deck, "algo.current_deposition", "esirkepov") in (
                "esirkepov", "villasenor"):
            raise NotImplementedError(
                "charge-conserving current depositions cannot be used with "
                "the comoving PSATD algorithm (WarpX.cpp:1575)")
    sol_type = _lower(deck, "psatd.solution_type",
                      "second-order").replace("_", "-")
    multi_j = deck.get_bool("warpx.do_multi_J", False)
    if (_lower(deck, "psatd.rho_in_time", "linear") == "constant"
            and not (sol_type == "first-order" and multi_j)):
        raise NotImplementedError(
            "psatd.rho_in_time=constant not implemented except for "
            "psatd.solution_type=first-order with warpx.do_multi_J=1 "
            "(WarpX.cpp:1454)")
    if (deck.get_int("warpx.do_multi_J_n_depositions", 1) > 1
            and sol_type != "first-order"):
        raise NotImplementedError(
            "warpx.do_multi_J_n_depositions > 1 requires "
            "psatd.solution_type = first-order")
    if sol_type == "first-order":
        faces = (deck.get_strings("boundary.field_lo", [])
                 + deck.get_strings("boundary.field_hi", []))
        if any(b.lower() not in ("periodic", "") for b in faces):
            raise NotImplementedError(
                "first-order PSATD with non-periodic boundaries")
        if deck.get_bool("psatd.do_time_averaging", False):
            raise NotImplementedError(
                "first-order PSATD with time averaging")
    if multi_j and _lower(deck, "algo.current_deposition", "") == "vay":
        raise NotImplementedError(
            "Vay deposition not implemented with multi-J (WarpX.cpp:1162)")


def _item_of_key(deck: Deck, key: str) -> str:
    """The ROADMAP.md item a deck key the reader does not read waits for;
    a key that neither package reads names Queue C (the JAX package lists
    it as unused and runs without it; the port refuses it, so that a
    misspelt key drops nothing silently)."""
    head, _, tail = key.partition(".")
    if (head == "amr" and tail.split("_")[0] in ("plot", "check")
            or "checkpoint" in key or "restart" in key):
        # the legacy AMReX output keys and a restart named in the deck,
        # which neither package reads (the CLI's --restart does)
        return "Queue A 15"
    return "Queue C"


_FORMATS = ("plotfile", "openpmd", "checkpoint")
_FIELDS_TO_PLOT = ["Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"]


def _output_species(deck: Deck):
    return (deck.get_strings("particles.species_names", [])
            + deck.get_strings("lasers.names", []))


def _reduced_params(deck: Deck, nm: str) -> dict:
    """The parameters of reduced diagnostic ``nm`` (the JAX package's
    ``Simulation._setup_diagnostics``): multi-token values (ColliderRelevant
    .species = a b) ride as one space-joined string."""
    params = {}
    for key in ("species", "reduction_type", "normalization"):
        v = deck.get_strings(f"{nm}.{key}", [])
        if v:
            params[key] = " ".join(v)
    for key in ("bin_number", "bin_number_abs", "bin_number_ord"):
        v = deck.get_int(f"{nm}.{key}", 0)
        if v:
            params[key] = v
    for key in ("bin_min", "bin_max", "bin_min_abs", "bin_max_abs",
                "bin_min_ord", "bin_max_ord", "x_probe", "y_probe",
                "z_probe"):
        v = deck.get_real(f"{nm}.{key}", None)
        if v is not None:
            params[key] = v
    for base in ("histogram_function", "filter_function", "reduced_function",
                 "histogram_function_abscissa", "histogram_function_ordinate",
                 "value_function"):
        found = deck.get_expr_string(nm, base)
        if found:
            params[base] = found[0]
    return params


_BTD_FIELDS = _FIELDS_TO_PLOT + ["rho"]


def _btd_from_deck(deck: Deck, nm: str) -> dict:
    """A BackTransformed diagnostic as the JAX package's
    ``Simulation._setup_diagnostics`` reads it (simulation.py:317-345): the
    lab-frame snapshot period ``dt_snapshots_lab`` (or ``dz_snapshots_lab``
    over the window's speed), the number of snapshots (``num_snapshots_lab``,
    else ``num_snapshots``, else 8) and the fields."""
    dt_lab = deck.get_real(f"{nm}.dt_snapshots_lab", None)
    if dt_lab is None:
        dzs = deck.get_real(f"{nm}.dz_snapshots_lab", 0.0)
        dt_lab = dzs / (deck.get_real("warpx.moving_window_v", 1.0) * _C
                        or 1.0)
    num = deck.get_int(f"{nm}.num_snapshots_lab", 0)
    if num <= 0:
        num = deck.get_int(f"{nm}.num_snapshots", 0) or 8
    return {"name": nm, "num_snapshots": num, "dt_snapshots_lab": dt_lab,
            "fields": deck.get_strings(f"{nm}.fields_to_plot",
                                       list(_BTD_FIELDS))}


def outputs_from_deck(deck: Deck) -> dict:
    """The deck's outputs: ``diags`` (Full diagnostics: name, format,
    cadence, fields, species and particle filters), ``btd``
    (BackTransformed diagnostics: name, snapshot count and lab period,
    fields), ``reduced`` (name, kind, cadence, parameters) and the
    ``break_signals`` / ``checkpoint_signals`` of warpx.*; raises
    ``NotImplementedError`` naming the ROADMAP.md item for an output the
    port lacks."""
    from ..diagnostics.reduced import REDUCED_DIAGS

    consts = deck.my_constants
    diags, btd = [], []
    for nm in deck.get_strings("diagnostics.diags_names", []):
        kind = _lower(deck, f"{nm}.diag_type", "full")
        if kind == "backtransformed":
            btd.append(_btd_from_deck(deck, nm))
            continue
        if kind == "boundaryscraping":
            # the buffers themselves are Simulation.scraped_particles
            _no(f"{nm}.diag_type = {kind} (the JAX package writes it as a "
                "Full diagnostic of the instantaneous fields; the scraped "
                "particles are Simulation.scraped_particles)", "Queue C")
        if kind != "full":
            # the JAX package writes any other type as a Full diagnostic
            # of the instantaneous fields (simulation.py:318-370)
            _no(f"{nm}.diag_type = {kind} (the JAX package writes it as a "
                "Full diagnostic)", "Queue C")
        fmt = _lower(deck, f"{nm}.format", "plotfile")
        if fmt not in _FORMATS:
            raise ValueError(f"{nm}.format = {fmt}: not one of {_FORMATS}")
        pfilters = {}
        species = deck.get_strings(f"{nm}.species", []) or None
        for spn in species or _output_species(deck):
            f = {}
            found = deck.get_expr_string(f"{nm}.{spn}", "plot_filter_function")
            if found:
                f["filter"] = found[0]
            stride = deck.get_int(f"{nm}.{spn}.uniform_stride", 0)
            if stride:
                f["stride"] = stride
            frac = deck.get_real(f"{nm}.{spn}.random_fraction", None)
            if frac is not None:
                f["fraction"] = frac
            if f:
                pfilters[spn] = f
        diags.append({
            "name": nm, "format": fmt,
            "intervals": IntervalsParser(
                deck.get_strings(f"{nm}.intervals", ["0"]), consts),
            "fields": deck.get_strings(f"{nm}.fields_to_plot",
                                       list(_FIELDS_TO_PLOT)),
            "species": species, "pfilters": pfilters})
    reduced = []
    for nm in deck.get_strings("warpx.reduced_diags_names", []):
        kind = deck.get_string(f"{nm}.type", "")
        if kind not in REDUCED_DIAGS:
            raise ValueError(f"{nm}.type = {kind!r}: not a reduced "
                             "diagnostic kind")
        if kind == "ChargeOnEB" and deck.get_expr_string(
                nm, "weighting_function"):
            # the JAX package's diagnostic takes a weighting function but
            # its reader never passes the deck's
            _no(f"{nm}.weighting_function (the JAX package reads no "
                "ChargeOnEB weighting from the deck)", "Queue C")
        reduced.append({
            "name": nm, "kind": kind,
            "intervals": IntervalsParser(
                deck.get_strings(f"{nm}.intervals", ["1"]), consts),
            "params": _reduced_params(deck, nm)})
    return {"diags": diags, "btd": btd, "reduced": reduced,
            "break_signals": deck.get_strings("warpx.break_signals", []),
            "checkpoint_signals": deck.get_strings(
                "warpx.checkpoint_signals", [])}


def _lattice_from_deck(deck: Deck) -> tuple:
    """The accelerator lattice laid out from z = 0 (AcceleratorLattice.cpp:
    26-34 ReadLattice; JAX deck.py:1322-1347): a line recurses into its
    elements, a drift advances z, a quad or plasma lens spans [z, z + ds)."""
    out = []

    def read(names, z):
        for nm in names:
            kind = _lower(deck, f"{nm}.type", "")
            if kind == "line":
                z = read(deck.get_strings(f"{nm}.elements", []), z)
            elif kind == "drift":
                z += deck.get_real(f"{nm}.ds", 0.0)
            elif kind in ("quad", "plasmalens"):
                ds = deck.get_real(f"{nm}.ds", 0.0)
                out.append((kind, z, z + ds,
                            deck.get_real(f"{nm}.dEdx", 0.0),
                            deck.get_real(f"{nm}.dBdx", 0.0)))
                z += ds
            else:
                raise NotImplementedError(f"lattice element type {kind}")
        return z

    read(deck.get_strings("lattice.elements", []), 0.0)
    return tuple(out)


def _jax_refuses(what: str):
    raise NotImplementedError(
        f"{what} (the JAX reader refuses it too; ROADMAP.md Queue C)")


def _rz_config_from_deck(deck: Deck) -> SimConfig:
    """An RZ deck (geometry.dims = RZ) as the JAX reader reads it
    (warpx_tpu/core/deck.py:1074-1230): a 2D (r, z) grid with
    n_rz_azimuthal_modes field modes, particles in 3D Cartesian, with its
    refusals and messages; only these keys are read, so any other key of
    the deck is refused as unread (Queue C)."""
    n_cell = tuple(deck.get_ints("amr.n_cell"))
    prob_lo = tuple(deck.get_reals("geometry.prob_lo"))
    prob_hi = tuple(deck.get_reals("geometry.prob_hi"))
    if len(n_cell) != 2:
        raise ValueError("RZ expects amr.n_cell = nr nz")
    field_lo = [b.lower() for b in deck.get_strings(
        "boundary.field_lo", ["none", "periodic"])]
    field_hi = [b.lower() for b in deck.get_strings(
        "boundary.field_hi", ["none", "periodic"])]
    periodic = (False, field_lo[1] == "periodic" and field_hi[1] == "periodic")
    if field_hi[0] == "pml":
        _jax_refuses("RZ radial PML (PML_RZ)")
    solver = _lower(deck, "algo.maxwell_solver", "yee")
    if solver not in ("yee", "psatd"):
        _jax_refuses(f"RZ maxwell solver {solver}")
    if not periodic[1]:
        if solver == "psatd":
            _jax_refuses("RZ PSATD with bounded z (PML_RZ)")
        for b in (field_lo[1], field_hi[1]):
            if b not in ("pec", "none", "absorbing_silver_mueller"):
                _jax_refuses(f"RZ z boundary '{b}'")
    geom = Geometry(ndim=2, n_cell=n_cell, prob_lo=prob_lo, prob_hi=prob_hi,
                    periodic=periodic, rz=True)
    # the particle faces, which the JAX reader leaves unread and its RZ
    # steps fix: absorbed past rmax, wrapped or absorbed along z
    want = {"hi": ("absorbing", "periodic" if periodic[1] else "absorbing"),
            "lo": (("none", "absorbing") if prob_lo[0] == 0.0 else ("none",),
                   "periodic" if periodic[1] else "absorbing")}
    for side in ("lo", "hi"):
        got = [b.lower() for b in deck.get_strings(f"boundary.particle_{side}",
                                                   [])]
        r_ok, z_ok = want[side]
        if got and (got[0] not in (r_ok if side == "lo" else (r_ok,))
                    or len(got) < 2 or got[1] != z_ok):
            _no(f"boundary.particle_{side} = {' '.join(got)} (the JAX "
                "package's RZ steps absorb past rmax and wrap or absorb "
                "along z whatever it says)", "Queue C")
    n_modes = deck.get_int("warpx.n_rz_azimuthal_modes", 1)
    cfl = deck.get_real("warpx.cfl", 0.999)
    const_dt = deck.get_real("warpx.const_dt", None)
    if const_dt is not None:
        dt = const_dt
    elif solver == "psatd":
        # the spectral dt: cfl * the smaller cell / c (WarpXComputeDt.cpp:
        # 69-72)
        dt = cfl * min(geom.dx) / _C
    else:
        from ..rz.core import compute_dt_rz

        dt = compute_dt_rz(geom.dx[0], geom.dx[1], n_modes, cfl)
    pusher = _lower(deck, "algo.particle_pusher", "boris")
    species = tuple(
        dataclasses.replace(_species_from_deck(deck, nm, 2, rz=True),
                            pusher=pusher)
        for nm in deck.get_strings("particles.species_names", []))
    dep = _lower(deck, "algo.current_deposition", "esirkepov")
    dive = deck.get_bool("warpx.do_dive_cleaning", False)
    psatd_kw = {}
    if solver == "psatd":
        # the JAX reader's RZ spectral gates: the standard J-constant and
        # Galilean algorithms with update-with-rho and current correction
        if _lower(deck, "psatd.J_in_time", "constant") != "constant":
            _jax_refuses("RZ PSATD with psatd.J_in_time=linear")
        if deck.get_bool("psatd.do_time_averaging", False):
            _jax_refuses("RZ PSATD time averaging")
        if deck.get_int("warpx.do_multi_J", 0):
            _jax_refuses("RZ multi-J PSATD")
        if dive:
            _jax_refuses("RZ PSATD divergence cleaning (requires "
                         "J_in_time=linear)")
        if dep not in ("direct",):
            _jax_refuses(f"RZ PSATD with {dep} deposition (cell-centered "
                         "direct only)")
        psatd_kw = dict(
            psatd_order=deck.get_int("psatd.noz",
                                     deck.get_int("psatd.nox", 16)),
            # RZ always updates with rho (WarpX.cpp:1589-1590)
            psatd_update_with_rho=deck.get_bool("psatd.update_with_rho",
                                                True),
            psatd_current_correction=deck.get_bool(
                "psatd.current_correction", True),
            psatd_v_galilean=tuple(v * _C for v in deck.get_reals(
                "psatd.v_galilean", (0.0, 0.0, 0.0))))
    # the moving window, along z only (WarpX.cpp asserts it)
    window_kw = {}
    if deck.get_bool("warpx.do_moving_window", False):
        if _lower(deck, "warpx.moving_window_dir", "z") != "z":
            _jax_refuses("RZ moving window must be along z")
        if periodic[1]:
            raise ValueError("moving window requires bounded z")
        window_kw = dict(do_moving_window=True, moving_window_dir=1,
                         moving_window_v=deck.get_real(
                             "warpx.moving_window_v", 1.0))
    # the antennas (LaserParticleContainer RZ: radial spokes)
    lasers = tuple(_laser_from_deck(deck, nm)
                   for nm in deck.get_strings("lasers.names", []))
    laser_species = tuple(
        SpeciesConfig(name=las.name, charge=1.0, mass=0.0,
                      injection_style="laser") for las in lasers)
    _laser_gates(deck)
    return SimConfig(
        geometry=geom,
        max_step=deck.get_int("max_step", deck.get_int("warpx.max_step", 0)),
        dt=dt,
        particle_shape=deck.get_int("algo.particle_shape", 1),
        em_solver=solver,
        current_deposition=dep,
        field_gathering=_lower(deck, "algo.field_gathering",
                               "energy-conserving"),
        use_filter=deck.get_bool("warpx.use_filter", True),
        grid_type=_lower(deck, "warpx.grid_type", "staggered"),
        cfl=cfl,
        n_rz_modes=n_modes,
        do_dive_cleaning=dive,
        field_bc_lo=tuple(field_lo),
        field_bc_hi=tuple(field_hi),
        filter_npass_each_dir=tuple(
            deck.get_ints("warpx.filter_npass_each_dir", (1, 1))),
        lasers=lasers,
        species=species + laser_species,
        user_constants=tuple(sorted(deck.my_constants.items())),
        tiled_particles="off",
        eb_implicit_function=_eb_function(deck),
        **window_kw,
        **psatd_kw,
    )


def _check_unread(deck: Deck, outputs: dict) -> None:
    names = {o["name"] for o in (outputs["diags"] + outputs["btd"]
                                 + outputs["reduced"])}
    unread = [k for k in deck.unused_keys()
              if k not in NO_PHYSICS and k.partition(".")[0] not in names]
    if unread:
        raise NotImplementedError(
            "deck keys the port does not read: " + ", ".join(
                f"{k} (ROADMAP.md {_item_of_key(deck, k)})" for k in unread))


def config_from_deck(deck: Deck) -> SimConfig:
    """The port's ``SimConfig`` from a parsed deck (raises
    ``NotImplementedError`` naming the ROADMAP.md item for what the port
    does not run)."""
    if _lower(deck, "geometry.dims", "3") == "rz":
        # the JAX reader routes RZ first (warpx_tpu/core/deck.py:1074)
        from ..rz.core import check_rz_supported

        cfg = _rz_config_from_deck(deck)
        outputs = outputs_from_deck(deck)
        if outputs["reduced"] or outputs["btd"] or any(
                d["format"] == "openpmd" for d in outputs["diags"]):
            _no("reduced, back-transformed or openPMD outputs of an RZ "
                "run (the JAX package computes them on the Cartesian "
                "layout)", "Queue C")
        # the JAX RZ reader leaves the load-balancing keys at their
        # defaults: read, and dropped
        _load_balance_from_deck(deck)
        _check_unread(deck, outputs)
        check_rz_supported(cfg)
        return cfg
    _gate_values(deck)
    ndim = int(_lower(deck, "geometry.dims", "3"))
    n_cell = tuple(deck.get_ints("amr.n_cell"))
    prob_lo = tuple(deck.get_reals("geometry.prob_lo"))
    prob_hi = tuple(deck.get_reals("geometry.prob_hi"))
    if len(n_cell) != ndim:
        raise ValueError(f"amr.n_cell has {len(n_cell)} entries for "
                         f"geometry.dims = {ndim}")
    # boosted frame: the deck's geometry is in lab coordinates; convert the
    # boost axis with the moving window's contraction
    # (ConvertLabParamsToBoost, WarpXUtil.cpp:180-263)
    gamma_boost = deck.get_real("warpx.gamma_boost", 1.0)
    boost_dir = _lower(deck, "warpx.boost_direction", "z")
    if gamma_boost > 1.0:
        beta_boost = math.sqrt(1.0 - 1.0 / (gamma_boost * gamma_boost))
        d = _AXIS_NAMES[ndim].index(boost_dir)
        beta_window = beta_boost
        if deck.get_bool("warpx.do_moving_window", False) and (
                deck.get_string("warpx.moving_window_dir", "z").lower()
                == boost_dir):
            beta_window = deck.get_real("warpx.moving_window_v", 1.0)
        factor = 1.0 / (gamma_boost * (1.0 - beta_boost * beta_window))
        prob_lo = tuple(v * factor if i == d else v
                        for i, v in enumerate(prob_lo))
        prob_hi = tuple(v * factor if i == d else v
                        for i, v in enumerate(prob_hi))

    field_lo = [b.lower() for b in deck.get_strings(
        "boundary.field_lo", ["periodic"] * ndim)]
    field_hi = [b.lower() for b in deck.get_strings(
        "boundary.field_hi", ["periodic"] * ndim)]
    default_pbc = ["periodic" if lo == "periodic" else "absorbing"
                   for lo in field_lo]
    particle_lo = [b.lower() for b in deck.get_strings(
        "boundary.particle_lo", default_pbc)]
    particle_hi = [b.lower() for b in deck.get_strings(
        "boundary.particle_hi", default_pbc)]
    geom = Geometry(
        ndim=ndim, n_cell=n_cell, prob_lo=prob_lo, prob_hi=prob_hi,
        periodic=tuple(lo == "periodic" and hi == "periodic"
                       for lo, hi in zip(field_lo, field_hi)))

    grid_type = _lower(deck, "warpx.grid_type", "staggered")
    xi_q = deck.get_real("warpx.quantum_xi", None)
    max_step = deck.get_int("max_step", deck.get_int("warpx.max_step", 0))
    cfl = deck.get_real("warpx.cfl", 0.999)
    const_dt = deck.get_real("warpx.const_dt", None)
    em_solver = _lower(deck, "algo.maxwell_solver", "yee")
    es_solver = _ES_SOLVERS[_es_solver(deck)]
    if es_solver != "none":
        # the Poisson solve replaces the field solver
        em_solver = "none"
    # Dirichlet wall potentials f(t) per active dim (PoissonBoundaryHandler)
    boundary_potentials = tuple(
        (deck.get_string(f"boundary.potential_lo_{nm}", "") or "",
         deck.get_string(f"boundary.potential_hi_{nm}", "") or "")
        for nm in _AXIS_NAMES[ndim])
    if not any(lo or hi for lo, hi in boundary_potentials):
        boundary_potentials = ()
    if const_dt is not None:
        dt = const_dt
    elif em_solver == "psatd":
        dt = cfl * min(geom.dx) / _C
    elif em_solver == "ckc" and grid_type != "collocated":
        dt = compute_dt_ckc(geom, cfl)
    else:
        # Yee and collocated (nodal) share the same CFL formula
        dt = compute_dt_yee(geom, cfl)
    if const_dt is None and deck.get_int("amr.max_level", 0) > 0:
        # the finest level's cell sets dt (WarpXComputeDt.cpp:57
        # geom[max_level].CellSize()); under subcycling the coarse step is
        # ref_ratio fine steps (ComputeDt do_subcycling)
        rv = _mr_ref_ratio(deck, ndim)
        geom_f = dataclasses.replace(
            geom, n_cell=tuple(n * r for n, r in zip(geom.n_cell, rv)))
        dt = (compute_dt_ckc(geom_f, cfl)
              if em_solver == "ckc" and grid_type != "collocated"
              else compute_dt_yee(geom_f, cfl))
        if deck.get_bool("warpx.do_subcycling", False):
            dt *= rv[0]
    # stop_time: run while cur_time < stop_time (WarpXEvolve.cpp:112)
    stop_time = deck.get_real("stop_time",
                              deck.get_real("warpx.stop_time", None))
    if stop_time is not None:
        n_stop = max(int(math.ceil(stop_time / dt * (1.0 - 1e-12))), 0)
        max_step = min(max_step, n_stop) if max_step > 0 else n_stop

    dep = _lower(deck, "algo.current_deposition",
                 _dep_default(em_solver, es_solver))
    pusher = _lower(deck, "algo.particle_pusher", "boris")
    # per-species classical radiation reaction upgrades Boris to the
    # Tamburini pusher (PhysicalParticleContainer.cpp:325; the JAX reader,
    # warpx_tpu/core/deck.py:718-730)
    species = tuple(
        dataclasses.replace(
            _species_from_deck(deck, nm, ndim),
            pusher="boris_rr" if pusher == "boris" and deck.get_bool(
                f"{nm}.do_classical_radiation_reaction", False) else pusher)
        for nm in deck.get_strings("particles.species_names", []))
    ext = {}
    for which in ("E", "B"):
        style = _lower(deck, f"particles.{which}_ext_particle_init_style",
                       "none")
        ext[which] = (tuple(deck.get_reals(
            f"particles.{which}_external_particle", (0.0, 0.0, 0.0)))
            if style == "constant" else (0.0, 0.0, 0.0))

    # moving window (reference: WarpX.cpp:640-660)
    do_window = deck.get_bool("warpx.do_moving_window", False)
    window_dir = -1
    if do_window:
        window_dir = _AXIS_NAMES[ndim].index(
            deck.get_string("warpx.moving_window_dir", "z").lower())
    lasers = tuple(_laser_from_deck(deck, nm)
                   for nm in deck.get_strings("lasers.names", []))
    if gamma_boost > 1.0:
        # the antenna plane at Z0_lab / gamma along its normal
        lasers = tuple(
            dataclasses.replace(las, position=pos, z0_lab=z0)
            for las, (pos, z0) in (
                (las, boost_laser_position(las, gamma_boost))
                for las in lasers))
    # each antenna is a species of its own, after the deck's species
    laser_species = tuple(
        SpeciesConfig(name=las.name, charge=1.0, mass=0.0,
                      injection_style="laser")
        for las in lasers)

    cfg = SimConfig(
        geometry=geom,
        max_step=max_step,
        dt=dt,
        particle_shape=deck.get_int("algo.particle_shape", 1),
        em_solver=em_solver,
        current_deposition=dep,
        use_hybrid_qed=deck.get_bool("warpx.use_hybrid_QED", False),
        quantum_xi_c2=(xi_q * _C ** 2 if xi_q is not None
                       else 1.1728865132395492e-35),
        # hybrid grids default to momentum-conserving gathering at
        # centering order 8 (parameters.rst:2223; JAX deck.py:948-966)
        field_gathering=_lower(
            deck, "algo.field_gathering",
            "momentum-conserving" if grid_type == "hybrid"
            else "energy-conserving"),
        grid_type=grid_type,
        field_centering_no=tuple(
            deck.get_int(f"warpx.field_centering_no{ax}",
                         8 if grid_type == "hybrid" else 2)
            for ax in _AXIS_NAMES[ndim]),
        lattice_elements=_lattice_from_deck(deck),
        # the reference's default is use_filter = true (WarpX.cpp:158)
        use_filter=deck.get_bool("warpx.use_filter", True),
        filter_npass_each_dir=tuple(deck.get_ints(
            "warpx.filter_npass_each_dir", (1,) * ndim)),
        use_nci_corr=deck.get_bool(
            "particles.use_fdtd_nci_corr",
            deck.get_bool("warpx.use_fdtd_nci_corr", False)),
        species=species + laser_species,
        cfl=cfl,
        field_bc_lo=tuple(field_lo),
        field_bc_hi=tuple(field_hi),
        particle_bc_lo=tuple(particle_lo),
        particle_bc_hi=tuple(particle_hi),
        do_moving_window=do_window,
        moving_window_dir=window_dir,
        moving_window_v=deck.get_real("warpx.moving_window_v", 1.0),
        start_moving_window_step=deck.get_int(
            "warpx.start_moving_window_step", 0),
        end_moving_window_step=deck.get_int(
            "warpx.end_moving_window_step", -1),
        lasers=lasers,
        pml_ncell=deck.get_int("pml_ncell",
                               deck.get_int("warpx.pml_ncell", 10)),
        max_level=deck.get_int("amr.max_level", 0),
        ref_ratio=_mr_ref_ratio(deck, ndim),
        do_subcycling=deck.get_bool("warpx.do_subcycling", False),
        fine_tag_lo=tuple(deck.get_reals("warpx.fine_tag_lo", ())),
        fine_tag_hi=tuple(deck.get_reals("warpx.fine_tag_hi", ())),
        blocking_factor=deck.get_int("amr.blocking_factor", 8),
        refine_plasma=deck.get_bool("warpx.refine_plasma", False),
        n_field_gather_buffer=deck.get_int("warpx.n_field_gather_buffer", 3),
        n_current_deposition_buffer=deck.get_int(
            "warpx.n_current_deposition_buffer", 2),
        gamma_boost=gamma_boost,
        boost_direction=boost_dir,
        e_ext_particle=ext["E"],
        b_ext_particle=ext["B"],
        e_ext_grid=_ext_grid(deck, "E"),
        b_ext_grid=_ext_grid(deck, "B"),
        electrostatic=es_solver,
        poisson_solver=_lower(deck, "warpx.poisson_solver", "multigrid"),
        boundary_potentials=boundary_potentials,
        do_dive_cleaning=deck.get_bool("warpx.do_dive_cleaning", False),
        do_divb_cleaning=deck.get_bool("warpx.do_divb_cleaning", False),
        do_divb_cleaning_external=deck.get_bool(
            "warpx.do_divb_cleaning_external", False),
        verbose=deck.get_bool("warpx.verbose", False),
        do_qed_schwinger=deck.get_bool("warpx.do_qed_schwinger", False),
        qed_schwinger_ele=deck.get_string(
            "qed_schwinger.ele_product_species", "") or "",
        qed_schwinger_pos=deck.get_string(
            "qed_schwinger.pos_product_species", "") or "",
        qed_schwinger_y_size=deck.get_real("qed_schwinger.y_size", 0.0),
        qed_schwinger_threshold=deck.get_real(
            "qed_schwinger.threshold_poisson_gaussian", 25.0),
        qed_schwinger_bounds_lo=tuple(
            deck.get_real(f"qed_schwinger.{ax}min", float("-inf"))
            for ax in "xyz"),
        qed_schwinger_bounds_hi=tuple(
            deck.get_real(f"qed_schwinger.{ax}max", float("inf"))
            for ax in "xyz"),
        collisions=_collisions_from_deck(deck),
        fluids=tuple(_species_from_deck(deck, nm, ndim)
                     for nm in deck.get_strings("fluids.species_names", [])),
        eb_implicit_function=(_eb_function(deck)
                              or _eb2_implicit_function(deck)),
        user_constants=tuple(sorted(deck.my_constants.items())),
        **_implicit_from_deck(deck),
        **_psatd_from_deck(deck, em_solver, dep),
        **_tiling_from_deck(deck, ndim),
        **_macroscopic_from_deck(deck),
        **_hybrid_from_deck(deck, em_solver),
    )
    if cfg.max_level > 0:
        # the JAX reader's mesh-refinement envelope (warpx_tpu/core/deck.py:
        # 317-355), and what the JAX package's MR step would drop
        from .mr import check_mr_supported

        check_mr_supported(cfg)
    _check_unread(deck, outputs_from_deck(deck))
    return cfg
