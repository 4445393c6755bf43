"""Input deck -> ``SimConfig``.

The counterpart of ``warpx_tpu.core.deck.config_from_deck`` for the fields
the port's ``SimConfig`` holds (2D XZ and 3D explicit electromagnetic runs,
periodic or bounded with PML/PEC faces, moving window, Gaussian laser
antennas, continuous injection, Gaussian beams, constant or parsed density
and momentum profiles, the tile-binned layout and its ``tpu.*`` keys), with
the JAX reader's defaults and derived values (reference: Source/WarpX.cpp:466
ReadParameters; Source/Initialization/PlasmaInjector.cpp), and the deck's
outputs (``outputs_from_deck``: Full diagnostics in plotfile, openPMD or
checkpoint format, reduced diagnostics, signal handling) as the JAX
package's ``Simulation._setup_diagnostics`` reads them.

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

from ..solvers.yee import compute_dt_ckc, compute_dt_yee
from ..utils.intervals import IntervalsParser
from ..utils.parser import Deck
from .config import LaserConfig, SimConfig, SpeciesConfig
from .grid import Geometry

__all__ = ["NO_PHYSICS", "config_from_deck", "outputs_from_deck"]

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

# keys that change no physics on one device: the reference's box
# decomposition, warning policy, OpenMP scheduling and the multi-device load
# balancing
NO_PHYSICS = (
    "amr.max_grid_size", "amr.max_grid_size_x", "amr.max_grid_size_y",
    "amr.max_grid_size_z",
    "amr.blocking_factor", "amr.blocking_factor_x", "amr.blocking_factor_y",
    "amr.blocking_factor_z",
    "warpx.numprocs",
    "warpx.abort_on_warning_threshold", "warpx.always_warn_immediately",
    "warpx.do_dynamic_scheduling",
    "algo.load_balance_intervals", "algo.load_balance_with_sfc",
    "algo.load_balance_knapsack_factor",
    "algo.load_balance_efficiency_ratio_threshold",
    "algo.load_balance_costs_update", "algo.costs_heuristic_cells_wt",
    "algo.costs_heuristic_particles_wt",
)

_AXES3 = {2: (0, 2), 3: (0, 1, 2)}


def _no(what: str, item: str):
    raise NotImplementedError(f"deck: {what} (ROADMAP.md {item})")


def _lower(deck: Deck, key: str, default: str) -> str:
    return (deck.get_string(key, default) or default).strip('"').lower()


def _species_from_deck(deck: Deck, name: str, ndim: int) -> SpeciesConfig:
    def g(k, default=None):
        return deck.get_real(f"{name}.{k}", default)

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
    mom = _lower(deck, f"{name}.momentum_distribution_type", "at_rest")
    momentum_exprs = None
    if mom == "parse_momentum_function":
        momentum_exprs = tuple(
            (deck.get_expr_string(name, f"momentum_function_{comp}")
             or ("0",))[0]
            for comp in ("ux", "uy", "uz"))
    inf = math.inf
    full_lo = (g("xmin", -inf), g("ymin", -inf), g("zmin", -inf))
    full_hi = (g("xmax", inf), g("ymax", inf), g("zmax", inf))
    axes = _AXES3[ndim]
    return SpeciesConfig(
        name=name,
        charge=g("charge", type_q if type_q is not None else 0.0),
        mass=g("mass", type_m if type_m is not None else 0.0),
        injection_style=style,
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
        momentum_exprs=momentum_exprs,
        bounds_lo=tuple(full_lo[a] for a in axes),
        bounds_hi=tuple(full_hi[a] for a in axes),
        do_not_push=bool(deck.get_int(f"{name}.do_not_push", 0)),
        do_not_gather=bool(deck.get_int(f"{name}.do_not_gather", 0)),
        do_not_deposit=bool(deck.get_int(f"{name}.do_not_deposit", 0)),
        user_constants=tuple(sorted(deck.my_constants.items())),
        do_continuous_injection=bool(
            deck.get_int(f"{name}.do_continuous_injection", 0)),
        species_type=species_type,
        x_rms=g("x_rms", 0.0), y_rms=g("y_rms", 0.0), z_rms=g("z_rms", 0.0),
        x_m=g("x_m", 0.0), y_m=g("y_m", 0.0), z_m=g("z_m", 0.0),
        npart=deck.get_int(f"{name}.npart", 0),
        q_tot=g("q_tot", 0.0),
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
    )


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
    return out


def _gate_values(deck: Deck) -> None:
    """Keys the reader reads whose value selects what the port lacks."""
    dims = _lower(deck, "geometry.dims", "3")
    if dims == "1":
        _no("geometry.dims = 1", "Queue A 3-4")
    if dims == "rz":
        _no("geometry.dims = RZ", "Queue A 12")
    if dims not in ("2", "3"):
        raise ValueError(f"geometry.dims = {dims}")
    if deck.get_int("amr.max_level", 0) > 0:
        _no("mesh refinement (amr.max_level > 0)", "Queue A 12")
    solver = _lower(deck, "algo.maxwell_solver", "yee")
    if solver == "psatd":
        _no("algo.maxwell_solver = psatd", "Queue A 10")
    if solver in ("hybrid", "ect"):
        _no(f"algo.maxwell_solver = {solver}", "Queue A 11.3")
    if solver not in ("yee", "ckc", "none"):
        _no(f"algo.maxwell_solver = {solver}", "Queue A 11")
    es = _lower(deck, "warpx.do_electrostatic",
                _lower(deck, "algo.do_electrostatic", "none"))
    if es != "none":
        _no(f"the electrostatic solver {es!r}", "Queue A 11.3")
    scheme = _lower(deck, "algo.evolve_scheme", "explicit")
    if scheme != "explicit":
        _no(f"algo.evolve_scheme = {scheme}", "Queue A 11.3")
    if deck.get_real("warpx.gamma_boost", 1.0) > 1.0:
        _no("the Lorentz-boosted frame (warpx.gamma_boost > 1)", "Queue A 11")
    dep = _lower(deck, "algo.current_deposition", "esirkepov")
    if dep != "esirkepov":
        _no(f"algo.current_deposition = {dep}", "Queue A 3")
    for which in ("E", "B"):
        style = _lower(deck, f"particles.{which}_ext_particle_init_style",
                       "none")
        if style not in ("none", "constant"):
            _no(f"particles.{which}_ext_particle_init_style = {style}",
                "Queue A 11")


def _item_of_key(deck: Deck, key: str) -> str:
    """The ROADMAP.md item a deck key the reader does not read waits for."""
    head, _, tail = key.partition(".")
    if (head == "amr" and tail.split("_")[0] in ("plot", "check")
            or "checkpoint" in key or "restart" in key):
        # the legacy AMReX output keys and a restart named in the deck,
        # which neither package reads (the CLI's --restart does)
        return "Queue A 15"
    if head == "psatd":
        return "Queue A 10"
    if head == "collisions" or head in deck.get_strings(
            "collisions.collision_names", []) or head.startswith("qed"):
        return "Queue A 11.1"
    if head in ("fluids", "hybrid_pic_model", "macroscopic", "eb2",
                "implicit_evolve", "picard", "newton", "gmres") or (
            tail.startswith("eb_") or "quantum_xi" in tail):
        return "Queue A 11.3"
    if head == "amr" or tail in ("do_subcycling", "fine_tag_lo",
                                 "fine_tag_hi", "refine_plasma",
                                 "n_rz_azimuthal_modes"):
        return "Queue A 12"
    if head in deck.get_strings("particles.species_names", []):
        if tail == "do_classical_radiation_reaction":
            return "Queue A 2"
        if ("ionization" in tail or "qed" in tail or tail == "physical_element"
                or tail.startswith("resampling") or tail == "do_resampling"):
            return "Queue A 11.1"
        if "flux" in tail or tail in ("injection_file", "single_particle_pos",
                                      "single_particle_u",
                                      "single_particle_weight") or (
                tail.startswith("multiple_particles")):
            return "Queue A 11.2"
    if head in deck.get_strings("lasers.names", []) and tail in (
            "lasy_file_name", "binary_file_name", "delay"):
        return "Queue A 11.2"
    return "Queue A 11"


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


def outputs_from_deck(deck: Deck) -> dict:
    """The deck's outputs: ``diags`` (Full diagnostics: name, format,
    cadence, fields, species and particle filters), ``reduced`` (name, kind,
    cadence, parameters) and the ``break_signals`` / ``checkpoint_signals``
    of warpx.*; raises ``NotImplementedError`` naming the ROADMAP.md item
    for an output the port lacks."""
    from ..diagnostics.reduced import REDUCED_DIAGS

    consts = deck.my_constants
    diags = []
    for nm in deck.get_strings("diagnostics.diags_names", []):
        kind = _lower(deck, f"{nm}.diag_type", "full")
        if kind != "full":
            what = ("BackTransformed: the boosted frame's back-transformed "
                    "diagnostics" if kind == "backtransformed" else kind)
            _no(f"{nm}.diag_type = {what}", "Queue A 11")
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
        if kind == "ChargeOnEB":
            _no(f"reduced diagnostic {nm}.type = ChargeOnEB: embedded "
                "boundaries", "Queue A 11.3")
        if kind not in REDUCED_DIAGS:
            raise ValueError(f"{nm}.type = {kind!r}: not a reduced "
                             "diagnostic kind")
        reduced.append({
            "name": nm, "kind": kind,
            "intervals": IntervalsParser(
                deck.get_strings(f"{nm}.intervals", ["1"]), consts),
            "params": _reduced_params(deck, nm)})
    return {"diags": diags, "reduced": reduced,
            "break_signals": deck.get_strings("warpx.break_signals", []),
            "checkpoint_signals": deck.get_strings(
                "warpx.checkpoint_signals", [])}


def config_from_deck(deck: Deck) -> SimConfig:
    """The port's ``SimConfig`` from a parsed deck (raises
    ``NotImplementedError`` naming the ROADMAP.md item for what the port
    does not run)."""
    _gate_values(deck)
    ndim = int(_lower(deck, "geometry.dims", "3"))
    n_cell = tuple(deck.get_ints("amr.n_cell"))
    prob_lo = tuple(deck.get_reals("geometry.prob_lo"))
    prob_hi = tuple(deck.get_reals("geometry.prob_hi"))
    if len(n_cell) != ndim:
        raise ValueError(f"amr.n_cell has {len(n_cell)} entries for "
                         f"geometry.dims = {ndim}")
    gamma_boost = deck.get_real("warpx.gamma_boost", 1.0)

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
    max_step = deck.get_int("max_step", deck.get_int("warpx.max_step", 0))
    cfl = deck.get_real("warpx.cfl", 0.999)
    const_dt = deck.get_real("warpx.const_dt", None)
    em_solver = _lower(deck, "algo.maxwell_solver", "yee")
    if const_dt is not None:
        dt = const_dt
    elif em_solver == "ckc" and grid_type != "collocated":
        dt = compute_dt_ckc(geom, cfl)
    else:
        # Yee and collocated (nodal) share the same CFL formula
        dt = compute_dt_yee(geom, cfl)
    # stop_time: run while cur_time < stop_time (WarpXEvolve.cpp:112)
    stop_time = deck.get_real("stop_time",
                              deck.get_real("warpx.stop_time", None))
    if stop_time is not None:
        n_stop = max(int(math.ceil(stop_time / dt * (1.0 - 1e-12))), 0)
        max_step = min(max_step, n_stop) if max_step > 0 else n_stop

    pusher = _lower(deck, "algo.particle_pusher", "boris")
    species = tuple(
        dataclasses.replace(_species_from_deck(deck, nm, ndim), pusher=pusher)
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
        window_dir = {2: ["x", "z"], 3: ["x", "y", "z"]}[ndim].index(
            deck.get_string("warpx.moving_window_dir", "z").lower())
    lasers = tuple(_laser_from_deck(deck, nm)
                   for nm in deck.get_strings("lasers.names", []))
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
        current_deposition=_lower(deck, "algo.current_deposition",
                                  "esirkepov"),
        field_gathering=_lower(deck, "algo.field_gathering",
                               "energy-conserving"),
        grid_type=grid_type,
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
        lasers=lasers,
        pml_ncell=deck.get_int("pml_ncell",
                               deck.get_int("warpx.pml_ncell", 10)),
        gamma_boost=gamma_boost,
        e_ext_particle=ext["E"],
        b_ext_particle=ext["B"],
        em_solver_medium=_lower(deck, "algo.em_solver_medium", "vacuum"),
        do_dive_cleaning=deck.get_bool("warpx.do_dive_cleaning", False),
        do_divb_cleaning=deck.get_bool("warpx.do_divb_cleaning", False),
        verbose=deck.get_bool("warpx.verbose", False),
        **_tiling_from_deck(deck, ndim),
    )
    outputs = outputs_from_deck(deck)
    names = {o["name"] for o in outputs["diags"] + outputs["reduced"]}
    unread = [k for k in deck.unused_keys()
              if k not in NO_PHYSICS and k.partition(".")[0] not in names]
    if unread:
        raise NotImplementedError(
            "deck keys the port does not read: " + ", ".join(
                f"{k} (ROADMAP.md {_item_of_key(deck, k)})" for k in unread))
    return cfg
