"""Plasma injection: per-cell particle placement, weights, momentum sampling.

The counterpart of ``warpx_tpu.core.injection``: ``inject_species`` for
NUniformPerCell / NRandomPerCell placement, a constant or parsed
(``parse_density_function``) density profile inside optional bounds and
``at_rest`` / ``constant`` / ``gaussian`` / ``maxwell_boltzmann`` /
``maxwell_juttner`` (with parsed temperature and drift) / ``uniform`` /
``parse_momentum_function`` / ``gaussian_parse_momentum_function`` momenta
(reference: PhysicalParticleContainer.cpp:925-1334,
InjectorPosition.H:67-107, InjectorMomentum.H), the ``singleparticle``,
``multipleparticles`` and ``external_file`` (openPMD, AddPlasmaFromFile)
styles, and ``inject_gaussian_beam`` (PhysicalParticleContainer.cpp:503-680,
with ``do_backward_propagation``), the plasma styles and the beam with
the deck's runtime attributes at each particle (``attribute_values``),
in the lab frame or, with ``gamma_boost`` > 1, mapped into the
Lorentz-boosted frame (profiles and bounds are the lab's at t_lab = 0:
AddPlasma's ballistic correction and boost transform,
MapParticletoBoostedFrame for the beam).  They run on the host in numpy and
draw from the caller's ``np.random.Generator`` in the same order as the JAX
package, so the same seed gives bit-identical particles.  The ``*_host``
functions return the columns as numpy arrays (the bounded
``Simulation.init`` re-lays them out before its one transfer);
``inject_species`` and ``inject_gaussian_beam`` move them to a device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import constants
from ..utils.expression import compile_expression
from .config import SpeciesConfig
from .grid import Geometry
from .state import ParticleState

__all__ = ["inject_species", "inject_species_host", "inject_gaussian_beam",
           "inject_gaussian_beam_host", "columns_to_state", "profile_values",
           "attribute_values", "xyz_of"]

_AXES3 = {1: (2,), 2: (0, 2), 3: (0, 1, 2)}
_NAMES = {1: ("z",), 2: ("x", "z"), 3: ("x", "y", "z")}
PARSED_PROFILES = ("parse", "parse_density_function")


def profile_values(expr: str, sp: SpeciesConfig, pos, ndim: int):
    """The deck expression ``expr`` of (x, y, z) with the species' constants
    at the (n, ndim) positions ``pos`` (a tensor, or a numpy array whose
    result comes back as one); the inactive axes are 0."""
    fn = compile_expression(expr, ["x", "y", "z"], dict(sp.user_constants))
    cols = xyz_of([pos[:, d] for d in range(ndim)], ndim)
    if isinstance(pos, np.ndarray):
        return fn(*(np.ascontiguousarray(c) for c in cols)).numpy()
    return fn(*cols)


def xyz_of(cols, ndim: int):
    """The (x, y, z) columns of the active-axis columns ``cols``; an
    inactive axis is 0."""
    if ndim == 3:
        return list(cols)
    zero = cols[0] * 0
    if ndim == 2:
        return [cols[0], zero, cols[1]]
    return [zero, zero, cols[0]]


def attribute_values(sp: SpeciesConfig, xyz, ux, uy, uz, t, dtype) -> dict:
    """The species' runtime attributes at injection (the JAX package's
    ``inject_species``, warpx_tpu/core/injection.py:366-377): each
    expression of (x, y, z, ux, uy, uz, t) at the particles, a real one in
    ``dtype``, an integer one rounded (half to even) to int32.  Numpy
    columns give numpy values, tensors give tensors on their device."""
    out = {}
    for aname, expr, is_int in sp.attributes:
        fn = compile_expression(expr, ["x", "y", "z", "ux", "uy", "uz", "t"],
                                dict(sp.user_constants))
        val = fn(*xyz, ux, uy, uz, t)
        if isinstance(xyz[2], np.ndarray):
            val = np.broadcast_to(val.numpy(), xyz[2].shape)
            out[aname] = (np.round(val).astype(np.int32) if is_int
                          else val.astype(dtype))
        else:
            out[aname] = (torch.round(val).to(torch.int32) if is_int
                          else val.to(dtype))
    return out


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def columns_to_state(cols: dict, device, capacity: int | None = None,
                     fills: dict | None = None) -> ParticleState:
    """A ``ParticleState`` on ``device`` from numpy columns keyed by its
    field names (the runtime attributes as a dict under ``"extra"``).  With
    ``capacity``, columns shorter than it are padded on ``device`` with
    their ``fills`` value (default 0, False), so that only the rows given
    cross from the host."""
    fills = fills or {}

    def dev(k, v):
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        if capacity is None or t.shape[0] == capacity:
            return t
        out = torch.full((capacity,), fills.get(k, 0), dtype=t.dtype,
                         device=device)
        out[:t.shape[0]] = t
        return out

    return ParticleState(
        **{k: dev(k, v) for k, v in cols.items() if k != "extra"},
        extra={k: dev(k, v) for k, v in cols.get("extra", {}).items()})


def position_fills(geom: Geometry) -> dict:
    """The value of each position column in a dead slot: the domain's
    center (the other columns hold 0 there)."""
    return {nm: 0.5 * (geom.prob_lo[d] + geom.prob_hi[d])
            for d, nm in enumerate(_NAMES[geom.ndim])}


def _pad_columns(cols: dict, count: int, cap: int, geom: Geometry) -> dict:
    """Columns of ``cap`` slots holding the first ``count`` rows of
    ``cols`` (alive first), the rest dead at ``position_fills``."""
    fills = position_fills(geom)
    out = {}
    for k, a in cols.items():
        if k == "alive":
            out[k] = np.zeros(cap, dtype=bool)
            out[k][:count] = True
            continue
        if a.shape[0] == cap == count:
            out[k] = a
            continue
        out[k] = np.full(cap, fills.get(k, 0.0), dtype=a.dtype)
        out[k][:count] = a[:count]
    return out


def _bulk_momentum(sp: SpeciesConfig) -> np.ndarray:
    """Bulk momentum (units of c) of the distribution: the speed the
    continuous-injection front rides at and the boosted frame's ballistic
    correction (PhysicalParticleContainer.cpp:137-147)."""
    if sp.momentum_distribution in ("constant", "gaussian"):
        return np.array([sp.ux, sp.uy, sp.uz], float)
    if sp.momentum_distribution in ("maxwell_boltzmann", "maxwell_juttner"):
        b = sp.beta_bulk * (-1.0 if sp.bulk_vel_dir.startswith("-") else 1.0)
        u = np.zeros(3)
        if abs(b) < 1.0 and b != 0.0:
            u[_bulk_axis(sp)] = b / np.sqrt(1.0 - b * b)
        return u
    return np.zeros(3)


def _bulk_axis(sp: SpeciesConfig) -> int:
    return {"x": 0, "y": 1, "z": 2}.get(sp.bulk_vel_dir.strip("+-") or "x", 0)


_MOMENTA = ("at_rest", "none", "constant", "gaussian", "maxwell_boltzmann",
            "maxwell_juttner", "uniform", "parse_momentum_function",
            "gaussian_parse_momentum_function")
# the styles whose container the caller sizes and fills (the JAX package's
# empty container: antennas, beams and plane emission come from their own
# injectors)
_EMPTY_STYLES = ("none", "laser", "gaussian_beam", "nfluxpercell")


def _listed_particles(sp: SpeciesConfig, ndim: int, np_dtype,
                      capacity: int | None) -> dict:
    """The ``singleparticle`` and ``multipleparticles`` styles (the
    reference's SingleParticle and AddNParticles paths): the deck's
    positions, momenta (units of c) and weights, alive first.  As in the
    JAX package, one particle's u times c is rounded once, a list's
    columns are rounded to the type before the product."""
    if sp.injection_style == "singleparticle":
        cols7 = [np.asarray([v], dtype=np_dtype) for v in (
            *sp.single_particle_pos,
            *(u * constants.c for u in sp.single_particle_u),
            sp.single_particle_weight)]
    else:
        cols7 = [np.asarray(col, dtype=np_dtype)
                 for col in sp.multiple_particles]
        cols7[3:6] = [u * constants.c for u in cols7[3:6]]
    n = cols7[6].shape[0]
    cap = capacity or n

    def fill(col):
        out = np.zeros(cap, dtype=np_dtype)
        out[:n] = col
        return out

    cols = dict(w=fill(cols7[6]), ux=fill(cols7[3]), uy=fill(cols7[4]),
                uz=fill(cols7[5]), alive=np.arange(cap) < n)
    for nm, a in zip(_NAMES[ndim], _AXES3[ndim]):
        cols[nm] = fill(cols7[a])
    return cols


def _file_particles(sp: SpeciesConfig, ndim: int, np_dtype,
                    capacity: int | None) -> dict:
    """The ``external_file`` style (AddPlasmaFromFile,
    PhysicalParticleContainer.cpp:680-800): positions are position +
    positionOffset (+ z_shift on z), u = momentum / mass (m/s), weights
    from the file; particles outside the species bounds are dead slots
    with zero weight, in the file's order."""
    from ..io.openpmd import read_openpmd_particles

    data = read_openpmd_particles(sp.injection_file)
    pos_all = (data["x"].astype(np_dtype), data["y"].astype(np_dtype),
               (data["z"] + sp.z_shift).astype(np_dtype))
    n = pos_all[0].shape[0]
    keep = np.ones(n, bool)
    if sp.bounds_lo:
        for d, a in enumerate(_AXES3[ndim]):
            keep &= ((pos_all[a] >= sp.bounds_lo[d])
                     & (pos_all[a] <= sp.bounds_hi[d]))
    cap = capacity or n

    def fill(col, masked=True):
        out = np.zeros(cap, dtype=np_dtype)
        out[:n] = np.where(keep, col, 0.0) if masked else col
        return out

    inv_m = 1.0 / sp.mass
    alive = np.zeros(cap, bool)
    alive[:n] = keep
    cols = dict(
        w=fill(data["w"].astype(np_dtype)),
        ux=fill((data["px"] * inv_m).astype(np_dtype), masked=False),
        uy=fill((data["py"] * inv_m).astype(np_dtype), masked=False),
        uz=fill((data["pz"] * inv_m).astype(np_dtype), masked=False),
        alive=alive)
    for nm, a in zip(_NAMES[ndim], _AXES3[ndim]):
        cols[nm] = fill(pos_all[a], masked=False)
    return cols


def _sample_boltzmann(rng, n, theta, beta, bdir, np_dtype):
    """Maxwell-Boltzmann momenta (units of c) with a drift
    (InjectorMomentum.H:202-245): u ~ N(0, sqrt(theta)) a component,
    Zenitani's flip, the boost along ``bdir``; ``theta`` and ``beta`` are
    scalars or per-particle arrays."""
    theta = np.broadcast_to(np.asarray(theta, np.float64), (n,))
    beta = np.broadcast_to(np.asarray(beta, np.float64), (n,))
    u = rng.standard_normal((3, n)) * np.sqrt(theta)
    gamma = np.sqrt(1.0 + (u * u).sum(axis=0))
    if np.any(beta != 0.0):
        flip = -beta * u[bdir] / gamma > rng.random(n)
        u[bdir] = np.where(flip, -u[bdir], u[bdir])
        u[bdir] = (u[bdir] + gamma * beta) / np.sqrt(1.0 - beta * beta)
    return u.astype(np_dtype)


def _sample_juttner(rng, n, theta, beta, bdir, np_dtype):
    """Maxwell-Juttner momenta (units of c) by Sobol's rejection with
    Zenitani's flip (InjectorMomentum.H:296-360); per-particle theta and
    beta allowed.  Its acceptance vanishes like exp(-1/theta), so below
    theta = 0.1 it raises, as the reference aborts
    (InjectorMomentum.H:313)."""
    theta = np.broadcast_to(np.asarray(theta, np.float64), (n,))
    beta = np.broadcast_to(np.asarray(beta, np.float64), (n,))
    if n and float(theta.min()) < 0.1:
        raise ValueError(
            "Temperature parameter theta is less than minimum 0.1 allowed "
            "for Maxwell-Juttner (Sobol sampling; InjectorMomentum.H:313)")
    um = np.zeros(n)
    todo = np.ones(n, bool)
    while todo.any():
        idx = np.nonzero(todo)[0]
        m = idx.size
        th = theta[idx]
        cand = -th * np.log(rng.random(m) * rng.random(m) * rng.random(m))
        gam = np.sqrt(1.0 + cand * cand)
        acc = cand - gam > th * np.log(rng.random(m))
        um[idx[acc]] = cand[acc]
        todo[idx[acc]] = False
    x1 = rng.random(n)
    x2 = rng.random(n)
    u = np.zeros((3, n))
    s_perp = 2.0 * um * np.sqrt(x1 * (1.0 - x1))
    u[(bdir + 1) % 3] = s_perp * np.sin(2.0 * np.pi * x2)
    u[(bdir + 2) % 3] = s_perp * np.cos(2.0 * np.pi * x2)
    u[bdir] = um * (2.0 * x1 - 1.0)
    gamma = np.sqrt(1.0 + (u * u).sum(axis=0))
    if np.any(beta != 0.0):
        flip = -beta * u[bdir] / gamma > rng.random(n)
        u[bdir] = np.where(flip, -u[bdir], u[bdir])
        u[bdir] = (u[bdir] + gamma * beta) / np.sqrt(1.0 - beta * beta)
    return u.astype(np_dtype)


def _momenta(sp: SpeciesConfig, rng, n: int, lab, ndim: int, np_dtype):
    """(ux, uy, uz) in units of c of ``n`` particles at the lab positions
    ``lab``, in the JAX package's draw order."""
    dist = sp.momentum_distribution
    if dist in ("at_rest", "none"):
        return tuple(np.zeros(n, dtype=np_dtype) for _ in range(3))
    if dist == "constant":
        return tuple(np.full(n, v, dtype=np_dtype)
                     for v in (sp.ux, sp.uy, sp.uz))
    if dist == "gaussian":
        return tuple(rng.normal(m, th or 0.0, n).astype(np_dtype)
                     for m, th in ((sp.ux, sp.ux_th), (sp.uy, sp.uy_th),
                                   (sp.uz, sp.uz_th)))
    if dist in ("maxwell_boltzmann", "maxwell_juttner"):
        sampler = (_sample_boltzmann if dist == "maxwell_boltzmann"
                   else _sample_juttner)
        sign = -1.0 if sp.bulk_vel_dir.startswith("-") else 1.0
        theta = sp.theta
        if sp.theta_expr:
            theta = profile_values(sp.theta_expr, sp, lab, ndim).astype(
                np.float64)
        beta = sp.beta_bulk * sign
        if sp.beta_expr:
            beta = sign * profile_values(sp.beta_expr, sp, lab,
                                         ndim).astype(np.float64)
        return tuple(sampler(rng, n, theta, beta, _bulk_axis(sp), np_dtype))
    if dist == "uniform":
        # a cuboid in u-space (InjectorMomentumUniform)
        return tuple(rng.uniform(lo, hi, n).astype(np_dtype)
                     for lo, hi in zip(sp.u_min, sp.u_max))
    if dist == "gaussian_parse_momentum_function":
        cols = []
        for me, te in zip(sp.momentum_exprs, sp.momentum_th_exprs):
            mu = profile_values(me, sp, lab, ndim).astype(np.float64)
            th = profile_values(te, sp, lab, ndim).astype(np.float64)
            cols.append((np.broadcast_to(mu, (n,)) + np.broadcast_to(th, (n,))
                         * rng.standard_normal(n)).astype(np_dtype))
        return tuple(cols)
    # parse_momentum_function
    return tuple(profile_values(e, sp, lab, ndim).astype(np_dtype)
                 for e in sp.momentum_exprs)


def _regular_unit_positions(ppc: Tuple[int, ...], ndim: int) -> np.ndarray:
    """Unit-cell offsets for NUniformPerCell, ordered like the reference
    (InjectorPosition.H:100-107: i_part decomposes as x-major, then z, then y)."""
    ppc = tuple(ppc)[:ndim]
    if ndim == 3:
        nx, ny, nz = ppc
    elif ndim == 2:
        nx, nz = ppc
        ny = 1
    else:
        (nz,) = ppc
        nx = ny = 1
    n_tot = nx * ny * nz
    out = np.zeros((n_tot, 3))
    for i_part in range(n_tot):
        ix = i_part // (ny * nz)
        iz = (i_part - ix * (ny * nz)) // ny
        iy = (i_part - ix * (ny * nz)) - ny * iz
        out[i_part] = [(0.5 + ix) / nx, (0.5 + iy) / ny, (0.5 + iz) / nz]
    return out


def inject_species_host(
    sp: SpeciesConfig,
    geom: Geometry,
    rng: np.random.Generator,
    np_dtype,
    capacity: int | None = None,
    gamma_boost: float = 1.0,
    refine_spec=None,
) -> dict:
    """Inject one species on the host; alive particles first, dead slots (up
    to ``capacity``) parked at the domain center with zero weight.  With
    ``gamma_boost`` > 1 the profiles and bounds are evaluated at the lab
    position of each boosted-frame particle at t_lab = 0, and the weights
    and uz are boosted (AddPlasma:1243-1246).  ``refine_spec`` = (i0, i1,
    ratio, window axis) is ``warpx.refine_plasma``: the cells whose coarse
    index across the window axis lies in [i0, i1) of the refined box
    inject on the fine lattice instead, ratio-times more streams an axis at
    1/prod(ratio) the weight (findRefinedInjectionBox,
    PhysicalParticleContainer.cpp:3260; the JAX package's
    ``inject_species``), after all the coarse candidates."""
    ndim = geom.ndim
    names = _NAMES[ndim]
    if sp.injection_style in _EMPTY_STYLES:
        # an empty container of ``capacity`` slots (the products of
        # ionization and QED, and plane emission, land there), positions
        # at 0 as in the JAX package
        cap = capacity or 0
        cols = {k: np.zeros(cap, np_dtype)
                for k in ("w", "ux", "uy", "uz") + names}
        cols["alive"] = np.zeros(cap, dtype=bool)
        return cols
    if sp.injection_style in ("singleparticle", "multipleparticles"):
        return _listed_particles(sp, ndim, np_dtype, capacity)
    if sp.injection_style == "external_file":
        return _file_particles(sp, ndim, np_dtype, capacity)
    if sp.injection_style not in ("nuniformpercell", "nrandompercell"):
        raise ValueError(f"{sp.name}: unknown injection style "
                         f"{sp.injection_style!r}")
    if sp.profile != "constant" and sp.profile not in PARSED_PROFILES:
        # the JAX package refuses it too (its deck reader turns the one
        # predefined profile it knows, parabolic_channel, into a parsed one)
        raise NotImplementedError(
            f"density profile {sp.profile!r} (the JAX package refuses it "
            "too; ROADMAP.md Queue C)")
    if sp.profile in PARSED_PROFILES and not sp.density_expr:
        raise ValueError(f"{sp.name}: profile {sp.profile!r} without a "
                         "density_function")
    if sp.momentum_distribution not in _MOMENTA:
        raise NotImplementedError(
            f"momentum distribution {sp.momentum_distribution!r} (the JAX "
            "package refuses it too; ROADMAP.md Queue C)")

    # --- per-cell offsets (unit box, full xyz triple)
    if sp.injection_style == "nuniformpercell":
        unit = _regular_unit_positions(sp.num_particles_per_cell_each_dim, ndim)
    else:
        unit = rng.random((sp.num_particles_per_cell, 3))

    if sp.profile == "constant" and not _momenta_use_positions(sp):
        cols = _constant_density_rows(sp, geom, unit, rng, np_dtype,
                                      gamma_boost, refine_spec)
    else:
        cols = _rows(sp, geom, unit, rng, np_dtype, gamma_boost,
                     refine_spec)
    count = cols["w"].shape[0]
    if gamma_boost > 1.0:
        # to the boosted frame (AddPlasma:1243-1246):
        # w *= gamma (1 - beta betaz_lab); uz' = gamma (uz - beta gamma_lab)
        beta_boost = float(np.sqrt(1.0 - 1.0 / gamma_boost**2))
        ux, uy, uz, w = (cols[k] for k in ("ux", "uy", "uz", "w"))
        gamma_lab = np.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
        betaz_lab = uz / gamma_lab
        cols["w"] = (w * gamma_boost
                     * (1.0 - beta_boost * betaz_lab)).astype(np_dtype)
        cols["uz"] = gamma_boost * (uz - beta_boost * gamma_lab)
    for k in ("ux", "uy", "uz"):
        cols[k] = (cols[k] * constants.c).astype(np_dtype)
    extra = {}
    if sp.attributes:
        # at the lab position (the boosted z ballistically corrected to
        # t_lab = 0) and the boosted momenta, at t = 0
        lab = [cols[nm] for nm in names]
        if gamma_boost > 1.0:
            lab[-1] = _boost_ballistic(lab[-1], sp, gamma_boost)
        extra = attribute_values(sp, xyz_of(lab, ndim), cols["ux"],
                                 cols["uy"], cols["uz"], 0.0, np_dtype)

    # --- alive first, padded to capacity
    if capacity is None and sp.capacity_factor > 1.0:
        capacity = int(np.ceil(count * sp.capacity_factor))
    cap = capacity or count
    if cap < count:
        raise ValueError(f"capacity {cap} < injected count {count}")
    cols = dict(w=cols["w"], ux=cols["ux"], uy=cols["uy"], uz=cols["uz"],
                alive=None, **{nm: cols[nm] for nm in names})
    out = _pad_columns(cols, count, cap, geom)
    if extra:
        out["extra"] = _pad_columns(extra, count, cap, geom)
    return out


def _momenta_use_positions(sp: SpeciesConfig) -> bool:
    return (sp.momentum_distribution in ("gaussian_parse_momentum_function",
                                         "parse_momentum_function")
            or bool(sp.theta_expr) or bool(sp.beta_expr))


def _boost_ballistic(z, sp: SpeciesConfig, gamma_boost: float):
    """The lab z at t_lab = 0 of boosted-frame coordinates ``z`` (the
    ballistic correction, PhysicalParticleContainer.cpp
    applyBallisticCorrection at t = 0), in ``z``'s type."""
    beta_boost = float(np.sqrt(1.0 - 1.0 / gamma_boost**2))
    ub = _bulk_momentum(sp)
    betaz_bulk = ub[2] / np.sqrt(1.0 + ub @ ub)
    lab = np.empty_like(z)
    lab[...] = gamma_boost * z * (1.0 - beta_boost * betaz_bulk)
    return lab


def _in_footprint(p, d, geom, refine_spec):
    """Where coordinates ``p`` along axis ``d`` fall in a coarse cell of
    the refined box's footprint (every cell along the window axis)."""
    i0, i1, _rv, wdir = refine_spec
    if d == wdir:
        return np.ones(p.shape, bool)
    ci = np.floor((p - geom.prob_lo[d]) / geom.dx[d]).astype(np.int64)
    return (ci >= i0[d]) & (ci < i1[d])


def _rows(sp, geom, unit, rng, np_dtype, gamma_boost,
          refine_spec=None) -> dict:
    """The kept rows (positions by name, w, and ux, uy, uz in units of c)
    of every cell's ``unit`` offsets: the profiles and bounds at the lab
    position of each particle at t_lab = 0 (AddPlasma:1021), the momenta
    drawn for every candidate in the JAX package's order; under
    ``refine_spec`` the fine lattice's candidates follow the coarse ones."""
    ndim = geom.ndim
    ppc_tot = unit.shape[0]
    mesh_axes = [
        geom.prob_lo[d] + np.arange(geom.n_cell[d]) * geom.dx[d]
        for d in range(ndim)
    ]
    cell_lo = np.meshgrid(*mesh_axes, indexing="ij")
    cell_lo = np.stack([m.reshape(-1) for m in cell_lo], axis=-1)
    unit_active = unit[:, list(_AXES3[ndim])]
    dx = np.array(geom.dx)
    pos = cell_lo[:, None, :] + unit_active[None, :, :] * dx[None, None, :]
    pos = pos.reshape(-1, ndim).astype(np_dtype)
    scale_vec = np.full(pos.shape[0], geom.cell_volume / ppc_tot, np_dtype)
    if refine_spec is not None:
        rv = refine_spec[2]
        R = int(np.prod(rv))
        dxf = dx / np.asarray(rv)
        subs = np.meshgrid(*[np.arange(rv[d]) * dxf[d] for d in range(ndim)],
                           indexing="ij")
        sub = np.stack([s_.reshape(-1) for s_ in subs], axis=-1)
        pos_f = (cell_lo[:, None, None, :] + sub[None, :, None, :]
                 + unit_active[None, None, :, :] * dxf[None, None, None, :]
                 ).reshape(-1, ndim).astype(np_dtype)

        def in_fp(p):
            m = np.ones(p.shape[0], bool)
            for d in range(ndim):
                m &= _in_footprint(p[:, d], d, geom, refine_spec)
            return m

        scale_vec = np.concatenate([
            np.where(in_fp(pos), 0.0, scale_vec),
            np.where(in_fp(pos_f), geom.cell_volume / (R * ppc_tot),
                     0.0).astype(np_dtype)])
        pos = np.concatenate([pos, pos_f], axis=0)

    lab = pos
    if gamma_boost > 1.0:
        lab = pos.copy()
        lab[:, -1] = _boost_ballistic(pos[:, -1], sp, gamma_boost)

    # --- injection bounds (PhysicalParticleContainer xmin..zmax)
    mask = np.ones(pos.shape[0], dtype=bool)
    if sp.bounds_lo:
        for d in range(ndim):
            coord = lab[:, d]
            mask &= (coord >= sp.bounds_lo[d]) & (coord <= sp.bounds_hi[d])

    # --- density -> weight
    if sp.profile == "constant":
        dens = np.full(pos.shape[0], sp.density, dtype=np_dtype)
    else:
        dens = profile_values(sp.density_expr, sp, lab, ndim).astype(np_dtype)
    w = np.where(mask, dens * scale_vec, 0.0).astype(np_dtype)
    mask &= w > 0

    u = _momenta(sp, rng, pos.shape[0], lab, ndim, np_dtype)
    keep = np.nonzero(mask)[0]
    cols = {nm: pos[keep, d] for d, nm in enumerate(_NAMES[ndim])}
    cols.update(w=w[keep], ux=u[0][keep], uy=u[1][keep], uz=u[2][keep])
    return cols


def _constant_density_rows(sp, geom, unit, rng, np_dtype,
                           gamma_boost, refine_spec=None) -> dict:
    """``_rows`` of a constant density whose momenta do not depend on the
    position, computed at the kept rows only: a coordinate, and the bound
    on it, depend on one axis's cell index and the offset alone, so each
    axis is an (n_cell, offsets) table, the same numbers ``_rows`` makes,
    and every candidate shares one weight.  Under ``refine_spec`` the fine
    lattice's axis tables are (n_cell, ratio, offsets), their candidates
    following the coarse ones, each lattice's weight zero outside its
    part of the footprint."""
    ndim = geom.ndim
    ppc_tot = unit.shape[0]
    unit_active = unit[:, list(_AXES3[ndim])]
    lattices = [(
        [((geom.prob_lo[d] + np.arange(geom.n_cell[d]) * geom.dx[d])
          [:, None] + unit_active[None, :, d] * geom.dx[d]).astype(np_dtype)
         for d in range(ndim)],
        (*geom.n_cell[:ndim], ppc_tot), geom.cell_volume / ppc_tot)]
    if refine_spec is not None:
        i0, i1, rv, wdir = refine_spec
        dxf = np.array(geom.dx) / np.asarray(rv)
        # the fine lattice keeps nothing outside the footprint: with no
        # momenta drawn per candidate its cells across the window axis can
        # stop one cell beyond the footprint, which keeps the kept rows and
        # their order
        drawn = sp.momentum_distribution not in ("at_rest", "none",
                                                 "constant")
        cells = [np.arange(geom.n_cell[d]) if d == wdir or drawn
                 else np.arange(max(i0[d] - 1, 0),
                                min(i1[d] + 1, geom.n_cell[d]))
                 for d in range(ndim)]
        lattices.append((
            [((geom.prob_lo[d] + cells[d] * geom.dx[d])[:, None, None]
              + (np.arange(rv[d]) * dxf[d])[None, :, None]
              + (unit_active[:, d] * dxf[d])[None, None, :]).astype(np_dtype)
             for d in range(ndim)],
            (*[c.shape[0] for c in cells], *rv[:ndim], ppc_tot),
            geom.cell_volume / (int(np.prod(rv)) * ppc_tot)))
    cols = {nm: [] for nm in _NAMES[ndim] + ("w",)}
    masks = []
    for k, (table, shape, scale) in enumerate(lattices):
        lab = list(table)
        if gamma_boost > 1.0:
            lab[-1] = _boost_ballistic(table[-1], sp, gamma_boost)

        def spread(t, d, shape=shape):
            """An axis table broadcast over the lattice's candidates."""
            idx = [None] * (len(shape) - 1) + [slice(None)]
            idx[d] = slice(None)
            if t.ndim == 3:
                idx[ndim + d] = slice(None)
            return np.broadcast_to(t[tuple(idx)], shape)

        mask = np.ones(shape, dtype=bool)
        if sp.bounds_lo:
            for d in range(ndim):
                mask &= spread((lab[d] >= sp.bounds_lo[d])
                               & (lab[d] <= sp.bounds_hi[d]), d)
        if refine_spec is not None:
            inside = np.ones(shape, dtype=bool)
            for d in range(ndim):
                inside &= spread(_in_footprint(table[d], d, geom,
                                               refine_spec), d)
            # the coarse lattice stands outside the footprint, the fine one
            # inside
            mask &= inside if k else ~inside
        w = (np.full(1, sp.density, dtype=np_dtype)
             * np.full(1, scale, np_dtype))
        w = np.where(True, w, 0.0).astype(np_dtype)
        if not w[0] > 0:
            mask[...] = False
        for d, nm in enumerate(_NAMES[ndim]):
            cols[nm].append(spread(table[d], d)[mask])
        cols["w"].append(np.full(int(np.count_nonzero(mask)), w[0],
                                 dtype=np_dtype))
        masks.append(mask.reshape(-1))
    cols = {k: np.concatenate(v) for k, v in cols.items()}
    count = cols["w"].shape[0]
    dist = sp.momentum_distribution
    if dist in ("at_rest", "none"):
        u = tuple(np.zeros(count, dtype=np_dtype) for _ in range(3))
    elif dist == "constant":
        u = tuple(np.full(count, v, dtype=np_dtype)
                  for v in (sp.ux, sp.uy, sp.uz))
    else:
        flat = np.concatenate(masks)
        u = tuple(a[flat] for a in _momenta(sp, rng, flat.size, None, ndim,
                                              np_dtype))
    cols.update(ux=u[0], uy=u[1], uz=u[2])
    return cols


def inject_species(
    sp: SpeciesConfig,
    geom: Geometry,
    rng: np.random.Generator,
    *,
    dtype: torch.dtype,
    device: torch.device | str,
    capacity: int | None = None,
    gamma_boost: float = 1.0,
) -> ParticleState:
    """``inject_species_host`` moved to ``device``."""
    return columns_to_state(
        inject_species_host(sp, geom, rng, _np_dtype(dtype), capacity,
                            gamma_boost),
        device)


def inject_gaussian_beam_host(sp: SpeciesConfig, geom: Geometry,
                              rng: np.random.Generator, np_dtype,
                              gamma_boost: float = 1.0) -> dict:
    """Gaussian beam injection (PhysicalParticleContainer::AddGaussianBeam,
    PhysicalParticleContainer.cpp:503-680): ``npart`` particles normally
    distributed around (x_m, y_m, z_m) with per-axis rms, weight
    q_tot/(q*npart), gaussian or constant momentum; with ``gamma_boost`` > 1
    mapped into the boosted frame at t_lab = 0
    (MapParticletoBoostedFrame, PhysicalParticleContainer.cpp:455-492)."""
    ndim = geom.ndim
    n = sp.npart
    x = rng.normal(sp.x_m, sp.x_rms, n)
    y = rng.normal(sp.y_m, sp.y_rms, n)
    z = rng.normal(sp.z_m, sp.z_rms, n)
    # the inactive transverse coordinates are identically zero in the
    # reference (PhysicalParticleContainer.cpp:543-551)
    if ndim < 3:
        y = np.zeros(n)
    if ndim == 1:
        x = np.zeros(n)
    keep = np.abs(z - sp.z_m) <= sp.z_cut * (sp.z_rms if sp.z_rms else np.inf)
    if sp.momentum_distribution == "gaussian":
        ux = rng.normal(sp.ux, sp.ux_th or 0.0, n)
        uy = rng.normal(sp.uy, sp.uy_th or 0.0, n)
        uz = rng.normal(sp.uz, sp.uz_th or 0.0, n)
    elif sp.momentum_distribution == "constant":
        ux = np.full(n, sp.ux)
        uy = np.full(n, sp.uy)
        uz = np.full(n, sp.uz)
    else:
        ux = uy = uz = np.zeros(n)
    if gamma_boost > 1.0:
        # boosted time of flight t' = -gamma beta z / c back to t' = 0
        beta_boost = np.sqrt(1.0 - 1.0 / gamma_boost**2)
        tpr = -gamma_boost * beta_boost * z / constants.c
        zpr = gamma_boost * z
        gamma_lab = np.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
        uz = gamma_boost * uz - gamma_boost * beta_boost * gamma_lab
        gammapr = np.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
        vzpr = uz / gammapr * constants.c
        if sp.do_backward_propagation:
            # flipped after vzpr: the position map takes the unflipped
            # velocity (PhysicalParticleContainer.cpp:487-498)
            uz = -uz
        z = zpr - tpr * vzpr
    weight = sp.q_tot / (sp.charge * n)
    if ndim == 2:
        # 2D: weight = q_tot/(npart*charge*y_rms)
        # (PhysicalParticleContainer.cpp:543)
        weight /= sp.y_rms
    elif ndim == 1:
        # 1D: / (x_rms y_rms) (PhysicalParticleContainer.cpp:548)
        weight /= (sp.x_rms * sp.y_rms)
    cols = dict(
        w=np.where(keep, weight, 0.0).astype(np_dtype),
        ux=(ux * constants.c).astype(np_dtype),
        uy=(uy * constants.c).astype(np_dtype),
        uz=(uz * constants.c).astype(np_dtype),
        alive=np.asarray(keep),
        **{nm: v.astype(np_dtype) for nm, v in zip("xyz", (x, y, z))
           if nm in _NAMES[ndim]},
    )
    if sp.attributes:
        # at the float64 positions and momenta before the cast
        # (warpx_tpu/core/injection.py:475-490)
        cols["extra"] = attribute_values(
            sp, [x, y, z], ux * constants.c, uy * constants.c,
            uz * constants.c, 0.0, np_dtype)
    return cols


def inject_gaussian_beam(sp: SpeciesConfig, geom: Geometry,
                         rng: np.random.Generator, *, dtype: torch.dtype,
                         device: torch.device | str,
                         gamma_boost: float = 1.0) -> ParticleState:
    """``inject_gaussian_beam_host`` moved to ``device``."""
    return columns_to_state(
        inject_gaussian_beam_host(sp, geom, rng, _np_dtype(dtype),
                                  gamma_boost), device)
