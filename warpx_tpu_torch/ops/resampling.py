"""Particle resampling: leveling thinning and velocity-coincidence thinning.

The counterpart of ``warpx_tpu.ops.resampling``.

Leveling thinning (Source/Particles/Resampling/LevelingThinning.cpp): per
cell a level weight w_level = t <w> (t = target_ratio, default 1.5);
particles lighter than it survive with probability w / w_level and take
w_level, which conserves the weight in expectation and lowers the count.

Velocity-coincidence thinning (VelocityCoincidenceThinning.cpp): particles
are grouped per (cell, momentum bin); each group of more than two merges
into two particles at its weighted mean position that conserve its weight,
momentum and kinetic energy exactly (the Vranic two-particle solve, with a
random azimuth for the perpendicular part).

Each pass is a deterministic core on given uniform draws (one per slot, the
JAX package's ``(capacity,)`` draw) and a wrapper that draws them from a
``utils.draws`` source with one split, as ``resampling.py:49-50, 159-160``
does.
"""

from __future__ import annotations

import math

import torch

from ..constants import c as _c

__all__ = ["leveling_thinning", "velocity_coincidence_thinning",
           "leveling_core", "velocity_coincidence_core", "momentum_bins"]


def _cell_index(sp, geom):
    """Each slot's cell, flattened in C order; positions outside the
    domain clip into its edge cells."""
    ndim = geom.ndim
    pos = sp.positions(ndim)
    cell = torch.zeros(sp.capacity, dtype=torch.int64, device=sp.w.device)
    for d in range(ndim):
        idx = torch.floor((pos[d] - geom.prob_lo[d]) / geom.dx[d]).to(
            torch.int64)
        idx = torch.clamp(idx, 0, geom.n_cell[d] - 1)
        cell = cell * geom.n_cell[d] + idx
    return cell


def leveling_core(sp, geom, r, target_ratio: float = 1.5):
    """One leveling-thinning pass on the uniform draws ``r`` (one per
    slot)."""
    n_cells = math.prod(geom.n_cell)
    cell = _cell_index(sp, geom)
    zero = torch.zeros_like(sp.w)
    w = torch.where(sp.alive, sp.w, zero)
    wsum = torch.zeros(n_cells, dtype=w.dtype, device=w.device).index_add_(
        0, cell, w)
    count = torch.zeros(n_cells, dtype=w.dtype,
                        device=w.device).index_add_(0, cell,
                                                    sp.alive.to(w.dtype))
    avg_w = wsum / torch.clamp(count, min=1.0)
    w_level = target_ratio * avg_w[cell]
    below = sp.alive & (sp.w < w_level)
    keep = ~below | (r < sp.w / torch.clamp(w_level, min=1e-300))
    new_w = torch.where(below & keep, w_level, sp.w)
    return sp.replace(w=new_w, alive=sp.alive & keep)


def leveling_thinning(sp, geom, draws, target_ratio: float = 1.5):
    """One leveling-thinning pass on the numbers of ``draws``."""
    (sub,) = draws.split(1)
    r = sub.uniform((sp.capacity,), sp.w.dtype)
    return leveling_core(sp, geom, r, target_ratio)


def momentum_bins(sp, *, grid_type="spherical", delta_ur=None, n_theta=1,
                  n_phi=1, delta_u=None):
    """Each slot's momentum bin: spherical bins (|u|/delta_ur,
    (atan2(uy, ux) + pi)/dtheta, acos(uz/|u|)/dphi;
    VelocityCoincidenceThinning.H:130-148) or Cartesian bins from the
    species' momentum extents."""
    ux, uy, uz = sp.ux, sp.uy, sp.uz
    if grid_type == "spherical":
        u_mag = torch.sqrt(ux * ux + uy * uy + uz * uz)
        safe = torch.clamp(u_mag, min=1e-300)
        u_theta = torch.atan2(uy, ux) + math.pi
        u_phi = torch.acos(torch.clamp(uz / safe, -1.0, 1.0))
        dtheta = 2.0 * math.pi / n_theta
        dphi = math.pi / n_phi
        ii = (u_theta / dtheta).to(torch.int64)
        jj = (u_phi / dphi).to(torch.int64)
        kk = (u_mag / delta_ur).to(torch.int64)
        return ii + jj * n_theta + kk * n_theta * n_phi
    dux, duy, duz = delta_u
    ux_min, uy_min, uz_min = (torch.min(a) for a in (ux, uy, uz))
    n1 = torch.clamp(torch.ceil((torch.max(ux) - ux_min) / dux).to(
        torch.int64), min=1)
    n2 = torch.clamp(torch.ceil((torch.max(uy) - uy_min) / duy).to(
        torch.int64), min=1)
    ii = ((ux - ux_min) / dux).to(torch.int64)
    jj = ((uy - uy_min) / duy).to(torch.int64)
    kk = ((uz - uz_min) / duz).to(torch.int64)
    return ii + jj * n1 + kk * n1 * n2


def velocity_coincidence_core(sp, geom, r, *, min_ppc: int = 1, **bins):
    """Merge each (cell, momentum bin) group of more than two particles into
    two, on the uniform draws ``r`` (one per slot; the group of sorted rank
    k takes r[k] pi as its azimuth).  ``bins`` are ``momentum_bins``'s
    keywords.  The species' mass cancels from the solve (the JAX package
    takes it)."""
    c2 = _c * _c
    ndim = geom.ndim
    cap = sp.capacity
    dev = sp.w.device
    n_cells = math.prod(geom.n_cell)
    cell = torch.where(sp.alive, _cell_index(sp, geom),
                       torch.full((cap,), n_cells, dtype=torch.int64,
                                  device=dev))
    vbin = momentum_bins(sp, **bins)

    # lexsort by (cell, vbin): stable sorts, minor key first
    o1 = torch.sort(vbin, stable=True).indices
    o2 = torch.sort(cell[o1], stable=True).indices
    order = o1[o2]
    cell_s = cell[order]
    vbin_s = vbin[order]
    alive_s = sp.alive[order]
    idx_s = torch.arange(cap, device=dev)
    new_run = torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev),
        (cell_s[1:] != cell_s[:-1]) | (vbin_s[1:] != vbin_s[:-1])])
    run_id = torch.cumsum(new_run.to(torch.int64), 0) - 1
    run_start = torch.cummax(torch.where(new_run, idx_s,
                                         torch.zeros_like(idx_s)), 0).values
    rank = idx_s - run_start

    w_s = torch.where(alive_s, sp.w[order], torch.zeros_like(sp.w))
    u_s = [a[order] for a in (sp.ux, sp.uy, sp.uz)]
    pos = sp.positions(ndim)
    pos_s = [p[order] for p in pos]
    gam = torch.sqrt(1.0 + (u_s[0] ** 2 + u_s[1] ** 2 + u_s[2] ** 2) / c2)
    # the kinetic energy in units of m c^2: the JAX package's
    # e (e + 2 m c^2) / (m^2 c^2) divides by m^2 c^2 ~ 7e-44, a float32
    # subnormal whose reciprocal overflows on the card (NaN momenta)
    ke = gam - 1.0

    def rsum(vals):
        return torch.zeros(cap, dtype=vals.dtype, device=dev).index_add_(
            0, run_id, vals)

    tot_w = rsum(w_s)
    tot_n = rsum(alive_s.to(w_s.dtype))
    tot_e = rsum(w_s * ke)
    wdiv = torch.clamp(tot_w, min=1e-300)
    mean_u = [rsum(w_s * u) / wdiv for u in u_s]
    mean_x = [rsum(w_s * p) / wdiv for p in pos_s]

    # per-cell particle counts for the min_ppc gate
    ppc = torch.zeros(n_cells + 1, dtype=w_s.dtype, device=dev).index_add_(
        0, cell, sp.alive.to(w_s.dtype))
    run_cell = torch.full((cap,), n_cells, dtype=torch.int64,
                          device=dev).scatter_(0, run_id, cell_s)
    merge = ((tot_n > 2.0) & (tot_w > 1e-300) & (run_cell < n_cells)
             & (ppc[run_cell] >= min_ppc))

    phi_r = r * math.pi  # per run (indexed by run id)

    # the Vranic two-particle solve on the group means
    # (VelocityCoincidenceThinning.cpp:230-295)
    mux, muy, muz = mean_u
    u_perp2 = mux * mux + muy * muy
    u_perp = torch.sqrt(u_perp2)
    u_mag2 = u_perp2 + muz * muz
    u_mag_c = torch.sqrt(u_mag2)
    e_per_w = tot_e / wdiv
    v_mag2 = e_per_w * (e_per_w + 2.0) * c2
    v_perp = torch.sqrt(torch.clamp(v_mag2 - u_mag2, min=0.0))
    vx = v_perp * torch.cos(phi_r)
    vy = v_perp * torch.sin(phi_r)
    zero = torch.zeros_like(u_mag_c)
    umc = torch.clamp(u_mag_c, min=1e-300)
    upc = torch.clamp(u_perp, min=1e-300)
    cos_t = torch.where(u_mag_c > 0, muz / umc, zero)
    sin_t = torch.where(u_mag_c > 0, u_perp / umc, zero)
    cos_p = torch.where(u_perp > 0, mux / upc, zero)
    sin_p = torch.where(u_perp > 0, muy / upc, zero)
    ux_new = vx * cos_t * cos_p - vy * sin_p + u_mag_c * sin_t * cos_p
    uy_new = vx * cos_t * sin_p + vy * cos_p + u_mag_c * sin_t * sin_p
    uz_new = -vx * sin_t + u_mag_c * cos_t

    m_i = merge[run_id] & alive_s
    is_a = m_i & (rank == 0)
    is_b = m_i & (rank == 1)
    killed = m_i & (rank >= 2)

    def pick(a_val, b_val, cur):
        out = torch.where(is_a, a_val[run_id], cur)
        return torch.where(is_b, b_val[run_id], out)

    half_w = tot_w / 2.0
    w_out = pick(half_w, half_w, sp.w[order])
    ux_out = pick(ux_new, 2.0 * mux - ux_new, u_s[0])
    uy_out = pick(uy_new, 2.0 * muy - uy_new, u_s[1])
    uz_out = pick(uz_new, 2.0 * muz - uz_new, u_s[2])
    pos_out = [pick(mx, mx, p) for mx, p in zip(mean_x, pos_s)]
    alive_out = alive_s & ~killed

    inv = torch.empty_like(order)
    inv[order] = idx_s
    return sp.replace(
        w=w_out[inv], ux=ux_out[inv], uy=uy_out[inv], uz=uz_out[inv],
        alive=alive_out[inv],
    ).with_positions(ndim, [p[inv] for p in pos_out])


def velocity_coincidence_thinning(sp, geom, draws, *, min_ppc: int = 1,
                                  **bins):
    """One velocity-coincidence pass on the numbers of ``draws``."""
    (sub,) = draws.split(1)
    r = sub.uniform((sp.capacity,), sp.w.dtype)
    return velocity_coincidence_core(sp, geom, r, min_ppc=min_ppc, **bins)
