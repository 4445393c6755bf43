"""Binary Coulomb collisions (Perez/Nanbu), cell-paired.

The counterpart of ``warpx_tpu.ops.collisions`` (reference: the relativistic
elastic Coulomb module, Source/Particles/Collision/BinaryCollision/Coulomb/
UpdateMomentumPerezElastic.H and ElasticCollisionPerez.H): particles are
paired at random within cells (a sort by (cell, random key)), each pair
scatters in its center-of-momentum frame by the Nanbu cumulative angle with
s12 from Perez Eq. 9 (the sigma_max cap, Debye or atomic-spacing
screening), and each partner takes its update with the weight-ratio
rejection rule.  Intra-species pairs are consecutive slots of the global
(cell, random) order, a pair straddling two cells sitting out; the
inter-species walk strides the smaller set in "rounds" as the JAX package
does.

Scaled units.  The JAX package forms SI momenta p = m u and squares them;
for an electron at 1e6 m/s p^2 ~ 8e-49, below float32's smallest
subnormal, so in float32 it changes no momentum.  Here the same formulas
run on u / c and on mass ratios: momenta in units of m1 c, energies in
units of m1 c^2, speeds in units of c, and every SI prefactor a host
float64 constant.  In float64 the results equal the JAX package's to
roundoff; in float32 the port collides where float64 does.

The pieces shared with the fusion and DSMC modules live here: the cell of
each slot (``cell_of``), the (cell, random) order (``sort_by_cell``), each
cell's block of it (``cell_blocks``, ``pairs_for``), the pairs
(``pair_arrays``) and the scatter whose duplicate targets keep the last
writer (``last_writers``, ``put_last``).
"""

from __future__ import annotations

import math

import torch

from .. import constants

__all__ = ["intra_species_coulomb", "inter_species_coulomb",
           "perez_update", "cell_of", "sort_by_cell", "cell_blocks",
           "pairs_for", "pair_arrays", "last_writers", "put_last",
           "cell_moments", "tiny"]

_c = constants.c


def tiny(dtype: torch.dtype) -> float:
    """The JAX package's 1e-300 floor in float64, float32's smallest
    normal number in float32 (where 1e-300 is 0)."""
    return 1e-300 if dtype == torch.float64 else torch.finfo(dtype).tiny


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cell_of(sp, geom, n_cells_tot: int) -> torch.Tensor:
    """Flat cell index per slot (C order), clipped into the domain; dead
    slots parked at ``n_cells_tot``.  The divisor is a 0-d tensor, so that
    the card floors the CPU's quotient (a CUDA division by a Python number
    multiplies by its rounded reciprocal)."""
    pos = sp.positions(geom.ndim)
    cell = torch.zeros(sp.capacity, dtype=torch.int64, device=sp.w.device)
    for d in range(geom.ndim):
        dx = torch.tensor(geom.dx[d], dtype=pos[d].dtype,
                          device=pos[d].device)
        idx = torch.floor((pos[d] - geom.prob_lo[d]) / dx).to(torch.int64)
        idx = torch.clamp(idx, 0, geom.n_cell[d] - 1)
        cell = cell * geom.n_cell[d] + idx
    return torch.where(sp.alive, cell, torch.full_like(cell, n_cells_tot))


def sort_by_cell(cell: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``jnp.lexsort((r, cell))``: slots by cell, within
    a cell by the random key ``r``; a stable sort on ``r``, then a stable
    sort on the cell."""
    o1 = torch.argsort(r, stable=True)
    return o1[torch.argsort(cell[o1], stable=True)]


def cell_blocks(cell: torch.Tensor, alive: torch.Tensor, n_cells_tot: int):
    """(start, alive count) of each cell's block in the (cell, random)
    order, with a spare entry for the dead slots.  Counted in int64: a
    float32 prefix sum rounds starts above 2^24 and pairs across cells."""
    counts = torch.zeros(n_cells_tot + 1, dtype=torch.int64,
                         device=cell.device).index_add_(
        0, cell, alive.to(torch.int64))
    return torch.cumsum(counts, 0) - counts, counts


def pairs_for(sp, geom, key):
    """(cell, (cell, random) order, per-cell start and alive count, the
    number of cells) of one species (BinaryCollision.H's pair machinery:
    the ShuffleFisherYates analog by random sort keys)."""
    n_cells_tot = math.prod(geom.n_cell)
    cell = cell_of(sp, geom, n_cells_tot)
    # the JAX package draws the sort keys without a dtype (float64 under
    # x64, float32 otherwise)
    order = sort_by_cell(cell, key.uniform((sp.capacity,), sp.w.dtype))
    starts, counts = cell_blocks(cell, sp.alive, n_cells_tot)
    return cell, order, starts, counts, n_cells_tot


def pair_arrays(sp1, sp2, geom, k_s1, k_s2, intra):
    """The pairs, one per slot of species 1 in its (cell, random) order:
    (origL, origS, multiplier ratio, pair alive).  Intra-species, rank r
    of a cell of N pairs with rank r + ceil(N / 2) for r < N // 2;
    inter-species, each species-1 particle with the species-2 particle of
    in-cell rank r mod N2, several sharing one where N1 > N2."""
    cell1, order1, starts1, counts1, nct = pairs_for(sp1, geom, k_s1)
    if intra:
        order2, starts2, counts2 = order1, starts1, counts1
    else:
        _, order2, starts2, counts2, _ = pairs_for(sp2, geom, k_s2)
    j = torch.arange(sp1.capacity, dtype=torch.int64, device=cell1.device)
    cL = cell1[order1]
    rank = j - starts1[cL]
    if intra:
        N = counts1[cL]
        is_pair = rank < N // 2
        partner_rank = rank + (N + 1) // 2
        mult_ratio = torch.clamp(N - 1, min=1)
    else:
        N2c = counts2[cL]
        is_pair = N2c > 0
        partner_rank = torch.where(N2c > 0, rank % torch.clamp(N2c, min=1),
                                   torch.zeros_like(rank))
        mult_ratio = torch.minimum(torch.clamp(counts1[cL], min=1),
                                   torch.clamp(N2c, min=1))
    slotS = torch.clamp(starts2[cL] + partner_rank, 0, sp2.capacity - 1)
    origS = order2[slotS]
    ok = sp1.alive[order1] & is_pair & (cL < nct) & sp2.alive[origS]
    return order1, origS, mult_ratio, ok


def last_writers(idx: torch.Tensor, n: int) -> torch.Tensor:
    """For writers j = 0.. of targets ``idx`` (in 0..n-1): ``idx[j]`` where
    j is the last (largest) writer of its target, ``n + j`` elsewhere, so
    that every writer has a target of its own.  The JAX package's
    ``.at[idx].set`` keeps the last writer of a shared target on the CPU
    (XLA's scatter applies its updates in order: the inter-species
    partners, ROADMAP.md Queue C); ``index_put_`` on CUDA keeps no order.
    The winners come from a stable sort of the targets, not from atomics:
    the dead slots of a species all name one clipped partner, and millions
    of atomics on one address serialize."""
    m = idx.shape[0]
    order = torch.argsort(idx, stable=True)
    s = idx[order]
    last = torch.ones(m, dtype=torch.bool, device=idx.device)
    last[:-1] = s[1:] != s[:-1]
    win = torch.empty_like(last)
    win[order] = last
    j = torch.arange(m, dtype=idx.dtype, device=idx.device)
    return torch.where(win, idx, n + j)


def put_last(base: torch.Tensor, tgt: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """A copy of ``base`` with ``vals`` written at ``tgt`` (from
    ``last_writers``: distinct targets, the losers' past the end)."""
    n = base.shape[0]
    out = torch.cat([base, base.new_empty(tgt.shape[0])])
    out.index_copy_(0, tgt, vals.to(base.dtype))
    return out[:n]


def cell_moments(sp, m: float, cell, n_cells_tot: int, dV: float):
    """Per cell, with a spare entry for the dead slots: the count, the
    density sum(w) / dV, and the temperature (m / 3) var(u) in units of
    m c^2 (the JAX package's, in Joules, divided by m c^2; reference:
    ComputeTemperature.H), floored at the JAX package's 1e-300 J."""
    dt = sp.w.dtype
    zero = torch.zeros_like(sp.w)
    alive_f = sp.alive.to(dt)
    k = torch.zeros(n_cells_tot + 1, dtype=dt, device=sp.w.device)
    wsum = k.clone().index_add_(0, cell, torch.where(sp.alive, sp.w, zero))
    nsum = k.clone().index_add_(0, cell, alive_f)
    nsafe = torch.clamp(nsum, min=1.0)
    var = k.clone()
    for u in (sp.ux, sp.uy, sp.uz):
        us = u * (1.0 / _c)
        mu = k.clone().index_add_(0, cell, torch.where(sp.alive, us, zero)) \
            / nsafe
        var = var.index_add_(0, cell, torch.where(
            sp.alive, (us - mu[cell]) ** 2, zero))
    floor = 1e-300 / (m * _c * _c) if dt == torch.float64 else tiny(dt)
    T = torch.clamp(var / (3.0 * nsafe), min=floor)
    return nsum, wsum / dV, T


def perez_update(u1, u2, q1: float, m1: float, w1, q2: float, m2: float, w2,
                 n12, sigma_max, L: float, bmax, dt: float, r1, r2, r3, r4,
                 r5):
    """UpdateMomentumPerezElastic over pair arrays.

    ``u1``, ``u2``: (ux, uy, uz) proper velocities in m/s; ``r1..r5``
    uniform draws per pair.  Returns the new (u1, u2), in m/s.  Worked in
    units of c and of m1 (module docstring)."""
    dtype = w1.dtype
    fl = tiny(dtype)
    a = tuple(x * (1.0 / _c) for x in u1)
    b = tuple(x * (1.0 / _c) for x in u2)
    mu = m2 / m1
    gb1sq = _dot(a, a)
    gb2sq = _dot(b, b)
    g1 = torch.sqrt(1.0 + gb1sq)
    g2 = torch.sqrt(1.0 + gb2sq)
    d = tuple(x - y for x, y in zip(a, b))
    diffm = torch.sqrt(_dot(d, d))
    summm = torch.sqrt(gb1sq) + torch.sqrt(gb2sq)
    live = (diffm > 0.0) & (diffm > 1.0e-10 * summm)

    p2 = tuple(mu * x for x in b)
    mass_g = g1 + mu * g2
    vc = tuple((x + y) / mass_g for x, y in zip(a, p2))
    vcms = _dot(vc, vc)
    gc = 1.0 / torch.sqrt(torch.clamp(1.0 - vcms, min=1e-30))
    vcDv1 = _dot(vc, a) / g1
    vcDv2 = _dot(vc, b) / g2
    ltf = (gc * gc * vcDv1 / (1.0 + gc) - gc) * g1
    p1s = tuple(p + v * ltf for p, v in zip(a, vc))
    p1sm = torch.sqrt(_dot(p1s, p1s))
    g1s = (1.0 - vcDv1) * gc * g1
    g2s = (1.0 - vcDv2) * gc * g2

    muRst = g1s * mu * g2s / (g1s + mu * g2s)
    p1sm_safe = torch.where(p1sm > 0, p1sm, torch.ones_like(p1sm))
    vrelst = p1sm_safe / muRst
    denom = 1.0 + p1sm_safe ** 2 / (g1s * mu * g2s)
    vrelst_invar = vrelst / denom

    # b0 = |q1 q2| / (2 pi ep0 muRst vrelst vrelst_invar) in metres
    k_b0 = abs(q1 * q2) / (2.0 * math.pi * constants.ep0 * m1 * _c * _c)
    b0 = k_b0 / (muRst * vrelst * vrelst_invar)
    bmin_qm = (constants.hbar * 0.5 / (m1 * _c)) / p1sm_safe
    bmin = torch.maximum(bmin_qm, 0.5 * b0)
    if L > 0.0:
        lnLmd = torch.full_like(b0, L)
    else:
        lnLmd = torch.clamp(0.5 * torch.log(1.0 + (bmax / bmin) ** 2),
                            min=2.0)
    sigma_eff = torch.minimum(math.pi * b0 ** 2 * lnLmd, sigma_max)
    s12 = torch.where(p1sm > 0.0,
                      sigma_eff * n12 * (dt * _c) * vrelst * g1s * g2s
                      / (g1 * g2), torch.zeros_like(p1sm))
    live = live & (s12 > 0.0)

    # the scattering angle from the Nanbu cumulative distribution: the
    # s <= 0.1 branch with one redraw to dodge cosXs < -1
    r = r1
    cos_a = 1.0 + s12 * torch.log(torch.clamp(r, min=fl))
    cos_a = torch.where(cos_a < -1.0,
                        1.0 + s12 * torch.log(torch.clamp(r2, min=fl)), cos_a)
    cos_a = torch.clamp(cos_a, -1.0, 1.0)
    s = s12
    Ainv = (0.0056958 + 0.9560202 * s - 0.508139 * s ** 2
            + 0.47913906 * s ** 3 - 0.12788975 * s ** 4
            + 0.02389567 * s ** 5)
    inv_A = 1.0 / torch.where(Ainv != 0, Ainv, torch.ones_like(Ainv))
    cos_b = Ainv * torch.log(torch.exp(-inv_A) + 2.0 * r * torch.sinh(inv_A))
    A = 3.0 * torch.exp(-s)
    A_safe = torch.where(A > 0, A, torch.ones_like(A))
    cos_c = (1.0 / A_safe) * torch.log(torch.exp(-A) + 2.0 * r * torch.sinh(A))
    cos_d = 2.0 * r - 1.0
    cosXs = torch.where(s12 <= 0.1, cos_a, torch.where(
        s12 <= 3.0, cos_b, torch.where(s12 <= 6.0, cos_c, cos_d)))
    cosXs = torch.clamp(cosXs, -1.0, 1.0)
    sinXs = torch.sqrt(1.0 - cosXs * cosXs)
    phis = r3 * (2.0 * math.pi)
    cosphis = torch.cos(phis)
    sinphis = torch.sin(phis)

    # the post-collision COM momentum: p1s rotated (Perez Eq. 12, with the
    # x -> y -> z -> x fallback where p1s has no perpendicular part)
    p1sx, p1sy, p1sz = p1s
    one = torch.ones_like(p1sm)
    p1sp = torch.sqrt(p1sx ** 2 + p1sy ** 2)
    use_main = p1sp > 0.0
    p1sp_s = torch.where(use_main, p1sp, one)
    fx = (p1sx * p1sz / p1sp_s) * sinXs * cosphis + (
        p1sy * p1sm / p1sp_s) * sinXs * sinphis + p1sx * cosXs
    fy = (p1sy * p1sz / p1sp_s) * sinXs * cosphis + (
        -p1sx * p1sm / p1sp_s) * sinXs * sinphis + p1sy * cosXs
    fz = (-p1sp_s) * sinXs * cosphis + p1sz * cosXs
    p1sp2 = torch.sqrt(p1sy ** 2 + p1sz ** 2)
    p1sp2_s = torch.where(p1sp2 > 0, p1sp2, one)
    gy = (p1sy * p1sx / p1sp2_s) * sinXs * cosphis + (
        p1sz * p1sm / p1sp2_s) * sinXs * sinphis + p1sy * cosXs
    gz = (p1sz * p1sx / p1sp2_s) * sinXs * cosphis + (
        -p1sy * p1sm / p1sp2_s) * sinXs * sinphis + p1sz * cosXs
    gx = (-p1sp2_s) * sinXs * cosphis + p1sx * cosXs
    p1fs = (torch.where(use_main, fx, gx), torch.where(use_main, fy, gy),
            torch.where(use_main, fz, gz))

    # back to the lab frame
    factor = gc * gc / (gc + 1.0)
    vcDp1fs = _dot(vc, p1fs)
    factor1 = factor * vcDp1fs + g1s * gc
    factor2 = factor * (-vcDp1fs) + mu * g2s * gc

    wmax = torch.maximum(w1, w2)
    take1 = live & (w2 > r4 * wmax)
    take2 = live & (w1 > r5 * wmax)
    u1n = tuple(torch.where(take1, (p + v * factor1) * _c, u)
                for p, v, u in zip(p1fs, vc, u1))
    u2n = tuple(torch.where(take2, (-p + v * factor2) * (_c / mu), u)
                for p, v, u in zip(p1fs, vc, u2))
    return u1n, u2n


def _screening(n, T, q2_over_m):
    """1 / lambda_D^2 terms: n q^2 / (T ep0) with T in units of m c^2."""
    return n * (q2_over_m / (constants.ep0 * _c * _c)) / T


def _bmax_sigma_max(inv_lmd2, maxn, coulomb_log, dtype):
    """bmax = max(lambda_D, rmin) and sigma_max = 1 / (n rmin) with the
    atomic spacing rmin (ElasticCollisionPerez.H:74-90)."""
    fl = tiny(dtype)
    if coulomb_log > 0.0:
        lmdD = torch.ones_like(maxn)
    else:
        lmdD = 1.0 / torch.sqrt(torch.clamp(inv_lmd2, min=fl))
    maxn = torch.clamp(maxn, min=fl)
    rmin = 1.0 / (4.0 * math.pi / 3.0 * maxn) ** (1.0 / 3.0)
    return torch.maximum(lmdD, rmin), 1.0 / (maxn * rmin)


def intra_species_coulomb(sp, q: float, m: float, geom, dt: float, draws,
                          coulomb_log: float = -1.0):
    """One intra-species Coulomb collision step on the numbers of
    ``draws`` (a source split as ``jax.random.split(key, 7)``).  Consecutive
    slots of the (cell, random) order pair; a pair across two cells sits
    out, so a cell with an odd count leaves one particle alone and shifts
    the next cell's pairs (``collisions.py:388-393``)."""
    cap = sp.capacity
    dtype = sp.w.dtype
    n_cells_tot = math.prod(geom.n_cell)
    cell = cell_of(sp, geom, n_cells_tot)
    # the JAX package draws these without a dtype: float64 under x64, as
    # the CPU tests run, float32 otherwise
    _, k_shuf, k1, k2, k3, k4, k5 = draws.split(7)
    order = sort_by_cell(cell, k_shuf.uniform((cap,), dtype))
    cell_s = cell[order]

    nsum, n_dens, T = cell_moments(sp, m, cell, n_cells_tot,
                                   geom.cell_volume)
    npairs = cap // 2
    i1 = order[0:2 * npairs:2]
    i2 = order[1:2 * npairs:2]
    c1 = cell_s[0:2 * npairs:2]
    same_cell = (c1 == cell_s[1:2 * npairs:2]) & (c1 < n_cells_tot)
    c_pair = torch.clamp(c1, max=n_cells_tot)
    n_loc = n_dens[c_pair]
    bmax, sigma_max = _bmax_sigma_max(
        2.0 * _screening(n_loc, T[c_pair], q * q / m),
        n_loc, coulomb_log, dtype)
    w1, w2 = sp.w[i1], sp.w[i2]
    n12 = torch.maximum(w1, w2) * torch.clamp(nsum[c_pair] - 1.0, min=0.0) \
        / geom.cell_volume
    u1 = (sp.ux[i1], sp.uy[i1], sp.uz[i1])
    u2 = (sp.ux[i2], sp.uy[i2], sp.uz[i2])
    r = [k.uniform((npairs,), dtype) for k in (k1, k2, k3, k4, k5)]
    u1n, u2n = perez_update(
        u1, u2, q, m, w1, q, m, w2,
        torch.where(same_cell, n12, torch.zeros_like(n12)), sigma_max,
        coulomb_log, bmax, dt, *r)
    # i1 and i2 are disjoint slots: a plain scatter
    out = []
    for k, comp in enumerate((sp.ux, sp.uy, sp.uz)):
        comp = comp.clone()
        comp.index_copy_(0, i1, torch.where(same_cell, u1n[k], u1[k]))
        comp.index_copy_(0, i2, torch.where(same_cell, u2n[k], u2[k]))
        out.append(comp)
    return sp.replace(ux=out[0], uy=out[1], uz=out[2])


def _pass(momL, momS, spL, spS, qL, mL, qS, mS, orderL, cellL, startL,
          startS, orderS, *, minN, cell_mask, sigma_max_c, bmax_c,
          n_cells_tot, dV, dt, coulomb_log, pkey):
    """Walk species L (the larger set in the masked cells): every alive L
    particle collides with its strided S partner (in-cell rank mod min_N),
    round by round (rank // min_N), each round's partners distinct."""
    capL = spL.capacity
    dtype = spL.w.dtype
    j = torch.arange(capL, dtype=torch.int64, device=spL.w.device)
    origL = orderL
    cL = cellL[orderL]
    rank = j - startL[cL]
    mN = minN[cL]
    active = (cL < n_cells_tot) & spL.alive[orderL] & (mN > 0) \
        & cell_mask[cL]
    mN_s = torch.clamp(mN, min=1)
    partner_slot = torch.clamp(startS[cL] + rank % mN_s, 0,
                               spS.capacity - 1)
    origS = orderS[partner_slot]
    rounds = torch.where(active, rank // mN_s, torch.full_like(rank, -1))
    # the one host read of the pass: the rounds' count is data-dependent
    n_rounds = int(rounds.max()) + 1 if capL else 0

    wL = spL.w[origL]
    wS = spS.w[origS]
    n12 = torch.maximum(wL, wS) * mN.to(dtype) / dV
    sig = sigma_max_c[cL]
    bmx = bmax_c[cL]
    zero = torch.zeros_like(n12)
    momL, momS = list(momL), list(momS)
    # origL is a permutation; origS repeats where an unmasked slot shares a
    # masked one's partner, and the last writer wins
    tgtS = last_writers(origS, spS.capacity) if n_rounds else None
    for r in range(n_rounds):
        mask = active & (rounds == r)
        draws = pkey.fold_in(r).uniform((5, capL), dtype)
        uL = tuple(x[origL] for x in momL)
        uS = tuple(x[origS] for x in momS)
        uLn, uSn = perez_update(uL, uS, qL, mL, wL, qS, mS, wS,
                                torch.where(mask, n12, zero), sig,
                                coulomb_log, bmx, dt, *draws)
        for k in range(3):
            momL[k] = momL[k].index_copy(
                0, origL, torch.where(mask, uLn[k], uL[k]))
            momS[k] = put_last(momS[k], tgtS,
                               torch.where(mask, uSn[k], uS[k]))
    return tuple(momL), tuple(momS)


def inter_species_coulomb(sp1, q1: float, m1: float, sp2, q2: float,
                          m2: float, geom, dt: float, draws,
                          coulomb_log: float = -1.0):
    """One inter-species Coulomb collision step on the numbers of
    ``draws`` (a source split as ``jax.random.split(key, 5)``): pass 1 walks
    species 1 where it is the larger (or equal) set, pass 2 species 2 where
    it is strictly larger, with the combined two-species Debye length
    (ElasticCollisionPerez.H:74-146).  Returns (sp1', sp2')."""
    dV = geom.cell_volume
    dtype = sp1.w.dtype
    _, k_s1, k_s2, k_p1, k_p2 = draws.split(5)
    cell1, order1, start1, N1, n_cells_tot = pairs_for(sp1, geom, k_s1)
    cell2, order2, start2, N2, _ = pairs_for(sp2, geom, k_s2)

    _, n1, T1 = cell_moments(sp1, m1, cell1, n_cells_tot, dV)
    _, n2, T2 = cell_moments(sp2, m2, cell2, n_cells_tot, dV)
    bmax_c, sigma_max_c = _bmax_sigma_max(
        _screening(n1, T1, q1 * q1 / m1)
        + _screening(n2, T2, q2 * q2 / m2),
        torch.maximum(n1, n2), coulomb_log, dtype)
    minN = torch.minimum(N1, N2)
    shared = dict(minN=minN, sigma_max_c=sigma_max_c, bmax_c=bmax_c,
                  n_cells_tot=n_cells_tot, dV=dV, dt=dt,
                  coulomb_log=coulomb_log)
    mom1, mom2 = _pass((sp1.ux, sp1.uy, sp1.uz), (sp2.ux, sp2.uy, sp2.uz),
                       sp1, sp2, q1, m1, q2, m2, order1, cell1, start1,
                       start2, order2, cell_mask=N1 >= N2, pkey=k_p1,
                       **shared)
    mom2, mom1 = _pass(mom2, mom1, sp2, sp1, q2, m2, q1, m1, order2, cell2,
                       start2, start1, order1, cell_mask=N2 > N1, pkey=k_p2,
                       **shared)
    return (sp1.replace(ux=mom1[0], uy=mom1[1], uz=mom1[2]),
            sp2.replace(ux=mom2[0], uy=mom2[1], uz=mom2[2]))
