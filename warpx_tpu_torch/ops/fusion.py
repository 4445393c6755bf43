"""Nuclear fusion binary collisions (proton-boron, D-T, D-D, D-He3).

The counterpart of ``warpx_tpu.ops.fusion`` (reference:
Source/Particles/Collision/BinaryCollision/NuclearFusion/):

* the pair fusion probability of Higginson et al., JCP 388, 439 (2019)
  (SingleNuclearFusionEvent.H): the relativistic COM kinetic energy and
  relative velocity (BinaryCollisionUtils.H:50-133), the cross section,
  the fusion multiplier with the probability-threshold reduction;
* the cross sections: the Bosch-Hale 1992 fits for D-T, D-D and D-He3
  (BoschHaleFusionCrossSection.H), Tentori-Belloni 2023 and Buck 1983 for
  p-B11 (ProtonBoronFusionCrossSection.H), as functions of the COM energy
  in keV;
* the products: two-body COM kinematics with isotropic emission
  (TwoProductFusionUtil.H) and the two-step p + B11 -> alpha + Be8* -> 3
  alphas (ProtonBoronFusionInitializeMomentum.H), each product made at both
  parents' positions with half the reaction weight, which the reactants
  lose (ParticleCreationFunc.H:187-191).

The pairing is the JAX package's (``collisions.pair_arrays``): a random
in-cell order; intra-species, rank r pairs with r + ceil(N/2);
inter-species, every species-1 particle with its strided species-2
partner.  Products take the
free slots in the order of the pair arrays, the (cell, random) order.

Scaled units, as in ``ops/collisions.py``: u / c, mass ratios to m1, the
COM kinetic energy from the invariant gamma_rel - 1 = (|u1 - u2|^2 -
(g1 - g2)^2) / (2 c^2) rather than E* - (m1 + m2) c^2, which cancels five
digits (float32 keeps none of them: the JAX package's float32 v_rel is 0
at thermal speeds, so nothing fuses).
"""

from __future__ import annotations

import math

import torch

from .. import constants
from .collisions import pair_arrays, tiny
from .emit import emit_targets, put_rows

__all__ = ["bosch_hale_cross_section", "proton_boron_cross_section",
           "collision_parameters", "two_product_momenta",
           "proton_boron_momenta", "fusion_event_weight",
           "fusion_collision_update", "isotropic", "M_ALPHA"]

_c = constants.c
_c2 = _c * _c
_q_e = constants.q_e
_m_u = 1.66053906660e-27  # unified atomic mass (ablastr constant::SI::m_u)

# fusion type -> E_fusion [J] for the product kinematics (the fusion
# types: protonboron, dt, ddp, ddn, dhe)
_E_FUSION = {
    "dt": 17.5893e6 * _q_e,
    "ddp": 4.032667e6 * _q_e,
    "ddn": 3.268911e6 * _q_e,
}

# Bosch-Hale table IV coefficients (Nucl. Fusion 32, 611 (1992), Eq. 8-9)
_BH = {
    "dt": ((6.927e4, 7.454e8, 2.050e6, 5.2002e4, 0.0),
           (6.38e1, -9.95e-1, 6.981e-5, 1.728e-4)),
    "ddp": ((5.5576e4, 2.1054e2, -3.2638e-2, 1.4987e-6, 1.8181e-10),
            (0.0, 0.0, 0.0, 0.0)),
    "ddn": ((5.3701e4, 3.3027e2, -1.2706e-1, 2.9327e-5, -2.5151e-9),
            (0.0, 0.0, 0.0, 0.0)),
    "dhe": ((5.7501e6, 2.5226e3, 4.5566e1, 0.0, 0.0),
            (-3.1995e-3, -8.5530e-6, 5.9014e-8, 0.0)),
}

# p-B11 channel constants (ProtonBoronFusionInitializeMomentum.H:79-92)
M_ALPHA = _m_u * 4.00260325413
_M_BE = _m_u * (8.0053095729 + 0.00325283863)  # Be8 excited state
_E_FUSION_PB = 5.55610759e6 * _q_e
_E_DECAY_PB = 3.12600414e6 * _q_e


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def bosch_hale_cross_section(E_keV, kind: str, m1: float, m2: float):
    """sigma(E_COM) [m^2] at the COM kinetic energy ``E_keV`` [keV] from
    the Bosch-Hale 1992 astrophysical-factor fits."""
    joule_to_keV = 1e-3 / _q_e
    m_reduced = m1 / (1.0 + m1 / m2)
    alpha_fs = 7.2973525693e-3  # fine-structure constant (PhysConst::alpha)
    B_G = math.pi * alpha_fs * math.sqrt(2.0 * m_reduced * _c2 * joule_to_keV)
    if kind == "dhe":
        B_G = B_G * 2.0  # Z = 2 reactant
    (A1, A2, A3, A4, A5), (B1, B2, B3, B4) = _BH[kind]
    E = E_keV
    S = (A1 + E * (A2 + E * (A3 + E * (A4 + E * A5)))) / (
        1.0 + E * (B1 + E * (B2 + E * (B3 + E * B4))))
    safe = torch.clamp(E, min=tiny(E.dtype))
    sigma = 1e-31 * S / safe * torch.exp(-B_G / torch.sqrt(safe))
    return torch.where(E > 0.0, sigma, torch.zeros_like(sigma))


def proton_boron_cross_section(E_keV):
    """sigma(E_COM) [m^2] at ``E_keV`` [keV]: the Tentori-Belloni 2023 fit
    (with the 148 keV Breit-Wigner resonance) below 9.76 MeV, Buck 1983's
    power law above."""
    E = torch.clamp(E_keV, min=tiny(E_keV.dtype))
    E_MeV = E * 1e-3
    # the Gamow factor in MeV (Z_boron = 5)
    m_boron = 11.00930536 * _m_u
    m_h = 1.00782503223 * _m_u
    m_red = m_boron / (1.0 + m_boron / m_h)
    hbar = 1.054571817e-34
    g = (m_red / 2.0) * (_q_e * _q_e * 5.0 / (2.0 * constants.ep0 * hbar)) ** 2
    gamow_MeV = g * (1e-6 / _q_e)
    # the astrophysical factor [MeV barn] in three fit regions
    sf_low = (197.0 + 0.269 * E + 2.54e-4 * E ** 2
              + 1.82e4 / ((E - 148.0) ** 2 + 2.35 ** 2))
    E_norm = (E - 400.0) * 1e-2
    sf_mid = 346.0 + 150.0 * E_norm - 59.9 * E_norm ** 2 \
        - 0.460 * E_norm ** 5
    sf_high = (1.98e6 / ((E - 640.9) ** 2 + 85.5 ** 2)
               + 3.89e6 / ((E - 1211.0) ** 2 + 414.0 ** 2)
               + 1.36e6 / ((E - 2340.0) ** 2 + 221.0 ** 2)
               + 3.71e6 / ((E - 3294.0) ** 2 + 351.0 ** 2)
               + 0.381)
    sf = torch.where(E < 400.0, sf_low, torch.where(E < 668.0, sf_mid,
                                                     sf_high))
    sigma_tentori = sf / E_MeV * torch.exp(-torch.sqrt(gamow_MeV / E_MeV))
    sigma_buck = 0.01277998 * (E / 9760.0) ** (-2.661840717596765)
    sigma_b = torch.where(E <= 9760.0, sigma_tentori, sigma_buck)
    return torch.where(E_keV > 0.0, sigma_b * 1e-28,
                       torch.zeros_like(sigma_b))


def _gamma_rel_minus_one(a, b, g1, g2):
    """gamma_rel - 1 = g1 g2 - a.b - 1 without its cancellation:
    (|a - b|^2 - (g1 - g2)^2) / 2, with g1 - g2 = (a^2 - b^2) / (g1 + g2)."""
    d = tuple(x - y for x, y in zip(a, b))
    dg = (_dot(a, a) - _dot(b, b)) / (g1 + g2)
    return 0.5 * (_dot(d, d) - dg * dg)


def _com_energy(a, b, mu):
    """(g1, g2, E*, E* - (1 + mu)) in units of m1 c^2 for the proper
    velocities ``a``, ``b`` in units of c and the mass ratio mu = m2 / m1."""
    g1 = torch.sqrt(1.0 + _dot(a, a))
    g2 = torch.sqrt(1.0 + _dot(b, b))
    M = 1.0 + mu
    D = 2.0 * mu * torch.clamp(_gamma_rel_minus_one(a, b, g1, g2), min=0.0)
    E_star = torch.sqrt(M * M + D)
    return g1, g2, E_star, D / (E_star + M)


def collision_parameters(u1, u2, m1: float, m2: float):
    """(E_kin_COM [keV], v_rel_COM [m/s], lab_to_COM factor) for pair
    proper velocities ``u1``, ``u2`` (m/s):
    BinaryCollisionUtils::get_collision_parameters."""
    mu = m2 / m1
    a = tuple(x * (1.0 / _c) for x in u1)
    b = tuple(x * (1.0 / _c) for x in u2)
    g1, g2, E_star, E_kin = _com_energy(a, b, mu)
    M = 1.0 + mu
    # E_ratio^2 - 1 and E_ratio - 1 / E_ratio from E* - M, not from E*
    er2m1 = E_kin * (E_star + M) / (M * M)
    e_inv = er2m1 * M / E_star
    p_star_sq = torch.clamp(mu * er2m1 + (1.0 - mu) ** 2 / 4.0 * e_inv ** 2,
                            min=0.0)
    g1s = torch.sqrt(1.0 + p_star_sq)
    g2s = torch.sqrt(1.0 + p_star_sq / (mu * mu))
    v_rel = torch.sqrt(p_star_sq) * (1.0 / g1s + 1.0 / (mu * g2s)) * _c
    lab_to_com = g1s * g2s / (g1 * g2)
    return E_kin * (m1 * _c2 * 1e-3 / _q_e), v_rel, lab_to_com


def isotropic(key, norm):
    """A random 3-vector of norm ``norm`` (ParticleUtils::RandomizeVelocity)
    on the numbers of ``key`` (split in two, as the JAX package does)."""
    k1, k2 = key.split(2)
    mu = k1.uniform(norm.shape, norm.dtype, -1.0, 1.0)
    phi = k2.uniform(norm.shape, norm.dtype, 0.0, 2.0 * math.pi)
    s = torch.sqrt(torch.clamp(1.0 - mu * mu, min=0.0))
    return norm * s * torch.cos(phi), norm * s * torch.sin(phi), norm * mu


def _boost(p_star3, v3, m_out, g_v):
    """COM (or rest-frame) momentum -> lab momentum, eq. (13) of Perez et
    al. PoP 19, 083104 (TwoProductFusionUtil.H:120-140), in units of c and
    m1; (g - 1) / v^2 is written g^2 / (1 + g), so that v = 0 needs no
    guard."""
    p_sq = _dot(p_star3, p_star3)
    g_star = torch.sqrt(1.0 + p_sq / (m_out * m_out))
    factor = g_v * g_v / (1.0 + g_v) * _dot(v3, p_star3) + m_out * g_star * g_v
    return tuple(p + v * factor for p, v in zip(p_star3, v3))


def _two_product_scaled(key, a, b, mu, o1, o2, q_fus):
    """The two products' momenta (units of m1 c) for the reactants' proper
    velocities ``a``, ``b`` (units of c), the mass ratio mu = m2 / m1, the
    products' mass ratios o1, o2 and the released energy q_fus (units of
    m1 c^2)."""
    g1, g2, E_star, E_kin = _com_energy(a, b, mu)
    p_in = tuple(x + mu * y for x, y in zip(a, b))
    M_out = o1 + o2
    # E*_f = E* - M_in + M_out + Q; E_ratio = E*_f / M_out
    k = (E_kin + q_fus) / M_out
    er2m1 = k * (2.0 + k)
    e_inv = er2m1 / (1.0 + k)
    p_star_sq = torch.clamp(o1 * o2 * er2m1 + (o1 - o2) ** 2 * 0.25
                            * e_inv ** 2, min=0.0)
    p_star3 = isotropic(key, torch.sqrt(p_star_sq))
    mass_g = g1 + mu * g2
    vc = tuple(p / mass_g for p in p_in)
    gc = 1.0 / torch.sqrt(torch.clamp(1.0 - _dot(vc, vc), min=1e-30))
    p1 = _boost(p_star3, vc, o1, gc)
    return p1, tuple(pi - p for pi, p in zip(p_in, p1))


def two_product_momenta(key, u1, m1, u2, m2, m1_out, m2_out, E_fusion):
    """The products' proper velocities (m/s) of a two-product fusion
    (TwoProductFusionComputeProductMomenta)."""
    a = tuple(x * (1.0 / _c) for x in u1)
    b = tuple(x * (1.0 / _c) for x in u2)
    o1, o2 = m1_out / m1, m2_out / m1
    p1, p2 = _two_product_scaled(key, a, b, m2 / m1, o1, o2,
                                 E_fusion / (m1 * _c2))
    return (tuple(p * (_c / o1) for p in p1),
            tuple(p * (_c / o2) for p in p2))


def proton_boron_momenta(key, u1, m1, u2, m2):
    """The three alphas' proper velocities (m/s) of p + B11 -> alpha + Be8*
    -> 3 alpha (two steps, isotropic in each rest frame)."""
    k1, k2 = key.split(2)
    a = tuple(x * (1.0 / _c) for x in u1)
    b = tuple(x * (1.0 / _c) for x in u2)
    oa, ob = M_ALPHA / m1, _M_BE / m1
    pa1, p_be = _two_product_scaled(k1, a, b, m2 / m1, oa, ob,
                                    _E_FUSION_PB / (m1 * _c2))
    # alpha 2: isotropic in the Be rest frame with half the decay energy
    gamma_bestar = 1.0 + 0.5 * _E_DECAY_PB / (M_ALPHA * _c2)
    p_bestar = oa * math.sqrt(gamma_bestar ** 2 - 1.0)
    p_star3 = isotropic(k2, torch.full_like(p_be[0], p_bestar))
    g_be = torch.sqrt(1.0 + _dot(p_be, p_be) / (ob * ob))
    v_be = tuple(p / (ob * g_be) for p in p_be)
    factor = g_be * g_be / (1.0 + g_be) * _dot(v_be, p_star3) \
        + oa * gamma_bestar * g_be
    pa2 = tuple(p + v * factor for p, v in zip(p_star3, v_be))
    pa3 = tuple(pb - p for pb, p in zip(p_be, pa2))
    k = _c / oa
    return tuple(tuple(p * k for p in pa) for pa in (pa1, pa2, pa3))


def fusion_event_weight(key, u1, m1, w1, u2, m2, w2, kind, dt, dV,
                        fusion_multiplier, multiplier_ratio, prob_threshold,
                        prob_target):
    """(fuse mask, reaction weight) per pair (SingleNuclearFusionEvent.H)
    on one uniform draw per pair from ``key``."""
    E_keV, v_rel, lab_to_com = collision_parameters(u1, u2, m1, m2)
    if kind == "protonboron":
        sigma = proton_boron_cross_section(E_keV)
    else:
        sigma = bosch_hale_cross_section(E_keV, kind, m1, m2)
    w_min = torch.minimum(w1, w2)
    w_max = torch.maximum(w1, w2)
    # sigma v_rel first, the host factors in one constant: the product
    # stays in float32's range
    prob_est = (sigma * (v_rel * (fusion_multiplier * dt / dV))
                * (multiplier_ratio * lab_to_com * w_max))
    mult_eff = torch.where(
        prob_est > prob_threshold,
        torch.clamp(fusion_multiplier * prob_target
                    / torch.clamp(prob_est, min=tiny(w1.dtype)), min=1.0),
        torch.full_like(prob_est, fusion_multiplier))
    prob_est = prob_est * (mult_eff / fusion_multiplier)
    prob = -torch.expm1(-prob_est)
    fuse = key.uniform(prob.shape, prob.dtype) < prob
    return fuse, torch.where(fuse, w_min / mult_eff, torch.zeros_like(w_min))


def emit_pair_products(prod, mask, pos_src, u3, w_new, ndim):
    """One product per masked pair into the free slots of ``prod``: the
    k-th masked pair (in pair order) takes the k-th free slot; runtime
    attributes of the new particles are zeroed."""
    tgt, placeable = emit_targets(mask, ~prod.alive)
    pos = [put_rows(p, tgt, v) for p, v in zip(prod.positions(ndim),
                                               pos_src)]
    out = prod.replace(
        w=put_rows(prod.w, tgt, w_new),
        ux=put_rows(prod.ux, tgt, u3[0]),
        uy=put_rows(prod.uy, tgt, u3[1]),
        uz=put_rows(prod.uz, tgt, u3[2]),
        alive=put_rows(prod.alive, tgt, placeable),
        extra={k: put_rows(v, tgt, 0) for k, v in prod.extra.items()},
    )
    return out.with_positions(ndim, pos)


def fusion_collision_update(state, cfg, col, dt: float, draws):
    """One nuclear-fusion collision step for the CollisionConfig ``col`` on
    the numbers of ``draws`` (split as ``jax.random.split(key, 4)``):
    pairs, events, the reaction weight taken from the reactants (a slot
    at zero weight dies), products at both parents' positions with half
    of it each (NuclearFusionFunc.H, ParticleCreationFunc.H).  Intra-
    species, the JAX package keeps only the partner's subtraction: its
    second write of the species replaces the first (ROADMAP.md Queue C)."""
    geom = cfg.geometry
    ndim = geom.ndim
    by_name = {s.name: s for s in cfg.species}
    n1, n2 = col.species
    intra = n1 == n2
    sp1, sp2 = state.species[n1], state.species[n2]
    m1, m2 = by_name[n1].mass, by_name[n2].mass
    k_s1, k_s2, k_ev, k_mom = draws.split(4)
    origL, origS, mult_ratio, ok = pair_arrays(sp1, sp2, geom, k_s1, k_s2,
                                               intra)
    u1 = (sp1.ux[origL], sp1.uy[origL], sp1.uz[origL])
    u2 = (sp2.ux[origS], sp2.uy[origS], sp2.uz[origS])
    w1, w2 = sp1.w[origL], sp2.w[origS]
    fuse, w_r = fusion_event_weight(
        k_ev, u1, m1, w1, u2, m2, w2, col.fusion_kind, dt, geom.cell_volume,
        col.fusion_multiplier, mult_ratio.to(w1.dtype),
        col.fusion_probability_threshold,
        col.fusion_probability_target_value)
    fuse = fuse & ok
    w_r = torch.where(fuse, w_r, torch.zeros_like(w_r))

    new_w1 = sp1.w.index_add(0, origL, -w_r)
    new_w2 = sp2.w.index_add(0, origS, -w_r)
    species = dict(state.species)
    species[n1] = sp1.replace(w=new_w1, alive=sp1.alive & (new_w1 > 0.0))
    species[n2] = sp2.replace(w=new_w2, alive=sp2.alive & (new_w2 > 0.0))

    pos1 = tuple(p[origL] for p in sp1.positions(ndim))
    pos2 = tuple(p[origS] for p in sp2.positions(ndim))
    w_half = 0.5 * w_r
    if col.fusion_kind == "protonboron":
        name = col.product_species[0]
        prod = species[name]
        for u3 in proton_boron_momenta(k_mom, u1, m1, u2, m2):
            for pos in (pos1, pos2):
                prod = emit_pair_products(prod, fuse, pos, u3, w_half, ndim)
        species[name] = prod
    else:
        p1name, p2name = col.product_species
        ups = two_product_momenta(
            k_mom, u1, m1, u2, m2, by_name[p1name].mass,
            by_name[p2name].mass, _E_FUSION[col.fusion_kind])
        for name, u3 in zip((p1name, p2name), ups):
            prod = species[name]
            for pos in (pos1, pos2):
                prod = emit_pair_products(prod, fuse, pos, u3, w_half, ndim)
            species[name] = prod
    return state.replace(species=species)
