"""Hybrid-PIC (kinetic ions, inertialess fluid electrons) Ohm's-law solver.

The counterpart of ``warpx_tpu.solvers.hybrid`` (reference:
HybridPICModel.cpp, HybridPICSolveE.cpp:700-1000,
WarpXPushFieldsHybridPIC.cpp):

  E = [ (J - J_i) x B  -  grad(P_e) ] / rho  +  eta J  -  eta_h lap(J)

with J = curl(B)/mu0 - J_ext (Ampere without displacement current),
P_e = n0 kTe (n/n0)^gamma (adiabatic electrons) and rho floored at
q_e n_floor.  As in the reference, grad(P_e) enters only the end-of-step E
and the resistive terms only the E of the Faraday substeps
(HybridPICSolveE.cpp:890, 898).  B advances through ``substeps`` RK4 steps
per half step with the half-time-centered (rho, J_i) pairs
(WarpXPushFieldsHybridPIC.cpp:102-143); each RK4 stage is a whole Ohm solve
and Faraday curl on the periodic torus, in plain PyTorch: the 2 x substeps
x 4 stage evaluations of a step are each a few dozen elementwise launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..constants import mu0 as _mu0
from ..constants import q_e as _q_e
from .yee import _down, _up, evolve_b

__all__ = ["curl_b_over_mu0", "electron_pressure", "ohm_solve_e",
           "hybrid_evolve_fields", "hybrid_initial_e", "resistivity"]


def curl_b_over_mu0(fields, geom):
    """J = curl(B)/mu0 at the Yee E sites (CalculateCurrentAmpere)."""
    Bx, By, Bz = fields.Bx, fields.By, fields.Bz
    inv_mu0 = 1.0 / _mu0
    if geom.ndim == 3:
        idx, idy, idz = (1.0 / d for d in geom.dx)
        jx = (_down(Bz, 1, idy) - _down(By, 2, idz)) * inv_mu0
        jy = (_down(Bx, 2, idz) - _down(Bz, 0, idx)) * inv_mu0
        jz = (_down(By, 0, idx) - _down(Bx, 1, idy)) * inv_mu0
    elif geom.ndim == 2:
        idx, idz = (1.0 / d for d in geom.dx)
        jx = -_down(By, 1, idz) * inv_mu0
        jy = (_down(Bx, 1, idz) - _down(Bz, 0, idx)) * inv_mu0
        jz = _down(By, 0, idx) * inv_mu0
    else:
        idz = 1.0 / geom.dx[0]
        jx = -_down(By, 0, idz) * inv_mu0
        jy = _down(Bx, 0, idz) * inv_mu0
        jz = torch.zeros_like(fields.Ez)
    return jx, jy, jz


def electron_pressure(rho, cfg):
    """P_e = n0 kTe ((rho/q_e)/n0)^gamma in J/m^3 (HybridPICModel.H:214;
    elec_temp in eV)."""
    n0 = cfg.hybrid_n0_ref
    T0 = cfg.hybrid_elec_temp * _q_e
    n = torch.clamp(rho, min=0.0) / _q_e
    return n0 * T0 * (n / n0) ** cfg.hybrid_gamma


def _to_nodal(arr, flags, ndim):
    """A staggered array averaged to the nodes (flag 0: centered, average
    i-1 and i)."""
    out = arr
    for d in range(ndim):
        if flags[d] == 0:
            out = 0.5 * (out + torch.roll(out, 1, d))
    return out


def _nodal_to(arr, flags, ndim):
    """A nodal array interpolated to a staggered site (average i, i+1 along
    the centered dims)."""
    out = arr
    for d in range(ndim):
        if flags[d] == 0:
            out = 0.5 * (out + torch.roll(out, -1, d))
    return out


def _laplacian(arr, geom):
    out = torch.zeros_like(arr)
    for d in range(geom.ndim):
        inv2 = 1.0 / (geom.dx[d] * geom.dx[d])
        out = out + (torch.roll(arr, -1, d) - 2.0 * arr
                     + torch.roll(arr, 1, d)) * inv2
    return out


def resistivity(cfg):
    """eta(rho, J) of ``hybrid_pic_model.plasma_resistivity(rho,J)``.  An
    expression that names neither variable is evaluated once on the host,
    and the function returns that number: a compiled expression makes its
    constants on the device at every call, a transfer each for the field
    advance's hundreds of stage evaluations."""
    from ..utils.expression import compile_expression, evaluate_constant

    consts = dict(cfg.user_constants or ())
    try:
        value = float(evaluate_constant(cfg.hybrid_eta, consts))
    except (NameError, ValueError, TypeError, SyntaxError):
        return compile_expression(cfg.hybrid_eta, ("rho", "J"), consts)
    return lambda rho, J: value


def _j_external(cfg, geom, staggering, like):
    """The external current at the Yee E sites (GetCurrentExternal), None
    for a component without an expression; evaluated at t = 0 in float64
    on the host, as the JAX package bakes it in."""
    if not any(cfg.hybrid_j_ext):
        return (None, None, None)
    from ..utils.expression import compile_expression

    ndim = geom.ndim
    axes = {1: (2,), 2: (0, 2), 3: (0, 1, 2)}[ndim]
    out = []
    for i, expr in enumerate(cfg.hybrid_j_ext):
        if not expr:
            out.append(None)
            continue
        fn = compile_expression(expr, ("x", "y", "z", "t"),
                                dict(cfg.user_constants or ()))
        flags = staggering[("Ex", "Ey", "Ez")[i]]
        coords3 = [torch.zeros((1,) * ndim, dtype=torch.float64)] * 3
        for d, a in enumerate(axes):
            offs = 0.0 if flags[d] else 0.5
            g = geom.prob_lo[d] + (torch.arange(
                geom.n_cell[d], dtype=torch.float64) + offs) * geom.dx[d]
            shape = [1] * ndim
            shape[d] = geom.n_cell[d]
            coords3[a] = g.reshape(shape)
        val = torch.broadcast_to(fn(*coords3, 0.0), tuple(geom.n_cell))
        out.append(val.to(device=like.device, dtype=like.dtype))
    return tuple(out)


def ohm_solve_e(fields, Ji3: Tuple, rho, geom, staggering, cfg,
                eta_fn=None, Pe=None, solve_for_Faraday: bool = True):
    """Ohm's-law E at the Yee E sites (HybridPICSolveE.cpp:700-1000).

    ``Ji3``: the ion current at the E sites; ``rho``: the nodal charge
    density.  Returns the fields with Ex/Ey/Ez replaced (J untouched: the
    reference keeps the deposited ion current in current_fp)."""
    ndim = geom.ndim
    jamp = curl_b_over_mu0(fields, geom)
    jext = _j_external(cfg, geom, staggering, fields.Ex)
    jp = tuple((a - e if e is not None else a) for a, e in zip(jamp, jext))
    e_names = ("Ex", "Ey", "Ez")
    b_names = ("Bx", "By", "Bz")
    jn = [_to_nodal(jp[i], staggering[e_names[i]], ndim) for i in range(3)]
    jin = [_to_nodal(Ji3[i], staggering[e_names[i]], ndim) for i in range(3)]
    bn = [_to_nodal(getattr(fields, b_names[i]), staggering[b_names[i]],
                    ndim) for i in range(3)]
    dj = [jn[i] - jin[i] for i in range(3)]
    enE = (dj[1] * bn[2] - dj[2] * bn[1],
           dj[2] * bn[0] - dj[0] * bn[2],
           dj[0] * bn[1] - dj[1] * bn[0])
    rho_floor = _q_e * cfg.hybrid_n_floor
    axis_of = {1: {2: 0}, 2: {0: 0, 2: 1}, 3: {0: 0, 1: 1, 2: 2}}[ndim]
    with_eta = eta_fn is not None and solve_for_Faraday
    if with_eta and cfg.hybrid_resistivity_has_J:
        # |J| from the nodal plasma current
        jtot_n = torch.sqrt(sum(j * j for j in jn))
    out = {}
    for i in range(3):
        flags = staggering[e_names[i]]
        rho_at = torch.clamp(_nodal_to(rho, flags, ndim), min=rho_floor)
        e_val = _nodal_to(enE[i], flags, ndim)
        if not solve_for_Faraday and Pe is not None:
            d = axis_of.get(i)
            if d is not None:
                # UpwardD of the nodal Pe onto the staggered E_i site
                e_val = e_val - _up(Pe, d, 1.0 / geom.dx[d])
        e_val = e_val / rho_at
        if with_eta:
            # |J| where the expression names it (the JAX package hands it
            # zeros otherwise)
            jt_at = (_nodal_to(jtot_n, flags, ndim)
                     if cfg.hybrid_resistivity_has_J else None)
            e_val = e_val + eta_fn(rho_at, jt_at) * jp[i]
            if cfg.hybrid_eta_h > 0.0:
                e_val = e_val - cfg.hybrid_eta_h * _laplacian(jp[i], geom)
        out[e_names[i]] = e_val
    return fields.replace(**out)


def _rk4_b(fields, Ji3, rho, geom, staggering, cfg, eta_fn, dt):
    """One classic RK4 advance of B by dt under dB/dt = -curl E(B)
    (BfieldEvolveRK, HybridPICModel.cpp:429-540)."""

    def dbdt(f):
        f_e = ohm_solve_e(f, Ji3, rho, geom, staggering, cfg, eta_fn=eta_fn,
                          solve_for_Faraday=True)
        # evolve_b applies B += dt (-curl E); the increment at dt = 1
        f_b = evolve_b(f_e, geom, 1.0, algo="yee")
        return (f_b.Bx - f_e.Bx, f_b.By - f_e.By, f_b.Bz - f_e.Bz)

    names = ("Bx", "By", "Bz")
    b0 = (fields.Bx, fields.By, fields.Bz)
    k1 = dbdt(fields)
    k2 = dbdt(fields.replace(**{n: b + 0.5 * dt * k
                                for n, b, k in zip(names, b0, k1)}))
    k3 = dbdt(fields.replace(**{n: b + 0.5 * dt * k
                                for n, b, k in zip(names, b0, k2)}))
    k4 = dbdt(fields.replace(**{n: b + dt * k
                                for n, b, k in zip(names, b0, k3)}))
    return fields.replace(**{
        n: b + (dt / 6.0) * (a + 2 * bb + 2 * cc + d)
        for n, b, a, bb, cc, d in zip(names, b0, k1, k2, k3, k4)})


def hybrid_evolve_fields(fields, rho_n, rho_np1, ji_old3, ji_new3, geom,
                         staggering, cfg, eta_fn, dt):
    """The hybrid field advance of one PIC step
    (WarpXPushFieldsHybridPIC.cpp:24-190): ``substeps`` RK4 steps of B
    over the first half step with (rho^n, J_i^n), as many over the second
    with (rho^{n+1/2}, J_i^{n+1/2}), then the Ohm's-law E at t^{n+1} with
    the extrapolated J_i^{n+1} and the electron pressure.

    ``rho_n`` / ``rho_np1``: nodal rho at t^n / t^{n+1}; ``ji_old3`` /
    ``ji_new3``: the ion current at t^{n-1/2} / t^{n+1/2}."""
    sub = max(cfg.hybrid_substeps, 1)
    ji_n = tuple(0.5 * (a + b) for a, b in zip(ji_old3, ji_new3))
    h = 0.5 * dt / sub
    for _ in range(sub):
        fields = _rk4_b(fields, ji_n, rho_n, geom, staggering, cfg, eta_fn,
                        h)
    rho_half = 0.5 * (rho_n + rho_np1)
    for _ in range(sub):
        fields = _rk4_b(fields, ji_new3, rho_half, geom, staggering, cfg,
                        eta_fn, h)
    ji_np1 = tuple(2.0 * b - a for a, b in zip(ji_n, ji_new3))
    pe = electron_pressure(rho_np1, cfg)
    return ohm_solve_e(fields, ji_np1, rho_np1, geom, staggering, cfg,
                       eta_fn=eta_fn, Pe=pe, solve_for_Faraday=False)


def hybrid_initial_e(fields, rho0, ji0, geom, staggering, cfg, eta_fn):
    """The Ohm's-law E of the t = 0 deposit (InitData -> HybridPICSolveE
    with solve_for_Faraday = false)."""
    pe = electron_pressure(rho0, cfg)
    return ohm_solve_e(fields, ji0, rho0, geom, staggering, cfg,
                       eta_fn=eta_fn, Pe=pe, solve_for_Faraday=False)
