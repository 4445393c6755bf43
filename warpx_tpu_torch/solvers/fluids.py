"""Cold relativistic fluid species (MUSCL-Hancock advection, Higuera-Cary
momentum push).

The counterpart of ``warpx_tpu.solvers.fluids`` (reference:
Source/Fluids/WarpXFluidContainer.cpp, MusclHancockUtils.H): each fluid
carries nodal (N, NUx, NUy, NUz) arrays on the periodic torus, kept in the
state's ``aux`` as ``fluid_N:<name>`` and ``fluid_NU{x,y,z}:<name>``, and
evolved each step by

  1. the momentum push: E and B averaged to the nodes, the Higuera-Cary
     update of U over dt (GatherAndPush, WarpXFluidContainer.cpp:1211);
  2. MUSCL-Hancock advection (AdvectivePush_Muscl): slopes of the
     primitives limited by the 'ave' minmod3 limiter, the Hancock
     half-step predictor with the quasilinear Jacobian, positivity-limited
     face states, Rusanov fluxes of the conserved variables;
  3. the deposits: q N at the nodes for rho, q N U / gamma averaged to
     the Yee J sites (DepositCurrent).

Elementwise PyTorch over ``torch.roll``; no loop over cells.
"""

from __future__ import annotations

import torch

from ..constants import c as _c
from ..ops.push import push_momentum_higuera_cary

__all__ = ["init_fluid", "fluid_gather_push", "fluid_advect", "fluid_rho",
           "fluid_current", "fluid_evolve", "fluid_keys"]

_c2 = _c * _c
_AXES = {1: (2,), 2: (0, 2), 3: (0, 1, 2)}


def fluid_keys(name: str):
    """The ``aux`` keys of fluid ``name``: N, then NUx, NUy, NUz."""
    return (f"fluid_N:{name}",) + tuple(f"fluid_NU{ax}:{name}"
                                        for ax in "xyz")


def init_fluid(sp, geom, dtype, device=None):
    """Nodal N and (NUx, NUy, NUz) from the density and momentum profiles
    (WarpXFluidContainer::InitData; periodic, so the nodal extent is
    n_cell)."""
    from ..utils.expression import compile_expression

    ndim = geom.ndim
    kw = dict(dtype=dtype, device=device)
    coords3 = [torch.zeros((1,) * ndim, **kw)] * 3
    for d in range(ndim):
        g = geom.prob_lo[d] + torch.arange(
            geom.n_cell[d], dtype=torch.float64, device=device) * geom.dx[d]
        shape = [1] * ndim
        shape[d] = geom.n_cell[d]
        coords3[_AXES[ndim][d]] = g.reshape(shape).to(dtype)
    uc = dict(sp.user_constants)
    n_cell = tuple(geom.n_cell)
    if sp.profile in ("parse", "parse_density_function"):
        fn = compile_expression(sp.density_expr, ["x", "y", "z"], uc)
        N = torch.broadcast_to(torch.as_tensor(fn(*coords3), **kw), n_cell)
    else:
        N = torch.full(n_cell, sp.density, **kw)
    if sp.momentum_exprs is not None:
        u3 = []
        for expr in sp.momentum_exprs:
            fe = compile_expression(expr, ["x", "y", "z"], uc)
            u3.append(torch.broadcast_to(
                torch.as_tensor(fe(*coords3), **kw), n_cell) * _c)
    else:
        u3 = [torch.full(n_cell, u * _c, **kw) for u in (sp.ux, sp.uy, sp.uz)]
    N = N.contiguous()
    return N, tuple((N * u).contiguous() for u in u3)


def _prim(N, NU3):
    """The primitive U = NU / N (0 where N <= 0)."""
    pos = N > 0
    one = torch.ones((), dtype=N.dtype, device=N.device)
    zero = torch.zeros((), dtype=N.dtype, device=N.device)
    Ns = torch.where(pos, N, one)
    return tuple(torch.where(pos, nu / Ns, zero) for nu in NU3)


def _gamma(u3):
    return torch.sqrt(1.0 + (u3[0] ** 2 + u3[1] ** 2 + u3[2] ** 2) / _c2)


def _minmod3(a, b, c3):
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    pos = (a > 0) & (b > 0) & (c3 > 0)
    neg = (a < 0) & (b < 0) & (c3 < 0)
    return torch.where(pos, torch.minimum(a, torch.minimum(b, c3)),
                       torch.where(neg, torch.maximum(a, torch.maximum(b, c3)),
                                   zero))


def _ave(a, b):
    """The 'ave' low-diffusivity limiter (MusclHancockUtils.H:146):
    minmod3((a+b)/2, 2a, 2b) where a b > 0."""
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.where(a * b > 0.0,
                       _minmod3(0.5 * (a + b), 2.0 * a, 2.0 * b), zero)


def fluid_gather_push(N, NU3, fields, geom, staggering, sp, dt):
    """The momentum source: staggered E and B averaged to the nodes, the
    Higuera-Cary push of U where N > 0 (GatherAndPush)."""
    ndim = geom.ndim

    def to_nodal(arr, flags):
        out = arr
        for d in range(ndim):
            if flags[d] == 0:
                out = 0.5 * (out + torch.roll(out, 1, d))
        return out

    e6 = [to_nodal(getattr(fields, nm), staggering[nm])
          for nm in ("Ex", "Ey", "Ez", "Bx", "By", "Bz")]
    u3 = _prim(N, NU3)
    ux, uy, uz = push_momentum_higuera_cary(
        u3[0], u3[1], u3[2], *e6, sp.charge, sp.mass, dt)
    keep = N > 0
    return (torch.where(keep, N * ux, NU3[0]),
            torch.where(keep, N * uy, NU3[1]),
            torch.where(keep, N * uz, NU3[2]))


def fluid_advect(N, NU3, geom, dt):
    """One MUSCL-Hancock advection step (AdvectivePush_Muscl), periodic."""
    ndim = geom.ndim
    u3 = _prim(N, NU3)
    gam = _gamma(u3)
    Ux, Uy, Uz = u3
    axes = _AXES[ndim]
    U_by_xyz = {0: Ux, 1: Uy, 2: Uz}

    def slopes(q):
        return [_ave(q - torch.roll(q, 1, d), torch.roll(q, -1, d) - q)
                for d in range(ndim)]

    dN, dUx, dUy, dUz = slopes(N), slopes(Ux), slopes(Uy), slopes(Uz)

    # the Hancock predictor: prim - sum_d dt/(2 dx_d) J_d dU_d
    inv_g3c2 = 1.0 / (gam ** 3 * _c2)
    t0, t1, t2, t3 = N, Ux, Uy, Uz
    for d in range(ndim):
        a = axes[d]
        V = U_by_xyz[a] / gam
        Ua = U_by_xyz[a]
        j0 = []
        for m, Um in enumerate((Ux, Uy, Uz)):
            if m == a:
                j0.append(N * (1.0 / gam) * (1.0 - V * V / _c2))
            else:
                j0.append(-N * Um * Ua * inv_g3c2)
        half = 0.5 * dt / geom.dx[d]
        dU_d = (dN[d], dUx[d], dUy[d], dUz[d])
        t0 = t0 - half * (V * dU_d[0] + j0[0] * dU_d[1]
                          + j0[1] * dU_d[2] + j0[2] * dU_d[3])
        t1 = t1 - half * V * dU_d[1]
        t2 = t2 - half * V * dU_d[2]
        t3 = t3 - half * V * dU_d[3]

    # face states, the positivity limiter and Rusanov fluxes per axis
    newN, newNUx, newNUy, newNUz = N, NU3[0], NU3[1], NU3[2]
    prim_node = (N, Ux, Uy, Uz)
    for d in range(ndim):
        dU_d = (dN[d], dUx[d], dUy[d], dUz[d])
        # the minus state at face i+1/2 from node i, the plus one from i+1
        Um = [t + 0.5 * s for t, s in zip((t0, t1, t2, t3), dU_d)]
        Up_node = [t - 0.5 * s for t, s in zip((t0, t1, t2, t3), dU_d)]
        Up = [torch.roll(q, -1, d) for q in Up_node]
        # a node with a negative face density resets both its faces
        neg_node = (Um[0] < 0.0) | (Up_node[0] < 0.0)
        Um = [torch.where(neg_node, p, q) for p, q in zip(prim_node, Um)]
        neg_up = torch.roll(neg_node, -1, d)
        prim_up = [torch.roll(p, -1, d) for p in prim_node]
        Up = [torch.where(neg_up, p, q) for p, q in zip(prim_up, Up)]

        a = axes[d]
        gm = _gamma((Um[1], Um[2], Um[3]))
        gp = _gamma((Up[1], Up[2], Up[3]))
        Vm = Um[1 + a] / gm
        Vp = Up[1 + a] / gp
        cmax = torch.maximum(torch.abs(Vm), torch.abs(Vp))
        Qm = (Um[0], Um[0] * Um[1], Um[0] * Um[2], Um[0] * Um[3])
        Qp = (Up[0], Up[0] * Up[1], Up[0] * Up[2], Up[0] * Up[3])
        F = [0.5 * (Vm * qm + Vp * qp) - 0.5 * cmax * (qp - qm)
             for qm, qp in zip(Qm, Qp)]
        r = dt / geom.dx[d]
        newN = newN - r * (F[0] - torch.roll(F[0], 1, d))
        newNUx = newNUx - r * (F[1] - torch.roll(F[1], 1, d))
        newNUy = newNUy - r * (F[2] - torch.roll(F[2], 1, d))
        newNUz = newNUz - r * (F[3] - torch.roll(F[3], 1, d))
    return newN, (newNUx, newNUy, newNUz)


def fluid_rho(N, q):
    """The nodal charge density q N (DepositCharge)."""
    return q * N


def fluid_current(N, NU3, geom, staggering, q):
    """J at the Yee sites from the nodal q N U / gamma (DepositCurrent)."""
    ndim = geom.ndim
    u3 = _prim(N, NU3)
    gam = _gamma(u3)
    out = []
    for nm, u in zip(("Ex", "Ey", "Ez"), u3):
        arr = q * N * u / gam
        for d in range(ndim):
            if staggering[nm][d] == 0:
                arr = 0.5 * (arr + torch.roll(arr, -1, d))
        out.append(arr)
    return tuple(out)


def fluid_evolve(N, NU3, fields, geom, staggering, sp, dt):
    """One fluid step (WarpXFluidContainer::Evolve without the rho
    deposits, which the caller makes): push, then advect."""
    NU3 = fluid_gather_push(N, NU3, fields, geom, staggering, sp, dt)
    return fluid_advect(N, NU3, geom, dt)
