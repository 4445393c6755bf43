"""Theta-implicit and semi-implicit electromagnetic time solvers.

The counterpart of ``warpx_tpu.solvers.implicit`` (reference:
Source/FieldSolver/ImplicitSolvers/ThetaImplicitEM.{H,cpp},
SemiImplicitEM.cpp, WarpXImplicitOps.cpp; NonlinearSolvers/PicardSolver.H,
NewtonSolver.H):

  theta-implicit (energy conserving at theta = 1/2):
    E^{n+1} = E^n + c^2 dt (curl B^{n+theta} - mu0 J^{n+1/2})
    B^{n+1} = B^n - dt curl E^{n+theta}
    x^{n+1} = x^n + dt u^{n+1/2} 2/(gamma^n + gamma^{n+1})
    u^{n+1} = u^n + dt q/m (E^{n+theta} + v^{n+1/2} x B^{n+theta})

  semi-implicit: B advances explicitly by dt first, then the same
  nonlinear solve for E^{n+1/2} with coefficient dt/2 and B held.

The unknown is E^{n+theta}.  One evaluation of the right-hand side
(ThetaImplicitEM::ComputeRHS) updates B^{n+theta}, runs the particles'
ImplicitPushXP iterations (gather with ``ops/implicit_gather.py``, push),
deposits the charge-conserving J^{n+1/2} and forms c^2 theta dt (curl B -
mu0 J).  Picard iterates E <- E^n + RHS(E) with the time-centred particle
state carried from one iteration to the next; Newton solves F(E) = E - E^n
- RHS(E) = 0 with ``gmres`` on the exact Jacobian-vector product
(``torch.func.jvp`` through the gather, push, deposit and curls; the
reference takes finite differences, JacobianFunctionMF.H), the particles
re-solving from u^n at every evaluation so that F is a function of E
alone.  ``gmres`` is the batched restarted GMRES of
``jax.scipy.sparse.linalg.gmres(solve_method="batched")``.

Periodic domains only.  Each Picard iteration and each Newton iteration
waits for the device once, on its norm; each GMRES restart waits once on
its residual and once per Arnoldi step on the breakdown test.
"""

from __future__ import annotations

import math

import torch

from ..constants import c as _c
from ..ops.deposit import deposit_current_esirkepov
from ..ops.implicit_gather import gather_eb_implicit
from ..ops.push import PUSHERS
from ..core.state import SimState
from . import yee

__all__ = ["ImplicitStepper", "gmres", "check_implicit_supported"]

_inv_c2 = 1.0 / (_c * _c)
_AXES = {1: (2,), 2: (0, 2), 3: (0, 1, 2)}


def _gamma(ux, uy, uz):
    return torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz) * _inv_c2)


def _norm(x):
    return torch.sqrt(sum(torch.sum(a * a) for a in x))


def _cn_gaminv(ubar3, un3):
    """2/(gamma^n + gamma^{n+1}) with u^{n+1} = 2 ubar - u^n
    (UpdatePosition.H:66-72)."""
    up1 = tuple(2.0 * ub - un for ub, un in zip(ubar3, un3))
    return 2.0 / (_gamma(*un3) + _gamma(*up1))


def check_implicit_supported(cfg) -> None:
    """Refuse what the JAX package's implicit step would run wrongly or
    drop without a word (ROADMAP.md Queue C), and what it refuses."""
    def no(what):
        raise NotImplementedError(
            f"implicit scheme: {what} (ROADMAP.md Queue C)")

    if cfg.evolve_scheme not in ("theta_implicit_em", "semi_implicit_em"):
        raise ValueError(f"evolve_scheme {cfg.evolve_scheme!r}")
    if cfg.implicit_nonlinear not in ("picard", "newton"):
        raise NotImplementedError(
            f"implicit nonlinear solver {cfg.implicit_nonlinear}")
    if not cfg.geometry.all_periodic:
        # the JAX package's refusal (simulation.py:115-118, :183-185)
        raise NotImplementedError(
            "implicit schemes support periodic domains only")
    if cfg.em_solver_medium != "vacuum":
        raise NotImplementedError(
            "macroscopic medium with implicit evolve schemes")
    # the JAX step hands em_solver to the Yee curls, which run plain Yee
    # for anything but CKC, and leaves out every operator below
    if cfg.em_solver not in ("yee", "ckc"):
        no(f"em_solver {cfg.em_solver!r} (the JAX package's implicit step "
           "runs the Yee curls in its place)")
    if cfg.grid_type != "staggered":
        no(f"grid type {cfg.grid_type!r}")
    if cfg.current_deposition != "esirkepov":
        no(f"current deposition {cfg.current_deposition!r} (the JAX "
           "package's implicit step deposits by Esirkepov whatever it is)")
    if cfg.use_filter:
        no("the current filter (the JAX package's implicit step never "
           "filters J; set warpx.use_filter = 0)")
    if cfg.use_nci_corr or cfg.do_dive_cleaning or cfg.do_divb_cleaning:
        no("the NCI corrector or divergence cleaning (the JAX package's "
           "implicit step skips them)")
    if cfg.collisions or cfg.do_qed_schwinger:
        no("collisions or Schwinger pairs (the JAX package's implicit step "
           "skips them)")
    if cfg.fluids:
        no("fluid species (the JAX package's implicit step has no fluid "
           "code)")
    if cfg.eb_implicit_function:
        no("an embedded boundary (the JAX package's periodic steps have "
           "no embedded boundary)")
    for sp in cfg.species:
        if sp.do_not_push or sp.do_not_gather:
            no(f"do_not_push/do_not_gather of {sp.name!r} (the JAX "
               "package's implicit step pushes and gathers every species)")
        if sp.mass == 0.0 or sp.species_type == "photon":
            no(f"massless species {sp.name!r}")
        if (sp.do_field_ionization or sp.do_qed_quantum_sync
                or sp.do_qed_breit_wheeler):
            no(f"ionization or QED of {sp.name!r} (the JAX package's "
               "implicit step skips them)")


# ---------------------------------------------------------------- GMRES
def _safe_normalize(x, thresh=None):
    """x / |x| and |x|, or zeros and 0 where |x| <= thresh (the dtype's
    eps by default)."""
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(norm.dtype).eps
    use = norm > thresh
    zero = torch.zeros((), dtype=norm.dtype, device=norm.device)
    return (tuple(torch.where(use, a / norm, zero) for a in x),
            torch.where(use, norm, zero))


def gmres(A, b, tol=1e-5, atol=0.0, restart=20, maxiter=None, stats=None):
    """Solve A x = b, x a tuple of tensors, from x0 = 0, as
    ``jax.scipy.sparse.linalg.gmres(..., solve_method="batched")`` does
    (jax/_src/scipy/sparse/linalg.py: ``_gmres_solve``, ``_gmres_batched``,
    ``_kth_arnoldi_iteration``): restarts while |b - A x| > max(tol |b|,
    atol) and fewer than ``maxiter``; each restart builds the whole
    ``restart``-dimensional Krylov space unless it breaks down, one
    classical Gram-Schmidt pass per vector (the re-orthogonalization test
    fails after the first pass there), and solves the least squares on the
    normal equations by Cholesky.  ``stats`` (a dict) gathers the restarts
    and the Arnoldi steps."""
    size = sum(a.numel() for a in b)
    if maxiter is None:
        maxiter = 10 * size
    restart = min(restart, size)
    dtype, dev = b[0].dtype, b[0].device
    eps = torch.finfo(dtype).eps
    b_norm = _norm(b)
    atol_t = torch.clamp_min(tol * b_norm, atol)
    x = tuple(torch.zeros_like(a) for a in b)
    # the residual of x0 = 0 (A is linear: A(0) = 0)
    unit, rnorm = _safe_normalize(b)
    k = 0
    while k < maxiter and bool(rnorm > atol_t):
        # one restart: V holds restart + 1 columns per component
        V = [torch.zeros((restart + 1,) + a.shape, dtype=dtype, device=dev)
             for a in b]
        for Vc, u in zip(V, unit):
            Vc[0] = u
        H = torch.eye(restart, restart + 1, dtype=dtype, device=dev)
        for j in range(restart):
            v = A(tuple(Vc[j] for Vc in V))
            _, v_norm_0 = _safe_normalize(v)
            h = sum(torch.tensordot(Vc, a, dims=a.dim())
                    for Vc, a in zip(V, v))
            v = tuple(a - torch.tensordot(h, Vc, dims=1)
                      for a, Vc in zip(v, V))
            unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
            for Vc, u in zip(V, unit_v):
                Vc[j + 1] = u
            h = h.clone()
            h[j + 1] = v_norm_1
            H[j] = h
            if stats is not None:
                stats["arnoldi"] = stats.get("arnoldi", 0) + 1
            if bool(v_norm_1 == 0.0):
                break
        beta = torch.zeros(restart + 1, dtype=dtype, device=dev)
        beta[0] = rnorm
        # least squares min |H^T y - beta| by its normal equations
        a = H.T
        L = torch.linalg.cholesky(a.T @ a)
        y = torch.cholesky_solve((a.T @ beta)[:, None], L)[:, 0]
        x = tuple(xc + torch.tensordot(y, Vc[:-1], dims=1)
                  for xc, Vc in zip(x, V))
        ax = A(x)
        unit, rnorm = _safe_normalize(tuple(bc - c for bc, c in zip(b, ax)))
        k += 1
        if stats is not None:
            stats["restarts"] = stats.get("restarts", 0) + 1
    return x


# ------------------------------------------------------------- the step
class ImplicitStepper:
    """The implicit step ``state -> state`` of one configuration.
    ``history`` holds each step's nonlinear iterations (Picard or Newton)
    and, under Newton, its GMRES restarts and Arnoldi steps."""

    def __init__(self, cfg, staggering, dtype, device=None):
        check_implicit_supported(cfg)
        self.cfg = cfg
        self.staggering = staggering
        self.dtype = dtype
        geom = cfg.geometry
        self.geom = geom
        self.dt = cfg.dt
        self.semi = cfg.evolve_scheme == "semi_implicit_em"
        self.theta = 0.5 if self.semi else cfg.implicit_theta
        self.adt = (0.5 * cfg.dt) if self.semi else (self.theta * cfg.dt)
        self.algo = cfg.em_solver
        self.axes = _AXES[geom.ndim]
        self.history = []

    # -- pieces
    def _fields_with(self, fields, e3=None, b3=None, j3=None):
        kw = {}
        if e3 is not None:
            kw.update(Ex=e3[0], Ey=e3[1], Ez=e3[2])
        if b3 is not None:
            kw.update(Bx=b3[0], By=b3[1], Bz=b3[2])
        if j3 is not None:
            kw.update(jx=j3[0], jy=j3[1], jz=j3[2])
        return fields.replace(**kw)

    def _particle_rhs(self, e3, b3, state, ubar, xhalf):
        """The ImplicitPushXP iterations and the J deposit of every
        species; returns (J3, ubar, xhalf)."""
        cfg, geom, dt = self.cfg, self.geom, self.dt
        ndim = geom.ndim
        j3 = tuple(torch.zeros(geom.n_cell, dtype=e3[0].dtype,
                               device=e3[0].device) for _ in range(3))
        farr = {"Ex": e3[0], "Ey": e3[1], "Ez": e3[2],
                "Bx": b3[0], "By": b3[1], "Bz": b3[2]}
        ee, be = cfg.e_ext_particle, cfg.b_ext_particle
        new_ubar, new_xhalf = {}, {}
        for sp_cfg in cfg.species:
            name = sp_cfg.name
            sp = state.species[name]
            pos_n = sp.positions(ndim)
            un3 = (sp.ux, sp.uy, sp.uz)
            ub, xh = ubar[name], xhalf[name]
            pusher = PUSHERS[sp_cfg.pusher]
            for _ in range(max(1, cfg.implicit_max_particle_iterations)):
                gi = _cn_gaminv(ub, un3)
                xh = tuple(p + 0.5 * dt * (ub[a] * gi)
                           for p, a in zip(pos_n, self.axes))
                e6 = gather_eb_implicit(pos_n, xh, farr, geom,
                                        cfg.particle_shape,
                                        cfg.deposit_chunk_size)
                e6 = (e6[0] + ee[0], e6[1] + ee[1], e6[2] + ee[2],
                      e6[3] + be[0], e6[4] + be[1], e6[5] + be[2])
                uf = pusher(*un3, *e6, sp_cfg.charge, sp_cfg.mass, dt)
                ub = tuple(0.5 * (a + b) for a, b in zip(uf, un3))
            new_ubar[name], new_xhalf[name] = ub, xh
            if not sp_cfg.do_not_deposit:
                w_eff = torch.where(sp.alive, sp.w, torch.zeros_like(sp.w))
                pos_new = [2.0 * h - p for h, p in zip(xh, pos_n)]
                j3 = deposit_current_esirkepov(
                    pos_new, ub[0], ub[1], ub[2], w_eff, sp_cfg.charge,
                    geom, dt, cfg.particle_shape,
                    chunk_size=cfg.deposit_chunk_size, out=j3,
                    positions_old=pos_n,
                    gaminv_override=_cn_gaminv(ub, un3))
        return j3, new_ubar, new_xhalf

    def _compute_rhs(self, e3, state, b_old3, ubar, xhalf):
        """RHS = c^2 adt (curl B^{n+theta} - mu0 J^{n+1/2}), with the
        particle state it leaves (ThetaImplicitEM::ComputeRHS)."""
        if self.semi:
            b3 = b_old3
        else:
            bf = yee.evolve_b(self._fields_with(state.fields, e3=e3,
                                                b3=b_old3),
                              self.geom, self.adt, self.algo)
            b3 = (bf.Bx, bf.By, bf.Bz)
        j3, ubar, xhalf = self._particle_rhs(e3, b3, state, ubar, xhalf)
        ef = yee.evolve_e(
            self._fields_with(state.fields,
                              e3=tuple(torch.zeros_like(a) for a in e3),
                              b3=b3, j3=j3),
            self.geom, self.adt, self.algo)
        return (ef.Ex, ef.Ey, ef.Ez), b3, j3, ubar, xhalf

    # -- the step
    def __call__(self, state: SimState) -> SimState:
        cfg, geom = self.cfg, self.geom
        fields = state.fields
        e_old = (fields.Ex, fields.Ey, fields.Ez)
        if self.semi:
            # B from n-1/2 to n+1/2 with E^n (SemiImplicitEM.cpp:73)
            bf = yee.evolve_b(fields, geom, self.dt, self.algo)
            b_old3 = (bf.Bx, bf.By, bf.Bz)
        else:
            b_old3 = (fields.Bx, fields.By, fields.Bz)
        ubar0 = {s.name: (state.species[s.name].ux, state.species[s.name].uy,
                          state.species[s.name].uz) for s in cfg.species}
        xhalf0 = {s.name: tuple(state.species[s.name].positions(geom.ndim))
                  for s in cfg.species}
        if cfg.implicit_nonlinear == "newton":
            e_theta = self._newton(state, e_old, b_old3, ubar0, xhalf0)
            _, b_theta, j3, ubar, xhalf = self._compute_rhs(
                e_theta, state, b_old3, ubar0, xhalf0)
        else:
            e_theta, b_theta, j3, ubar, xhalf = self._picard(
                state, e_old, b_old3, ubar0, xhalf0)
        return self._finish(state, e_old, b_old3, e_theta, b_theta, j3,
                            ubar, xhalf)

    def _picard(self, state, e_old, b_old3, ubar, xhalf):
        """E = E^n + RHS(E) (PicardSolver.H:132): iterate while the
        update's norm is at least ``picard_atol`` and, relative to the
        first update's, at least ``picard_rtol``."""
        cfg = self.cfg
        e3, b3 = e_old, b_old3
        j3 = tuple(torch.zeros_like(a) for a in e_old)
        it, norm_abs, norm0 = 0, math.inf, 1.0
        while (it < cfg.picard_max_iterations and norm_abs >= cfg.picard_atol
               and norm_abs / norm0 >= cfg.picard_rtol):
            rhs3, b3, j3, ubar, xhalf = self._compute_rhs(
                e3, state, b_old3, ubar, xhalf)
            e_new = tuple(eo + r for eo, r in zip(e_old, rhs3))
            norm_abs = float(_norm(tuple(a - b for a, b in zip(e3, e_new))))
            if it == 0:
                norm0 = norm_abs if norm_abs > 0 else 1.0
            e3 = e_new
            it += 1
        self.history.append({"iterations": it})
        return e3, b3, j3, ubar, xhalf

    def _newton(self, state, e_old, b_old3, ubar0, xhalf0):
        """Newton-Krylov on F(E) = E - E^n - RHS(E) (NewtonSolver.H) with
        GMRES on the exact Jacobian-vector product."""
        cfg = self.cfg

        def F(*e3):
            rhs3, _, _, _, _ = self._compute_rhs(e3, state, b_old3, ubar0,
                                                 xhalf0)
            return tuple(a - b - r for a, b, r in zip(e3, e_old, rhs3))

        fv = F(*e_old)
        f0n = float(_norm(fv))
        f0s = f0n if f0n > 0 else 1.0
        e3 = e_old
        it = 0
        stats = {}
        fn = f0n
        while (it < cfg.newton_max_iterations and fn >= cfg.newton_atol
               and fn / f0s >= cfg.newton_rtol):
            def mv(v3, _e3=e3):
                return torch.func.jvp(F, tuple(_e3), tuple(v3))[1]

            dx = gmres(mv, tuple(-f for f in fv), tol=cfg.gmres_rtol,
                       atol=cfg.gmres_atol, restart=cfg.gmres_restart,
                       maxiter=max(cfg.gmres_max_iterations
                                   // cfg.gmres_restart, 1),
                       stats=stats)
            e3 = tuple(a + d for a, d in zip(e3, dx))
            fv = F(*e3)
            fn = float(_norm(fv))
            it += 1
        self.history.append({"iterations": it,
                             "gmres_restarts": stats.get("restarts", 0),
                             "gmres_arnoldi": stats.get("arnoldi", 0)})
        return e3

    def _finish(self, state, e_old, b_old3, e_theta, b_theta, j3, ubar,
                xhalf):
        geom = self.geom
        fields = state.fields
        if not self.semi:
            # B^{n+theta} = B^n - theta dt curl(E_final)
            # (ThetaImplicitEM.cpp:110)
            bf = yee.evolve_b(self._fields_with(fields, e3=e_theta,
                                                b3=b_old3),
                              geom, self.adt, self.algo)
            b_theta = (bf.Bx, bf.By, bf.Bz)
        # x^{n+1} = 2 x_half - x^n, wrapped by a mod as the JAX step does;
        # u^{n+1} = 2 ubar - u^n
        new_species = dict(state.species)
        for sp_cfg in self.cfg.species:
            nm = sp_cfg.name
            sp = state.species[nm]
            pos_n = sp.positions(geom.ndim)
            pos1 = []
            for d, (h, p) in enumerate(zip(xhalf[nm], pos_n)):
                lo, hi = geom.prob_lo[d], geom.prob_hi[d]
                pos1.append(lo + torch.remainder(2.0 * h - p - lo, hi - lo))
            sp = sp.replace(ux=2.0 * ubar[nm][0] - sp.ux,
                            uy=2.0 * ubar[nm][1] - sp.uy,
                            uz=2.0 * ubar[nm][2] - sp.uz)
            new_species[nm] = sp.with_positions(geom.ndim, pos1)
        if self.semi:
            e1 = tuple(2.0 * et - eo for et, eo in zip(e_theta, e_old))
            b1 = b_old3
        else:
            c0 = 1.0 / self.theta
            c1 = 1.0 - c0
            e1 = tuple(c0 * et + c1 * eo for et, eo in zip(e_theta, e_old))
            b1 = tuple(c0 * bt + c1 * bo for bt, bo in zip(b_theta, b_old3))
        return state.replace(
            fields=self._fields_with(fields, e3=e1, b3=b1, j3=j3),
            species=new_species, step=state.step + 1,
            time=state.time + self.dt)
