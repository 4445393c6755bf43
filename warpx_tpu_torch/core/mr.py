"""Two-level electromagnetic mesh refinement (one static fine patch).

The counterpart of ``warpx_tpu.core.mr`` (Vay's substitution scheme as
WarpX composes it):

- One static fine patch (``warpx.fine_tag_lo/hi``) refined by
  ``amr.ref_ratio``, its box grown to ``amr.blocking_factor`` multiples in
  fine cells.  dt is the finest level's CFL step (``core/deck.py``).
- Particles live at level 0; a particle inside the patch gathers from and
  deposits to the fine level unless it sits within the gather or the
  deposition buffer of the coarse-fine interface (WarpX::BuildBufferMasks,
  buffer widths in fine cells; ``MRLayout.fine_mask``).
- The patch carries two solutions, each ringed by a split-field PML: the
  fine-resolution solve (``fp``, the aux keys ``mr:f:<comp>:<i>``) driven
  by the fine current (``mr:j:<jx|jy|jz>``), and a coarse-resolution patch
  solve (``cp``, ``mr:c:<comp>:<i>``) driven by the averaged-down current.
- J_cp is the staggering-aware average-down of J_fp (SyncCurrent); the
  unfiltered J_cp is added into level 0's J over the patch before the
  per-level filters.
- The fine gather reads aux(1) = fp + I(aux(0) - cp), the 2-point
  staggering-aware interpolation (UpdateAuxilaryDataSameType,
  WarpXComm.cpp:388).
- Under ``warpx.do_subcycling`` (ratio 2) the fine level takes two
  substeps of dt/2 around the split coarse advance (OneStep_sub1).

``make_mr_step`` builds the periodic step and its half push (gather on
both levels, push, deposit on both levels, the three field solves); the
bounded step rides the same pieces (``core/bounded_step.py``).  Where a
weight is zero the JAX package still deposits the particle; here the
deposits and the fine gather take only the particles of their level
(``torch.nonzero``): a zero weight adds an exact zero, so the sums agree
to roundoff, and a full-width step deposits each particle once.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..constants import c as _c
from ..constants import mu0 as _mu0
from .grid import Geometry

_c2 = _c * _c

__all__ = ["MRLayout", "make_mr_step", "make_patch_advance", "mr_init_aux",
           "compute_aux1", "coarsen_field", "mr_output_fields",
           "check_mr_supported", "refine_spec_of", "part_keys"]

_EB = ("Ex", "Ey", "Ez", "Bx", "By", "Bz")
_JNAMES = ("jx", "jy", "jz")

# curl structure: comp -> ((source comp, derivative axis (3D xyz), sign), ...)
# dB/dt = -curl E (upward differences); dE/dt = c^2 curl B - J/ep0 (downward)
_B_TERMS_3D = {
    "Bx": (("Ey", 2, +1.0), ("Ez", 1, -1.0)),
    "By": (("Ez", 0, +1.0), ("Ex", 2, -1.0)),
    "Bz": (("Ex", 1, +1.0), ("Ey", 0, -1.0)),
}
_E_TERMS_3D = {
    "Ex": (("Bz", 1, +1.0), ("By", 2, -1.0)),
    "Ey": (("Bx", 2, +1.0), ("Bz", 0, -1.0)),
    "Ez": (("By", 0, +1.0), ("Bx", 1, -1.0)),
}


def _active_terms(terms3d, ndim):
    """The 3D curl terms on the active axes (2D: x, z; d/dy vanishes)."""
    amap = ({0: 0, 1: 1, 2: 2} if ndim == 3 else
            {0: 0, 1: None, 2: 1} if ndim == 2 else
            {0: None, 1: None, 2: 0})
    return {comp: tuple((src, amap[ax3], sign) for src, ax3, sign in terms
                        if amap[ax3] is not None)
            for comp, terms in terms3d.items()}


def check_mr_supported(cfg) -> None:
    """Refuse what the JAX package's mesh refinement does not run, or runs
    with a part dropped (ROADMAP.md Queue C): its deck reader's refusals,
    with its messages (``warpx_tpu/core/deck.py:317-355``), and on the
    periodic step what its ``make_mr_step`` leaves out."""
    def no(what):
        raise NotImplementedError(
            f"mesh refinement: {what} (ROADMAP.md Queue C)")

    def jax_refuses(what):
        raise NotImplementedError(
            f"{what} (the JAX reader refuses it too; ROADMAP.md Queue C)")

    if cfg.max_level > 1:
        jax_refuses("amr.max_level > 1")
    if cfg.geometry.rz:
        no("RZ geometry")
    rv = tuple(cfg.ref_ratio) or (2,) * cfg.geometry.ndim
    if cfg.do_subcycling and any(r != 2 for r in rv):
        jax_refuses("subcycling requires ref_ratio = 2 (OneStep_sub1 runs "
                    "exactly two fine substeps)")
    if cfg.em_solver not in ("yee", "ckc") or cfg.electrostatic != "none":
        jax_refuses(f"mesh refinement with solver '{cfg.em_solver}'/"
                    f"electrostatic '{cfg.electrostatic}' (FDTD Yee/CKC "
                    "only)")
    if cfg.grid_type != "staggered":
        jax_refuses("MR requires a staggered grid")
    if cfg.collisions:
        jax_refuses("MR with collisions")
    if cfg.current_deposition not in ("esirkepov", "villasenor"):
        jax_refuses(f"MR with {cfg.current_deposition} current deposition")
    if cfg.evolve_scheme != "explicit":
        no("an implicit scheme (the JAX package runs the explicit MR step "
           "in its place)")
    if cfg.em_solver_medium != "vacuum" or cfg.fluids:
        no("a macroscopic medium or fluid species (the JAX package's MR "
           "step has neither)")
    if cfg.field_gathering == "momentum-conserving" and any(
            o != 2 for o in cfg.field_centering_no):
        no("momentum-conserving gathering at a centering order other than "
           "2 (the JAX package's MR averages two points)")
    if cfg.do_subcycling and (cfg.do_dive_cleaning or cfg.do_divb_cleaning):
        raise NotImplementedError("subcycling with divergence cleaning")
    if not any(bc != "periodic" for bc in cfg.field_bc_lo + cfg.field_bc_hi) \
            and not cfg.do_moving_window and not cfg.lasers:
        # the periodic MR step (make_mr_step)
        if cfg.do_dive_cleaning or cfg.do_divb_cleaning:
            no("divergence cleaning on the periodic MR step (the JAX "
               "package's hands its field advance no rho)")
        if any(cfg.e_ext_particle) or any(cfg.b_ext_particle) or \
                cfg.lattice_elements:
            no("external particle fields on the periodic MR step (the JAX "
               "package's MR gather adds none)")
        for sp in cfg.species:
            if (sp.do_field_ionization or sp.do_qed_quantum_sync
                    or sp.do_qed_breit_wheeler or sp.mass == 0.0
                    or sp.zinject_plane is not None):
                no(f"species {sp.name!r}: ionization, QED, a massless "
                   "species or rigid injection on the periodic MR step (the "
                   "JAX package's MR step has none of them)")
        if cfg.do_qed_schwinger:
            no("Schwinger pair creation on the periodic MR step")


class MRLayout:
    """The static index geometry of the fine patch (numpy, on the host),
    with the index tables as tensors per device (``tables``)."""

    def __init__(self, cfg, staggering):
        geom = cfg.geometry
        ndim = geom.ndim
        rv = cfg.ref_ratio or (2,) * ndim
        if isinstance(rv, int):
            rv = (rv,) * ndim
        rv = tuple(int(r) for r in rv)
        if any(r != 1 and r % 2 != 0 for r in rv):
            # odd ratios > 1 break the nodal average-down (r/2 taps)
            raise NotImplementedError("amr.ref_ratio must be even (or 1)")
        self.ndim = ndim
        self.rv = rv
        dxc = geom.dx
        lo, hi = cfg.fine_tag_lo, cfg.fine_tag_hi
        if len(lo) != ndim or len(hi) != ndim:
            raise NotImplementedError(
                "amr.max_level > 0 requires warpx.fine_tag_lo/hi")
        i0 = [int(round((lo[d] - geom.prob_lo[d]) / dxc[d]))
              for d in range(ndim)]
        i1 = [int(round((hi[d] - geom.prob_lo[d]) / dxc[d]))
              for d in range(ndim)]
        # AMReX blocking: the refined box snaps out to blocking_factor
        # multiples in fine cells, clamped to the domain
        bf = int(getattr(cfg, "blocking_factor", 8) or 8)
        for d in range(ndim):
            step = max(bf // rv[d], 1)
            i0[d] = max(0, (i0[d] // step) * step)
            i1[d] = min(geom.n_cell[d], -((-i1[d]) // step) * step)
        self.i0, self.i1 = tuple(i0), tuple(i1)
        self.nc = tuple(self.i1[d] - self.i0[d] for d in range(ndim))
        if any(n <= 0 for n in self.nc):
            raise ValueError("empty fine_tag box")
        # a patch over the whole periodic domain has no PML and no buffers;
        # an axis the patch spans has no coarse-fine interface along it
        self.spanning = tuple(
            self.i0[d] == 0 and self.i1[d] == geom.n_cell[d]
            for d in range(ndim))
        self.full_domain = all(self.spanning)
        if not self.full_domain and any(
                (self.i0[d] < 1 or self.i1[d] > geom.n_cell[d] - 1)
                and not self.spanning[d] for d in range(ndim)):
            raise NotImplementedError(
                "fine patch partially touching a level-0 boundary")
        self.nf = tuple(n * r for n, r in zip(self.nc, rv))
        self.npml_f = 0 if self.full_domain else int(cfg.pml_ncell)
        self.npml_c = self.npml_f
        self.patch_lo = tuple(geom.prob_lo[d] + self.i0[d] * dxc[d]
                              for d in range(ndim))
        self.patch_hi = tuple(geom.prob_lo[d] + self.i1[d] * dxc[d]
                              for d in range(ndim))
        self.dxf = tuple(d / r for d, r in zip(dxc, rv))
        self.n_fext = tuple(n + 2 * self.npml_f for n in self.nf)
        self.n_cext = tuple(n + 2 * self.npml_c for n in self.nc)
        self.geom_f_ext = Geometry(
            ndim=ndim, n_cell=self.n_fext,
            prob_lo=tuple(self.patch_lo[d] - self.npml_f * self.dxf[d]
                          for d in range(ndim)),
            prob_hi=tuple(self.patch_hi[d] + self.npml_f * self.dxf[d]
                          for d in range(ndim)),
            periodic=(True,) * ndim)
        self.geom_c_ext = Geometry(
            ndim=ndim, n_cell=self.n_cext,
            prob_lo=tuple(self.patch_lo[d] - self.npml_c * dxc[d]
                          for d in range(ndim)),
            prob_hi=tuple(self.patch_hi[d] + self.npml_c * dxc[d]
                          for d in range(ndim)),
            periodic=(True,) * ndim)
        # global index offsets of the extended grids
        self.f_off = tuple(self.i0[d] * rv[d] - self.npml_f
                           for d in range(ndim))
        self.c_off = tuple(self.i0[d] - self.npml_c for d in range(ndim))
        self.n0 = geom.n_cell
        self.gather_buf = int(cfg.n_field_gather_buffer)
        self.dep_buf = int(cfg.n_current_deposition_buffer)
        self._b_terms = _active_terms(_B_TERMS_3D, ndim)
        self._e_terms = _active_terms(_E_TERMS_3D, ndim)
        self._cache = {}

    # -------------------------------------------------- particle level masks
    def fine_mask(self, positions, nbuf, patch_lo=None):
        """True where the particle's fine cell is at least ``nbuf`` fine
        cells from every patch edge (BuildBufferMasksInBox); ``patch_lo``
        (default: the static one) is the patch's lower corner, which rides
        a moving window."""
        if self.full_domain:
            return torch.ones(positions[0].shape, dtype=torch.bool,
                              device=positions[0].device)
        lo = self.patch_lo if patch_lo is None else patch_lo
        ok = None
        for d in range(self.ndim):
            if self.spanning[d]:
                continue
            idx = torch.floor((positions[d] - lo[d]) / self.dxf[d])
            in_d = (idx >= nbuf) & (idx <= self.nf[d] - 1 - nbuf)
            ok = in_d if ok is None else ok & in_d
        if ok is None:
            ok = torch.ones(positions[0].shape, dtype=torch.bool,
                            device=positions[0].device)
        return ok

    # -------------------------------------------------- sigma (PML) profiles
    def _sigma_1d(self, axis, nodal, fine):
        """The 1/time damping profile along ``axis`` on the extended grid."""
        npml = self.npml_f if fine else self.npml_c
        n_int = self.nf[axis] if fine else self.nc[axis]
        dx = self.dxf[axis] if fine else self.dxf[axis] * self.rv[axis]
        n_ext = n_int + 2 * npml
        if npml == 0:
            return np.zeros(n_ext)
        pos = np.arange(n_ext, dtype=np.float64) + (0.0 if nodal else 0.5)
        depth = np.clip(np.maximum(npml - pos, pos - (npml + n_int)), 0.0,
                        npml)
        # sigma_max from the R0 = 1e-8 reflection target, m = 2
        sigma_max = 3.0 * (-math.log(1e-8)) * _c / (2.0 * npml * dx)
        return sigma_max * (depth / npml) ** 2

    def damping_tables(self, staggering, tau_b, tau_e, fine, dtype, device):
        """Per split part ``"<comp>:<i>"``: (decay, source coefficient)
        shaped to broadcast along the part's damping axis; decay =
        exp(-sigma tau), coefficient (1 - decay)/sigma (tau where sigma is
        0); B parts take tau_b, E parts tau_e."""
        out = {}
        for comp, terms, tau in (
                [(c, t, tau_b) for c, t in self._b_terms.items()]
                + [(c, t, tau_e) for c, t in self._e_terms.items()]):
            flags = staggering[comp]
            for i, (_src, ax, _sign) in enumerate(terms):
                sig = self._sigma_1d(ax, flags[ax] == 1, fine)
                decay = np.exp(-sig * tau)
                coef = np.where(sig > 0, -np.expm1(-sig * tau)
                                / np.where(sig > 0, sig, 1.0), tau)
                shape = [1] * self.ndim
                shape[ax] = -1
                out[f"{comp}:{i}"] = tuple(
                    torch.as_tensor(a.reshape(shape), dtype=dtype,
                                    device=device) for a in (decay, coef))
        return out

    # ------------------------------------------------------- index tables
    def coarsen_tables(self, flags, fine_shape):
        """Per axis (idx, weights, valid) of the staggering-aware
        average-down (ablastr::coarsen::average): a cell-centered axis
        averages r fine cells; a nodal one takes (1/2, 1, ..., 1, 1/2)/r
        over r + 1 fine nodes."""
        tabs = []
        for d in range(self.ndim):
            r = self.rv[d]
            cg = np.arange(self.n_cext[d]) + self.c_off[d]
            if flags[d] == 1:
                if r == 1:
                    taps, w = np.array([0]), np.array([1.0])
                else:
                    taps = np.arange(-r // 2, r // 2 + 1)
                    w = np.full(len(taps), 1.0 / r)
                    w[0] = w[-1] = 0.5 / r
            else:
                taps = np.arange(r)
                w = np.full(r, 1.0 / r)
            fidx = cg[:, None] * r + taps[None, :] - self.f_off[d]
            if self.full_domain:
                tabs.append((fidx % fine_shape[d], w, None))
            else:
                valid = (fidx >= 0) & (fidx < fine_shape[d])
                tabs.append((np.clip(fidx, 0, fine_shape[d] - 1), w, valid))
        return tabs

    def interp_tables(self, flags):
        """Per axis (idx(2), weights(2)) of the 2-point coarse-to-fine
        interpolation (warpx_interp, WarpXComm_K.H:28): output on the fine
        extended grid, source on the coarse extended grid, zero out of
        range."""
        tabs = []
        for d in range(self.ndim):
            r = self.rv[d]
            jg = np.arange(self.n_fext[d]) + self.f_off[d]
            h = 0.0 if flags[d] == 1 else 0.5
            jc = (np.floor_divide(jg, r) if flags[d] == 1
                  else np.floor_divide(jg - r // 2, r))
            idx = np.stack([jc, jc + 1], axis=1)
            w = np.empty_like(idx, dtype=np.float64)
            for t in range(2):
                w[:, t] = (r - np.abs(jg + h - (idx[:, t] + h) * r)) / r
            w = np.clip(w, 0.0, None)
            cidx = idx - self.c_off[d]
            if self.full_domain:
                cidx = cidx % self.n_cext[d]
            else:
                w = w * ((cidx >= 0) & (cidx < self.n_cext[d]))
                cidx = np.clip(cidx, 0, self.n_cext[d] - 1)
            tabs.append((cidx, w))
        return tabs

    def window_indices(self):
        """Level-0 (periodic) indices covering the coarse extended grid."""
        return [(np.arange(self.n_cext[d]) + self.c_off[d]) % self.n0[d]
                for d in range(self.ndim)]

    def patch_slices(self, flags, grid):
        """(level-0 slices, extended-grid slices) over the valid patch box;
        ``grid``: 'c' (coarse extended) or 'f' (fine extended)."""
        dst, src = [], []
        npml = self.npml_c if grid == "c" else self.npml_f
        nvals = self.nc if grid == "c" else self.nf
        for d in range(self.ndim):
            extra = 1 if (flags[d] == 1 and not self.full_domain) else 0
            dst.append(slice(self.i0[d], self.i1[d] + extra))
            src.append(slice(npml, npml + nvals[d] + extra))
        return tuple(dst), tuple(src)

    def tables(self, kind, flags, device, dtype, shape=None):
        """The ``kind`` ('interp' | 'coarsen' | 'window') tables of a
        component with staggering ``flags`` as tensors on ``device``: per
        axis (index (n, taps), weights (n, taps)), or the window's
        indices; made once."""
        key = (kind, tuple(flags), str(device), dtype, shape)
        got = self._cache.get(key)
        if got is not None:
            return got
        if kind == "window":
            got = [torch.as_tensor(i, dtype=torch.int64, device=device)
                   for i in self.window_indices()]
        elif kind == "interp":
            got = [(torch.as_tensor(i, dtype=torch.int64, device=device),
                    torch.as_tensor(w, dtype=dtype, device=device))
                   for i, w in self.interp_tables(flags)]
        else:
            got = []
            for i, w, valid in self.coarsen_tables(flags, shape):
                wgt = np.broadcast_to(w, i.shape).copy()
                if valid is not None:
                    wgt = wgt * valid
                got.append((torch.as_tensor(i, dtype=torch.int64,
                                            device=device),
                            torch.as_tensor(wgt, dtype=dtype,
                                            device=device)))
        self._cache[key] = got
        return got


def _axis_apply(arr, axis, idx, w):
    """out[..., j, ...] = sum_t w[j, t] arr[..., idx[j, t], ...] along
    ``axis``."""
    taken = torch.index_select(arr, axis, idx.reshape(-1))
    taken = taken.reshape(arr.shape[:axis] + idx.shape
                          + arr.shape[axis + 1:])
    wshape = [1] * taken.ndim
    wshape[axis] = idx.shape[0]
    wshape[axis + 1] = idx.shape[1]
    return torch.sum(taken * w.reshape(wshape), dim=axis + 1)


def _take_window(arr, win_idx):
    for d, idx in enumerate(win_idx):
        arr = torch.index_select(arr, d, idx)
    return arr


def make_patch_advance(layout: MRLayout, staggering, algo, tau_b, tau_e,
                       fine, dtype, device):
    """The B and E sub-steps on a patch's extended grid with the
    split-field PML (exponential damping).  Returns (b_step, e_step):
    b_step advances every B part by tau_b from the current E, e_step the E
    parts by tau_e with the current J; the FDTD step is b_step, e_step,
    b_step with tau_b = dt/2, tau_e = dt; the subcycled coarse patch
    composes them as [B,E] / [E,B] with tau_b = tau_e = dt_fine
    (OneStep_sub1, WarpXEvolve.cpp:928, :1000)."""
    from ..solvers.yee import _ckc_coefs, _up_ckc

    geom = layout.geom_f_ext if fine else layout.geom_c_ext
    inv_d = [1.0 / dx for dx in geom.dx]
    damp = layout.damping_tables(staggering, tau_b, tau_e, fine, dtype,
                                 device)
    b_terms = layout._b_terms
    e_terms = layout._e_terms

    if algo == "ckc":
        coefs = _ckc_coefs(geom)

        def dup(F, ax):
            return _up_ckc(F, ax, coefs)
    else:
        def dup(F, ax):
            return (torch.roll(F, -1, ax) - F) * inv_d[ax]

    def ddown(F, ax):
        return (F - torch.roll(F, 1, ax)) * inv_d[ax]

    def total(parts, comp, terms):
        tot = parts[f"{comp}:0"]
        for i in range(1, len(terms[comp])):
            tot = tot + parts[f"{comp}:{i}"]
        return tot

    def b_step(parts):
        parts = dict(parts)
        E = {c: total(parts, c, e_terms) for c in ("Ex", "Ey", "Ez")}
        for comp, terms in b_terms.items():
            for i, (src, ax, sign) in enumerate(terms):
                key = f"{comp}:{i}"
                decay, coef = damp[key]
                parts[key] = decay * parts[key] + coef * (
                    sign * dup(E[src], ax))
        return parts

    def e_step(parts, j3):
        parts = dict(parts)
        B = {c: total(parts, c, b_terms) for c in ("Bx", "By", "Bz")}
        jmap = {"Ex": j3[0], "Ey": j3[1], "Ez": j3[2]}
        for comp, terms in e_terms.items():
            for i, (src, ax, sign) in enumerate(terms):
                key = f"{comp}:{i}"
                decay, coef = damp[key]
                rhs = _c2 * sign * ddown(B[src], ax)
                if i == 0:
                    rhs = rhs - _c2 * _mu0 * jmap[comp]
                parts[key] = decay * parts[key] + coef * rhs
        return parts

    return b_step, e_step


def part_keys(layout: MRLayout):
    """The split parts ``"<comp>:<i>"``, B's then E's."""
    return [f"{comp}:{i}"
            for comp, terms in list(layout._b_terms.items())
            + list(layout._e_terms.items())
            for i in range(len(terms))]


def mr_init_aux(layout: MRLayout, dtype, device) -> Dict:
    """The patch state at rest: every split part of both solutions and the
    fine current, zero."""
    aux = {}
    for key in part_keys(layout):
        aux[f"mr:f:{key}"] = torch.zeros(layout.n_fext, dtype=dtype,
                                         device=device)
        aux[f"mr:c:{key}"] = torch.zeros(layout.n_cext, dtype=dtype,
                                         device=device)
    for jn in _JNAMES:
        aux[f"mr:j:{jn}"] = torch.zeros(layout.n_fext, dtype=dtype,
                                        device=device)
    return aux


def patch_parts(aux, prefix):
    """The split parts of one patch solution (``prefix`` 'f' or 'c')."""
    tag = f"mr:{prefix}:"
    return {k[len(tag):]: v for k, v in aux.items() if k.startswith(tag)}


def _patch_totals(aux, layout, prefix):
    """comp -> the total field of a patch solution ('f' or 'c')."""
    terms = dict(layout._b_terms)
    terms.update(layout._e_terms)
    out = {}
    for comp, tl in terms.items():
        tot = aux[f"mr:{prefix}:{comp}:0"]
        for i in range(1, len(tl)):
            tot = tot + aux[f"mr:{prefix}:{comp}:{i}"]
        out[comp] = tot
    return out


def compute_aux1(farr0, aux, layout: MRLayout, staggering):
    """aux(1) = fp + I(aux(0) - cp) on the fine extended grid
    (UpdateAuxilaryDataSameType, WarpXComm.cpp:388)."""
    fp = _patch_totals(aux, layout, "f")
    cp = _patch_totals(aux, layout, "c")
    like = farr0["Ex"]
    win = layout.tables("window", (), like.device, like.dtype)
    out = {}
    for comp in _EB:
        interp = _take_window(farr0[comp], win) - cp[comp]
        for d, (idx, w) in enumerate(layout.tables(
                "interp", staggering[comp], like.device, like.dtype)):
            interp = _axis_apply(interp, d, idx, w)
        out[comp] = fp[comp] + interp
    return out


def coarsen_field(arr_f, flags, layout: MRLayout):
    """The staggering-aware average-down, fine extended -> coarse
    extended."""
    out = arr_f
    for d, (idx, w) in enumerate(layout.tables(
            "coarsen", flags, arr_f.device, arr_f.dtype,
            tuple(arr_f.shape))):
        out = _axis_apply(out, d, idx, w)
    return out


def to_nodal_torus(farr, staggering):
    """Momentum-conserving gathering: the staggered fields averaged to the
    nodes on a torus (UpdateAuxilaryDataStagToNodal, WarpXComm.cpp:94;
    two points, as the JAX package's MR averages)."""
    out = {}
    for nm, a in farr.items():
        for d, flag in enumerate(staggering[nm]):
            if flag == 0:
                a = 0.5 * (a + torch.roll(a, 1, d))
        out[nm] = a
    return out


def apply_nci_fine(farr, cfg, layout: MRLayout, dt_f):
    """The Godfrey corrector on the fine aux with the fine level's own
    c dt/dz (UpdateAuxilaryData filters each level)."""
    from ..solvers.filter import apply_z_stencil, nci_godfrey_stencil

    zax = cfg.geometry.ndim - 1
    cdtodz = _c * dt_f / layout.dxf[zax]
    nodal = cfg.field_gathering == "momentum-conserving"
    s1 = nci_godfrey_stencil(cdtodz, "ExEyBz", nodal)
    s2 = nci_godfrey_stencil(cdtodz, "BxByEz", nodal)
    out = dict(farr)
    for nm in ("Ex", "Ey", "Bz"):
        out[nm] = apply_z_stencil(out[nm], s1, zax)
    for nm in ("Bx", "By", "Ez"):
        out[nm] = apply_z_stencil(out[nm], s2, zax)
    return out


def select(mask):
    """The slots where ``mask`` holds (waits for the device)."""
    return torch.nonzero(mask).reshape(-1)


def gather_levels(e6, idx, pos, gather_fine):
    """``e6`` (level 0's fields at every particle) with the fine gather
    ``gather_fine`` put in at the slots ``idx``."""
    if idx.numel() == 0:
        return e6
    e6f = gather_fine([p[idx] for p in pos])
    return tuple(c.index_put((idx,), f) for c, f in zip(e6, e6f))


def deposit_slots(idx, pos, u3, w, q, geom, dt, order, out, **kw):
    """The Esirkepov J of the particles at the slots ``idx``, added into
    ``out``."""
    from ..ops.deposit import deposit_current_esirkepov

    if idx.numel() == 0:
        return out
    return deposit_current_esirkepov(
        [p[idx] for p in pos], *(a[idx] for a in u3), w[idx], q, geom, dt,
        order, out=out, **kw)


def add_patch_j(j0, jcp, layout, staggering, offsets=None):
    """AddCurrentFromFineLevelandSumBoundary: the restricted fine current
    added into level 0's J over the patch box (shifted by ``offsets`` on a
    padded block)."""
    out = []
    for a, b, nm in zip(j0, jcp, _JNAMES):
        dst, src = layout.patch_slices(staggering[nm], "c")
        if offsets is not None:
            dst = tuple(slice(s.start + o, s.stop + o)
                        for s, o in zip(dst, offsets))
        a = a.clone()
        a[dst] += b[src]
        out.append(a)
    return tuple(out)


def refine_spec_of(cfg, layout, sp_cfg):
    """``warpx.refine_plasma``'s injection spec (i0, i1, ratio, window
    axis) of a continuously injected species, None otherwise (the JAX
    package's ``simulation.py:916-922``)."""
    if (layout is None or not cfg.refine_plasma or cfg.max_level <= 0
            or not sp_cfg.do_continuous_injection):
        return None
    return (layout.i0, layout.i1, layout.rv, cfg.moving_window_dir)


def make_mr_step(cfg, staggering, dtype, device):
    """The two-level periodic PIC step (OneStep_nosub with the MR sync and
    aux plumbing, or OneStep_sub1 under subcycling) and its momentum half
    push.  Returns (step, half_push, layout)."""
    from ..ops.deposit import deposit_current_esirkepov
    from ..ops.gather import gather_eb
    from ..ops.push import PUSHERS, position_step
    from ..solvers import yee
    from .step import (_apply_nci, _field_dict, _filter, advance_fields,
                       nodal_staggering, wrap_positions)

    check_mr_supported(cfg)
    layout = MRLayout(cfg, staggering)
    geom = cfg.geometry
    ndim = geom.ndim
    dt = cfg.dt
    algo = cfg.em_solver
    order = cfg.particle_shape
    chunk = cfg.deposit_chunk_size
    sub = bool(cfg.do_subcycling)
    mc_gather = cfg.field_gathering == "momentum-conserving"
    gstag = nodal_staggering(ndim, staggering) if mc_gather else staggering
    # the fine level's step: dt / ref_ratio under subcycling (ComputeDt)
    dt_f = dt / layout.rv[0] if sub else dt
    bf, ef = make_patch_advance(layout, staggering, algo, 0.5 * dt_f, dt_f,
                                True, dtype, device)
    bc, ec = make_patch_advance(layout, staggering, algo,
                                dt_f if sub else 0.5 * dt,
                                dt_f if sub else dt, False, dtype, device)
    kw = dict(dtype=dtype, device=device)

    def adv_f(parts, j3):
        return bf(ef(bf(parts), j3))

    def adv_c(parts, j3):
        return bc(ec(bc(parts), j3))

    def gather_fields(state):
        """Level 0's and the fine aux's gather fields (NCI-corrected,
        averaged to the nodes under momentum-conserving gathering)."""
        farr0 = _field_dict(state.fields)
        aux1 = compute_aux1(farr0, state.aux, layout, staggering)
        if cfg.use_nci_corr:
            farr0 = _apply_nci(farr0, cfg)
            aux1 = apply_nci_fine(aux1, cfg, layout, dt_f)
        if mc_gather:
            farr0 = to_nodal_torus(farr0, staggering)
            aux1 = to_nodal_torus(aux1, staggering)
        return farr0, aux1

    def gather_both(pos, farr0, aux1, mask_g):
        e6 = gather_eb(pos, farr0, gstag, geom, order, cfg.galerkin)
        return gather_levels(
            e6, select(mask_g), pos,
            lambda p: gather_eb(p, aux1, gstag, layout.geom_f_ext, order,
                                cfg.galerkin))

    def zeros3(shape):
        return tuple(torch.zeros(shape, **kw) for _ in range(3))

    def filtered(j3):
        return tuple(_filter(a, cfg) for a in j3) if cfg.use_filter else j3

    def coarsened(jf):
        return tuple(coarsen_field(a, staggering[nm], layout)
                     for a, nm in zip(jf, _JNAMES))

    def with_parts(aux, parts_f, parts_c, jf=None):
        aux = dict(aux)
        aux.update({f"mr:f:{k}": v for k, v in parts_f.items()})
        aux.update({f"mr:c:{k}": v for k, v in parts_c.items()})
        if jf is not None:
            aux.update({f"mr:j:{nm}": a for nm, a in zip(_JNAMES, jf)})
        return aux

    def mr_step(state):
        farr0, aux1 = gather_fields(state)
        jf, j0 = zeros3(layout.n_fext), zeros3(geom.n_cell)
        new_species = {}
        for sp_cfg in cfg.species:
            sp = state.species[sp_cfg.name]
            if sp.capacity == 0:
                new_species[sp_cfg.name] = sp
                continue
            pos = sp.positions(ndim)
            mask_g = layout.fine_mask(pos, layout.gather_buf)
            mask_d = layout.fine_mask(pos, layout.dep_buf)
            if sp_cfg.do_not_gather:
                e6 = (torch.zeros_like(sp.ux),) * 6
            else:
                e6 = gather_both(pos, farr0, aux1, mask_g)
            if sp_cfg.do_not_push:
                ux, uy, uz = sp.ux, sp.uy, sp.uz
                new_pos = pos
            else:
                ux, uy, uz = PUSHERS[sp_cfg.pusher](
                    sp.ux, sp.uy, sp.uz, *e6, sp_cfg.charge, sp_cfg.mass, dt)
                new_pos = position_step(pos, ux, uy, uz, dt, ndim)
            if not sp_cfg.do_not_deposit:
                zero = torch.zeros_like(sp.w)
                w = torch.where(sp.alive, sp.w, zero)
                jf = deposit_slots(select(mask_d & sp.alive), new_pos,
                                   (ux, uy, uz), w, sp_cfg.charge,
                                   layout.geom_f_ext, dt, order, jf,
                                   chunk_size=chunk)
                j0 = deposit_current_esirkepov(
                    new_pos, ux, uy, uz, torch.where(mask_d, zero, w),
                    sp_cfg.charge, geom, dt, order, chunk_size=chunk,
                    out=j0)
            new_species[sp_cfg.name] = wrap_positions(
                sp.replace(ux=ux, uy=uy, uz=uz).with_positions(ndim,
                                                               new_pos),
                geom)
        # SyncCurrent: J_cp = average-down(J_fp), added raw into level 0's
        # J; the filters act per level afterwards
        jcp = coarsened(jf)
        j0 = add_patch_j(j0, jcp, layout, staggering)
        jf, jcp = filtered(jf), filtered(jcp)
        fields = advance_fields(state.fields, cfg, j0)
        parts_f = adv_f(patch_parts(state.aux, "f"), jf)
        parts_c = adv_c(patch_parts(state.aux, "c"), jcp)
        return state.replace(
            fields=fields, species=new_species, step=state.step + 1,
            time=state.time + dt,
            aux=with_parts(state.aux, parts_f, parts_c, jf))

    def lev0_half(fields, j3, first):
        """The half-coarse-step mother-grid advance of OneStep_sub1: [B,E]
        on the first half, [E,B] on the second
        (WarpXEvolve.cpp:936-946, :1022-1031)."""
        j3 = filtered(j3)
        fields = fields.replace(jx=j3[0], jy=j3[1], jz=j3[2])
        h = 0.5 * dt
        if first:
            fields = yee.evolve_b(fields, geom, h, algo)
            return yee.evolve_e(fields, geom, h, algo)
        fields = yee.evolve_e(fields, geom, h, algo)
        return yee.evolve_b(fields, geom, h, algo)

    def sub_deposit(pos, u3, w, lev, mask_d, q, jf, jb):
        """A fine substep's deposits over a dt_f trajectory: the patch J
        of the non-buffer fine-level particles, the level-0 buffer J of the
        deposition-buffer ones."""
        jf = deposit_slots(select(lev & mask_d), pos, u3, w, q,
                           layout.geom_f_ext, dt_f, order, jf,
                           chunk_size=chunk)
        jb = deposit_slots(select(lev & ~mask_d), pos, u3, w, q, geom, dt_f,
                           order, jb, chunk_size=chunk)
        return jf, jb

    def mr_step_sub(state):
        """OneStep_sub1 (WarpXEvolve.cpp:856): two fine substeps of dt/2
        around the split coarse advance; fine-level particles push twice
        by dt/2, level-0 particles once by dt; each mother-grid half step
        takes its own substep's restricted fine current."""
        # substep 1: gather at t^n, fine push dt/2, coarse push dt
        farr0, aux1 = gather_fields(state)
        jf1, jb1, j0 = (zeros3(layout.n_fext), zeros3(geom.n_cell),
                        zeros3(geom.n_cell))
        mid_species, lev_masks = {}, {}
        for sp_cfg in cfg.species:
            sp = state.species[sp_cfg.name]
            if sp.capacity == 0:
                mid_species[sp_cfg.name] = sp
                continue
            pos = sp.positions(ndim)
            lev = layout.fine_mask(pos, 0)
            lev_masks[sp_cfg.name] = lev
            mask_g = layout.fine_mask(pos, layout.gather_buf)
            mask_d = layout.fine_mask(pos, layout.dep_buf)
            if sp_cfg.do_not_gather:
                e6 = (torch.zeros_like(sp.ux),) * 6
            else:
                e6 = gather_both(pos, farr0, aux1, mask_g)
            if sp_cfg.do_not_push:
                ux, uy, uz = sp.ux, sp.uy, sp.uz
                new_pos = pos
            else:
                dt_p = torch.where(lev, torch.full((), dt_f, **kw),
                                   torch.full((), dt, **kw))
                ux, uy, uz = PUSHERS[sp_cfg.pusher](
                    sp.ux, sp.uy, sp.uz, *e6, sp_cfg.charge, sp_cfg.mass,
                    dt_p)
                new_pos = position_step(pos, ux, uy, uz, dt_p, ndim)
            if not sp_cfg.do_not_deposit:
                zero = torch.zeros_like(sp.w)
                w = torch.where(sp.alive, sp.w, zero)
                lev_a = lev & sp.alive
                jf1, jb1 = sub_deposit(new_pos, (ux, uy, uz), w, lev_a,
                                       mask_d, sp_cfg.charge, jf1, jb1)
                j0 = deposit_current_esirkepov(
                    new_pos, ux, uy, uz, torch.where(lev, zero, w),
                    sp_cfg.charge, geom, dt, order, chunk_size=chunk,
                    out=j0)
            mid_species[sp_cfg.name] = wrap_positions(
                sp.replace(ux=ux, uy=uy, uz=uz).with_positions(ndim,
                                                               new_pos),
                geom)
        jcp1 = coarsened(jf1)
        jf1, jcp1f = filtered(jf1), filtered(jcp1)
        # the fine patch's whole B/E/B step of dt/2, the coarse patch's
        # [B,E] leg and level 0's first half with J0 + buffer + cp
        parts_f = adv_f(patch_parts(state.aux, "f"), jf1)
        parts_c = ec(bc(patch_parts(state.aux, "c")), jcp1f)
        fields = lev0_half(
            state.fields,
            add_patch_j(tuple(a + b for a, b in zip(j0, jb1)), jcp1, layout,
                        staggering),
            first=True)

        # the aux at t^n + dt/2, then substep 2 for the fine level only
        mid = state.replace(fields=fields,
                            aux=with_parts(state.aux, parts_f, parts_c))
        farr_h, aux1b = gather_fields(mid)
        jf2, jb2 = zeros3(layout.n_fext), zeros3(geom.n_cell)
        new_species = {}
        for sp_cfg in cfg.species:
            sp = mid_species[sp_cfg.name]
            if sp.capacity == 0:
                new_species[sp_cfg.name] = sp
                continue
            lev = lev_masks[sp_cfg.name]
            pos = sp.positions(ndim)
            mask_d = layout.fine_mask(pos, layout.dep_buf)
            ux, uy, uz = sp.ux, sp.uy, sp.uz
            new_pos = pos
            if not sp_cfg.do_not_push:
                # only the fine-level particles move in this substep
                idx = select(lev)
                pl = [p[idx] for p in pos]
                if sp_cfg.do_not_gather:
                    e6 = (torch.zeros_like(pl[0]),) * 6
                else:
                    e6 = gather_both(
                        pl, farr_h, aux1b,
                        layout.fine_mask(pl, layout.gather_buf))
                u2 = PUSHERS[sp_cfg.pusher](
                    ux[idx], uy[idx], uz[idx], *e6, sp_cfg.charge,
                    sp_cfg.mass, dt_f)
                p2 = position_step(pl, *u2, dt_f, ndim)
                ux, uy, uz = (a.index_put((idx,), b)
                              for a, b in zip((ux, uy, uz), u2))
                new_pos = tuple(a.index_put((idx,), b)
                                for a, b in zip(pos, p2))
            if not sp_cfg.do_not_deposit:
                w = torch.where(sp.alive, sp.w, torch.zeros_like(sp.w))
                jf2, jb2 = sub_deposit(new_pos, (ux, uy, uz), w,
                                       lev & sp.alive, mask_d,
                                       sp_cfg.charge, jf2, jb2)
            new_species[sp_cfg.name] = wrap_positions(
                sp.replace(ux=ux, uy=uy, uz=uz).with_positions(ndim,
                                                               new_pos),
                geom)
        jcp2 = coarsened(jf2)
        jf2, jcp2f = filtered(jf2), filtered(jcp2)
        parts_f = adv_f(parts_f, jf2)
        parts_c = bc(ec(parts_c, jcp2f))
        fields = lev0_half(
            fields,
            add_patch_j(tuple(a + b for a, b in zip(j0, jb2)), jcp2, layout,
                        staggering),
            first=False)
        return state.replace(
            fields=fields, species=new_species, step=state.step + 1,
            time=state.time + dt,
            aux=with_parts(state.aux, parts_f, parts_c, jf2))

    def mr_half_push(state, dt_half):
        """PushP with the MR gather (the synchronizations around the
        loop); under subcycling each level by half its own dt."""
        farr0, aux1 = gather_fields(state)
        new_species = {}
        for sp_cfg in cfg.species:
            sp = state.species[sp_cfg.name]
            if (sp_cfg.do_not_push or sp.capacity == 0
                    or sp_cfg.mass == 0.0):
                new_species[sp_cfg.name] = sp
                continue
            pos = sp.positions(ndim)
            e6 = gather_both(pos, farr0, aux1,
                             layout.fine_mask(pos, layout.gather_buf))
            dt_p = dt_half
            if sub:
                dt_p = torch.where(layout.fine_mask(pos, 0),
                                   torch.full((), dt_half / layout.rv[0],
                                              **kw),
                                   torch.full((), dt_half, **kw))
            ux, uy, uz = PUSHERS[sp_cfg.pusher](
                sp.ux, sp.uy, sp.uz, *e6, sp_cfg.charge, sp_cfg.mass, dt_p)
            new_species[sp_cfg.name] = sp.replace(ux=ux, uy=uy, uz=uz)
        return state.replace(species=new_species)

    return (mr_step_sub if sub else mr_step), mr_half_push, layout


def mr_output_fields(state, cfg, staggering, layout: MRLayout, farr0=None):
    """The lev=1 diagnostics of the reference's checksum convention: a yt
    ``covering_grid(level=1, left_edge=patch_lo, dims=n_cell(0))``
    (Regression/Checksum/checksum.py:110), a fine window of n_cell(0) cells
    at the patch's corner filled with level 0's data beyond the patch; the
    fine data are the aux fields and the fine current, cell-centered
    (FullDiagnostics.cpp CellCenterFunctor on Efield_aux[lev]); rho is the
    fine deposit of the particles deep in the patch.  Host arrays."""
    from ..diagnostics.fields import cell_center, deposit_total_rho
    from ..ops.deposit import deposit_rho
    from .step import _field_dict

    if farr0 is None:
        farr0 = _field_dict(state.fields)
        farr0.update(jx=state.fields.jx, jy=state.fields.jy,
                     jz=state.fields.jz)
        if farr0["Ex"].shape[0] != layout.n0[0]:
            # bounded level-0 arrays carry PML strips and nodal tops: crop
            # to the plain domain frame of the covering-grid tables
            from .domain import DomainLayout

            lay = DomainLayout.from_config(cfg)
            farr0 = {nm: arr[tuple(
                slice(lay.ext_lo(d), lay.ext_lo(d) + layout.n0[d])
                for d in range(layout.ndim))]
                for nm, arr in farr0.items()}
    aux1 = compute_aux1(farr0, state.aux, layout, staggering)
    ndim, n0, nf = layout.ndim, layout.n0, layout.nf
    grids = np.meshgrid(*[np.arange(n0[d]) for d in range(ndim)],
                        indexing="ij")
    valid = np.ones([n0[d] for d in range(ndim)], bool)
    for d, g in enumerate(grids):
        valid &= g < nf[d]
    f_idx = tuple(np.clip(g, 0, nf[d] - 1) for d, g in enumerate(grids))
    c_idx = tuple(((layout.i0[d] * layout.rv[d] + g) // layout.rv[d])
                  % n0[d] for d, g in enumerate(grids))

    def host(t):
        return t.detach().cpu().numpy()

    def covering(fine_cc, coarse_cc):
        return np.where(valid, host(fine_cc)[f_idx], host(coarse_cc)[c_idx])

    out = {}
    for comp in _EB:
        flags = staggering[comp]
        _dst, src = layout.patch_slices(flags, "f")
        out[comp] = covering(cell_center(aux1[comp][src], flags, nf),
                             cell_center(farr0[comp], flags, n0))
    for nm in _JNAMES:
        flags = staggering[nm]
        _dst, src = layout.patch_slices(flags, "f")
        out[nm] = covering(
            cell_center(state.aux[f"mr:j:{nm}"][src], flags, nf),
            cell_center(farr0[nm], flags, n0))

    # rho: the fine deposit of the deep-patch particles (the fine level's
    # own particles in the reference's per-level RhoFunctor), level 0's
    # diagnostic rho beyond the patch
    origin_f = list(layout.geom_f_ext.prob_lo)
    patch_lo = list(layout.patch_lo)
    if cfg.do_moving_window and "window_lo" in state.aux:
        wd = cfg.moving_window_dir
        ws = state.aux["window_lo"] - cfg.geometry.prob_lo[wd]
        origin_f[wd] = origin_f[wd] + ws
        patch_lo[wd] = patch_lo[wd] + ws
    like = state.fields.Ex
    rho_f = torch.zeros(layout.n_fext, dtype=like.dtype, device=like.device)
    for sp_cfg in cfg.species:
        sp = state.species[sp_cfg.name]
        if sp.capacity == 0 or sp_cfg.do_not_deposit:
            continue
        pos = sp.positions(ndim)
        mask = sp.alive & layout.fine_mask(pos, layout.dep_buf, patch_lo)
        rho_f = deposit_rho(pos, torch.where(mask, sp.w,
                                             torch.zeros_like(sp.w)),
                            sp_cfg.charge, layout.geom_f_ext,
                            cfg.particle_shape, out=rho_f, origin=origin_f,
                            chunk_size=cfg.deposit_chunk_size)
    nodal = (1,) * ndim
    _dst, src = layout.patch_slices(nodal, "f")
    out["rho"] = covering(cell_center(rho_f[src], nodal, nf),
                          cell_center(deposit_total_rho(state, cfg), nodal,
                                      n0))
    return out
