"""Back-transformed diagnostics (BTD): lab-frame snapshots of a boosted run.

The counterpart of ``warpx_tpu.diagnostics.btd.BTDSnapshots`` (reference:
Source/Diagnostics/BTDiagnostics.cpp, ComputeDiagFunctors/
BackTransformFunctor.cpp).  For each lab-frame time t_lab,i = i *
dt_snapshots_lab the snapshot plane sits at

  z_boost(t) = (t_lab/gamma - t) c / beta      (BTDiagnostics.H:278)
  z_lab(t)   = (t_lab - t/gamma) c / beta      (BTDiagnostics.H:287)

and sweeps backward through the boosted domain as the run advances; each
time it crosses a new lab cell (dz_lab = c dt / (beta gamma),
BTDiagnostics.cpp:886) the cell-centered slice at z_boost is
back-transformed (LorentzTransformZ: Ex<->By, Ey<->Bx, jz<->rho; Ez, Bz,
jx, jy invariant) into row k_lab of the snapshot.

The plane's position is computed on the host from the state's host time and
window edges; the slice (``cell_centered_slice``: rho from the particles
near the plane only) is transformed on the device in the state's precision
with Python-float gamma and beta, as the JAX package transforms its host
arrays, and stays there, one row tensor per filled lab cell.  So a step
that fills a row waits for the device no more than one that does not; a
snapshot's rows are copied to the host once, when its plane leaves the
domain and it is written as ``<name>_snapshot<i:05d>.npz`` (float64 arrays
of the whole lab extent, zero in the rows not filled: the JAX package's
keys and layout), or when a caller reads it.  As in the JAX package, ``Simulation.evolve``
never calls ``finalize``: a snapshot whose plane is still inside the domain
when the run ends is written only by an explicit ``finalize()``.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from ..constants import c as _c
from .fields import cell_centered_slice, slab_reach

__all__ = ["BTDSnapshots", "BTD_FIELDS", "back_transform"]

# the fields LorentzTransformZ yields; the slice inputs each one needs
BTD_FIELDS = {
    "Ex": ("Ex", "By"), "By": ("By", "Ex"), "Ey": ("Ey", "Bx"),
    "Bx": ("Bx", "Ey"), "Ez": ("Ez",), "Bz": ("Bz",), "jx": ("jx",),
    "jy": ("jy",), "jz": ("jz", "rho"), "rho": ("rho", "jz"),
}


def back_transform(raw: Dict, gamma: float, beta: float) -> Dict:
    """LorentzTransformZ (BackTransformFunctor.cpp:280-320, Cartesian) of
    the cell-centered boosted-frame values ``raw`` (arrays or tensors) to
    the lab frame, for the fields whose inputs ``raw`` holds."""
    g, b = gamma, beta
    out = {}
    ex, ey = raw.get("Ex"), raw.get("Ey")
    bx, by = raw.get("Bx"), raw.get("By")
    jz, rho = raw.get("jz"), raw.get("rho")
    if ex is not None and by is not None:
        out["Ex"] = g * (ex + b * _c * by)
        out["By"] = g * (by + b / _c * ex)
    if ey is not None and bx is not None:
        out["Ey"] = g * (ey - b * _c * bx)
        out["Bx"] = g * (bx - b / _c * ey)
    if jz is not None and rho is not None:
        out["jz"] = g * (jz + b * _c * rho)
        out["rho"] = g * (rho + b / _c * jz)
    for nm in ("Ez", "Bz", "jx", "jy"):
        if raw.get(nm) is not None:
            out[nm] = raw[nm]
    return out


class BTDSnapshots:
    """``num_snapshots`` lab-frame snapshots ``dt_snapshots_lab`` apart of
    ``fields`` (names of ``BTD_FIELDS``), written under ``output_dir``."""

    def __init__(self, name, cfg, num_snapshots, dt_snapshots_lab, fields,
                 output_dir):
        unknown = [f for f in fields if f not in BTD_FIELDS]
        if unknown:
            raise ValueError(f"{name}.fields_to_plot: {unknown} are not "
                             f"back-transformed fields {list(BTD_FIELDS)}")
        if cfg.gamma_boost <= 1.0:
            raise ValueError(f"{name}: back-transformed diagnostics need "
                             "warpx.gamma_boost > 1")
        self.name = name
        self.cfg = cfg
        self.fields = list(fields)
        self.gamma = cfg.gamma_boost
        self.beta = float(np.sqrt(1.0 - 1.0 / self.gamma**2))
        self.dt_lab = dt_snapshots_lab
        self.num = num_snapshots
        self.output_dir = output_dir
        geom = cfg.geometry
        self.zdir = geom.ndim - 1
        self.dz_lab = _c * cfg.dt / (self.beta * self.gamma)
        # the lab extent: the boosted length with the moving window's
        # contraction (BTDiagnostics.cpp:142)
        vw_beta = cfg.moving_window_v if cfg.do_moving_window else 0.0
        lz_lab = ((geom.prob_hi[self.zdir] - geom.prob_lo[self.zdir])
                  * self.gamma * (1.0 - self.beta * vw_beta))
        self.nz_lab = max(int(np.floor(lz_lab / self.dz_lab)), 1)
        self.trans_shape = tuple(geom.n_cell[d] for d in range(geom.ndim)
                                 if d != self.zdir)
        self.t_lab = [i * dt_snapshots_lab for i in range(num_snapshots)]
        # each snapshot's lab domain: zmin_boost/gamma + v_w t_lab
        self.zmin_lab = [geom.prob_lo[self.zdir] / self.gamma
                         + vw_beta * _c * tl for tl in self.t_lab]
        self.filled = [np.zeros(self.nz_lab, bool)
                       for _ in range(num_snapshots)]
        self.done = [False] * num_snapshots
        # each snapshot's filled rows on the device: (k_lab, (fields,
        # transverse...) tensor)
        self._rows: List[list] = [[] for _ in range(num_snapshots)]
        # the needed slice inputs
        self._inputs = sorted({nm for f in self.fields
                               for nm in BTD_FIELDS[f]})
        # device counts of rho's slab selection without room
        self.slab_overflow: List[torch.Tensor] = []

    # ------------------------------------------------------------------
    def plane(self, i, t):
        """(z_boost, z_lab) of snapshot ``i``'s plane at boosted time t."""
        z_boost = (self.t_lab[i] / self.gamma - t) * _c / self.beta
        z_lab = (self.t_lab[i] - t / self.gamma) * _c / self.beta
        return z_boost, z_lab

    def update(self, sim):
        """Fill the rows whose plane crossed a new lab cell at the current
        boosted time (once per step, after the step's outputs)."""
        state = sim.state
        geom = self.cfg.geometry
        t = float(state.time)
        # the boosted domain along z now (the moving window shifts it)
        z_lo = float(state.aux.get("window_lo", geom.prob_lo[self.zdir]))
        z_hi = float(state.aux.get("window_hi", geom.prob_hi[self.zdir]))
        dz = geom.dx[self.zdir]
        for i in range(self.num):
            if self.done[i]:
                continue
            z_boost, z_lab = self.plane(i, t)
            if not (z_lo <= z_boost < z_hi):
                if z_boost < z_lo and self.filled[i].any():
                    self._flush(i)
                    self.done[i] = True
                continue
            k_lab = int(np.floor((z_lab - self.zmin_lab[i]) / self.dz_lab))
            if k_lab < 0 or k_lab >= self.nz_lab or self.filled[i][k_lab]:
                continue
            k_boost = int(np.floor((z_boost - z_lo) / dz))
            k_boost = min(max(k_boost, 0), geom.n_cell[self.zdir] - 1)
            raw = cell_centered_slice(state, self.cfg, sim.staggering,
                                      self._inputs, k_boost,
                                      self.slab_overflow,
                                      self.slab_plan(sim, k_boost))
            lab = back_transform(raw, self.gamma, self.beta)
            self._rows[i].append(
                (k_lab, torch.stack([lab[f] for f in self.fields])))
            self.filled[i][k_lab] = True

    def slab_plan(self, sim, k, injected=None) -> Dict[str, tuple]:
        """Which slots of each tile-binned species can hold a particle
        within ``slab_reach`` cells of plane ``k`` (for
        ``cell_centered_slice``).  Between rebins a particle stays within
        the rebin margin of its tile (or the violation count says so), so
        the slots of the tiles that reach the slab hold them all
        (``("slots", idx)``) -- but on a step that injected plasma (the step
        before a rebin; ``injected`` overrides) the new particles wait in
        dead slots anywhere, and the species selects its particles near the
        plane (``("room", cap)``: those tiles' slots and one injection
        band).  Other species deposit whole."""
        spec = sim.tile_spec
        if not sim.binned or spec is None or not sim.is_bounded:
            return {}
        st = sim.stepper
        state = sim.state
        geom = self.cfg.geometry
        dz = geom.dx[-1]
        if injected is None:
            injected = state.step % spec.interval == 0
        reach = slab_reach(self.cfg)
        # the slab in the tiles' frame, anchored where the window stood at
        # the last rebin
        shift = int(np.round((float(state.aux["window_lo"])
                              - float(state.aux["tile_anchor"])) / dz))
        lo = k - reach + shift - spec.margin - 1
        hi = k + 1 + reach + shift + spec.margin + 1
        ntz = spec.tiles_per_dim[-1]
        tz0 = min(max(lo // spec.tile[-1], 0), ntz - 1)
        tz1 = min(max(hi // spec.tile[-1], 0), ntz - 1)
        slots = self._tile_slots(spec, tz0, tz1, state.fields.Ex.device)
        plan = {}
        for sp in st.binned_cfgs:
            if injected and sp.do_continuous_injection:
                ppc = int(np.prod(sp.num_particles_per_cell_each_dim or (1,)))
                band = (max(st.max_shift * (spec.interval + 2), 4)
                        * int(np.prod(geom.n_cell[:-1])) * ppc)
                plan[sp.name] = ("room", slots.numel() + band)
            else:
                plan[sp.name] = ("slots", slots)
        return plan

    def _tile_slots(self, spec, tz0, tz1, device):
        """The slots of the tiles whose last index lies in [tz0, tz1], in
        slot order (cached)."""
        key = (tz0, tz1)
        if getattr(self, "_slots_key", None) != key:
            ntz = spec.tiles_per_dim[-1]
            cross = int(np.prod(spec.tiles_per_dim[:-1]))
            tiles = (torch.arange(cross, device=device)[:, None] * ntz
                     + torch.arange(tz0, tz1 + 1, device=device)[None, :])
            self._slots = (tiles.reshape(-1, 1) * spec.p_max
                           + torch.arange(spec.p_max, device=device)
                           ).reshape(-1)
            self._slots_key = key
        return self._slots

    # ------------------------------------------------------------------
    def check_overflow(self):
        """Raise if rho's slab selection ran out of room (a device read)."""
        if self.slab_overflow:
            n = int(sum(int(o) for o in self.slab_overflow))
            self.slab_overflow = [] if n == 0 else self.slab_overflow
            if n:
                raise RuntimeError(
                    f"{self.name}: {n} particles near a back-transformed "
                    "plane found no room in rho's slab selection")

    def rows(self, i):
        """Snapshot ``i``'s filled rows: (k_lab list, device tensor
        (rows, fields, transverse...)), or ([], None)."""
        if not self._rows[i]:
            return [], None
        ks, rows = zip(*self._rows[i])
        return list(ks), torch.stack(rows)

    def data(self, i) -> np.ndarray:
        """Snapshot ``i`` as the JAX package holds it: a float64 array
        (fields, transverse..., nz_lab), zero in the unfilled rows."""
        out = np.zeros((len(self.fields),) + self.trans_shape
                       + (self.nz_lab,))
        ks, rows = self.rows(i)
        if ks:
            out[..., ks] = np.moveaxis(rows.cpu().numpy(), 0, -1)
        return out

    def _flush(self, i):
        self.check_overflow()
        data = self.data(i)
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir, f"{self.name}_snapshot{i:05d}.npz")
        np.savez(path, t_lab=self.t_lab[i], zmin_lab=self.zmin_lab[i],
                 dz_lab=self.dz_lab, filled=self.filled[i],
                 **{nm: data[fi] for fi, nm in enumerate(self.fields)})
        self._rows[i] = []

    def finalize(self):
        """Write every snapshot not yet written that has a row."""
        for i in range(self.num):
            if not self.done[i] and self.filled[i].any():
                self._flush(i)
                self.done[i] = True

    def snapshot(self, i) -> Dict[str, np.ndarray]:
        """Snapshot ``i``'s fields by name (float64, host)."""
        if self.done[i]:
            path = os.path.join(self.output_dir,
                                f"{self.name}_snapshot{i:05d}.npz")
            with np.load(path) as z:
                return {nm: z[nm] for nm in self.fields}
        data = self.data(i)
        return {nm: data[fi] for fi, nm in enumerate(self.fields)}

    def z_lab_centers(self, i) -> np.ndarray:
        return self.zmin_lab[i] + (np.arange(self.nz_lab) + 0.5) \
            * self.dz_lab
