"""Field diagnostics: cell-centered output arrays (periodic, staggered).

The counterpart of ``warpx_tpu.diagnostics.fields`` for the periodic,
staggered, electromagnetic case: every staggered field is interpolated to
cell centers as the reference's full diagnostics do (CellCenterFunctor ->
ablastr::coarsen::sample::Interp: the value at cell i averages the two
surrounding points along every nodal dimension).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.config import SimConfig
from ..core.state import SimState
from ..ops.deposit import count_particles_per_cell, deposit_rho
from ..solvers import yee
from ..solvers.filter import bilinear_filter

__all__ = ["cell_center", "cell_centered_output", "deposit_total_rho"]


def cell_center(arr: torch.Tensor, nodal_flags) -> torch.Tensor:
    """Average the nodal dims of a periodic array to cell centers."""
    out = arr
    for d, flag in enumerate(nodal_flags):
        if flag == 1:
            out = 0.5 * (out + torch.roll(out, -1, dims=d))
    return out


def deposit_total_rho(state: SimState, cfg: SimConfig) -> torch.Tensor:
    """Nodal charge density summed over species at the current positions
    (RhoFunctor -> GetChargeDensity, periodic fold), smoothed like J when
    the current filter is on."""
    geom = cfg.geometry
    f = state.fields.Ex
    rho = torch.zeros(geom.n_cell, dtype=f.dtype, device=f.device)
    for sp_cfg in cfg.species:
        sp = state.species[sp_cfg.name]
        if sp.capacity == 0 or sp_cfg.do_not_deposit:
            continue
        w_eff = torch.where(sp.alive, sp.w, torch.zeros_like(sp.w))
        rho = deposit_rho(sp.positions(geom.ndim), w_eff, sp_cfg.charge,
                          geom, cfg.particle_shape, out=rho)
    if cfg.use_filter:
        rho = bilinear_filter(
            rho, cfg.filter_npass_each_dir or (1,) * geom.ndim)
    return rho


def cell_centered_output(state: SimState, cfg: SimConfig,
                         staggering: Dict) -> Dict[str, torch.Tensor]:
    """E, B, j, rho, divE, divB and part_per_cell at cell centers."""
    geom = cfg.geometry
    if cfg.field_gathering == "momentum-conserving":
        raise NotImplementedError(
            "momentum-conserving diagnostics (ROADMAP.md Queue A 13)"
        )
    f = state.fields
    out = {}
    for name in ("Ex", "Ey", "Ez", "Bx", "By", "Bz", "jx", "jy", "jz"):
        out[name] = cell_center(getattr(f, name), staggering[name])
    out["rho"] = cell_center(deposit_total_rho(state, cfg),
                             staggering["rho"])
    out["divE"] = cell_center(yee.compute_div_e(f, geom), (1,) * geom.ndim)
    out["divB"] = yee.compute_div_b(f, geom)
    ppc = torch.zeros(geom.n_cell, dtype=f.Ex.dtype, device=f.Ex.device)
    for sp_cfg in cfg.species:
        sp = state.species[sp_cfg.name]
        if sp.capacity:
            ppc = ppc + count_particles_per_cell(
                sp.positions(geom.ndim), sp.alive, geom
            )
    out["part_per_cell"] = ppc
    return out
