"""Checksums: sum(|Q|) per cell-centered field and per particle quantity.

The counterpart of ``warpx_tpu.diagnostics.checksum.compute_checksums``
(reference: Regression/Checksum/checksum.py, ``np.sum(np.abs(Q))``).  Sums
are taken in float64 whatever the state's dtype.
"""

from __future__ import annotations

from typing import Dict

from ..core.config import SimConfig
from ..core.state import SimState
from .fields import cell_centered_output

__all__ = ["compute_checksums"]


def _abs_sum(t) -> float:
    return float(t.double().abs().sum())


def compute_checksums(state: SimState, cfg: SimConfig,
                      staggering: Dict) -> Dict[str, Dict[str, float]]:
    fields = cell_centered_output(state, cfg, staggering)
    data = {"lev=0": {name: _abs_sum(arr) for name, arr in fields.items()}}
    ndim = cfg.geometry.ndim
    pos_names = {1: ["x"], 2: ["x", "y"], 3: ["x", "y", "z"]}[ndim]
    for sp_cfg in cfg.species:
        sp = state.species[sp_cfg.name]
        if sp.capacity == 0:
            continue
        alive = sp.alive
        entry = {}
        for nm, arr in zip(pos_names, sp.positions(ndim)):
            entry[f"particle_position_{nm}"] = _abs_sum(arr[alive])
        for nm, arr in (("x", sp.ux), ("y", sp.uy), ("z", sp.uz)):
            entry[f"particle_momentum_{nm}"] = _abs_sum(
                sp_cfg.mass * arr[alive].double()
            )
        entry["particle_weight"] = _abs_sum(sp.w[alive])
        data[sp_cfg.name] = entry
    return data
