"""Checksums: sum(|Q|) per cell-centered field and per particle quantity.

The counterpart of ``warpx_tpu.diagnostics.checksum`` (reference:
Regression/Checksum/checksum.py, ``np.sum(np.abs(Q))``; tolerances
checksumAPI.py:38-46): ``compute_checksums`` from the state (sums taken in
float64 whatever the state's dtype), ``checksums_from_plotfile`` and
``checksums_from_openpmd`` from written files, as the reference's harness
reads them, and ``compare_checksums`` against a golden JSON file.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from ..core.config import SimConfig
from ..core.state import SimState
from .fields import cell_centered_output

__all__ = ["compute_checksums", "compare_checksums", "checksums_from_openpmd",
           "checksums_from_plotfile"]


def _abs_sum(t) -> float:
    return float(t.double().abs().sum())


def compute_checksums(state: SimState, cfg: SimConfig, staggering: Dict,
                      psatd=None, mr_layout=None
                      ) -> Dict[str, Dict[str, float]]:
    """Checksums of the state; ``psatd`` (the periodic spectral solver)
    makes divE spectral, as in the JAX package; with ``mr_layout`` (the
    refined patch's ``core/mr.py::MRLayout``) the lev=1 sums of the
    covering grid (``mr_output_fields``)."""
    fields = cell_centered_output(state, cfg, staggering, psatd=psatd)
    data = {"lev=0": {name: _abs_sum(arr) for name, arr in fields.items()}}
    if mr_layout is not None:
        from ..core.mr import mr_output_fields

        lev1 = mr_output_fields(state, cfg, staggering, mr_layout)
        data["lev=1"] = {name: float(np.sum(np.abs(arr)))
                         for name, arr in lev1.items()}
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
        for aname, arr in sp.extra.items():
            entry[f"particle_{aname}"] = _abs_sum(arr[alive].double())
        data[sp_cfg.name] = entry
    return data


def compare_checksums(
    computed: Dict[str, Dict[str, float]],
    golden_path: str,
    rtol: float = 1e-9,
    atol: float = 1e-40,
) -> Dict[str, float]:
    """Compare against a reference benchmarks_json file: only the keys of
    the golden file (the reference writes a deck-selected subset).  Returns
    {key: relative error}; raises AssertionError listing the entries beyond
    tolerance."""
    with open(golden_path) as fh:
        golden = json.load(fh)
    rel_errors: Dict[str, float] = {}
    failures = []
    for group, entries in golden.items():
        for key, ref_val in entries.items():
            if group not in computed or key not in computed[group]:
                failures.append(f"missing {group}/{key}")
                continue
            val = computed[group][key]
            rel = abs(val - ref_val) / max(abs(ref_val), atol)
            rel_errors[f"{group}/{key}"] = rel
            if not (abs(val - ref_val) <= atol + rtol * abs(ref_val)):
                failures.append(
                    f"{group}/{key}: computed {val:.12e} vs golden "
                    f"{ref_val:.12e} (rel {rel:.3e})"
                )
    if failures:
        raise AssertionError("checksum mismatches:\n  "
                             + "\n  ".join(failures))
    return rel_errors


def checksums_from_openpmd(filename: str, iteration: int):
    """Reference-style checksums of one iteration of a written openPMD file
    (Regression/Checksum/checksum.py:61-116: sum(abs(Q)) per cell-centered
    field component and per particle quantity, positions named in the
    active-axis order)."""
    from ..io.openpmd import _h5py

    h5py = _h5py()
    out = {"lev=0": {}}
    with h5py.File(filename, "r") as fh:
        it = fh[f"data/{iteration}"]
        meshes = it["fields"]
        for rec in meshes:
            obj = meshes[rec]
            if isinstance(obj, h5py.Dataset):
                out["lev=0"][rec] = float(np.abs(obj[...]).sum())
            else:
                for comp in obj:
                    key = (rec.lower() if rec == "J" else rec) + comp
                    out["lev=0"][key] = float(np.abs(obj[comp][...]).sum())
        for sp in it.get("particles", {}):
            grp = it["particles"][sp]
            d = {}
            names = [n for n in ("x", "y", "z") if n in grp["position"]]
            for i, nm in enumerate(names):
                d[f"particle_position_{'xyz'[i]}"] = float(
                    np.abs(grp["position"][nm][...]).sum())
            for nm in ("x", "y", "z"):
                d[f"particle_momentum_{nm}"] = float(
                    np.abs(grp["momentum"][nm][...]).sum())
            d["particle_weight"] = float(
                np.abs(grp["weighting/value"][...]).sum())
            out[sp] = d
    return out


def checksums_from_plotfile(path: str):
    """Reference-style checksums of a written AMReX plotfile (the analog of
    Regression/Checksum/checksum.py reading plotfiles through yt: sum(abs(Q))
    per level component and particle quantity)."""
    from ..io.plotfile import read_particles, read_plotfile

    levels, _ = read_plotfile(path)
    out = {}
    for lev, comps in enumerate(levels):
        out[f"lev={lev}"] = {
            name: float(np.abs(arr).sum()) for name, arr in comps.items()
        }
    for entry in sorted(os.listdir(path)):
        if not os.path.isdir(os.path.join(path, entry)) or \
                entry.startswith("Level_"):
            continue
        attrs = read_particles(path, entry)
        d = {}
        for nm in ("x", "y", "z"):
            if nm in attrs:
                d[f"particle_position_{nm}"] = float(np.abs(attrs[nm]).sum())
            if f"momentum_{nm}" in attrs:
                d[f"particle_momentum_{nm}"] = float(
                    np.abs(attrs[f"momentum_{nm}"]).sum())
        if "weight" in attrs:
            d["particle_weight"] = float(np.abs(attrs["weight"]).sum())
        out[entry] = d
    return out
