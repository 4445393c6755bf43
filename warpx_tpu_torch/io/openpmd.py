"""openPMD-standard HDF5 output written directly with h5py.

The counterpart of ``warpx_tpu.io.openpmd`` (reference:
Source/Diagnostics/WarpXOpenPMD.cpp, FlushFormats/FlushFormatOpenPMD.cpp):
the same openPMD 1.1.0 file layout (basePath/meshesPath/particlesPath,
unitDimension/unitSI/gridSpacing/position attributes), so openPMD-viewer and
the reference's checksumAPI read it unchanged.

The particle columns are compacted where they live: one ``nonzero`` of the
output mask on the state's device, then one gather and one transfer to the
host a column (the JAX package gathers on the host with its C++
compactor).  ``h5py`` is imported when a file is written or read; without
it the writer and the readers raise ``ImportError``, they never skip a
write.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..core.config import SimConfig
from ..core.state import SimState

__all__ = ["write_openpmd_iteration", "read_openpmd_particles",
           "read_openpmd_mesh", "compact_columns"]

# unitDimension: powers of (L, M, T, I, theta, N, J)
_UNIT_DIM = {
    "E": (1.0, 1.0, -3.0, -1.0, 0.0, 0.0, 0.0),
    "B": (0.0, 1.0, -2.0, -1.0, 0.0, 0.0, 0.0),
    "j": (-2.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0),
    "rho": (-3.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0),
}


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("openPMD output needs the h5py package, which is "
                          "not installed") from e
    return h5py


def _axis_labels(ndim: int):
    return {1: ["z"], 2: ["x", "z"], 3: ["x", "y", "z"]}[ndim]


def compact_columns(mask: torch.Tensor, columns):
    """The entries of each 1D tensor of ``columns`` where ``mask`` holds, as
    host numpy arrays in the tensors' dtype: the mask's ``nonzero`` on its
    device (the one wait), then a gather and a transfer a column."""
    idx = torch.nonzero(mask).squeeze(1)
    return [c.index_select(0, idx).cpu().numpy() for c in columns]


def host(arr) -> np.ndarray:
    """A tensor (or array) as a host numpy array."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def write_openpmd_iteration(
    filename: str,
    iteration: int,
    state: SimState,
    cfg: SimConfig,
    fields: Dict[str, torch.Tensor],
    time: float,
    dt: float,
    origin,
    species_names=None,
    select=None,
):
    """Append one iteration (fields + particles) in openPMD layout;
    ``select`` maps a species to a bool tensor that narrows its alive
    mask."""
    h5py = _h5py()
    geom = cfg.geometry
    ndim = geom.ndim
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with h5py.File(filename, "a") as fh:
        fh.attrs["openPMD"] = np.bytes_("1.1.0")
        fh.attrs["openPMDextension"] = np.uint32(0)
        fh.attrs["basePath"] = np.bytes_("/data/%T/")
        fh.attrs["meshesPath"] = np.bytes_("fields/")
        fh.attrs["particlesPath"] = np.bytes_("particles/")
        fh.attrs["software"] = np.bytes_("warpx_tpu_torch")
        fh.attrs["iterationEncoding"] = np.bytes_("groupBased")
        fh.attrs["iterationFormat"] = np.bytes_("/data/%T/")

        it = fh.require_group(f"data/{iteration}")
        it.attrs["time"] = float(time)
        it.attrs["dt"] = float(dt)
        it.attrs["timeUnitSI"] = 1.0

        meshes = it.require_group("fields")
        labels = _axis_labels(ndim)

        def mesh_attrs(obj, kind):
            obj.attrs["geometry"] = np.bytes_("cartesian")
            obj.attrs["dataOrder"] = np.bytes_("C")
            obj.attrs["axisLabels"] = np.array([np.bytes_(a) for a in labels])
            obj.attrs["gridSpacing"] = np.asarray(geom.dx, dtype=np.float64)
            obj.attrs["gridGlobalOffset"] = np.asarray(
                [float(o) for o in origin], dtype=np.float64)
            obj.attrs["gridUnitSI"] = 1.0
            obj.attrs["timeOffset"] = 0.0
            obj.attrs["unitDimension"] = np.asarray(
                _UNIT_DIM.get(kind, (0.0,) * 7), dtype=np.float64
            )

        for name, arr in fields.items():
            data = host(arr)
            if len(name) == 2 and name[0] in "EBj":
                rec = meshes.require_group(name[0])
                mesh_attrs(rec, name[0])
                comp = name[1]
                if comp in rec:
                    del rec[comp]
                ds = rec.create_dataset(comp, data=data)
            else:
                # scalar mesh record: the record itself is the dataset
                if name in meshes:
                    del meshes[name]
                ds = meshes.create_dataset(name, data=data)
                mesh_attrs(ds, name)
            ds.attrs["unitSI"] = 1.0
            ds.attrs["position"] = np.full(ndim, 0.5)

        parts = it.require_group("particles")
        for sp_cfg in cfg.species:
            sp = state.species[sp_cfg.name]
            if sp.capacity == 0:
                continue
            if species_names is not None and sp_cfg.name not in species_names:
                continue
            mask = sp.alive
            if select is not None and sp_cfg.name in select:
                mask = mask & select[sp_cfg.name]
            grp = parts.require_group(sp_cfg.name)
            grp.attrs["charge"] = sp_cfg.charge
            grp.attrs["mass"] = sp_cfg.mass
            names_x = list(sp.extra)
            packed = compact_columns(
                mask, [*sp.positions(ndim), sp.ux, sp.uy, sp.uz, sp.w,
                       *(sp.extra[k] for k in names_x)])
            pos = grp.require_group("position")
            pos.attrs["unitDimension"] = np.asarray(
                (1.0, 0, 0, 0, 0, 0, 0), dtype=np.float64
            )
            pos.attrs["timeOffset"] = 0.0
            for nm, data in zip(labels, packed[:ndim]):
                if nm in pos:
                    del pos[nm]
                ds = pos.create_dataset(nm, data=data)
                ds.attrs["unitSI"] = 1.0
            mom = grp.require_group("momentum")
            mom.attrs["unitDimension"] = np.asarray(
                (1.0, 1.0, -1.0, 0, 0, 0, 0), dtype=np.float64
            )
            mom.attrs["timeOffset"] = 0.0
            for nm, data in zip(("x", "y", "z"), packed[ndim:ndim + 3]):
                if nm in mom:
                    del mom[nm]
                ds = mom.create_dataset(nm, data=data * sp_cfg.mass)
                ds.attrs["unitSI"] = 1.0
            w = grp.require_group("weighting")
            if "value" in w:
                del w["value"]
            ds = w.create_dataset("value", data=packed[ndim + 3])
            ds.attrs["unitSI"] = 1.0
            # runtime attributes (ionizationLevel, optical depths), one
            # scalar record each, as the JAX package writes them
            for aname, data in zip(names_x, packed[ndim + 4:]):
                g = grp.require_group(aname)
                if "value" in g:
                    del g["value"]
                ds = g.create_dataset("value", data=data)
                ds.attrs["unitSI"] = 1.0


# --------------------------------------------------------------- readers

def _first_iteration(fh):
    """The (sole) iteration group of a group-/file-based openPMD file."""
    base = fh.attrs.get("basePath", b"/data/%T/")
    base = base.decode() if isinstance(base, bytes) else str(base)
    root = base.split("%T")[0].strip("/")
    grp = fh[root] if root else fh
    its = sorted(grp.keys(), key=lambda s: int(s) if s.isdigit() else 0)
    if not its:
        raise ValueError("openPMD file contains no iterations")
    return grp[its[0]]


def _record_component(rec, comp=None):
    """One record component as (numpy array or scalar, unitSI): dataset
    components, openPMD constant components (a group with ``value``/
    ``shape`` attributes), ``value`` datasets, attribute fallbacks."""
    h5py = _h5py()
    obj = rec if comp is None else (rec[comp] if comp in rec else None)
    if obj is None:
        raise KeyError(comp)
    if isinstance(obj, h5py.Dataset):
        return np.asarray(obj[...]), float(obj.attrs.get("unitSI", 1.0))
    if "value" in obj and isinstance(obj["value"], h5py.Dataset):
        ds = obj["value"]
        return np.asarray(ds[...]), float(ds.attrs.get("unitSI", 1.0))
    if "value" in obj.attrs:  # constant record component
        return np.asarray(obj.attrs["value"]), float(
            obj.attrs.get("unitSI", 1.0)
        )
    raise ValueError(f"unreadable openPMD record component {obj.name}")


def read_openpmd_particles(path: str, species: str | None = None):
    """One particle species of an openPMD file (the analog of the
    reference's AddPlasmaFromFile reader, PhysicalParticleContainer.cpp:
    680-800): SI-scaled ``x, y, z`` (position + positionOffset when
    present), ``px, py, pz`` (kg*m/s), ``w``, ``charge``/``mass`` (None
    when the file does not record them) and the iteration's ``time``.
    Missing transverse components are zero (2D files)."""
    h5py = _h5py()
    with h5py.File(path, "r") as fh:
        it = _first_iteration(fh)
        ppath = fh.attrs.get("particlesPath", b"particles/")
        ppath = (ppath.decode() if isinstance(ppath, bytes)
                 else str(ppath)).strip("/")
        parts = it[ppath]
        names = sorted(parts.keys())
        if species is None:
            if len(names) != 1:
                raise ValueError(
                    "external file should contain exactly 1 species "
                    f"(has {names}); specify one"
                )
            species = names[0]
        ps = parts[species]
        pos = ps["position"]
        npart = None
        out = {}
        for ax in ("x", "y", "z"):
            try:
                val, unit = _record_component(pos, ax)
            except KeyError:
                out[ax] = None
                continue
            val = np.asarray(val, np.float64) * unit
            if "positionOffset" in ps and ax in ps["positionOffset"]:
                off, ounit = _record_component(ps["positionOffset"], ax)
                val = val + np.asarray(off, np.float64) * ounit
            out[ax] = val
            npart = len(val)
        if npart is None:
            raise ValueError("no position records in file")
        for ax in ("x", "y", "z"):
            if out[ax] is None or out[ax].ndim == 0:
                fill = 0.0 if out[ax] is None else float(out[ax])
                out[ax] = np.full(npart, fill)
        mom = ps["momentum"] if "momentum" in ps else None
        for ax in ("x", "y", "z"):
            key = f"p{ax}"
            if mom is not None and ax in mom:
                val, unit = _record_component(mom, ax)
                out[key] = np.broadcast_to(
                    np.asarray(val, np.float64) * unit, (npart,)
                )
            else:
                out[key] = np.zeros(npart)
        wrec = ps["weighting"] if "weighting" in ps else None
        if wrec is not None:
            try:
                val, unit = _record_component(wrec, "value")
            except (KeyError, ValueError):
                val, unit = _record_component(wrec)
            out["w"] = np.broadcast_to(
                np.asarray(val, np.float64) * unit, (npart,)
            )
        else:
            out["w"] = np.ones(npart)
        for nm in ("charge", "mass"):
            if nm in ps:
                val, unit = _record_component(ps[nm])
                out[nm] = float(np.ravel(np.asarray(val))[0]) * unit
            elif nm in ps.attrs:
                out[nm] = float(ps.attrs[nm])
            else:
                out[nm] = None
        t_unit = float(it.attrs.get("timeUnitSI", 1.0))
        out["time"] = float(it.attrs.get("time", 0.0)) * t_unit
        out["species"] = species
    return out


def read_openpmd_mesh(path: str, name: str, comp: str):
    """One mesh record component (the analog of
    WarpX::ReadExternalFieldFromFile's series read, WarpXInitData.cpp:
    1503-1583): the SI ``data`` array, per-axis ``spacing``, the global
    ``offset`` of node (0, ..), the in-cell ``position`` fractions,
    ``axis_labels`` and the ``geometry`` string."""
    h5py = _h5py()
    with h5py.File(path, "r") as fh:
        it = _first_iteration(fh)
        mpath = fh.attrs.get("meshesPath", b"meshes/")
        mpath = (mpath.decode() if isinstance(mpath, bytes)
                 else str(mpath)).strip("/")
        meshes = it[mpath] if mpath in it else it["fields"]
        rec = meshes[name]
        is_scalar = isinstance(rec, h5py.Dataset)
        data, unit = _record_component(rec, None if is_scalar else comp)
        labels = [
            (s.decode() if isinstance(s, bytes) else str(s))
            for s in rec.attrs["axisLabels"]
        ]
        spacing = np.asarray(rec.attrs["gridSpacing"], np.float64)
        offset = np.asarray(rec.attrs["gridGlobalOffset"], np.float64)
        gunit = float(rec.attrs.get("gridUnitSI", 1.0))
        geometry = rec.attrs.get("geometry", b"cartesian")
        geometry = (geometry.decode() if isinstance(geometry, bytes)
                    else str(geometry))
        ds = rec if is_scalar else rec[comp]
        pos_frac = np.asarray(
            ds.attrs.get("position", np.zeros(len(labels))), np.float64
        )
        return {
            "data": np.asarray(data, np.float64) * unit,
            "spacing": spacing * gunit,
            "offset": offset * gunit,
            "position": pos_frac,
            "axis_labels": labels,
            "geometry": geometry,
        }
