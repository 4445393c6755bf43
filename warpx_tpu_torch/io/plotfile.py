"""AMReX-style plotfile flush format (writer + reader).

A copy of ``warpx_tpu.io.plotfile`` (numpy only; the port keeps its own
copy and imports nothing of the JAX package): the same bytes on disk,
so either package's reader reads the other's files.

The design analog of the reference's plotfile output stack
(Source/Diagnostics/FlushFormats/FlushFormatPlotfile.cpp:94
``amrex::WriteMultiLevelPlotfile`` + particle ``WritePlotFile``): one
directory per flush holding a ``HyperCLaw-V1.1`` text Header, one
``Level_<l>/`` subdirectory per AMR level with a VisMF ``Cell_H`` header and
a single FAB data file (Version_v1 header, cf. FlushFormatPlotfile.cpp:92
``VisMF::SetHeaderVersion(Version_v1)``), and one ``<species>/`` subdirectory
per output species with a particle header + flat binary real data.

The writer always writes one grid per level (the host-side
array is already the assembled global box — there is no per-rank MultiFab to
scatter), which keeps the format exactly round-trippable by ``read_plotfile``
below; the checksum harness (diagnostics/checksum.py) reads these files back
the way the reference's Regression/Checksum/checksum.py reads plotfiles
through yt (sum(abs(Q)) per component).

Data layout facts encoded here (AMReX VisMF/FAB on-disk contract):
  * FAB records start with an ASCII header
    ``FAB ((8, (64 11 52 0 1 12 0 1023)),(8, (8 7 6 5 4 3 2 1)))`` — IEEE-754
    little-endian float64 — followed by the box, the component count, and the
    raw cell data in Fortran order, component-major.
  * Cell_H lists per-FAB byte offsets plus per-component min/max tables.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["write_plotfile", "read_plotfile", "read_particles"]

_FAB_REAL8 = "FAB ((8, (64 11 52 0 1 12 0 1023)),(8, (8 7 6 5 4 3 2 1)))"


def _box_str(lo, hi) -> str:
    t = ",".join("0" for _ in lo)
    return (
        "((" + ",".join(str(i) for i in lo) + ") ("
        + ",".join(str(i) for i in hi) + ") (" + t + "))"
    )


def _parse_box(s: str):
    parts = s.replace("(", " ").replace(")", " ").split()
    lo = tuple(int(x) for x in parts[0].split(","))
    hi = tuple(int(x) for x in parts[1].split(","))
    return lo, hi


def write_plotfile(
    path: str,
    levels: Sequence[Dict[str, np.ndarray]],
    *,
    prob_lo: Sequence[float],
    prob_hi: Sequence[float],
    time: float,
    step: int,
    ref_ratio: Sequence[Sequence[int]] = (),
    particles: Dict[str, Dict[str, np.ndarray]] | None = None,
) -> None:
    """Write a multi-level plotfile.

    ``levels[l]`` maps component name -> cell-centered ndarray (level-l global
    box); every level must carry the same component names in the same order.
    ``ref_ratio[l]`` is the per-axis refinement ratio from level l to l+1.
    ``particles`` maps species name -> {attr: 1D array}; attrs must include
    the active position components ``x``(, ``y``, ``z``).
    """
    names = list(levels[0].keys())
    ncomp = len(names)
    ndim = levels[0][names[0]].ndim
    nlev = len(levels)
    os.makedirs(path, exist_ok=True)

    with open(os.path.join(path, "Header"), "w") as fh:
        fh.write("HyperCLaw-V1.1\n")
        fh.write(f"{ncomp}\n")
        for n in names:
            fh.write(n + "\n")
        fh.write(f"{ndim}\n")
        fh.write(f"{time!r}\n")
        fh.write(f"{nlev - 1}\n")
        fh.write(" ".join(repr(float(x)) for x in prob_lo) + "\n")
        fh.write(" ".join(repr(float(x)) for x in prob_hi) + "\n")
        fh.write(
            " ".join(
                str(max(r)) for r in (ref_ratio or [])
            ) + "\n"
        )
        for lev in range(nlev):
            shp = levels[lev][names[0]].shape
            fh.write(_box_str((0,) * ndim, tuple(s - 1 for s in shp)) + " ")
        fh.write("\n")
        fh.write(" ".join(str(step) for _ in range(nlev)) + "\n")
        lo = np.asarray(prob_lo, float)
        hi = np.asarray(prob_hi, float)
        for lev in range(nlev):
            shp = levels[lev][names[0]].shape
            dx = (hi - lo) / np.asarray(shp, float)
            fh.write(" ".join(repr(float(d)) for d in dx) + "\n")
        fh.write("0\n")  # coord sys: cartesian
        fh.write("0\n")  # boundary width
        for lev in range(nlev):
            shp = levels[lev][names[0]].shape
            dx = (hi - lo) / np.asarray(shp, float)
            fh.write(f"{lev} 1 {time!r}\n")
            fh.write(f"{step}\n")
            for d in range(ndim):
                fh.write(f"{lo[d]!r} {hi[d]!r}\n")
            fh.write(f"Level_{lev}/Cell\n")

    for lev, comps in enumerate(levels):
        lvldir = os.path.join(path, f"Level_{lev}")
        os.makedirs(lvldir, exist_ok=True)
        shp = comps[names[0]].shape
        box = _box_str((0,) * ndim, tuple(s - 1 for s in shp))
        data = np.stack(
            [np.asarray(comps[n], np.float64) for n in names], axis=0
        )
        # FAB payload: Fortran cell order, component-major
        payload = np.concatenate(
            [data[i].ravel(order="F") for i in range(ncomp)]
        )
        fab_header = f"{_FAB_REAL8}{box} {ncomp}\n"
        with open(os.path.join(lvldir, "Cell_D_00000"), "wb") as fd:
            fd.write(fab_header.encode())
            fd.write(payload.astype("<f8").tobytes())
        mins = data.reshape(ncomp, -1).min(axis=1)
        maxs = data.reshape(ncomp, -1).max(axis=1)
        with open(os.path.join(lvldir, "Cell_H"), "w") as fh:
            fh.write("1\n1\n")
            fh.write(f"{ncomp}\n")
            fh.write("0\n")
            fh.write(f"(1 0\n{box}\n)\n")
            fh.write("1\n")
            fh.write("FabOnDisk: Cell_D_00000 0\n")
            fh.write(f"\n1,{ncomp}\n")
            fh.write(",".join(repr(float(v)) for v in mins) + ",\n")
            fh.write(f"\n1,{ncomp}\n")
            fh.write(",".join(repr(float(v)) for v in maxs) + ",\n")

    for sp, attrs in (particles or {}).items():
        _write_species(path, sp, attrs, ndim)


def _write_species(path: str, name: str, attrs: Dict[str, np.ndarray],
                   ndim: int) -> None:
    """AMReX-style particle output: text header + flat float64 data file
    (the analog of ParticleContainer::WritePlotFile; positions first, then
    the extra real attributes, struct-of-arrays)."""
    spdir = os.path.join(path, name, "Level_0")
    os.makedirs(spdir, exist_ok=True)
    pos_names = ["x", "y", "z"][:ndim]
    extra = [k for k in attrs if k not in pos_names]
    np_count = len(np.asarray(attrs[pos_names[0]]).ravel())
    with open(os.path.join(path, name, "Header"), "w") as fh:
        fh.write("Version_Two_Dot_Zero_double\n")
        fh.write(f"{ndim}\n")
        fh.write(f"{len(extra)}\n")
        for k in extra:
            fh.write(k + "\n")
        fh.write("0\n")  # int attrs
        fh.write("0\n")  # not a checkpoint
        fh.write(f"{np_count}\n")
        fh.write(f"{np_count}\n")  # max next_id
        fh.write("0\n")  # finest level
        fh.write("1\n")  # grids on level 0
        fh.write(f"0 {np_count} 0\n")  # (which file, count, offset)
    cols = [np.asarray(attrs[k], np.float64).ravel()
            for k in pos_names + extra]
    with open(os.path.join(spdir, "DATA_00000"), "wb") as fd:
        fd.write(np.concatenate(cols).astype("<f8").tobytes())


def read_plotfile(path: str):
    """Read a plotfile written by write_plotfile (or any single-grid-per-level
    AMReX plotfile with one FAB per level).

    Returns (levels, meta): ``levels[l]`` maps component -> ndarray;
    ``meta`` has prob_lo/prob_hi/time/step/ndim.
    """
    with open(os.path.join(path, "Header")) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    assert lines[0].startswith("HyperCLaw"), lines[0]
    i = 1
    ncomp = int(lines[i]); i += 1
    names = lines[i:i + ncomp]; i += ncomp
    ndim = int(lines[i]); i += 1
    time = float(lines[i]); i += 1
    finest = int(lines[i]); i += 1
    prob_lo = [float(x) for x in lines[i].split()]; i += 1
    prob_hi = [float(x) for x in lines[i].split()]; i += 1
    i += 1  # ref ratios
    boxes_line = lines[i]; i += 1
    steps = [int(x) for x in lines[i].split()]; i += 1
    meta = {
        "prob_lo": prob_lo, "prob_hi": prob_hi, "time": time,
        "step": steps[0] if steps else 0, "ndim": ndim, "names": names,
    }
    del boxes_line
    levels: List[Dict[str, np.ndarray]] = []
    for lev in range(finest + 1):
        lvldir = os.path.join(path, f"Level_{lev}")
        with open(os.path.join(lvldir, "Cell_H")) as fh:
            htxt = fh.read()
        box_s = htxt[htxt.index("((") : htxt.index("))") + 2]
        lo, hi = _parse_box(box_s)
        shp = tuple(h - l + 1 for l, h in zip(lo, hi))
        fab_file = None
        offset = 0
        for ln in htxt.splitlines():
            if ln.startswith("FabOnDisk:"):
                _, fab_file, off = ln.split()
                offset = int(off)
        with open(os.path.join(lvldir, fab_file), "rb") as fd:
            fd.seek(offset)
            hdr = b""
            while not hdr.endswith(b"\n"):
                hdr += fd.read(1)
            nc = int(hdr.rsplit(b" ", 1)[1])
            count = int(np.prod(shp)) * nc
            raw = np.frombuffer(fd.read(count * 8), "<f8")
        data = raw.reshape((nc,) + shp[::-1]).transpose(
            (0,) + tuple(range(ndim, 0, -1))
        )
        levels.append({names[c]: data[c] for c in range(nc)})
    return levels, meta


def read_particles(path: str, species: str) -> Dict[str, np.ndarray]:
    """Read one species' particle data back (attrs incl. positions)."""
    with open(os.path.join(path, species, "Header")) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    assert lines[0].startswith("Version_Two_Dot_Zero"), lines[0]
    ndim = int(lines[1])
    nextra = int(lines[2])
    extra = lines[3:3 + nextra]
    i = 3 + nextra
    nint = int(lines[i]); i += 1 + nint
    i += 1  # checkpoint flag
    np_count = int(lines[i])
    pos_names = ["x", "y", "z"][:ndim]
    cols = pos_names + extra
    raw = np.fromfile(
        os.path.join(path, species, "Level_0", "DATA_00000"), "<f8"
    )
    out = {}
    for k, col in enumerate(cols):
        out[col] = raw[k * np_count:(k + 1) * np_count]
    return out
