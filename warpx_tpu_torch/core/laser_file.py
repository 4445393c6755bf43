"""Laser profile from a lasy (openPMD) file.

The counterpart of ``warpx_tpu.core.laser_file`` (reference:
Source/Laser/LaserProfilesImpl/LaserProfileFromFile.cpp): the lasy file's
complex E envelope (mesh ``laserEnvelope``, geometry ``cartesian`` with
axes {t, y, x} or ``thetaMode`` with {m, t, r}) is interpolated tri- or
bilinearly at the antenna-plane coordinates and the time, and the emitted
amplitude is Re(envelope e^{-i omega0 t}) (:436-437).  The whole file is
read once, on the host (``h5py`` is imported then), and kept per path in
``_CACHE``; ``lasy_amplitude`` runs on the device of the antenna
particles, on a copy of the envelope made there once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants

__all__ = ["LasyData", "load_lasy", "lasy_amplitude", "is_loaded"]

# path -> LasyData: each file is read once per process
_CACHE = {}
# (device, dtype) copies of an envelope, keyed by the id of its host array
_ON_DEVICE = {}


@dataclasses.dataclass(frozen=True)
class LasyData:
    cartesian: bool
    t_min: float
    t_max: float
    # cartesian: (nt, ny, nx) complex; thetaMode: (2m - 1, nt, nr) complex
    # (a numpy array on the host)
    data: object
    x_min: float = 0.0
    x_max: float = 0.0
    y_min: float = 0.0
    y_max: float = 0.0
    r_min: float = 0.0
    r_max: float = 0.0


def is_loaded(path: str) -> bool:
    """Whether ``path`` was read already (``load_lasy`` will not open it)."""
    return path in _CACHE


def _text(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


def load_lasy(path: str) -> LasyData:
    """Read the lasy envelope of ``path`` (once per process)."""
    if path in _CACHE:
        return _CACHE[path]
    from ..io.openpmd import _h5py

    h5py = _h5py()
    with h5py.File(path, "r") as fh:
        data_grp = fh["data"]
        it = data_grp[sorted(data_grp.keys(), key=int)[0]]
        env = (it["fields/laserEnvelope"] if "fields" in it
               else it["meshes/laserEnvelope"])
        geom = _text(env.attrs["geometry"])
        spacing = np.asarray(env.attrs["gridSpacing"], float)
        offset = np.asarray(env.attrs["gridGlobalOffset"], float)
        # the scalar record: the group is the dataset or holds one
        ds = env if isinstance(env, h5py.Dataset) else env[list(env.keys())[0]]
        pos = np.asarray(ds.attrs.get("position", np.zeros(len(spacing))),
                         float)
        raw = ds[...]
        if raw.dtype.names:  # compound (r, i)
            arr = raw[raw.dtype.names[0]] + 1j * raw[raw.dtype.names[1]]
        else:
            arr = np.asarray(raw)
    lo = offset + pos * spacing
    if geom == "cartesian":
        nt, ny, nx = arr.shape
        out = LasyData(
            cartesian=True, t_min=float(lo[0]),
            t_max=float(lo[0] + (nt - 1) * spacing[0]),
            y_min=float(lo[1]), y_max=float(lo[1] + (ny - 1) * spacing[1]),
            x_min=float(lo[2]), x_max=float(lo[2] + (nx - 1) * spacing[2]),
            data=arr)
    elif geom == "thetaMode":
        _, nt, nr = arr.shape
        out = LasyData(
            cartesian=False, t_min=float(lo[0]),
            t_max=float(lo[0] + (nt - 1) * spacing[0]),
            r_min=float(lo[1]), r_max=float(lo[1] + (nr - 1) * spacing[1]),
            data=arr)
    else:
        raise NotImplementedError(f"lasy geometry '{geom}'")
    _CACHE[path] = out
    return out


def _device_data(ld: LasyData, device, dtype) -> torch.Tensor:
    """The envelope as a complex tensor on ``device`` matching the real
    ``dtype`` (made once per envelope, device and type)."""
    ctype = torch.complex128 if dtype == torch.float64 else torch.complex64
    key = (id(ld.data), str(device), ctype)
    hit = _ON_DEVICE.get(key)
    if hit is None or hit[0] is not ld.data:
        hit = (ld.data, torch.from_numpy(np.asarray(
            ld.data, np.complex128)).to(device=device, dtype=ctype))
        _ON_DEVICE[key] = hit
    return hit[1]


def _axis_interp(coord: torch.Tensor, lo: float, hi: float, n: int):
    """(left index, right index, fraction) with the reference's ceil-based
    index choice (LaserProfileFromFile.cpp:468-476)."""
    span = torch.full((), hi - lo, dtype=coord.dtype, device=coord.device)
    s = (n - 1) * (coord - lo) / span
    idx_r = torch.clamp(torch.ceil(s).to(torch.int64), 1, n - 1)
    idx_l = idx_r - 1
    return idx_l, idx_r, s - idx_l.to(coord.dtype)


def lasy_amplitude(ld: LasyData, laser, Xp: torch.Tensor, Yp: torch.Tensor,
                   t: float) -> torch.Tensor:
    """The amplitude at the antenna-plane coordinates (``Xp``, ``Yp``) and
    the host time ``t`` of the envelope, on the device of ``Xp``."""
    t = float(t)
    phase = complex(np.exp(-1j * (2.0 * np.pi * constants.c * t
                                  / laser.wavelength)))
    data = _device_data(ld, Xp.device, Xp.dtype)
    nt = data.shape[0] if ld.cartesian else data.shape[-2]
    tl, tr, tf = _axis_interp(
        torch.full((), t, dtype=Xp.dtype, device=Xp.device),
        ld.t_min, ld.t_max, nt)
    if ld.cartesian:
        _, ny, nx = data.shape
        xl, xr, xf = _axis_interp(Xp, ld.x_min, ld.x_max, nx)
        yl, yr, yf = _axis_interp(Yp, ld.y_min, ld.y_max, ny)

        def plane(ti):
            return (data[ti, yl, xl] * (1 - yf) * (1 - xf)
                    + data[ti, yr, xl] * yf * (1 - xf)
                    + data[ti, yl, xr] * (1 - yf) * xf
                    + data[ti, yr, xr] * yf * xf)

        val = plane(tl) * (1 - tf) + plane(tr) * tf
        inside = ((Xp > ld.x_min) & (Xp < ld.x_max)
                  & (Yp > ld.y_min) & (Yp < ld.y_max))
    else:
        rp = torch.sqrt(Xp * Xp + Yp * Yp)
        ok = rp > 0
        safe = torch.where(ok, rp, torch.ones_like(rp))
        ct = torch.where(ok, Xp / safe, torch.ones_like(rp))
        st = torch.where(ok, Yp / safe, torch.zeros_like(rp))
        rl, rr, rf = _axis_interp(rp, ld.r_min, ld.r_max, data.shape[2])

        def bilin(comp):
            return (data[comp, tl, rl] * (1 - tf) * (1 - rf)
                    + data[comp, tl, rr] * (1 - tf) * rf
                    + data[comp, tr, rl] * tf * (1 - rf)
                    + data[comp, tr, rr] * tf * rf)

        val = bilin(0)
        fc, fs = ct, st
        for m in range(1, data.shape[0] // 2 + 1):
            val = val + bilin(2 * m - 1) * fc + bilin(2 * m) * fs
            fc, fs = fc * ct - fs * st, fc * st + fs * ct
        inside = rp < ld.r_max
    amp = (val * phase).real
    if not ld.t_min <= t <= ld.t_max:
        return torch.zeros_like(amp)
    return torch.where(inside, amp, torch.zeros_like(amp))
