"""Fused gather + push + Esirkepov deposit over the tile-binned layout (3D).

The counterpart of ``warpx_tpu.ops.pallas_pic``: ``pad_fields`` and
``binned_push_deposit``, with the same arguments and returns.  The wrapper
launches kernel K1 (``csrc/fused_pic.cu``, see its header for the design)
on CUDA tensors and runs ``binned_push_deposit_plain`` on CPU tensors.

The plain version repeats the TPU kernel's arithmetic in its own dense
formulation: per tile, every shape weight becomes a (W, p_max) band matrix
over the window rows, the gather is a batched matrix product against the
(W, W*W) field window, and the deposit is a batched product of the
Esirkepov running sums against the transverse outer products.  It is the
oracle the CPU tests hold against the JAX package and the kernel is held
against on the card; it is not built for speed.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..constants import c as _c
from .gather import GALERKIN_AXES
from .push import PUSHERS
from .shapes import spline, start_index

__all__ = ["binned_push_deposit", "binned_push_deposit_plain", "pad_fields"]

_AXES = ("x", "y", "z")
_COMPS = ("Ex", "Ey", "Ez", "Bx", "By", "Bz")
_PUSHER_IDS = {"boris": 0, "vay": 1, "higuera": 2}


def pad_fields(fields6, spec):
    """Guard-pad the six field arrays by periodic wrap: ``off`` cells below
    and ``W - tile - off`` above per axis, so the window of tile t starts
    at t*tile in padded coordinates (the FillBoundary analog)."""
    if spec.ndim != 3:
        raise NotImplementedError("2D fused step (ROADMAP.md Queue B K2)")
    out = []
    for a in fields6:
        idx = [
            torch.remainder(
                torch.arange(-spec.off, a.shape[d] + spec.w - spec.tile[d]
                             - spec.off, device=a.device),
                a.shape[d],
            )
            for d in range(3)
        ]
        out.append(a[idx[0][:, None, None], idx[1][None, :, None],
                     idx[2][None, None, :]])
    return tuple(out)


def _gather_table(order, galerkin, staggering):
    """Per (component, axis): the gather's shape order (reduced by one on
    the Galerkin axes) and whether the component sits at i + 1/2."""
    gorder, gstag = [], []
    for comp in _COMPS:
        for d in range(3):
            reduced = galerkin and (_AXES[d] in GALERKIN_AXES[comp])
            gorder.append(order - 1 if reduced else order)
            gstag.append(int(staggering[comp][d] == 0))
    return gorder, gstag


def _check(params, fields6, parts7, counts, spec, mxu, anchors, zshift):
    if spec.ndim != 3:
        raise NotImplementedError("2D fused step (ROADMAP.md Queue B K2)")
    if mxu != "f32":
        raise NotImplementedError(
            f"tile_mxu={mxu!r}: the TPU matrix-unit precision modes are "
            "ROADMAP.md Queue B K1d"
        )
    if anchors is not None or zshift is not None:
        raise NotImplementedError(
            "moving-window anchors (ROADMAP.md Queue B K1c)"
        )
    if len(parts7) != 7:
        raise ValueError(f"expected 7 particle arrays, got {len(parts7)}")
    if counts is None:
        counts = torch.ones(parts7[0].shape[0], dtype=torch.int32,
                            device=parts7[0].device)
    return counts


def binned_push_deposit_plain(
    params, fields6, parts7, counts, *, spec, geom, order, galerkin,
    pusher_name, dt, stag_items,
):
    """Plain PyTorch version of K1 (same arguments as
    ``binned_push_deposit``; ``counts`` is required)."""
    staggering = dict(stag_items)
    dtype = parts7[0].dtype
    dev = parts7[0].device
    W, P, T = spec.w, spec.p_max, order + 3
    nt = spec.n_tiles
    ns = parts7[0].shape[0] // nt
    ntx, nty, ntz = spec.tiles_per_dim
    inv_dx = tuple(1.0 / d for d in geom.dx)
    invdtd = (
        1.0 / (dt * geom.dx[1] * geom.dx[2]),
        1.0 / (dt * geom.dx[0] * geom.dx[2]),
        1.0 / (dt * geom.dx[0] * geom.dx[1]),
    )
    pusher = PUSHERS[pusher_name]
    inv_c2 = 1.0 / (_c * _c)
    gorder, gstag = _gather_table(order, galerkin, staggering)

    # (n_tiles, W, W*W) windows of the padded fields, layout (x, (y,z))
    ar = torch.arange(W, device=dev)
    idx = [
        (torch.arange(spec.tiles_per_dim[d], device=dev) * spec.tile[d])
        [:, None] + ar[None, :]
        for d in range(3)
    ]
    win = [
        f[idx[0][:, None, None, :, None, None],
          idx[1][None, :, None, None, :, None],
          idx[2][None, None, :, None, None, :]].reshape(nt, W, W * W)
        for f in fields6
    ]
    tix = torch.arange(nt, device=dev)
    worig = torch.stack([
        (tix // (nty * ntz)) * spec.tile[0] - spec.off,
        ((tix // ntz) % nty) * spec.tile[1] - spec.off,
        (tix % ntz) * spec.tile[2] - spec.off,
    ]).to(dtype)  # (3, nt)
    rows = ar.to(dtype)[None, :, None]  # (1, W, 1)

    out_parts = [torch.empty_like(parts7[c]) for c in range(6)]
    jw = [torch.zeros((nt, W, W * W), dtype=dtype, device=dev)
          for _ in range(3)]
    viol = torch.zeros(ns * nt, dtype=torch.int32, device=dev)
    # tiles per chunk: bounds the (chunk, W*W, P) intermediates
    per_tile = W * W * P * parts7[0].element_size()
    chunk = max(1, min(nt, (256 << 20) // per_tile))

    def band(xc, o):
        """(C, W, P) band matrix A[t, i, p] = S_o(xc[t, p] - i); order 0 is
        the half-open box [-1/2, 1/2)."""
        xi = xc[:, None, :] - rows
        if o == 0:
            return ((xi >= -0.5) & (xi < 0.5)).to(dtype)
        return spline(xi, o)

    def outer(a, b):
        return (a[:, :, None, :] * b[:, None, :, :]).reshape(
            a.shape[0], W * W, P)

    for s in range(ns):
        q = params[s, 0]
        m = params[s, 1]
        for c0 in range(0, nt, chunk):
            c1 = min(nt, c0 + chunk)
            rsel = slice(s * nt + c0, s * nt + c1)
            pin = [parts7[c][rsel] for c in range(7)]
            occ = counts[rsel] > 0  # (C,)
            X = [(pin[d] - geom.prob_lo[d]) * inv_dx[d]
                 - worig[d, c0:c1, None] for d in range(3)]
            acache = {}

            def axis_mat(d, o, stag):
                key = (d, o, stag)
                if key not in acache:
                    acache[key] = band(X[d] - (0.5 if stag else 0.0), o)
                return acache[key]

            # ---- gather
            e6 = []
            for ci in range(6):
                keys = [(gorder[ci * 3 + d], gstag[ci * 3 + d])
                        for d in range(3)]
                byz = outer(axis_mat(1, *keys[1]), axis_mat(2, *keys[2]))
                h = torch.bmm(win[ci][c0:c1], byz)  # (C, W, P)
                e6.append((axis_mat(0, *keys[0]) * h).sum(dim=1)
                          + params[s, 2 + ci])
            # ---- push
            ux, uy, uz = pusher(pin[3], pin[4], pin[5], *e6, q, m, dt)
            gaminv = 1.0 / torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz)
                                      * inv_c2)
            vel = (ux * gaminv, uy * gaminv, uz * gaminv)
            new = [pin[d] + vel[d] * dt for d in range(3)] + [ux, uy, uz]
            keep = occ[:, None]
            for c in range(6):
                out_parts[c][rsel] = torch.where(keep, new[c], pin[c])
            # ---- Esirkepov deposit
            wq = q * pin[6]
            sm, df, cs = [], [], []
            bad = torch.zeros_like(occ[:, None].expand(-1, P))
            for d in range(3):
                xn = X[d] + vel[d] * (dt * inv_dx[d])
                nn = band(xn, order)
                no = axis_mat(d, order, False)
                sm.append(nn + no)
                df.append(no - nn)
                cs.append(torch.cumsum(no - nn, dim=1))
                i0 = start_index(xn, order) - 1
                bad = bad | (i0 < 0) | (i0 > W - T)
            for d, (a, b) in enumerate(((1, 2), (0, 2), (0, 1))):
                lhs = cs[d] * (wq * invdtd[d])[:, None, :]
                rhs = (0.25 * outer(sm[a], sm[b])
                       + (1.0 / 12.0) * outer(df[a], df[b]))
                jd = torch.bmm(lhs, rhs.transpose(1, 2))  # (C, W, W*W)
                jw[d][c0:c1] += torch.where(occ[:, None, None], jd,
                                            torch.zeros((), dtype=dtype,
                                                        device=dev))
            alive = pin[6] > 0
            cnt = (bad & alive).sum(dim=1, dtype=torch.int32)
            viol[rsel] = torch.where(occ, cnt, torch.zeros_like(cnt))
    return tuple(out_parts), tuple(jw), viol


class _FusedPicArgs(ctypes.Structure):
    """Mirror of ``struct FusedPicArgs`` in ``csrc/fused_pic.cu``."""

    _fields_ = [
        ("fields", ctypes.c_void_p * 6),
        ("parts", ctypes.c_void_p * 7),
        ("out_parts", ctypes.c_void_p * 6),
        ("jw", ctypes.c_void_p * 3),
        ("viol", ctypes.c_void_p),
        ("counts", ctypes.c_void_p),
        ("sp_params", ctypes.c_void_p),
        ("n_sp", ctypes.c_int),
        ("n_tiles", ctypes.c_int),
        ("p_max", ctypes.c_int),
        ("w", ctypes.c_int),
        ("off", ctypes.c_int),
        ("tiles_per_dim", ctypes.c_int * 3),
        ("tile", ctypes.c_int * 3),
        ("fdim", ctypes.c_int * 3),
        ("order", ctypes.c_int),
        ("pusher", ctypes.c_int),
        ("gorder", ctypes.c_int * 18),
        ("gstag", ctypes.c_int * 18),
        ("lo", ctypes.c_double * 3),
        ("inv_dx", ctypes.c_double * 3),
        ("dt_inv_dx", ctypes.c_double * 3),
        ("invdtd", ctypes.c_double * 3),
        ("dt", ctypes.c_double),
    ]


def _library_name(dtype, order):
    return f"fused_pic_{'f64' if dtype == torch.float64 else 'f32'}_o{order}"


def _launch_kernel(params, fields6, parts7, counts, *, spec, geom, order,
                   galerkin, pusher_name, dt, stag_items):
    dtype = parts7[0].dtype
    dev = parts7[0].device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused kernel takes float32/float64, got {dtype}")
    if not 1 <= order <= 3:
        raise ValueError(f"shape order {order} outside 1-3")
    if pusher_name not in _PUSHER_IDS:
        raise NotImplementedError(
            f"pusher {pusher_name!r} in the fused kernel (ROADMAP.md Queue A 11)"
        )
    nt, P, W = spec.n_tiles, spec.p_max, spec.w
    rows = parts7[0].shape[0]
    ns = rows // nt
    padded = tuple(n + W - t for n, t in zip(geom.n_cell, spec.tile))
    for f in fields6:
        if (f.dtype != dtype or f.device != dev or not f.is_contiguous()
                or tuple(f.shape) != padded):
            raise ValueError(f"fields must be contiguous {dtype} {padded} "
                             f"tensors on {dev} (pad_fields)")
    for a in parts7:
        if (a.dtype != dtype or a.device != dev or not a.is_contiguous()
                or tuple(a.shape) != (ns * nt, P)):
            raise ValueError(f"particle arrays must be contiguous {dtype} "
                             f"({ns * nt}, {P}) tensors on {dev}")
    if (params.dtype != dtype or params.device != dev
            or tuple(params.shape) != (ns, 8) or not params.is_contiguous()):
        raise ValueError(f"params must be a contiguous ({ns}, 8) {dtype} "
                         f"tensor on {dev}")
    if (counts.dtype != torch.int32 or counts.device != dev
            or tuple(counts.shape) != (rows,) or not counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous ({rows},) int32 "
                         f"tensor on {dev}")
    out_parts = tuple(torch.empty_like(parts7[c]) for c in range(6))
    jw = tuple(torch.empty((nt, W, W * W), dtype=dtype, device=dev)
               for _ in range(3))
    viol = torch.empty(rows, dtype=torch.int32, device=dev)
    gorder, gstag = _gather_table(order, galerkin, dict(stag_items))
    a = _FusedPicArgs()
    a.fields[:] = [f.data_ptr() for f in fields6]
    a.parts[:] = [p.data_ptr() for p in parts7]
    a.out_parts[:] = [p.data_ptr() for p in out_parts]
    a.jw[:] = [j.data_ptr() for j in jw]
    a.viol = viol.data_ptr()
    a.counts = counts.data_ptr()
    a.sp_params = params.data_ptr()
    a.n_sp, a.n_tiles, a.p_max, a.w, a.off = ns, nt, P, W, spec.off
    a.tiles_per_dim[:] = list(spec.tiles_per_dim)
    a.tile[:] = list(spec.tile)
    a.fdim[:] = list(padded)
    a.order = order
    a.pusher = _PUSHER_IDS[pusher_name]
    a.gorder[:] = gorder
    a.gstag[:] = gstag
    a.lo[:] = list(geom.prob_lo)
    a.inv_dx[:] = [1.0 / d for d in geom.dx]
    a.dt_inv_dx[:] = [dt * (1.0 / d) for d in geom.dx]
    a.invdtd[:] = [
        1.0 / (dt * geom.dx[1] * geom.dx[2]),
        1.0 / (dt * geom.dx[0] * geom.dx[2]),
        1.0 / (dt * geom.dx[0] * geom.dx[1]),
    ]
    a.dt = dt
    lib = _library_name(dtype, order)
    err = build.library(lib).fused_pic_launch(
        ctypes.addressof(a), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        stage = {1: "device query", 2: "shared-memory opt-in", 3: "launch",
                 4: "arguments"}.get(err // 1000, "?")
        raise RuntimeError(
            f"fused_pic {stage} failed: "
            f"{build.cuda_error(lib, 'fused_pic_error_string', err)}"
        )
    binned_push_deposit.launches += 1
    return out_parts, jw, viol


def binned_push_deposit(
    params, fields6, parts7, anchors=None, zshift=None, counts=None, *,
    spec, geom, order, galerkin, pusher_name, dt, stag_items, mxu="f32",
):
    """Run the fused gather + push + deposit over all tiles for all species
    of one pusher at once (kernel K1 on CUDA tensors).

    params: (n_sp, 8) [q, m, Eext(3), Bext(3)] per species; fields6: the six
    guard-padded fields from ``pad_fields``; parts7: (x, y, z, ux, uy, uz, w)
    each (n_sp * n_tiles, p_max), the species' tile arrays stacked along the
    tile axis; counts: alive particles per (species, tile) (default: all
    tiles occupied).

    Returns (new_parts6 (x, y, z, ux, uy, uz), (jx_w, jy_w, jz_w) summed over
    species, violations (n_sp * n_tiles,)).  J windows are (n_tiles, W, W*W)
    in layouts (x,(y,z)), (y,(x,z)), (z,(x,y)): fold them with axes
    (0,1,2), (1,0,2), (2,0,1).  ``violations`` counts alive particles that
    drifted beyond the rebin margin (must be all zero).
    """
    counts = _check(params, fields6, parts7, counts, spec, mxu, anchors,
                    zshift)
    kw = dict(spec=spec, geom=geom, order=order, galerkin=galerkin,
              pusher_name=pusher_name, dt=dt, stag_items=stag_items)
    dev = parts7[0].device.type
    if dev == "cpu":
        return binned_push_deposit_plain(params, fields6, parts7, counts,
                                         **kw)
    if dev != "cuda":
        raise ValueError(f"unsupported device {parts7[0].device}")
    return _launch_kernel(params, fields6, parts7, counts, **kw)


binned_push_deposit.launches = 0
