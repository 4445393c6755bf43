"""Fused gather + push + Esirkepov deposit over the tile-binned layout
(2D XZ and 3D).

The counterpart of ``warpx_tpu.ops.pallas_pic``: ``pad_fields`` and
``binned_push_deposit``, with the same arguments and returns.  On CUDA
tensors the wrapper launches kernel K1 (3D, ``csrc/fused_pic.cu``) or K2
(2D, ``csrc/fused_pic_2d.cu``; see their headers for the design), which
gather on the Yee staggering only (``gather_table_3d``, ``gather_table_2d``:
any other raises, with no fallback); on CPU tensors it runs
``binned_push_deposit_plain``.

The plain version repeats the TPU kernels' arithmetic in its own dense
formulation: per tile, every shape weight becomes a (W, p_max) band matrix
over the window rows, the gather is a batched matrix product against the
field window, and the deposit is a batched product of the Esirkepov running
sums against the transverse weights.  It is the oracle the CPU tests hold
against the JAX package and the kernels are held against on the card; it
is not built for speed.

Precision modes (``mxu``, the TPU kernel's matrix-unit modes,
pallas_pic.py:57-69): 'f32' computes in the state's type throughout.
'mixed' rounds the gather's operands to bfloat16 (each field-window value;
in 3D the transverse weight ``bf16(wy * wz)``, in 2D the z weight; the x
weight stays unrounded) and splits each deposit operand into a bfloat16
high part and a bfloat16 remainder, dropping only the remainder-remainder
product (``_dot3x``, pallas_pic.py:101).  'bf16' rounds the deposit's
operands to bfloat16 once as well.  Products of bfloat16 values are exact
in float32 and float64, and every sum is taken in the state's type, as the
TPU kernel's dots with ``preferred_element_type`` do.  A float64 value is
rounded to bfloat16 through float32, as PyTorch and XLA convert it.

Moving-window mode (``anchors``, ``zshift``, ``smax``): the tiles stay
anchored where the last rebin laid them out (``anchors`` replaces
``prob_lo``) while the grid has slid ``zshift`` whole cells along the last
axis since; the padded fields are ``smax`` cells longer on that axis and
the window of tile t starts at ``t*tile + (smax - zshift)`` there.  Both
are host numbers, so neither path waits for the device.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..constants import c as _c
from ..core.grid import AXIS_NAMES, yee_staggering
from .gather import GALERKIN_AXES
from .push import PUSHERS
from .shapes import spline, start_index
from .tiling import broadcast_index

__all__ = ["binned_push_deposit", "binned_push_deposit_plain", "pad_fields",
           "padded_shape", "gather_table_2d", "gather_table_3d", "wide_tiles",
           "blocks_per_sm"]

_COMPS = ("Ex", "Ey", "Ez", "Bx", "By", "Bz")
_PUSHER_IDS = {"boris": 0, "vay": 1, "higuera": 2}
MXU_MODES = {"f32": 0, "mixed": 1, "bf16": 2}


def padded_shape(spec, n_cell, smax=0):
    """Extents of the guard-padded fields the fused kernels read."""
    shape = [n + spec.w - t for n, t in zip(n_cell, spec.tile)]
    shape[-1] += smax
    return tuple(shape)


def pad_fields(fields6, spec):
    """Guard-pad the six field arrays by periodic wrap: ``off`` cells below
    and ``W - tile - off`` above per axis, so the window of tile t starts
    at t*tile in padded coordinates (the FillBoundary analog)."""
    ndim = spec.ndim
    out = []
    for a in fields6:
        idx = []
        for d in range(ndim):
            ix = torch.remainder(
                torch.arange(-spec.off, a.shape[d] + spec.w - spec.tile[d]
                             - spec.off, device=a.device),
                a.shape[d],
            )
            shape = [1] * ndim
            shape[d] = -1
            idx.append(ix.reshape(shape))
        out.append(a[tuple(idx)])
    return tuple(out)


def _gather_table(order, galerkin, staggering, ndim):
    """Per (component, axis): the gather's shape order (reduced by one on
    the Galerkin axes) and whether the component sits at i + 1/2."""
    gorder, gstag = [], []
    for comp in _COMPS:
        for d, ax in enumerate(AXIS_NAMES[ndim]):
            reduced = galerkin and (ax in GALERKIN_AXES[comp])
            gorder.append(order - 1 if reduced else order)
            gstag.append(int(staggering[comp][d] == 0))
    return gorder, gstag


def _yee_gather_flag(ndim, galerkin, stag_items):
    stag, yee = dict(stag_items), yee_staggering(ndim)
    if any(tuple(stag[c]) != yee[c] for c in _COMPS):
        raise NotImplementedError(
            f"the {ndim}D fused kernel gathers on the Yee staggering only "
            "(the binned gates send other grids per particle, as the JAX "
            "package's do; ROADMAP.md Queue C)")
    return int(bool(galerkin))


def gather_table_2d(galerkin, stag_items):
    """The ``galerkin`` argument of K2 (1 on, 0 off).  K2 fixes its gather
    table at compile time (``csrc/fused_pic_2d.cu``): the Yee staggering,
    reduced by one order on the staggered axes with Galerkin on, as
    ``_gather_table`` builds it for the paths.  Any other staggering of the
    fields raises."""
    return _yee_gather_flag(2, galerkin, stag_items)


def gather_table_3d(galerkin, stag_items):
    """The ``galerkin`` argument of K1 (1 on, 0 off), whose gather table is
    fixed at compile time as K2's is (``csrc/fused_pic.cu``).  Any other
    staggering of the fields raises."""
    return _yee_gather_flag(3, galerkin, stag_items)


def _check(parts, counts, spec, geom, mxu, anchors, zshift, smax):
    """Validate the mode arguments; returns (counts, tiling origin, offset
    of window 0 on the last field axis)."""
    ndim = spec.ndim
    if ndim not in (2, 3):
        raise ValueError(f"tile-binned layout is 2D/3D, got ndim={ndim}")
    if mxu not in MXU_MODES:
        raise ValueError(f"tile_mxu must be one of {sorted(MXU_MODES)}, "
                         f"got {mxu!r}")
    if len(parts) != ndim + 4:
        raise ValueError(f"expected {ndim + 4} particle arrays, got "
                         f"{len(parts)}")
    lo = tuple(float(v) for v in (geom.prob_lo if anchors is None
                                  else anchors))
    if len(lo) != ndim:
        raise ValueError(f"anchors must have {ndim} entries")
    zshift = 0 if zshift is None else int(zshift)
    smax = int(smax)
    if not 0 <= zshift <= smax:
        raise ValueError(f"zshift={zshift} outside [0, smax={smax}]")
    if counts is None:
        counts = torch.ones(parts[0].shape[0], dtype=torch.int32,
                            device=parts[0].device)
    return counts, lo, smax - zshift


def _bf16(a):
    """``a`` rounded to the nearest bfloat16, in its own type."""
    return a.to(torch.bfloat16).to(a.dtype)


def _split(a):
    """The bfloat16 high part of ``a`` and the bfloat16 remainder."""
    hi = _bf16(a)
    return hi, _bf16(a - hi)


def binned_push_deposit_plain(
    params, fields6, parts, counts, *, spec, geom, order, galerkin,
    pusher_name, dt, stag_items, lo=None, zoff=0, mxu="f32",
):
    """Plain PyTorch version of K1 (3D) and K2 (2D): the arguments of
    ``binned_push_deposit`` with ``counts`` required, the tiling origin
    ``lo`` (default ``geom.prob_lo``) and ``zoff = smax - zshift``."""
    staggering = dict(stag_items)
    nd = spec.ndim
    dtype = parts[0].dtype
    dev = parts[0].device
    W, P, T = spec.w, spec.p_max, order + 3
    WT = W ** (nd - 1)  # transverse window size
    nt = spec.n_tiles
    ns = parts[0].shape[0] // nt
    lo = geom.prob_lo if lo is None else lo
    inv_dx = tuple(1.0 / d for d in geom.dx)
    dx = geom.dx
    if nd == 3:
        invdtd = (1.0 / (dt * dx[1] * dx[2]), 1.0 / (dt * dx[0] * dx[2]),
                  1.0 / (dt * dx[0] * dx[1]))
    else:  # (Jx, Jz) running sums; Jy is direct, per unit area
        invdtd = (1.0 / (dt * dx[1]), 1.0 / (dt * dx[0]))
        invvol = 1.0 / (dx[0] * dx[1])
    pusher = PUSHERS[pusher_name]
    inv_c2 = 1.0 / (_c * _c)
    gorder, gstag = _gather_table(order, galerkin, staggering, nd)

    # (n_tiles, W, WT) windows of the padded fields, layout (x, (y,z)) / (x, z)
    ar = torch.arange(W, device=dev)
    idx = tuple(broadcast_index(
        [(torch.arange(spec.tiles_per_dim[d], device=dev)
          * spec.tile[d])[:, None] + ar[None, :]
         + (zoff if d == nd - 1 else 0) for d in range(nd)], nd))
    win = [f[idx].reshape(nt, W, WT) for f in fields6]
    round_gather = mxu in ("mixed", "bf16")
    if round_gather:
        win = [_bf16(w) for w in win]
    tix = torch.arange(nt, device=dev)
    worig = []
    for d in range(nd):
        stride = 1
        for n in spec.tiles_per_dim[d + 1:]:
            stride *= n
        worig.append((tix // stride) % spec.tiles_per_dim[d] * spec.tile[d]
                     - spec.off)
    worig = torch.stack(worig).to(dtype)  # (nd, nt)
    rows = ar.to(dtype)[None, :, None]  # (1, W, 1)

    out_parts = [torch.empty_like(parts[c]) for c in range(nd + 3)]
    jw = [torch.zeros((nt, W, WT), dtype=dtype, device=dev)
          for _ in range(3)]
    viol = torch.zeros(ns * nt, dtype=torch.int32, device=dev)
    # tiles per chunk: bounds the (chunk, WT, P) intermediates; in 2D these
    # are the bands themselves, of which some twenty live at once
    budget = (256 << 20) if nd == 3 else (64 << 20)
    chunk = max(1, min(nt, budget // (WT * P * parts[0].element_size())))
    zero = torch.zeros((), dtype=dtype, device=dev)

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

    def mm(a, b):
        """J[t, i, k] = sum over p of a[t, i, p] * b[t, k, p]."""
        return torch.bmm(a, b.transpose(1, 2))

    def dot(a, b):
        """``mm`` at the deposit's precision: 'mixed' sums the three
        products of the high parts and remainders but the
        remainder-remainder one; 'bf16' rounds both operands once."""
        if mxu == "mixed":
            ah, al = _split(a)
            bh, bl = _split(b)
            return mm(ah, bh) + mm(ah, bl) + mm(al, bh)
        if mxu == "bf16":
            return mm(_bf16(a), _bf16(b))
        return mm(a, b)

    for s in range(ns):
        q = params[s, 0]
        m = params[s, 1]
        for c0 in range(0, nt, chunk):
            c1 = min(nt, c0 + chunk)
            rsel = slice(s * nt + c0, s * nt + c1)
            pin = [a[rsel] for a in parts]
            occ = counts[rsel] > 0  # (C,)
            X = [(pin[d] - lo[d]) * inv_dx[d]
                 - worig[d, c0:c1, None] for d in range(nd)]
            acache = {}

            def axis_mat(d, o, stag):
                key = (d, o, stag)
                if key not in acache:
                    acache[key] = band(X[d] - (0.5 if stag else 0.0), o)
                return acache[key]

            # ---- gather: contract the transverse axes, then the x axis
            e6 = []
            for ci in range(6):
                keys = [(gorder[ci * nd + d], gstag[ci * nd + d])
                        for d in range(nd)]
                if nd == 3:
                    trans = outer(axis_mat(1, *keys[1]),
                                  axis_mat(2, *keys[2]))
                else:
                    trans = axis_mat(1, *keys[1])
                if round_gather:
                    trans = _bf16(trans)
                h = torch.bmm(win[ci][c0:c1], trans)  # (C, W, P)
                e6.append((axis_mat(0, *keys[0]) * h).sum(dim=1)
                          + params[s, 2 + ci])
            # ---- push
            ux, uy, uz = pusher(*pin[nd:nd + 3], *e6, q, m, dt)
            gaminv = 1.0 / torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz)
                                      * inv_c2)
            vel3 = (ux * gaminv, uy * gaminv, uz * gaminv)
            vel = vel3 if nd == 3 else (vel3[0], vel3[2])  # active axes
            new = [pin[d] + vel[d] * dt for d in range(nd)] + [ux, uy, uz]
            keep = occ[:, None]
            for c in range(nd + 3):
                out_parts[c][rsel] = torch.where(keep, new[c], pin[c])
            # ---- Esirkepov deposit
            wq = q * pin[nd + 3]
            sm, df, cs = [], [], []
            bad = torch.zeros_like(occ[:, None].expand(-1, P))
            for d in range(nd):
                xn = X[d] + vel[d] * (dt * inv_dx[d])
                nn = band(xn, order)
                no = axis_mat(d, order, False)
                sm.append(nn + no)
                df.append(no - nn)
                cs.append(torch.cumsum(no - nn, dim=1))
                i0 = start_index(xn, order) - 1
                bad = bad | (i0 < 0) | (i0 > W - T)
            if nd == 3:
                jd3 = []
                for d, (a, b) in enumerate(((1, 2), (0, 2), (0, 1))):
                    lhs = cs[d] * (wq * invdtd[d])[:, None, :]
                    if mxu == "bf16":
                        # two single-pass products (pallas_pic.py:379-390)
                        jd3.append(
                            dot(0.25 * lhs, outer(sm[a], sm[b]))
                            + dot((1.0 / 12.0) * lhs, outer(df[a], df[b])))
                        continue
                    rhs = (0.25 * outer(sm[a], sm[b])
                           + (1.0 / 12.0) * outer(df[a], df[b]))
                    jd3.append(dot(lhs, rhs))
            else:
                # all three windows in layout (x, z): J[i, k] = sum over p
                # of (x-side)[i, p] * (z-side)[k, p]; the four (x-side,
                # z-side) pairs of pallas_pic.py:604-618
                wqvy = (wq * (vel3[1] * invvol))[:, None, :]
                jd3 = [
                    dot(cs[0] * (wq * invdtd[0])[:, None, :], 0.5 * sm[1]),
                    dot((0.25 * wqvy) * sm[0], sm[1])
                    + dot(((1.0 / 12.0) * wqvy) * df[0], df[1]),
                    dot(0.5 * sm[0], cs[1] * (wq * invdtd[1])[:, None, :]),
                ]
            for d in range(3):
                jw[d][c0:c1] += torch.where(occ[:, None, None], jd3[d], zero)
            alive = pin[nd + 3] > 0
            cnt = (bad & alive).sum(dim=1, dtype=torch.int32)
            viol[rsel] = torch.where(occ, cnt, torch.zeros_like(cnt))
    return tuple(out_parts), tuple(jw), viol


class _FusedPicArgs(ctypes.Structure):
    """Mirror of ``struct FusedPicArgs`` in ``csrc/fused_pic_common.cuh``
    (2D fills the first entries of the per-axis and per-column arrays)."""

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
        ("zoff", ctypes.c_int),
        ("mxu", ctypes.c_int),
        # the first design's runtime gather table, which K1 and K2 now fix
        # at compile time: kept so k1_ab.py and k2_ab.py can launch that
        # design's source on these same arguments
        ("gorder", ctypes.c_int * 18),
        ("gstag", ctypes.c_int * 18),
        ("lo", ctypes.c_double * 3),
        ("inv_dx", ctypes.c_double * 3),
        ("dt_inv_dx", ctypes.c_double * 3),
        ("invdtd", ctypes.c_double * 3),
        ("dt", ctypes.c_double),
    ]


def _stem(ndim):
    """The kernel's source and C-function prefix: K1 in 3D, K2 in 2D."""
    return "fused_pic" if ndim == 3 else "fused_pic_2d"


def _library_name(ndim, dtype, order):
    tn = "f64" if dtype == torch.float64 else "f32"
    return f"{_stem(ndim)}_{tn}_o{order}"


def _kernel_args(params, fields6, parts, counts, *, spec, geom, order,
                 galerkin, pusher_name, dt, stag_items, lo, zoff, mxu, smax):
    """Check the kernel's inputs and allocate its outputs; returns the
    ``_FusedPicArgs`` of one launch and the outputs it points to."""
    nd = spec.ndim
    dtype = parts[0].dtype
    dev = parts[0].device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused kernel takes float32/float64, got {dtype}")
    if not 1 <= order <= 3:
        raise ValueError(f"shape order {order} outside 1-3")
    if pusher_name not in _PUSHER_IDS:
        raise NotImplementedError(
            f"pusher {pusher_name!r} in the fused kernel (the binned gates "
            "keep it per particle, as the JAX package's do; ROADMAP.md "
            "Queue C)")
    nt, P, W = spec.n_tiles, spec.p_max, spec.w
    rows = parts[0].shape[0]
    ns = rows // nt
    padded = padded_shape(spec, geom.n_cell, smax)
    for f in fields6:
        if (f.dtype != dtype or f.device != dev or not f.is_contiguous()
                or tuple(f.shape) != padded):
            raise ValueError(f"fields must be contiguous {dtype} {padded} "
                             f"tensors on {dev} (pad_fields)")
    for a in parts:
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
    out_parts = tuple(torch.empty_like(parts[c]) for c in range(nd + 3))
    jw = tuple(torch.empty((nt, W, W ** (nd - 1)), dtype=dtype, device=dev)
               for _ in range(3))
    viol = torch.empty(rows, dtype=torch.int32, device=dev)
    gorder, gstag = _gather_table(order, galerkin, dict(stag_items), nd)
    dx = geom.dx
    a = _FusedPicArgs()
    a.fields[:] = [f.data_ptr() for f in fields6]
    a.parts[:nd + 4] = [p.data_ptr() for p in parts]
    a.out_parts[:nd + 3] = [p.data_ptr() for p in out_parts]
    a.jw[:] = [j.data_ptr() for j in jw]
    a.viol = viol.data_ptr()
    a.counts = counts.data_ptr()
    a.sp_params = params.data_ptr()
    a.n_sp, a.n_tiles, a.p_max, a.w, a.off = ns, nt, P, W, spec.off
    a.tiles_per_dim[:nd] = list(spec.tiles_per_dim)
    a.tile[:nd] = list(spec.tile)
    a.fdim[:nd] = list(padded)
    a.order = order
    a.pusher = _PUSHER_IDS[pusher_name]
    a.zoff = zoff
    a.mxu = MXU_MODES[mxu]
    a.gorder[:6 * nd] = gorder
    a.gstag[:6 * nd] = gstag
    a.lo[:nd] = list(lo)
    a.inv_dx[:nd] = [1.0 / d for d in dx]
    a.dt_inv_dx[:nd] = [dt * (1.0 / d) for d in dx]
    if nd == 3:
        a.invdtd[:] = [1.0 / (dt * dx[1] * dx[2]), 1.0 / (dt * dx[0] * dx[2]),
                       1.0 / (dt * dx[0] * dx[1])]
    else:  # Jx and Jz scales, then 1 / cell area for the direct Jy
        a.invdtd[:] = [1.0 / (dt * dx[1]), 1.0 / (dt * dx[0]),
                       1.0 / (dx[0] * dx[1])]
    a.dt = dt
    return a, (out_parts, jw, viol)


# The count of tiles that took K1's or K2's checked path, per (device,
# ndim): one int32 that every launch there adds to
_WIDE = {}


def _wide_counter(dev, ndim):
    key = (str(dev), ndim)
    if key not in _WIDE:
        _WIDE[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _WIDE[key]


def wide_tiles(device, ndim):
    """Tiles that took the checked path of K1 (``ndim`` 3) or K2 (2), a
    stencil outside the tile's shared box, summed over every launch so far
    on ``device``."""
    return int(_wide_counter(torch.device(device), ndim).item())


def blocks_per_sm(ndim, dtype, order, mxu):
    """Resident blocks per SM of K1 (``ndim`` 3) or K2 (2) for ``dtype``,
    ``order`` and ``mxu`` (the CUDA occupancy calculator on the current
    device)."""
    lib = _library_name(ndim, dtype, order)
    stem = _stem(ndim)
    n = getattr(build.library(lib), f"{stem}_blocks_per_sm")(MXU_MODES[mxu])
    if n < 0:
        raise RuntimeError(f"{stem} occupancy query failed: "
                           + build.cuda_error(lib, f"{stem}_error_string", -n))
    return n


def _launch_kernel(params, fields6, parts, counts, **kw):
    nd, mxu = kw["spec"].ndim, kw["mxu"]
    table = gather_table_3d if nd == 3 else gather_table_2d
    gal = table(kw["galerkin"], kw["stag_items"])
    a, (out_parts, jw, viol) = _kernel_args(params, fields6, parts, counts,
                                            **kw)
    dev = parts[0].device
    lib = _library_name(nd, parts[0].dtype, kw["order"])
    stream = torch.cuda.current_stream(dev).cuda_stream
    stem = _stem(nd)
    err = getattr(build.library(lib), f"{stem}_launch")(
        ctypes.addressof(a), gal, _wide_counter(dev, nd).data_ptr(), stream)
    if err:
        stage = {1: "device query", 2: "shared-memory opt-in", 3: "launch",
                 4: "arguments"}.get(err // 1000, "?")
        raise RuntimeError(
            f"{stem} {stage} failed: "
            f"{build.cuda_error(lib, f'{stem}_error_string', err)}"
        )
    if nd == 3:
        binned_push_deposit.launches += 1
    else:
        binned_push_deposit.launches_2d += 1
    binned_push_deposit.launches_by_mode[mxu] += 1
    return out_parts, jw, viol


def binned_push_deposit(
    params, fields6, parts7, anchors=None, zshift=None, counts=None, *,
    spec, geom, order, galerkin, pusher_name, dt, stag_items, mxu="f32",
    smax=0,
):
    """Run the fused gather + push + deposit over all tiles for all species
    of one pusher at once (kernel K1 in 3D, K2 in 2D, on CUDA tensors).

    params: (n_sp, 8) [q, m, Eext(3), Bext(3)] per species; fields6: the six
    guard-padded fields (``pad_fields``; ``smax`` cells longer on the last
    axis in moving-window mode); parts7: (x, y, z, ux, uy, uz, w) in 3D,
    (x, z, ux, uy, uz, w) in 2D, each (n_sp * n_tiles, p_max), the species'
    tile arrays stacked along the tile axis; mxu: the precision mode,
    'f32', 'mixed' or 'bf16' (module docstring); anchors: the tiling origin as
    ndim host numbers (default ``geom.prob_lo``); zshift: whole cells the
    grid has slid along the last axis since the rebin, a host int in
    [0, smax]; counts: alive particles per (species, tile) (default: all
    tiles occupied).

    Returns (new particle columns (the inputs less w), (jx_w, jy_w, jz_w)
    summed over species, violations (n_sp * n_tiles,)).  In 3D the J windows
    are (n_tiles, W, W*W) in layouts (x,(y,z)), (y,(x,z)), (z,(x,y)): fold
    them with axes (0,1,2), (1,0,2), (2,0,1).  In 2D they are (n_tiles, W,
    W), all in layout (x, z).  ``violations`` counts alive particles that
    drifted beyond the rebin margin (must be all zero).
    """
    counts, lo, zoff = _check(parts7, counts, spec, geom, mxu, anchors,
                              zshift, smax)
    kw = dict(spec=spec, geom=geom, order=order, galerkin=galerkin,
              pusher_name=pusher_name, dt=dt, stag_items=stag_items, lo=lo,
              zoff=zoff, mxu=mxu)
    dev = parts7[0].device.type
    if dev == "cpu":
        return binned_push_deposit_plain(params, fields6, parts7, counts,
                                         **kw)
    if dev != "cuda":
        raise ValueError(f"unsupported device {parts7[0].device}")
    return _launch_kernel(params, fields6, parts7, counts, smax=smax, **kw)


# launches of K1 (3D) and of K2 (2D), and of both by precision mode
binned_push_deposit.launches = 0
binned_push_deposit.launches_2d = 0
binned_push_deposit.launches_by_mode = dict.fromkeys(MXU_MODES, 0)
