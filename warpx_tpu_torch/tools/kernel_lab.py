"""Lab L1: ablations of the fused PIC kernel's body, on the card.

The Hopper counterpart of ``tools/kernel_lab.py`` (the TPU lab's
``make_kernel``, ``make_packed_kernel`` and ``run``): per tile of W^3
cells and P particles, the six field windows (W, W^2) are gathered through
order-1 band matrices (``band``, ``yz_mat``: byz = ay (x) az, W^2 rows),
the particles take a Boris-like push, and three current windows are
deposited as sums over the particles of products of cumulative-sum and
outer-product bands.  ``lab_fused`` launches ``csrc/lab_fused.cu``, the
band-matrix formulation on the tensor cores, in chunks of ``CHUNK``
particles; ``lab_fused_plain`` is its plain PyTorch version.

Modes, as the TPU lab defines them:

    empty     memory traffic only (copies)
    full      the kernel's structure, dots at DEFAULT
    bf16      the MXU operands cast to bfloat16 (windows staged as bfloat16)
    split3    gather at DEFAULT, deposit as three bfloat16 passes
    nomxu     the dots replaced by cheap row reductions
    novpu     the band builds replaced by linear ramps (dots kept)
    prec_<g><d>  gather and deposit at d (DEFAULT), h (HIGH), x (HIGHEST)
    pk_<mode> the same with one packed window and particle array per tile

Precision, as the TPU computes it (interpret mode on a CPU ignores it):

    DEFAULT (or precision=None)  both operands rounded to bfloat16, products
                                 summed in float32
    HIGH                         hi = bf16(x), lo = bf16(x - hi);
                                 hi*hi + lo*hi + hi*lo
    HIGHEST                      float32 throughout

So 'full' and 'prec_dd' compute what 'bf16' computes (at another cost on
the TPU), and 'split3' is 'prec_dh'.

    python -m warpx_tpu_torch.tools.kernel_lab [modes ...] [--device cpu]
    (LAB_W, LAB_P, LAB_NT as in the TPU lab; default modes: empty full
    pk_empty pk_full empty)
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .. import build
from . import _timing

__all__ = ["MODES", "mode_spec", "lab_fused", "lab_fused_plain", "inputs",
           "run", "main"]

W = int(os.environ.get("LAB_W", 16))
P = int(os.environ.get("LAB_P", 2048))
NT = int(os.environ.get("LAB_NT", 512))
REPS = 10  # timed repetitions
CHUNK = 128  # particles a chunk of csrc/lab_fused.cu (kChunk)
WARPS = 16  # warps a block of csrc/lab_fused.cu (kWarps)
DEFAULT_MODES = ("empty", "full", "pk_empty", "pk_full", "empty")
MODES = ("empty", "full", "bf16", "split3", "nomxu", "novpu") + tuple(
    f"prec_{g}{d}" for g in "dhx" for d in "dhx")

_PREC = {"d": "bf16", "h": "3pass", "x": "f32"}
_KIND = {"empty": 0, "dot": 1, "nomxu": 2}
_DOT = {None: 0, "f32": 0, "bf16": 1, "3pass": 2}
Q_M = 1.7e11 * 0.5e-12
# order-1 Yee galerkin keys per component: ((order, staggered) per axis)
KEYSETS = (
    ((0, True), (1, False), (1, False)),
    ((1, False), (0, True), (1, False)),
    ((1, False), (1, False), (0, True)),
    ((1, False), (0, True), (0, True)),
    ((0, True), (1, False), (0, True)),
    ((0, True), (0, True), (1, False)),
)
PAIRS = ((1, 2), (0, 2), (0, 1))  # (a, b) of the outer products of jx, jy, jz


def mode_spec(mode):
    """What a mode computes: kind ('empty', 'dot', 'nomxu'), band
    ('spline' or 'linear'), the gather's and the deposit's precision
    ('bf16', '3pass', 'f32'), whether the windows are staged as bfloat16,
    and whether the layout is packed."""
    packed = mode.startswith("pk_")
    inner = mode[3:] if packed else mode
    spec = dict(kind="dot", band="spline", gather="bf16", deposit="bf16",
                stage_bf16=False, packed=packed)
    if inner == "empty":
        spec.update(kind="empty", gather=None, deposit=None)
    elif inner == "nomxu":
        spec.update(kind="nomxu", gather=None, deposit=None)
    elif inner == "novpu":
        spec.update(band="linear")
    elif inner == "bf16":
        spec.update(stage_bf16=True)
    elif inner == "split3":
        spec.update(deposit="3pass")
    elif inner.startswith("prec_") and len(inner) == 7 and all(
            c in _PREC for c in inner[5:]):
        spec.update(gather=_PREC[inner[5]], deposit=_PREC[inner[6]])
    elif inner != "full":
        raise ValueError(f"unknown mode {mode!r}")
    return spec


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _dot(a, b, prec):
    """a (nt, m, k) . b (nt, k, n) at the TPU's precision ``prec``."""
    if prec == "bf16":
        return torch.matmul(_bf16(a), _bf16(b))
    if prec == "3pass":
        ah, bh = _bf16(a), _bf16(b)
        al, bl = _bf16(a - ah), _bf16(b - bh)
        return (torch.matmul(ah, bh) + torch.matmul(al, bh)
                + torch.matmul(ah, bl))
    return torch.matmul(a, b)


def _band(xc, w, linear, order):
    """(nt, W, P) band of coordinates ``xc`` (nt, P) over window rows."""
    xi = xc[:, None, :] - torch.arange(w, dtype=xc.dtype,
                                       device=xc.device)[:, None]
    if linear:
        return xi * 0.25
    if order == 0:
        return ((xi >= -0.5) & (xi < 0.5)).to(xc.dtype)
    return torch.clamp(1.0 - xi.abs(), min=0.0)


def _scan(diff):
    """Inclusive cumulative sum over the rows by doubling, in the TPU
    lab's order of additions."""
    acc = diff
    w = diff.shape[1]
    s = 1
    while s < w:
        nxt = acc.clone()
        nxt[:, s:] = acc[:, s:] + acc[:, :-s]
        acc = nxt
        s *= 2
    return acc


def _outer(a, b):
    nt, w, p = a.shape
    return (a[:, :, None, :] * b[:, None, :, :]).reshape(nt, w * w, p)


def _body_plain(spec, wins, parts):
    """The lab's body on unpacked views: wins 6 x (nt, W, W^2), parts 7 x
    (nt, P); returns 6 x (nt, P) and 3 x (nt, W, W^2)."""
    x, y, z, ux0, uy0, uz0, wq = parts
    pos = (x, y, z)
    if spec["kind"] == "empty":
        return ([p_ * 1.0001 for p_ in pos] + [u + wq for u in (ux0, uy0,
                                                                uz0)],
                [wins[i] + wins[i + 3] for i in range(3)])
    nt, w, w2 = wins[0].shape
    linear = spec["band"] == "linear"
    X = [p_ * 0.1 for p_ in pos]
    axis = {}

    def axis_mat(d, o, stag):
        if (d, o, stag) not in axis:
            axis[d, o, stag] = _band(X[d] - (0.5 if stag else 0.0), w,
                                     linear, o)
        return axis[d, o, stag]

    e6 = []
    for (kx, ky, kz), win in zip(KEYSETS, wins):
        byz = _outer(axis_mat(1, *ky), axis_mat(2, *kz))
        if spec["kind"] == "nomxu":
            h = byz[:, :w, :] + win[:, :, 0:1]
        else:
            h = _dot(win, byz, spec["gather"])
        e6.append((axis_mat(0, *kx) * h).sum(dim=1))
    ex, ey, ez, bx, by, bz = e6
    ux, uy, uz = ux0 + Q_M * ex, uy0 + Q_M * ey, uz0 + Q_M * ez
    tx, ty, tz = Q_M * bx, Q_M * by, Q_M * bz
    upx = ux + uy * tz - uz * ty
    upy = uy + uz * tx - ux * tz
    upz = uz + ux * ty - uy * tx
    s = 2.0 / (1.0 + tx * tx + ty * ty + tz * tz)
    ux = ux + (upy * tz - upz * ty) * s + Q_M * ex
    uy = uy + (upz * tx - upx * tz) * s + Q_M * ey
    uz = uz + (upx * ty - upy * tx) * s + Q_M * ez
    gaminv = torch.rsqrt(1.0 + (ux * ux + uy * uy + uz * uz) * 1e-17)
    vel = (ux * gaminv, uy * gaminv, uz * gaminv)
    outs = [pos[d] + vel[d] * 1e-12 for d in range(3)] + [ux, uy, uz]
    sm, df, cs = [], [], []
    for d in range(3):
        nn = _band(X[d] + vel[d] * 1e-4, w, linear, 1)
        no = axis_mat(d, 1, False)
        sm.append(nn + no)
        df.append(no - nn)
        cs.append(_scan(no - nn))
    jw = []
    for d, (a, b) in enumerate(PAIRS):
        lhs = cs[d] * wq[:, None, :]
        if spec["kind"] == "nomxu":
            jd = lhs.sum(dim=2, keepdim=True) + _outer(sm[a], sm[b])[
                :, :w, :w2]
        else:
            prec = spec["deposit"]
            jd = (_dot(0.25 * lhs, _outer(sm[a], sm[b]).transpose(1, 2),
                       prec)
                  + _dot((1.0 / 12.0) * lhs,
                         _outer(df[a], df[b]).transpose(1, 2), prec))
        jw.append(jd)
    return outs, jw


def lab_fused_plain(mode, wins, parts, packed=False):
    """Plain PyTorch version of the lab's body in ``mode`` (see the
    module's docstring).  Unpacked: ``wins`` 6 x (NT, W, W^2), ``parts``
    7 x (NT, 1, P); returns (6 x (NT, 1, P), 3 x (NT, W, W^2)).  Packed:
    ``wins`` (NT, 6, W, W^2), ``parts`` (NT, 7, 1, P); returns
    ((NT, 6, 1, P), (NT, 3, W, W^2))."""
    spec = mode_spec(mode)
    if packed:
        outs, jw = _body_plain(spec, wins.unbind(1),
                               [p_[:, 0] for p_ in parts.unbind(1)])
        return (torch.stack(outs, dim=1)[:, :, None, :],
                torch.stack(jw, dim=1))
    outs, jw = _body_plain(spec, wins, [p_[:, 0] for p_ in parts])
    return [o[:, None, :] for o in outs], jw


class _LabFusedArgs(ctypes.Structure):
    # must match csrc/lab_fused.cu::LabFusedArgs
    _fields_ = [("win", ctypes.c_void_p * 6),
                ("win_stride", ctypes.c_longlong),
                ("parts", ctypes.c_void_p * 7),
                ("part_stride", ctypes.c_longlong),
                ("pout", ctypes.c_void_p * 6),
                ("pout_stride", ctypes.c_longlong),
                ("jw", ctypes.c_void_p * 3), ("jw_stride", ctypes.c_longlong)
                ] + [(nm, ctypes.c_int) for nm in (
                    "nt", "w", "p", "kind", "band_linear", "gather",
                    "deposit")]


def lab_fused(mode, wins, parts, packed=False):
    """The lab's body in ``mode`` (see ``lab_fused_plain``, same arguments
    and results): CUDA tensors launch ``csrc/lab_fused.cu``, CPU tensors
    take the plain version."""
    first = wins if packed else wins[0]
    if first.device.type == "cpu":
        return lab_fused_plain(mode, wins, parts, packed)
    if first.device.type != "cuda":
        raise ValueError(f"unsupported device {first.device}")
    spec = mode_spec(mode)
    if spec["packed"] != packed:
        raise ValueError(f"mode {mode!r} with packed={packed}")
    dev = first.device
    f32 = torch.float32
    if packed:
        nt, _, w, w2 = wins.shape
        p = parts.shape[-1]
        _timing.check_tensor("wins", wins, f32, dev, (nt, 6, w, w * w))
        _timing.check_tensor("parts", parts, f32, dev, (nt, 7, 1, p))
        pout = torch.empty((nt, 6, 1, p), dtype=f32, device=dev)
        jout = torch.empty((nt, 3, w, w2), dtype=f32, device=dev)
        win_p = [wins[:, i].data_ptr() for i in range(6)]
        part_p = [parts[:, i].data_ptr() for i in range(7)]
        pout_p = [pout[:, i].data_ptr() for i in range(6)]
        jw_p = [jout[:, i].data_ptr() for i in range(3)]
        strides = (6 * w * w2, 7 * p, 6 * p, 3 * w * w2)
    else:
        nt, w, w2 = wins[0].shape
        p = parts[0].shape[-1]
        for i, t in enumerate(wins):
            _timing.check_tensor(f"wins[{i}]", t, f32, dev, (nt, w, w * w))
        for i, t in enumerate(parts):
            _timing.check_tensor(f"parts[{i}]", t, f32, dev, (nt, 1, p))
        pouts = [torch.empty((nt, 1, p), dtype=f32, device=dev)
                 for _ in range(6)]
        jws = [torch.empty((nt, w, w2), dtype=f32, device=dev)
               for _ in range(3)]
        win_p = [t.data_ptr() for t in wins]
        part_p = [t.data_ptr() for t in parts]
        pout_p = [t.data_ptr() for t in pouts]
        jw_p = [t.data_ptr() for t in jws]
        strides = (w * w2, p, p, w * w2)
    if w not in (8, 16) or p % 64:
        # the last chunk of CHUNK particles may be half full
        raise ValueError("lab_fused takes W 8 or 16 and P a multiple of 64")
    if spec["kind"] == "nomxu" and p < w2:
        raise ValueError("mode nomxu needs P >= W^2 (the TPU lab slices "
                         "W^2 particles)")
    args = _LabFusedArgs(
        (ctypes.c_void_p * 6)(*win_p), strides[0],
        (ctypes.c_void_p * 7)(*part_p), strides[1],
        (ctypes.c_void_p * 6)(*pout_p), strides[2],
        (ctypes.c_void_p * 3)(*jw_p), strides[3],
        nt, w, p, _KIND[spec["kind"]], int(spec["band"] == "linear"),
        _DOT[spec["gather"]], _DOT[spec["deposit"]])
    err = build.library("lab_fused").lab_fused_launch(
        ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    _timing.check_launch("lab_fused", "lab_fused_error_string", err,
                         "lab_fused")
    lab_fused.launches += 1
    return (pout, jout) if packed else (pouts, jws)


lab_fused.launches = 0


def resources(mode, w):
    """The kernel's shared memory (bytes) and resident blocks per SM in
    ``mode`` at width ``w`` (on the card)."""
    spec = mode_spec(mode)
    args = (w, _KIND[spec["kind"]], _DOT[spec["gather"]],
            _DOT[spec["deposit"]])
    lib = build.library("lab_fused")
    return {"smem_bytes": lib.lab_fused_smem(*args),
            "blocks_per_sm": lib.lab_fused_blocks_per_sm(*args)}


def inputs(mode, nt, w, p, seed=0, device="cpu"):
    """The TPU lab's inputs for ``mode`` (``run``, :250-284): windows of
    standard normals and particle rows uniform in [0, 1), float32, from
    numpy's generator at ``seed``, in the lab's order.  Returns (wins,
    parts, packed)."""
    rng = np.random.default_rng(seed)
    f32 = torch.float32
    if mode.startswith("pk_"):
        wins = torch.tensor(rng.normal(size=(nt, 6, w, w * w)), dtype=f32)
        parts = torch.tensor(rng.random(size=(nt, 7, 1, p)), dtype=f32)
        return wins.to(device), parts.to(device), True
    wins = tuple(torch.tensor(rng.normal(size=(nt, w, w * w)),
                              dtype=f32).to(device) for _ in range(6))
    parts = tuple(torch.tensor(rng.random(size=(nt, 1, p)),
                               dtype=f32).to(device) for _ in range(7))
    return wins, parts, False


def lab_flops(mode, nt, w, p):
    """{unit: operations} of one call in ``mode``, counted from the lab's
    body: the gather products (6 x 2 W W^2 P) and deposit products (3 x 2 x
    2 W W^2 P) at their precision's unit (three products a term at HIGH);
    the band builds, byz, the row sums, the push, the scans and the outer
    products on FP32.  'empty' has 3 W^3 + 6 P additions or scalings."""
    spec = mode_spec(mode)
    if spec["kind"] == "empty":
        return {"fp32": nt * (3 * w * w * w + 6 * p)}
    vec = p * (6 * 3 * w          # six axis bands
               + 6 * w * w        # byz
               + 6 * 2 * w        # the gather's row sums
               + 60               # the push
               + 3 * (3 * w + 2 * w + 4 * w)  # nn, sm/df, the scan
               + 3 * (w + 2 * w * w + 2 * w))  # lhs, outer products, scales
    if spec["kind"] == "nomxu":
        return {"fp32": nt * (vec + 6 * w * p + 3 * w * p)}
    out = {"fp32": nt * vec, "bf16": 0}
    for prec, flops in ((spec["gather"], 6 * 2 * w * w * w * p),
                        (spec["deposit"], 3 * 2 * 2 * w * w * w * p)):
        if prec == "f32":
            out["fp32"] += nt * flops
        else:
            out["bf16"] += nt * flops * (3 if prec == "3pass" else 1)
    return out


def run(mode, device="cuda"):
    """One mode at the lab's shapes (``W``, ``P``, ``NT``): kernel against
    plain version, times, bound; prints the TPU lab's line and returns the
    result dict."""
    nt, w, p = NT, W, P
    device = torch.device(device)
    wins, parts, packed = inputs(mode, nt, w, p, device=device)
    got = lab_fused(mode, wins, parts, packed)
    ref = lab_fused_plain(mode, wins, parts, packed)
    flat = (lambda r: list(r[0]) + list(r[1])) if not packed else (
        lambda r: [r[0], r[1]])
    errs = []
    for a, b in zip(flat(got), flat(ref)):
        d = (a - b).abs().max().item()
        errs.append((d, d / max(b.abs().max().item(), 1e-30)))
    ms = _timing.time_ms(lambda: lab_fused(mode, wins, parts, packed), REPS,
                         device)
    plain_ms = _timing.time_ms(
        lambda: lab_fused_plain(mode, wins, parts, packed), 1, device)
    n_bytes = (_timing.nbytes(*([wins] if packed else wins),
                              *([parts] if packed else parts))
               + nt * (6 * p + 3 * w * w * w) * 4)
    flops = lab_flops(mode, nt, w, p)
    bound, by = _timing.bound_ms(n_bytes, flops)
    rates = {"ns_per_particle": ms * 1e6 / (nt * p), "bound_share": bound / ms}
    res = _timing.result(
        f"L1 {mode}", device, ms, plain_ms, rates=rates, mode=mode, nt=nt,
        w=w, p=p, bound_ms=bound, bound_by=by, flops=flops, bytes=n_bytes,
        library_ms=None,
        library="none: no single PyTorch call computes the fused body",
        max_abs_err=max(e[0] for e in errs),
        max_rel_err=max(e[1] for e in errs))
    t = f"{ms:7.3f} ms   {ms * 1e6 / (nt * p):6.2f} ns/p" if \
        device.type == "cuda" else f"{ms:7.3f} ms on the CPU"
    print(f"{mode:8s}: {t}", flush=True)
    return res


def main(argv=None):
    def extra(p):
        p.add_argument("modes", nargs="*", default=list(DEFAULT_MODES))

    args = _timing.lab_args(__doc__, argv, extra)
    print(f"device={args.device}  W={W} P={P} NT={NT} "
          f"(= {NT * P / 1e6:.1f}M slots)")
    results = [run(m, args.device) for m in args.modes]
    out = _timing.summary("L1 kernel_lab", args.device, cases=results,
                          launches=lab_fused.launches)
    _timing.emit(out)
    return out


if __name__ == "__main__":
    main()
