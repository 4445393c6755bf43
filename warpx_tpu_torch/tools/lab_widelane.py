"""Lab L2: batched (S, W, 128) against wide (W, P) particle layouts for the
fused kernel's gather and deposit contractions, on the card.

The Hopper counterpart of ``tools/lab_widelane.py`` (the TPU lab's ``make``
with its bodies ``kernel_batched`` and ``kernel_wide``).  Per tile, over P
particles, with byz = bf16(ay (x) az) (W^2 rows):

    out[t, p] = sum over 4 groups g of  sum over b < W of
                ay[b, p] * (bf16(win[t, :mW]) . byz)[b, p]   mW = 2W, 2W, W, W
    jw[t]     = sum over 3 components of  lhs . byz^T   (over the particles)

``widelane`` launches ``csrc/lab_widelane.cu``; ``widelane_plain`` is its
plain PyTorch version.  The two layouts compute the same function; they
differ in the addresses of the particle axis (and, in the TPU lab, in the
shapes of its products).

Precision, as the TPU computes it (interpret mode on a CPU ignores it):

    DEFAULT (or precision=None)  both operands rounded to bfloat16, products
                                 summed in float32
    HIGH                         hi = bf16(x), lo = bf16(x - hi);
                                 hi*hi + lo*hi + hi*lo
    HIGHEST                      float32 throughout

The gather's operands are bfloat16 at DEFAULT; the deposit is 'bf16' (the
lab's "bf16-ops": DEFAULT, so lhs is rounded to bfloat16 as well) or 'f32'
(the lab's "f32-dep3x": HIGHEST, lhs in float32 against the
bfloat16-valued byz).

    python -m warpx_tpu_torch.tools.lab_widelane [--device cpu] [--nt 512]
        [--w 16] [--p 1280]
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import build
from . import _timing

__all__ = ["widelane", "widelane_plain", "make", "lab_flops", "main"]

LANES = 128


class _LabWidelaneArgs(ctypes.Structure):
    # must match csrc/lab_widelane.cu::LabWidelaneArgs
    _fields_ = [(nm, ctypes.c_void_p)
                for nm in ("win", "ay", "az", "lhs", "out", "jw")] + [
        (nm, ctypes.c_int) for nm in ("nt", "w", "p", "batched", "dep_f32")]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _wide(x, batched):
    """(S, W, 128) or (1, W, P) as (W, P)."""
    if batched:
        s, w, lanes = x.shape
        return x.permute(1, 0, 2).reshape(w, s * lanes)
    return x[0]


def widelane_plain(win, ay, az, lhs, batched, dep):
    """Plain PyTorch version (see the module's docstring); returns (out of
    shape (nt, S, 128) batched or (nt, 1, P) wide, jw (nt, W, W^2))."""
    nt, rows, w2 = win.shape
    w = rows // 2
    A, Z = _wide(ay, batched), _wide(az, batched)
    p = A.shape[1]
    byz = _bf16((A[:, None, :] * Z[None, :, :]).reshape(w2, p))
    acc = None
    for g in range(4):
        mw = rows if g < 2 else w
        h = torch.matmul(_bf16(win[:, :mw]), byz)
        r = (A * h[:, :w]).sum(dim=1)
        acc = r if acc is None else acc + r
    L = _bf16(lhs) if dep == "bf16" else lhs
    if batched:  # per 128-particle plane, then summed over the planes
        s = lhs.shape[0]
        bs = byz.reshape(w2, s, LANES).permute(1, 0, 2)
        jd = torch.matmul(L, bs.transpose(1, 2)).sum(dim=0)
        out = acc.reshape(nt, s, LANES)
    else:
        jd = torch.matmul(L[0], byz.T)
        out = acc.reshape(nt, 1, p)
    jacc = (jd + jd) + jd
    return out, jacc.expand(nt, w, w2).contiguous()


def widelane(win, ay, az, lhs, batched, dep):
    """The lab's function (see ``widelane_plain``): CUDA tensors launch
    ``csrc/lab_widelane.cu``, CPU tensors take the plain version."""
    if win.device.type == "cpu":
        return widelane_plain(win, ay, az, lhs, batched, dep)
    if win.device.type != "cuda":
        raise ValueError(f"unsupported device {win.device}")
    if dep not in ("bf16", "f32"):
        raise ValueError(f"unknown deposit precision {dep!r}")
    dev = win.device
    nt, rows, w2 = win.shape
    w = rows // 2
    if w not in (8, 16) or w2 != w * w:
        raise ValueError("win must be (nt, 2W, W^2) with W 8 or 16")
    shape = ay.shape
    p = shape[0] * shape[2] if batched else shape[2]
    want = (p // LANES, w, LANES) if batched else (1, w, p)
    if p % 64 or (batched and shape[2] != LANES):
        raise ValueError("the particle axis must be a multiple of 64 (of "
                         "128 lanes when batched)")
    _timing.check_tensor("win", win, torch.float32, dev)
    for nm, t in (("ay", ay), ("az", az), ("lhs", lhs)):
        _timing.check_tensor(nm, t, torch.float32, dev, want)
    out = torch.empty((nt, p), dtype=torch.float32, device=dev)
    jw = torch.empty((nt, w, w2), dtype=torch.float32, device=dev)
    args = _LabWidelaneArgs(win.data_ptr(), ay.data_ptr(), az.data_ptr(),
                            lhs.data_ptr(), out.data_ptr(), jw.data_ptr(),
                            nt, w, p, int(batched), int(dep == "f32"))
    err = build.library("lab_widelane").lab_widelane_launch(
        ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    _timing.check_launch("lab_widelane", "lab_widelane_error_string", err,
                         "lab_widelane")
    widelane.launches += 1
    return (out.reshape(nt, p // LANES, LANES) if batched
            else out.reshape(nt, 1, p)), jw


widelane.launches = 0


def make(mode, dep, device="cuda", nt=512, w=16, p=1280, seed=0):
    """The lab's call for layout ``mode`` ('batched' or 'wide') and deposit
    precision ``dep``: (fn, args), with random inputs from ``seed``; lhs is
    bfloat16-valued, so that the TPU's rounding of it at DEFAULT is exact."""
    rng = np.random.default_rng(seed)
    shape = (p // LANES, w, LANES) if mode == "batched" else (1, w, p)
    win = rng.normal(size=(nt, 2 * w, w * w))
    ay, az = rng.random(size=shape), rng.random(size=shape)
    lhs = _bf16(torch.tensor(rng.normal(size=shape), dtype=torch.float32))
    args = [torch.tensor(a, dtype=torch.float32) for a in (win, ay, az)]
    args.append(lhs)
    args = [a.to(device) for a in args]
    batched = mode == "batched"

    def fn(*a):
        return widelane(*a, batched, dep)

    return fn, args


def lab_flops(nt, w, p, dep):
    """{unit: operations} of one call: the four gather products (rows 2W,
    2W, W, W) on the tensor cores; the three deposit products on the tensor
    cores ('bf16') or FP32 ('f32'); byz and the row sums on FP32."""
    gather = 2 * (6 * w) * w * w * p * nt
    deposit = 3 * 2 * w * w * w * p * nt
    vector = (w * w + 4 * 2 * w) * p * nt
    if dep == "bf16":
        return {"bf16": gather + deposit, "fp32": vector}
    return {"bf16": gather, "fp32": deposit + vector}


def main(argv=None):
    def extra(p):
        p.add_argument("--nt", type=int, default=512)
        p.add_argument("--w", type=int, default=16)
        p.add_argument("--p", type=int, default=1280)

    args = _timing.lab_args(__doc__, argv, extra)
    device = torch.device(args.device)
    nt, w, p = args.nt, args.w, args.p
    results = []
    for mode in ("batched", "wide"):
        for label, dep in (("bf16-ops", "bf16"), ("f32-dep3x", "f32")):
            fn, a = make(mode, dep, device, nt, w, p)
            out, jw = fn(*a)
            ref_out, ref_jw = widelane_plain(*a, mode == "batched", dep)
            err = {nm: ((x - y).abs().max().item(),
                        (x - y).abs().max().item()
                        / max(y.abs().max().item(), 1e-30))
                   for nm, x, y in (("out", out, ref_out),
                                    ("jw", jw, ref_jw))}
            ms = _timing.time_ms(lambda: fn(*a), 10, device)
            plain_ms = _timing.time_ms(
                lambda: widelane_plain(*a, mode == "batched", dep), 3, device)
            win_b = a[0].to(torch.bfloat16)
            byz = torch.ones((w * w, p), dtype=torch.bfloat16, device=device)
            lib_ms = _timing.time_ms(lambda: torch.matmul(win_b, byz), 10,
                                     device)
            flops = lab_flops(nt, w, p, dep)
            n_bytes = _timing.nbytes(*a, out, jw)
            bound, by = _timing.bound_ms(n_bytes, flops)
            rates = {"bound_share": bound / ms,
                     "ns_per_particle": ms * 1e6 / (nt * p),
                     "largest_product_tflops":
                         2 * nt * 2 * w * w * w * p / lib_ms * 1e-9}
            res = _timing.result(
                f"L2 {mode} {label}", device, ms, plain_ms, rates=rates,
                layout=mode, dep=dep, nt=nt, w=w, p=p, bound_ms=bound,
                bound_by=by, flops=flops, bytes=n_bytes, library_ms=None,
                library="none: no single PyTorch call computes the lab's "
                        "function (two bfloat16 contractions a group, the ay "
                        "weighting, the group sum, the deposit product)",
                largest_product_ms=lib_ms,
                largest_product="torch.matmul bfloat16 (nt, 2W, W^2) . "
                                "(W^2, P): one product of the function",
                max_abs_err=max(e[0] for e in err.values()),
                max_rel_err={k: v[1] for k, v in err.items()})
            t = f"{ms:7.3f} ms" if device.type == "cuda" else \
                f"{ms:7.3f} ms on the CPU"
            print(f"{mode:8s} {label:10s}: {t}", flush=True)
            results.append(res)
    out = _timing.summary("L2 lab_widelane", device, cases=results,
                          launches=widelane.launches)
    _timing.emit(out)
    return out


if __name__ == "__main__":
    main()
