"""Lab L4: the cost of tile products against M and precision, on the card.

The Hopper counterpart of ``tools/bench_dot_shapes.py`` (the TPU lab's
Pallas kernel ``make``): for every batch entry, ``reps`` accumulated
products ``a (m, k) . b (k, n)`` with a float32 accumulator, the same total
of multiply-adds at M = 8, 16, 64 and 128.  ``tile_dot`` launches
``csrc/tile_dot.cu`` (L3 uses it too, in layout 'nt'); ``tile_dot_plain`` is
its plain PyTorch version (``torch.matmul`` in a loop).

Precision, as the TPU computes it (interpret mode on a CPU ignores it):

    DEFAULT (or precision=None)  both operands rounded to bfloat16, products
                                 summed in float32             -> mode 'bf16'
    HIGH                         hi = bf16(x), lo = bf16(x - hi);
                                 hi*hi + lo*hi + hi*lo           -> '3pass'
    HIGHEST                      float32 throughout            -> 'f32'

The TPU lab's float32 case runs at DEFAULT, so it gives the numbers of its
bfloat16 case at another cost: here both run mode 'bf16', one with float32
operands in memory and one with bfloat16 operands.

    python -m warpx_tpu_torch.tools.bench_dot_shapes [--device cpu]
        [--reps-div 1]
"""

from __future__ import annotations

import torch

from .. import build
from . import _timing

__all__ = ["MODES", "tile_dot", "tile_dot_plain", "dot_flops", "run_case",
           "main"]

MODES = {"f32": 0, "bf16": 1, "3pass": 2}
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_MAX = 227 * 1024

# The TPU lab's shapes (bench_dot_shapes.py:84-90) and workload: nt = 8
# tiles, reps = BASE_MACS // (m k n nt)
CASES = ((16, 256, 2048), (64, 256, 2048), (128, 256, 2048), (8, 256, 2048),
         (128, 2048, 256))
NT = 8
BASE_MACS = 16 * 256 * 2048 * 256 * 256


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def tile_dot_plain(a, b, reps, mode, layout="nn"):
    """Plain PyTorch version: ``reps`` times acc += a . b (b transposed in
    layout 'nt'), float32, with the operands rounded as ``mode`` rounds
    them; '3pass' adds hi.hi, hi.lo and lo.hi in that order."""
    a = a.float()
    b = b.float() if layout == "nn" else b.float().transpose(1, 2)
    if mode == "f32":
        terms = ((a, b),)
    elif mode == "bf16":
        terms = ((_bf16(a), _bf16(b)),)
    elif mode == "3pass":
        (ah, al), (bh, bl) = _split(a), _split(b)
        terms = ((ah, bh), (ah, bl), (al, bh))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    acc = torch.zeros((a.shape[0], a.shape[1], b.shape[2]),
                      dtype=torch.float32, device=a.device)
    for _ in range(reps):
        for x, y in terms:
            acc = acc + torch.matmul(x, y)
    return acc


def _warps(batch, m, n, k, mode):
    """Warps per block: as many as keep two blocks per SM in the grid and
    the staged operands within shared memory."""
    lib = build.library("tile_dot")
    for w in (4, 2, 1):
        blocks = batch * -(-m // 16) * -(-n // (8 * w))
        if (blocks >= 2 * SMS or w == 1) and lib.tile_dot_smem(
                k, MODES[mode], w) <= SMEM_MAX:
            return w
    raise ValueError(f"k = {k} does not fit in shared memory in mode {mode}")


def tile_dot(a, b, reps, mode, layout="nn"):
    """``reps`` accumulated products (see ``tile_dot_plain``): CUDA tensors
    launch ``csrc/tile_dot.cu``, CPU tensors take the plain version.  a is
    (batch, m, k); b is (batch, k, n) in layout 'nn', (batch, n, k) in
    'nt'; both float32 or both bfloat16."""
    if a.device.type == "cpu":
        return tile_dot_plain(a, b, reps, mode, layout)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if mode not in MODES or layout not in ("nn", "nt"):
        raise ValueError(f"unknown mode {mode!r} or layout {layout!r}")
    if a.dtype not in (torch.float32, torch.bfloat16) or a.dim() != 3:
        raise ValueError("a must be a (batch, m, k) float32 or bfloat16 "
                         "tensor")
    batch, m, k = a.shape
    n = b.shape[2] if layout == "nn" else b.shape[1]
    _timing.check_tensor("a", a, a.dtype, a.device)
    _timing.check_tensor("b", b, a.dtype, a.device,
                         (batch, k, n) if layout == "nn" else (batch, n, k))
    if k % (4 if mode == "f32" else 16) or (mode != "f32" and n % 8):
        raise ValueError(f"mode {mode} needs k % {4 if mode == 'f32' else 16}"
                         " == 0 and n % 8 == 0")
    out = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    err = build.library("tile_dot").tile_dot_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, m, k, n,
        int(layout == "nt"), int(a.dtype == torch.bfloat16), MODES[mode],
        reps, _warps(batch, m, n, k, mode),
        torch.cuda.current_stream(a.device).cuda_stream)
    _timing.check_launch("tile_dot", "tile_dot_error_string", err, "tile_dot")
    tile_dot.launches += 1
    return out


tile_dot.launches = 0


def dot_flops(batch, m, k, n, reps, mode):
    """(useful, issued) floating-point operations: 2 m k n per product and
    rep; 'issued' counts the m16 x n8 tiles the kernel computes, padding
    rows included, and three products a term in '3pass'."""
    useful = 2 * batch * m * k * n * reps
    issued = 2 * batch * (-(-m // 16) * 16) * k * (-(-n // 8) * 8) * reps
    return useful, issued * (3 if mode == "3pass" else 1)


def run_case(label, a, b, reps, mode, layout, device, n_time=1):
    """One product shape in one mode: kernel against plain version (error
    relative to the largest output), times, TFLOP/s, bound and the
    library: one product by ``torch.bmm`` (TF32 off), timed alone, its
    TFLOP/s, and its time times ``reps`` for the same work
    (``library_ms``)."""
    batch, m, k = a.shape
    n = b.shape[2] if layout == "nn" else b.shape[1]
    got = tile_dot(a, b, reps, mode, layout)
    ref = tile_dot_plain(a, b, reps, mode, layout)
    err = (got - ref).abs().max().item()
    rel = err / max(ref.abs().max().item(), 1e-30)
    ms = _timing.time_ms(lambda: tile_dot(a, b, reps, mode, layout), n_time,
                         device)
    plain_ms = _timing.time_ms(
        lambda: tile_dot_plain(a, b, reps, mode, layout), 1, device)
    bt = b if layout == "nn" else b.transpose(1, 2)
    lib_dtype = torch.float32 if mode == "f32" else torch.bfloat16
    la, lb = a.to(lib_dtype), bt.to(lib_dtype).contiguous()
    lib_one_ms = _timing.time_ms(lambda: torch.bmm(la, lb), 20, device)
    useful, issued = dot_flops(batch, m, k, n, reps, mode)
    unit = "fp32" if mode == "f32" else "bf16"
    work = useful * (3 if mode == "3pass" else 1)
    n_bytes = _timing.nbytes(a, b) + batch * m * n * 4
    bound, by = _timing.bound_ms(n_bytes, work, unit)
    rates = {"tflops_useful": useful / ms * 1e-9, "bound_share": bound / ms,
             "library_tflops": 2 * batch * m * k * n / lib_one_ms * 1e-9}
    return _timing.result(
        label, device, ms, plain_ms, rates=rates, mode=mode, layout=layout,
        operands=str(a.dtype).replace("torch.", ""), batch=batch, m=m, k=k,
        n=n, reps=reps, flops_useful=useful, flops_issued=issued,
        bound_ms=bound, bound_by=by, unit=unit,
        library_ms=lib_one_ms * reps,
        library_one_ms=lib_one_ms,
        library=f"torch.bmm {lib_dtype}: one product's time x reps",
        max_abs_err=err, max_rel_err=rel)


def case_line(res):
    """A case's time, rate and bound in the TPU lab's line format."""
    if "ms" not in res:
        return f"{res['cpu_ms']:8.3f} ms on the CPU (plain version)"
    return (f"{res['ms']:8.3f} ms {res['tflops_useful']:7.1f} TFLOP/s, "
            f"bound {res['bound_ms']:.3f} ms ({res['bound_by']}, "
            f"{100 * res['bound_share']:.1f} %), bmm "
            f"{res['library_tflops']:.1f} TFLOP/s")


def reps_scaling(a, b, reps, mode, layout, device):
    """The kernel's time at ``reps`` over its time at reps // 4: near 4 when
    every rep really issues its products."""
    t1 = _timing.time_ms(lambda: tile_dot(a, b, reps, mode, layout), 1,
                         device)
    t4 = _timing.time_ms(lambda: tile_dot(a, b, max(1, reps // 4), mode,
                                          layout), 1, device)
    return t1 / t4


def main(argv=None):
    def extra(p):
        p.add_argument("--reps-div", type=int, default=1,
                       help="divide every case's reps (for a quick run)")
        p.add_argument("--k-scale", type=int, default=1,
                       help="divide k and n (for a quick run on the CPU)")

    args = _timing.lab_args(__doc__, argv, extra)
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n in CASES:
            k, n = max(16, k // args.k_scale), max(8, n // args.k_scale)
            reps = max(1, BASE_MACS // (m * k * n * NT) // args.reps_div)
            # zero-mean, so that a lower precision shows in the check
            a = (torch.rand((NT, m, k), generator=gen) - 0.5).to(device,
                                                                 dtype)
            b = (torch.rand((NT, k, n), generator=gen) - 0.5).to(device,
                                                                 dtype)
            res = run_case("L4 tile_dot", a, b, reps, "bf16", "nn", device)
            name = "float32" if dtype == torch.float32 else "bfloat16"
            print(f"dtype={name:8s} M={m:4d} K={k:4d} N={n:5d} nt={NT:3d} "
                  f"inner={reps}: {case_line(res)}", flush=True)
            results.append(res)
    first = results[0]
    a = torch.rand((NT, first["m"], first["k"]), generator=gen).to(device)
    b = torch.rand((NT, first["k"], first["n"]), generator=gen).to(device)
    scaling = reps_scaling(a, b, first["reps"], "bf16", "nn", device)
    out = _timing.summary("L4 bench_dot_shapes", device, cases=results,
                          launches=tile_dot.launches)
    if device.type == "cuda":
        out["reps_scaling_x4"] = scaling
    _timing.emit(out)
    return out


if __name__ == "__main__":
    main()
