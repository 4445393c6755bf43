"""Lab L3: deposit-shaped tile products against precision, on the card.

The Hopper counterpart of ``tools/bench_deposit_prec.py`` (the TPU lab's
``make`` and, in ``main``, the 2D kernels ``kb`` and ``ks``): for every
batch entry, ``reps`` accumulated products ``a (m, K) . b (n, K)^T`` over
the particle axis K = 1152, with a float32 accumulator, at M = 16 (the 3D
deposit), 64, 128 and the gather-shaped (32, 1152); then the 2D deposit as
four (16, K) . (16, K)^T products (``dep2d-batch4``) or one stacked
(64, K) . (64, K)^T product of which a quarter is used (``dep2d-stack64``).
The kernel is ``csrc/tile_dot.cu`` in layout 'nt'
(``bench_dot_shapes.tile_dot``).

Precision, as the TPU computes it (interpret mode on a CPU ignores it):

    DEFAULT (or precision=None)  both operands rounded to bfloat16, products
                                 summed in float32             -> mode 'bf16'
    HIGH                         hi = bf16(x), lo = bf16(x - hi);
                                 hi*hi + lo*hi + hi*lo           -> '3pass'
    HIGHEST                      float32 throughout            -> 'f32'

The lab's cases: f32/HIGHEST ('f32'), f32/DEFAULT ('bf16' on float32
operands), 3-pass ('3pass') and bf16-cast ('bf16' on bfloat16 operands).

    python -m warpx_tpu_torch.tools.bench_deposit_prec [--device cpu]
        [--reps 400] [--k 1152]
"""

from __future__ import annotations

import torch

from . import _timing
from .bench_dot_shapes import case_line, reps_scaling, run_case, tile_dot

__all__ = ["CASES", "make_case", "main"]

# the TPU lab's shapes (bench_deposit_prec.py:108-113)
CASES = ((16, 256, "deposit3d"), (128, 256, "deposit3d-M128"),
         (64, 256, "deposit3d-M64"), (32, 1152, "gatherT"))
# label -> (mode, operand type)
MODES = {"f32/HIGHEST": ("f32", torch.float32),
         "f32/DEFAULT": ("bf16", torch.float32),
         "3-pass": ("3pass", torch.float32),
         "bf16-cast": ("bf16", torch.bfloat16)}
NT = 8
W2D = 16


def make_case(m, n, k, nt, dtype, device, gen):
    """Operands of one case: a (nt, m, k), b (nt, n, k), uniform in
    [-0.5, 0.5) from ``gen`` (the TPU lab used constants; random values
    make the check against the plain version see every element, and zero
    mean keeps the sums from hiding a lower precision)."""
    a = (torch.rand((nt, m, k), generator=gen) - 0.5).to(device, dtype)
    b = (torch.rand((nt, n, k), generator=gen) - 0.5).to(device, dtype)
    return a, b


def main(argv=None):
    def extra(p):
        p.add_argument("--reps", type=int, default=400)
        p.add_argument("--k", type=int, default=1152)

    args = _timing.lab_args(__doc__, argv, extra)
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    k, reps = args.k, args.reps
    results = []

    def line(label, lbl, res):
        print(f"{label:16s} {lbl:12s}: {case_line(res)}", flush=True)

    for m, n, label in CASES:
        for lbl, (mode, dtype) in MODES.items():
            a, b = make_case(m, n, k, NT, dtype, device, gen)
            res = run_case(f"L3 {label}", a, b, reps, mode, "nt", device)
            line(label, lbl, res)
            results.append(res)
    # the 2D deposit: batch of four (W, K).(W, K)^T against the stacked
    # (4W, K).(4W, K)^T of which the four diagonal blocks are used
    for lbl in ("f32/HIGHEST", "bf16-cast"):
        mode, dtype = MODES[lbl]
        a, _ = make_case(4 * W2D, 4 * W2D, k, NT, dtype, device, gen)
        ab = a.reshape(NT * 4, W2D, k)
        res = run_case("L3 dep2d-batch4", ab, ab, reps, mode, "nt", device)
        line("dep2d-batch4", lbl, res)
        results.append(res)
        res = run_case("L3 dep2d-stack64", a, a, reps, mode, "nt", device)
        # useful work: the four diagonal (W, W) blocks of the (4W, 4W) output
        res["flops_useful"] //= 4
        if "tflops_useful" in res:
            res["tflops_useful"] /= 4
        line("dep2d-stack64", lbl, res)
        results.append(res)
    a, b = make_case(16, 256, k, NT, torch.float32, device, gen)
    scaling = reps_scaling(a, b, reps, "f32", "nt", device)
    out = _timing.summary("L3 bench_deposit_prec", device, cases=results,
                          launches=tile_dot.launches)
    if device.type == "cuda":
        out["reps_scaling_x4"] = scaling
    _timing.emit(out)
    return out


if __name__ == "__main__":
    main()
