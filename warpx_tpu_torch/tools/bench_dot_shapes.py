"""Lab L4: the cost of tile products against M and precision, on the card.

The Hopper counterpart of ``tools/bench_dot_shapes.py`` (the TPU lab's
Pallas kernel ``make``): for every batch entry, ``reps`` accumulated
products ``a (m, k) . b (k, n)`` with a float32 accumulator, the same total
of multiply-adds at M = 8, 16, 64 and 128.  ``tile_dot`` launches
``csrc/tile_dot.cu`` (L3 uses it too, in layout 'nt') on the plan of
``_plan_nt``, which splits K over warps and blocks in either layout;
``tile_dot_plain`` is its plain PyTorch version (``torch.matmul`` in a
loop).

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

import functools

import torch

from .. import build
from . import _timing

__all__ = ["MODES", "tile_dot", "tile_dot_plain", "dot_flops", "run_case",
           "nt_slices", "main"]

MODES = {"f32": 0, "bf16": 1, "3pass": 2}
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_MAX = 227 * 1024
# the plan's kernel paths (csrc/tile_dot.cu::kPath*): 'mma' serves layout
# NT only, 'wgmma_n' (out = a . b, m >= 64) layout NN only
NT_PATHS = {"fma": 0, "wgmma": 1, "mma": 2, "wgmma_n": 3}
# 'fma' lane shapes (TR row groups, TC column groups, RM rows a lane; TK =
# 32 / (TR TC) lanes split k): the kernel's instantiations
NT_FMA_SHAPES = ((2, 16, 8), (4, 8, 4), (2, 8, 4), (4, 2, 4))
WGMMA_N = (8, 16, 32, 64, 128)

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


def _nt_tile(path, m, tr=4, tc=8, rm=4):
    """A plan's unit: its rows (of out) and columns on ``path``."""
    if path == "fma":
        return rm * tr, 8 * tc
    if path == "wgmma":
        return next((nn for nn in WGMMA_N if nn >= m), WGMMA_N[-1]), 64
    if path == "wgmma_n":
        return 64, 8 * tc
    return 16, 16


def _nt_smem(path, tm, tn, kw, wb, mode):
    """Shared memory of a block (csrc/tile_dot.cu::plan_smem): the staged K
    slices, reused for the warps' partial sums."""
    kblk = wb * kw
    parts = 2 if mode == "3pass" else 1
    if path == "fma":
        stage = (tm + tn) * kblk * 4
    elif path in ("wgmma", "wgmma_n"):
        stage = (tm + tn) * kblk * 2 * parts
    else:
        stage = 2 * 16 * (kblk + 8) * 2 * parts
    return max(stage, wb * tm * tn * 4)


# Resident warps an SM for the 'fma' kernel at RM rows a lane (ptxas: ~100
# registers a lane at RM = 4, ~180 at RM = 8; 65536 registers an SM)
_FMA_RESIDENT_WARPS = {4: 19, 8: 11}
# The SM's rates behind NN's wgmma cost: 2048 bfloat16 multiply-adds a
# clock on the tensor cores, 128 bytes a clock of shared memory (what an
# m64nNk16 step reads: 64 x 16 + N x 16 bfloat16)
_TC_MACS, _SMEM_BYTES = 2048, 128
# registers a thread of the wgmma kernel at each N (ptxas: two
# accumulators below N = 128, one at 128), for the warpgroups an SM holds
_WGMMA_REGS = {8: 40, 16: 48, 32: 76, 64: 124, 128: 156}


def _plan_nt(batch, m, n, k, mode, layout="nt"):
    """The launch plan of ``_search_nt`` (a copy; the search is cached, so
    that a timed launch does not spend host time planning)."""
    return dict(_search_nt(batch, m, n, k, mode, layout))


def _nn_wgmma_cost(slices, kw, nn, passes, held):
    """Clocks of an SM that runs ``slices`` warpgroup slices of ``kw`` on
    m64n{nn}k16 a rep, ``held`` warpgroups at once: each k16 step the
    tensor cores' or the shared-memory port's clocks, whichever is longer;
    each rep 30 + nn / 2 more (its wait and its sum); the whole over
    1 + sqrt(16 / nn) / held, the latency that too few warpgroups leave
    open (small products suffer more).  The constants fit labs_ab.py's
    plan sweep on the card (NVIDIA H100 80GB HBM3, 700 W)."""
    step = max(64 * nn * 16 / _TC_MACS,
               (64 + nn) * 16 * 2 / _SMEM_BYTES) * passes
    rep = kw // 16 * step + 30 + nn / 2
    return slices * rep * (1 + (16 / nn) ** 0.5 / max(held, 1))


@functools.lru_cache(maxsize=None)
def _search_nt(batch, m, n, k, mode, layout="nt"):
    """Launch plan of csrc/tile_dot.cu in ``layout`` ('nt': b is (n, k);
    'nn': (k, n)): out (batch, m, n) cut into units of tm x tn, K into
    slices of ``kw``; a block of ``wb`` warps (warpgroups on the wgmma
    paths) takes one unit and wb consecutive slices, ``kb`` blocks a unit's
    K.  Paths: 'fma' for 'f32' in either layout (every lane shape of
    NT_FMA_SHAPES is a candidate); for 'bf16'/'3pass' in layout NT 'wgmma'
    where n >= 64, 'mma' below, and in layout NN 'wgmma' (out^T, N = m)
    where m < 64, else 'wgmma_n' (out = a . b, N = 64 or 128 columns of b).

    Costs.  'fma' and NT's tensor-core paths: the work of the busiest
    scheduler, four an SM: the most blocks an SM gets, their warps spread
    over its schedulers, times a warp's instructions a rep (a k costs an
    'fma' lane RM x 8 FFMA and its loads; a rep adds its sum), over 0.62
    where a scheduler holds fewer than two warps at once (the shares
    measured on the card by labs_ab.py's plan sweep); among the candidates
    that fit in shared memory it takes, where any reaches 2 x SMS warps,
    the cheapest (at equal cost the one whose lanes split k the least, then
    the deepest slices), else the one with the most warps.  NN's wgmma
    paths: the clocks of the busiest SM (``_nn_wgmma_cost``: its blocks
    times their warpgroups times a rep, less efficient the fewer
    warpgroups it holds at once); at equal cost the fewest blocks, then the
    deepest slices.
    Raises ValueError for a shape it cannot serve."""
    if min(batch, m, n, k) <= 0 or mode not in MODES or layout not in (
            "nt", "nn"):
        raise ValueError(f"no plan for batch {batch}, m {m}, n {n}, "
                         f"k {k}, mode {mode!r}, layout {layout!r}")
    passes = 3 if mode == "3pass" else 1
    if mode == "f32":
        path, shapes = "fma", NT_FMA_SHAPES
        kws, wbs = (12, 16, 24, 32, 48, 64, 96, 128), (1, 2, 4, 8)
    elif layout == "nn":
        path = "wgmma" if m < 64 else "wgmma_n"
        shapes = ((0, 0, 0),) if m < 64 else ((0, 8, 0), (0, 16, 0))
        kws = (16, 32, 48, 64, 96, 128, 192, 256)
        wbs = (1, 2)
    else:
        path, shapes = ("wgmma" if n >= 64 else "mma"), ((0, 0, 0),)
        kws = (16, 32, 48, 64, 96, 128, 192, 256)
        wbs = (1, 2) if path == "wgmma" else (1, 2, 4, 8)
    best = None
    for tr, tc, rm in shapes:
        tk = 32 // (tr * tc) if path == "fma" else 1
        tm, tn = _nt_tile(path, m, tr, tc, rm)
        units = batch * -(-m // tm) * -(-n // tn)
        for kw in kws:
            for wb in wbs:
                smem = _nt_smem(path, tm, tn, kw, wb, mode)
                if smem > SMEM_MAX or kw % tk:
                    continue
                kb = -(-k // (kw * wb))
                if wb > 1 and (kb - 1) * kw * wb + (wb - 1) * kw >= k:
                    continue  # a warp of every block would see no k
                blocks = units * kb
                bwarps = wb * (1 if path in ("fma", "mma") else 4)
                warps = blocks * bwarps
                per_sm = -(-blocks // SMS)
                if layout == "nn" and path != "fma":
                    nn = tm if path == "wgmma" else tn
                    held = wb * min(per_sm, SMEM_MAX // smem, 65536 // (
                        _WGMMA_REGS[nn] * 128 * wb))
                    cost = _nn_wgmma_cost(per_sm * wb, kw, nn, passes, held)
                    key = (cost, blocks, -kw)
                elif path == "fma":
                    rep = kw // tk * (8 * rm + rm // 4 + 2) + 8 * rm + 10
                    resident = _FMA_RESIDENT_WARPS[rm] // bwarps
                elif path == "wgmma":
                    rep = kw // 16 * passes * (4 + tm // 16) + 20
                    resident = 16 // bwarps
                else:
                    rep = kw // 16 * passes * 10 + 20
                    resident = 32 // bwarps
                if layout == "nt" or path == "fma":
                    resident = max(1, min(resident, 32,
                                          SMEM_MAX // (smem + 1024)))
                    held = min(per_sm, resident) * bwarps / 4
                    cost = (-(-per_sm * bwarps // 4) * rep
                            / (0.62 if held < 2 else 1.0))
                    key = (warps < 2 * SMS,
                           -warps if warps < 2 * SMS else cost, -tr * tc,
                           -kw)
                if best is None or key < best[0]:
                    best = (key, dict(
                        path=path, tr=tr, tc=tc, rm=rm, tk=tk, kw=kw, wb=wb,
                        kb=kb, tm=tm, tn=tn, mg=-(-m // tm), ng=-(-n // tn),
                        units=units, blocks=blocks, warps=warps, smem=smem,
                        cost=cost))
    if best is None:
        raise ValueError(f"no plan fits in shared memory: ({batch}, {m},"
                         f" {n}, {k}) {mode} {layout}")
    return best[1]


def nt_slices(plan, k):
    """The k indices of every slice of ``plan`` in the order the kernel
    adds their sums: blocks along K, their warps, the warps' TK lane
    groups (k = tk mod TK inside the warp's slice)."""
    kw, wb, tk = plan["kw"], plan["wb"], plan["tk"]
    out = []
    for kbi in range(plan["kb"]):
        for w in range(wb):
            base = kbi * kw * wb + w * kw
            for t in range(tk):
                out.append(list(range(base + t, min(base + kw, k), tk)))
    return out


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
    out = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    lib = build.library("tile_dot")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    p = _plan_nt(batch, m, n, k, mode, layout)
    scratch = (torch.empty((p["kb"], batch, m, n), dtype=torch.float32,
                           device=a.device) if p["kb"] > 1 else None)
    err = lib.tile_dot_launch(
        int(layout == "nn"), a.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), batch, m, k, n,
        int(a.dtype == torch.bfloat16), MODES[mode], reps,
        NT_PATHS[p["path"]], p["tr"], p["tc"], p["rm"], p["kw"], p["wb"],
        p["kb"], stream)
    _timing.check_launch("tile_dot", "tile_dot_error_string", err, "tile_dot")
    tile_dot.launches += 1
    return out


tile_dot.launches = 0


def dot_flops(batch, m, k, n, reps, mode, layout="nn"):
    """(useful, issued) floating-point operations: 2 m k n per product and
    rep; 'issued' counts the tiles the kernel computes, padding included
    (the plan's units over its slices, K padded to whole k16 steps on the
    tensor cores), and three products a term in '3pass'."""
    useful = 2 * batch * m * k * n * reps
    p = _plan_nt(batch, m, n, k, mode, layout)
    kpad = p["kb"] * p["wb"] * p["kw"] if p["path"] != "fma" else k
    issued = 2 * p["units"] * p["tm"] * p["tn"] * kpad * reps
    return useful, issued * (3 if mode == "3pass" else 1)


# the stacked library product's least work: enough that one call is not
# bound by its launch
STACKED_FLOP = 1e9


def run_case(label, a, b, reps, mode, layout, device, n_time=1):
    """One product shape in one mode: kernel against plain version (error
    relative to the largest output), times, TFLOP/s, bound and the
    library: one product by ``torch.bmm`` (TF32 off), timed alone, its
    TFLOP/s, and its time times ``reps`` for the same work
    (``library_ms``, launch-bound at the labs' shapes); on the card in
    layout 'nn' also one ``torch.bmm`` over ``copies`` stacked copies of
    the operands (at least STACKED_FLOP), its time over ``copies`` times
    ``reps`` (``library_stacked_ms``)."""
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
    stacked = {}
    if layout == "nn" and torch.device(device).type == "cuda":
        copies = max(1, -(-int(STACKED_FLOP) // (2 * batch * m * k * n)))
        sa, sb = la.repeat(copies, 1, 1), lb.repeat(copies, 1, 1)
        t = _timing.time_ms(lambda: torch.bmm(sa, sb), 10, device)
        stacked = {"library_stacked_ms": t / copies * reps,
                   "library_stacked_copies": copies,
                   "library_stacked": f"torch.bmm {lib_dtype} over {copies} "
                                      "stacked copies of the operands, its "
                                      "time / copies x reps"}
        del sa, sb
    useful, issued = dot_flops(batch, m, k, n, reps, mode, layout)
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
        **stacked, max_abs_err=err, max_rel_err=rel)


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
