"""The Hopper labs L2 (``warpx_tpu_torch/csrc/lab_widelane.cu``), L3 and
L4 (``csrc/tile_dot.cu``, layouts NT and NN) and, when asked, L1
(``csrc/lab_fused.cu``) against a parent source and against ablations, at
the labs' shapes, on one card.

    python3 labs_ab.py [l1] [l2] [l3] [l4] [rates] [phases] [--log FILE]
                                        (default: l2 l3 l4 rates)

Run from the repository's root, beside ``chip_smoke.py``, whose helpers it
uses.  ``_ab/parent/`` (git-ignored) holds the parent commit's
``tile_dot.cu`` and ``lab_widelane.cu`` (and, for ``l1``, the first L1
design's ``lab_fused.cu``, which L1_PARENTS edits):

    mkdir -p _ab/parent && for f in tile_dot.cu lab_widelane.cu; do
      git show <rev>:warpx_tpu_torch/csrc/$f > _ab/parent/$f; done

Each variant is a copy of a source with the named edits (*_PARENTS of a
parent's source, *_VARIANTS of this one's), built by ``nvcc`` into
``warpx_tpu_torch/_build/labs_ab/`` (git-ignored); an ablation marked
``timing_only`` computes wrong outputs and exists for its time.

- L2: the lab's four cases (batched and wide, deposit 'bf16' and 'f32';
  W = 16, P = 1280, NT = 512, ``lab_widelane.make``): the parent, this
  kernel, no deposit products, no gather products, and the byz values of
  either product's A fragments not formed (constant fragments: what
  forming byz twice a chunk costs).
- L3: every case of ``bench_deposit_prec`` (layout NT, 400 reps): the
  parent's and this kernel at the plan ``_plan_nt`` makes for both, and on
  the wgmma path this kernel with one accumulator at every wgmma N (a wait
  for each rep's products before the next rep is issued, the parent's
  schedule) and with two at every N.
- L4: every case of ``bench_dot_shapes`` (layout NN, mode 'bf16', float32
  and bfloat16 operands): the parent's first design; this kernel at its
  plan; one accumulator at every wgmma N, and two at every N; K
  split over twice the blocks (more units an SM); at m >= 64, N = 64
  columns and the out^T orientation (N = m); at K = 2048 the parent on
  the operands cut along K into the plan's slices as batch entries, their
  sums added after (split K only).
- L1: the lab's inputs (W = 16, P = 2048, NT = 512, ``kernel_lab.inputs``)
  in the modes 'full', 'bf16' and 'empty', the first design's ablations.
- rates: the tensor-core instructions alone (mma.sync, wgmma with A in
  registers, wgmma with both operands from shared memory at N = 8-128).
- phases: the seconds of ``chip_smoke.py``'s lab phases (the four lab
  libraries' build, ``lab_parity``, ``labs``) in the parent commit's whole
  tree, unpacked in ``_ab/parent_tree/`` (``git archive <rev> | tar -x -C
  _ab/parent_tree``), and in this one, each in its own process, in the
  order parent, this, this, parent.

Every variant that is not timing-only is held against the parent's
outputs at the lab tolerance (chip_smoke.TOL_LABS); then ten launches
timed with CUDA events, three rounds in the order first..last,
last..first.  Prints one JSON line per result, as ``k2_ab.py`` does (and
appends them to FILE with ``--log FILE``).
"""

from __future__ import annotations

import ctypes
import functools
import json
import pathlib
import subprocess
import time

import numpy as np
import torch

import sys

import chip_smoke as cs

from warpx_tpu_torch import build
from warpx_tpu_torch.tools import bench_deposit_prec as l3
from warpx_tpu_torch.tools import bench_dot_shapes as dots
from warpx_tpu_torch.tools import kernel_lab as l1
from warpx_tpu_torch.tools import lab_widelane as l2

ROOT = pathlib.Path(__file__).resolve().parent
PARENT = ROOT / "_ab" / "parent"
SRC = ROOT / "warpx_tpu_torch" / "csrc"
OUT = ROOT / "warpx_tpu_torch" / "_build" / "labs_ab"
LOG = []  # the --log file, if any

# the tensor-core product replaced by an exclusive-or of its operands into
# one accumulator register, so that the operands stay live (a product whose
# PTX reads no operand lets ptxas drop the work that builds them)
_NO_MMA = ('''      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"''',
           '''      "{ .reg .b32 t; xor.b32 t, %4, %5; xor.b32 t, t, %6; "
      "xor.b32 t, t, %7; xor.b32 t, t, %8; xor.b32 t, t, %9; "
      "mov.b32 %1, t; }\\n"''')

# (old, new) edits of the parent's lab_fused.cu, each found exactly once
L1_PARENTS = {
    "parent": [],
    # no push: the velocities stay as the last chunk left them
    "parent_nopush": [("    if (tid < kChunk) {\n      const int j = tid;",
                       "    if (false) {\n      const int j = tid;")],
    # no deposit products (J stays zero)
    "parent_nodep": [("      for (int k0 = 0; k0 < kChunk; k0 += 16) {\n"
                      "        // A: 0.25 lhs",
                      "      for (int k0 = 0; k0 < 0; k0 += 16) {\n"
                      "        // A: 0.25 lhs")],
    # byz as one load from a band array, not a product formed per
    # instruction (wrong gather)
    "parent_byz1": [("              y[f] = mul(ay[(q >> lw) * kSp + pj],\n"
                     "                         az[(q & (W - 1)) * kSp + pj]);",
                     "              y[f] = az[(q & (W - 1)) * kSp + pj];")],
    # no tensor-core products (wrong outputs)
    "parent_nomma": [_NO_MMA],
}
TIMING_ONLY = {"parent_nopush", "parent_nodep", "parent_byz1", "parent_nomma",
               "nodep", "nomma", "nogather", "nobands", "l2_nodep",
               "l2_nogather", "l2_gather_byz_free", "l2_dep_byz_free"}

# (old, new) edits of csrc/lab_widelane.cu, each found exactly once
L2_VARIANTS = {
    "l2_new": [],
    # no deposit products ('bf16': its k-steps; 'f32': its particles)
    "l2_nodep": [("      for (int ks = 0; ks < kChunk / 16; ++ks) {",
                  "      for (int ks = 0; ks < 0; ++ks) {"),
                 ("        for (int j = 0; j < kChunk; j += 4) {",
                  "        for (int j = 0; j < 0; j += 4) {")],
    # no gather products (the fields are garbage)
    "l2_nogather": [("    for (int s2 = 0; s2 < KS; s2 += 2) {",
                     "    for (int s2 = 0; s2 < 0; s2 += 2) {")],
    # the gather's A fragments constant: no byz formed for it
    "l2_gather_byz_free": [
        ("          f[2 * e] = wgmma::pack_bf16(__fmul_rn(y0, z[e][0][0]),\n"
         "                                      __fmul_rn(y0, z[e][0][1]));\n"
         "          f[2 * e + 1] = wgmma::pack_bf16(__fmul_rn(y1, z[e][1][0]),\n"
         "                                          __fmul_rn(y1, z[e][1][1]));",
         "          f[2 * e] = 0x3f803f80u + s;\n"
         "          f[2 * e + 1] = 0x3f803f80u + e;")],
    # the deposit's A fragments constant: no byz formed for it
    "l2_dep_byz_free": [
        ("              f[2 * e + h] = wgmma::pack_bf16(__fmul_rn(y.x, zz[h][e].x),\n"
         "                                              __fmul_rn(y.y, zz[h][e].y));",
         "              f[2 * e + h] = 0x3f803f80u + mt + ks;")],
}
# layout NN plans (kw, wb) timed beside _plan_nt's at float32 operands
L4_PLANS = ((256, 1), (128, 1), (64, 1), (32, 1), (128, 2), (64, 2))

# (old, new) edits of csrc/tile_dot.cu
L4_VARIANTS = {
    "l4_new": [],
    # the wgmma paths (both layouts) with one accumulator at every N: a
    # wait for each rep's products before the next rep is issued
    "l4_wait_per_rep": [("constexpr bool kTwoAcc = N < 128;",
                         "constexpr bool kTwoAcc = false;")],
    # two accumulators at N = 128 too
    "l4_two_acc_n128": [("constexpr bool kTwoAcc = N < 128;",
                         "constexpr bool kTwoAcc = true;")],
}

# The tensor-core instructions' rates on this card: mma.sync m16n8k16 and
# wgmma m64n16k16 (A from registers, B from shared memory) with 1-8
# independent accumulators a warp (a warpgroup), 264 blocks of 4-16 warps,
# bfloat16 in, float32 sums (the numbers are not checked: they are rates).
MMA_RATES_CU = r"""
#include <cstdint>
#include <cstdio>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a, uint32_t b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a), "r"(a + 1), "r"(a + 2), "r"(a + 3), "r"(b),
                 "r"(b + 1));
}
template <int NACC>
__global__ void k_mma(float* out, int iters) {
  float c[NACC][4] = {};
  const uint32_t a = threadIdx.x * 2654435761u, b = threadIdx.x ^ 0x3f803f80u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) mma(c[j], a, b + j);
  }
  float s = 0;
  for (int j = 0; j < NACC; ++j) s += c[j][0] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__device__ __forceinline__ void wg16(float (&d)[8], uint32_t a, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
               "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, 0;"
               "\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                 "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
               : "r"(a), "r"(a + 1), "r"(a + 2), "r"(a + 3), "l"(db)
               : "memory");
}
template <int NACC>
__global__ void k_wgmma(float* out, int iters) {
  __shared__ __align__(128) __nv_bfloat16 bs[16 * 16 * 8];
  for (int i = threadIdx.x; i < 16 * 16 * 8; i += blockDim.x)
    bs[i] = __float2bfloat16(0.001f * (i % 7));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(bs));
  const uint64_t db = ((addr >> 4) & 0x3FFF) | (uint64_t(256 >> 4) << 16) |
                      (uint64_t(128 >> 4) << 32);
  float d[NACC][8] = {};
  const uint32_t a = threadIdx.x * 2654435761u;
  for (int i = 0; i < iters; ++i) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < NACC; ++j) wg16(d[j], a + j, db);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float s = 0;
  for (int j = 0; j < NACC; ++j) s += d[j][0] + d[j][7];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// both operands from shared memory by descriptor: sixteen m64nNk16 a
// group into one accumulator, then its wait, as a rep of tile_dot's NN
template <int N>
__global__ void k_wgmma_ss(float* out, int iters) {
  __shared__ __align__(128) __nv_bfloat16 s[(64 + 128) * 16];
  for (int i = threadIdx.x; i < (64 + 128) * 16; i += blockDim.x)
    s[i] = __float2bfloat16(0.001f * (i % 7));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t da = wgmma::desc(s, 64 / 8 * 128, 128);
  const uint64_t db = wgmma::desc(s + 64 * 16, N / 8 * 128, 128);
  float d[N / 2] = {};
  for (int i = 0; i < iters; ++i) {
    wgmma::fence_regs(d);
    wgmma::fence();
#pragma unroll
    for (int j = 0; j < 16; ++j) wgmma::SS<N>::mma(d, da, db, 1);
    wgmma::commit();
    wgmma::wait<0>();
  }
  wgmma::fence_regs(d);
  float t = 0;
  for (int j = 0; j < N / 2; ++j) t += d[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}
template <typename K>
void run(const char* name, K kern, int threads, double macs_per_warp_iter,
         int warps_per_unit) {
  const int blocks = 264, iters = 4096;
  float* out;
  cudaMalloc(&out, sizeof(float) * threads * blocks);
  kern<<<blocks, threads>>>(out, 10);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  kern<<<blocks, threads>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double flops = 2.0 * macs_per_warp_iter * threads / 32.0 /
                       warps_per_unit * blocks * iters;
  printf("{\"kind\": \"rate\", \"kernel\": \"%s\", \"warps\": %d, "
         "\"ms\": %.4f, \"tflops\": %.1f, \"error\": \"%s\"}\n",
         name, threads / 32, ms, flops / ms * 1e-9,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}
int main() {
  for (int w : {4, 8, 16}) {
    run("mma.sync acc1", k_mma<1>, 32 * w, 2048.0, 1);
    run("mma.sync acc2", k_mma<2>, 32 * w, 2048.0 * 2, 1);
    run("mma.sync acc4", k_mma<4>, 32 * w, 2048.0 * 4, 1);
    run("mma.sync acc8", k_mma<8>, 32 * w, 2048.0 * 8, 1);
  }
  for (int w : {4, 8, 16}) {
    run("wgmma m64n16k16 RS acc1", k_wgmma<1>, 32 * w, 16384.0, 4);
    run("wgmma m64n16k16 RS acc2", k_wgmma<2>, 32 * w, 16384.0 * 2, 4);
    run("wgmma m64n16k16 RS acc4", k_wgmma<4>, 32 * w, 16384.0 * 4, 4);
  }
  for (int w : {4, 8}) {
    run("wgmma m64n8k16 SS x16", k_wgmma_ss<8>, 32 * w, 16 * 8192.0, 4);
    run("wgmma m64n16k16 SS x16", k_wgmma_ss<16>, 32 * w, 16 * 16384.0, 4);
    run("wgmma m64n64k16 SS x16", k_wgmma_ss<64>, 32 * w, 16 * 65536.0, 4);
    run("wgmma m64n128k16 SS x16", k_wgmma_ss<128>, 32 * w, 16 * 131072.0,
        4);
  }
  return 0;
}
"""

# (old, new) edits of csrc/lab_fused.cu, each found exactly once
L1_VARIANTS = {
    "new": [],
    # chunks of 64 particles and 8 warps (a particle tile a warp, the
    # deposit's shared memory halved)
    "c64": [("constexpr int kChunk = 128;", "constexpr int kChunk = 64;"),
            ("constexpr int kWarps = 16;", "constexpr int kWarps = 8;")],
    # 8 warps a block: two particle tiles and two J^T m tiles a warp (each
    # window fragment and second-factor row serves two)
    "w8": [("constexpr int kWarps = 16;", "constexpr int kWarps = 8;")],
    "nodep": [("    for (int ks = kgi; ks < C / 16; ks += KG) {",
               "    for (int ks = kgi; ks < 0; ks += KG) {")],
    "nomma": [_NO_MMA],
    # no gather products or A fragments at DEFAULT (the fields stay zero)
    "nogather": [("    for (int s = 0; s < W2 / 16; ++s) {",
                  "    for (int s = 0; s < 0; ++s) {")],
    # no push and no deposit bands (stale sm, df, lhs; no particles out)
    "nobands": [("    for (int i = tid; i < 3 * C; i += blockDim.x) {\n"
                 "      const int d = i / C, j = i % C;\n"
                 "      const float ex",
                 "    for (int i = tid; i < 0; i += blockDim.x) {\n"
                 "      const int d = i / C, j = i % C;\n"
                 "      const float ex")],
    # the gather's and the deposit's k-steps unrolled by two
    "gunroll2": [("    for (int s = 0; s < W2 / 16; ++s) {",
                  "#pragma unroll 2\n    for (int s = 0; s < W2 / 16; ++s) {")],
    "dunroll2": [("    for (int ks = kgi; ks < C / 16; ks += KG) {",
                  "#pragma unroll 2\n    for (int ks = kgi; ks < C / 16; ks += KG) {")],
}
L1_MODES = ("full", "bf16", "empty")


def card_state():
    """The card's SM clock (MHz), power draw (W) and temperature (C) now,
    from nvidia-smi: a case timed at a lower clock than another ran
    throttled."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split(",")
    return [float(x) for x in out] if len(out) == 3 else None


def emit(**kw):
    line = json.dumps(kw)
    print(line, flush=True)
    for path in LOG:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as fh:
            fh.write(line + "\n")


def start_build(name, src_dir, stem, edits):
    """Copy ``stem``.cu from ``src_dir`` with ``edits`` into OUT/name and
    start nvcc on it; returns (process, library path)."""
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    text = (src_dir / f"{stem}.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{name}: edit target not found once: {old!r}")
        text = text.replace(old, new)
    (d / f"{stem}.cu").write_text(text)
    lib = d / "lib.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(SRC), "-o", str(lib),
           str(d / f"{stem}.cu")]
    with open(d / "build.log", "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, lib


class _ParentArgs(ctypes.Structure):
    # the parent's csrc/lab_fused.cu::LabFusedArgs (a stage_bf16 flag last)
    _fields_ = l1._LabFusedArgs._fields_ + [("stage_bf16", ctypes.c_int)]


def l1_launcher(L, parent, mode, wins, parts):
    """(launch function, outputs) of one L1 variant on unpacked inputs."""
    spec = l1.mode_spec(mode)
    nt, w, w2 = wins[0].shape
    p = parts[0].shape[-1]
    dev = wins[0].device
    pouts = [torch.empty((nt, 1, p), device=dev) for _ in range(6)]
    jws = [torch.empty((nt, w, w2), device=dev) for _ in range(3)]
    vals = [(ctypes.c_void_p * 6)(*[t.data_ptr() for t in wins]), w * w2,
            (ctypes.c_void_p * 7)(*[t.data_ptr() for t in parts]), p,
            (ctypes.c_void_p * 6)(*[t.data_ptr() for t in pouts]), p,
            (ctypes.c_void_p * 3)(*[t.data_ptr() for t in jws]), w * w2,
            nt, w, p, l1._KIND[spec["kind"]], int(spec["band"] == "linear"),
            l1._DOT[spec["gather"]], l1._DOT[spec["deposit"]]]
    args = (_ParentArgs(*vals, int(spec["stage_bf16"])) if parent
            else l1._LabFusedArgs(*vals))
    fn = L.lab_fused_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(ctypes.byref(args), stream)
        if err:
            raise RuntimeError(f"lab_fused launch error {err}")

    return launch, pouts + jws


def time_all(fns):
    """{name: (min, median, all)} ms of ten launches, three rounds in the
    order first..last, last..first."""
    times = {nm: [] for nm in fns}
    order = list(fns)
    for _ in range(3):
        for nm in order + order[::-1]:
            times[nm].append(cs.cuda_ms(fns[nm], 10))
    return {nm: {"ms_min": min(v), "ms_median": float(np.median(v)),
                 "ms_all": v} for nm, v in times.items()}


def worst_rel(got, ref):
    return max(cs.rel_err(x, y)[1] for x, y in zip(got, ref))


def run_l1(libs):
    for mode in L1_MODES:
        wins, parts, _ = l1.inputs(mode, l1.NT, l1.W, l1.P, device="cuda")
        fns, outs = {}, {}
        for nm, (L, parent) in libs.items():
            if mode != "full" and nm not in ("parent", "new", "c64", "w8"):
                continue
            fns[nm], outs[nm] = l1_launcher(L, parent, mode, wins, parts)
        results = {}
        for nm, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            res = {"timing_only": nm in TIMING_ONLY}
            if nm != "parent" and nm not in TIMING_ONLY:
                res["rel_err_vs_parent"] = worst_rel(outs[nm], outs["parent"])
                res["within_tol"] = (res["rel_err_vs_parent"]
                                     <= cs.TOL_LABS["L1"])
            results[nm] = res
        for nm, t in time_all(fns).items():
            results[nm].update(t)
            results[nm]["ns_per_slot"] = (t["ms_min"] * 1e6
                                          / (l1.NT * l1.P))
        emit(kind="ab", lab="L1", mode=mode, shape=[l1.NT, l1.W, l1.P],
             tol=cs.TOL_LABS["L1"], results=results)
        del wins, parts, outs
        torch.cuda.empty_cache()


def parent_warps(L, batch, m, n, k, mode):
    """The parent's bench_dot_shapes._warps (layout NN, the first design)."""
    for w in (4, 2, 1):
        blocks = batch * -(-m // 16) * -(-n // (8 * w))
        if (blocks >= 2 * dots.SMS or w == 1) and L.tile_dot_smem(
                k, dots.MODES[mode], w) <= dots.SMEM_MAX:
            return w
    raise ValueError("no parent plan")


_P, _I = ctypes.c_void_p, ctypes.c_int


def declare_tile_dot(L, parent):
    """Argument types of a tile_dot library (the parent's: layout NT's plan
    entry point and the first design's layout NN)."""
    if parent:
        L.tile_dot_nt_launch.argtypes = [_P] * 4 + [_I] * 14 + [_P]
        L.tile_dot_nt_launch.restype = _I
        L.tile_dot_launch.argtypes = [_P, _P, _P] + [_I] * 8 + [_P]
        L.tile_dot_smem.argtypes = [_I, _I, _I]
        L.tile_dot_smem.restype = ctypes.c_longlong
    else:
        L.tile_dot_launch.argtypes = [_I] + [_P] * 4 + [_I] * 14 + [_P]
        L.tile_dot_launch.restype = _I
        L.tile_dot_blocks_per_sm.argtypes = [_I] * 10


def plan_launch(L, layout, a, b, out, reps, mode, plan, parent=False):
    """A launch of csrc/tile_dot.cu's plan kernels at ``plan`` (in the
    parent's library: its layout NT)."""
    batch, m, k = a.shape
    n = b.shape[2] if layout == "nn" else b.shape[1]
    scratch = (torch.empty((plan["kb"], batch, m, n), device="cuda")
               if plan["kb"] > 1 else None)
    fn = (L.tile_dot_nt_launch if parent
          else functools.partial(L.tile_dot_launch, int(layout == "nn")))
    stream = torch.cuda.current_stream().cuda_stream
    in_bf16 = int(a.dtype == torch.bfloat16)

    def launch():
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), batch, m,
                 k, n, in_bf16, dots.MODES[mode], reps,
                 dots.NT_PATHS[plan["path"]], plan["tr"], plan["tc"],
                 plan["rm"], plan["kw"], plan["wb"], plan["kb"], stream)
        if err:
            raise RuntimeError(f"tile_dot {layout} error {err}: {plan}")
    return launch


def parent_nn_launch(L, a, b, out, reps, mode):
    """A launch of the parent's layout NN (the first design)."""
    batch, m, k = a.shape
    n = b.shape[2]
    w = parent_warps(L, batch, m, n, k, mode)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = L.tile_dot_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                batch, m, k, n,
                                int(a.dtype == torch.bfloat16),
                                dots.MODES[mode], reps, w, stream)
        if err:
            raise RuntimeError(f"parent tile_dot error {err}")
    return launch


def compare_and_time(fns, outs, ref_name, tol, timing_only=()):
    """Run each variant once, hold it against ``ref_name``'s outputs (a
    list of tensors each), then time them all."""
    results = {}
    for nm, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        results[nm] = {"timing_only": nm in timing_only}
        if nm != ref_name and nm not in timing_only:
            e = worst_rel(outs[nm], outs[ref_name])
            results[nm].update(rel_err_vs_parent=e, within_tol=e <= tol)
    for nm, t in time_all(fns).items():
        results[nm].update(t)
    results["card_after"] = card_state()
    return results


def run_l3(parent_lib, libs):
    """Every bench_deposit_prec case: the parent's layout NT against this
    one's, both at _plan_nt's plan, and on the wgmma path this one waiting
    for each rep's products (the parent's schedule)."""
    gen = torch.Generator().manual_seed(0)
    reps, k = 400, 1152
    for m, n, label in l3.CASES:
        for lbl, (mode, dtype) in l3.MODES.items():
            a, b = l3.make_case(m, n, k, l3.NT, dtype, "cuda", gen)
            plan = dots._plan_nt(l3.NT, m, n, k, mode, "nt")
            variants = {"parent": parent_lib, "new": libs["l4_new"]}
            if plan["path"] == "wgmma":
                variants["wait_per_rep"] = libs["l4_wait_per_rep"]
                variants["two_acc_n128"] = libs["l4_two_acc_n128"]
            outs = {nm: [torch.empty((l3.NT, m, n), device="cuda")]
                    for nm in variants}
            fns = {nm: plan_launch(lib, "nt", a, b, outs[nm][0], reps, mode,
                                   plan, parent=nm == "parent")
                   for nm, lib in variants.items()}
            results = compare_and_time(fns, outs, "parent", cs.TOL_LABS["L3"])
            useful, _ = dots.dot_flops(l3.NT, m, k, n, reps, mode, "nt")
            emit(kind="ab", lab="L3", case=f"{label} {lbl}",
                 shape=[l3.NT, m, n, k], reps=reps, plan={
                     key: plan[key] for key in ("path", "tr", "tc", "rm",
                                                "kw", "wb", "kb")},
                 flops_useful=useful, tol=cs.TOL_LABS["L3"],
                 results=results)
            del a, b, outs, fns
    torch.cuda.empty_cache()


def run_l4(parent_lib, libs):
    """Every bench_dot_shapes case in mode 'bf16': the parent's first
    design, this kernel and its ablations (edited sources and other
    plans)."""
    gen = torch.Generator().manual_seed(0)
    mode = "bf16"
    new_lib = libs["l4_new"]
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n in dots.CASES:
            batch = dots.NT
            reps = dots.BASE_MACS // (m * k * n * batch)
            a = (torch.rand((batch, m, k), generator=gen) - 0.5).to(
                "cuda", dtype)
            b = (torch.rand((batch, k, n), generator=gen) - 0.5).to(
                "cuda", dtype)
            plan = dots._plan_nt(batch, m, n, k, mode, "nn")
            plans = {"l4_new": plan,
                     # twice the blocks along K
                     "l4_split_more": dict(plan, kw=plan["kw"] // 2,
                                           kb=-(-k // (plan["kw"] // 2
                                                       * plan["wb"])))}
            if m >= 64:
                plans["l4_n64"] = dict(plan, tc=8, tn=64, ng=-(-n // 64))
                # out^T, N = m
                plans["l4_orient_T"] = dict(
                    plan, path="wgmma", tm=m, tn=64, mg=1, ng=-(-n // 64))
            outs, fns = {}, {}
            outs["parent"] = [torch.empty((batch, m, n), device="cuda")]
            fns["parent"] = parent_nn_launch(parent_lib, a, b,
                                             outs["parent"][0], reps, mode)
            for nm, p in plans.items():
                outs[nm] = [torch.empty((batch, m, n), device="cuda")]
                fns[nm] = plan_launch(new_lib, "nn", a, b, outs[nm][0], reps,
                                      mode, p)
            for nm in ("l4_wait_per_rep", "l4_two_acc_n128"):
                outs[nm] = [torch.empty((batch, m, n), device="cuda")]
                fns[nm] = plan_launch(libs[nm], "nn", a, b, outs[nm][0],
                                      reps, mode, plan)
            slices = plan["kb"] * plan["wb"]
            if slices > 1:  # the parent over the plan's K slices
                ks = k // slices
                a_s = a.reshape(batch, m, slices, ks).permute(0, 2, 1, 3) \
                    .reshape(batch * slices, m, ks).contiguous()
                b_s = b.reshape(batch, slices, ks, n) \
                    .reshape(batch * slices, ks, n).contiguous()
                part = torch.empty((batch * slices, m, n), device="cuda")
                inner = parent_nn_launch(parent_lib, a_s, b_s, part, reps,
                                         mode)
                outs["parent_splitk"] = [torch.empty((batch, m, n),
                                                     device="cuda")]

                def splitk(inner=inner, part=part,
                           dst=outs["parent_splitk"][0]):
                    inner()
                    torch.sum(part.view(batch, slices, m, n), dim=1, out=dst)
                fns["parent_splitk"] = splitk
            if dtype == torch.float32:  # the plan sweep
                for kw, wb in L4_PLANS:
                    nm = f"plan_kw{kw}_wb{wb}"
                    p = dict(plan, kw=kw, wb=wb, kb=-(-k // (kw * wb)))
                    if (p["kb"] - 1) * kw * wb + (wb - 1) * kw >= k:
                        continue  # a warpgroup would see no k
                    plans[nm] = p
                    outs[nm] = [torch.empty((batch, m, n), device="cuda")]
                    fns[nm] = plan_launch(new_lib, "nn", a, b, outs[nm][0],
                                          reps, mode, p)
            results = compare_and_time(fns, outs, "parent",
                                       cs.TOL_LABS["L4"])
            for nm, p in plans.items():
                results[nm]["plan"] = {key: p[key] for key in (
                    "path", "tm", "tn", "kw", "wb", "kb")}
                results[nm]["blocks"] = batch * p["mg"] * p["ng"] * p["kb"]
                results[nm]["blocks_per_sm"] = \
                    new_lib.tile_dot_blocks_per_sm(
                        m, n, int(dtype == torch.bfloat16), dots.MODES[mode],
                        dots.NT_PATHS[p["path"]], p["tr"], p["tc"], p["rm"],
                        p["kw"], p["wb"])
            emit(kind="ab", lab="L4", case=f"M{m} K{k} N{n}",
                 operands=str(dtype).replace("torch.", ""),
                 shape=[batch, m, n, k], reps=reps,
                 flops_useful=2 * dots.BASE_MACS, tol=cs.TOL_LABS["L4"],
                 results=results)
            del a, b, outs, fns
            torch.cuda.empty_cache()


class _WidelaneArgs(ctypes.Structure):
    _fields_ = l2._LabWidelaneArgs._fields_


def run_l2(parent_lib, libs):
    """The lab's four cases: the parent, this kernel and its ablations."""
    for mode in ("batched", "wide"):
        for dep in ("bf16", "f32"):
            _, args = l2.make(mode, dep, "cuda")
            nt, rows, w2 = args[0].shape
            w, p = rows // 2, args[1].numel() // (rows // 2)
            stream = torch.cuda.current_stream().cuda_stream
            fns, outs = {}, {}
            for nm, L in [("parent", parent_lib)] + list(libs.items()):
                out = torch.empty((nt, p), device="cuda")
                jw = torch.empty((nt, w, w2), device="cuda")
                st = _WidelaneArgs(*[t.data_ptr() for t in args],
                                   out.data_ptr(), jw.data_ptr(), nt, w, p,
                                   int(mode == "batched"), int(dep == "f32"))
                fn = L.lab_widelane_launch
                fn.argtypes, fn.restype = [_P, _P], _I

                def launch(fn=fn, st=st):
                    err = fn(ctypes.byref(st), stream)
                    if err:
                        raise RuntimeError(f"lab_widelane error {err}")
                fns[nm], outs[nm] = launch, [out, jw]
            results = compare_and_time(fns, outs, "parent",
                                       cs.TOL_LABS["L2"], TIMING_ONLY)
            flops = l2.lab_flops(nt, w, p, dep)
            emit(kind="ab", lab="L2", case=f"{mode} {dep}",
                 shape=[nt, w, p], flops=flops,
                 bound_ms=cs_bound_l2(args, nt, p, w, flops),
                 tol=cs.TOL_LABS["L2"], results=results)
            del args, fns, outs
            torch.cuda.empty_cache()


def cs_bound_l2(args, nt, p, w, flops):
    from warpx_tpu_torch.tools import _timing
    n_bytes = _timing.nbytes(*args) + nt * p * 4 + nt * w * w * w * 4
    return _timing.bound_ms(n_bytes, flops)[0]


# run in a tree's root: its chip_smoke's lab phases under a timer
PHASES_PY = """
import json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from warpx_tpu_torch import build
t = [time.perf_counter()]
build.build_all(["tile_dot", "lab_widelane", "lab_fused", "slot_copy"])
t.append(time.perf_counter())
cs.phase_lab_parity(torch.device("cuda"))
t.append(time.perf_counter())
cs.phase_labs(torch.device("cuda"))
t.append(time.perf_counter())
print("PHASES " + json.dumps(dict(zip(
    ("build_labs_s", "lab_parity_s", "labs_s"),
    [b - a for a, b in zip(t, t[1:])]))))
"""


def run_phases():
    """chip_smoke.py's lab phases, parent tree and this one in turns."""
    for name, tree in (("parent", ROOT / "_ab" / "parent_tree"),
                       ("this", ROOT), ("this", ROOT),
                       ("parent", ROOT / "_ab" / "parent_tree")):
        out = subprocess.run([sys.executable, "-c", PHASES_PY], cwd=tree,
                             capture_output=True, text=True)
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("PHASES ")]
        if out.returncode or not line:
            raise SystemExit(f"labs_ab: the {name} tree's lab phases "
                             f"failed:\n{out.stdout[-3000:]}"
                             f"{out.stderr[-3000:]}")
        emit(kind="phases", tree=name, **json.loads(line[0][7:]))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("labs_ab: no CUDA device")
    args = sys.argv[1:]
    if "--log" in args:
        i = args.index("--log")
        LOG.append(pathlib.Path(args[i + 1]))
        del args[i:i + 2]
    want = set(args) or {"l2", "l3", "l4", "rates"}
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(kind="device", name=torch.cuda.get_device_name(0),
         nvidia_smi=cs.nvidia_smi_line(), labs=sorted(want))
    t0 = time.perf_counter()
    procs = {}
    if "l1" in want:
        procs.update({nm: start_build(nm, PARENT, "lab_fused", e)
                      for nm, e in L1_PARENTS.items()})
        procs.update({nm: start_build(nm, SRC, "lab_fused", e)
                      for nm, e in L1_VARIANTS.items()})
    if want & {"l3", "l4"}:
        procs["td_parent"] = start_build("td_parent", PARENT, "tile_dot", [])
        procs.update({nm: start_build(nm, SRC, "tile_dot", e)
                      for nm, e in L4_VARIANTS.items()})
    if "l2" in want:
        procs["l2_parent"] = start_build("l2_parent", PARENT,
                                         "lab_widelane", [])
        procs.update({nm: start_build(nm, SRC, "lab_widelane", e)
                      for nm, e in L2_VARIANTS.items()})
    rates_proc = None
    if "rates" in want:
        rates = OUT / "mma_rates"
        rates.mkdir(parents=True, exist_ok=True)
        (rates / "mma_rates.cu").write_text(MMA_RATES_CU)
        rates_proc = subprocess.Popen(
            [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
             "-std=c++17", "-I", str(SRC), "-o", str(rates / "mma_rates"),
             str(rates / "mma_rates.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for nm, (proc, _) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"labs_ab: the build of {nm} failed:\n"
                             + (OUT / nm / "build.log").read_text())
    reports = {nm: cs.ptxas_report((OUT / nm / "build.log").read_text())
               for nm in procs}
    serialized = {nm: (OUT / nm / "build.log").read_text().count("C7520")
                  for nm in procs}
    emit(kind="build", seconds=time.perf_counter() - t0,
         registers={nm: dict(sorted(r.items()))
                    for nm, (r, _) in reports.items()},
         spill_bytes={nm: sum(sp.values())
                      for nm, (_, sp) in reports.items()},
         wgmma_serialized=serialized)
    if rates_proc is not None:
        if rates_proc.wait() != 0:
            raise SystemExit("labs_ab: the rates' build failed:\n"
                             + rates_proc.stdout.read())
        text = subprocess.run([str(OUT / "mma_rates" / "mma_rates")],
                              capture_output=True, text=True,
                              check=True).stdout
        for ln in text.splitlines():
            emit(**json.loads(ln))
    lib = {nm: ctypes.CDLL(str(path)) for nm, (_, path) in procs.items()}
    if "l2" in want:
        run_l2(lib["l2_parent"], {nm: lib[nm] for nm in L2_VARIANTS})
    if want & {"l3", "l4"}:
        declare_tile_dot(lib["td_parent"], True)
        for nm in L4_VARIANTS:
            declare_tile_dot(lib[nm], False)
    if "l3" in want:
        run_l3(lib["td_parent"], {nm: lib[nm] for nm in L4_VARIANTS})
    if "l4" in want:
        run_l4(lib["td_parent"], {nm: lib[nm] for nm in L4_VARIANTS})
    if "l1" in want:
        run_l1({nm: (lib[nm], nm in L1_PARENTS)
                for nm in list(L1_PARENTS) + list(L1_VARIANTS)})
    if "phases" in want:
        run_phases()
    emit(kind="done", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
