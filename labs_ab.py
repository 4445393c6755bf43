"""The Hopper labs L1 (``warpx_tpu_torch/csrc/lab_fused.cu``) and L3
(``csrc/tile_dot.cu`` in layout NT) against a parent source and against
ablations, at the labs' shapes, on one card.

    python3 labs_ab.py

Run from the repository's root, beside ``chip_smoke.py`` and ``k2_ab.py``,
whose helpers it uses.  ``_ab/parent/`` (git-ignored) holds the parent
commit's ``lab_fused.cu`` and ``tile_dot.cu``:

    mkdir -p _ab/parent && for f in lab_fused.cu tile_dot.cu; do
      git show <rev>:warpx_tpu_torch/csrc/$f > _ab/parent/$f; done

Each variant is a copy of a source with the named edits (L1_PARENTS of the
parent's lab_fused.cu, L1_VARIANTS of this one's), built by ``nvcc`` into
``warpx_tpu_torch/_build/labs_ab/`` (git-ignored); an ablation marked
``timing_only`` computes wrong outputs and exists for its time.  L1 runs
the lab's inputs (W = 16, P = 2048, NT = 512, ``kernel_lab.inputs``) in
the modes 'full', 'bf16' (the parent stages its windows as bfloat16 there:
the "windows pre-split" ablation of the parent) and 'empty'.  L3 runs
``bench_deposit_prec``'s principal case, 8 entries of (16 x 1152) .
(256 x 1152)^T, 400 reps, 'f32', and two other cases: the parent; the
parent on the same operands cut along K into the new plan's slices as
batch entries, their sums added after (split K only); this kernel at its
plan; this kernel at a plan of 128-deep slices, ~the parent's warp count
(micro-tiles only).  Every variant that is not timing-only is held against
the parent's outputs at the lab tolerance (chip_smoke.TOL_LABS); then ten
launches timed with CUDA events, three rounds in the order first..last,
last..first.  Prints one JSON line per result, as ``k2_ab.py`` does.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import time

import numpy as np
import torch

import chip_smoke as cs

from warpx_tpu_torch import build
from warpx_tpu_torch.tools import bench_deposit_prec as l3
from warpx_tpu_torch.tools import bench_dot_shapes as dots
from warpx_tpu_torch.tools import kernel_lab as l1

ROOT = pathlib.Path(__file__).resolve().parent
PARENT = ROOT / "_ab" / "parent"
SRC = ROOT / "warpx_tpu_torch" / "csrc"
OUT = ROOT / "warpx_tpu_torch" / "_build" / "labs_ab"

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
               "nodep", "nomma", "nogather", "nobands"}
# layout NT plans (tr, tc, rm, kw, wb) of the principal case timed beside
# _plan_nt's: slices and blocks at 4 x 8 lane tiles, then 8 x 8
L3_PLANS = ((4, 8, 4, 12, 1), (4, 8, 4, 16, 4), (4, 8, 4, 24, 4),
            (4, 8, 4, 32, 1), (4, 8, 4, 72, 4), (4, 8, 4, 144, 1),
            (2, 16, 8, 12, 8), (2, 16, 8, 24, 8))

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


def emit(**kw):
    print(json.dumps(kw), flush=True)


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
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
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
    """The parent's bench_dot_shapes._warps."""
    for w in (4, 2, 1):
        blocks = batch * -(-m // 16) * -(-n // (8 * w))
        if (blocks >= 2 * dots.SMS or w == 1) and L.tile_dot_smem(
                k, dots.MODES[mode], w) <= dots.SMEM_MAX:
            return w
    raise ValueError("no parent plan")


def run_l3(parent_lib, new_lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    parent_lib.tile_dot_launch.argtypes = [P, P, P] + [I] * 9 + [P]
    parent_lib.tile_dot_smem.argtypes = [I, I, I]
    parent_lib.tile_dot_smem.restype = ctypes.c_longlong
    new_lib.tile_dot_nt_launch.argtypes = [P] * 4 + [I] * 14 + [P]
    new_lib.tile_dot_nt_blocks_per_sm.argtypes = [I] * 10
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(0)
    reps = 400
    cases = [("deposit3d f32/HIGHEST", 16, 256, "f32", torch.float32),
             ("deposit3d bf16-cast", 16, 256, "bf16", torch.bfloat16),
             ("deposit3d-M128 f32/HIGHEST", 128, 256, "f32", torch.float32)]
    for label, m, n, mode, dtype in cases:
        a, b = l3.make_case(m, n, 1152, l3.NT, dtype, "cuda", gen)
        batch, k = l3.NT, 1152
        in_bf16 = int(dtype == torch.bfloat16)

        def parent_fn(a_, b_, out_):
            bt, mm, kk = a_.shape
            nn = b_.shape[1]
            w = parent_warps(parent_lib, bt, mm, nn, kk, mode)

            def launch():
                err = parent_lib.tile_dot_launch(
                    a_.data_ptr(), b_.data_ptr(), out_.data_ptr(), bt, mm, kk,
                    nn, 1, in_bf16, dots.MODES[mode], reps, w, stream)
                if err:
                    raise RuntimeError(f"parent tile_dot error {err}")
            return launch

        def new_fn(plan, out_):
            scratch = (torch.empty((plan["kb"], batch, m, n), device="cuda")
                       if plan["kb"] > 1 else None)

            def launch():
                err = new_lib.tile_dot_nt_launch(
                    a.data_ptr(), b.data_ptr(), out_.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), batch, m,
                    k, n, in_bf16, dots.MODES[mode], reps,
                    dots.NT_PATHS[plan["path"]], plan["tr"], plan["tc"],
                    plan["rm"], plan["kw"], plan["wb"], plan["kb"], stream)
                if err:
                    raise RuntimeError(f"tile_dot_nt error {err}")
            return launch

        plan = dots._plan_nt(batch, m, n, k, mode)
        few = dict(plan, kw=128, wb=1, kb=-(-k // 128))
        outs = {nm: torch.empty((batch, m, n), device="cuda")
                for nm in ("parent", "parent_splitk", "new", "new_microtile")}
        fns = {"parent": parent_fn(a, b, outs["parent"]),
               "new": new_fn(plan, outs["new"]),
               "new_microtile": new_fn(few, outs["new_microtile"])}
        slices = plan["kb"] * plan["wb"]
        if k % slices == 0 and (k // slices) % (4 if mode == "f32" else 16) \
                == 0:
            ks = k // slices
            a_s = a.reshape(batch, m, slices, ks).permute(0, 2, 1, 3) \
                .reshape(batch * slices, m, ks).contiguous()
            b_s = b.reshape(batch, n, slices, ks).permute(0, 2, 1, 3) \
                .reshape(batch * slices, n, ks).contiguous()
            part = torch.empty((batch * slices, m, n), device="cuda")
            inner = parent_fn(a_s, b_s, part)

            def splitk():
                inner()
                torch.sum(part.view(batch, slices, m, n), dim=1,
                          out=outs["parent_splitk"])
            fns["parent_splitk"] = splitk
        results = {}
        for nm, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            results[nm] = {}
            if nm != "parent":
                e = cs.rel_err(outs[nm], outs["parent"])[1]
                results[nm].update(rel_err_vs_parent=e,
                                   within_tol=e <= cs.TOL_LABS["L3"])
        for nm, t in time_all(fns).items():
            results[nm].update(t)
        plans = {"new": plan, "new_microtile": few}
        for nm, p in plans.items():
            results[nm]["plan"] = {key: p[key] for key in (
                "path", "tr", "tc", "rm", "kw", "wb", "kb", "warps")}
            results[nm]["plan"]["warps"] = (
                batch * -(-m // p["tm"]) * -(-n // p["tn"]) * p["kb"]
                * p["wb"] * (4 if p["path"] == "wgmma" else 1))
            results[nm]["blocks_per_sm"] = new_lib.tile_dot_nt_blocks_per_sm(
                m, n, in_bf16, dots.MODES[mode], dots.NT_PATHS[p["path"]],
                p["tr"], p["tc"], p["rm"], p["kw"], p["wb"])
        if "parent_splitk" in fns:
            results["parent_splitk"]["slices"] = slices
        if label == cases[0][0]:  # the principal case: other plans
            for tr, tc, rm, kw, wb in L3_PLANS:
                tm, tn = dots._nt_tile("fma", m, tr, tc, rm)
                alt = dict(plan, tr=tr, tc=tc, rm=rm, kw=kw, wb=wb,
                           kb=-(-k // (kw * wb)), mg=-(-m // tm),
                           ng=-(-n // tn))
                o = torch.empty((batch, m, n), device="cuda")
                fn = new_fn(alt, o)
                fn()
                torch.cuda.synchronize()
                t = time_all({"x": fn})["x"]
                results[f"plan_{rm}x8_kw{kw}_wb{wb}"] = dict(
                    t, rel_err_vs_parent=cs.rel_err(o, outs["parent"])[1],
                    blocks=batch * alt["mg"] * alt["ng"] * alt["kb"])
        useful, _ = dots.dot_flops(batch, m, k, n, reps, mode, "nt")
        emit(kind="ab", lab="L3", case=label, shape=[batch, m, n, k],
             reps=reps, tol=cs.TOL_LABS["L3"], flops_useful=useful,
             results=results)
        del a, b, outs, fns
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("labs_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(kind="device", name=torch.cuda.get_device_name(0),
         nvidia_smi=cs.nvidia_smi_line())
    t0 = time.perf_counter()
    procs = {nm: start_build(nm, PARENT, "lab_fused", e)
             for nm, e in L1_PARENTS.items()}
    procs.update({nm: start_build(nm, SRC, "lab_fused", e)
                  for nm, e in L1_VARIANTS.items()})
    procs["l3_parent"] = start_build("l3_parent", PARENT, "tile_dot", [])
    procs["l3_new"] = start_build("l3_new", SRC, "tile_dot", [])
    rates = OUT / "mma_rates"
    rates.mkdir(parents=True, exist_ok=True)
    (rates / "mma_rates.cu").write_text(MMA_RATES_CU)
    rates_proc = subprocess.Popen(
        [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-o", str(rates / "mma_rates"), str(rates / "mma_rates.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for nm, (proc, _) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"labs_ab: the build of {nm} failed:\n"
                             + (OUT / nm / "build.log").read_text())
    reports = {nm: cs.ptxas_report((OUT / nm / "build.log").read_text())
               for nm in procs}
    emit(kind="build", seconds=time.perf_counter() - t0,
         registers={nm: dict(sorted(r.items()))
                    for nm, (r, _) in reports.items()},
         spill_bytes={nm: sum(sp.values())
                      for nm, (_, sp) in reports.items()})
    if rates_proc.wait() != 0:
        raise SystemExit("labs_ab: the rates' build failed:\n"
                         + rates_proc.stdout.read())
    print(subprocess.run([str(rates / "mma_rates")], capture_output=True,
                         text=True, check=True).stdout, end="", flush=True)
    libs = {nm: (ctypes.CDLL(str(lib)), nm in L1_PARENTS)
            for nm, (_, lib) in procs.items() if not nm.startswith("l3_")}
    run_l1(libs)
    run_l3(ctypes.CDLL(str(procs["l3_parent"][1])),
           ctypes.CDLL(str(procs["l3_new"][1])))
    emit(kind="done", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
