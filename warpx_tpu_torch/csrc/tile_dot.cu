// Labs L3 and L4: accumulated tile products, reps times, at a chosen
// operand precision.
//
// Replaces the Pallas kernels of tools/bench_dot_shapes.py::make (:26, call
// :40; layout NN, a (m, k) . b (k, n)) and tools/bench_deposit_prec.py::make
// (:34, call :69) with main's kb (:138, call :152) and ks (:169, call :182)
// (layout NT, a (m, k) . b (n, k)^T): for every batch entry
//
//   out = sum over reps of a . b   (float32 accumulator)
//
// Modes (the TPU's precisions, not interpret mode's): 0 'f32' (HIGHEST:
// float32 products by FP32 FMA), 1 'bf16' (DEFAULT, or bfloat16 operands:
// both operands rounded to bfloat16, tensor-core products with a float32
// accumulator), 2 '3pass' (HIGH: hi = bf16(x), lo = bf16(x - hi), three
// tensor-core products a term: hi.hi + hi.lo + lo.hi).
//
// Bound on the card: operations (the operands are read once, and each rep
// redoes the product), at 989 TFLOP/s for the bfloat16 tensor cores (three
// products a term in '3pass') and 67 TFLOP/s for FP32.  In both layouts
// each rep's product goes into a fresh accumulator that is then added to
// the sum, as the TPU labs add `acc + dot` (one accumulator over all reps
// drifts, since the tensor cores' float32 accumulation truncates, by up to
// 3e-2 of the sum over 16384 reps), and each rep reloads its operands from
// shared memory after a compiler barrier, so nothing is hoisted out of the
// reps loop: the labs measure a deposit whose operands stream.
//
// Both layouts run on one plan (tools/bench_dot_shapes.py::_plan_nt, with
// a layout) and one set of kernels: the host cuts every batch entry's
// output into units and K into slices of `kw`; a block of `wb` warps
// (warpgroups on the wgmma paths) takes one unit and `wb` consecutive
// slices, staged once in shared memory; `kb` blocks cover a unit's K.  Each
// warp runs the reps over its own slice.  The layout only changes how b is
// read as it is staged.  Paths:
//   fma      'f32': FP32 FMA on register micro-tiles of RM rows x 8 columns
//            a lane; the operands are staged k-major (a_s[k][row],
//            b_s[k][col]) so that one LDS.128 feeds 16 or 32 FMA and a
//            warp's loads of `a` are broadcasts (TR x TC lanes tile the
//            unit, TK = 32 / (TR TC) lanes interleave the slice's k);
//   wgmma    'bf16'/'3pass' (the plan's choice in layout NT where n >= 64,
//            in NN where m < 64): out^T = b^T . a^T, the unit's 64 columns
//            of b as wgmma's M and m (rounded up to 8, 16, 32, 64 or 128)
//            as its N;
//   wgmma_n  'bf16'/'3pass' (the plan's choice in NN where m >= 64): out =
//            a . b, 64 rows of a as M and 64 or 128 columns of b as N;
//   mma      'bf16'/'3pass', layout NT only (the plan's choice where n <
//            64, the 2D deposit's 16 x 16): mma.sync m16n8k16 on a 16 x 16
//            warp tile, operands staged once.
// On the wgmma paths both operands are staged once as bfloat16 hi (and lo)
// in the no-swizzle K-major core-matrix layout (csrc/wgmma.cuh) and read by
// descriptor; b stored (k, n) (layout NN) is transposed as it is staged.
// Two accumulators alternate over the reps where wgmma's N is below 128
// (kTwoAcc): each rep's products are issued before the wait for the
// previous rep's, whose sum is added meanwhile.
//
// Layout NT (L3) was redesigned for the H100 first (the plan, split K, the
// fma and wgmma paths).
//
// Layout NN (L4), redesigned after it.  The first design gave each warp one
// 16 x 8 mma.sync tile over the whole K and reloaded its fragments lane by
// lane every rep: 768 bytes of shared memory a warp for 2048 multiply-adds,
// six clocks of the SM's 128-byte port for one of the tensor cores, so it
// ran at 14 % of its bound (at M = 8 half of each m16 tile was padding, at
// K = 2048 one 197 KB block an SM).  What bounds it now: at m >= 64 the
// tensor cores (m64n128k16 reads 6 KB of shared memory for 64 clocks of
// them); at m = 16 and 8 shared memory, since wgmma's M is 64 and a k16
// step of m64n16k16 (m64n8k16) reads 2.5 KB (2.25 KB) for 8 (4) clocks of
// tensor cores, 20 (18) of the port: about 40 % (22 %) of the bound.  What
// the design does about it: the orientation puts M on the wide side (no
// padded rows at M = 8), descriptors replace lane-by-lane fragments, split
// K keeps two or more warpgroups an SM at K = 2048, and below N = 128 two
// accumulators alternate over the reps (kTwoAcc).
//
// The warps' partial sums meet once, after the last rep: in shared memory
// in warp order, then, where kb > 1, through a scratch buffer that a second
// kernel adds in block order.  No float atomics: the result is the same
// from launch to launch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

constexpr int kModeF32 = 0, kMode3Pass = 2;  // and 1, 'bf16'
constexpr int kPathFma = 0, kPathWgmma = 1, kPathMma = 2, kPathWgmmaN = 3;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename In>
__device__ __forceinline__ float to_f(In x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One operand value staged into shared memory in the mode's format.
__device__ __forceinline__ void stage(float x, int mode, int idx, float* f32,
                                      __nv_bfloat16* hi, __nv_bfloat16* lo) {
  if (mode == kModeF32) {
    f32[idx] = x;
  } else {
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    hi[idx] = h;
    if (mode == kMode3Pass) {
      lo[idx] = __float2bfloat16_rn(x - __bfloat162float(h));
    }
  }
}

// ---- the plan: split K, one deterministic reduction ----------------------

// Must match tools/bench_dot_shapes.py::_plan_nt.
struct NtPlan {
  int path, tr, tc, rm, kw, wb, kb;
  int tm, tn;    // the unit's rows (of out) and columns
  int threads;   // a block's
  int kblk;      // the K a block stages: wb * kw
  int mg, ng;    // units along m and n per batch entry
  int kn;        // b is stored (k, n) (layout NN), else (n, k)
};

__host__ __device__ inline int wgmma_n(int m) {
  return m <= 8 ? 8 : m <= 16 ? 16 : m <= 32 ? 32 : m <= 64 ? 64 : 128;
}

__host__ __device__ inline NtPlan make_plan(int nn, int m, int n, int path,
                                            int tr, int tc, int rm, int kw,
                                            int wb, int kb) {
  NtPlan p{path, tr, tc, rm, kw, wb, kb, 0, 0, 0, wb * kw, 0, 0, nn};
  if (path == kPathFma) {
    p.tm = rm * tr;
    p.tn = 8 * tc;
    p.threads = 32 * wb;
  } else if (path == kPathWgmma) {
    p.tm = wgmma_n(m);
    p.tn = 64;
    p.threads = 128 * wb;
  } else if (path == kPathWgmmaN) {
    p.tm = 64;
    p.tn = 8 * tc;
    p.threads = 128 * wb;
  } else {
    p.tm = 16;
    p.tn = 16;
    p.threads = 32 * wb;
  }
  p.mg = (m + p.tm - 1) / p.tm;
  p.ng = (n + p.tn - 1) / p.tn;
  return p;
}

// Shared memory of a block: the staged slices, reused for the warps'
// partial sums.
__host__ __device__ inline long long plan_smem(const NtPlan& p, int mode) {
  const long long parts = 2 - (mode != kMode3Pass);
  long long stage;
  if (p.path == kPathFma) {
    stage = static_cast<long long>(p.tm + p.tn) * p.kblk * 4;
  } else if (p.path == kPathWgmma || p.path == kPathWgmmaN) {
    stage = static_cast<long long>(p.tm + p.tn) * p.kblk * 2 * parts;
  } else {
    stage = 2LL * 16 * (p.kblk + 8) * 2 * parts;
  }
  const long long red = static_cast<long long>(p.wb) * p.tm * p.tn * 4;
  return stage > red ? stage : red;
}

// Where a block's partial sums go: out where one block covers K, else its
// own plane of the scratch buffer.
__device__ __forceinline__ float* nt_dest(float* out, float* scratch,
                                          const NtPlan& P, int batch, int m,
                                          int n, int kbi) {
  return P.kb == 1 ? out
                   : scratch + static_cast<long long>(kbi) * batch * m * n;
}

// Sum the warps' (or warpgroups') tm x tn partials red[w][r][c] in warp
// order and store the unit's result.
__device__ __forceinline__ void nt_store(const float* red, const NtPlan& P,
                                         float* dst, int e, int row0, int col0,
                                         int m, int n) {
  const int tile = P.tm * P.tn;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int r = i / P.tn, c = i % P.tn;
    float s = red[i];
    for (int w = 1; w < P.wb; ++w) s = __fadd_rn(s, red[w * tile + i]);
    if (row0 + r < m && col0 + c < n) {
      dst[(static_cast<long long>(e) * m + row0 + r) * n + col0 + c] = s;
    }
  }
}

// The block's unit and K range from blockIdx.x = ((e * mg + mb) * ng + nb)
// * kb + kbi.
struct NtBlock {
  int e, row0, col0, kbi, k0;
};
__device__ __forceinline__ NtBlock nt_block(const NtPlan& P) {
  int bid = blockIdx.x;
  NtBlock B;
  B.kbi = bid % P.kb;
  bid /= P.kb;
  const int nb = bid % P.ng;
  bid /= P.ng;
  const int mb = bid % P.mg;
  B.e = bid / P.mg;
  B.row0 = mb * P.tm;
  B.col0 = nb * P.tn;
  B.k0 = B.kbi * P.kblk;
  return B;
}

// 'f32': FP32 FMA on RM x 8 register micro-tiles.  Lane (tk, ty, tx) owns
// rows RM ty .. RM ty + RM - 1 and columns 4 tx .. 4 tx + 3, 4 TC + 4 tx ..
// + 3 of the unit, and the k of its warp's slice with k = tk (mod TK).
// (`mode` is 'f32': the kernels share one signature.)
template <typename In, int TR, int TC, int RM>
__global__ void __launch_bounds__(256) tile_dot_fma(
    const In* __restrict__ a, const In* __restrict__ b,
    float* __restrict__ out, float* __restrict__ scratch, int batch, int m,
    int k, int n, int mode, int reps, NtPlan P) {
  constexpr int TK = 32 / (TR * TC), TM = RM * TR, TN = 8 * TC;
  extern __shared__ __align__(16) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);  // [kblk][TM]
  float* bs = as + P.kblk * TM;                // [kblk][TN]
  const NtBlock B = nt_block(P);
  const In* ae = a + static_cast<long long>(B.e) * m * k;
  const In* be = b + static_cast<long long>(B.e) * n * k;
  // k fastest in global memory; zeros past m, n and K
  for (int i = threadIdx.x; i < TM * P.kblk; i += blockDim.x) {
    const int r = i / P.kblk, kk = i % P.kblk, kg = B.k0 + kk;
    as[kk * TM + r] = (B.row0 + r < m && kg < k)
                          ? to_f(ae[static_cast<long long>(B.row0 + r) * k + kg])
                          : 0.f;
  }
  for (int i = threadIdx.x; i < TN * P.kblk; i += blockDim.x) {
    if (P.kn) {  // n fastest in global memory
      const int c = i % TN, kk = i / TN, kg = B.k0 + kk;
      bs[kk * TN + c] = (B.col0 + c < n && kg < k)
                            ? to_f(be[static_cast<long long>(kg) * n + B.col0 + c])
                            : 0.f;
    } else {
      const int c = i / P.kblk, kk = i % P.kblk, kg = B.k0 + kk;
      bs[kk * TN + c] = (B.col0 + c < n && kg < k)
                            ? to_f(be[static_cast<long long>(B.col0 + c) * k + kg])
                            : 0.f;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tk = lane / (TR * TC), ty = (lane / TC) % TR, tx = lane % TC;
  const int kbeg = warp * P.kw;
  int kend = kbeg + P.kw;
  if (kend > k - B.k0) kend = k - B.k0;
  const float* ap = as + RM * ty;
  const float* bp0 = bs + 4 * tx;
  const float* bp1 = bs + 4 * TC + 4 * tx;
  float c[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
  for (int rep = 0; rep < reps; ++rep) {
    asm volatile("" ::: "memory");
    float p[RM][8];
    // the first k multiplies (an FMA into zero rounds the same); a lane
    // whose k lies past the block's K reads the zeros staged there
    int kk = kbeg + tk;
    {
      float xv[RM], yv[8];
#pragma unroll
      for (int i = 0; i < RM; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(ap + kk * TM + i);
        xv[i] = x.x; xv[i + 1] = x.y; xv[i + 2] = x.z; xv[i + 3] = x.w;
      }
      const float4 y0 = *reinterpret_cast<const float4*>(bp0 + kk * TN);
      const float4 y1 = *reinterpret_cast<const float4*>(bp1 + kk * TN);
      yv[0] = y0.x; yv[1] = y0.y; yv[2] = y0.z; yv[3] = y0.w;
      yv[4] = y1.x; yv[5] = y1.y; yv[6] = y1.z; yv[7] = y1.w;
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) p[i][j] = __fmul_rn(xv[i], yv[j]);
    }
#pragma unroll 2
    for (kk += TK; kk < kend; kk += TK) {
      float xv[RM], yv[8];
#pragma unroll
      for (int i = 0; i < RM; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(ap + kk * TM + i);
        xv[i] = x.x; xv[i + 1] = x.y; xv[i + 2] = x.z; xv[i + 3] = x.w;
      }
      const float4 y0 = *reinterpret_cast<const float4*>(bp0 + kk * TN);
      const float4 y1 = *reinterpret_cast<const float4*>(bp1 + kk * TN);
      yv[0] = y0.x; yv[1] = y0.y; yv[2] = y0.z; yv[3] = y0.w;
      yv[4] = y1.x; yv[5] = y1.y; yv[6] = y1.z; yv[7] = y1.w;
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) p[i][j] = fmaf(xv[i], yv[j], p[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = __fadd_rn(c[i][j], p[i][j]);
  }
  // the TK lane groups' sums (xor partners add the same two values)
#pragma unroll
  for (int s = TR * TC; s < 32; s *= 2)
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        c[i][j] = __fadd_rn(c[i][j], __shfl_xor_sync(0xffffffffu, c[i][j], s));
  __syncthreads();  // the operands are dead: the partials reuse them
  float* red = reinterpret_cast<float*>(smem) + warp * TM * TN;
  if (tk == 0) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j < 4 ? 4 * tx + j : 4 * TC + 4 * tx + j - 4;
        red[(RM * ty + i) * TN + col] = c[i][j];
      }
  }
  __syncthreads();
  nt_store(reinterpret_cast<float*>(smem), P,
           nt_dest(out, scratch, P, batch, m, n, B.kbi), B.e, B.row0, B.col0,
           m, n);
}

// Stage rows [row0, row0 + rows) of an operand of `count` rows over the
// block's K as bfloat16 hi (and lo) in the core-matrix layout of `rows`
// rows.  kmaj: x is (count, k), k fastest; else (k, count) (layout NN's b,
// whose rows are its columns), read along its rows and transposed here.
template <typename In>
__device__ __forceinline__ void stage_core(const In* x, bool kmaj, int count,
                                           int k, int row0, int rows, int k0,
                                           int kblk, int mode,
                                           __nv_bfloat16* hi,
                                           __nv_bfloat16* lo) {
  for (int i = threadIdx.x; i < rows * kblk; i += blockDim.x) {
    const int r = kmaj ? i / kblk : i % rows;
    const int kk = kmaj ? i % kblk : i / rows, kg = k0 + kk;
    float v = 0.f;
    if (row0 + r < count && kg < k) {
      v = to_f(kmaj ? x[static_cast<long long>(row0 + r) * k + kg]
                    : x[static_cast<long long>(kg) * count + row0 + r]);
    }
    stage(v, mode, wgmma::core_off(r, kk, rows), nullptr, hi, lo);
  }
}

template <int N>
__device__ __forceinline__ void add_rep(float (&c)[N / 2], float (&p)[N / 2]) {
  wgmma::fence_regs(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) c[i] = __fadd_rn(c[i], p[i]);
}

// One rep's products into p, a fresh sum (scale-d 0 at the first step),
// committed as one group; THREE: '3pass'.
template <int N, bool THREE>
__device__ __forceinline__ void issue_rep(float (&p)[N / 2], uint64_t dxh,
                                          uint64_t dyh, uint64_t dxl,
                                          uint64_t dyl, uint64_t sx,
                                          uint64_t sy, int steps) {
  wgmma::fence_regs(p);
  wgmma::fence();
  for (int s = 0; s < steps; ++s) {
    wgmma::SS<N>::mma(p, dxh + s * sx, dyh + s * sy, s != 0);
    if constexpr (THREE) {
      wgmma::SS<N>::mma(p, dxl + s * sx, dyh + s * sy, 1);
      wgmma::SS<N>::mma(p, dxh + s * sx, dyl + s * sy, 1);
    }
  }
  wgmma::commit();
}

// Accumulators a thread alternates over the reps at wgmma's N: two, so
// that each rep's products are issued before the wait for the previous
// rep's, whose sum is added meanwhile; one at N = 128, where a second one
// takes 64 more registers a thread (222 against 156) and so one of the
// three blocks an SM that L3's M = 128 plan places.  Measured by
// labs_ab.py on an NVIDIA H100 80GB HBM3 at 700 W: one accumulator costs
// L4's M = 8 case and L3's N = 16 cases 9-12 %; two cost L3's M = 128
// cases 30-37 % (and gain L4's m >= 64 cases 3-6 %).
template <int N>
constexpr bool kTwoAcc = N < 128;

// The reps, rep r's sum added to c in rep order: with two accumulators in
// p (r even) or q (r odd), after the wait that leaves only the next rep in
// flight; with one after each rep's wait.
template <int N, bool THREE>
__device__ __forceinline__ void run_reps(float (&c)[N / 2], uint64_t dxh,
                                         uint64_t dyh, uint64_t dxl,
                                         uint64_t dyl, uint64_t sx,
                                         uint64_t sy, int steps, int reps) {
  float p[N / 2];
  if constexpr (!kTwoAcc<N>) {
    for (int r = 0; r < reps; ++r) {
      asm volatile("" ::: "memory");
      issue_rep<N, THREE>(p, dxh, dyh, dxl, dyl, sx, sy, steps);
      wgmma::wait<0>();
      add_rep<N>(c, p);
    }
  } else {
    float q[N / 2];
    issue_rep<N, THREE>(p, dxh, dyh, dxl, dyl, sx, sy, steps);
    int r = 1;
    for (; r + 1 < reps; r += 2) {
      asm volatile("" ::: "memory");
      issue_rep<N, THREE>(q, dxh, dyh, dxl, dyl, sx, sy, steps);
      wgmma::wait<1>();
      add_rep<N>(c, p);
      issue_rep<N, THREE>(p, dxh, dyh, dxl, dyl, sx, sy, steps);
      wgmma::wait<1>();
      add_rep<N>(c, q);
    }
    if (r < reps) {
      issue_rep<N, THREE>(q, dxh, dyh, dxl, dyl, sx, sy, steps);
      wgmma::wait<1>();
      add_rep<N>(c, p);
      wgmma::wait<0>();
      add_rep<N>(c, q);
    } else {
      wgmma::wait<0>();
      add_rep<N>(c, p);
    }
  }
}

// 'bf16'/'3pass' on wgmma: D (64 x N) = X (64 x K) . Y^T, one warpgroup a
// slice of kw.  Path wgmma: D = out^T, X the unit's 64 columns of b, Y its
// N rows of a; wgmma_n: D = out, X 64 rows of a, Y N columns of b.
template <typename In, int N>
__global__ void __launch_bounds__(256) tile_dot_wgmma(
    const In* __restrict__ a, const In* __restrict__ b,
    float* __restrict__ out, float* __restrict__ scratch, int batch, int m,
    int k, int n, int mode, int reps, NtPlan P) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xh = reinterpret_cast<__nv_bfloat16*>(smem);  // A: 64 rows
  __nv_bfloat16* yh = xh + 64 * P.kblk;                        // B: N rows
  __nv_bfloat16* xl = yh + N * P.kblk;
  __nv_bfloat16* yl = xl + 64 * P.kblk;
  const NtBlock B = nt_block(P);
  const In* ae = a + static_cast<long long>(B.e) * m * k;
  const In* be = b + static_cast<long long>(B.e) * n * k;
  const bool tr = P.path == kPathWgmma;  // D = out^T
  if (tr) {
    stage_core(be, !P.kn, n, k, B.col0, 64, B.k0, P.kblk, mode, xh, xl);
    stage_core(ae, true, m, k, B.row0, N, B.k0, P.kblk, mode, yh, yl);
  } else {
    stage_core(ae, true, m, k, B.row0, 64, B.k0, P.kblk, mode, xh, xl);
    stage_core(be, !P.kn, n, k, B.col0, N, B.k0, P.kblk, mode, yh, yl);
  }
  // the generic proxy's stores, visible to the tensor cores' async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lbo_x = 64 / 8 * 128, lbo_y = N / 8 * 128;
  const int kbeg = wg * P.kw;
  // Every warpgroup runs its whole slice, zeros past K included (the
  // staging wrote them): the steps and every branch around the products
  // then come from the kernel's arguments alone, which ptxas needs to keep
  // the wgmma instructions in flight (else it serializes them, remark
  // C7520, as it does where the steps depend on the thread).
  const int steps = P.kw / 16;
  // a k16 step moves both descriptors by two k groups
  using wgmma::core_off;
  const uint64_t dxh = wgmma::desc(xh + core_off(0, kbeg, 64), lbo_x, 128);
  const uint64_t dyh = wgmma::desc(yh + core_off(0, kbeg, N), lbo_y, 128);
  const uint64_t dxl = wgmma::desc(xl + core_off(0, kbeg, 64), lbo_x, 128);
  const uint64_t dyl = wgmma::desc(yl + core_off(0, kbeg, N), lbo_y, 128);
  const uint64_t sx = 2 * lbo_x >> 4, sy = 2 * lbo_y >> 4;
  float c[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) c[i] = 0.f;
  if (reps > 0) {
    if (mode == kMode3Pass) {
      run_reps<N, true>(c, dxh, dyh, dxl, dyl, sx, sy, steps, reps);
    } else {
      run_reps<N, false>(c, dxh, dyh, dxl, dyl, sx, sy, steps, reps);
    }
  }
  __syncthreads();  // the operands are dead: the partials reuse them
  // c[4 j + h]: D row 16 w + g + 8 (h >> 1), column 8 j + 2 t + (h & 1);
  // the partials red[wg] as the unit's tm x tn
  float* red = reinterpret_cast<float*>(smem) + wg * N * 64;
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int dr = 16 * w + g + 8 * (h >> 1), dc = 8 * j + 2 * t + (h & 1);
      red[tr ? dc * 64 + dr : dr * N + dc] = c[4 * j + h];
    }
  __syncthreads();
  nt_store(reinterpret_cast<float*>(smem), P,
           nt_dest(out, scratch, P, batch, m, n, B.kbi), B.e, B.row0, B.col0,
           m, n);
}

// 'bf16'/'3pass' where n < 64: mma.sync m16n8k16 on a 16 x 16 warp tile,
// one warp a slice of kw; rows of kblk + 8 bfloat16 (conflict-free
// fragment loads where kblk is a multiple of 64).
template <typename In>
__global__ void __launch_bounds__(256) tile_dot_mma(
    const In* __restrict__ a, const In* __restrict__ b,
    float* __restrict__ out, float* __restrict__ scratch, int batch, int m,
    int k, int n, int mode, int reps, NtPlan P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sb = P.kblk + 8;
  __nv_bfloat16* ah = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bh = ah + 16 * sb;
  __nv_bfloat16* al = bh + 16 * sb;
  __nv_bfloat16* bl = al + 16 * sb;
  const NtBlock B = nt_block(P);
  const In* ae = a + static_cast<long long>(B.e) * m * k;
  const In* be = b + static_cast<long long>(B.e) * n * k;
  for (int i = threadIdx.x; i < 16 * P.kblk; i += blockDim.x) {
    const int r = i / P.kblk, kk = i % P.kblk, kg = B.k0 + kk;
    const float x = (B.row0 + r < m && kg < k)
                        ? to_f(ae[static_cast<long long>(B.row0 + r) * k + kg])
                        : 0.f;
    const float y = (B.col0 + r < n && kg < k)
                        ? to_f(be[static_cast<long long>(B.col0 + r) * k + kg])
                        : 0.f;
    stage(x, mode, r * sb + kk, nullptr, ah, al);
    stage(y, mode, r * sb + kk, nullptr, bh, bl);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kbeg = warp * P.kw;
  int kend = kbeg + P.kw;
  if (kend > k - B.k0) kend = k - B.k0;
  const uint32_t* ah32 = reinterpret_cast<const uint32_t*>(ah);
  const uint32_t* bh32 = reinterpret_cast<const uint32_t*>(bh);
  const uint32_t* al32 = reinterpret_cast<const uint32_t*>(al);
  const uint32_t* bl32 = reinterpret_cast<const uint32_t*>(bl);
  const int sw = sb / 2;  // row stride in 32-bit words
  const int ra = g * sw + t;
  float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int rep = 0; rep < reps; ++rep) {
    asm volatile("" ::: "memory");
    float p[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kk = kbeg; kk < kend; kk += 16) {
      const int kw = kk / 2;
      const uint32_t ahi[4] = {ah32[ra + kw], ah32[ra + 8 * sw + kw],
                               ah32[ra + kw + 4], ah32[ra + 8 * sw + kw + 4]};
      uint32_t alo[4] = {0u, 0u, 0u, 0u};
      if (mode == kMode3Pass) {
        alo[0] = al32[ra + kw];
        alo[1] = al32[ra + 8 * sw + kw];
        alo[2] = al32[ra + kw + 4];
        alo[3] = al32[ra + 8 * sw + kw + 4];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int rb = ra + 8 * nt * sw;
        const uint32_t b0 = bh32[rb + kw], b1 = bh32[rb + kw + 4];
        mma_bf16(p[nt], ahi, b0, b1);
        if (mode == kMode3Pass) {
          mma_bf16(p[nt], ahi, bl32[rb + kw], bl32[rb + kw + 4]);
          mma_bf16(p[nt], alo, b0, b1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[nt][i] = __fadd_rn(c[nt][i], p[nt][i]);
  }
  __syncthreads();  // the operands are dead: the partials reuse them
  float* red = reinterpret_cast<float*>(smem) + warp * 256;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      red[(g + 8 * (h >> 1)) * 16 + 8 * nt + 2 * t + (h & 1)] = c[nt][h];
    }
  __syncthreads();
  nt_store(reinterpret_cast<float*>(smem), P,
           nt_dest(out, scratch, P, batch, m, n, B.kbi), B.e, B.row0, B.col0,
           m, n);
}

// out[i] = the kb blocks' partials added in block order.
__global__ void tile_dot_reduce(const float* __restrict__ scratch,
                                   float* __restrict__ out, int kb,
                                   long long total) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = scratch[i];
    for (int j = 1; j < kb; ++j) s = __fadd_rn(s, scratch[j * total + i]);
    out[i] = s;
  }
}

template <typename K, typename... Args>
cudaError_t launch(K kernel, int blocks, int threads, long long smem,
                   cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<blocks, threads, static_cast<int>(smem), st>>>(args...);
  return cudaGetLastError();
}

// f(kernel) for the plan's kernel (they share one signature).
template <typename In, typename F>
cudaError_t dispatch(const NtPlan& P, F&& f) {
  if (P.path == kPathFma) {
    if (P.rm == 8 && P.tr == 2 && P.tc == 16) {
      return f(tile_dot_fma<In, 2, 16, 8>);
    }
    if (P.rm == 4 && P.tr == 4 && P.tc == 8) {
      return f(tile_dot_fma<In, 4, 8, 4>);
    }
    if (P.rm == 4 && P.tr == 2 && P.tc == 8) {
      return f(tile_dot_fma<In, 2, 8, 4>);
    }
    if (P.rm == 4 && P.tr == 4 && P.tc == 2) {
      return f(tile_dot_fma<In, 4, 2, 4>);
    }
    return cudaErrorInvalidValue;
  }
  if (P.path == kPathMma) return f(tile_dot_mma<In>);
  // wgmma's N: the unit's rows of out (wgmma) or its columns (wgmma_n)
  switch (P.path == kPathWgmma ? P.tm : P.tn) {
    case 8:
      return f(tile_dot_wgmma<In, 8>);
    case 16:
      return f(tile_dot_wgmma<In, 16>);
    case 32:
      return f(tile_dot_wgmma<In, 32>);
    case 64:
      return f(tile_dot_wgmma<In, 64>);
    case 128:
      return f(tile_dot_wgmma<In, 128>);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename In>
cudaError_t launch_plan(const In* a, const In* b, float* out, float* scratch,
                        int batch, int m, int k, int n, int mode, int reps,
                        const NtPlan& P, cudaStream_t st) {
  const long long smem = plan_smem(P, mode);
  const int blocks = batch * P.mg * P.ng * P.kb;
  return dispatch<In>(P, [&](auto kernel) {
    return launch(kernel, blocks, P.threads, smem, st, a, b, out, scratch,
                  batch, m, k, n, mode, reps, P);
  });
}

template <typename K>
int occupancy(K kernel, int threads, long long smem) {
  int n = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess) {
    return -1;
  }
  return n;
}

}  // namespace

// Resident blocks per SM (the occupancy calculator) of the kernel of the
// plan (path, tr, tc, rm, kw, wb), which serves either layout.
extern "C" int tile_dot_blocks_per_sm(int m, int n, int in_bf16, int mode,
                                      int path, int tr, int tc, int rm,
                                      int kw, int wb) {
  const NtPlan P = make_plan(0, m, n, path, tr, tc, rm, kw, wb, 1);
  const long long smem = plan_smem(P, mode);
  int blocks = -1;
  auto f = [&](auto kernel) {
    blocks = occupancy(kernel, P.threads, smem);
    return cudaSuccess;
  };
  in_bf16 ? dispatch<__nv_bfloat16>(P, f) : dispatch<float>(P, f);
  return blocks;
}

// Shared memory of a block of the plan (path, tr, tc, rm, kw, wb) in
// `mode`, either layout.
extern "C" long long tile_dot_smem(int m, int n, int mode, int path, int tr,
                                   int tc, int rm, int kw, int wb) {
  return plan_smem(make_plan(0, m, n, path, tr, tc, rm, kw, wb, 1), mode);
}

// nn: a (batch, m, k) . b (batch, k, n) (layout NN), else a . b^T with b
// (batch, n, k) (layout NT).  scratch: kb x batch x m x n floats where kb >
// 1 (else unused).
extern "C" int tile_dot_launch(int nn, const void* a, const void* b,
                               void* out, void* scratch, int batch, int m,
                               int k, int n, int in_bf16, int mode, int reps,
                               int path, int tr, int tc, int rm, int kw,
                               int wb, int kb, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  const NtPlan P = make_plan(nn, m, n, path, tr, tc, rm, kw, wb, kb);
  // the plan covers K, and a lane's first k lies inside its block's slices;
  // mma serves layout NT only
  const bool fits = kw > 0 && wb > 0 && kb > 0 &&
                    static_cast<long long>(kb) * P.kblk >= k &&
                    P.threads <= 256 && (path == kPathFma) == (mode == kModeF32) &&
                    (path == kPathFma || kw % 16 == 0) &&
                    (path != kPathFma || kw >= 32 / (tr * tc)) &&
                    !(nn && path == kPathMma);
  if (!fits || (kb > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* s = static_cast<float*>(scratch);
  const auto* ab = static_cast<const __nv_bfloat16*>(a);
  const auto* bb = static_cast<const __nv_bfloat16*>(b);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  const cudaError_t e =
      in_bf16 ? launch_plan(ab, bb, o, s, batch, m, k, n, mode, reps, P, st)
              : launch_plan(af, bf, o, s, batch, m, k, n, mode, reps, P, st);
  if (e != cudaSuccess || kb == 1) return static_cast<int>(e);
  const long long total = static_cast<long long>(batch) * m * n;
  const long long want = (total + 255) / 256;
  const int grid = static_cast<int>(want < 1056 ? want : 1056);
  tile_dot_reduce<<<grid, 256, 0, st>>>(s, o, kb, total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tile_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
