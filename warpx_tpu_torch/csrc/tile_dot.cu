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
// Layout NN (L4), the first design: each warp owns one 16 x 8 mma.sync tile
// and runs its reps over the whole K; a block of `warps` warps shares the 16
// rows of a, staged once in shared memory in the mode's format, with a row
// stride padded so the fragment loads hit 32 distinct banks.  Rows past m
// (M = 8) are zeros that the mma computes and nobody reads.
//
// Layout NT (L3), redesigned for the H100.  The host's plan
// (tools/bench_dot_shapes.py::_plan_nt) cuts every batch entry's output
// into units and K into slices of `kw`: a block of `wb` warps (warpgroups on
// the wgmma path) takes one unit and `wb` consecutive slices, staged once in
// shared memory; `kb` blocks cover a unit's K.  Each warp runs the reps over
// its own slice, so the grid has units x slices warps where the first
// design had one warp a 16 x 8 tile over the whole K (256 warps, two an
// SM, at L3's principal shape).  Three paths:
//   'f32'  FP32 FMA on register micro-tiles of 4 rows x 8 columns a lane;
//          the operands are staged k-major (a_s[k][row], b_s[k][col]) so
//          that one LDS.128 feeds 16 or 32 FMA and a warp's loads of `a`
//          are broadcasts (TR x TC lanes tile the unit, TK = 32 / (TR TC)
//          lanes interleave the slice's k);
//   wgmma  'bf16'/'3pass' where n >= 64: out^T = b . a^T, both operands
//          K-major, bfloat16 hi (and lo) staged once in the no-swizzle
//          core-matrix layout; a warpgroup issues m64nNk16 (N = m rounded
//          up to 8, 16, 32, 64 or 128) over its slice;
//   mma    'bf16'/'3pass' where n < 64 (the 2D deposit's 16 x 16):
//          mma.sync m16n8k16 on a 16 x 16 warp tile, operands staged once.
// The warps' partial sums meet once, after the last rep: in shared memory
// in warp order, then, where kb > 1, through a scratch buffer that a second
// kernel adds in block order.  No float atomics: the result is the same
// from launch to launch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kModeF32 = 0, kMode3Pass = 2;  // and 1, 'bf16'
constexpr int kPathFma = 0, kPathWgmma = 1, kPathMma = 2;

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

// ---- layout NN (L4): the first design -------------------------------------

template <typename In>
__global__ void tile_dot_nn_kernel(const In* __restrict__ a,
                                   const In* __restrict__ b,
                                   float* __restrict__ out, int m, int k,
                                   int n, int mode, int reps, int mg, int ng) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int cols = 8 * warps;
  int bid = blockIdx.x;
  const int nb = bid % ng;
  bid /= ng;
  const int mb = bid % mg;
  const int e = bid / mg;  // batch entry
  const int row0 = mb * 16, col0 = nb * cols;
  // row strides: K + 4 floats, or K + 8 bfloat16 (K/2 + 4 words)
  const int sf = k + 4, sb = k + 8;
  float* af = reinterpret_cast<float*>(smem);
  float* bf = af + 16 * sf;
  __nv_bfloat16* ah = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bh = ah + 16 * sb;
  __nv_bfloat16* al = bh + cols * sb;
  __nv_bfloat16* bl = al + 16 * sb;

  const In* ae = a + static_cast<long long>(e) * m * k;
  const In* be = b + static_cast<long long>(e) * n * k;
  for (int i = threadIdx.x; i < 16 * k; i += blockDim.x) {
    const int r = i / k, kk = i % k;
    const float x = (row0 + r < m) ? to_f(ae[(row0 + r) * k + kk]) : 0.f;
    const int idx = mode == kModeF32 ? r * sf + kk : r * sb + kk;
    stage(x, mode, idx, af, ah, al);
  }
  for (int i = threadIdx.x; i < cols * k; i += blockDim.x) {
    // b (k, n): column fastest in memory
    const int kk = i / cols, c = i % cols;
    const int col = col0 + c;
    const float x = col < n ? to_f(be[kk * n + col]) : 0.f;
    const int idx = mode == kModeF32 ? c * sf + kk : c * sb + kk;
    stage(x, mode, idx, bf, bh, bl);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wc = warp * 8;  // the warp's first column in the block
  if (col0 + wc >= n) return;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  if (mode == kModeF32) {
    const float* ar0 = af + g * sf;
    const float* ar1 = af + (g + 8) * sf;
    const float* br0 = bf + (wc + 2 * tig) * sf;
    const float* br1 = bf + (wc + 2 * tig + 1) * sf;
    for (int rep = 0; rep < reps; ++rep) {
      asm volatile("" ::: "memory");
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < k; kk += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(ar0 + kk);
        const float4 x1 = *reinterpret_cast<const float4*>(ar1 + kk);
        const float4 y0 = *reinterpret_cast<const float4*>(br0 + kk);
        const float4 y1 = *reinterpret_cast<const float4*>(br1 + kk);
        p[0] = fmaf(x0.x, y0.x, p[0]); p[0] = fmaf(x0.y, y0.y, p[0]);
        p[0] = fmaf(x0.z, y0.z, p[0]); p[0] = fmaf(x0.w, y0.w, p[0]);
        p[1] = fmaf(x0.x, y1.x, p[1]); p[1] = fmaf(x0.y, y1.y, p[1]);
        p[1] = fmaf(x0.z, y1.z, p[1]); p[1] = fmaf(x0.w, y1.w, p[1]);
        p[2] = fmaf(x1.x, y0.x, p[2]); p[2] = fmaf(x1.y, y0.y, p[2]);
        p[2] = fmaf(x1.z, y0.z, p[2]); p[2] = fmaf(x1.w, y0.w, p[2]);
        p[3] = fmaf(x1.x, y1.x, p[3]); p[3] = fmaf(x1.y, y1.y, p[3]);
        p[3] = fmaf(x1.z, y1.z, p[3]); p[3] = fmaf(x1.w, y1.w, p[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], p[i]);
    }
  } else {
    const uint32_t* ah32 = reinterpret_cast<const uint32_t*>(ah);
    const uint32_t* bh32 = reinterpret_cast<const uint32_t*>(bh);
    const uint32_t* al32 = reinterpret_cast<const uint32_t*>(al);
    const uint32_t* bl32 = reinterpret_cast<const uint32_t*>(bl);
    const int sw = sb / 2;  // row stride in 32-bit words
    const int ra = g * sw + tig, rb = (wc + g) * sw + tig;
    for (int rep = 0; rep < reps; ++rep) {
      asm volatile("" ::: "memory");
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < k; kk += 16) {
        const int kw = kk / 2;
        const uint32_t ahi[4] = {ah32[ra + kw], ah32[ra + 8 * sw + kw],
                                 ah32[ra + kw + 4], ah32[ra + 8 * sw + kw + 4]};
        const uint32_t b0 = bh32[rb + kw], b1 = bh32[rb + kw + 4];
        mma_bf16(p, ahi, b0, b1);
        if (mode == kMode3Pass) {
          const uint32_t alo[4] = {al32[ra + kw], al32[ra + 8 * sw + kw],
                                   al32[ra + kw + 4],
                                   al32[ra + 8 * sw + kw + 4]};
          mma_bf16(p, ahi, bl32[rb + kw], bl32[rb + kw + 4]);
          mma_bf16(p, alo, b0, b1);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], p[i]);
    }
  }
  float* oe = out + static_cast<long long>(e) * m * n;
  const int col = col0 + wc + 2 * tig;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row < m) {
      if (col < n) oe[row * n + col] = c[2 * h];
      if (col + 1 < n) oe[row * n + col + 1] = c[2 * h + 1];
    }
  }
}

// ---- layout NT (L3): split K, one deterministic reduction -----------------

// Must match tools/bench_dot_shapes.py::_plan_nt.
struct NtPlan {
  int path, tr, tc, rm, kw, wb, kb;
  int tm, tn;    // the unit's rows (of out) and columns
  int threads;   // a block's
  int kblk;      // the K a block stages: wb * kw
  int mg, ng;    // units along m and n per batch entry
};

__host__ __device__ inline int wgmma_n(int m) {
  return m <= 8 ? 8 : m <= 16 ? 16 : m <= 32 ? 32 : m <= 64 ? 64 : 128;
}

__host__ __device__ inline NtPlan make_plan(int m, int n, int path, int tr,
                                            int tc, int rm, int kw, int wb,
                                            int kb) {
  NtPlan p{path, tr, tc, rm, kw, wb, kb, 0, 0, 0, wb * kw, 0, 0};
  if (path == kPathFma) {
    p.tm = rm * tr;
    p.tn = 8 * tc;
    p.threads = 32 * wb;
  } else if (path == kPathWgmma) {
    p.tm = wgmma_n(m);
    p.tn = 64;
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
  } else if (p.path == kPathWgmma) {
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
// (`mode` is 'f32': the three NT kernels share one signature.)
template <typename In, int TR, int TC, int RM>
__global__ void __launch_bounds__(256) tile_dot_nt_fma(
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
    const int c = i / P.kblk, kk = i % P.kblk, kg = B.k0 + kk;
    bs[kk * TN + c] = (B.col0 + c < n && kg < k)
                          ? to_f(be[static_cast<long long>(B.col0 + c) * k + kg])
                          : 0.f;
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

// The no-swizzle K-major core-matrix layout of a wgmma operand of R rows:
// 8 rows x 16 bytes contiguous, row groups 128 bytes apart (SBO), k groups
// of 8 R / 8 * 128 bytes apart (LBO).
__device__ __forceinline__ int core_off(int r, int kk, int rows) {
  return ((kk >> 3) * (rows >> 3) + (r >> 3)) * 64 + (r & 7) * 8 + (kk & 7);
}

__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d)
        : "memory");
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d)
        : "memory");
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d)
        : "memory");
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d)
        : "memory");
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d)
        : "memory");
  }
};


template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Stage rows [row0, row0 + rows) of x (count, k) over the block's K as
// bfloat16 hi (and lo) in the core-matrix layout of `rows` rows.
template <typename In>
__device__ __forceinline__ void stage_core(const In* x, int count, int k,
                                           int row0, int rows, int k0,
                                           int kblk, int mode,
                                           __nv_bfloat16* hi,
                                           __nv_bfloat16* lo) {
  for (int i = threadIdx.x; i < rows * kblk; i += blockDim.x) {
    const int r = i / kblk, kk = i % kblk, kg = k0 + kk;
    const float v = (row0 + r < count && kg < k)
                        ? to_f(x[static_cast<long long>(row0 + r) * k + kg])
                        : 0.f;
    stage(v, mode, core_off(r, kk, rows), nullptr, hi, lo);
  }
}

// 'bf16'/'3pass' where n >= 64: out^T (64 x N) = b (64 x K) . a^T, one
// warpgroup a slice of kw.
template <typename In, int N>
__global__ void __launch_bounds__(256) tile_dot_nt_wgmma(
    const In* __restrict__ a, const In* __restrict__ b,
    float* __restrict__ out, float* __restrict__ scratch, int batch, int m,
    int k, int n, int mode, int reps, NtPlan P) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* bh = reinterpret_cast<__nv_bfloat16*>(smem);  // A: b rows
  __nv_bfloat16* ah = bh + 64 * P.kblk;                        // B: a rows
  __nv_bfloat16* bl = ah + N * P.kblk;
  __nv_bfloat16* al = bl + 64 * P.kblk;
  const NtBlock B = nt_block(P);
  stage_core(b + static_cast<long long>(B.e) * n * k, n, k, B.col0, 64, B.k0,
             P.kblk, mode, bh, bl);
  stage_core(a + static_cast<long long>(B.e) * m * k, m, k, B.row0, N, B.k0,
             P.kblk, mode, ah, al);
  // the generic proxy's stores, visible to the tensor cores' async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lbo_a = 64 / 8 * 128, lbo_b = N / 8 * 128;
  const int kbeg = wg * P.kw;
  int kend = kbeg + P.kw;
  if (kend > k - B.k0) kend = k - B.k0;
  const int steps = kend > kbeg ? (kend - kbeg + 15) / 16 : 0;
  // a k16 step moves both descriptors by two k groups
  const uint64_t da_h = wgmma_desc(bh + core_off(0, kbeg, 64), lbo_a, 128);
  const uint64_t db_h = wgmma_desc(ah + core_off(0, kbeg, N), lbo_b, 128);
  const uint64_t da_l = wgmma_desc(bl + core_off(0, kbeg, 64), lbo_a, 128);
  const uint64_t db_l = wgmma_desc(al + core_off(0, kbeg, N), lbo_b, 128);
  const uint64_t sa = 2 * lbo_a >> 4, sb = 2 * lbo_b >> 4;
  float c[N / 2], p[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) c[i] = 0.f;
  for (int rep = 0; rep < reps; ++rep) {
    asm volatile("" ::: "memory");
#pragma unroll
    for (int i = 0; i < N / 2; ++i) p[i] = 0.f;
    fence_regs(p);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int s = 0; s < steps; ++s) {
      Wgmma<N>::mma(p, da_h + s * sa, db_h + s * sb, 1);
      if (mode == kMode3Pass) {
        Wgmma<N>::mma(p, da_l + s * sa, db_h + s * sb, 1);  // a_hi . b_lo
        Wgmma<N>::mma(p, da_h + s * sa, db_l + s * sb, 1);  // a_lo . b_hi
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(p);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) c[i] = __fadd_rn(c[i], p[i]);
  }
  __syncthreads();  // the operands are dead: the partials reuse them
  // c[4 j + h]: out^T row 16 w + g + 8 (h >> 1), column 8 j + 2 t + (h & 1)
  float* red = reinterpret_cast<float*>(smem) + wg * N * 64;
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int nr = 16 * w + g + 8 * (h >> 1), mc = 8 * j + 2 * t + (h & 1);
      red[mc * 64 + nr] = c[4 * j + h];
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
__global__ void __launch_bounds__(256) tile_dot_nt_mma(
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
__global__ void tile_dot_nt_reduce(const float* __restrict__ scratch,
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

// f(kernel) for the plan's kernel (the three share one signature).
template <typename In, typename F>
cudaError_t nt_dispatch(const NtPlan& P, F&& f) {
  if (P.path == kPathFma) {
    if (P.rm == 8 && P.tr == 2 && P.tc == 16) {
      return f(tile_dot_nt_fma<In, 2, 16, 8>);
    }
    if (P.rm == 4 && P.tr == 4 && P.tc == 8) {
      return f(tile_dot_nt_fma<In, 4, 8, 4>);
    }
    if (P.rm == 4 && P.tr == 2 && P.tc == 8) {
      return f(tile_dot_nt_fma<In, 2, 8, 4>);
    }
    if (P.rm == 4 && P.tr == 4 && P.tc == 2) {
      return f(tile_dot_nt_fma<In, 4, 2, 4>);
    }
    return cudaErrorInvalidValue;
  }
  if (P.path == kPathMma) return f(tile_dot_nt_mma<In>);
  switch (P.tm) {
    case 8:
      return f(tile_dot_nt_wgmma<In, 8>);
    case 16:
      return f(tile_dot_nt_wgmma<In, 16>);
    case 32:
      return f(tile_dot_nt_wgmma<In, 32>);
    case 64:
      return f(tile_dot_nt_wgmma<In, 64>);
    default:
      return f(tile_dot_nt_wgmma<In, 128>);
  }
}

template <typename In>
cudaError_t launch_nt(const In* a, const In* b, float* out, float* scratch,
                      int batch, int m, int k, int n, int mode, int reps,
                      const NtPlan& P, cudaStream_t st) {
  const long long smem = plan_smem(P, mode);
  const int blocks = batch * P.mg * P.ng * P.kb;
  return nt_dispatch<In>(P, [&](auto kernel) {
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

// ---- layout NN ----

// Shared memory a block of `warps` warps needs for depth k in `mode`.
extern "C" long long tile_dot_smem(int k, int mode, int warps) {
  const long long rows = 16 + 8LL * warps;
  if (mode == kModeF32) return rows * (k + 4) * 4;
  return rows * (k + 8) * 2 * (mode == kMode3Pass ? 2 : 1);
}

extern "C" int tile_dot_launch(const void* a, const void* b, void* out,
                               int batch, int m, int k, int n, int in_bf16,
                               int mode, int reps, int warps, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mg = (m + 15) / 16, ng = (n + 8 * warps - 1) / (8 * warps);
  const int blocks = batch * mg * ng;
  const long long smem = tile_dot_smem(k, mode, warps);
  cudaError_t e;
  if (in_bf16) {
    e = launch(tile_dot_nn_kernel<__nv_bfloat16>, blocks, 32 * warps, smem,
               st, static_cast<const __nv_bfloat16*>(a),
               static_cast<const __nv_bfloat16*>(b), static_cast<float*>(out),
               m, k, n, mode, reps, mg, ng);
  } else {
    e = launch(tile_dot_nn_kernel<float>, blocks, 32 * warps, smem, st,
               static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<float*>(out), m, k, n, mode, reps, mg, ng);
  }
  return static_cast<int>(e);
}

// ---- layout NT ----

// Resident blocks per SM (the occupancy calculator) of layout NN's kernel.
extern "C" int tile_dot_nn_blocks_per_sm(int k, int in_bf16, int mode,
                                         int warps) {
  const long long smem = tile_dot_smem(k, mode, warps);
  return in_bf16 ? occupancy(tile_dot_nn_kernel<__nv_bfloat16>, 32 * warps,
                             smem)
                 : occupancy(tile_dot_nn_kernel<float>, 32 * warps, smem);
}

// Resident blocks per SM of the plan (path, tr, tc, rm, kw, wb)'s kernel.
extern "C" int tile_dot_nt_blocks_per_sm(int m, int n, int in_bf16, int mode,
                                         int path, int tr, int tc, int rm,
                                         int kw, int wb) {
  const NtPlan P = make_plan(m, n, path, tr, tc, rm, kw, wb, 1);
  const long long smem = plan_smem(P, mode);
  int blocks = -1;
  auto f = [&](auto kernel) {
    blocks = occupancy(kernel, P.threads, smem);
    return cudaSuccess;
  };
  if (in_bf16) {
    nt_dispatch<__nv_bfloat16>(P, f);
  } else {
    nt_dispatch<float>(P, f);
  }
  return blocks;
}

// Shared memory of a block of the plan (path, tr, tc, rm, kw, wb) in
// `mode`.
extern "C" long long tile_dot_nt_smem(int m, int n, int mode, int path,
                                      int tr, int tc, int rm, int kw,
                                      int wb) {
  return plan_smem(make_plan(m, n, path, tr, tc, rm, kw, wb, 1), mode);
}

// scratch: kb x batch x m x n floats where kb > 1 (else unused).
extern "C" int tile_dot_nt_launch(const void* a, const void* b, void* out,
                                  void* scratch, int batch, int m, int k,
                                  int n, int in_bf16, int mode, int reps,
                                  int path, int tr, int tc, int rm, int kw,
                                  int wb, int kb, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  const NtPlan P = make_plan(m, n, path, tr, tc, rm, kw, wb, kb);
  // the plan covers K, and a lane's first k lies inside its block's slices
  const bool fits = kw > 0 && wb > 0 && kb > 0 &&
                    static_cast<long long>(kb) * P.kblk >= k &&
                    P.threads <= 256 && (path == kPathFma) == (mode == kModeF32) &&
                    (path == kPathFma || kw % 16 == 0) &&
                    (path != kPathFma || kw >= 32 / (tr * tc));
  if (!fits || (kb > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* s = static_cast<float*>(scratch);
  cudaError_t e =
      in_bf16 ? launch_nt(static_cast<const __nv_bfloat16*>(a),
                          static_cast<const __nv_bfloat16*>(b), o, s, batch, m,
                          k, n, mode, reps, P, st)
              : launch_nt(static_cast<const float*>(a),
                          static_cast<const float*>(b), o, s, batch, m, k, n,
                          mode, reps, P, st);
  if (e != cudaSuccess || kb == 1) return static_cast<int>(e);
  const long long total = static_cast<long long>(batch) * m * n;
  const long long want = (total + 255) / 256;
  const int grid = static_cast<int>(want < 1056 ? want : 1056);
  tile_dot_nt_reduce<<<grid, 256, 0, st>>>(s, o, kb, total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tile_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
