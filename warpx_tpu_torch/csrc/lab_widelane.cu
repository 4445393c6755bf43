// Lab L2: the fused kernel's gather and deposit contractions with the
// particle axis batched (S, W, 128) or wide (W, P).
//
// Replaces tools/lab_widelane.py::make (:47, pallas_call :158), bodies
// kernel_batched (:55) and kernel_wide (:86).  Per tile t, over the P
// particles (p = s*128 + j in the batched layout):
//
//   byz[q, p] = bf16(ay[b, p] * az[c, p])                 q = b*W + c
//   h_g       = bf16(win[t, :mW]) . byz        mW = 2W for g < 2, W after
//   out[t, p] = sum over g of  sum over b < W of  ay[b, p] * h_g[b, p]
//   jw[t]     = sum over 3 components of  lhs . byz^T  (contracted over p)
//
// The gather's operands are bfloat16 (the lab's gmx) at DEFAULT precision;
// the deposit is 'bf16' (DEFAULT: lhs rounded to bfloat16 too) or 'f32'
// (HIGHEST: lhs in float32 against the bfloat16-valued byz, float32 sums).
//
// Bound on the card: operations, ~2*(2+2+1+1)*W*W^2 + 3*2*W*W^2 flops per
// particle and tile on the tensor cores (bfloat16, 989 TFLOP/s) or, for the
// 'f32' deposit, on FP32 (67 TFLOP/s); the inputs are small and shared by
// every tile.  Design: one block per tile; the tile's window (2W x W^2) is
// staged once in shared memory as bfloat16; the particles go by in chunks of
// 64, for which byz is built once in shared memory in the two layouts the
// two products read (particle-major for the gather's B operand,
// q-major for the deposit's), without FMA contraction before its rounding;
// both products are mma.sync m16n8k16 with float32 accumulators (the 'f32'
// deposit: FP32 FMA).  Each warp owns one 8-particle column of the gather
// and a quarter of the window's columns of the three deposit accumulators,
// which stay in registers over all chunks and are written once.  Rows W..2W
// of the first two gather groups are computed and not used, as in the lab.
// The layout of the particle axis changes only the input addresses.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Must match warpx_tpu_torch/tools/lab_widelane.py::_LabWidelaneArgs.
struct LabWidelaneArgs {
  const float* win;  // (nt, 2W, W^2)
  const float* ay;   // (S, W, 128) batched or (W, P) wide
  const float* az;
  const float* lhs;
  float* out;        // (nt, P)
  float* jw;         // (nt, W, W^2)
  int nt, w, p, batched, dep_f32;
};

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kChunk = 64;  // particles per chunk: 8 n8 tiles of the gather
constexpr int kMaxDepTiles = 4;  // n8 tiles of W^2 per warp at W = 16

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ long long part_index(int b, int p, int w, int np,
                                                int batched) {
  return batched ? static_cast<long long>(p / 128) * w * 128 + b * 128 + p % 128
                 : static_cast<long long>(b) * np + p;
}

__global__ void __launch_bounds__(kThreads)
lab_widelane_kernel(LabWidelaneArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = a.w, W2 = a.w * a.w, rows = 2 * a.w;
  const int sw = W2 + 8;       // bf16 stride of win and byzP rows
  const int sq = kChunk + 8;   // bf16 stride of byzQ rows
  const int sf = kChunk + 4;   // float stride of ay, az, lhs rows
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* byzp = win + 32 * sw;          // [kChunk][W2]
  __nv_bfloat16* byzq = byzp + kChunk * sw;     // [W2][kChunk]
  float* ays = reinterpret_cast<float*>(byzq + W2 * sq);
  float* azs = ays + 16 * sf;
  float* lhs = azs + 16 * sf;
  const int t = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;

  // the tile's window as bfloat16, rows past 2W zero
  const float* wt = a.win + static_cast<long long>(t) * rows * W2;
  for (int i = threadIdx.x; i < 32 * W2; i += kThreads) {
    const int r = i / W2, q = i % W2;
    win[r * sw + q] = __float2bfloat16_rn(r < rows ? wt[r * W2 + q] : 0.f);
  }
  for (int i = threadIdx.x; i < 16 * sf; i += kThreads) {
    ays[i] = azs[i] = lhs[i] = 0.f;  // rows past W stay zero
  }

  const int dep_tiles = W2 / 8 / kWarps;  // n8 tiles of W^2 per warp
  float jc[3][kMaxDepTiles][4];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int j = 0; j < kMaxDepTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) jc[c][j][e] = 0.f;

  const uint32_t* win32 = reinterpret_cast<const uint32_t*>(win);
  const uint32_t* byzp32 = reinterpret_cast<const uint32_t*>(byzp);
  const uint32_t* byzq32 = reinterpret_cast<const uint32_t*>(byzq);
  const int sw32 = sw / 2, sq32 = sq / 2;

  for (int p0 = 0; p0 < a.p; p0 += kChunk) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = threadIdx.x; i < W * kChunk; i += kThreads) {
      const int b = i / kChunk, j = i % kChunk;
      const long long k = part_index(b, p0 + j, W, a.p, a.batched);
      ays[b * sf + j] = a.ay[k];
      azs[b * sf + j] = a.az[k];
      lhs[b * sf + j] = a.lhs[k];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < W2 * kChunk; i += kThreads) {
      const int q = i / kChunk, j = i % kChunk;
      const __nv_bfloat16 v = __float2bfloat16_rn(
          __fmul_rn(ays[(q / W) * sf + j], azs[(q % W) * sf + j]));
      byzq[q * sq + j] = v;
      byzp[j * sw + q] = v;
    }
    __syncthreads();

    // gather: warp `warp` owns particles 8*warp .. 8*warp + 7 of the chunk
    float racc[2] = {0.f, 0.f};
    for (int grp = 0; grp < 4; ++grp) {
      const int mw = grp < 2 ? rows : W;
      float h0[4] = {0.f, 0.f, 0.f, 0.f};
      for (int mt = 0; mt * 16 < mw; ++mt) {
        float h[4] = {0.f, 0.f, 0.f, 0.f};
        const int ra = (mt * 16 + g) * sw32 + tig;
        const int rb = (warp * 8 + g) * sw32 + tig;
        for (int k = 0; k < W2; k += 16) {
          const int kw = k / 2;
          const uint32_t af[4] = {win32[ra + kw], win32[ra + 8 * sw32 + kw],
                                  win32[ra + kw + 4],
                                  win32[ra + 8 * sw32 + kw + 4]};
          mma_bf16(h, af, byzp32[rb + kw], byzp32[rb + kw + 4]);
        }
        if (mt == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) h0[e] = h[e];
        }
      }
      // r[p] = sum over b < W of ay[b, p] * h[b, p]
      float r[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = warp * 8 + 2 * tig + e;
        r[e] = ays[g * sf + j] * h0[e] + ays[(g + 8) * sf + j] * h0[2 + e];
        r[e] += __shfl_xor_sync(0xffffffffu, r[e], 4);
        r[e] += __shfl_xor_sync(0xffffffffu, r[e], 8);
        r[e] += __shfl_xor_sync(0xffffffffu, r[e], 16);
        racc[e] = grp == 0 ? r[e] : racc[e] + r[e];
      }
    }
    if (g == 0) {
      float* o = a.out + static_cast<long long>(t) * a.p + p0 + warp * 8;
      o[2 * tig] = racc[0];
      o[2 * tig + 1] = racc[1];
    }

    // deposit: jw += lhs . byz^T over the chunk, three components
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      asm volatile("" ::: "memory");
      for (int k = 0; k < kChunk; k += 16) {
        if (a.dep_f32) {
          for (int kk = k; kk < k + 16; ++kk) {
            const float x0 = lhs[g * sf + kk], x1 = lhs[(g + 8) * sf + kk];
#pragma unroll
            for (int j = 0; j < kMaxDepTiles; ++j) {
              if (j >= dep_tiles) break;
              const int q = (warp * dep_tiles + j) * 8 + 2 * tig;
              const float y0 = __bfloat162float(byzq[q * sq + kk]);
              const float y1 = __bfloat162float(byzq[(q + 1) * sq + kk]);
              jc[c][j][0] = fmaf(x0, y0, jc[c][j][0]);
              jc[c][j][1] = fmaf(x0, y1, jc[c][j][1]);
              jc[c][j][2] = fmaf(x1, y0, jc[c][j][2]);
              jc[c][j][3] = fmaf(x1, y1, jc[c][j][3]);
            }
          }
        } else {
          const float* l0 = lhs + g * sf + k + 2 * tig;
          const float* l1 = lhs + (g + 8) * sf + k + 2 * tig;
          const uint32_t af[4] = {pack_bf16(l0[0], l0[1]),
                                  pack_bf16(l1[0], l1[1]),
                                  pack_bf16(l0[8], l0[9]),
                                  pack_bf16(l1[8], l1[9])};
#pragma unroll
          for (int j = 0; j < kMaxDepTiles; ++j) {
            if (j >= dep_tiles) break;
            const int rb =
                ((warp * dep_tiles + j) * 8 + g) * sq32 + k / 2 + tig;
            mma_bf16(jc[c][j], af, byzq32[rb], byzq32[rb + 4]);
          }
        }
      }
    }
  }

  // jw = (jd_0 + jd_1) + jd_2, rows below W
  float* jt = a.jw + static_cast<long long>(t) * W * W2;
#pragma unroll
  for (int j = 0; j < kMaxDepTiles; ++j) {
    if (j >= dep_tiles) break;
    const int q = (warp * dep_tiles + j) * 8 + 2 * tig;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e / 2);
      if (row < W) {
        jt[row * W2 + q + (e % 2)] = (jc[0][j][e] + jc[1][j][e]) + jc[2][j][e];
      }
    }
  }
}

}  // namespace

static size_t widelane_smem(int w) {
  const int w2 = w * w;
  return sizeof(__nv_bfloat16) *
             (32 * (w2 + 8) + kChunk * (w2 + 8) + w2 * (kChunk + 8)) +
         sizeof(float) * 3 * 16 * (kChunk + 4);
}

// Resident blocks per SM (the occupancy calculator) at window width w.
extern "C" int lab_widelane_blocks_per_sm(int w) {
  const size_t smem = widelane_smem(w);
  int n = 0;
  if (cudaFuncSetAttribute(lab_widelane_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, lab_widelane_kernel, kThreads, smem) != cudaSuccess) {
    return -1;
  }
  return n;
}

extern "C" int lab_widelane_launch(const LabWidelaneArgs* args, void* stream) {
  const LabWidelaneArgs& a = *args;
  if (a.nt <= 0) return 0;
  const size_t smem = widelane_smem(a.w);
  cudaError_t e = cudaFuncSetAttribute(
      lab_widelane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  lab_widelane_kernel<<<a.nt, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lab_widelane_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
