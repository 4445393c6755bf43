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
// both operands rounded to bfloat16, one mma.sync m16n8k16 per product with a
// float32 accumulator), 2 '3pass' (HIGH: hi = bf16(x), lo = bf16(x - hi),
// three mma.sync per product: hi.hi + hi.lo + lo.hi).
//
// Bound on the card: operations (the operands are read once, and each rep
// redoes the product), at 989 TFLOP/s for the bfloat16 tensor cores (three
// products a term in '3pass') and 67 TFLOP/s for FP32.  Design: each warp
// owns one 16 x 8 output tile and runs its own reps loop over the whole K
// (each rep's product in a fresh accumulator, then added to the sum, as the
// TPU labs add `acc + dot`: one accumulator over all reps drifts, since the
// tensor cores' float32 accumulation truncates, by up to 3e-2 of the sum
// over 16384 reps), so
// the grid splits every batch entry's m x n output into mma tiles (the TPU
// labs' 8 programs would fill 8 of the 132 SMs); a block of `warps` warps
// shares the 16 rows of a, staged once in shared memory in the mode's format
// (float32, or bfloat16 pairs with hi and lo in '3pass'), with a row stride
// padded so the fragment loads hit 32 distinct banks.  Rows past m (M = 8)
// are zeros that the mma computes and nobody reads: wasted work that the lab
// prints beside the useful work.  The mma is `asm volatile` and each rep
// reloads its operands from shared memory after a compiler barrier, so
// nothing is hoisted out of the reps loop.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kModeF32 = 0, kMode3Pass = 2;  // and 1, 'bf16'

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

template <typename In>
__global__ void tile_dot_kernel(const In* __restrict__ a,
                                const In* __restrict__ b,
                                float* __restrict__ out, int m, int k, int n,
                                int layout_nt, int mode, int reps, int mg,
                                int ng) {
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
    int c, kk;
    if (layout_nt) {  // b (n, k): k fastest in memory
      c = i / k;
      kk = i % k;
    } else {  // b (k, n): column fastest in memory
      kk = i / cols;
      c = i % cols;
    }
    const int col = col0 + c;
    float x = 0.f;
    if (col < n) {
      x = to_f(layout_nt ? be[col * k + kk] : be[kk * n + col]);
    }
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

}  // namespace

// Shared memory a block of `warps` warps needs for depth k in `mode`.
extern "C" long long tile_dot_smem(int k, int mode, int warps) {
  const long long rows = 16 + 8LL * warps;
  if (mode == kModeF32) return rows * (k + 4) * 4;
  return rows * (k + 8) * 2 * (mode == kMode3Pass ? 2 : 1);
}

extern "C" int tile_dot_launch(const void* a, const void* b, void* out,
                               int batch, int m, int k, int n, int layout_nt,
                               int in_bf16, int mode, int reps, int warps,
                               void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mg = (m + 15) / 16, ng = (n + 8 * warps - 1) / (8 * warps);
  const unsigned blocks = static_cast<unsigned>(batch) * mg * ng;
  const int smem = static_cast<int>(tile_dot_smem(k, mode, warps));
  cudaError_t e;
  if (in_bf16) {
    e = cudaFuncSetAttribute(tile_dot_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    tile_dot_kernel<__nv_bfloat16><<<blocks, 32 * warps, smem, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), static_cast<float*>(out), m, k,
        n, layout_nt, mode, reps, mg, ng);
  } else {
    e = cudaFuncSetAttribute(tile_dot_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    tile_dot_kernel<float><<<blocks, 32 * warps, smem, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), m, k, n, layout_nt, mode, reps, mg, ng);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tile_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
