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
// Bound on the card: operations, 2*(2+2+1+1)*W*W^2 + 3*2*W*W^2 flops per
// particle and tile on the tensor cores (bfloat16, 989 TFLOP/s) or, for the
// 'f32' deposit, 3*2*W*W^2 of them on FP32 (67 TFLOP/s); the inputs are
// small and shared by every tile.
//
// The first design (mma.sync m16n8k16) loaded every fragment lane by lane
// for each 2048-MAC product, reloaded the window's fragments in all eight
// warps every chunk, built byz twice a chunk in shared memory (its
// particle-major copy with a 4-way bank conflict) and took three barriers a
// chunk: 7.5 % of the bound ('f32': scalar FMA at four shared loads to four
// FMA, 17 %).
//
// This design: one warpgroup a tile, wgmma with A in registers.
//   - byz never touches shared memory: each lane forms the bfloat16 values
//     of its own A fragment (__fmul_rn, then one rounding), so a value is
//     formed by the lane that feeds it to the tensor cores, twice a chunk
//     in all (once per product's layout).
//   - Gather: h_g^T (64 particles x mW) = byz^T . win^T, the particles as
//     wgmma's M.  The window (2W x W^2) is staged once a tile as bfloat16 in
//     the K-major core-matrix layout and read by descriptor (N = 2W or W);
//     one A fragment serves the four groups' products of a k16 step.  A
//     lane's A columns are fixed c bands, so its az values stay in registers
//     and a step loads one ay value per particle row.  The row sum over
//     b < W is a reduction over the accumulator's quad of lanes.
//   - Deposit 'bf16': jw^T (W^2 x W) += byz (q x p) . lhs^T, W^2 / 64 m64
//     tiles of W^2, N = W, K the chunk's particles; lhs staged once a chunk
//     as bfloat16 (the B operand); one A fragment serves the three
//     components.  The accumulators stay in registers over all chunks.
//   - Deposit 'f32': FP32 FMA on register micro-tiles of 4 q x 8 b per
//     component a lane, four particles a step from LDS.128 (byz formed and
//     rounded in registers): 384 FMA to 13 loads.
//   - The particles go by in chunks of 64, loaded a chunk ahead by cp.async
//     into a second buffer; two barriers a chunk (the chunk has landed; the
//     deposit's bfloat16 lhs is staged).
// Every product lab_flops counts is issued (rows W..2W of groups 0-1 are
// computed and not used, as in the lab; the three deposit components are
// computed apart).  The layout of the particle axis changes only the input
// addresses.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

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

constexpr int kThreads = 128;  // one warpgroup a tile
constexpr int kChunk = 64;     // particles a chunk: the gather's M
// float stride of a staged row: 16-byte aligned for cp.async, and the
// deposit's float2 loads of 8 rows x 4 lanes hit 32 distinct banks a half
constexpr int kSf = kChunk + 8;

using wgmma::core_off;

__device__ __forceinline__ long long part_index(int b, int p, int w, int np,
                                                int batched) {
  return batched ? static_cast<long long>(p / 128) * w * 128 + b * 128 + p % 128
                 : static_cast<long long>(b) * np + p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Start the copy of chunk p0's rows of ay, az and lhs (W x 64 floats each,
// contiguous in either layout) into buf[3][W][kSf].
template <int W>
__device__ __forceinline__ void load_chunk(const LabWidelaneArgs& a, int p0,
                                           float* buf) {
  for (int i = threadIdx.x; i < 3 * W * 16; i += kThreads) {
    const int arr = i / (W * 16), r = (i / 16) % W, piece = i % 16;
    const float* src = arr == 0 ? a.ay : arr == 1 ? a.az : a.lhs;
    cp_async16(buf + (arr * W + r) * kSf + 4 * piece,
               src + part_index(r, p0 + 4 * piece, W, a.p, a.batched));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int W>
constexpr int smem_bytes() {
  return 2 * (2 * W * W * W + W * kChunk) + 4 * 2 * 3 * W * kSf;
}

template <int W, bool DEP_F32>
__global__ void __launch_bounds__(kThreads, 2)
lab_widelane_kernel(LabWidelaneArgs a) {
  constexpr int W2 = W * W, RW = 2 * W;
  constexpr int KS = W2 / 16;  // the gather's k16 steps
  constexpr int MT = W2 / 64;  // the deposit's m64 tiles of W^2
  constexpr int BUF = 3 * W * kSf;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem);  // RW x W2
  __nv_bfloat16* lb = win + RW * W2;                              // W x 64
  float* bufs = reinterpret_cast<float*>(lb + W * kChunk);        // 2 x BUF
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int tile = blockIdx.x, nch = a.p / kChunk;

  load_chunk<W>(a, 0, bufs);
  // the tile's window as bfloat16 in the core-matrix layout of 2W rows
  const float* wt = a.win + static_cast<long long>(tile) * RW * W2;
  for (int i = tid; i < RW * W2; i += kThreads) {
    win[core_off(i / W2, i % W2, RW)] = __float2bfloat16_rn(wt[i]);
  }
  // the generic proxy's stores, visible to the tensor cores' async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // the deposit's sums over all chunks: [component][m tile][D fragment]
  // ('bf16'), [component][4 q x 8 b] ('f32')
  float jc[3][DEP_F32 ? 1 : MT][DEP_F32 ? 1 : W / 2];
  float jf[3][DEP_F32 ? 32 : 1];
#pragma unroll
  for (int c3 = 0; c3 < 3; ++c3) {
#pragma unroll
    for (int i = 0; i < (DEP_F32 ? 1 : MT); ++i)
#pragma unroll
      for (int j = 0; j < (DEP_F32 ? 1 : W / 2); ++j) jc[c3][i][j] = 0.f;
#pragma unroll
    for (int i = 0; i < (DEP_F32 ? 32 : 1); ++i) jf[c3][i] = 0.f;
  }
  const uint64_t dwin = wgmma::desc(win, RW / 8 * 128, 128);
  const uint64_t swin = 2 * (RW / 8 * 128) >> 4;  // a k16 step
  const uint64_t dlb = wgmma::desc(lb, W / 8 * 128, 128);
  const uint64_t slb = 2 * (W / 8 * 128) >> 4;
  const int p0 = 16 * warp + g, p1 = p0 + 8;  // the gather's A rows

  for (int ci = 0; ci < nch; ++ci) {
    // chunk ci has landed for every thread, and chunk ci - 1 is done
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (ci + 1 < nch) {
      load_chunk<W>(a, (ci + 1) * kChunk, bufs + ((ci + 1) & 1) * BUF);
    }
    const float* ays = bufs + (ci & 1) * BUF;
    const float* azs = ays + W * kSf;
    const float* lhs = azs + W * kSf;
    if constexpr (!DEP_F32) {
      for (int i = tid; i < W * kChunk; i += kThreads) {
        const int b = i / kChunk, j = i % kChunk;
        lb[core_off(b, j, W)] = __float2bfloat16_rn(lhs[b * kSf + j]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }

    // ---- gather: A row p (a particle), columns q = 16 s + 2 t + 8 e (+1)
    // of step s, i.e. b = (16 s + 8 e) / W and the fixed c = (2 t + 8 e) % W
    float z[2][2][2];  // az[c (+1)] at [e][particle p0, p1]
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = (2 * t + 8 * e) % W;
      z[e][0][0] = azs[c * kSf + p0];
      z[e][0][1] = azs[(c + 1) * kSf + p0];
      z[e][1][0] = azs[c * kSf + p1];
      z[e][1][1] = azs[(c + 1) * kSf + p1];
    }
    // two k16 steps a group of eight products, the next group's fragments
    // formed while this one runs
    float h0[W], h1[W], h2[W / 2], h3[W / 2];
    uint32_t fg[2][2][4];
#pragma unroll
    for (int s2 = 0; s2 < KS; s2 += 2) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = s2 + u;
        uint32_t(&f)[4] = fg[(s2 / 2) & 1][u];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b = (16 * s + 8 * e) / W;
          const float y0 = ays[b * kSf + p0], y1 = ays[b * kSf + p1];
          f[2 * e] = wgmma::pack_bf16(__fmul_rn(y0, z[e][0][0]),
                                      __fmul_rn(y0, z[e][0][1]));
          f[2 * e + 1] = wgmma::pack_bf16(__fmul_rn(y1, z[e][1][0]),
                                          __fmul_rn(y1, z[e][1][1]));
        }
      }
      wgmma::fence();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = s2 + u;
        const uint32_t(&f)[4] = fg[(s2 / 2) & 1][u];
        const uint64_t db = dwin + s * swin;
        wgmma::RS<RW>::mma(h0, f, db, s != 0);
        wgmma::RS<RW>::mma(h1, f, db, s != 0);
        wgmma::RS<W>::mma(h2, f, db, s != 0);
        wgmma::RS<W>::mma(h3, f, db, s != 0);
      }
      wgmma::commit();
      wgmma::wait<1>();
    }
    wgmma::wait<0>();
    wgmma::fence_regs(h0);
    wgmma::fence_regs(h1);
    wgmma::fence_regs(h2);
    wgmma::fence_regs(h3);
    // r[p] = sum over b < W of ay[b, p] h[p, b]: the lane's columns b =
    // 8 j + 2 t + e, then its quad's
    float racc[2];
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const int p = pp ? p1 : p0;
      float ya[W / 4];
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ya[2 * j + e] = ays[(8 * j + 2 * t + e) * kSf + p];
        }
      float r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y = ya[2 * j + e];
          const int i = 4 * j + 2 * pp + e;
          r[0] = fmaf(y, h0[i], r[0]);
          r[1] = fmaf(y, h1[i], r[1]);
          r[2] = fmaf(y, h2[i], r[2]);
          r[3] = fmaf(y, h3[i], r[3]);
        }
#pragma unroll
      for (int gr = 0; gr < 4; ++gr) {
        r[gr] += __shfl_xor_sync(0xffffffffu, r[gr], 1);
        r[gr] += __shfl_xor_sync(0xffffffffu, r[gr], 2);
      }
      racc[pp] = ((r[0] + r[1]) + r[2]) + r[3];
    }
    if (t == 0) {
      float* o = a.out + static_cast<long long>(tile) * a.p + ci * kChunk;
      o[p0] = racc[0];
      o[p1] = racc[1];
    }

    // ---- deposit over the chunk's particles
    if constexpr (!DEP_F32) {
      __syncthreads();  // lb staged by every thread
      // A row q = 64 mt + 16 warp + g + 8 h: b = (64 mt + 16 warp + 8 h) /
      // W, c = (16 warp + g + 8 h) % W; columns p = 16 ks + 2 t + 8 e (+1)
      // one group a k16 step: the MT m tiles' fragments, 3 MT products
      uint32_t fd[2][MT][4];
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        const int pc = 16 * ks + 2 * t;
        float2 zz[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = (16 * warp + g + 8 * h) % W;
            zz[h][e] = *reinterpret_cast<const float2*>(azs + c * kSf + pc +
                                                        8 * e);
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t(&f)[4] = fd[ks & 1][mt];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int b = (64 * mt + 16 * warp + 8 * h) / W;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float2 y =
                  *reinterpret_cast<const float2*>(ays + b * kSf + pc + 8 * e);
              f[2 * e + h] = wgmma::pack_bf16(__fmul_rn(y.x, zz[h][e].x),
                                              __fmul_rn(y.y, zz[h][e].y));
            }
          }
        }
        wgmma::fence();
        const uint64_t db = dlb + ks * slb;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          wgmma::RS<W>::mma(jc[0][mt], fd[ks & 1][mt], db, 1);
          wgmma::RS<W>::mma(jc[1][mt], fd[ks & 1][mt], db, 1);
          wgmma::RS<W>::mma(jc[2][mt], fd[ks & 1][mt], db, 1);
        }
        wgmma::commit();
        wgmma::wait<1>();
      }
      wgmma::wait<0>();
    } else {
      // lane (qg, bg): q = 4 qg .. + 3 (one b row of byz, c = c0 .. + 3),
      // lhs rows 8 bg .. + 7
      const int qg = tid % (W2 / 4), bg = tid / (W2 / 4);
      if (bg < W / 8) {
        const int q0 = 4 * qg, bq = q0 / W, c0 = q0 % W, b0 = 8 * bg;
        // the components' sums pass an opaque asm: three distinct sums
#pragma unroll
        for (int c3 = 0; c3 < 3; ++c3) wgmma::fence_regs(jf[c3]);
#pragma unroll 1
        for (int j = 0; j < kChunk; j += 4) {
          const float4 y = *reinterpret_cast<const float4*>(ays + bq * kSf + j);
          float4 zv[4], lv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            zv[i] = *reinterpret_cast<const float4*>(azs + (c0 + i) * kSf + j);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            lv[i] = *reinterpret_cast<const float4*>(lhs + (b0 + i) * kSf + j);
          }
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) {
            float yz[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              yz[i] = round_bf16(__fmul_rn(lane_of(y, pp), lane_of(zv[i], pp)));
            }
            // the components innermost: three FMA in a row share both
            // factors
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                for (int c3 = 0; c3 < 3; ++c3) {
                  jf[c3][8 * i + jj] =
                      fmaf(yz[i], lane_of(lv[jj], pp), jf[c3][8 * i + jj]);
                }
          }
        }
      }
    }
  }

  // jw = (jd_0 + jd_1) + jd_2
  float* jt = a.jw + static_cast<long long>(tile) * W * W2;
  if constexpr (!DEP_F32) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int q = 64 * mt + 16 * warp + g + 8 * (h >> 1);
          const int b = 8 * j + 2 * t + (h & 1);
          const int i = 4 * j + h;
          jt[b * W2 + q] = (jc[0][mt][i] + jc[1][mt][i]) + jc[2][mt][i];
        }
  } else {
    const int qg = tid % (W2 / 4), bg = tid / (W2 / 4);
    if (bg < W / 8) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int x = 8 * i + jj;
          v[i] = (jf[0][x] + jf[1][x]) + jf[2][x];
        }
        *reinterpret_cast<float4*>(jt + (8 * bg + jj) * W2 + 4 * qg) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

template <int W, bool F>
int blocks_per_sm() {
  int n = 0;
  const auto k = lab_widelane_kernel<W, F>;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes<W>()) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kThreads,
                                                    smem_bytes<W>()) !=
          cudaSuccess) {
    return -1;
  }
  return n;
}

template <int W, bool F>
cudaError_t launch(const LabWidelaneArgs& a, cudaStream_t st) {
  const auto k = lab_widelane_kernel<W, F>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<W>());
  if (e != cudaSuccess) return e;
  k<<<a.nt, kThreads, smem_bytes<W>(), st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Resident blocks per SM (the occupancy calculator) at window width w and
// deposit 'f32' (dep_f32 = 1) or 'bf16'.
extern "C" int lab_widelane_blocks_per_sm(int w, int dep_f32) {
  if (w == 16) return dep_f32 ? blocks_per_sm<16, true>()
                              : blocks_per_sm<16, false>();
  if (w == 8) return dep_f32 ? blocks_per_sm<8, true>()
                             : blocks_per_sm<8, false>();
  return -1;
}

extern "C" int lab_widelane_launch(const LabWidelaneArgs* args, void* stream) {
  const LabWidelaneArgs& a = *args;
  if (a.nt <= 0) return 0;
  if ((a.w != 8 && a.w != 16) || a.p <= 0 || a.p % kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (a.w == 16) {
    e = a.dep_f32 ? launch<16, true>(a, st) : launch<16, false>(a, st);
  } else {
    e = a.dep_f32 ? launch<8, true>(a, st) : launch<8, false>(a, st);
  }
  return static_cast<int>(e);
}

extern "C" const char* lab_widelane_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
