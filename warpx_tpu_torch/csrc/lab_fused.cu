// Lab L1: ablations of the fused PIC kernel's body, in the band-matrix
// formulation on the tensor cores.
//
// Replaces tools/kernel_lab.py::run (:250; pallas_call :267 packed, :289)
// with its bodies make_kernel (:58) and make_packed_kernel (:226).  Per tile
// of P particles and six (W, W^2) field windows:
//
//   gather   h = win . byz,  byz = ay (x) az (W^2 rows, `yz_mat` :106),
//            e[p] = sum over rows of ax * h      (six components, :125-137)
//   push     the lab's Boris-like push (:141-160)
//   deposit  sm = nn + no, df = no - nn, cs = doubling scan of df,
//            lhs = cs * w,
//            J_d = (0.25 lhs) . (sm_a (x) sm_b)^T
//                + (lhs / 12) . (df_a (x) df_b)^T
//            contracted over the particles (:162-221)
//
// Modes are runtime arguments (W, 8 or 16, is the only template
// parameter): kind (empty / dots / nomxu), linear bands (novpu), the
// gather's and the deposit's precision ('f32' HIGHEST: FP32 FMA; 'bf16'
// DEFAULT: operands rounded to bfloat16, one mma.sync m16n8k16; '3pass'
// HIGH: hi.hi + lo.hi + hi.lo, three mma.sync), windows staged as
// bfloat16 ('bf16' mode), and the packed layout (pointers and tile strides
// only).
//
// Bound on the card: operations.  At W = 16, P = 2048 a tile moves ~0.25 MB
// (the windows in, the particles in and out, J out) and does ~0.2 GFLOP of
// products (6 gathers of 2 W W^2 P, 3 deposits of 2 x 2 W W^2 P) and ~4
// kFLOP of band builds, push and outer products per particle: over 512
// tiles the products take 0.10 ms at 989 TFLOP/s (bfloat16), the vector
// work 0.07 ms at 67 TFLOP/s (FP32), the bytes 0.04 ms at 3.35 TB/s.
// Design: one block of 8 warps per tile; the six
// windows staged once in shared memory (96 KB float32 at W = 16, half in
// bfloat16, so cudaFuncSetAttribute); the particles in chunks of 64, whose
// six axis bands, push and deposit bands are built in shared memory, with
// the bfloat16 operands formed without FMA contraction before their
// rounding (__fmul_rn and friends: an FMA would move a value by an ulp and
// across a rounding boundary); byz and the outer products are formed in
// registers as the B fragments are loaded, never stored; the gather's
// accumulators are one 16 x 8 mma tile per warp and component, reduced over
// the rows by warp shuffles; the three J windows accumulate over all chunks
// in registers (48 a thread at W = 16) and are written once.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Must match warpx_tpu_torch/tools/kernel_lab.py::_LabFusedArgs.
struct LabFusedArgs {
  const float* win[6];
  long long win_stride;  // elements between tiles
  const float* parts[7];  // x, y, z, ux, uy, uz, w
  long long part_stride;
  float* pout[6];  // x, y, z, ux, uy, uz
  long long pout_stride;
  float* jw[3];
  long long jw_stride;
  int nt, w, p;
  int kind;         // 0 empty, 1 dots, 2 nomxu
  int band_linear;  // novpu
  int gather, deposit;  // 0 'f32', 1 'bf16', 2 '3pass'
  int stage_bf16;
};

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kChunk = 64;
constexpr int kSp = kChunk + 4;  // float stride of the [row][particle] arrays
constexpr int kMaxDepTiles = 4;
constexpr int kEmpty = 0, kDots = 1, kNomxu = 2;
constexpr int kF32 = 0, k3Pass = 2;  // and 1, 'bf16'
constexpr float kQm = static_cast<float>(1.7e11 * 0.5e-12);
// axis-band index (d * 2 + key; key 0: order 0 staggered, 1: order 1) of
// the x, y and z factors of each component (kernel_lab.py:116-123)
__constant__ int kKeys[6][3] = {{0, 1, 1}, {1, 0, 1}, {1, 1, 0},
                                {1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
__constant__ int kPairs[3][2] = {{1, 2}, {0, 2}, {0, 1}};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A pair of operand values as bfloat16 pairs: the high parts, and the
// remainders (the second pass of '3pass').
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack(x0, x1);
  lo = pack(sub(x0, bf(x0)), sub(x1, bf(x1)));
}

// Shared-memory layout, the same in the kernel and the launcher.
struct Layout {
  int win_bytes, am, pc, e6, vel, sm, df, lhs, total_bytes;
  __host__ __device__ Layout(int w, int kind, int stage_bf16) {
    const int w2 = w * w;
    win_bytes = kind == kDots ? 6 * w * (w2 + 8) * (stage_bf16 ? 2 : 4)
              : kind == kNomxu ? 3 * w * w2 * 4 : 0;
    // float offsets after the window region
    am = 0;
    pc = am + 6 * w * kSp;
    e6 = pc + 7 * kChunk;
    vel = e6 + 6 * kChunk;
    sm = vel + 3 * kChunk;
    df = sm + 3 * w * kSp;
    lhs = df + 3 * w * kSp;
    total_bytes = win_bytes + 4 * (lhs + 3 * 16 * kSp);
  }
};

__device__ __forceinline__ float band(float xi, int order, int linear) {
  if (linear) return mul(xi, 0.25f);
  if (order == 0) return (xi >= -0.5f && xi < 0.5f) ? 1.f : 0.f;
  return fmaxf(0.f, sub(1.f, fabsf(xi)));
}

template <int W>
__global__ void __launch_bounds__(kThreads) lab_fused_kernel(LabFusedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x, tid = threadIdx.x;
  constexpr int W2 = W * W, lw = W == 16 ? 4 : 3;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;

  if (a.kind == kEmpty) {  // memory traffic only (kernel_lab.py:74-83)
    for (int i = tid; i < a.p; i += kThreads) {
      for (int d = 0; d < 3; ++d) {
        a.pout[d][t * a.pout_stride + i] =
            mul(a.parts[d][t * a.part_stride + i], 1.0001f);
        a.pout[3 + d][t * a.pout_stride + i] =
            add(a.parts[3 + d][t * a.part_stride + i],
                a.parts[6][t * a.part_stride + i]);
      }
    }
    for (int i = tid; i < W * W2; i += kThreads) {
      for (int d = 0; d < 3; ++d) {
        a.jw[d][t * a.jw_stride + i] = add(a.win[d][t * a.win_stride + i],
                                           a.win[3 + d][t * a.win_stride + i]);
      }
    }
    return;
  }

  const Layout L(W, a.kind, a.stage_bf16);
  float* fs = reinterpret_cast<float*>(smem + L.win_bytes);
  float* am = fs + L.am;    // [6][W][kSp]  axis bands (d*2 + key)
  float* pc = fs + L.pc;    // [7][kChunk]  particle chunk
  float* e6 = fs + L.e6;    // [6][kChunk]  gathered fields
  float* vel = fs + L.vel;  // [3][kChunk]
  float* smv = fs + L.sm;   // [3][W][kSp]
  float* dfv = fs + L.df;   // [3][W][kSp]
  float* lhv = fs + L.lhs;  // [3][16][kSp] cs * w, rows past W zero
  float* winf = reinterpret_cast<float*>(smem);  // [6][W][W2 + 8]
  __nv_bfloat16* winb = reinterpret_cast<__nv_bfloat16*>(smem);
  float* first = reinterpret_cast<float*>(smem);  // nomxu: [3][W][W2]
  constexpr int sw = W2 + 8;

  if (a.kind == kDots) {
    for (int i = tid; i < 6 * W * W2; i += kThreads) {
      const int c = i / (W * W2), r = (i / W2) % W, q = i % W2;
      const float v = a.win[c][t * a.win_stride + r * W2 + q];
      if (a.stage_bf16) {
        winb[(c * W + r) * sw + q] = __float2bfloat16_rn(v);
      } else {
        winf[(c * W + r) * sw + q] = v;
      }
    }
  }
  for (int i = tid; i < 3 * 16 * kSp; i += kThreads) lhv[i] = 0.f;

  constexpr int dep_tiles = W2 / 8 / kWarps;
  float jc[3][kMaxDepTiles][4];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int j = 0; j < kMaxDepTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) jc[d][j][e] = 0.f;
  float rowsum = 0.f;  // nomxu: sum over the particles of lhs[d][row]

  for (int p0 = 0; p0 < a.p; p0 += kChunk) {
    __syncthreads();
    for (int i = tid; i < 7 * kChunk; i += kThreads) {
      const int k = i / kChunk, j = i % kChunk;
      pc[k * kChunk + j] = a.parts[k][t * a.part_stride + p0 + j];
    }
    __syncthreads();
    // the six axis bands of the chunk: band(X - 1/2, 0) and band(X, 1)
    for (int i = tid; i < 6 * kChunk; i += kThreads) {
      const int m = i / kChunk, j = i % kChunk, d = m / 2, key = m % 2;
      const float X = mul(pc[d * kChunk + j], 0.1f);
      const float xc = key == 0 ? sub(X, 0.5f) : X;
#pragma unroll
      for (int r = 0; r < W; ++r) {
        am[(m * W + r) * kSp + j] =
            band(sub(xc, static_cast<float>(r)), key == 0 ? 0 : 1,
                 a.band_linear);
      }
    }
    __syncthreads();

    // ---- gather: e6[c][p] = sum over rows of ax * (win . byz)
    if (a.kind == kNomxu) {
      // h = byz[:W] + win[:, 0]: byz row r is ay[0] * az[r]
      for (int i = tid; i < 6 * kChunk; i += kThreads) {
        const int c = i / kChunk, j = i % kChunk;
        const float* ax = am + kKeys[c][0] * W * kSp;
        const float* ay = am + (2 + kKeys[c][1]) * W * kSp;
        const float* az = am + (4 + kKeys[c][2]) * W * kSp;
        float e = 0.f;
        for (int r = 0; r < W; ++r) {
          const float h = add(mul(ay[j], az[r * kSp + j]),
                              a.win[c][t * a.win_stride + r * W2]);
          e = add(e, mul(ax[r * kSp + j], h));
        }
        e6[c * kChunk + j] = e;
      }
    } else {
      const int j0 = warp * 8;  // the warp's eight particles
      for (int c = 0; c < 6; ++c) {
        const float* ax = am + kKeys[c][0] * W * kSp;
        const float* ay = am + (2 + kKeys[c][1]) * W * kSp;
        const float* az = am + (4 + kKeys[c][2]) * W * kSp;
        float h[4] = {0.f, 0.f, 0.f, 0.f};
        const bool hi_row = g + 8 < W;
        if (a.gather == kF32) {
          const float* w0 = winf + (c * W + g) * sw;
          const float* w1 = winf + (c * W + g + 8) * sw;
          const int pa = j0 + 2 * tig, pb = pa + 1;
          for (int q = 0; q < W2; ++q) {
            const float y0 = mul(ay[(q >> lw) * kSp + pa],
                                 az[(q & (W - 1)) * kSp + pa]);
            const float y1 = mul(ay[(q >> lw) * kSp + pb],
                                 az[(q & (W - 1)) * kSp + pb]);
            const float x0 = w0[q], x1 = hi_row ? w1[q] : 0.f;
            h[0] = fmaf(x0, y0, h[0]);
            h[1] = fmaf(x0, y1, h[1]);
            h[2] = fmaf(x1, y0, h[2]);
            h[3] = fmaf(x1, y1, h[3]);
          }
        } else {
          const int pj = j0 + g;  // the B fragment's particle
          for (int k0 = 0; k0 < W2; k0 += 16) {
            // A: window rows g, g + 8; columns k0 + 2 tig (+1, +8, +9)
            uint32_t ah[4], al[4];
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              const int r = g + 8 * (f & 1), col = k0 + 2 * tig + 8 * (f >> 1);
              if (r >= W) {
                ah[f] = al[f] = 0u;
              } else if (a.stage_bf16) {
                ah[f] = *reinterpret_cast<const uint32_t*>(
                    winb + (c * W + r) * sw + col);
                al[f] = 0u;
              } else {
                const float2 v = *reinterpret_cast<const float2*>(
                    winf + (c * W + r) * sw + col);
                split(v.x, v.y, ah[f], al[f]);
              }
            }
            // B: byz[q][pj] for q = k0 + 2 tig (+1, +8, +9), formed here
            float y[4];
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              const int q = k0 + 2 * tig + (f & 1) + 8 * (f >> 1);
              y[f] = mul(ay[(q >> lw) * kSp + pj],
                         az[(q & (W - 1)) * kSp + pj]);
            }
            uint32_t bh0, bl0, bh1, bl1;
            split(y[0], y[1], bh0, bl0);
            split(y[2], y[3], bh1, bl1);
            mma_bf16(h, ah, bh0, bh1);
            if (a.gather == k3Pass) {
              mma_bf16(h, al, bh0, bh1);
              mma_bf16(h, ah, bl0, bl1);
            }
          }
        }
        // e[p] = sum over rows of ax[row][p] * h[row][p]
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 2 * tig + e;
          float r = mul(ax[g * kSp + j], h[e]);
          if (hi_row) r = add(r, mul(ax[(g + 8) * kSp + j], h[2 + e]));
          r += __shfl_xor_sync(0xffffffffu, r, 4);
          r += __shfl_xor_sync(0xffffffffu, r, 8);
          r += __shfl_xor_sync(0xffffffffu, r, 16);
          if (g == 0) e6[c * kChunk + j] = r;
        }
      }
    }
    __syncthreads();

    // ---- push (kernel_lab.py:141-160), one thread per particle
    if (tid < kChunk) {
      const int j = tid;
      const float ex = e6[j], ey = e6[kChunk + j], ez = e6[2 * kChunk + j];
      const float bx = e6[3 * kChunk + j], by = e6[4 * kChunk + j],
                  bz = e6[5 * kChunk + j];
      float ux = add(pc[3 * kChunk + j], mul(kQm, ex));
      float uy = add(pc[4 * kChunk + j], mul(kQm, ey));
      float uz = add(pc[5 * kChunk + j], mul(kQm, ez));
      const float tx = mul(kQm, bx), ty = mul(kQm, by), tz = mul(kQm, bz);
      const float upx = sub(add(ux, mul(uy, tz)), mul(uz, ty));
      const float upy = sub(add(uy, mul(uz, tx)), mul(ux, tz));
      const float upz = sub(add(uz, mul(ux, ty)), mul(uy, tx));
      const float s = __fdiv_rn(
          2.f, add(add(add(1.f, mul(tx, tx)), mul(ty, ty)), mul(tz, tz)));
      ux = add(add(ux, mul(sub(mul(upy, tz), mul(upz, ty)), s)), mul(kQm, ex));
      uy = add(add(uy, mul(sub(mul(upz, tx), mul(upx, tz)), s)), mul(kQm, ey));
      uz = add(add(uz, mul(sub(mul(upx, ty), mul(upy, tx)), s)), mul(kQm, ez));
      const float u2 = add(add(mul(ux, ux), mul(uy, uy)), mul(uz, uz));
      const float gaminv = __frsqrt_rn(add(1.f, mul(u2, 1e-17f)));
      const float v[3] = {mul(ux, gaminv), mul(uy, gaminv), mul(uz, gaminv)};
      const long long o = t * a.pout_stride + p0 + j;
      for (int d = 0; d < 3; ++d) {
        a.pout[d][o] = add(pc[d * kChunk + j], mul(v[d], 1e-12f));
        vel[d * kChunk + j] = v[d];
      }
      a.pout[3][o] = ux;
      a.pout[4][o] = uy;
      a.pout[5][o] = uz;
    }
    __syncthreads();

    // ---- the deposit's bands: sm, df, cs * w per axis and particle
    for (int i = tid; i < 3 * kChunk; i += kThreads) {
      const int d = i / kChunk, j = i % kChunk;
      const float X = mul(pc[d * kChunk + j], 0.1f);
      const float xn = add(X, mul(vel[d * kChunk + j], 1e-4f));
      const float wq = pc[6 * kChunk + j];
      const float* no = am + (2 * d + 1) * W * kSp;
      float cs[W];
#pragma unroll
      for (int r = 0; r < W; ++r) {
        const float nn = band(sub(xn, static_cast<float>(r)), 1, a.band_linear);
        const float o = no[r * kSp + j];
        smv[(d * W + r) * kSp + j] = add(nn, o);
        cs[r] = sub(o, nn);
        dfv[(d * W + r) * kSp + j] = cs[r];
      }
      // inclusive scan by doubling, in the TPU lab's order of additions
#pragma unroll
      for (int s = 1; s < W; s *= 2) {
#pragma unroll
        for (int r = W - 1; r >= s; --r) cs[r] = add(cs[r], cs[r - s]);
      }
#pragma unroll
      for (int r = 0; r < W; ++r) lhv[(d * 16 + r) * kSp + j] = mul(cs[r], wq);
      if (a.kind == kNomxu && p0 + j < W2) {
        for (int r = 0; r < W; ++r) {
          first[(d * W + r) * W2 + p0 + j] = smv[(d * W + r) * kSp + j];
        }
      }
    }
    __syncthreads();

    // ---- deposit products, accumulated over the chunks
    if (a.kind == kNomxu) {
      if (tid < 3 * W) {
        const int d = tid / W, r = tid % W;
        for (int j = 0; j < kChunk; ++j) {
          rowsum = add(rowsum, lhv[(d * 16 + r) * kSp + j]);
        }
      }
      continue;
    }
    const float c12 = static_cast<float>(1.0 / 12.0);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float* sa = smv + kPairs[d][0] * W * kSp;
      const float* sb = smv + kPairs[d][1] * W * kSp;
      const float* da = dfv + kPairs[d][0] * W * kSp;
      const float* db = dfv + kPairs[d][1] * W * kSp;
      const float* lh = lhv + d * 16 * kSp;
      if (a.deposit == kF32) {
        for (int j = 0; j < kChunk; ++j) {
          const float l0 = lh[g * kSp + j], l1 = lh[(g + 8) * kSp + j];
          const float a0 = mul(0.25f, l0), a1 = mul(0.25f, l1);
          const float b0 = mul(c12, l0), b1 = mul(c12, l1);
#pragma unroll
          for (int jt = 0; jt < kMaxDepTiles; ++jt) {
            if (jt >= dep_tiles) break;
            const int q0 = (warp * dep_tiles + jt) * 8 + 2 * tig;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int q = q0 + e, qa = q >> lw, qb = q & (W - 1);
              const float os = mul(sa[qa * kSp + j], sb[qb * kSp + j]);
              const float od = mul(da[qa * kSp + j], db[qb * kSp + j]);
              jc[d][jt][e] = fmaf(b0, od, fmaf(a0, os, jc[d][jt][e]));
              jc[d][jt][2 + e] = fmaf(b1, od, fmaf(a1, os, jc[d][jt][2 + e]));
            }
          }
        }
        continue;
      }
      for (int k0 = 0; k0 < kChunk; k0 += 16) {
        // A: 0.25 lhs and lhs / 12, rows g, g + 8, particles k0 + 2 tig ...
        uint32_t as_h[4], as_l[4], ad_h[4], ad_l[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float* row = lh + (g + 8 * (f & 1)) * kSp + k0 + 2 * tig +
                             8 * (f >> 1);
          split(mul(0.25f, row[0]), mul(0.25f, row[1]), as_h[f], as_l[f]);
          split(mul(c12, row[0]), mul(c12, row[1]), ad_h[f], ad_l[f]);
        }
#pragma unroll
        for (int jt = 0; jt < kMaxDepTiles; ++jt) {
          if (jt >= dep_tiles) break;
          // B: the outer products at column q, particles k0 + 2 tig ...
          const int q = (warp * dep_tiles + jt) * 8 + g;
          const int qa = q >> lw, qb = q & (W - 1);
          float os[4], od[4];
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int j = k0 + 2 * tig + (f & 1) + 8 * (f >> 1);
            os[f] = mul(sa[qa * kSp + j], sb[qb * kSp + j]);
            od[f] = mul(da[qa * kSp + j], db[qb * kSp + j]);
          }
          uint32_t bsh0, bsl0, bsh1, bsl1, bdh0, bdl0, bdh1, bdl1;
          split(os[0], os[1], bsh0, bsl0);
          split(os[2], os[3], bsh1, bsl1);
          split(od[0], od[1], bdh0, bdl0);
          split(od[2], od[3], bdh1, bdl1);
          mma_bf16(jc[d][jt], as_h, bsh0, bsh1);
          if (a.deposit == k3Pass) {
            mma_bf16(jc[d][jt], as_l, bsh0, bsh1);
            mma_bf16(jc[d][jt], as_h, bsl0, bsl1);
          }
          mma_bf16(jc[d][jt], ad_h, bdh0, bdh1);
          if (a.deposit == k3Pass) {
            mma_bf16(jc[d][jt], ad_l, bdh0, bdh1);
            mma_bf16(jc[d][jt], ad_h, bdl0, bdl1);
          }
        }
      }
    }
  }

  if (a.kind == kNomxu) {
    // J_d[r][q] = sum_p lhs[d][r] + sm_a[0][q] * sm_b[r][q] (:186-189)
    __syncthreads();
    float* rs = lhv;  // [3][W] row sums
    if (tid < 3 * W) rs[tid] = rowsum;
    __syncthreads();
    for (int i = tid; i < 3 * W * W2; i += kThreads) {
      const int d = i / (W * W2), r = (i / W2) % W, q = i % W2;
      const float o = mul(first[(kPairs[d][0] * W) * W2 + q],
                          first[(kPairs[d][1] * W + r) * W2 + q]);
      a.jw[d][t * a.jw_stride + r * W2 + q] = add(rs[d * W + r], o);
    }
    return;
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int jt = 0; jt < kMaxDepTiles; ++jt) {
      if (jt >= dep_tiles) break;
      const int q = (warp * dep_tiles + jt) * 8 + 2 * tig;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e / 2);
        if (r < W) a.jw[d][t * a.jw_stride + r * W2 + q + e % 2] = jc[d][jt][e];
      }
    }
  }
}

}  // namespace

extern "C" int lab_fused_launch(const LabFusedArgs* args, void* stream) {
  const LabFusedArgs& a = *args;
  if (a.nt <= 0) return 0;
  if (a.w != 8 && a.w != 16) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(a.w, a.kind, a.stage_bf16);
  const int smem = a.kind == kEmpty ? 0 : L.total_bytes;
  auto kernel = a.w == 16 ? lab_fused_kernel<16> : lab_fused_kernel<8>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<a.nt, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lab_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
