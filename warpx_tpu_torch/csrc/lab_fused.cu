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
// Modes are runtime arguments (W, 8 or 16, the chunk, the warps, the
// linear bands of 'novpu' and whether the kernel holds the FP32 paths are
// template parameters): kind (empty / dots / nomxu), linear bands, the
// gather's and the deposit's precision ('f32' HIGHEST: FP32 FMA; 'bf16'
// DEFAULT: operands rounded to bfloat16, one mma.sync m16n8k16; '3pass'
// HIGH: hi.hi + lo.hi + hi.lo, three mma.sync), and the packed layout
// (pointers and tile strides only).  The TPU lab's 'bf16' mode casts the
// windows to bfloat16 before a DEFAULT dot, which rounds them the same way:
// here both stage the windows as bfloat16.
//
// Bound on the card: operations.  At W = 16, P = 2048 a tile moves ~0.25 MB
// (the windows in, the particles in and out, J out) and does ~0.2 GFLOP of
// products (6 gathers of 2 W W^2 P, 3 deposits of 2 x 2 W W^2 P) and ~4
// kFLOP of band builds, push and outer products per particle: over 512
// tiles the products take 0.10 ms at 989 TFLOP/s (bfloat16), the vector
// work 0.07 ms at 67 TFLOP/s (FP32), the bytes 0.04 ms at 3.35 TB/s.  What
// binds in practice is the lane work that feeds the tensor cores: every
// operand value of byz and of the outer products is a product of two band
// values, formed and rounded by a lane.
//
// Design (the second; the first formed each byz and outer-product value
// inside the mma loop, once per instruction that read it, and split the
// float32 windows into bfloat16 again for every chunk):
//  - one block of 16 warps per tile (one block an SM: ~137 KB of shared
//    memory in 'full'); the particles in chunks of 128, the next chunk's
//    loaded by cp.async while this one computes, three block barriers a
//    chunk (the three threads that build a particle's deposit bands each
//    push it, so the push needs no phase of its own);
//  - the windows staged once per tile in the format the mma reads:
//    bfloat16 hi (and lo at HIGH) rows padded to conflict-free ldmatrix;
//    float32 only for a HIGHEST gather;
//  - the particle axis is the mma's M: gather h^T (C x W) = byz^T (C x W^2)
//    . win^T, deposit J^T (W^2 x W) += outer (W^2 x C) . lhs^T; each lane
//    forms its A fragments in registers, so every byz and outer-product
//    value is formed and rounded once a chunk, by the lane that feeds it
//    to the tensor cores (__fmul_rn before the bfloat16 rounding: an FMA
//    would move a value by an ulp and across a rounding boundary); the
//    band values of the gather are computed in registers (az once a chunk
//    and key, ay once a k-step), the deposit's sm and df are staged in
//    shared memory as float32 and lhs as bfloat16 in the mma's format;
//  - the six components share four distinct (y, z) band keys: a warp
//    builds each key's A fragment once and issues it to every component of
//    the key (two warps a particle tile, three components each);
//  - B fragments (windows, lhs) by ldmatrix.  mma.sync, not wgmma: on the
//    H100 mma.sync m16n8k16 and wgmma m64n16k16 with A in registers issue
//    at about the same rate (labs_ab.py's rates), and the A fragments are
//    built per k-step by the lanes, which with the block's barriers hold
//    the time (labs_ab.py's ablations);
//  - the three J windows accumulate over all chunks in registers and are
//    written once (at W = 8 the warps split the chunk's particles and add
//    their sums in warp order through shared memory).

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
};

namespace {

constexpr int kChunk = 128;  // particles a chunk (the launcher's choice)
constexpr int kWarps = 16;   // warps a block
constexpr int kEmpty = 0, kDots = 1, kNomxu = 2;
constexpr int kF32 = 0, k3Pass = 2;  // and 1, 'bf16'
constexpr float kQm = static_cast<float>(1.7e11 * 0.5e-12);
constexpr float kC12 = static_cast<float>(1.0 / 12.0);
// (x, y, z) band keys of each component (0: order 0 staggered, 1: order 1;
// kernel_lab.py:116-123).  The six components use four distinct (y, z)
// keys: (1, 1) for 0, (0, 1) for 1 and 5, (1, 0) for 2 and 4, (0, 0) for 3.
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four (two) 8 x 8 bfloat16 matrices; lane l gives the address of row
// l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
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

template <int LIN>
__device__ __forceinline__ float band(float xi, int order) {
  if (LIN) return mul(xi, 0.25f);
  if (order == 0) return (xi >= -0.5f && xi < 0.5f) ? 1.f : 0.f;
  return fmaxf(0.f, sub(1.f, fabsf(xi)));
}

// The band value of row r at key `key` (0: band(X - 1/2 - r, 0), 1:
// band(X - r, 1)) of the window coordinate X.  Inlined where the key is a
// constant, the selects fold away.
template <int LIN>
__device__ __forceinline__ float key_band(float X, int key, int r) {
  const float xc = key == 0 ? sub(X, 0.5f) : X;
  return band<LIN>(sub(xc, static_cast<float>(r)), key == 0 ? 0 : 1);
}

// A gather warp's three components (slots) in half HALF: half 0 takes the
// (y, z) keys (1, 1) (component 0) and (0, 1) (1 and 5), half 1 the keys
// (1, 0) (2 and 4) and (0, 0) (3).  Its key kk (0, 1) has y key 1 - kk and
// z key 1 - HALF; slot sl belongs to key sl >= 1 + HALF.
template <int HALF>
__device__ constexpr int slot_comp(int sl) {
  return HALF == 0 ? (sl == 0 ? 0 : sl == 1 ? 1 : 5)
                   : (sl == 0 ? 2 : sl == 1 ? 4 : 3);
}
template <int HALF>
__device__ constexpr int slot_kx(int sl) {
  return (sl == 1) != (HALF == 1);
}

// Shared-memory layout (bytes), the same in the kernel and the launcher.
template <int W, int C>
struct Layout {
  static constexpr int W2 = W * W;
  static constexpr int SWB = W2 + 8;  // bfloat16 window row
  static constexpr int SWF = W2 + 4;  // float32 window row
  static constexpr int SF = C + 8;    // sm, df rows (floats)
  static constexpr int SL = C + 8;    // lhs rows (bfloat16)
  static constexpr int SLF = C + 4;   // lhs rows (floats)
  int win, pc, e6, sm, df, lhs, total;
  __host__ __device__ Layout(int kind, int gather, int deposit) {
    int o = 0;
    win = o;
    if (kind == kDots) {
      o += gather == kF32 ? 6 * W * SWF * 4
                          : 6 * W * SWB * 2 * (gather == k3Pass ? 2 : 1);
    } else if (kind == kNomxu) {
      o += 3 * W * W2 * 4;  // the first W^2 particles' sm
    }
    pc = o;
    o += 2 * 7 * C * 4;
    e6 = o;
    o += 6 * C * 4;
    sm = o;
    o += 3 * W * SF * 4;
    df = o;
    o += 3 * W * SF * 4;
    lhs = o;
    o += kind == kDots && deposit != kF32
             ? 3 * 2 * W * SL * 2 * (deposit == k3Pass ? 2 : 1)
             : 3 * W * SLF * 4;
    total = o;
  }
};

// Load chunk p0 of tile t into pc (7 x C floats) by cp.async; zeros past
// P (a multiple of 64).
template <int C>
__device__ __forceinline__ void load_chunk(const LabFusedArgs& a, int t,
                                           int p0, float* pc) {
  for (int i = threadIdx.x; i < 7 * C / 4; i += blockDim.x) {
    const int k = i / (C / 4), j = 4 * (i % (C / 4));
    const bool valid = p0 + j < a.p;
    const float* src =
        a.parts[k] + t * a.part_stride + (valid ? p0 + j : 0);
    cp_async16(pc + k * C + j, src, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The gather of one warp of half HALF: PT particle tiles, in tile i the
// particles pj[i][0], pj[i][1] (rows g, g + 8), and its three components;
// e6[c][p] = sum over rows of ax * h, h^T = byz^T . win^T (FP32 FMA at
// HIGHEST, mma.sync otherwise: the window's B fragments serve every tile).
template <int W, int LIN, int HALF, int PT, bool F32>
__device__ __forceinline__ void gather_warp(
    const float (&Xp)[PT][2], const float (&Yp)[PT][2],
    const float (&Zp)[PT][2], const int (&pj)[PT][2], int gather,
    const float* winf, const __nv_bfloat16* winh, const __nv_bfloat16* winl,
    float* e6, int C, int lane) {
  constexpr int W2 = W * W, NG = W / 8;
  constexpr int SWB = W2 + 8, SWF = W2 + 4;
  const int tig = lane % 4;
  // h[tile][slot][n][e]: particle pj[tile][e >> 1], row 8 n + 2 tig + (e & 1)
  float h[PT][3][NG][4];
#pragma unroll
  for (int pt = 0; pt < PT; ++pt)
#pragma unroll
    for (int sl = 0; sl < 3; ++sl)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[pt][sl][n][e] = 0.f;
  constexpr int kz = 1 - HALF;
  if (F32 && gather == kF32) {
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int ky = 1 - kk;
        // FP32 FMA: h[p][r] += win[r][q] * ay[q / W] az[q % W]
        float az[W][2];
#pragma unroll
        for (int r = 0; r < W; ++r)
#pragma unroll
          for (int i = 0; i < 2; ++i) az[r][i] = key_band<LIN>(Zp[pt][i], kz, r);
        for (int ya = 0; ya < W; ++ya) {
          const float ay0 = key_band<LIN>(Yp[pt][0], ky, ya);
          const float ay1 = key_band<LIN>(Yp[pt][1], ky, ya);
#pragma unroll
          for (int zb = 0; zb < W; ++zb) {
            const int q = ya * W + zb;
            const float y0 = mul(ay0, az[zb][0]), y1 = mul(ay1, az[zb][1]);
#pragma unroll
            for (int sl = 0; sl < 3; ++sl) {
              if ((sl >= 1 + HALF) != (kk == 1)) continue;
              const float* wc = winf + slot_comp<HALF>(sl) * W * SWF + q;
#pragma unroll
              for (int n = 0; n < NG; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float x = wc[(8 * n + 2 * tig + e) * SWF];
                  h[pt][sl][n][e] = fmaf(x, y0, h[pt][sl][n][e]);
                  h[pt][sl][n][2 + e] = fmaf(x, y1, h[pt][sl][n][2 + e]);
                }
            }
          }
        }
      }
  } else {
    // the A fragments of both keys: byz^T rows pj, columns q = 16 s +
    // 2 tig (+1, +8, +9); W = 16: ay row s, az rows 2 tig (+1, +8, +9);
    // W = 8: ay rows 2 s (columns < 8) and 2 s + 1, az rows 2 tig (+1)
    constexpr int NZ = W == 16 ? 4 : 2;
    float az[PT][NZ][2];  // the z key is the half's
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int f = 0; f < NZ; ++f)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          az[pt][f][i] = key_band<LIN>(Zp[pt][i], kz,
                                       2 * tig + (f & 1) + 8 * (f >> 1));
    // B: win^T rows q = 16 s .. 16 s + 15, columns (window rows) r
    const int r = W == 16 ? (lane & 7) + 8 * (lane >> 4) : (lane & 7);
    const int boff = r * SWB + 8 * ((lane >> 3) & 1);
    for (int s = 0; s < W2 / 16; ++s) {
      uint32_t ah[PT][2][4], al[PT][2][4];
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          float y[4][2];  // [fragment register][its two columns]
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if constexpr (W == 16) {
              const float ay = key_band<LIN>(Yp[pt][i], 1 - kk, s);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                y[i][e] = mul(ay, az[pt][e][i]);
                y[2 + i][e] = mul(ay, az[pt][2 + e][i]);
              }
            } else {
              const float ay_lo = key_band<LIN>(Yp[pt][i], 1 - kk, 2 * s);
              const float ay_hi = key_band<LIN>(Yp[pt][i], 1 - kk, 2 * s + 1);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                y[i][e] = mul(ay_lo, az[pt][e][i]);
                y[2 + i][e] = mul(ay_hi, az[pt][e][i]);
              }
            }
          }
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            if (gather == k3Pass) {
              split(y[f][0], y[f][1], ah[pt][kk][f], al[pt][kk][f]);
            } else {
              ah[pt][kk][f] = pack(y[f][0], y[f][1]);
            }
          }
        }
#pragma unroll
      for (int sl = 0; sl < 3; ++sl) {
        const int kk = sl >= 1 + HALF;
        const int off = slot_comp<HALF>(sl) * W * SWB + 16 * s + boff;
        uint32_t bh[4], bl[4];
        if constexpr (W == 16) {
          ldsm_x4(bh, winh + off);
        } else {
          ldsm_x2(bh, winh + off);
        }
#pragma unroll
        for (int pt = 0; pt < PT; ++pt)
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            mma_bf16(h[pt][sl][n], ah[pt][kk], bh[2 * n], bh[2 * n + 1]);
          }
        if (gather == k3Pass) {
          if constexpr (W == 16) {
            ldsm_x4(bl, winl + off);
          } else {
            ldsm_x2(bl, winl + off);
          }
#pragma unroll
          for (int pt = 0; pt < PT; ++pt)
#pragma unroll
            for (int n = 0; n < NG; ++n) {
              mma_bf16(h[pt][sl][n], ah[pt][kk], bl[2 * n], bl[2 * n + 1]);
              mma_bf16(h[pt][sl][n], al[pt][kk], bh[2 * n], bh[2 * n + 1]);
            }
        }
      }
    }
  }
  // e[p] = sum over rows of ax[row][p] * h[p][row]
#pragma unroll
  for (int pt = 0; pt < PT; ++pt)
#pragma unroll
    for (int sl = 0; sl < 3; ++sl) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float r = 0.f;
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ax = key_band<LIN>(Xp[pt][i], slot_kx<HALF>(sl),
                                           8 * n + 2 * tig + e);
            r = add(r, mul(ax, h[pt][sl][n][2 * i + e]));
          }
        r = add(r, __shfl_xor_sync(0xffffffffu, r, 1));
        r = add(r, __shfl_xor_sync(0xffffffffu, r, 2));
        if (tig == 0) e6[slot_comp<HALF>(sl) * C + pj[pt][i]] = r;
      }
    }
}

// F32: the kernel holds the FP32 (HIGHEST) gather and deposit; without
// them the tensor-core modes' registers are their own.
template <int W, int C, int NW, int LIN, bool F32>
__global__ void __launch_bounds__(32 * NW, 1) lab_fused_kernel(LabFusedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int W2 = W * W;
  constexpr int NG = W / 8;              // n tiles of W columns
  using Ly = Layout<W, C>;
  const int t = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;

  if (a.kind == kEmpty) {  // memory traffic only (kernel_lab.py:74-83)
    for (int i = tid; i < a.p; i += blockDim.x) {
      for (int d = 0; d < 3; ++d) {
        a.pout[d][t * a.pout_stride + i] =
            mul(a.parts[d][t * a.part_stride + i], 1.0001f);
        a.pout[3 + d][t * a.pout_stride + i] =
            add(a.parts[3 + d][t * a.part_stride + i],
                a.parts[6][t * a.part_stride + i]);
      }
    }
    for (int i = tid; i < W * W2; i += blockDim.x) {
      for (int d = 0; d < 3; ++d) {
        a.jw[d][t * a.jw_stride + i] = add(a.win[d][t * a.win_stride + i],
                                           a.win[3 + d][t * a.win_stride + i]);
      }
    }
    return;
  }

  const Ly L(a.kind, a.gather, a.deposit);
  float* winf = reinterpret_cast<float*>(smem + L.win);  // [6][W][SWF]
  __nv_bfloat16* winh = reinterpret_cast<__nv_bfloat16*>(smem + L.win);
  __nv_bfloat16* winl = winh + 6 * W * Ly::SWB;     // [6][W][SWB] each
  float* first = reinterpret_cast<float*>(smem + L.win);  // nomxu [3][W][W2]
  float* pcb = reinterpret_cast<float*>(smem + L.pc);     // [2][7][C]
  float* e6 = reinterpret_cast<float*>(smem + L.e6);      // [6][C]
  float* smv = reinterpret_cast<float*>(smem + L.sm);     // [3][W][SF]
  float* dfv = reinterpret_cast<float*>(smem + L.df);     // [3][W][SF]
  // lhs as bfloat16: [3][2 scales][W][SL] hi, then lo; as floats [3][W][SLF]
  __nv_bfloat16* lhh = reinterpret_cast<__nv_bfloat16*>(smem + L.lhs);
  __nv_bfloat16* lhl = lhh + 3 * 2 * W * Ly::SL;
  float* lhf = reinterpret_cast<float*>(smem + L.lhs);
  const bool mma_dep = a.kind == kDots && a.deposit != kF32;

  load_chunk<C>(a, t, 0, pcb);
  if (a.kind == kDots) {
    for (int i = tid; i < 6 * W * W2; i += blockDim.x) {
      const int c = i / (W * W2), r = (i / W2) % W, q = i % W2;
      const float v = a.win[c][t * a.win_stride + r * W2 + q];
      if (a.gather == kF32) {
        winf[(c * W + r) * Ly::SWF + q] = v;
      } else {
        const __nv_bfloat16 h = __float2bfloat16_rn(v);
        winh[(c * W + r) * Ly::SWB + q] = h;
        if (a.gather == k3Pass) {
          winl[(c * W + r) * Ly::SWB + q] =
              __float2bfloat16_rn(sub(v, __bfloat162float(h)));
        }
      }
    }
  }

  // deposit work of this warp: m tiles of 16 J^T rows (q), and the chunk's
  // k-steps k = kgi (mod KG) where there are fewer m tiles than warps
  constexpr int MTILES = W2 / 16;
  constexpr int MT = MTILES >= NW ? MTILES / NW : 1;
  constexpr int KG = MTILES >= NW ? 1 : NW / MTILES;
  const int kgi = warp / (NW / KG), mt0 = (warp % (NW / KG)) * MT;
  float jc[3][MT][NG][4];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) jc[d][m][n][e] = 0.f;
  float rowsum = 0.f;  // nomxu: sum over the particles of lhs[d][row]

  const int nchunks = (a.p + C - 1) / C;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int p0 = ci * C;
    const float* pc = pcb + (ci & 1) * 7 * C;
    if (ci + 1 < nchunks) {
      load_chunk<C>(a, t, p0 + C, pcb + ((ci + 1) & 1) * 7 * C);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    // ---- gather: e6[c][p] = sum over rows of ax * (win . byz)
    if (a.kind == kNomxu) {
      // h = byz[:W] + win[:, 0]: byz row r is ay[0] * az[r]
      for (int i = tid; i < 6 * C; i += blockDim.x) {
        const int c = i / C, j = i % C;
        const float X = mul(pc[j], 0.1f), Y = mul(pc[C + j], 0.1f),
                    Z = mul(pc[2 * C + j], 0.1f);
        const float ay0 = key_band<LIN>(Y, kKeys[c][1], 0);
        float e = 0.f;
        for (int r = 0; r < W; ++r) {
          const float h = add(mul(ay0, key_band<LIN>(Z, kKeys[c][2], r)),
                              a.win[c][t * a.win_stride + r * W2]);
          e = add(e, mul(key_band<LIN>(X, kKeys[c][0], r), h));
        }
        e6[c * C + j] = e;
      }
    } else {
      // warp: PT tiles of 16 particles (16 p + g, + 8), the components of
      // two keys
      constexpr int PT = C / 16 / (NW / 2);
      static_assert(PT >= 1, "a gather warp needs a particle tile");
      const int half = warp / (NW / 2), pt0 = (warp % (NW / 2)) * PT;
      int pj[PT][2];
      float Xp[PT][2], Yp[PT][2], Zp[PT][2];
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pj[pt][i] = 16 * (pt0 + pt) + g + 8 * i;
          Xp[pt][i] = mul(pc[pj[pt][i]], 0.1f);
          Yp[pt][i] = mul(pc[C + pj[pt][i]], 0.1f);
          Zp[pt][i] = mul(pc[2 * C + pj[pt][i]], 0.1f);
        }
      if (half == 0) {
        gather_warp<W, LIN, 0, PT, F32>(Xp, Yp, Zp, pj, a.gather, winf, winh,
                                   winl, e6, C, lane);
      } else {
        gather_warp<W, LIN, 1, PT, F32>(Xp, Yp, Zp, pj, a.gather, winf, winh,
                                   winl, e6, C, lane);
      }
    }
    __syncthreads();

    // ---- push (kernel_lab.py:141-160) and the deposit's bands: a thread
    // per (axis d, particle j) pushes j (three threads push each particle
    // alike), stores its axis's position and momentum, then builds sm, df
    // and cs * w along d
    for (int i = tid; i < 3 * C; i += blockDim.x) {
      const int d = i / C, j = i % C;
      const float ex = e6[j], ey = e6[C + j], ez = e6[2 * C + j];
      const float bx = e6[3 * C + j], by = e6[4 * C + j], bz = e6[5 * C + j];
      float ux = add(pc[3 * C + j], mul(kQm, ex));
      float uy = add(pc[4 * C + j], mul(kQm, ey));
      float uz = add(pc[5 * C + j], mul(kQm, ez));
      const float tx = mul(kQm, bx), ty = mul(kQm, by), tz = mul(kQm, bz);
      const float upx = sub(add(ux, mul(uy, tz)), mul(uz, ty));
      const float upy = sub(add(uy, mul(uz, tx)), mul(ux, tz));
      const float upz = sub(add(uz, mul(ux, ty)), mul(uy, tx));
      const float sr = __fdiv_rn(
          2.f, add(add(add(1.f, mul(tx, tx)), mul(ty, ty)), mul(tz, tz)));
      ux = add(add(ux, mul(sub(mul(upy, tz), mul(upz, ty)), sr)), mul(kQm, ex));
      uy = add(add(uy, mul(sub(mul(upz, tx), mul(upx, tz)), sr)), mul(kQm, ey));
      uz = add(add(uz, mul(sub(mul(upx, ty), mul(upy, tx)), sr)), mul(kQm, ez));
      const float u2 = add(add(mul(ux, ux), mul(uy, uy)), mul(uz, uz));
      const float gaminv = __frsqrt_rn(add(1.f, mul(u2, 1e-17f)));
      const float ud = d == 0 ? ux : d == 1 ? uy : uz;
      const float v = mul(ud, gaminv);
      if (p0 + j < a.p) {
        const long long o = t * a.pout_stride + p0 + j;
        a.pout[d][o] = add(pc[d * C + j], mul(v, 1e-12f));
        a.pout[3 + d][o] = ud;
      }
      const float X = mul(pc[d * C + j], 0.1f);
      const float xn = add(X, mul(v, 1e-4f));
      const float wq = pc[6 * C + j];
      float cs[W];
#pragma unroll
      for (int r = 0; r < W; ++r) {
        const float nn = band<LIN>(sub(xn, static_cast<float>(r)), 1);
        const float o = key_band<LIN>(X, 1, r);
        smv[(d * W + r) * Ly::SF + j] = add(nn, o);
        cs[r] = sub(o, nn);
        dfv[(d * W + r) * Ly::SF + j] = cs[r];
      }
      // inclusive scan by doubling, in the TPU lab's order of additions
#pragma unroll
      for (int s = 1; s < W; s *= 2) {
#pragma unroll
        for (int r = W - 1; r >= s; --r) cs[r] = add(cs[r], cs[r - s]);
      }
#pragma unroll
      for (int r = 0; r < W; ++r) {
        const float l = mul(cs[r], wq);
        if (mma_dep) {
          const float vs[2] = {mul(0.25f, l), mul(kC12, l)};
#pragma unroll
          for (int sc = 0; sc < 2; ++sc) {
            const int at = ((d * 2 + sc) * W + r) * Ly::SL + j;
            const __nv_bfloat16 hv = __float2bfloat16_rn(vs[sc]);
            lhh[at] = hv;
            if (a.deposit == k3Pass) {
              lhl[at] = __float2bfloat16_rn(sub(vs[sc], __bfloat162float(hv)));
            }
          }
        } else {
          lhf[(d * W + r) * Ly::SLF + j] = l;
        }
      }
      if (a.kind == kNomxu && p0 + j < W2) {
        for (int r = 0; r < W; ++r) {
          first[(d * W + r) * W2 + p0 + j] = smv[(d * W + r) * Ly::SF + j];
        }
      }
    }
    __syncthreads();

    // ---- deposit products, accumulated over the chunks
    if (a.kind == kNomxu) {
      if (tid < 3 * W) {
        const int d = tid / W, r = tid % W;
        for (int j = 0; j < C; ++j) {
          rowsum = add(rowsum, lhf[(d * W + r) * Ly::SLF + j]);
        }
      }
      continue;
    }
    for (int ks = kgi; ks < C / 16; ks += KG) {
      const int k0 = 16 * ks;
      if (F32 && !mma_dep) {
        // FP32 FMA on the same fragments' positions
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float* sa = smv + kPairs[d][0] * W * Ly::SF;
          const float* sb = smv + kPairs[d][1] * W * Ly::SF;
          const float* da = dfv + kPairs[d][0] * W * Ly::SF;
          const float* db = dfv + kPairs[d][1] * W * Ly::SF;
          for (int j = k0; j < k0 + 16; ++j) {
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              float os[2], od[2];
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2) {
                const int q = 16 * (mt0 + m) + g + 8 * h2;
                os[h2] = mul(sa[(q / W) * Ly::SF + j], sb[(q % W) * Ly::SF + j]);
                od[h2] = mul(da[(q / W) * Ly::SF + j], db[(q % W) * Ly::SF + j]);
              }
#pragma unroll
              for (int n = 0; n < NG; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float l = lhf[(d * W + 8 * n + 2 * tig + e) * Ly::SLF + j];
                  const float a0 = mul(0.25f, l), b0 = mul(kC12, l);
#pragma unroll
                  for (int h2 = 0; h2 < 2; ++h2) {
                    float& acc = jc[d][m][n][2 * h2 + e];
                    acc = fmaf(b0, od[h2], fmaf(a0, os[h2], acc));
                  }
                }
            }
          }
        }
        continue;
      }
      // the operand values of this k-step, each row loaded once: the first
      // factor's rows qa of the warp's J^T rows and the second factor's
      // rows qb, particles k0 + 2 tig (+1) and + 8 (+1), sm and df (J^T row
      // 16 (mt0 + m) + g + 8 h has qa = its row / W and qb = its row % W).
      // Component d's factors are axes (1, 2), (0, 2), (0, 1): taken in
      // the order d = 1, 0, 2, at most three axes' values are live.
      using Rows = float2[2][MT][2][2];  // [sm, df][m][h][+0, +8]
      auto load_rows = [&](int x, bool first_factor, Rows& v) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int q = 16 * (mt0 + m) + g + 8 * h2;
              // rows g and g + 8 share qa at W = 16 and qb at W = 8; the m
              // tiles share qb at W = 16
              const bool same = first_factor ? W == 16 : W == 8;
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                if (same && h2 == 1) {
                  v[u][m][1][jj] = v[u][m][0][jj];
                } else if (!first_factor && W == 16 && m > 0) {
                  v[u][m][h2][jj] = v[u][0][h2][jj];
                } else {
                  const int row = first_factor ? q / W : q % W;
                  v[u][m][h2][jj] = *reinterpret_cast<const float2*>(
                      (u == 0 ? smv : dfv) + (x * W + row) * Ly::SF + k0 +
                      2 * tig + 8 * jj);
                }
              }
            }
      };
      const int r = W == 16 ? (lane & 7) + 8 * (lane >> 4) : (lane & 7);
      const int pb = k0 + 8 * ((lane >> 3) & 1);
      auto products = [&](int d, const Rows& fa, const Rows& fb) {
        // B: lhs^T rows (particles) k0 .. k0 + 15, columns r, per scale
        uint32_t bs[2][4], bl[2][4];
#pragma unroll
        for (int sc = 0; sc < 2; ++sc) {
          const int at = ((d * 2 + sc) * W + r) * Ly::SL + pb;
          if constexpr (W == 16) {
            ldsm_x4(bs[sc], lhh + at);
            if (a.deposit == k3Pass) ldsm_x4(bl[sc], lhl + at);
          } else {
            ldsm_x2(bs[sc], lhh + at);
            if (a.deposit == k3Pass) ldsm_x2(bl[sc], lhl + at);
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          // A: outer^T rows q = 16 (mt0 + m) + g (+8), columns (particles)
          // k0 + 2 tig (+1, +8, +9)
          uint32_t ash[4], asl[4], adh[4], adl[4];
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int h2 = f & 1, jj = f >> 1;
            const float2 xs = fa[0][m][h2][jj], ys = fb[0][m][h2][jj];
            const float2 xd = fa[1][m][h2][jj], yd = fb[1][m][h2][jj];
            const float os0 = mul(xs.x, ys.x), os1 = mul(xs.y, ys.y);
            const float od0 = mul(xd.x, yd.x), od1 = mul(xd.y, yd.y);
            if (a.deposit == k3Pass) {
              split(os0, os1, ash[f], asl[f]);
              split(od0, od1, adh[f], adl[f]);
            } else {
              ash[f] = pack(os0, os1);
              adh[f] = pack(od0, od1);
            }
          }
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            float(&acc)[4] = jc[d][m][n];
            mma_bf16(acc, ash, bs[0][2 * n], bs[0][2 * n + 1]);
            mma_bf16(acc, adh, bs[1][2 * n], bs[1][2 * n + 1]);
            if (a.deposit == k3Pass) {
              mma_bf16(acc, ash, bl[0][2 * n], bl[0][2 * n + 1]);
              mma_bf16(acc, asl, bs[0][2 * n], bs[0][2 * n + 1]);
              mma_bf16(acc, adh, bl[1][2 * n], bl[1][2 * n + 1]);
              mma_bf16(acc, adl, bs[1][2 * n], bs[1][2 * n + 1]);
            }
          }
        }
      };
      Rows a0, b2;
      load_rows(0, true, a0);
      load_rows(2, false, b2);
      products(1, a0, b2);
      {
        Rows a1;
        load_rows(1, true, a1);
        products(0, a1, b2);
      }
      {
        Rows b1;
        load_rows(1, false, b1);
        products(2, a0, b1);
      }
    }
  }

  if (a.kind == kNomxu) {
    // J_d[r][q] = sum_p lhs[d][r] + sm_a[0][q] * sm_b[r][q] (:186-189)
    __syncthreads();
    float* rs = lhf;  // [3][W] row sums
    if (tid < 3 * W) rs[tid] = rowsum;
    __syncthreads();
    for (int i = tid; i < 3 * W * W2; i += blockDim.x) {
      const int d = i / (W * W2), r = (i / W2) % W, q = i % W2;
      const float o = mul(first[(kPairs[d][0] * W) * W2 + q],
                          first[(kPairs[d][1] * W + r) * W2 + q]);
      a.jw[d][t * a.jw_stride + r * W2 + q] = add(rs[d * W + r], o);
    }
    return;
  }
  // jc[d][m][n][e]: J^T row q = 16 (mt0 + m) + g + 8 (e >> 1), column
  // r = 8 n + 2 tig + (e & 1)
  if constexpr (KG > 1) {
    // the k groups' sums, added in group order through shared memory
    __syncthreads();
    float* red = smv;  // [KG][3][W][W2]
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = 16 * (mt0 + m) + g + 8 * (e >> 1);
            const int r = 8 * n + 2 * tig + (e & 1);
            red[((kgi * 3 + d) * W + r) * W2 + q] = jc[d][m][n][e];
          }
    __syncthreads();
    for (int i = tid; i < 3 * W * W2; i += blockDim.x) {
      float s = red[i];
      for (int k = 1; k < KG; ++k) s = add(s, red[k * 3 * W * W2 + i]);
      const int d = i / (W * W2), rq = i % (W * W2);
      a.jw[d][t * a.jw_stride + rq] = s;
    }
    return;
  } else {
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = 16 * (mt0 + m) + g + 8 * (e >> 1);
            const int r = 8 * n + 2 * tig + (e & 1);
            a.jw[d][t * a.jw_stride + r * W2 + q] = jc[d][m][n][e];
          }
  }
}

template <int W, int LIN>
auto kernel_of(int gather, int deposit) {
  return gather == kF32 || deposit == kF32
             ? lab_fused_kernel<W, kChunk, kWarps, LIN, true>
             : lab_fused_kernel<W, kChunk, kWarps, LIN, false>;
}

template <int W>
auto kernel_of(const LabFusedArgs& a) {
  return a.band_linear ? kernel_of<W, 1>(a.gather, a.deposit)
                       : kernel_of<W, 0>(a.gather, a.deposit);
}

template <int W>
cudaError_t launch(const LabFusedArgs& a, cudaStream_t st) {
  const int smem =
      a.kind == kEmpty ? 0 : Layout<W, kChunk>(a.kind, a.gather, a.deposit).total;
  auto kernel = kernel_of<W>(a);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<a.nt, 32 * kWarps, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lab_fused_launch(const LabFusedArgs* args, void* stream) {
  const LabFusedArgs& a = *args;
  if (a.nt <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.w == 16) return static_cast<int>(launch<16>(a, st));
  if (a.w == 8) return static_cast<int>(launch<8>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The chunk (particles) and the shared memory (bytes) of a launch.
extern "C" int lab_fused_chunk() { return kChunk; }

extern "C" int lab_fused_smem(int w, int kind, int gather, int deposit) {
  if (kind == kEmpty) return 0;
  if (w == 16) return Layout<16, kChunk>(kind, gather, deposit).total;
  if (w == 8) return Layout<8, kChunk>(kind, gather, deposit).total;
  return -1;
}

// Resident blocks per SM (the occupancy calculator) of a launch (bands
// other than 'novpu''s).
extern "C" int lab_fused_blocks_per_sm(int w, int kind, int gather,
                                       int deposit) {
  const int smem = lab_fused_smem(w, kind, gather, deposit);
  auto kernel = w == 16 ? kernel_of<16, 0>(gather, deposit)
                        : kernel_of<8, 0>(gather, deposit);
  int n = 0;
  if (smem < 0 ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32 * kWarps,
                                                    smem) != cudaSuccess) {
    return -1;
  }
  return n;
}

extern "C" const char* lab_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
