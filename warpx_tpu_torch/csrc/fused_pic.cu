// Kernel K1: fused field gather + momentum push + Esirkepov current deposit
// over the tile-binned particle layout (3D; periodic, or anchored tiles under
// a moving window).
//
// Replaces warpx_tpu/ops/pallas_pic.py::binned_push_deposit -> _build_kernel
// (the Pallas TPU kernel).  That kernel turns every per-particle shape weight
// into a dense (W, p_max) band matrix so the gather and the deposit become
// MXU contractions over the tile window.  Here the same arithmetic is done
// by per-particle index arithmetic on the stencils, as the reference's
// shared-memory binned deposition does (WarpXParticleContainer.cpp:490-548;
// CurrentDeposition.H:643-900).
//
// Bound on the card: bytes.  Per slot the kernel must read 7 particle values
// and write 6, and per tile it writes three W^3 current windows; at order 1
// the arithmetic of an alive slot is a few hundred operations, under the
// float32 rate's share of those bytes.  The first design ran at 8-11 % of
// that bound: every particle computed 18 gather weight sets from a runtime
// table and tested every one of 48 taps against it and the window, the
// fields were read tap by tap through the read-only cache, and the deposit
// visited 192 points a particle by shared-memory compare-and-swap loops.
// Design:
//   * one block per tile; its threads stride over the slots, neighbouring
//     threads on neighbouring slots, so particle reads and writes coalesce;
//   * a tile with no alive particle in any species stages nothing: it
//     writes zero current windows and copies its columns through;
//   * two phases over the species of the launch: phase 1 gathers and
//     pushes every slot from the six staged field boxes and writes the new
//     columns; phase 2 reads each slot's old position and new momentum
//     back, forms the same x_new bit for bit (pushed_gaminv), counts
//     violations and deposits.  The registers of one phase are not live in
//     the other;
//   * every slot of an occupied tile is pushed in phase 1, dead ones too:
//     pushing the first dead slot once and copying it into the identical
//     ones, as K2 does, was slower here, where a tenth of the slots are
//     dead (PERF.md).  In phase 2 a slot that neither deposits nor counts
//     (w = 0) costs one load;
//   * a shared footprint sized to what the particles reach: a block-wide
//     min/max over the alive slots' stencil starts s (the stencils reach
//     rows s - 1 .. s + order + 1, as a particle drifts less than a cell a
//     step) places a box of at most KB^3 cells in the W^3 window
//     (box_edge); the fields are staged there, in the state's type or as
//     bfloat16 in the modes.  A particle whose gather leaves the box, or
//     whose deposit leaves it or is clipped at the window's edge, takes the
//     checked path: a tap in the box is read there, any other tap in the
//     window from the padded fields through the read-only cache.  The kernel
//     counts the tiles that took the checked path (`wide`);
//   * the deposit adds to the block's own current windows in device memory
//     (zeroed first by the block, which no other block touches) by the
//     reduction that returns nothing (global_add, REDG in the SASS), native
//     on sm_90a; three current boxes in shared memory, whose float atomicAdd
//     is a compare-and-swap loop there, were slower (PERF.md);
//   * the gather table at compile time: the paths run the Yee staggering
//     with Galerkin on or off (ops/fused_pic.py::_gather_table), where an
//     axis has two weight sets, nodal at the full order and staggered at
//     the full order less `galerkin`; a particle computes these six sets
//     once, with the per-tap formula of the first design, so the bits stay
//     the same, and runs tap loops of compile-time length with no bounds
//     tests;
//   * the deposit on the rows the two stencils touch: the old and new
//     stencil starts differ by -1, 0 or +1, so an axis spans order + 2
//     rows, and along the deposit axis the running sum of the old-minus-new
//     weights is, from the last touched row on, the rounding residue of a
//     zero sum.  The deposit visits (order + 1) x (order + 2)^2 points a
//     component, skips the rows that carry only that residue and every
//     zero product; the first design added the residue on order + 3 rows,
//     the plain version on every row to the window's end, which is within
//     the kernels' tolerance (ulps of the running sum);
//   * no call in the hot loops: each phase runs its fast form over up to 32
//     items a thread, then the checked form of the items the fast form left
//     (a 32-bit mask), inlined there; a call site made the kernel save its
//     live registers, which ptxas reports as spills;
//   * residency: block_threads() threads and min_blocks() blocks an SM asked
//     of ptxas per type, order and mode, the fastest shapes on the H100 with
//     which float32 spills nothing (PERF.md).
// Particles and violation counts are bitwise the first design's in every
// mode: the same expression trees, with the contractions that design's
// compiler chose spelled out where this one chose others (pushed_gaminv).
//
// Precision modes (the TPU kernel's mxu argument, kernel mode K1d;
// pallas_pic.py:57-69, 133-136, 268-306, 363-390), a template parameter
// instantiated in every library: in 'mixed' and 'bf16' each field value and
// each transverse weight bf16(wy*wz) of the gather is rounded to bfloat16, the
// x weight is not; the deposit's point value is dot3x(cs*scale, 1/4 sa sb +
// 1/12 da db) in 'mixed' and bf16(cs*scale/4) bf16(sa sb) + bf16(cs*scale/12)
// bf16(da db) in 'bf16' (fused_pic_common.cuh).  The splines and every
// rounded operand are formed without FMA contraction.
//
// Moving-window mode (the TPU kernel's anchors / zshift / smax arguments,
// pallas_pic.py:197-208): lo is the anchor the tiles were laid out from at the
// last rebin, and the grid has slid zshift cells along z since, inside a
// padded field that is smax cells longer on that axis; the window of tile t
// then starts at t*tile + (smax - zshift) there.  smax = zshift = 0 and
// lo = prob_lo is the periodic case.
//
// Semantics kept from the TPU kernel: coordinates are window-relative,
// X = (pos - lo)/dx - (t*tile - off); the new position is X + v*dt/dx; a
// stencil row outside the window is dropped; the gather's order-0 shape (the
// Galerkin reduced order of order 1) is the half-open box [-1/2, 1/2); the
// Esirkepov running sum along the deposit axis is carried to the window's
// end for a particle clipped at the window's low side; every slot of an
// occupied tile is pushed, dead ones too (their weight is 0, so they
// deposit nothing); violations count alive particles whose deposit stencil
// start, start_index(x_new) - 1, leaves [0, W - order - 3].  J windows are
// written in the layouts fold_windows expects: (x,(y,z)), (y,(x,z)),
// (z,(x,y)).

#include <climits>
#include <type_traits>

#include "fused_pic_common.cuh"

namespace {

// Threads a block and resident blocks an SM asked of ptxas, chosen on the
// H100 among the shapes with which float32 spills nothing (PERF.md): at
// order 1, 256 x 2 at 'f32' and 160 x 3 in the modes, whose field boxes take
// half the bytes; orders 2 and 3, 192 x 2; float64, which runs only in the
// tests, 192 threads and the registers it needs.
template <typename T, int ORDER, int MXU>
__host__ __device__ constexpr int block_threads() {
  return sizeof(T) == 8 || ORDER > 1 ? 192 : MXU == kMxuF32 ? 256 : 160;
}
template <typename T, int ORDER, int MXU>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(T) == 8 ? 1 : ORDER > 1 || MXU == kMxuF32 ? 2 : 3;
}
// Items a thread runs the fast form over before the checked form of those
// it left (the bits of a 32-bit mask).
constexpr int kLate = 32;
// The box edge: uniform-128's reach at order 1 (a tile of 8 cells, the
// stencil's rows around it, a drift of under a cell since the rebin), one
// more cell an order.
template <int ORDER>
__host__ __device__ constexpr int box_edge() {
  return 12 + ORDER;
}

// Yee staggering: whether component c (Ex, Ey, Ez, Bx, By, Bz) sits at
// i + 1/2 on axis d.
__host__ __device__ constexpr bool yee_stag(int c, int d) {
  return c < 3 ? c == d : c - 3 != d;
}

// The current component d's transverse axes, in its window's layout.
__host__ __device__ constexpr int axis_a(int d) { return d == 0 ? 1 : 0; }
__host__ __device__ constexpr int axis_b(int d) { return d == 2 ? 1 : 2; }

// J_d at one stencil point: cval = cs_d * wq*invdtd_d times the transverse
// mix 1/4 sa sb + 1/12 da db, at precision MXU (pallas_pic.py:363-390).
template <int MXU, typename T>
__device__ __forceinline__ T esirkepov_point(T cval, T sa, T sb, T da, T db) {
  if (MXU == kMxuMixed) {
    return dot3x(cval, add_rn(mul_rn(T(0.25), mul_rn(sa, sb)),
                              mul_rn(T(1.0 / 12.0), mul_rn(da, db))));
  }
  if (MXU == kMxuBf16) {
    return bf16_round(mul_rn(T(0.25), cval)) * bf16_round(mul_rn(sa, sb)) +
           bf16_round(mul_rn(T(1.0 / 12.0), cval)) * bf16_round(mul_rn(da, db));
  }
  return cval * (T(0.25) * (sa * sb) + T(1.0 / 12.0) * (da * db));
}

// *p += v in device memory by the reduction that returns nothing (REDG in
// the SASS), asked for explicitly: in one build of this kernel atomicAdd
// compiled to the value-returning ATOMG, 8 % slower (PERF.md).  The #else
// branch only lets a host compiler parse the source.
__device__ __forceinline__ void global_add(float* p, float v) {
#ifdef __CUDA_ARCH__
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
#else
  atomicAdd(p, v);
#endif
}
__device__ __forceinline__ void global_add(double* p, double v) {
#ifdef __CUDA_ARCH__
  asm volatile("red.global.add.f64 [%0], %1;" ::"l"(p), "d"(v) : "memory");
#else
  atomicAdd(p, v);
#endif
}

// Dynamic shared memory: the six staged field boxes.
extern __shared__ __align__(16) unsigned char smem_raw[];

template <typename G, int KB>
__host__ __device__ constexpr size_t smem_bytes() {
  return 6ull * KB * KB * KB * sizeof(G);
}

// Where the block's box lies in its window.
template <int KB>
struct Box {
  static constexpr int kB3 = KB * KB * KB;
  int w;      // the window's edge W
  int b0[3];  // the box's origin, in window rows
  int bw;     // the box's edge: min(W, KB)
  __device__ __forceinline__ bool holds(int r, int d) const {
    return static_cast<unsigned>(r - b0[d]) < static_cast<unsigned>(bw);
  }
  __device__ __forceinline__ bool holds(int rx, int ry, int rz) const {
    return holds(rx, 0) && holds(ry, 1) && holds(rz, 2);
  }
  __device__ __forceinline__ int at(int rx, int ry, int rz) const {
    return ((rx - b0[0]) * KB + ry - b0[1]) * KB + rz - b0[2];
  }
};

// The window's origin in the padded fields, and the block's current
// windows' offset in jw.
__device__ __forceinline__ long long field_origin(const FusedPicArgs& a) {
  const int t = blockIdx.x;
  const int nty = a.tiles_per_dim[1], ntz = a.tiles_per_dim[2];
  const int t0 = t / (nty * ntz);
  const int t1 = (t / ntz) % nty;
  const int t2 = t % ntz;
  return static_cast<long long>(t0 * a.tile[0]) * a.fdim[1] * a.fdim[2] +
         static_cast<long long>(t1 * a.tile[1]) * a.fdim[2] +
         (t2 * a.tile[2] + a.zoff);
}
__device__ __forceinline__ long long j_origin(const FusedPicArgs& a) {
  return static_cast<long long>(blockIdx.x) * a.w * a.w * a.w;
}

template <typename G>
__device__ __forceinline__ G* field_box() {
  return reinterpret_cast<G*>(smem_raw);
}

// f(row, k) for k in [0, n) of every row in [0, rows), by a block of NTH
// threads: a half-warp a row, so the rows of a box (n <= 16) take one pass
// and no division per element.
template <int NTH, typename F>
__device__ __forceinline__ void for_rows(int rows, int n, F f) {
  const int lane = threadIdx.x & 15;
  for (int row = threadIdx.x >> 4; row < rows; row += NTH / 16) {
    for (int k = lane; k < n; k += 16) f(row, k);
  }
}

// One component of the gather from its staged box, from box rows
// (ix, iy, iz) on: sum over the (y, z) taps of bf16?(wy wz) F, then over x
// of wx times that, the first design's order of summation.
template <int OX, int OY, int OZ, bool EXACT, typename T, typename G, int KB>
__device__ __forceinline__ T gather_boxed(int c, int ix, int iy, int iz,
                                          const T (&wx)[OX + 1],
                                          const T (&wy)[OY + 1],
                                          const T (&wz)[OZ + 1]) {
  const G* F = field_box<G>() + c * Box<KB>::kB3 + (ix * KB + iy) * KB + iz;
  T e = T(0);
#pragma unroll
  for (int ia = 0; ia <= OX; ++ia) {
    T h = T(0);
#pragma unroll
    for (int ib = 0; ib <= OY; ++ib) {
#pragma unroll
      for (int ic = 0; ic <= OZ; ++ic) {
        const T wyz = EXACT ? bf16_round(mul_rn(wy[ib], wz[ic]))
                            : wy[ib] * wz[ic];
        h += wyz * static_cast<T>(staged(F[(ia * KB + ib) * KB + ic]));
      }
    }
    e += wx[ia] * h;
  }
  return e;
}

// The checked path of the gather: the first design's loops, one component
// at a time with its orders and staggering; taps outside the window are
// dropped, a tap in the box is read there, any other from the padded field
// through the read-only cache, rounded as staged.
template <typename T, typename G, bool EXACT, int ORDER, int KB>
__device__ __forceinline__ void gather_checked(const FusedPicArgs& a,
                                               const Box<KB>& box,
                                               int galerkin, const T (&X)[3],
                                               T (&e6)[6]) {
  const long long fs1 = a.fdim[2];
  const long long fs0 = a.fdim[1] * fs1;
  const long long forig = field_origin(a);
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    T wt[3][4];
    int i0[3], o[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      o[d] = yee_stag(c, d) ? ORDER - galerkin : ORDER;
      i0[d] = gather_weights<T, EXACT>(yee_stag(c, d) ? X[d] - T(0.5) : X[d],
                                       o[d], wt[d]);
    }
    const G* F = field_box<G>() + c * Box<KB>::kB3;
    const T* f = static_cast<const T*>(a.fields[c]) + forig;
    T e = T(0);
#pragma unroll 1
    for (int ia = 0; ia <= o[0]; ++ia) {
      const int rx = i0[0] + ia;
      if (rx < 0 || rx >= box.w) continue;
      T wx = wt[0][0];
#pragma unroll
      for (int m = 1; m <= 3; ++m) wx = ia == m ? wt[0][m] : wx;
      T h = T(0);
#pragma unroll
      for (int ib = 0; ib <= 3; ++ib) {
        const int ry = i0[1] + ib;
        if (ib > o[1] || ry < 0 || ry >= box.w) continue;
#pragma unroll
        for (int ic = 0; ic <= 3; ++ic) {
          const int rz = i0[2] + ic;
          if (ic > o[2] || rz < 0 || rz >= box.w) continue;
          const T v = box.holds(rx, ry, rz)
                          ? static_cast<T>(staged(F[box.at(rx, ry, rz)]))
                          : static_cast<T>(staged(to_staged<G>(
                                __ldg(f + rx * fs0 + ry * fs1 + rz))));
          const T wyz = EXACT ? bf16_round(mul_rn(wt[1][ib], wt[2][ic]))
                              : wt[1][ib] * wt[2][ic];
          h += wyz * v;
        }
      }
      e += wx * h;
    }
    e6[c] = e;
  }
}

// The gather from the staged boxes: the nodal (N, full order) and
// staggered (S, order SO) weight sets of each axis, each computed once; the
// Yee table reads Ex (S, N, N), Ey (N, S, N), Ez (N, N, S), Bx (N, S, S),
// By (S, N, S), Bz (S, S, N).  Returns false, with e6 untouched, where a
// tap leaves the box.
template <int ORDER, int SO, bool EXACT, typename T, typename G, int KB>
__device__ __forceinline__ bool gather_sets(const Box<KB>& box,
                                            const T (&X)[3],
                                            const int (&iN)[3],
                                            const T (&wN)[3][ORDER + 1],
                                            T (&e6)[6]) {
  static_assert(yee_stag(0, 0) && !yee_stag(0, 1) && !yee_stag(0, 2) &&
                    !yee_stag(1, 0) && yee_stag(1, 1) && !yee_stag(1, 2) &&
                    !yee_stag(2, 0) && !yee_stag(2, 1) && yee_stag(2, 2) &&
                    !yee_stag(3, 0) && yee_stag(3, 1) && yee_stag(3, 2) &&
                    yee_stag(4, 0) && !yee_stag(4, 1) && yee_stag(4, 2) &&
                    yee_stag(5, 0) && yee_stag(5, 1) && !yee_stag(5, 2),
                "gather_sets reads the Yee table");
  T wS[3][SO + 1];
  int iS[3];
  bool boxed = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    iS[d] = set_weights<T, EXACT, SO>(X[d] - T(0.5), wS[d]);
    const int lo = box.b0[d], hi = box.b0[d] + box.bw - 1;
    boxed = boxed && iN[d] >= lo && iN[d] + ORDER <= hi && iS[d] >= lo &&
            iS[d] + SO <= hi;
  }
  if (!boxed) return false;
  const int n0 = iN[0] - box.b0[0], n1 = iN[1] - box.b0[1],
            n2 = iN[2] - box.b0[2];
  const int s0 = iS[0] - box.b0[0], s1 = iS[1] - box.b0[1],
            s2 = iS[2] - box.b0[2];
  e6[0] = gather_boxed<SO, ORDER, ORDER, EXACT, T, G, KB>(0, s0, n1, n2,
                                                          wS[0], wN[1], wN[2]);
  e6[1] = gather_boxed<ORDER, SO, ORDER, EXACT, T, G, KB>(1, n0, s1, n2,
                                                          wN[0], wS[1], wN[2]);
  e6[2] = gather_boxed<ORDER, ORDER, SO, EXACT, T, G, KB>(2, n0, n1, s2,
                                                          wN[0], wN[1], wS[2]);
  e6[3] = gather_boxed<ORDER, SO, SO, EXACT, T, G, KB>(3, n0, s1, s2, wN[0],
                                                       wS[1], wS[2]);
  e6[4] = gather_boxed<SO, ORDER, SO, EXACT, T, G, KB>(4, s0, n1, s2, wS[0],
                                                       wN[1], wS[2]);
  e6[5] = gather_boxed<SO, SO, ORDER, EXACT, T, G, KB>(5, s0, s1, n2, wS[0],
                                                       wS[1], wN[2]);
  return true;
}

// The launch's constants in the state's type, a kernel argument: they stay
// in the parameter space, where an instruction reads them as operands.
template <typename T>
struct K1Consts {
  T lo[3], inv_dx[3], dt_inv_dx[3], dt, invdtd[3];
};

// What a block holds for all its slots.
template <typename T, int KB>
struct TileConst {
  Box<KB> box;
  T worig[3];  // the window's origin, relative to the tiling origin lo
};

template <typename T>
__device__ __forceinline__ T window_coord(T pos, T lo, T inv_dx, T worig) {
  return sub_rn(mul_rn(sub_rn(pos, lo), inv_dx), worig);
}

// 1/gamma of the pushed momentum with the first design's roundings spelled
// out: its compiler contracted the sum of squares as fma(uz, uz, fma(ux, ux,
// uy*uy)) and 1 + s/c^2 as one FMA.  Left to the compiler here, another
// contraction moved a new position by an ulp now and then; phase 2 forms
// x_new from the same value.
template <typename T>
__device__ __forceinline__ T pushed_gaminv(T ux, T uy, T uz) {
  const T s = fma(uz, uz, fma(ux, ux, mul_rn(uy, uy)));
  return T(1) / sqrt(fma(s, T(kInvC2), T(1)));
}

// Phase 1 for one slot: gather, push, the columns written.  The fast form
// (CHECKED false) gathers from the staged boxes; where a tap leaves the box
// it writes nothing and returns false, and the slot takes the checked form
// later.
template <bool CHECKED, typename T, int ORDER, int MXU, typename G, int KB>
__device__ __forceinline__ bool push_slot(const FusedPicArgs& a,
                                          const K1Consts<T>& kc,
                                          const TileConst<T, KB>& tk, int s,
                                          int galerkin, long long k) {
  constexpr bool EXACT = MXU != kMxuF32;
  const T* prm = static_cast<const T*>(a.sp_params) + s * 8;
  const T dt = kc.dt;
  T in_[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) in_[c] = static_cast<const T*>(a.parts[c])[k];
  T X[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    X[d] = window_coord(in_[d], kc.lo[d], kc.inv_dx[d], tk.worig[d]);
  }

  // ---- gather: the nodal sets, then the staggered ones
  T e6[6];
  if constexpr (CHECKED) {
    gather_checked<T, G, EXACT, ORDER, KB>(a, tk.box, galerkin, X, e6);
  } else {
    T wN[3][ORDER + 1];
    int iN[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      iN[d] = set_weights<T, EXACT, ORDER>(X[d], wN[d]);
    }
    const bool boxed =
        galerkin
            ? gather_sets<ORDER, ORDER - 1, EXACT, T, G, KB>(tk.box, X, iN,
                                                             wN, e6)
            : gather_sets<ORDER, ORDER, EXACT, T, G, KB>(tk.box, X, iN, wN,
                                                         e6);
    if (!boxed) return false;
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) e6[c] = e6[c] + prm[2 + c];

  // ---- push
  // the pusher is uniform over the launch: a branch no warp diverges on
  const T q = prm[0];
  const T m = prm[1];
  T ux = in_[3], uy = in_[4], uz = in_[5];
  if (a.pusher == 0) {
    push_boris(ux, uy, uz, e6[0], e6[1], e6[2], e6[3], e6[4], e6[5], q, m,
               dt);
  } else if (a.pusher == 1) {
    push_vay(ux, uy, uz, e6[0], e6[1], e6[2], e6[3], e6[4], e6[5], q, m, dt);
  } else {
    push_higuera(ux, uy, uz, e6[0], e6[1], e6[2], e6[3], e6[4], e6[5], q, m,
                 dt);
  }
  const T gaminv = pushed_gaminv(ux, uy, uz);
  // pos + v dt as one FMA, as the first design's compiler formed it
  const T out_[6] = {fma(mul_rn(ux, gaminv), dt, in_[0]),
                     fma(mul_rn(uy, gaminv), dt, in_[1]),
                     fma(mul_rn(uz, gaminv), dt, in_[2]), ux, uy, uz};
#pragma unroll
  for (int c = 0; c < 6; ++c) static_cast<T*>(a.out_parts[c])[k] = out_[c];
  return true;
}

// The old and new weights of one axis on the order + 2 rows from
// b = min(so, sn), the first rows of the old and new stencils: sm = new +
// old and df = old - new.  Returns b.
template <typename T, bool EXACT, int ORDER>
__device__ __forceinline__ int union_rows(T X, T xn, int so, int sn,
                                          T (&sm)[ORDER + 2],
                                          T (&df)[ORDER + 2]) {
  T wo[ORDER + 1], wn[ORDER + 1];
  set_weights<T, EXACT, ORDER>(X, wo);
  set_weights<T, EXACT, ORDER>(xn, wn);
  const int b = min(so, sn);
  const int oo = so - b, on = sn - b;
#pragma unroll
  for (int r = 0; r < ORDER + 2; ++r) {
    // the sets placed by their offsets, with compile-time indices only
    T sov = T(0), snv = T(0);
#pragma unroll
    for (int o = 0; o <= 1; ++o) {
      if (r - o >= 0 && r - o <= ORDER) {
        if (oo == o) sov = wo[r - o];
        if (on == o) snv = wn[r - o];
      }
    }
    sm[r] = snv + sov;
    df[r] = sov - snv;
  }
  return b;
}

// The coordinates phase 2 deposits from.
template <typename T>
struct Move {
  T X[3], xn[3];
};

// The checked path of the deposit: the first design's Esirkepov weights and
// loops on order + 3 rows an axis from start_index(x_new) - 1, a stencil row
// outside the window dropped, the low-side carry, into the block's current
// windows.  One component at a time, each axis's weights formed anew, so
// few registers are live.
template <typename T, int ORDER, int MXU>
__device__ __forceinline__ void deposit_checked(const FusedPicArgs& a,
                                                const K1Consts<T>& kc,
                                                const Move<T>& mv, T wq) {
  constexpr int NT = ORDER + 3;
  constexpr bool EXACT = MXU != kMxuF32;
  const int W = a.w;
  int j0[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) j0[d] = start_index(mv.xn[d], ORDER) - 1;
  // sm = new + old, df = old - new on the NT rows of axis d (0 outside the
  // window)
  auto weights = [&](int d, T (&sm)[NT], T (&df)[NT]) {
#pragma unroll
    for (int r = 0; r < NT; ++r) {
      const int row_ = j0[d] + r;
      const bool in = row_ >= 0 && row_ < W;
      const T sn = in ? spline<T, EXACT>(mv.xn[d] - static_cast<T>(row_), ORDER)
                      : T(0);
      const T so = in ? spline<T, EXACT>(mv.X[d] - static_cast<T>(row_), ORDER)
                      : T(0);
      sm[r] = sn + so;
      df[r] = so - sn;
    }
  };
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int da = axis_a(d), db = axis_b(d);
    // cs: the running sum of df along d (sma is scratch until reused)
    T cs[NT], sma[NT], dfa[NT], smb[NT], dfb[NT];
    weights(d, sma, cs);
    T acc = T(0);
#pragma unroll
    for (int r = 0; r < NT; ++r) {
      acc += cs[r];
      cs[r] = acc;
    }
    weights(da, sma, dfa);
    weights(db, smb, dfb);
    const T scale = wq * kc.invdtd[d];
    T* Jd = static_cast<T*>(a.jw[d]) + j_origin(a);
    auto plane = [&](int row_, T cval) {
#pragma unroll
      for (int ja = 0; ja < NT; ++ja) {
        const int ra = j0[da] + ja;
        if (ra < 0 || ra >= W) continue;
#pragma unroll
        for (int jb = 0; jb < NT; ++jb) {
          const int rb = j0[db] + jb;
          if (rb < 0 || rb >= W) continue;
          const T v = esirkepov_point<MXU>(cval, sma[ja], smb[jb], dfa[ja],
                                           dfb[jb]);
          if (v != T(0)) global_add(Jd + (row_ * W + ra) * W + rb, v);
        }
      }
    };
#pragma unroll
    for (int r = 0; r < NT; ++r) {
      const int row_ = j0[d] + r;
      if (row_ < 0 || row_ >= W) continue;
      const T cval = cs[r] * scale;
      if (cval != T(0)) plane(row_, cval);
    }
    if (j0[d] < 0) {
      // clipped at the window's low side: the running sum is carried on to
      // the window's end, as the TPU kernel's full-window cumsum
      const T cval = cs[NT - 1] * scale;
      for (int row_ = max(j0[d] + NT, 0); row_ < W && cval != T(0); ++row_) {
        plane(row_, cval);
      }
    }
  }
}

// Phase 2 for one slot of an occupied (species, tile): x_new from the old
// position and the new momentum (phase 1's expressions, so the same bits),
// the violation count, the deposit.  The fast form counts the violation and
// returns false, depositing nothing, where the slot's stencils leave the
// box or the window or move by more than a row; the checked form then
// deposits it.
template <bool CHECKED, typename T, int ORDER, int MXU, int KB>
__device__ __forceinline__ bool deposit_slot(const FusedPicArgs& a,
                                             const K1Consts<T>& kc,
                                             const TileConst<T, KB>& tk, T q,
                                             long long k, int* s_viol) {
  constexpr int NT = ORDER + 3;  // the first design's rows an axis
  constexpr int NU = ORDER + 2;  // the rows the two stencils span
  constexpr bool EXACT = MXU != kMxuF32;
  const Box<KB>& box = tk.box;
  const T w = static_cast<const T*>(a.parts[6])[k];
  const T wq = q * w;
  if (wq == T(0) && !(w > T(0))) return true;  // deposits nor counts
  const T ux = static_cast<const T*>(a.out_parts[3])[k];
  const T uy = static_cast<const T*>(a.out_parts[4])[k];
  const T uz = static_cast<const T*>(a.out_parts[5])[k];
  const T gaminv = pushed_gaminv(ux, uy, uz);
  const T vel[3] = {mul_rn(ux, gaminv), mul_rn(uy, gaminv),
                    mul_rn(uz, gaminv)};
  // the stencil starts: the violation count and the path
  Move<T> mv;
  int so[3], sn[3];
  bool bad = false, fast = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    mv.X[d] = window_coord(static_cast<const T*>(a.parts[d])[k], kc.lo[d],
                           kc.inv_dx[d], tk.worig[d]);
    mv.xn[d] = add_rn(mv.X[d], mul_rn(vel[d], kc.dt_inv_dx[d]));
    so[d] = start_index(mv.X[d], ORDER);
    sn[d] = start_index(mv.xn[d], ORDER);
    bad = bad || sn[d] - 1 < 0 || sn[d] - 1 > box.w - NT;
    const int b = min(so[d], sn[d]);
    fast = fast && abs(sn[d] - so[d]) <= 1 && b >= box.b0[d] &&
           b + NU <= box.b0[d] + box.bw;
  }
  if constexpr (CHECKED) {
    deposit_checked<T, ORDER, MXU>(a, kc, mv, wq);
    return true;
  }
  if (bad && w > T(0)) atomicAdd(s_viol, 1);
  if (wq == T(0)) return true;
  if (bad || !fast) return false;
  // J_d[row, ra, rb] += cs_d * (wq*invdtd_d) * (1/4 sm_a sm_b + 1/12 df_a df_b)
  // on the NU rows of each axis; each component forms its three axes'
  // weights anew, so few registers are live
  const int W = box.w;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int da = axis_a(d), db = axis_b(d);
    T cs[NU], sma[NU], dfa[NU], smb[NU], dfb[NU];
    const int bd = union_rows<T, EXACT, ORDER>(mv.X[d], mv.xn[d], so[d],
                                               sn[d], sma, cs);
    const int ba = union_rows<T, EXACT, ORDER>(mv.X[da], mv.xn[da], so[da],
                                               sn[da], sma, dfa);
    const int bb = union_rows<T, EXACT, ORDER>(mv.X[db], mv.xn[db], so[db],
                                               sn[db], smb, dfb);
    // the running sum of df along d; from the last row either stencil
    // touches on, it is the rounding residue of a zero sum
    const int last = max(so[d], sn[d]) - bd + ORDER;
    T acc = T(0);
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      acc += cs[r];
      cs[r] = acc;
    }
    const T scale = wq * kc.invdtd[d];
    T* Jd = static_cast<T*>(a.jw[d]) + j_origin(a) + (bd * W + ba) * W + bb;
#pragma unroll
    for (int r = 0; r <= ORDER; ++r) {
      if (r >= last) continue;
      const T cval = cs[r] * scale;
      if (cval == T(0)) continue;
#pragma unroll
      for (int ja = 0; ja < NU; ++ja) {
#pragma unroll
        for (int jb = 0; jb < NU; ++jb) {
          const T v = esirkepov_point<MXU>(cval, sma[ja], smb[jb], dfa[ja],
                                           dfb[jb]);
          if (v != T(0)) global_add(Jd + (r * W + ja) * W + jb, v);
        }
      }
    }
  }
  return true;
}

template <typename T, int ORDER, int MXU>
__global__ void __launch_bounds__(block_threads<T, ORDER, MXU>(),
                                  min_blocks<T, ORDER, MXU>())
fused_pic_kernel(const FusedPicArgs a, const K1Consts<T> kc,
                 const int galerkin, int* wide_tiles) {
  using G = typename std::conditional<MXU == kMxuF32, T, __nv_bfloat16>::type;
  constexpr int kThreads = block_threads<T, ORDER, MXU>();
  constexpr int KB = box_edge<ORDER>();
  constexpr int kB3 = Box<KB>::kB3;
  __shared__ int s_viol, s_wide;
  __shared__ int s_lo[3], s_hi[3];
  // the slots read the tile's constants from here, not from registers
  __shared__ TileConst<T, KB> s_tk;

  const int t = blockIdx.x;
  const int W = a.w;
  const int P = a.p_max;
  const int W2 = W * W;
  const int nty = a.tiles_per_dim[1], ntz = a.tiles_per_dim[2];
  const int t0 = t / (nty * ntz);
  const int t1 = (t / ntz) % nty;
  const int t2 = t % ntz;
  // window origin in grid coordinates, relative to the tiling origin lo
  const int g0[3] = {t0 * a.tile[0], t1 * a.tile[1], t2 * a.tile[2]};
  TileConst<T, KB> tk;
#pragma unroll
  for (int d = 0; d < 3; ++d) tk.worig[d] = static_cast<T>(g0[d] - a.off);
  const long long jbase = j_origin(a);

  // the current windows start at zero: the deposit adds to them by global
  // atomics, after the barriers below
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    T* dst = static_cast<T*>(a.jw[c]) + jbase;
    for_rows<kThreads>(W2, W,
                       [&](int row, int z) { dst[row * W + z] = T(0); });
  }
  bool any = false;
  for (int s = 0; s < a.n_sp; ++s) any = any || a.counts[s * a.n_tiles + t] > 0;
  if (!any) {
    // no alive particle in any species: copy the columns
    for (int s = 0; s < a.n_sp; ++s) {
      const long long base = (static_cast<long long>(s) * a.n_tiles + t) * P;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const T* src = static_cast<const T*>(a.parts[c]) + base;
        T* dst = static_cast<T*>(a.out_parts[c]) + base;
        for (int p = threadIdx.x; p < P; p += kThreads) dst[p] = src[p];
      }
      if (threadIdx.x == 0) a.viol[s * a.n_tiles + t] = 0;
    }
    return;
  }

  // ---- the rows the alive slots reach (stencil start s: s - 1 to
  // s + order + 1) place the box; a window no wider than the box is the box
  tk.box.w = W;
  tk.box.bw = min(W, KB);
  tk.box.b0[0] = tk.box.b0[1] = tk.box.b0[2] = 0;
  if (threadIdx.x == 0) s_wide = 0;
  if (W > KB) {
    if (threadIdx.x < 3) {
      s_lo[threadIdx.x] = INT_MAX;
      s_hi[threadIdx.x] = INT_MIN;
    }
    __syncthreads();
    int rlo[3] = {INT_MAX, INT_MAX, INT_MAX};
    int rhi[3] = {INT_MIN, INT_MIN, INT_MIN};
    for (int s = 0; s < a.n_sp; ++s) {
      const long long base = (static_cast<long long>(s) * a.n_tiles + t) * P;
      const int cnt = a.counts[s * a.n_tiles + t];
      for (int p = threadIdx.x; p < cnt; p += kThreads) {
        if (static_cast<const T*>(a.parts[6])[base + p] == T(0)) continue;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const T X = window_coord(static_cast<const T*>(a.parts[d])[base + p],
                                   kc.lo[d], kc.inv_dx[d], tk.worig[d]);
          const int st = start_index(X, ORDER);
          rlo[d] = min(rlo[d], st - 1);
          rhi[d] = max(rhi[d], st + ORDER + 1);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      rlo[d] = __reduce_min_sync(0xffffffffu, rlo[d]);
      rhi[d] = __reduce_max_sync(0xffffffffu, rhi[d]);
    }
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        atomicMin(&s_lo[d], rlo[d]);
        atomicMax(&s_hi[d], rhi[d]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      // every reached row when they fit; else the box centred on the tile
      const bool fits = s_lo[d] <= s_hi[d] && s_hi[d] - s_lo[d] < KB;
      const int want = fits ? s_lo[d] : a.off + a.tile[d] / 2 - KB / 2;
      tk.box.b0[d] = min(max(want, 0), W - KB);
    }
  }
  const int bw = tk.box.bw, bw2 = bw * bw;
  if (threadIdx.x == 0) s_tk = tk;  // read after the next barrier

  // ---- phase 1: stage the fields in the box, then gather and push
  {
    G* fbox = field_box<G>();
    const long long fs1 = a.fdim[2];
    const long long fs0 = static_cast<long long>(a.fdim[1]) * fs1;
    const long long borig = field_origin(a) + tk.box.b0[0] * fs0 +
                            tk.box.b0[1] * fs1 + tk.box.b0[2];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const T* f = static_cast<const T*>(a.fields[c]) + borig;
      G* fb = fbox + c * kB3;
      for_rows<kThreads>(bw2, bw, [&](int row, int z) {
        const int r = row / bw;
        const int ry = row - r * bw;
        fb[(r * KB + ry) * KB + z] = to_staged<G>(__ldg(f + r * fs0 +
                                                        ry * fs1 + z));
      });
    }
  }
  __syncthreads();  // the staged boxes before their first use
  for (int s = 0; s < a.n_sp; ++s) {
    const long long base = (static_cast<long long>(s) * a.n_tiles + t) * P;
    if (a.counts[s * a.n_tiles + t] == 0) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const T* src = static_cast<const T*>(a.parts[c]) + base;
        T* dst = static_cast<T*>(a.out_parts[c]) + base;
        for (int p = threadIdx.x; p < P; p += kThreads) dst[p] = src[p];
      }
      continue;
    }
    // up to kLate items a thread at a time: the fast form first, then, from
    // the bits of `late`, the checked form of the items it left
    for (int c0 = 0; c0 < P; c0 += kLate * kThreads) {
      unsigned late = 0;
      int j = 0;
      for (int p = c0 + threadIdx.x; j < kLate && p < P; ++j, p += kThreads) {
        if (!push_slot<false, T, ORDER, MXU, G, KB>(a, kc, s_tk, s, galerkin,
                                                    base + p)) {
          late |= 1u << j;
        }
      }
      if (late) s_wide = 1;
      for (; late; late &= late - 1) {
        const int p = c0 + threadIdx.x + (__ffs(late) - 1) * kThreads;
        push_slot<true, T, ORDER, MXU, G, KB>(a, kc, s_tk, s, galerkin,
                                              base + p);
      }
    }
  }
  __syncthreads();  // the new columns before phase 2 reads them back

  // ---- phase 2: violations and the deposit
  const T* prm = static_cast<const T*>(a.sp_params);
  for (int s = 0; s < a.n_sp; ++s) {
    const long long row = static_cast<long long>(s) * a.n_tiles + t;
    const int cnt = a.counts[row];
    if (threadIdx.x == 0) s_viol = 0;
    __syncthreads();
    if (cnt > 0) {
      const T q = prm[s * 8];
      for (int c0 = 0; c0 < P; c0 += kLate * kThreads) {
        unsigned late = 0;
        int j = 0;
        for (int p = c0 + threadIdx.x; j < kLate && p < P;
             ++j, p += kThreads) {
          if (!deposit_slot<false, T, ORDER, MXU, KB>(a, kc, s_tk, q,
                                                      row * P + p, &s_viol)) {
            late |= 1u << j;
          }
        }
        if (late) s_wide = 1;
        for (; late; late &= late - 1) {
          const int p = c0 + threadIdx.x + (__ffs(late) - 1) * kThreads;
          deposit_slot<true, T, ORDER, MXU, KB>(a, kc, s_tk, q, row * P + p,
                                                &s_viol);
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) a.viol[row] = cnt > 0 ? s_viol : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_wide) atomicAdd(wide_tiles, 1);
}

template <typename T, int O, int MX>
int launch_3d(const FusedPicArgs& a, int galerkin, int* wide,
              cudaStream_t st) {
  using G = typename std::conditional<MX == kMxuF32, T, __nv_bfloat16>::type;
  constexpr size_t smem = smem_bytes<G, box_edge<O>()>();
  auto kern = fused_pic_kernel<T, O, MX>;
  // dynamic shared memory beyond the default 48 KB (static included) needs
  // the opt-in, so always ask for it
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return kStageSetSmem * 1000 + static_cast<int>(e);
  K1Consts<T> kc;
  for (int d = 0; d < 3; ++d) {
    kc.lo[d] = static_cast<T>(a.lo[d]);
    kc.inv_dx[d] = static_cast<T>(a.inv_dx[d]);
    kc.dt_inv_dx[d] = static_cast<T>(a.dt_inv_dx[d]);
    kc.invdtd[d] = static_cast<T>(a.invdtd[d]);
  }
  kc.dt = static_cast<T>(a.dt);
  kern<<<a.n_tiles, block_threads<T, O, MX>(), smem, st>>>(a, kc, galerkin,
                                                         wide);
  e = cudaGetLastError();
  return e == cudaSuccess ? 0 : kStageLaunch * 1000 + static_cast<int>(e);
}

template <typename T, int O, int MX>
int blocks_3d() {
  using G = typename std::conditional<MX == kMxuF32, T, __nv_bfloat16>::type;
  constexpr size_t smem = smem_bytes<G, box_edge<O>()>();
  auto kern = fused_pic_kernel<T, O, MX>;
  // as the launch asks: without the opt-in, a block above 48 KB fits none
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int n = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kern, block_threads<T, O, MX>(), smem);
  }
  return e == cudaSuccess ? n : -(kStageAttr * 1000 + static_cast<int>(e));
}

}  // namespace

// One library per (type, order): FP_REAL and FP_ORDER are set on the nvcc
// command line (warpx_tpu_torch/build.py), so the builds run in parallel;
// each holds the three precision modes.  The pusher and `galerkin` (the
// Yee gather table with Galerkin on or off) are kernel arguments, uniform
// over the launch: as template parameters too, their instantiations would
// multiply the build.  `wide` is a device counter that each tile which took
// the checked path adds one to.
extern "C" int fused_pic_launch(const FusedPicArgs* a, int galerkin,
                                int* wide, void* stream) {
  if (a->n_tiles <= 0) return 0;
  if (a->order != FP_ORDER || a->pusher < 0 || a->pusher > 2 ||
      (galerkin != 0 && galerkin != 1)) {
    return kStageArgs * 1000 + static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a->mxu) {
    case kMxuF32:
      return launch_3d<FP_REAL, FP_ORDER, kMxuF32>(*a, galerkin, wide, st);
    case kMxuMixed:
      return launch_3d<FP_REAL, FP_ORDER, kMxuMixed>(*a, galerkin, wide, st);
    case kMxuBf16:
      return launch_3d<FP_REAL, FP_ORDER, kMxuBf16>(*a, galerkin, wide, st);
    default:
      return kStageArgs * 1000 + static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident blocks per SM of the kernel in precision mode `mxu`
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); a negative value is an
// error code.
extern "C" int fused_pic_blocks_per_sm(int mxu) {
  switch (mxu) {
    case kMxuF32: return blocks_3d<FP_REAL, FP_ORDER, kMxuF32>();
    case kMxuMixed: return blocks_3d<FP_REAL, FP_ORDER, kMxuMixed>();
    case kMxuBf16: return blocks_3d<FP_REAL, FP_ORDER, kMxuBf16>();
    default:
      return -(kStageArgs * 1000 + static_cast<int>(cudaErrorInvalidValue));
  }
}

extern "C" const char* fused_pic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code % 1000));
}
