// Kernel K2: fused field gather + momentum push + Esirkepov current deposit
// over the tile-binned particle layout in 2D (the XZ plane; periodic, or
// anchored tiles under a moving window).
//
// Replaces warpx_tpu/ops/pallas_pic.py::binned_push_deposit ->
// _build_kernel_2d (the Pallas TPU kernel).  That kernel turns every
// per-particle shape weight into a dense (W, p_max) band matrix and stacks
// Jx, Jz and the two terms of Jy into one batched MXU contraction over the
// particle lanes.  Here, as in K1 (fused_pic.cu), the same arithmetic is
// per-particle index arithmetic on the (order+1)- or (order+3)-point
// stencils (CurrentDeposition.H doEsirkepovDepositionShapeN, 2D branch).
//
// Bound on the card: at order 3 in float32 the bytes bound it (6 particle
// values read and 5 written per slot, three W^2 current windows written per
// tile) some 30 % above the operations (about 490 per slot for coordinates,
// gather and push, and 540 more per alive slot for the Esirkepov weights and
// the deposit).  What held the first design back was not arithmetic: every
// block staged six W x W field windows and accumulated three W x W current
// windows in shared memory (83 KB a block at W = 48, two blocks an SM), and
// every dead slot of an occupied tile ran the gather and the push.  Design:
//   * one block per tile; the block loops over the species of the launch and
//     its threads stride over the slots, neighbouring threads on
//     neighbouring slots, so particle reads and writes are coalesced;
//   * a tile with no alive particle in any species stages nothing: it
//     writes zero current windows and copies its columns through;
//   * dead slots once per (species, tile): the rebin fills slots
//     [counts, p_max) from one value per tile, so thread 0 pushes slot
//     `counts` (the first dead slot) first, and every later slot whose six
//     inputs are bitwise equal to that slot's takes its outputs once thread
//     0 has published them in shared memory (a flag, no barrier); any other
//     slot takes the full path.  Exact whatever the inputs (a first dead
//     slot that would deposit or count a violation is copied by nobody);
//   * a shared footprint sized to what the particles reach: a block-wide
//     min/max over the alive slots' stencil rows (deposit reach: the old
//     position +- 1 cell, as CFL <= 1 in 2D bounds the drift of one step)
//     places a box of at most kBox x kBox cells in the window; the six field
//     boxes are staged there and the three current boxes accumulate there
//     by atomicAdd.  A particle whose gather or deposit stencil leaves the
//     box (a tile whose particles drifted further apart, a stencil clipped
//     at the window's edge, a violation) takes the checked path: each tap
//     in the box is read from or added to the box, each other tap in the
//     window is read from the padded fields through the read-only cache
//     (rounded to bfloat16 at use in the modes) or added by a global atomic
//     to the block's own current window, whose part outside the box the
//     block zeroes before any particle runs.  The kernel counts the tiles
//     that took the checked path (`wide`).  With W <= kBox, as at order 3
//     and one cell of sort margin (W = 24), the box is the window and the
//     min/max is skipped;
//   * the gather table at compile time: the paths run the Yee staggering
//     with Galerkin on or off (ops/fused_pic.py::_gather_table), where an
//     axis has two weight sets, nodal at the full order and staggered at
//     the full order less `galerkin`; a particle computes these four sets
//     once, with the per-tap formula of the first design, so the bits stay
//     the same, and the six components read them (12 sets in the first
//     design).  The new stencil of the deposit is one more nodal set, and
//     the old one is the gather's nodal set, placed by the stencil shift;
//   * a particle inside the box runs tap loops of compile-time length with
//     no bounds tests;
//   * residency: 160 threads, four blocks an SM at 96 registers
//     (kThreads, min_blocks);
//   * the deposit stays 108 shared atomicAdds an alive particle at order 3
//     (fewer: zero terms are skipped).  On sm_90a a shared float or double
//     atomicAdd is a compare-and-swap loop (ATOMS.CAST.SPIN in the SASS);
//     packing a point's (x, z) or (x, z, y) into one 64- or 128-bit
//     compare-and-swap, global atomics (native there) into the block's own
//     window and a per-lane rotation of the column order were each slower
//     (PERF.md).
//
// Semantics kept from the TPU kernel: particle columns are (x, z, ux, uy, uz,
// w) and y is not moved; coordinates are window-relative,
// X = (pos - lo)/dx - (t*tile - off), the new position X + v*dt/dx, both
// computed without FMA contraction (see fused_pic_common.cuh); the gather
// order is reduced by one on the Galerkin axes, where the axis names are
// (x, z), and order 0 is the half-open box [-1/2, 1/2); with no/nn the old
// and new shape weights on the window, sm = nn + no, df = no - nn and cs the
// running sum of df over the whole window row,
//   Jx[i,k] += wq/(dt*dz) * cs_x[i] * sm_z[k]/2,
//   Jz[i,k] += sm_x[i]/2 * wq/(dt*dx) * cs_z[k],
//   Jy[i,k] += wq*vy/(dx*dz) * (sm_x[i]*sm_z[k]/4 + df_x[i]*df_z[k]/12),
// all three in layout (x, z); a stencil row outside the window is dropped,
// and the running sum of a stencil clipped at the window's low side is
// carried to the window's end; every slot of an occupied tile is pushed, dead
// ones too (their weight is 0, so they deposit nothing); violations count
// alive particles whose deposit stencil start, start_index(x_new) - 1, leaves
// [0, W - order - 3] on either axis.  In moving-window mode the window of
// tile tz starts at tz*tile_z + zoff on the last axis of the padded field.
// A (species, tile) with no alive particle copies its five columns through
// and counts no violation (pallas_pic.py:485-498).
//
// Precision modes (the TPU kernel's mxu argument, kernel mode K1d;
// pallas_pic.py:57-69, 433-436, 483, 527-561, 604-626), a template parameter
// instantiated in every library: in 'mixed' and 'bf16' the six field boxes
// are staged in shared memory as bfloat16 (half the bytes of float32) and
// the z weight of the gather is rounded to bfloat16, the x weight is not.
// The deposit is four (x-side, z-side) products per point, as the TPU kernel
// stacks them:
//   Jx: (cs_x * wq/(dt*dz), sm_z/2)       Jz: (sm_x/2, cs_z * wq/(dt*dx))
//   Jy: ((wqvy/4) sm_x, sm_z) + ((wqvy/12) df_x, df_z),  wqvy = wq*vy/(dx*dz)
// each taken by mxu_mul (fused_pic_common.cuh): dot3x in 'mixed', both
// operands rounded to bfloat16 in 'bf16'.  The splines are formed without FMA
// contraction in the modes.

#include <climits>
#include <type_traits>

#include "fused_pic_common.cuh"

namespace {

// Threads a block and resident blocks asked of ptxas, chosen by measurement
// on the H100 (PERF.md): four blocks of 160 threads cap float32 at 96
// registers, the fewest at which orders 1 and 3 spill in no mode, and the
// more warps are resident the more of the shared atomics' latency they
// hide; order 2 ('mixed' spilled at 96) takes three, and float64, which
// runs only in the tests, the registers it needs.
constexpr int kThreads = 160;
template <typename T, int ORDER>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(T) == 8 ? 1 : ORDER == 2 ? 3 : 4;
}
// The box edge: uniform2d's window (order 3, one cell of margin), which a
// tile's particles reach at the laser-wakefield deck's W = 48 too.
constexpr int kBox = 24;
constexpr int kBox2 = kBox * kBox;

// Yee staggering in XZ: whether component c (Ex, Ey, Ez, Bx, By, Bz) sits at
// i + 1/2 on axis d.
__host__ __device__ constexpr bool yee_stag(int c, int d) {
  return d == 0 ? (c == 0 || c == 4 || c == 5) : (c == 2 || c == 3 || c == 4);
}

// Bytes of the staged field boxes, rounded up so the current boxes that
// follow them are aligned for either type.
template <typename G>
__host__ __device__ constexpr size_t staged_bytes() {
  return (6ull * kBox2 * sizeof(G) + 15) & ~size_t(15);
}
template <typename T, typename G>
__host__ __device__ constexpr size_t smem_bytes() {
  return staged_bytes<G>() + 3ull * kBox2 * sizeof(T);
}

__device__ __forceinline__ unsigned int bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned long long bits(double v) {
  return static_cast<unsigned long long>(__double_as_longlong(v));
}

// Dynamic shared memory: the six staged field boxes, then the three current
// boxes.  Static: the first dead slot's inputs and outputs.
extern __shared__ __align__(16) unsigned char smem_raw[];
__shared__ double s_ref_raw[11];

template <typename G>
__device__ __forceinline__ G* field_box() {
  return reinterpret_cast<G*>(smem_raw);
}
template <typename T, typename G>
__device__ __forceinline__ T* j_box() {
  return reinterpret_cast<T*>(smem_raw + staged_bytes<G>());
}

// Where the block's box lies in its window.
struct Box {
  int w;      // the window's edge W
  int b0[2];  // the box's origin, in window rows
  int bw;     // the box's edge: min(W, kBox)
  __device__ __forceinline__ bool holds(int rx, int rz) const {
    return static_cast<unsigned>(rx - b0[0]) < static_cast<unsigned>(bw) &&
           static_cast<unsigned>(rz - b0[1]) < static_cast<unsigned>(bw);
  }
  __device__ __forceinline__ int at(int rx, int rz) const {
    return (rx - b0[0]) * kBox + rz - b0[1];
  }
};

// One component of the gather from its staged box: sum over z taps, then x
// taps, from box rows (ix, iz) on.
template <int OX, int OZ, typename T, typename G>
__device__ __forceinline__ T gather_boxed(int c, int ix, int iz,
                                          const T (&wx)[OX + 1],
                                          const T (&wz)[OZ + 1]) {
  const G* F = field_box<G>() + c * kBox2 + ix * kBox + iz;
  T e = T(0);
#pragma unroll
  for (int ia = 0; ia <= OX; ++ia) {
    T h = T(0);
#pragma unroll
    for (int ic = 0; ic <= OZ; ++ic) {
      h += wz[ic] * static_cast<T>(staged(F[ia * kBox + ic]));
    }
    e += wx[ia] * h;
  }
  return e;
}

// The checked path of one gather component: the first design's loops, with
// runtime orders (ox, oz) and staggering (sx, sz); taps outside the window
// are dropped, a tap in the box is read there, any other from the padded
// field `f` (at the window's origin, row stride fs0), rounded as staged.
template <typename T, typename G, bool EXACT, bool ROUND_Z>
__device__ __noinline__ T gather_checked(const T* f, long long fs0, Box box,
                                         int c, T X0, T X1, int ox, int oz,
                                         bool sx, bool sz) {
  T wt[2][4];
  int i0[2];
  i0[0] = gather_weights<T, EXACT>(sx ? X0 - T(0.5) : X0, ox, wt[0]);
  i0[1] = gather_weights<T, EXACT>(sz ? X1 - T(0.5) : X1, oz, wt[1]);
  if (ROUND_Z) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wt[1][j] = bf16_round(wt[1][j]);
  }
  const G* F = field_box<G>() + c * kBox2;
  T e = T(0);
#pragma unroll
  for (int ia = 0; ia <= 3; ++ia) {
    const int rx = i0[0] + ia;
    if (ia > ox || rx < 0 || rx >= box.w) continue;
    T h = T(0);
#pragma unroll
    for (int ic = 0; ic <= 3; ++ic) {
      const int rz = i0[1] + ic;
      if (ic > oz || rz < 0 || rz >= box.w) continue;
      const T v =
          box.holds(rx, rz)
              ? static_cast<T>(staged(F[box.at(rx, rz)]))
              : static_cast<T>(staged(to_staged<G>(__ldg(f + rx * fs0 + rz))));
      h += wt[1][ic] * v;
    }
    e += wt[0][ia] * h;
  }
  return e;
}

// The checked path of the deposit: the first design's Esirkepov weights and
// loops, a stencil row outside the window dropped, the low-side carry; a
// point in the box is added there, any other by a global atomic to the
// block's own current windows jw.
template <typename T, typename G, int ORDER, int MXU>
__device__ __noinline__ void deposit_checked(T* jx, T* jy, T* jz, Box box,
                                             T X0, T X1, T xn0, T xn1, T sx,
                                             T sz, T wqvy) {
  constexpr int NT = ORDER + 3;
  constexpr bool EXACT = MXU != kMxuF32;
  const T X[2] = {X0, X1};
  const T xn[2] = {xn0, xn1};
  const int W = box.w;
  T sm[2][NT], df[2][NT], cs[2][NT];
  int j0[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    j0[d] = start_index(xn[d], ORDER) - 1;
    T acc = T(0);
#pragma unroll
    for (int r = 0; r < NT; ++r) {
      const int row_ = j0[d] + r;
      const bool in = row_ >= 0 && row_ < W;
      const T sn =
          in ? spline<T, EXACT>(xn[d] - static_cast<T>(row_), ORDER) : T(0);
      const T so =
          in ? spline<T, EXACT>(X[d] - static_cast<T>(row_), ORDER) : T(0);
      sm[d][r] = sn + so;
      df[d][r] = so - sn;
      acc += df[d][r];
      cs[d][r] = acc;
    }
  }
  T* jb = j_box<T, G>();
  T* const jg[3] = {jx, jy, jz};
  auto add = [&](int c, int rx, int rz, T v) {
    if (box.holds(rx, rz)) {
      atomicAdd(jb + c * kBox2 + box.at(rx, rz), v);
    } else {
      atomicAdd(jg[c] + rx * W + rz, v);
    }
  };
#pragma unroll
  for (int r = 0; r < NT; ++r) {
    const int rx = j0[0] + r;
    if (rx < 0 || rx >= W) continue;
    const T cx = cs[0][r] * sx;
    const T hx = T(0.5) * sm[0][r];
    const T ax = (T(0.25) * wqvy) * sm[0][r];
    const T bx = (T(1.0 / 12.0) * wqvy) * df[0][r];
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const int rz = j0[1] + kk;
      if (rz < 0 || rz >= W) continue;
      const T vx = mxu_mul<MXU>(cx, T(0.5) * sm[1][kk]);
      const T vz = mxu_mul<MXU>(hx, cs[1][kk] * sz);
      const T vyv = mxu_mul<MXU>(ax, sm[1][kk]) + mxu_mul<MXU>(bx, df[1][kk]);
      if (vx != T(0)) add(0, rx, rz, vx);
      if (vz != T(0)) add(2, rx, rz, vz);
      if (vyv != T(0)) add(1, rx, rz, vyv);
    }
  }
  // clipped at the window's low side: the running sum is carried on to the
  // window's end, as the TPU kernel's full-window cumsum
  if (j0[0] < 0) {
    const T cx = cs[0][NT - 1] * sx;
    for (int rx = max(j0[0] + NT, 0); rx < W && cx != T(0); ++rx) {
      for (int kk = 0; kk < NT; ++kk) {
        const int rz = j0[1] + kk;
        if (rz < 0 || rz >= W) continue;
        const T vx = mxu_mul<MXU>(cx, T(0.5) * sm[1][kk]);
        if (vx != T(0)) add(0, rx, rz, vx);
      }
    }
  }
  if (j0[1] < 0) {
    const T cz = cs[1][NT - 1] * sz;
    for (int rz = max(j0[1] + NT, 0); rz < W && cz != T(0); ++rz) {
      for (int r = 0; r < NT; ++r) {
        const int rx = j0[0] + r;
        if (rx < 0 || rx >= W) continue;
        const T vz = mxu_mul<MXU>(T(0.5) * sm[0][r], cz);
        if (vz != T(0)) add(2, rx, rz, vz);
      }
    }
  }
}

// The gather from the staged boxes: the nodal (N, full order) and
// staggered (S, order SO) weight sets of each axis, each computed once; the
// Yee table reads Ex (S, N), Ey (N, N), Ez (N, S), Bx (N, S), By (S, S),
// Bz (S, N).  Returns false, with e6 untouched, where a tap leaves the box.
template <int ORDER, int SO, bool EXACT, bool ROUND_Z, typename T, typename G>
__device__ __forceinline__ bool gather_sets(const Box& box, const T (&X)[2],
                                            const int (&iN)[2],
                                            const T (&wN)[2][ORDER + 1],
                                            T (&e6)[6]) {
  static_assert(yee_stag(0, 0) && !yee_stag(0, 1) && !yee_stag(1, 0) &&
                    !yee_stag(1, 1) && !yee_stag(2, 0) && yee_stag(2, 1) &&
                    !yee_stag(3, 0) && yee_stag(3, 1) && yee_stag(4, 0) &&
                    yee_stag(4, 1) && yee_stag(5, 0) && !yee_stag(5, 1),
                "gather_sets reads the Yee table");
  T wS[2][SO + 1];
  int iS[2];
  bool boxed = true;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    iS[d] = set_weights<T, EXACT, SO>(X[d] - T(0.5), wS[d]);
    const int lo = box.b0[d], hi = box.b0[d] + box.bw - 1;
    boxed = boxed && iN[d] >= lo && iN[d] + ORDER <= hi && iS[d] >= lo &&
            iS[d] + SO <= hi;
  }
  if (!boxed) return false;
  T wNz[ORDER + 1];
#pragma unroll
  for (int j = 0; j <= ORDER; ++j) {
    wNz[j] = ROUND_Z ? bf16_round(wN[1][j]) : wN[1][j];
  }
  if (ROUND_Z) {
#pragma unroll
    for (int j = 0; j <= SO; ++j) wS[1][j] = bf16_round(wS[1][j]);
  }
  const int nx = iN[0] - box.b0[0], nz = iN[1] - box.b0[1];
  const int sx = iS[0] - box.b0[0], sz = iS[1] - box.b0[1];
  e6[0] = gather_boxed<SO, ORDER, T, G>(0, sx, nz, wS[0], wNz);
  e6[1] = gather_boxed<ORDER, ORDER, T, G>(1, nx, nz, wN[0], wNz);
  e6[2] = gather_boxed<ORDER, SO, T, G>(2, nx, sz, wN[0], wS[1]);
  e6[3] = gather_boxed<ORDER, SO, T, G>(3, nx, sz, wN[0], wS[1]);
  e6[4] = gather_boxed<SO, SO, T, G>(4, sx, sz, wS[0], wS[1]);
  e6[5] = gather_boxed<SO, ORDER, T, G>(5, sx, nz, wS[0], wNz);
  return true;
}

// The launch's constants in the state's type, a kernel argument: they stay
// in the parameter space, where an instruction reads them as operands.
template <typename T>
struct K2Consts {
  T lo[2], inv_dx[2], dt_inv_dx[2], dt, invdtd[3];
};

// What a block holds for all its slots.
template <typename T>
struct TileConst {
  Box box;
  T worig[2];  // the window's origin, relative to the tiling origin lo
};

// The window's origin in the padded fields, and the block's current
// windows' offset in jw.
__device__ __forceinline__ long long field_origin(const FusedPicArgs& a) {
  const int t = blockIdx.x;
  const int t0 = t / a.tiles_per_dim[1];
  return static_cast<long long>(t0 * a.tile[0]) * a.fdim[1] +
         ((t - t0 * a.tiles_per_dim[1]) * a.tile[1] + a.zoff);
}
__device__ __forceinline__ long long j_origin(const FusedPicArgs& a) {
  return static_cast<long long>(blockIdx.x) * a.w * a.w;
}

// One slot: gather, push, the columns written, Esirkepov weights, violation,
// deposit.  REF: the slot is the first dead one, whose inputs and outputs
// go to s_ref_raw, then s_silent and s_ready.  Sets `wide` where a tap took
// the checked path.
template <typename T, int ORDER, int MXU, typename G>
__device__ __forceinline__ void push_slot(const FusedPicArgs& a,
                                          const K2Consts<T>& kc,
                                          const TileConst<T>& tk, int s,
                                          int galerkin, long long k,
                                          const T (&in_)[6], bool ref,
                                          int* s_viol, int* s_silent,
                                          int* s_ready, bool& wide) {
  constexpr int NT = ORDER + 3;  // Esirkepov taps per axis
  constexpr bool EXACT = MXU != kMxuF32;
  constexpr bool ROUND_Z = MXU != kMxuF32;
  const Box& box = tk.box;
  const T* prm = static_cast<const T*>(a.sp_params) + s * 8;
  const T q = prm[0];
  const T m = prm[1];
  const T dt = kc.dt;
  T* s_ref = reinterpret_cast<T*>(s_ref_raw);
  if (ref) {
#pragma unroll
    for (int c = 0; c < 6; ++c) s_ref[c] = in_[c];
  }
  T X[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    X[d] = sub_rn(mul_rn(sub_rn(in_[d], kc.lo[d]), kc.inv_dx[d]),
                  tk.worig[d]);
  }
  T ux = in_[2], uy = in_[3], uz = in_[4];

  // ---- the nodal sets (the deposit's old stencil too), then the gather
  T wN[2][ORDER + 1];
  int iN[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    iN[d] = set_weights<T, EXACT, ORDER>(X[d], wN[d]);
  }
  T e6[6];
  const bool boxed =
      galerkin
          ? gather_sets<ORDER, ORDER - 1, EXACT, ROUND_Z, T, G>(box, X, iN,
                                                                wN, e6)
          : gather_sets<ORDER, ORDER, EXACT, ROUND_Z, T, G>(box, X, iN, wN,
                                                            e6);
  if (!boxed) {
    wide = true;
    const int so = ORDER - galerkin;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const bool sx = yee_stag(c, 0), sz = yee_stag(c, 1);
      e6[c] = gather_checked<T, G, EXACT, ROUND_Z>(
          static_cast<const T*>(a.fields[c]) + field_origin(a), a.fdim[1],
          box, c, X[0], X[1], sx ? so : ORDER, sz ? so : ORDER, sx, sz);
    }
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) e6[c] = e6[c] + prm[2 + c];

  // ---- push
  // the pusher is uniform over the launch: a branch no warp diverges on
  if (a.pusher == 0) {
    push_boris(ux, uy, uz, e6[0], e6[1], e6[2], e6[3], e6[4], e6[5], q, m,
               dt);
  } else if (a.pusher == 1) {
    push_vay(ux, uy, uz, e6[0], e6[1], e6[2], e6[3], e6[4], e6[5], q, m, dt);
  } else {
    push_higuera(ux, uy, uz, e6[0], e6[1], e6[2], e6[3], e6[4], e6[5], q, m,
                 dt);
  }
  const T gaminv =
      T(1) / sqrt(T(1) + (ux * ux + uy * uy + uz * uz) * T(kInvC2));
  const T vy = uy * gaminv;
  const T vel[2] = {ux * gaminv, uz * gaminv};  // in-plane (x, z)
  {
    const T out_[5] = {in_[0] + vel[0] * dt, in_[1] + vel[1] * dt, ux, uy,
                       uz};
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      static_cast<T*>(a.out_parts[c])[k] = out_[c];
      if (ref) s_ref[6 + c] = out_[c];
    }
  }
  const T w = in_[5];
  const T wq = q * w;
  // a first dead slot that deposits or counts is copied by nobody
  if (ref) {
    *s_silent = wq == T(0) && !(w > T(0));
    __threadfence_block();
    *static_cast<volatile int*>(s_ready) = 1;
  }

  // ---- Esirkepov weights on the NT-row window of each axis: the new
  // stencil starts one row in, the old one (the nodal gather set) sh rows
  T xn[2];
  int j0[2], sh[2];
  bool bad = false;
  bool fast = true;
  T wn[2][ORDER + 1];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    xn[d] = add_rn(X[d], mul_rn(vel[d], kc.dt_inv_dx[d]));
    j0[d] = set_weights<T, EXACT, ORDER>(xn[d], wn[d]) - 1;
    sh[d] = iN[d] - j0[d];
    bad = bad || j0[d] < 0 || j0[d] > box.w - NT;
    fast = fast && sh[d] >= 0 && sh[d] <= 2 && j0[d] >= box.b0[d] &&
           j0[d] <= box.b0[d] + box.bw - NT;
  }
  if (bad && w > T(0)) atomicAdd(s_viol, 1);

  // ---- deposit (a dead slot has w = 0 and deposits nothing)
  if (wq == T(0)) return;
  const T sx = wq * kc.invdtd[0];
  const T sz = wq * kc.invdtd[1];
  const T wqvy = wq * (vy * kc.invdtd[2]);
  if (!fast) {
    wide = true;
    deposit_checked<T, G, ORDER, MXU>(
        static_cast<T*>(a.jw[0]) + j_origin(a),
        static_cast<T*>(a.jw[1]) + j_origin(a),
        static_cast<T*>(a.jw[2]) + j_origin(a), box, X[0], X[1], xn[0], xn[1],
        sx, sz, wqvy);
    return;
  }
  // the z side whole; the x side row by row, as the loop reaches it
  T smz[NT], dfz[NT], csz[NT];
  {
    T acc = T(0);
#pragma unroll
    for (int r = 0; r < NT; ++r) {
      const T sn = (r >= 1 && r <= ORDER + 1) ? wn[1][r - 1] : T(0);
      T so = T(0);
#pragma unroll
      for (int o = 0; o <= 2; ++o) {
        if (r - o >= 0 && r - o <= ORDER && sh[1] == o) so = wN[1][r - o];
      }
      smz[r] = sn + so;
      dfz[r] = so - sn;
      acc += dfz[r];
      csz[r] = acc;
    }
  }
  T* Jx = j_box<T, G>() + box.at(j0[0], j0[1]);
  T* Jy = Jx + kBox2;
  T* Jz = Jx + 2 * kBox2;
  // the x side's new and old weights on the NT rows, shifted out one row a
  // step; float64 keeps the row loop rolled (its registers would spill)
  T qn[NT], qo[NT];
#pragma unroll
  for (int r = 0; r < NT; ++r) {
    qn[r] = (r >= 1 && r <= ORDER + 1) ? wn[0][r - 1] : T(0);
    qo[r] = T(0);
#pragma unroll
    for (int o = 0; o <= 2; ++o) {
      if (r - o >= 0 && r - o <= ORDER && sh[0] == o) qo[r] = wN[0][r - o];
    }
  }
  constexpr int kRowUnroll = sizeof(T) == 8 ? 1 : NT;
  T accx = T(0);
#pragma unroll kRowUnroll
  for (int r = 0; r < NT; ++r) {
    const T sn = qn[0];
    const T so = qo[0];
#pragma unroll
    for (int m = 0; m + 1 < NT; ++m) {
      qn[m] = qn[m + 1];
      qo[m] = qo[m + 1];
    }
    const T smx = sn + so;
    const T dfx = so - sn;
    accx += dfx;
    const T cx = accx * sx;
    const T hx = T(0.5) * smx;
    const T ax = (T(0.25) * wqvy) * smx;
    const T bx = (T(1.0 / 12.0) * wqvy) * dfx;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const int at = r * kBox + kk;
      const T vx = mxu_mul<MXU>(cx, T(0.5) * smz[kk]);
      const T vz = mxu_mul<MXU>(hx, csz[kk] * sz);
      const T vyv = mxu_mul<MXU>(ax, smz[kk]) + mxu_mul<MXU>(bx, dfz[kk]);
      if (vx != T(0)) atomicAdd(Jx + at, vx);
      if (vz != T(0)) atomicAdd(Jz + at, vz);
      if (vyv != T(0)) atomicAdd(Jy + at, vyv);
    }
  }
}

template <typename T, int ORDER, int MXU>
__global__ void __launch_bounds__(kThreads, min_blocks<T, ORDER>())
fused_pic_2d_kernel(const FusedPicArgs a, const K2Consts<T> kc,
                    const int galerkin, int* wide_tiles) {
  using G = typename std::conditional<MXU == kMxuF32, T, __nv_bfloat16>::type;
  constexpr int NT = ORDER + 3;
  __shared__ int s_viol, s_wide, s_silent, s_ready;
  __shared__ int s_lo[2], s_hi[2];

  const int t = blockIdx.x;
  const int W = a.w;
  const int P = a.p_max;
  const int W2 = W * W;
  const int ntz = a.tiles_per_dim[1];
  const int t0 = t / ntz;
  const int t1 = t - t0 * ntz;
  // window origin in grid coordinates, relative to the tiling origin lo
  const int g0[2] = {t0 * a.tile[0], t1 * a.tile[1]};
  TileConst<T> tk;
#pragma unroll
  for (int d = 0; d < 2; ++d) tk.worig[d] = static_cast<T>(g0[d] - a.off);
  const long long jbase = j_origin(a);

  bool any = false;
  for (int s = 0; s < a.n_sp; ++s) any = any || a.counts[s * a.n_tiles + t] > 0;
  if (!any) {
    // no alive particle in any species: copy the columns, write zero J
    for (int s = 0; s < a.n_sp; ++s) {
      const long long base = (static_cast<long long>(s) * a.n_tiles + t) * P;
      for (int c = 0; c < 5; ++c) {
        const T* src = static_cast<const T*>(a.parts[c]) + base;
        T* dst = static_cast<T*>(a.out_parts[c]) + base;
        for (int p = threadIdx.x; p < P; p += kThreads) dst[p] = src[p];
      }
      if (threadIdx.x == 0) a.viol[s * a.n_tiles + t] = 0;
    }
    for (int i = threadIdx.x; i < 3 * W2; i += kThreads) {
      const int c = i / W2;
      static_cast<T*>(a.jw[c])[jbase + i - c * W2] = T(0);
    }
    return;
  }

  // ---- the rows the alive slots reach (stencil start +- 1 cell of
  // drift) place the box; a window no wider than the box is the box
  tk.box.w = W;
  tk.box.bw = min(W, kBox);
  tk.box.b0[0] = tk.box.b0[1] = 0;
  if (threadIdx.x == 0) s_wide = 0;
  if (W > kBox) {
    if (threadIdx.x < 2) {
      s_lo[threadIdx.x] = INT_MAX;
      s_hi[threadIdx.x] = INT_MIN;
    }
    __syncthreads();
    int rlo[2] = {INT_MAX, INT_MAX}, rhi[2] = {INT_MIN, INT_MIN};
    for (int s = 0; s < a.n_sp; ++s) {
      const long long base = (static_cast<long long>(s) * a.n_tiles + t) * P;
      const int cnt = a.counts[s * a.n_tiles + t];
      for (int p = threadIdx.x; p < cnt; p += kThreads) {
        if (static_cast<const T*>(a.parts[5])[base + p] == T(0)) continue;
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const T pos = static_cast<const T*>(a.parts[d])[base + p];
          const T X = sub_rn(mul_rn(sub_rn(pos, kc.lo[d]), kc.inv_dx[d]),
                             tk.worig[d]);
          const int st = start_index(X, ORDER);
          rlo[d] = min(rlo[d], st - 2);
          rhi[d] = max(rhi[d], st + NT - 1);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      rlo[d] = __reduce_min_sync(0xffffffffu, rlo[d]);
      rhi[d] = __reduce_max_sync(0xffffffffu, rhi[d]);
    }
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        atomicMin(&s_lo[d], rlo[d]);
        atomicMax(&s_hi[d], rhi[d]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      // every reached row when they fit; else the box centred on the tile
      const bool fits = s_lo[d] <= s_hi[d] && s_hi[d] - s_lo[d] < kBox;
      const int want = fits ? s_lo[d] : a.off + a.tile[d] / 2 - kBox / 2;
      tk.box.b0[d] = min(max(want, 0), W - kBox);
    }
  }

  // ---- stage the fields in the box, zero the currents
  const int bw = tk.box.bw, bw2 = bw * bw;
  {
    G* fbox = field_box<G>();
    const long long fs0 = a.fdim[1];
    const long long borig =
        field_origin(a) + tk.box.b0[0] * fs0 + tk.box.b0[1];
    for (int i = threadIdx.x; i < 6 * bw2; i += kThreads) {
      const int c = i / bw2;
      const int rem = i - c * bw2;
      const int r = rem / bw;
      const int kz = rem - r * bw;
      fbox[c * kBox2 + r * kBox + kz] = to_staged<G>(
          __ldg(static_cast<const T*>(a.fields[c]) + borig + r * fs0 + kz));
    }
    T* jbox = j_box<T, G>();
    for (int i = threadIdx.x; i < 3 * kBox2; i += kThreads) jbox[i] = T(0);
    if (bw < W) {
      // the window outside the box takes global atomics: zero it first
      for (int i = threadIdx.x; i < 3 * W2; i += kThreads) {
        const int c = i / W2;
        const int rem = i - c * W2;
        if (!tk.box.holds(rem / W, rem % W)) {
          static_cast<T*>(a.jw[c])[jbase + rem] = T(0);
        }
      }
    }
  }

  bool wide = false;
  const T* s_ref = reinterpret_cast<const T*>(s_ref_raw);
  for (int s = 0; s < a.n_sp; ++s) {
    const long long row = static_cast<long long>(s) * a.n_tiles + t;
    const long long base = row * P;
    const int cnt = a.counts[row];
    if (threadIdx.x == 0) {
      s_viol = 0;
      s_silent = 0;
      s_ready = 0;
    }
    __syncthreads();  // also orders the staging above before the first use
    if (cnt == 0) {
      for (int c = 0; c < 5; ++c) {
        const T* src = static_cast<const T*>(a.parts[c]) + base;
        T* dst = static_cast<T*>(a.out_parts[c]) + base;
        for (int p = threadIdx.x; p < P; p += kThreads) dst[p] = src[p];
      }
    } else {
      // item 0 is the first dead slot (slot cnt), which thread 0 pushes
      // first; items 1..cnt are the alive slots; each later dead slot takes
      // slot cnt's outputs where its inputs are bitwise slot cnt's, once
      // thread 0 has published them (s_ready): no barrier splits the loop
      const bool has_ref = cnt < P;
      for (int i = threadIdx.x; i < P; i += kThreads) {
        const int p = !has_ref ? i : i == 0 ? cnt : i <= cnt ? i - 1 : i;
        const long long k = base + p;
        T in_[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          in_[c] = static_cast<const T*>(a.parts[c])[k];
        }
        if (has_ref && i > cnt) {
          while (!*static_cast<volatile int*>(&s_ready)) {
          }
          __threadfence_block();
          if (s_silent) {
            bool same = true;
#pragma unroll
            for (int c = 0; c < 6; ++c) {
              same = same && bits(in_[c]) == bits(s_ref[c]);
            }
            if (same) {
#pragma unroll
              for (int c = 0; c < 5; ++c) {
                static_cast<T*>(a.out_parts[c])[k] = s_ref[6 + c];
              }
              continue;
            }
          }
        }
        push_slot<T, ORDER, MXU, G>(a, kc, tk, s, galerkin, k, in_,
                                    has_ref && i == 0, &s_viol, &s_silent,
                                    &s_ready, wide);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) a.viol[row] = cnt > 0 ? s_viol : 0;
  }
  if (wide) s_wide = 1;

  __syncthreads();
  const T* jbox = j_box<T, G>();
  for (int i = threadIdx.x; i < 3 * bw2; i += kThreads) {
    const int c = i / bw2;
    const int rem = i - c * bw2;
    const int r = rem / bw;
    const int kz = rem - r * bw;
    static_cast<T*>(a.jw[c])[jbase + (tk.box.b0[0] + r) * W +
                             tk.box.b0[1] + kz] =
        jbox[c * kBox2 + r * kBox + kz];
  }
  if (threadIdx.x == 0 && s_wide) atomicAdd(wide_tiles, 1);
}

template <typename T, int O, int MX>
int launch_2d(const FusedPicArgs& a, int galerkin, int* wide, cudaStream_t st) {
  using G = typename std::conditional<MX == kMxuF32, T, __nv_bfloat16>::type;
  constexpr size_t smem = smem_bytes<T, G>();
  auto kern = fused_pic_2d_kernel<T, O, MX>;
  // dynamic shared memory beyond the default 48 KB (static included) needs
  // the opt-in, so always ask for it
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return kStageSetSmem * 1000 + static_cast<int>(e);
  K2Consts<T> kc;
  for (int d = 0; d < 2; ++d) {
    kc.lo[d] = static_cast<T>(a.lo[d]);
    kc.inv_dx[d] = static_cast<T>(a.inv_dx[d]);
    kc.dt_inv_dx[d] = static_cast<T>(a.dt_inv_dx[d]);
  }
  kc.dt = static_cast<T>(a.dt);
  for (int c = 0; c < 3; ++c) kc.invdtd[c] = static_cast<T>(a.invdtd[c]);
  kern<<<a.n_tiles, kThreads, smem, st>>>(a, kc, galerkin, wide);
  e = cudaGetLastError();
  return e == cudaSuccess ? 0 : kStageLaunch * 1000 + static_cast<int>(e);
}

template <typename T, int O, int MX>
int blocks_2d() {
  using G = typename std::conditional<MX == kMxuF32, T, __nv_bfloat16>::type;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, fused_pic_2d_kernel<T, O, MX>, kThreads, smem_bytes<T, G>());
  return e == cudaSuccess ? n : -(kStageAttr * 1000 + static_cast<int>(e));
}

}  // namespace

// One library per (type, order): FP_REAL and FP_ORDER are set on the nvcc
// command line (warpx_tpu_torch/build.py), so the builds run in parallel;
// each holds the three precision modes.  The pusher and `galerkin` (the
// Yee gather table with Galerkin on or off) are kernel arguments, uniform
// over the launch.  `wide` is a device counter that each tile which took
// the checked path adds one to.
extern "C" int fused_pic_2d_launch(const FusedPicArgs* a, int galerkin,
                                   int* wide, void* stream) {
  if (a->n_tiles <= 0) return 0;
  if (a->order != FP_ORDER || a->pusher < 0 || a->pusher > 2 ||
      (galerkin != 0 && galerkin != 1)) {
    return kStageArgs * 1000 + static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a->mxu) {
    case kMxuF32:
      return launch_2d<FP_REAL, FP_ORDER, kMxuF32>(*a, galerkin, wide, st);
    case kMxuMixed:
      return launch_2d<FP_REAL, FP_ORDER, kMxuMixed>(*a, galerkin, wide, st);
    case kMxuBf16:
      return launch_2d<FP_REAL, FP_ORDER, kMxuBf16>(*a, galerkin, wide, st);
    default:
      return kStageArgs * 1000 + static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident blocks per SM of the kernel in precision mode `mxu`
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); a negative value is an
// error code.
extern "C" int fused_pic_2d_blocks_per_sm(int mxu) {
  switch (mxu) {
    case kMxuF32: return blocks_2d<FP_REAL, FP_ORDER, kMxuF32>();
    case kMxuMixed: return blocks_2d<FP_REAL, FP_ORDER, kMxuMixed>();
    case kMxuBf16: return blocks_2d<FP_REAL, FP_ORDER, kMxuBf16>();
    default:
      return -(kStageArgs * 1000 + static_cast<int>(cudaErrorInvalidValue));
  }
}

extern "C" const char* fused_pic_2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code % 1000));
}
