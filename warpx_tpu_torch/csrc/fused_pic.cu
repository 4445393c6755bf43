// Kernel K1: fused field gather + momentum push + Esirkepov current deposit
// over the tile-binned particle layout (3D; periodic, or anchored tiles under
// a moving window).
//
// Replaces warpx_tpu/ops/pallas_pic.py::binned_push_deposit -> _build_kernel
// (the Pallas TPU kernel).  That kernel turns every per-particle shape weight
// into a dense (W, p_max) band matrix so the gather and the deposit become
// MXU contractions over the tile window.  Here the same arithmetic is done
// by per-particle index arithmetic on the (order+1)- or (order+3)-point
// stencils, as the reference's shared-memory binned deposition does
// (WarpXParticleContainer.cpp:490-548; CurrentDeposition.H:643-900).
//
// Bound on the card: bytes.  Per slot the kernel must read 7 particle values
// and write 6, and per tile it writes three W^3 current windows; at order 1 the
// arithmetic is about 1.2 kFLOP per slot, under the float32 rate's share of
// those bytes.  Design:
//   * one block per tile; the block loops over the species of the launch (the
//     TPU kernel's sequential species grid axis) and its threads stride over
//     the p_max slots, neighbouring threads on neighbouring slots, so the
//     particle reads and writes are coalesced;
//   * a (species, tile) with no alive particle copies its slots through and
//     counts no violation (pallas_pic.py:213-225);
//   * the field stencil is read straight from the guard-padded fields
//     (pad_fields), whose window for tile t starts at t*tile: the taps of
//     the particles of one tile fall in one W^3 box, which stays in L1/L2;
//   * J accumulates with atomicAdd into three W^3 windows in shared memory,
//     written once per tile in the layouts fold_windows expects: (x,(y,z)),
//     (y,(x,z)), (z,(x,y)).  When 3*W^3 values do not fit a block's shared
//     memory (float64 with W = 24) the atomics go to the block's own tile
//     window in device memory instead, which no other block touches.
//
// Precision modes (the TPU kernel's mxu argument, kernel mode K1d;
// pallas_pic.py:57-69, 133-136, 268-306, 363-390), a template parameter
// instantiated in every library: in 'mixed' and 'bf16' each field value and
// each transverse weight bf16(wy*wz) of the gather is rounded to bfloat16, the
// x weight is not; the deposit's point value is dot3x(cs*scale, 1/4 sa sb +
// 1/12 da db) in 'mixed' and bf16(cs*scale/4) bf16(sa sb) + bf16(cs*scale/12)
// bf16(da db) in 'bf16' (fused_pic_common.cuh).  The field values are
// rounded as they are loaded (the fields are not staged in shared memory);
// the splines and every rounded operand are formed without FMA contraction.
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
// end, which matters only for a particle clipped at the window's low side;
// every slot of an occupied tile is pushed, dead ones too (their weight is 0,
// so they deposit nothing); violations count alive particles whose deposit
// stencil start, start_index(x_new) - 1, leaves [0, W - order - 3].

#include "fused_pic_common.cuh"

namespace {

constexpr int kThreads = 256;

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

template <typename T, int ORDER, bool SMEM, int MXU>
__global__ void __launch_bounds__(kThreads)
fused_pic_kernel(const FusedPicArgs a) {
  constexpr int NT = ORDER + 3;  // Esirkepov taps per axis
  constexpr bool EXACT = MXU != kMxuF32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_viol;

  const int t = blockIdx.x;
  const int W = a.w;
  const int P = a.p_max;
  const int W3 = W * W * W;
  const int nty = a.tiles_per_dim[1];
  const int ntz = a.tiles_per_dim[2];
  const int t0 = t / (nty * ntz);
  const int t1 = (t / ntz) % nty;
  const int t2 = t % ntz;
  // window origin in grid coordinates (relative to the tiling origin lo),
  // and in padded-field coordinates: in moving-window mode the window has
  // slid zoff = smax - zshift cells along the last field axis
  const int g0[3] = {t0 * a.tile[0], t1 * a.tile[1], t2 * a.tile[2]};
  const int f0[3] = {g0[0], g0[1], g0[2] + a.zoff};
  T worig[3];
  T lo[3], inv_dx[3], dt_inv_dx[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    worig[d] = static_cast<T>(g0[d] - a.off);
    lo[d] = static_cast<T>(a.lo[d]);
    inv_dx[d] = static_cast<T>(a.inv_dx[d]);
    dt_inv_dx[d] = static_cast<T>(a.dt_inv_dx[d]);
  }
  const T dt = static_cast<T>(a.dt);
  const long long fs1 = a.fdim[2];
  const long long fs0 = static_cast<long long>(a.fdim[1]) * a.fdim[2];

  T* J[3];
  if (SMEM) {
    T* s = reinterpret_cast<T*>(smem_raw);
    for (int i = threadIdx.x; i < 3 * W3; i += kThreads) s[i] = T(0);
    J[0] = s;
    J[1] = s + W3;
    J[2] = s + 2 * W3;
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      J[c] = static_cast<T*>(a.jw[c]) + static_cast<long long>(t) * W3;
      for (int i = threadIdx.x; i < W3; i += kThreads) J[c][i] = T(0);
    }
  }

  const T* F[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) F[c] = static_cast<const T*>(a.fields[c]);
  const T* prm = static_cast<const T*>(a.sp_params);

  for (int s = 0; s < a.n_sp; ++s) {
    const long long row = static_cast<long long>(s) * a.n_tiles + t;
    const long long base = row * P;
    if (threadIdx.x == 0) s_viol = 0;
    __syncthreads();
    const bool occupied = a.counts[row] > 0;
    if (!occupied) {
      for (int c = 0; c < 6; ++c) {
        const T* src = static_cast<const T*>(a.parts[c]) + base;
        T* dst = static_cast<T*>(a.out_parts[c]) + base;
        for (int p = threadIdx.x; p < P; p += kThreads) dst[p] = src[p];
      }
    } else {
      const T q = prm[s * 8 + 0];
      const T m = prm[s * 8 + 1];
      for (int p = threadIdx.x; p < P; p += kThreads) {
        const long long k = base + p;
        T pos[3], X[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          pos[d] = static_cast<const T*>(a.parts[d])[k];
          X[d] = sub_rn(mul_rn(sub_rn(pos[d], lo[d]), inv_dx[d]), worig[d]);
        }
        T ux = static_cast<const T*>(a.parts[3])[k];
        T uy = static_cast<const T*>(a.parts[4])[k];
        T uz = static_cast<const T*>(a.parts[5])[k];
        const T w = static_cast<const T*>(a.parts[6])[k];

        // ---- gather: sum over the stencil of (wy*wz) * F, then times wx
        T e6[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          T wt[3][4];
          int i0[3];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const T xc = a.gstag[c * 3 + d] ? X[d] - T(0.5) : X[d];
            i0[d] = gather_weights<T, EXACT>(xc, a.gorder[c * 3 + d], wt[d]);
          }
          T e = T(0);
#pragma unroll
          for (int ia = 0; ia <= ORDER; ++ia) {
            const int rx = i0[0] + ia;
            if (ia > a.gorder[c * 3 + 0] || rx < 0 || rx >= W) continue;
            T h = T(0);
#pragma unroll
            for (int ib = 0; ib <= ORDER; ++ib) {
              const int ry = i0[1] + ib;
              if (ib > a.gorder[c * 3 + 1] || ry < 0 || ry >= W) continue;
#pragma unroll
              for (int ic = 0; ic <= ORDER; ++ic) {
                const int rz = i0[2] + ic;
                if (ic > a.gorder[c * 3 + 2] || rz < 0 || rz >= W) continue;
                const long long fi = (f0[0] + rx) * fs0 + (f0[1] + ry) * fs1 +
                                     (f0[2] + rz);
                if (MXU == kMxuF32) {
                  h += (wt[1][ib] * wt[2][ic]) * __ldg(F[c] + fi);
                } else {
                  h += bf16_round(mul_rn(wt[1][ib], wt[2][ic])) *
                       bf16_round(__ldg(F[c] + fi));
                }
              }
            }
            e += wt[0][ia] * h;
          }
          e6[c] = e + prm[s * 8 + 2 + c];
        }

        // ---- push
        // the pusher is uniform over the launch: a branch no warp diverges on
        if (a.pusher == 0) {
          push_boris(ux, uy, uz, e6[0], e6[1], e6[2], e6[3], e6[4], e6[5], q,
                     m, dt);
        } else if (a.pusher == 1) {
          push_vay(ux, uy, uz, e6[0], e6[1], e6[2], e6[3], e6[4], e6[5], q, m,
                   dt);
        } else {
          push_higuera(ux, uy, uz, e6[0], e6[1], e6[2], e6[3], e6[4], e6[5],
                       q, m, dt);
        }
        const T gaminv = T(1) / sqrt(T(1) + (ux * ux + uy * uy + uz * uz) *
                                                T(kInvC2));
        const T vel[3] = {ux * gaminv, uy * gaminv, uz * gaminv};
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          static_cast<T*>(a.out_parts[d])[k] = pos[d] + vel[d] * dt;
        }
        static_cast<T*>(a.out_parts[3])[k] = ux;
        static_cast<T*>(a.out_parts[4])[k] = uy;
        static_cast<T*>(a.out_parts[5])[k] = uz;

        // ---- Esirkepov weights on the NT-row window of each axis
        const T wq = q * w;
        T sm[3][NT], df[3][NT], cs[3][NT];
        int j0[3];
        bool bad = false;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const T xn = add_rn(X[d], mul_rn(vel[d], dt_inv_dx[d]));
          j0[d] = start_index(xn, ORDER) - 1;
          bad = bad || j0[d] < 0 || j0[d] > W - NT;
          T acc = T(0);
#pragma unroll
          for (int r = 0; r < NT; ++r) {
            const int row_ = j0[d] + r;
            const bool in = row_ >= 0 && row_ < W;
            const T sn =
                in ? spline<T, EXACT>(xn - static_cast<T>(row_), ORDER) : T(0);
            const T so =
                in ? spline<T, EXACT>(X[d] - static_cast<T>(row_), ORDER) : T(0);
            sm[d][r] = sn + so;
            df[d][r] = so - sn;
            acc += df[d][r];
            cs[d][r] = acc;
          }
        }
        if (bad && w > T(0)) atomicAdd(&s_viol, 1);

        // ---- deposit: J_d[row, ra, rb] += cs_d * (wq*invdtd_d)
        //      * (1/4 sm_a sm_b + 1/12 df_a df_b)
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const int da = d == 0 ? 1 : 0;
          const int db = d == 2 ? 1 : 2;
          const T scale = wq * static_cast<T>(a.invdtd[d]);
          T* Jd = J[d];
#pragma unroll
          for (int r = 0; r < NT; ++r) {
            const int row_ = j0[d] + r;
            if (row_ < 0 || row_ >= W) continue;
            const T cval = cs[d][r] * scale;
            if (cval == T(0)) continue;
#pragma unroll
            for (int ja = 0; ja < NT; ++ja) {
              const int ra = j0[da] + ja;
              if (ra < 0 || ra >= W) continue;
#pragma unroll
              for (int jb = 0; jb < NT; ++jb) {
                const int rb = j0[db] + jb;
                if (rb < 0 || rb >= W) continue;
                const T v = esirkepov_point<MXU>(cval, sm[da][ja], sm[db][jb],
                                                 df[da][ja], df[db][jb]);
                if (v != T(0)) atomicAdd(Jd + (row_ * W + ra) * W + rb, v);
              }
            }
          }
          if (j0[d] < 0) {
            // clipped at the window's low side: the running sum is carried
            // on to the window's end, as the TPU kernel's full-window cumsum
            const T cval = cs[d][NT - 1] * scale;
            for (int row_ = max(j0[d] + NT, 0); row_ < W && cval != T(0);
                 ++row_) {
              for (int ja = 0; ja < NT; ++ja) {
                const int ra = j0[da] + ja;
                if (ra < 0 || ra >= W) continue;
                for (int jb = 0; jb < NT; ++jb) {
                  const int rb = j0[db] + jb;
                  if (rb < 0 || rb >= W) continue;
                  const T v = esirkepov_point<MXU>(cval, sm[da][ja], sm[db][jb],
                                                   df[da][ja], df[db][jb]);
                  if (v != T(0)) atomicAdd(Jd + (row_ * W + ra) * W + rb, v);
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) a.viol[row] = occupied ? s_viol : 0;
  }

  if (SMEM) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T* dst = static_cast<T*>(a.jw[c]) + static_cast<long long>(t) * W3;
      for (int i = threadIdx.x; i < W3; i += kThreads) dst[i] = J[c][i];
    }
  }
}

template <typename T, int O, bool SM, int MX>
int launch_one(const FusedPicArgs& a, cudaStream_t st) {
  const size_t smem = SM ? 3ull * a.w * a.w * a.w * sizeof(T) : 0;
  auto kern = fused_pic_kernel<T, O, SM, MX>;
  if (SM) {
    // dynamic shared memory beyond the default 48 KB (static included)
    // needs the opt-in, so always ask for it
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return kStageSetSmem * 1000 + static_cast<int>(e);
  }
  kern<<<a.n_tiles, kThreads, smem, st>>>(a);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : kStageLaunch * 1000 + static_cast<int>(e);
}

template <typename T, int O, int MX>
int launch_smem(const FusedPicArgs& a, cudaStream_t st) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  }
  if (e != cudaSuccess) return kStageAttr * 1000 + static_cast<int>(e);
  // the static s_viol counter shares the block's budget
  const size_t need = 3ull * a.w * a.w * a.w * sizeof(T) + 64;
  return need <= static_cast<size_t>(optin)
             ? launch_one<T, O, true, MX>(a, st)
             : launch_one<T, O, false, MX>(a, st);
}

}  // namespace

// One library per (type, order): FP_REAL and FP_ORDER are set on the nvcc
// command line (warpx_tpu_torch/build.py), so the builds run in parallel;
// each holds the three precision modes.  The pusher is a kernel argument:
// as a template parameter too, its nine instantiations per library tripled
// the build.
extern "C" int fused_pic_launch(const FusedPicArgs* a, void* stream) {
  if (a->n_tiles <= 0) return 0;
  if (a->order != FP_ORDER || a->pusher < 0 || a->pusher > 2) {
    return kStageArgs * 1000 + static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a->mxu) {
    case kMxuF32: return launch_smem<FP_REAL, FP_ORDER, kMxuF32>(*a, st);
    case kMxuMixed: return launch_smem<FP_REAL, FP_ORDER, kMxuMixed>(*a, st);
    case kMxuBf16: return launch_smem<FP_REAL, FP_ORDER, kMxuBf16>(*a, st);
    default:
      return kStageArgs * 1000 + static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fused_pic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code % 1000));
}
