// Kernel K1: fused field gather + momentum push + Esirkepov current deposit
// over the tile-binned particle layout (3D, periodic).
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
// Semantics kept from the TPU kernel: coordinates are window-relative,
// X = (pos - lo)/dx - (t*tile - off); the new position is X + v*dt/dx; a
// stencil row outside the window is dropped; the gather's order-0 shape (the
// Galerkin reduced order of order 1) is the half-open box [-1/2, 1/2); the
// Esirkepov running sum along the deposit axis is carried to the window's
// end, which matters only for a particle clipped at the window's low side;
// every slot of an occupied tile is pushed, dead ones too (their weight is 0,
// so they deposit nothing); violations count alive particles whose deposit
// stencil start, start_index(x_new) - 1, leaves [0, W - order - 3].

#include <cuda_runtime.h>

// Must match warpx_tpu_torch/ops/fused_pic.py::_FusedPicArgs field by field.
struct FusedPicArgs {
  const void* fields[6];  // guard-padded Ex, Ey, Ez, Bx, By, Bz
  const void* parts[7];   // x, y, z, ux, uy, uz, w: (n_sp * n_tiles, p_max)
  void* out_parts[6];     // x, y, z, ux, uy, uz
  void* jw[3];            // (n_tiles, W, W*W) each
  int* viol;              // (n_sp * n_tiles)
  const int* counts;      // alive particles per (species, tile)
  const void* sp_params;  // (n_sp, 8): q, m, Eext(3), Bext(3)
  int n_sp, n_tiles, p_max, w, off;
  int tiles_per_dim[3];
  int tile[3];
  int fdim[3];            // padded field extents
  int order, pusher;
  int gorder[18];         // gather shape order per (component, axis)
  int gstag[18];          // 1 where the component sits at i + 1/2 on the axis
  double lo[3];
  double inv_dx[3];
  double dt_inv_dx[3];
  double invdtd[3];       // 1 / (dt * dx_a * dx_b) per current component
  double dt;
};

namespace {

constexpr int kThreads = 256;
constexpr double kC = 299792458.0;
constexpr double kInvC2 = 1.0 / (kC * kC);

// Correctly rounded add, multiply and subtract, never contracted into an
// FMA.  The window coordinates X and x_new must carry the same bits as the
// plain version's: the order-0 (box) gather of a particle within an ulp of a
// half-integer would otherwise pick the neighbouring node, and the current
// is a difference of shape factors over a drift of a few thousandths of a
// cell, which an ulp of x_new (2^-20 cells in float32 at W = 16) perturbs by
// a part in 10^4.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T spline(T xi, int order) {
  const T t = fabs(xi);
  if (order == 1) return t < T(1) ? T(1) - t : T(0);
  if (order == 2) {
    if (t <= T(0.5)) return T(0.75) - t * t;
    if (t < T(1.5)) {
      const T u = T(1.5) - t;
      return T(0.5) * (u * u);
    }
    return T(0);
  }
  // order 3
  if (t <= T(1)) return T(2.0 / 3.0) - t * t * (T(1) - T(0.5) * t);
  if (t < T(2)) {
    const T u = T(2) - t;
    return u * u * u / T(6);
  }
  return T(0);
}

template <typename T>
__device__ __forceinline__ int start_index(T x, int order) {
  const T base = (order % 2 == 0) ? floor(x + T(0.5)) : floor(x);
  return static_cast<int>(base) - order / 2;
}

// Gather weights of shape order o (0..3) at grid coordinate xc; returns the
// first row.  Order 0 is the half-open box [-1/2, 1/2) of the TPU kernel.
template <typename T>
__device__ __forceinline__ int gather_weights(T xc, int o, T (&wt)[4]) {
  if (o == 0) {
    int i = static_cast<int>(floor(xc + T(0.5)));
    const T xi = xc - static_cast<T>(i);
    if (xi < T(-0.5)) {
      i -= 1;
    } else if (xi >= T(0.5)) {
      i += 1;
    }
    wt[0] = T(1);
    wt[1] = wt[2] = wt[3] = T(0);
    return i;
  }
  const int i0 = start_index(xc, o);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    wt[m] = (m <= o) ? spline(xc - static_cast<T>(i0 + m), o) : T(0);
  }
  return i0;
}

template <typename T>
__device__ __forceinline__ T inv_gamma(T ux, T uy, T uz) {
  return T(1) / sqrt(T(1) + (ux * ux + uy * uy + uz * uz) * T(kInvC2));
}

// The pushers repeat warpx_tpu_torch/ops/push.py term for term.
template <typename T>
__device__ __forceinline__ void push_boris(T& ux, T& uy, T& uz, T Ex, T Ey,
                                           T Ez, T Bx, T By, T Bz, T q, T m,
                                           T dt) {
  const T econst = T(0.5) * q * dt / m;
  ux = ux + econst * Ex;
  uy = uy + econst * Ey;
  uz = uz + econst * Ez;
  const T invg = inv_gamma(ux, uy, uz);
  const T tx = econst * invg * Bx;
  const T ty = econst * invg * By;
  const T tz = econst * invg * Bz;
  const T tsqi = T(2) / (T(1) + tx * tx + ty * ty + tz * tz);
  const T sx = tx * tsqi;
  const T sy = ty * tsqi;
  const T sz = tz * tsqi;
  const T uxp = ux + uy * tz - uz * ty;
  const T uyp = uy + uz * tx - ux * tz;
  const T uzp = uz + ux * ty - uy * tx;
  ux = ux + uyp * sz - uzp * sy;
  uy = uy + uzp * sx - uxp * sz;
  uz = uz + uxp * sy - uyp * sx;
  ux = ux + econst * Ex;
  uy = uy + econst * Ey;
  uz = uz + econst * Ez;
}

template <typename T>
__device__ __forceinline__ void push_vay(T& ux, T& uy, T& uz, T Ex, T Ey,
                                         T Ez, T Bx, T By, T Bz, T q, T m,
                                         T dt) {
  const T econst = q * dt / m;
  const T bconst = T(0.5) * q * dt / m;
  const T invg = inv_gamma(ux, uy, uz);
  const T taux = bconst * Bx;
  const T tauy = bconst * By;
  const T tauz = bconst * Bz;
  const T uxh = ux + econst * Ex + invg * (uy * tauz - uz * tauy);
  const T uyh = uy + econst * Ey + invg * (uz * taux - ux * tauz);
  const T uzh = uz + econst * Ez + invg * (ux * tauy - uy * taux);
  const T tausq = taux * taux + tauy * tauy + tauz * tauz;
  const T ust = (uxh * taux + uyh * tauy + uzh * tauz) / T(kC);
  const T gprsq = T(1) + (uxh * uxh + uyh * uyh + uzh * uzh) * T(kInvC2);
  const T sigma = gprsq - tausq;
  const T invgp = sqrt(
      T(2) / (sigma + sqrt(sigma * sigma + T(4) * (tausq + ust * ust))));
  const T tx = taux * invgp;
  const T ty = tauy * invgp;
  const T tz = tauz * invgp;
  const T s = T(1) / (T(1) + tausq * invgp * invgp);
  const T ut = uxh * tx + uyh * ty + uzh * tz;
  ux = s * (uxh + ut * tx + uyh * tz - uzh * ty);
  uy = s * (uyh + ut * ty + uzh * tx - uxh * tz);
  uz = s * (uzh + ut * tz + uxh * ty - uyh * tx);
}

template <typename T>
__device__ __forceinline__ void push_higuera(T& ux, T& uy, T& uz, T Ex, T Ey,
                                             T Ez, T Bx, T By, T Bz, T q,
                                             T m, T dt) {
  const T qmt = T(0.5) * q * dt / m;
  const T umx = ux + qmt * Ex;
  const T umy = uy + qmt * Ey;
  const T umz = uz + qmt * Ez;
  const T gsq = T(1) + (umx * umx + umy * umy + umz * umz) * T(kInvC2);
  const T betax = qmt * Bx;
  const T betay = qmt * By;
  const T betaz = qmt * Bz;
  const T betam = betax * betax + betay * betay + betaz * betaz;
  const T sigma = gsq - betam;
  const T ust = (umx * betax + umy * betay + umz * betaz) * T(1.0 / kC);
  const T invg = T(1) / sqrt(T(0.5) * (sigma + sqrt(sigma * sigma +
                                                    T(4) * (betam + ust * ust))));
  const T tx = invg * betax;
  const T ty = invg * betay;
  const T tz = invg * betaz;
  const T s = T(1) / (T(1) + (tx * tx + ty * ty + tz * tz));
  const T umt = umx * tx + umy * ty + umz * tz;
  const T upx = s * (umx + umt * tx + umy * tz - umz * ty);
  const T upy = s * (umy + umt * ty + umz * tx - umx * tz);
  const T upz = s * (umz + umt * tz + umx * ty - umy * tx);
  ux = upx + qmt * Ex + upy * tz - upz * ty;
  uy = upy + qmt * Ey + upz * tx - upx * tz;
  uz = upz + qmt * Ez + upx * ty - upy * tx;
}

template <typename T, int ORDER, int PUSHER, bool SMEM>
__global__ void __launch_bounds__(kThreads)
fused_pic_kernel(const FusedPicArgs a) {
  constexpr int NT = ORDER + 3;  // Esirkepov taps per axis
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
  // window origin in padded-field coordinates, and in grid coordinates
  const int f0[3] = {t0 * a.tile[0], t1 * a.tile[1], t2 * a.tile[2]};
  T worig[3];
  T lo[3], inv_dx[3], dt_inv_dx[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    worig[d] = static_cast<T>(f0[d] - a.off);
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
            i0[d] = gather_weights(xc, a.gorder[c * 3 + d], wt[d]);
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
                h += (wt[1][ib] * wt[2][ic]) * __ldg(F[c] + fi);
              }
            }
            e += wt[0][ia] * h;
          }
          e6[c] = e + prm[s * 8 + 2 + c];
        }

        // ---- push
        if (PUSHER == 0) {
          push_boris(ux, uy, uz, e6[0], e6[1], e6[2], e6[3], e6[4], e6[5], q,
                     m, dt);
        } else if (PUSHER == 1) {
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
            const T sn = in ? spline(xn - static_cast<T>(row_), ORDER) : T(0);
            const T so = in ? spline(X[d] - static_cast<T>(row_), ORDER) : T(0);
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
                const T v = cval * (T(0.25) * (sm[da][ja] * sm[db][jb]) +
                                    T(1.0 / 12.0) * (df[da][ja] * df[db][jb]));
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
                  const T v = cval * (T(0.25) * (sm[da][ja] * sm[db][jb]) +
                                      T(1.0 / 12.0) * (df[da][ja] * df[db][jb]));
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

// Error codes returned to Python: stage * 1000 + cudaError_t.
constexpr int kStageAttr = 1, kStageSetSmem = 2, kStageLaunch = 3,
              kStageArgs = 4;

template <typename T, int O, int PU, bool SM>
int launch_one(const FusedPicArgs& a, cudaStream_t st) {
  const size_t smem = SM ? 3ull * a.w * a.w * a.w * sizeof(T) : 0;
  auto kern = fused_pic_kernel<T, O, PU, SM>;
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

template <typename T, int O, int PU>
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
  return need <= static_cast<size_t>(optin) ? launch_one<T, O, PU, true>(a, st)
                                            : launch_one<T, O, PU, false>(a, st);
}

}  // namespace

// One library per (type, order): FP_REAL and FP_ORDER are set on the nvcc
// command line (warpx_tpu_torch/build.py), so the builds run in parallel.
extern "C" int fused_pic_launch(const FusedPicArgs* a, void* stream) {
  if (a->n_tiles <= 0) return 0;
  if (a->order != FP_ORDER) {
    return kStageArgs * 1000 + static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a->pusher) {
    case 0: return launch_smem<FP_REAL, FP_ORDER, 0>(*a, st);
    case 1: return launch_smem<FP_REAL, FP_ORDER, 1>(*a, st);
    case 2: return launch_smem<FP_REAL, FP_ORDER, 2>(*a, st);
    default:
      return kStageArgs * 1000 + static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fused_pic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code % 1000));
}
