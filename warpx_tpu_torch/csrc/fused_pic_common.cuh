// Shared by kernels K1 (fused_pic.cu, 3D) and K2 (fused_pic_2d.cu, 2D XZ):
// the launch arguments, the never-contracted coordinate arithmetic, the
// B-spline shape factors, the three momentum pushers and the roundings of the
// precision modes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

// Must match warpx_tpu_torch/ops/fused_pic.py::_FusedPicArgs field by field.
struct FusedPicArgs {
  const void* fields[6];  // guard-padded Ex, Ey, Ez, Bx, By, Bz
  const void* parts[7];   // x, [y,] z, ux, uy, uz, w: (n_sp * n_tiles, p_max)
  void* out_parts[6];     // x, [y,] z, ux, uy, uz
  void* jw[3];            // (n_tiles, W, W^(ndim-1)) each
  int* viol;              // (n_sp * n_tiles)
  const int* counts;      // alive particles per (species, tile)
  const void* sp_params;  // (n_sp, 8): q, m, Eext(3), Bext(3)
  int n_sp, n_tiles, p_max, w, off;
  int tiles_per_dim[3];
  int tile[3];
  int fdim[3];            // padded field extents (last axis longer by smax)
  int order, pusher;
  int zoff;               // smax - zshift: where window 0 starts on the last
                          // field axis (0 on the periodic path)
  int mxu;                // precision mode: kMxuF32, kMxuMixed or kMxuBf16
  int gorder[18];         // gather shape order per (component, axis)
  int gstag[18];          // 1 where the component sits at i + 1/2 on the axis
  double lo[3];           // tiling origin: prob_lo, or the moving-window anchor
  double inv_dx[3];
  double dt_inv_dx[3];
  double invdtd[3];       // 1 / (dt * dx_a * dx_b) per current component
  double dt;
};

namespace {

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

// The precision modes of the TPU kernel's matrix unit (tile_mxu,
// pallas_pic.py:57-69): 'f32' computes in the state's type; 'mixed' rounds
// the gather's operands to bfloat16 and splits the deposit's (dot3x);
// 'bf16' rounds the deposit's operands to bfloat16 too.  Products of
// bfloat16 values are exact in float and double, and every sum stays in the
// state's type, as the TPU kernel's dots with preferred_element_type do.
constexpr int kMxuF32 = 0, kMxuMixed = 1, kMxuBf16 = 2;

// x rounded to the nearest bfloat16, in x's own type.  A double is rounded to
// float first, as PyTorch's and XLA's conversions to bfloat16 do (a direct
// rounding differs when x lies within a float ulp of a tie).
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ double bf16_round(double x) {
  return static_cast<double>(bf16_round(static_cast<float>(x)));
}

// x * y with both split into a bfloat16 high part and a bfloat16 remainder,
// the remainder-remainder product dropped (pallas_pic.py:101 _dot3x).  The
// remainders use sub_rn: an x that is a product would otherwise be fused
// into an FMA with the subtraction and lose its rounding.
template <typename T>
__device__ __forceinline__ T dot3x(T x, T y) {
  const T xh = bf16_round(x);
  const T xl = bf16_round(sub_rn(x, xh));
  const T yh = bf16_round(y);
  const T yl = bf16_round(sub_rn(y, yh));
  return xh * yh + xh * yl + xl * yh;
}

// One product of the deposit at precision MXU.  The operands of the modes
// must carry the plain version's bits, so the callers form them with the
// _rn helpers: an FMA would move a value by an ulp before its rounding, and
// about 2^-16 of the float32 operands would then round to the other
// bfloat16.
template <int MXU, typename T>
__device__ __forceinline__ T mxu_mul(T x, T y) {
  if (MXU == kMxuMixed) return dot3x(x, y);
  if (MXU == kMxuBf16) return bf16_round(x) * bf16_round(y);
  return x * y;
}

// The B-spline.  EXACT (the precision modes) forms it without FMA
// contraction, as PyTorch does, so that the weights that are rounded to
// bfloat16 carry the plain version's bits.
template <typename T, bool EXACT = false>
__device__ __forceinline__ T spline(T xi, int order) {
  const T t = fabs(xi);
  if (order == 1) return t < T(1) ? T(1) - t : T(0);
  if (order == 2) {
    if (t <= T(0.5)) {
      return EXACT ? sub_rn(T(0.75), mul_rn(t, t)) : T(0.75) - t * t;
    }
    if (t < T(1.5)) {
      const T u = T(1.5) - t;
      return T(0.5) * (u * u);
    }
    return T(0);
  }
  // order 3
  if (t <= T(1)) {
    return EXACT ? sub_rn(T(2.0 / 3.0),
                          mul_rn(mul_rn(t, t), sub_rn(T(1), mul_rn(T(0.5), t))))
                 : T(2.0 / 3.0) - t * t * (T(1) - T(0.5) * t);
  }
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
template <typename T, bool EXACT = false>
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
    wt[m] = (m <= o) ? spline<T, EXACT>(xc - static_cast<T>(i0 + m), o) : T(0);
  }
  return i0;
}

// Weights of one shape set of compile-time order O at grid coordinate xc;
// returns the first row.  The per-tap formula of gather_weights, so the
// bits are the same; order 0 is the half-open box [-1/2, 1/2).
template <typename T, bool EXACT, int O>
__device__ __forceinline__ int set_weights(T xc, T (&wt)[O + 1]) {
  if constexpr (O == 0) {
    int i = static_cast<int>(floor(xc + T(0.5)));
    const T xi = xc - static_cast<T>(i);
    if (xi < T(-0.5)) {
      i -= 1;
    } else if (xi >= T(0.5)) {
      i += 1;
    }
    wt[0] = T(1);
    return i;
  } else {
    const int i0 = start_index(xc, O);
#pragma unroll
    for (int m = 0; m <= O; ++m) {
      wt[m] = spline<T, EXACT>(xc - static_cast<T>(i0 + m), O);
    }
    return i0;
  }
}

// The staged field boxes of K1 and K2: the state's type, or bfloat16 in the
// precision modes (rounded once, as they are staged).
template <typename T>
__device__ __forceinline__ T staged(T v) {
  return v;
}
__device__ __forceinline__ float staged(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename G, typename T>
__device__ __forceinline__ G to_staged(T v) {
  if constexpr (std::is_same<G, T>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(static_cast<float>(v));
  }
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

// Error codes returned to Python: stage * 1000 + cudaError_t.
constexpr int kStageAttr = 1, kStageSetSmem = 2, kStageLaunch = 3,
              kStageArgs = 4;

}  // namespace
