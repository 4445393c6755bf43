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
// the deposit).  Design:
//   * one block per tile; the block loops over the species of the launch and
//     its threads stride over the p_max slots, neighbouring threads on
//     neighbouring slots, so particle reads and writes are coalesced;
//   * 2D tiles are small and many (W^2 = 576 values at order 3), so everything
//     a tile touches fits a block's shared memory in either type: the six
//     W x W field windows are staged there once per tile, and the three W x W
//     current windows accumulate there by atomicAdd and are written once.
//     Unlike K1 in float64, no global-atomics variant is needed;
//   * 192 threads per block: a tile holds few slots (p_max = 384 at 2 x 2
//     particles per cell), which 192 threads cover in two passes with none
//     idle; it was the fastest of 64, 128, 192 and 256 at 2048^2 cells;
//   * a (species, tile) with no alive particle copies its five columns
//     through and counts no violation (pallas_pic.py:485-498).
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
//
// Precision modes (the TPU kernel's mxu argument, kernel mode K1d;
// pallas_pic.py:57-69, 433-436, 483, 527-561, 604-626), a template parameter
// instantiated in every library: in 'mixed' and 'bf16' the six field windows
// are staged in shared memory as bfloat16 (half the bytes of float32) and
// the z weight of the gather is rounded to bfloat16, the x weight is not.
// The deposit is four (x-side, z-side) products per point, as the TPU kernel
// stacks them:
//   Jx: (cs_x * wq/(dt*dz), sm_z/2)       Jz: (sm_x/2, cs_z * wq/(dt*dx))
//   Jy: ((wqvy/4) sm_x, sm_z) + ((wqvy/12) df_x, df_z),  wqvy = wq*vy/(dx*dz)
// each taken by mxu_mul (fused_pic_common.cuh): dot3x in 'mixed', both
// operands rounded to bfloat16 in 'bf16'.  The splines are formed without FMA
// contraction in the modes.

#include <type_traits>

#include "fused_pic_common.cuh"

namespace {

constexpr int kThreads = 192;

// The staged field windows: the state's type, or bfloat16 in the modes.
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

// Bytes of the staged field windows, rounded up so the current windows
// that follow them are aligned for either type.
template <typename G>
__host__ __device__ __forceinline__ size_t staged_bytes(int w) {
  return (6ull * w * w * sizeof(G) + 15) & ~size_t(15);
}

template <typename T, int ORDER, int MXU>
__global__ void __launch_bounds__(kThreads)
fused_pic_2d_kernel(const FusedPicArgs a) {
  using G = typename std::conditional<MXU == kMxuF32, T, __nv_bfloat16>::type;
  constexpr int NT = ORDER + 3;  // Esirkepov taps per axis
  constexpr bool EXACT = MXU != kMxuF32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_viol;

  const int t = blockIdx.x;
  const int W = a.w;
  const int P = a.p_max;
  const int W2 = W * W;
  const int ntz = a.tiles_per_dim[1];
  const int t0 = t / ntz;
  const int t1 = t - t0 * ntz;
  // window origin in grid coordinates, relative to the tiling origin lo
  const int g0[2] = {t0 * a.tile[0], t1 * a.tile[1]};
  T worig[2], lo[2], inv_dx[2], dt_inv_dx[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    worig[d] = static_cast<T>(g0[d] - a.off);
    lo[d] = static_cast<T>(a.lo[d]);
    inv_dx[d] = static_cast<T>(a.inv_dx[d]);
    dt_inv_dx[d] = static_cast<T>(a.dt_inv_dx[d]);
  }
  const T dt = static_cast<T>(a.dt);

  // ---- stage the six field windows, zero the three current windows
  G* Fw = reinterpret_cast<G*>(smem_raw);  // 6 x (W, W)
  // Jx, Jy, Jz: 3 x (W, W)
  T* J = reinterpret_cast<T*>(smem_raw + staged_bytes<G>(W));
  {
    const long long fs0 = a.fdim[1];
    const long long forig = g0[0] * fs0 + (g0[1] + a.zoff);
    for (int i = threadIdx.x; i < 6 * W2; i += kThreads) {
      const int c = i / W2;
      const int rem = i - c * W2;
      const int r = rem / W;
      const int k = rem - r * W;
      Fw[i] = to_staged<G>(
          __ldg(static_cast<const T*>(a.fields[c]) + forig + r * fs0 + k));
    }
    for (int i = threadIdx.x; i < 3 * W2; i += kThreads) J[i] = T(0);
  }
  const T* prm = static_cast<const T*>(a.sp_params);
  const T invvol = static_cast<T>(a.invdtd[2]);

  for (int s = 0; s < a.n_sp; ++s) {
    const long long row = static_cast<long long>(s) * a.n_tiles + t;
    const long long base = row * P;
    if (threadIdx.x == 0) s_viol = 0;
    __syncthreads();  // also orders the staging above before the first use
    const bool occupied = a.counts[row] > 0;
    if (!occupied) {
      for (int c = 0; c < 5; ++c) {
        const T* src = static_cast<const T*>(a.parts[c]) + base;
        T* dst = static_cast<T*>(a.out_parts[c]) + base;
        for (int p = threadIdx.x; p < P; p += kThreads) dst[p] = src[p];
      }
    } else {
      const T q = prm[s * 8 + 0];
      const T m = prm[s * 8 + 1];
      for (int p = threadIdx.x; p < P; p += kThreads) {
        const long long k = base + p;
        T pos[2], X[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          pos[d] = static_cast<const T*>(a.parts[d])[k];
          X[d] = sub_rn(mul_rn(sub_rn(pos[d], lo[d]), inv_dx[d]), worig[d]);
        }
        T ux = static_cast<const T*>(a.parts[2])[k];
        T uy = static_cast<const T*>(a.parts[3])[k];
        T uz = static_cast<const T*>(a.parts[4])[k];
        const T w = static_cast<const T*>(a.parts[5])[k];

        // ---- gather from the staged windows: sum over z taps, then x taps
        T e6[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          T wt[2][4];
          int i0[2];
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const T xc = a.gstag[c * 2 + d] ? X[d] - T(0.5) : X[d];
            i0[d] = gather_weights<T, EXACT>(xc, a.gorder[c * 2 + d], wt[d]);
          }
          if (MXU != kMxuF32) {
#pragma unroll
            for (int j = 0; j < 4; ++j) wt[1][j] = bf16_round(wt[1][j]);
          }
          const G* Fc = Fw + c * W2;
          T e = T(0);
#pragma unroll
          for (int ia = 0; ia <= ORDER; ++ia) {
            const int rx = i0[0] + ia;
            if (ia > a.gorder[c * 2 + 0] || rx < 0 || rx >= W) continue;
            T h = T(0);
#pragma unroll
            for (int ic = 0; ic <= ORDER; ++ic) {
              const int rz = i0[1] + ic;
              if (ic > a.gorder[c * 2 + 1] || rz < 0 || rz >= W) continue;
              h += wt[1][ic] * static_cast<T>(staged(Fc[rx * W + rz]));
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
        const T vy = uy * gaminv;
        const T vel[2] = {ux * gaminv, uz * gaminv};  // in-plane (x, z)
        static_cast<T*>(a.out_parts[0])[k] = pos[0] + vel[0] * dt;
        static_cast<T*>(a.out_parts[1])[k] = pos[1] + vel[1] * dt;
        static_cast<T*>(a.out_parts[2])[k] = ux;
        static_cast<T*>(a.out_parts[3])[k] = uy;
        static_cast<T*>(a.out_parts[4])[k] = uz;

        // ---- Esirkepov weights on the NT-row window of each axis
        T sm[2][NT], df[2][NT], cs[2][NT];
        int j0[2];
        bool bad = false;
#pragma unroll
        for (int d = 0; d < 2; ++d) {
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

        // ---- deposit (a dead slot has w = 0 and deposits nothing)
        const T wq = q * w;
        if (wq != T(0)) {
          T* Jx = J;
          T* Jy = J + W2;
          T* Jz = J + 2 * W2;
          const T sx = wq * static_cast<T>(a.invdtd[0]);
          const T sz = wq * static_cast<T>(a.invdtd[1]);
          const T wqvy = wq * (vy * invvol);
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
              const int at = rx * W + rz;
              const T vx = mxu_mul<MXU>(cx, T(0.5) * sm[1][kk]);
              const T vz = mxu_mul<MXU>(hx, cs[1][kk] * sz);
              const T vyv =
                  mxu_mul<MXU>(ax, sm[1][kk]) + mxu_mul<MXU>(bx, df[1][kk]);
              if (vx != T(0)) atomicAdd(Jx + at, vx);
              if (vz != T(0)) atomicAdd(Jz + at, vz);
              if (vyv != T(0)) atomicAdd(Jy + at, vyv);
            }
          }
          // clipped at the window's low side: the running sum is carried on
          // to the window's end, as the TPU kernel's full-window cumsum
          if (j0[0] < 0) {
            const T cx = cs[0][NT - 1] * sx;
            for (int rx = max(j0[0] + NT, 0); rx < W && cx != T(0); ++rx) {
              for (int kk = 0; kk < NT; ++kk) {
                const int rz = j0[1] + kk;
                if (rz < 0 || rz >= W) continue;
                const T vx = mxu_mul<MXU>(cx, T(0.5) * sm[1][kk]);
                if (vx != T(0)) atomicAdd(Jx + rx * W + rz, vx);
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
                if (vz != T(0)) atomicAdd(Jz + rx * W + rz, vz);
              }
            }
          }
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) a.viol[row] = occupied ? s_viol : 0;
  }

  __syncthreads();
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    T* dst = static_cast<T*>(a.jw[c]) + static_cast<long long>(t) * W2;
    for (int i = threadIdx.x; i < W2; i += kThreads) dst[i] = J[c * W2 + i];
  }
}

template <typename T, int O, int MX>
int launch_2d(const FusedPicArgs& a, cudaStream_t st) {
  using G = typename std::conditional<MX == kMxuF32, T, __nv_bfloat16>::type;
  const size_t smem = staged_bytes<G>(a.w) + 3ull * a.w * a.w * sizeof(T);
  auto kern = fused_pic_2d_kernel<T, O, MX>;
  // dynamic shared memory beyond the default 48 KB (static included) needs
  // the opt-in, so always ask for it
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return kStageSetSmem * 1000 + static_cast<int>(e);
  kern<<<a.n_tiles, kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  return e == cudaSuccess ? 0 : kStageLaunch * 1000 + static_cast<int>(e);
}

}  // namespace

// One library per (type, order): FP_REAL and FP_ORDER are set on the nvcc
// command line (warpx_tpu_torch/build.py), so the builds run in parallel;
// each holds the three precision modes.  The pusher is a kernel argument
// (see fused_pic.cu).
extern "C" int fused_pic_2d_launch(const FusedPicArgs* a, void* stream) {
  if (a->n_tiles <= 0) return 0;
  if (a->order != FP_ORDER || a->pusher < 0 || a->pusher > 2) {
    return kStageArgs * 1000 + static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a->mxu) {
    case kMxuF32: return launch_2d<FP_REAL, FP_ORDER, kMxuF32>(*a, st);
    case kMxuMixed: return launch_2d<FP_REAL, FP_ORDER, kMxuMixed>(*a, st);
    case kMxuBf16: return launch_2d<FP_REAL, FP_ORDER, kMxuBf16>(*a, st);
    default:
      return kStageArgs * 1000 + static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fused_pic_2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code % 1000));
}
