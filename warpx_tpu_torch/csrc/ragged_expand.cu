// Kernel K3: the rebin's slot expansion, with the dead-slot fills fused.
//
// Replaces warpx_tpu/ops/tiling.py::_ragged_expand (the Pallas kernel
// _ragged_expand_kernel, which DMAs each tile's sorted segment from a
// 128-lane-aligned base and fixes the sub-128 residual with a lane roll) and
// the fills rebin applies after it (tiling.py:298-330):
//
//   out[a, t*p_max + s] = src[a, offsets[t] + s]   if s < min(counts[t], p_max)
//                         fill[a, t]               otherwise
//
// Bound on the card: bytes.  It reads each attribute of each kept particle
// once and writes every slot once; there is no arithmetic.  Design: one block
// per tile; neighbouring threads copy neighbouring slots, so each warp reads
// and writes one contiguous run per attribute (the segment start is not
// aligned, which costs at most one extra sector per run).  Dead slots take
// their fill without reading the source.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ragged_expand_kernel(const T* __restrict__ src, long long cap_in,
                     const int* __restrict__ offsets,
                     const int* __restrict__ counts,
                     const T* __restrict__ fill, T* __restrict__ out,
                     int n_attr, int n_tiles, int p_max) {
  const int t = blockIdx.x;
  const long long off = offsets[t];
  const int cnt = min(counts[t], p_max);
  const long long out_stride = (long long)n_tiles * p_max;
  for (int a = 0; a < n_attr; ++a) {
    const T* s = src + a * cap_in + off;
    T* o = out + a * out_stride + (long long)t * p_max;
    const T f = fill[(long long)a * n_tiles + t];
    for (int i = threadIdx.x; i < p_max; i += kThreads) {
      o[i] = i < cnt ? s[i] : f;
    }
  }
}

}  // namespace

extern "C" int ragged_expand_launch(int is_f64, const void* src,
                                    long long cap_in, const void* offsets,
                                    const void* counts, const void* fill,
                                    void* out, int n_attr, int n_tiles,
                                    int p_max, void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  const int* cnt = static_cast<const int*>(counts);
  if (is_f64) {
    ragged_expand_kernel<double><<<n_tiles, kThreads, 0, st>>>(
        static_cast<const double*>(src), cap_in, off, cnt,
        static_cast<const double*>(fill), static_cast<double*>(out), n_attr,
        n_tiles, p_max);
  } else {
    ragged_expand_kernel<float><<<n_tiles, kThreads, 0, st>>>(
        static_cast<const float*>(src), cap_in, off, cnt,
        static_cast<const float*>(fill), static_cast<float*>(out), n_attr,
        n_tiles, p_max);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ragged_expand_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
