// Lab L5: the slot copy of the rebin's DMA variant, with the count mask.
//
// Replaces tools/profile_rebin_lwfa.py::variants3 (:261), the Pallas kernel
// `kern` (:300, pallas_call :338), which DMAs each tile's p_max-long segment
// of all rows of the padded payload into the tile's slots, TB = 16 tiles per
// program, and the mask v_pallas applies after it (:343-345):
//
//   out[r, t*pmax + s] = psp[r, offsets[t] + s]   if s < counts[t]
//                        0                        otherwise
//
// (a column at or past the row's end reads as 0).
//
// Bound on the card: bytes.  It reads each kept value once and writes every
// slot once; there is no arithmetic.  Design: one block per TB = 16 tiles, as
// the TPU kernel's program; each tile's segment of every row is brought into
// shared memory by Hopper's bulk asynchronous copy (cp.async.bulk, completion
// counted on an mbarrier: the counterpart of make_async_copy and its DMA
// semaphores), two tiles in flight, so the copy of tile i+1 overlaps the
// stores of tile i.  A bulk copy needs a 16-byte-aligned source and a size
// that is a multiple of 16, and random offsets break that: the kernel copies
// the enclosing aligned range (at most 4 floats more per row) and shifts by
// offsets[t] % 4 when it reads shared memory; the stores are 16-byte vectors.
// The rows themselves must be 16-byte aligned (a row length that is a
// multiple of 4 floats, an aligned base, pmax a multiple of 4): the wrapper
// raises otherwise, and the lab pads its payload to such a length.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kTilesPerBlock = 16;  // TB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct Seg {
  long long start;  // first column copied (aligned down to 4)
  int len;          // columns copied (a multiple of 4)
  int shift;        // offsets[t] - start
};

__device__ __forceinline__ Seg segment(long long off, int pmax,
                                       long long row_len) {
  long long start = off < 0 ? 0 : (off & ~3LL);
  long long end = (off + pmax + 3) & ~3LL;
  if (end > row_len) end = row_len;  // row_len % 4 == 0 (the wrapper checks)
  if (start > row_len) start = row_len;
  if (end < start) end = start;
  Seg g;
  g.start = start;
  g.len = static_cast<int>(end - start);
  g.shift = static_cast<int>(off - start);
  return g;
}

// Thread 0 starts the bulk copies of one tile's segment of every row.
__device__ __forceinline__ void issue(const float* psp, long long row_len,
                                      int n_rows, int seg_stride, Seg g,
                                      float* buf, uint64_t* bar) {
  mbar_expect_tx(bar, static_cast<uint32_t>(n_rows * g.len * 4));
  if (g.len == 0) return;
  for (int r = 0; r < n_rows; ++r) {
    bulk_copy(buf + r * seg_stride, psp + r * row_len + g.start,
              static_cast<uint32_t>(g.len * 4), bar);
  }
}

__global__ void __launch_bounds__(kThreads)
slot_copy_bulk(const float* __restrict__ psp, long long row_len,
               const int* __restrict__ offsets, const int* __restrict__ counts,
               float* __restrict__ out, int n_rows, int n_tiles, int pmax) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bars[kStages];
  const int seg_stride = pmax + 4;
  const int t0 = blockIdx.x * kTilesPerBlock;
  const int ntb = min(kTilesPerBlock, n_tiles - t0);
  const long long out_stride = static_cast<long long>(n_tiles) * pmax;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    issue(psp, row_len, n_rows, seg_stride,
          segment(offsets[t0], pmax, row_len), smem, &bars[0]);
  }
  for (int i = 0; i < ntb; ++i) {
    const int st = i % kStages;
    if (threadIdx.x == 0 && i + 1 < ntb) {
      const int nx = (i + 1) % kStages;
      // the buffer was last read by every thread before the barrier that
      // ended iteration i - 1; order those reads before the async writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(psp, row_len, n_rows, seg_stride,
            segment(offsets[t0 + i + 1], pmax, row_len),
            smem + nx * n_rows * seg_stride, &bars[nx]);
    }
    const int t = t0 + i;
    const Seg g = segment(offsets[t], pmax, row_len);
    const int cnt = counts[t];
    mbar_wait(&bars[st], (i / kStages) & 1);
    const float* buf = smem + st * n_rows * seg_stride;
    for (int r = 0; r < n_rows; ++r) {
      float* dst = out + r * out_stride + static_cast<long long>(t) * pmax;
      for (int s = threadIdx.x * 4; s < pmax; s += kThreads * 4) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = g.shift + s + j;  // column in the copied range
          v[j] = (s + j < cnt && c >= 0 && c < g.len) ? buf[r * seg_stride + c]
                                                      : 0.f;
        }
        *reinterpret_cast<float4*>(dst + s) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int slot_copy_launch(const void* psp, long long row_len,
                                const void* offsets, const void* counts,
                                void* out, int n_rows, int n_tiles, int pmax,
                                void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n_tiles + kTilesPerBlock - 1) / kTilesPerBlock;
  const size_t smem = sizeof(float) * kStages * n_rows * (pmax + 4);
  cudaError_t e = cudaFuncSetAttribute(
      slot_copy_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  slot_copy_bulk<<<blocks, kThreads, smem, st>>>(
      static_cast<const float*>(psp), row_len,
      static_cast<const int*>(offsets), static_cast<const int*>(counts),
      static_cast<float*>(out), n_rows, n_tiles, pmax);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM (the occupancy calculator) for n_rows x pmax.
extern "C" int slot_copy_blocks_per_sm(int n_rows, int pmax) {
  const size_t smem = sizeof(float) * kStages * n_rows * (pmax + 4);
  int n = 0;
  if (cudaFuncSetAttribute(slot_copy_bulk,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, slot_copy_bulk,
                                                    kThreads, smem) !=
          cudaSuccess) {
    return -1;
  }
  return n;
}

extern "C" const char* slot_copy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
