// Wrap-around uint32 sum of a contiguous uint16 or uint32 tensor.
//
// Replaces mcraw/kernels/checksum.py::_checksum_kernel (launched by
// _checksum_2d / device_checksum). The TPU kernel folds (band, W) tiles
// into an (8, 128) VMEM accumulator, carried across its sequential grid,
// and its band is capped in rows rather than bytes, so a (6144, 4096)
// uint32 input overflows VMEM. Here blocks run in parallel in no order.
// Unsigned addition mod 2^32 is associative and commutative, so the result
// does not depend on that order. Any length and any element-aligned start
// are taken.
//
// What bounds it: bytes, one read of the input (25.2 MB for a 4096x3072
// uint16 frame, >= 0.0075 ms at 3.35 TB/s). The design keeps enough loads
// in flight for HBM3 and spends few instructions on each byte:
//
// - The body is read with 16-byte loads (8 uint16 or 4 uint32), all
//   kLoads of a thread's step issued before any is summed, from the first
//   16-byte aligned element; the scalar head before it (at most 7
//   elements) and the tail after the last whole vector are added by the
//   first threads of block 0.
// - uint16 halves are summed in 32-bit lanes, (w & 0xFFFF) + (w >> 16).
// - At most one wave of blocks (kBlocksPerSm an SM) walks the body in a
//   grid stride; a 4K frame is one step of 8 loads a thread. Each block
//   reduces its sum by warp shuffles and adds it into the output word with
//   one atomicAdd. The entry zeroes that word with cudaMemsetAsync on the
//   same stream first, so a call enqueues a memset and one kernel and needs
//   nothing of the caller. (Partials and a second one-block pass, instead
//   of the memset and the atomics, were slower at 4K on an H100.)
//
// On an H100 at 4K the body streams at about the HBM3 rate; what stays is
// the fixed cost of a call (launch, memset, reduction: ~7.5 us at 16
// elements, PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

// The buffers of the checked build (kernels/build.py BUFFERS), in order:
// the entry's global buffers, then the kernel's shared array.
enum Buffer : int { kBufX, kBufOut, kBufSWarp };

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kLoads = 8;  // 16-byte loads in flight a thread

template <typename T>
__device__ __forceinline__ uint32_t fold(uint4 v);

template <>
__device__ __forceinline__ uint32_t fold<uint16_t>(uint4 v) {
  return (v.x & 0xFFFFu) + (v.x >> 16) + (v.y & 0xFFFFu) + (v.y >> 16) +
         (v.z & 0xFFFFu) + (v.z >> 16) + (v.w & 0xFFFFu) + (v.w >> 16);
}

template <>
__device__ __forceinline__ uint32_t fold<uint32_t>(uint4 v) {
  return v.x + v.y + v.z + v.w;
}

// x[0, head) and x[tail, n) are scalars; x[head, tail) is nvec 16-byte
// aligned vectors.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    checksum_kernel(const T* __restrict__ x, int64_t n, int64_t head, int64_t nvec,
                    unsigned int* __restrict__ out MCRAW_CK_KERNEL_PARAM) {
  MCRAW_CK_KERNEL_INIT
  __shared__ unsigned int s_warp[kThreads / 32];
  const uint4* __restrict__ body = reinterpret_cast<const uint4*>(x + head);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t acc = 0;
  for (; i < nvec; i += kLoads * stride) {
    uint4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int64_t j = i + u * stride;
      v[u] = j < nvec ? MCRAW_LDG(kBufX, body, j) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) acc += fold<T>(v[u]);
  }
  if (blockIdx.x == 0) {
    const int64_t tail = head + nvec * static_cast<int64_t>(16 / sizeof(T));
    if (threadIdx.x < head) acc += static_cast<uint32_t>(MCRAW_LD(kBufX, x, threadIdx.x));
    if (threadIdx.x < n - tail) {
      acc += static_cast<uint32_t>(MCRAW_LD(kBufX, x, tail + threadIdx.x));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) MCRAW_SST(kBufSWarp, s_warp, s_warp, warp, acc);
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? MCRAW_SLD(kBufSWarp, s_warp, s_warp, lane) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) MCRAW_ATOMIC_ADD(kBufOut, out, acc);
  }
}

template <typename T>
int launch(const void* x, int64_t n, unsigned int* out,
           cudaStream_t stream MCRAW_CK_ENTRY_PARAM) {
  constexpr int64_t per_vec = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (addr % sizeof(T) != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaSuccess;
  MCRAW_CK_HOST_IF(mcraw_check::kChecksum, mcraw_check::kEntryChecksum, kBufOut, kStore,
                   static_cast<int64_t>(sizeof(int64_t)))
  err = cudaMemsetAsync(out, 0, sizeof(int64_t), stream);
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  int64_t head = static_cast<int64_t>((16 - (addr & 15)) & 15) / sizeof(T);
  head = head < n ? head : n;
  const int64_t nvec = (n - head) / per_vec;
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (nvec + kThreads * kLoads - 1) / (kThreads * kLoads);
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1) * kBlocksPerSm;
  const int grid = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  checksum_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), n, head, nvec,
      out MCRAW_CK_LAUNCH(mcraw_check::kChecksum, mcraw_check::kEntryChecksum));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Writes the wrap-around sum of n elements of `elem_bytes` (2 or 4) each,
// zero-extended, into the 8-byte word at `out` (little-endian: the sum is
// its low 32 bits). Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for another element size, or
// cudaErrorMisalignedAddress for a start that is not element-aligned.
extern "C" int mcraw_checksum(const void* x, int64_t n, int32_t elem_bytes,
                              unsigned int* out, void* stream MCRAW_CK_ENTRY_PARAM) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) return launch<uint16_t>(x, n, out, s MCRAW_CK_ENTRY);
  if (elem_bytes == 4) return launch<uint32_t>(x, n, out, s MCRAW_CK_ENTRY);
  return static_cast<int>(cudaErrorInvalidValue);
}
