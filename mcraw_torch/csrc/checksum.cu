// Wrap-around uint32 sum of a contiguous uint16 or uint32 tensor.
//
// Replaces mcraw/kernels/checksum.py::_checksum_kernel (launched by
// _checksum_2d / device_checksum). The TPU kernel folds (band, W) tiles
// into an (8, 128) VMEM accumulator, carried across its sequential grid,
// and its band is capped in rows rather than bytes, so a (6144, 4096)
// uint32 input overflows VMEM. Here blocks run in parallel in no order, so
// each block folds a grid-stride slice into a uint32 register sum, reduces
// it across the block, and adds it into the output with one atomicAdd.
// Unsigned addition mod 2^32 is associative and commutative, so the result
// does not depend on that order. Any length is taken.
//
// Bound by bytes: one read of the input (25 MB for a 4096x3072 uint16
// frame), no writes beyond one word per block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    checksum_kernel(const T* __restrict__ x, int64_t n,
                    unsigned int* __restrict__ out) {
  __shared__ unsigned int s_warp[kThreads / 32];
  unsigned int acc = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    acc += static_cast<unsigned int>(x[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? s_warp[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) atomicAdd(out, acc);
  }
}

template <typename T>
int launch(const void* x, int64_t n, unsigned int* out, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1) * 8;
  const int grid = static_cast<int>(blocks < cap ? blocks : cap);
  checksum_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                     n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Adds the wrap-around sum of n elements of `elem_bytes` (2 or 4) each into
// *out, which the caller zeroes. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for another element size.
extern "C" int mcraw_checksum(const void* x, int64_t n, int32_t elem_bytes,
                              unsigned int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) return launch<uint16_t>(x, n, out, s);
  if (elem_bytes == 4) return launch<uint32_t>(x, n, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
