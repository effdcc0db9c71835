// Modern-codec (compressionType 7) block unpack + Bayer de-interleave.
//
// Replaces mcraw/kernels/pallas_unpack.py::_unpack_kernel_v5 (launched by
// _unpack_image_pallas_v5). It computes the same function, not the same
// machinery: the TPU kernel's chunk DMA, one-hot row picks, byte planes,
// subgroup layout and static field-pass count exist to work around the
// TPU's lack of a gather; an H100 reads device memory by address.
//
// One thread per output pixel (r, x) of the (height, width) plane, so that
// neighbouring threads store neighbouring pixels:
//   t = r / 4, h = (r / 2) % 2, q = r % 2, txi = x / 64, k = (x % 64) / 2,
//   c = x % 2; block b = 4 * (t * tx + txi) + 2q + c, value j = 32h + k
// (the transpose (ty, h, q, tx, k, c) of numpy_ref.modern_deinterleave).
// Value j of block b is the OR of at most three little-endian word fields
//   ((word[offset[b] / 4 + widx] >> rsh) & (2^nbits - 1)) << lsh
// from the class's descriptors (mcraw/kernels/tables.py MODERN_W*), plus
// the block's reference, wrapped to 16 bits. Class 0 yields the reference.
//
// Bound by bytes, not operations: a 4096x3072 frame reads a ~15 MB payload
// plus 196,608 blocks x (uint16 bits, uint16 ref, int64 offset) and writes
// 25.2 MB. There is no matrix product and no bulk tile copy, so wgmma and
// TMA have no role. The 10x64x3 descriptor table lives in shared memory,
// packed one int32 per slot (7.5 KB): neighbouring lanes read different
// entries, which __constant__ memory would serialise. The grid is sized to
// keep every SM busy and strides over the plane, so each block loads the
// table once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kClasses = 10;
constexpr int kBlock = 64;
constexpr int kFields = 3;
constexpr int kDesc = kClasses * kBlock * kFields;
constexpr int kBitsLut = 17;
constexpr int kThreads = 256;

// desc: packed per slot as widx | rsh << 5 | nbits << 10 | lsh << 15
// (see mcraw_torch/kernels/tables.py); class_index maps clamped bits
// (0..16) to a descriptor row.
__global__ void __launch_bounds__(kThreads) unpack_modern_kernel(
    const int32_t* __restrict__ words, int64_t n_words,
    const uint16_t* __restrict__ bits, const uint16_t* __restrict__ refs,
    const int64_t* __restrict__ offsets, const int32_t* __restrict__ desc,
    const int64_t* __restrict__ class_index, uint16_t* __restrict__ out,
    int64_t tx, int64_t rows, int64_t width) {
  __shared__ int32_t s_desc[kDesc];
  __shared__ int32_t s_cls[kBitsLut];
  for (int i = threadIdx.x; i < kDesc; i += blockDim.x) s_desc[i] = desc[i];
  if (threadIdx.x < kBitsLut)
    s_cls[threadIdx.x] = static_cast<int32_t>(class_index[threadIdx.x]);
  __syncthreads();

  const int64_t segs = (width + kThreads - 1) / kThreads;
  const int64_t units = rows * segs;
  for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
    const int64_t r = u / segs;
    const int64_t x = (u - r * segs) * kThreads + threadIdx.x;
    if (x >= width) continue;
    const int64_t t = r >> 2;
    const int h = static_cast<int>((r >> 1) & 1);
    const int q = static_cast<int>(r & 1);
    const int64_t txi = x >> 6;
    const int k = static_cast<int>((x & 63) >> 1);
    const int c = static_cast<int>(x & 1);
    const int64_t b = 4 * (t * tx + txi) + 2 * q + c;
    const int j = 32 * h + k;

    unsigned bb = bits[b];
    if (bb > 16) bb = 16;
    const int32_t* d = s_desc + (s_cls[bb] * kBlock + j) * kFields;
    const int64_t w0 = offsets[b] >> 2;
    uint32_t v = 0;
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      const uint32_t e = static_cast<uint32_t>(d[f]);
      const uint32_t nb = (e >> 10) & 31u;
      if (nb == 0) continue;
      const int64_t wi = w0 + (e & 31u);
      // Host prep proves every valid field lies inside the payload; the
      // bound only keeps a malformed offset from reading past the buffer.
      const uint32_t w =
          (wi >= 0 && wi < n_words) ? static_cast<uint32_t>(words[wi]) : 0u;
      v |= ((w >> ((e >> 5) & 31u)) & ((1u << nb) - 1u)) << ((e >> 15) & 15u);
    }
    out[r * width + x] = static_cast<uint16_t>(v + refs[b]);
  }
}

}  // namespace

// Writes rows [0, rows) of the (., width) uint16 plane `out`; rows past them
// keep whatever the caller allocated (zeros for a short encodedHeight).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mcraw_unpack_modern(const int32_t* words, int64_t n_words,
                                   const uint16_t* bits, const uint16_t* refs,
                                   const int64_t* offsets, const int32_t* desc,
                                   const int64_t* class_index, uint16_t* out,
                                   int64_t tx, int64_t rows, int64_t width,
                                   void* stream) {
  const int64_t units = rows * ((width + kThreads - 1) / kThreads);
  if (units <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1) * 8;
  const int grid = static_cast<int>(units < cap ? units : cap);
  unpack_modern_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      words, n_words, bits, refs, offsets, desc, class_index, out, tx, rows,
      width);
  return static_cast<int>(cudaGetLastError());
}
