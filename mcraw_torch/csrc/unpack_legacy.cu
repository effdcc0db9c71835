// Legacy-codec (compressionType 6) block unpack + even/odd interleave.
//
// Replaces three generations of one TPU kernel in
// mcraw/kernels/pallas_legacy.py: _legacy_kernel_v6 (launched by
// _unpack_legacy_pallas_v6_raw), _legacy_kernel_v5 (_unpack_legacy_pallas_v5)
// and _legacy_kernel (_unpack_legacy_pallas). It computes their function, not
// their machinery: the chunk DMA, one-hot MXU byte picks, byte planes,
// 128-lane rows and dummy lanes for ragged padded widths exist to work
// around the TPU's lack of a gather; an H100 reads device memory by address.
//
// One thread per output pixel (y, x) of the (height, width) plane, so that
// neighbouring threads store neighbouring pixels:
//   block b = 2 * (y * pw / 32 + x / 32) + (x & 1), value j = (x & 31) / 2
// (numpy_ref.legacy_interleave; pw is the width padded to 32, and the
// padding columns are never computed). Value j of block b is the c-bit field
// at bit j*c of the MSB-first, big-endian bitstream that starts at byte
// offsets[b], with c = bits <= 10 ? bits : 16 (LEGACY_CLASS_OF_BITS in
// mcraw/kernels/tables.py: class 16 is a big-endian uint16, class 0 all
// zeros), plus the block's reference, wrapped to 16 bits. The field starts
// at bit s = (j*c) & 7 of byte offsets[b] + (j*c >> 3), and s + c <= 23, so
// one 3-byte big-endian window always holds it:
//   v = (window >> (24 - s - c)) & (2^c - 1).
// That is the closed form of the byte-field tables LEGACY_POS/RSH/MSK/LSH,
// which the plain version (mcraw_torch/kernels/legacy.py) reads instead.
//
// Unaligned: offsets are odd as often as even (2-byte inline headers), so
// the payload is read byte by byte. For c >= 8 the window reaches up to 2
// bytes past the block's last byte; those bits are masked out, the caller
// pads the payload with a zeroed tail, and every byte index is still
// bounded by n_bytes (reads past it give 0).
//
// Bound by bytes, not operations: a 4096x3072 frame reads its payload plus
// 786,432 blocks x (int32 bits, uint16 ref, int64 offset) and writes 25.2 MB.
// A warp's 32 pixels share two blocks, so the metadata loads broadcast. No
// matrix product, no bulk tile copy and no table: wgmma, TMA and shared
// memory have no role.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t byte_at(const uint8_t* __restrict__ p,
                                            int64_t n, int64_t i) {
  return (i >= 0 && i < n) ? static_cast<uint32_t>(p[i]) : 0u;
}

__global__ void __launch_bounds__(kThreads) unpack_legacy_kernel(
    const uint8_t* __restrict__ payload, int64_t n_bytes,
    const int32_t* __restrict__ bits, const uint16_t* __restrict__ refs,
    const int64_t* __restrict__ offsets, uint16_t* __restrict__ out,
    int64_t height, int64_t width, int64_t pairs_per_row) {
  const int64_t segs = (width + kThreads - 1) / kThreads;
  const int64_t units = height * segs;
  for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
    const int64_t y = u / segs;
    const int64_t x = (u - y * segs) * kThreads + threadIdx.x;
    if (x >= width) continue;
    const int64_t b = 2 * (y * pairs_per_row + (x >> 5)) + (x & 1);
    const int j = static_cast<int>((x & 31) >> 1);

    int bb = bits[b];
    bb = bb < 0 ? 0 : (bb > 16 ? 16 : bb);
    const int c = bb <= 10 ? bb : 16;
    uint32_t v = 0;
    if (c != 0) {
      const int bit = j * c;
      const int64_t i = offsets[b] + (bit >> 3);
      const uint32_t win = byte_at(payload, n_bytes, i) << 16 |
                           byte_at(payload, n_bytes, i + 1) << 8 |
                           byte_at(payload, n_bytes, i + 2);
      v = (win >> (24 - (bit & 7) - c)) & ((1u << c) - 1u);
    }
    out[y * width + x] = static_cast<uint16_t>(v + refs[b]);
  }
}

}  // namespace

// Writes the whole (height, width) uint16 plane `out`; padded_width is the
// width rounded up to a multiple of 32, and bits/refs/offsets hold
// height * padded_width / 16 blocks. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int mcraw_unpack_legacy(const uint8_t* payload, int64_t n_bytes,
                                   const int32_t* bits, const uint16_t* refs,
                                   const int64_t* offsets, uint16_t* out,
                                   int64_t height, int64_t width,
                                   int64_t padded_width, void* stream) {
  const int64_t units = height * ((width + kThreads - 1) / kThreads);
  if (units <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1) * 8;
  const int grid = static_cast<int>(units < cap ? units : cap);
  unpack_legacy_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      payload, n_bytes, bits, refs, offsets, out, height, width,
      padded_width / 32);
  return static_cast<int>(cudaGetLastError());
}
