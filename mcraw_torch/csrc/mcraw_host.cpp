// Host runtime of mcraw_torch: the two format-imposed serial scans that
// cannot vectorize, walked on the host before the frame goes to the card.
//
//   1. mcraw_metadata_scan: the modern codec's inline-header metadata
//      streams ("bits"/"refs", RawData.cpp:463-498 semantics). Each 64-value
//      group's 2-byte header determines the next group's offset.
//   2. mcraw_legacy_scan / mcraw_legacy_scan_range: the legacy codec's
//      per-block header chain (RawData_Legacy.cpp:377-442 semantics): block
//      N's offset depends on block N-1's bits nibble.
//
// A copy of the functions of native/mcraw_host.cpp that the port calls, so
// that mcraw_torch needs nothing outside its own package; the CPU tests hold
// its scans equal to mcraw.kernels.native's. mcraw_torch/kernels/native.py
// builds it with g++ at first use (a .cpp, not a .cu: the CUDA build leaves
// it alone) and binds it with ctypes; the ABI is plain C.

#include <cstdint>
#include <cstring>

namespace {

// Payload bytes per 64-value modern block, by header bits value 0..16.
constexpr int64_t kModernBlockLength[17] = {
    0, 8, 16, 24, 32, 40, 48, 64, 64, 80, 80, 128, 128, 128, 128, 128, 128};

// Payload bytes per 16-value legacy block, by clamped bits value 0..16.
constexpr int64_t kLegacyBlockLength[17] = {
    0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 32, 32, 32, 32, 32, 32};

// Scalar unpack of one modern 64-value block into `out`, given its class.
// Mirrors the field tables in mcraw_torch/kernels/tables.py.
inline void unpack_modern_block(const uint8_t* p, int bits, uint16_t* out) {
  switch (bits) {
    case 0:
      std::memset(out, 0, 64 * sizeof(uint16_t));
      break;
    case 1:
      for (int m = 0; m < 8; ++m)
        for (int l = 0; l < 8; ++l) out[8 * m + l] = (p[l] >> m) & 1;
      break;
    case 2:
      for (int half = 0; half < 2; ++half)
        for (int m = 0; m < 4; ++m)
          for (int l = 0; l < 8; ++l)
            out[32 * half + 8 * m + l] = (p[8 * half + l] >> (2 * m)) & 3;
      break;
    case 3:
      for (int l = 0; l < 8; ++l) {
        const uint16_t p0 = p[l], p1 = p[8 + l], p2 = p[16 + l];
        out[l] = p0 & 7;
        out[8 + l] = (p0 >> 3) & 7;
        out[16 + l] = ((p0 >> 6) & 3) | (((p2 >> 6) & 1) << 2);
        out[24 + l] = p1 & 7;
        out[32 + l] = (p1 >> 3) & 7;
        out[40 + l] = ((p1 >> 6) & 3) | (((p2 >> 7) & 1) << 2);
        out[48 + l] = p2 & 7;
        out[56 + l] = (p2 >> 3) & 7;
      }
      break;
    case 4:
      for (int c = 0; c < 4; ++c)
        for (int m = 0; m < 2; ++m)
          for (int l = 0; l < 8; ++l)
            out[16 * c + 8 * m + l] = (p[8 * c + l] >> (4 * m)) & 15;
      break;
    case 5:
      for (int l = 0; l < 8; ++l) {
        const uint16_t p0 = p[l], p1 = p[8 + l], p2 = p[16 + l];
        const uint16_t p3 = p[24 + l], p4 = p[32 + l];
        out[l] = p0 & 31;
        out[8 + l] = p1 & 31;
        out[16 + l] = p2 & 31;
        out[24 + l] = p3 & 31;
        out[32 + l] = p4 & 31;
        out[40 + l] = ((p0 >> 5) & 7) | (((p3 >> 5) & 3) << 3);
        out[48 + l] = ((p1 >> 5) & 7) | (((p4 >> 5) & 3) << 3);
        out[56 + l] = ((p2 >> 5) & 7) | (((p3 >> 7) & 1) << 3) |
                      (((p4 >> 7) & 1) << 4);
      }
      break;
    case 6:
      for (int l = 0; l < 8; ++l) {
        out[l] = p[l] & 63;
        out[8 + l] = p[8 + l] & 63;
        out[16 + l] = p[16 + l] & 63;
        out[24 + l] = p[24 + l] & 63;
        out[32 + l] = p[32 + l] & 63;
        out[40 + l] = p[40 + l] & 63;
        out[48 + l] = ((p[l] >> 6) & 3) | (((p[8 + l] >> 6) & 3) << 2) |
                      (((p[16 + l] >> 6) & 3) << 4);
        out[56 + l] = ((p[24 + l] >> 6) & 3) | (((p[32 + l] >> 6) & 3) << 2) |
                      (((p[40 + l] >> 6) & 3) << 4);
      }
      break;
    case 7:
    case 8:
      for (int j = 0; j < 64; ++j) out[j] = p[j];
      break;
    case 9:
    case 10:
      for (int k = 0; k < 4; ++k)
        for (int l = 0; l < 8; ++l) {
          out[8 * k + l] =
              p[8 * k + l] | ((uint16_t)((p[32 + l] >> (2 * k)) & 3) << 8);
          out[32 + 8 * k + l] =
              p[40 + 8 * k + l] | ((uint16_t)((p[72 + l] >> (2 * k)) & 3) << 8);
        }
      break;
    default:  // 11..16: little-endian uint16
      for (int j = 0; j < 64; ++j)
        out[j] = (uint16_t)p[2 * j] | ((uint16_t)p[2 * j + 1] << 8);
      break;
  }
}

}  // namespace

extern "C" {

// Decode one modern metadata stream starting at `offset` (which points at
// the u32 LE numBlocks). Writes 64*ceil(num_blocks/64) values into `out`
// (caller allocates padded; reference-added). Returns the offset just past
// the stream, or -1 on truncation.
int64_t mcraw_metadata_scan(const uint8_t* data, int64_t len, int64_t offset,
                            uint16_t* out, int64_t num_blocks) {
  if (offset + 4 > len) return -1;
  offset += 4;  // caller already validated numBlocks
  const int64_t groups = (num_blocks + 63) / 64;
  for (int64_t g = 0; g < groups; ++g) {
    if (offset + 2 > len) return -1;
    const int bits = (data[offset] >> 4) & 0x0F;
    const uint16_t ref =
        (uint16_t)(((data[offset] & 0x0F) << 8) | data[offset + 1]);
    offset += 2;
    const int64_t blen = kModernBlockLength[bits];
    if (offset + blen > len) return -1;
    uint16_t* dst = out + g * 64;
    unpack_modern_block(data + offset, bits, dst);
    for (int x = 0; x < 64; ++x) dst[x] = (uint16_t)(dst[x] + ref);
    offset += blen;
  }
  return offset;
}

// Walk the legacy inline-header chain for `num_blocks` blocks starting at
// `start`. Emits per-block clamped bits, 12-bit references, and payload
// offsets (just past each 2-byte header). Truncation semantics follow the
// reference's strict `>=` checks. Returns the end offset or -1.
int64_t mcraw_legacy_scan(const uint8_t* data, int64_t len, int64_t start,
                          int64_t num_blocks, int32_t* bits_out,
                          uint16_t* refs_out, int64_t* offs_out) {
  int64_t offset = start;
  int64_t i = 0;
  // Fast path: while offset < len - 34, BOTH truncation checks are false
  // for any bits value (2-byte header + 32-byte max block, strict >=), so
  // the serial chain runs branch-light at ~2 loads + LUT + add per block.
  const int64_t safe = len - 34;
  while (i < num_blocks && offset < safe) {
    const uint8_t b0 = data[offset];
    const int bits = b0 >> 4;  // 4-bit field: the >16 clamp cannot fire
    refs_out[i] = (uint16_t)(((b0 & 0x0F) << 8) | data[offset + 1]);
    bits_out[i] = bits;
    offs_out[i] = offset + 2;
    offset += 2 + kLegacyBlockLength[bits];
    ++i;
  }
  for (; i < num_blocks; ++i) {
    if (offset + 2 >= len) return -1;
    const uint8_t b0 = data[offset];
    int bits = (b0 >> 4) & 0x0F;
    if (bits > 16) bits = 16;
    refs_out[i] = (uint16_t)(((b0 & 0x0F) << 8) | data[offset + 1]);
    const int64_t blen = kLegacyBlockLength[bits];
    if (offset + 2 + blen >= len) return -1;
    bits_out[i] = bits;
    offs_out[i] = offset + 2;
    offset += 2 + blen;
  }
  return offset;
}

// Bounded legacy header walk for CHUNK-PARALLEL scanning: the trailing
// offset table (RawData_Legacy.cpp:452-469) names block-aligned payload
// positions, so independent threads can each scan one [start, end_limit)
// segment and the concatenation equals the serial scan. Scans until (a)
// `max_blocks` blocks, (b) the next header would start at/after
// `end_limit`, or (c) the reference's strict `>=` truncation bound fires.
// Always returns the number of blocks emitted; the final stream offset is
// written to *end_out so the caller can validate segment continuity
// (a block straddling end_limit shows up as *end_out > end_limit).
int64_t mcraw_legacy_scan_range(const uint8_t* data, int64_t len,
                                int64_t start, int64_t end_limit,
                                int64_t max_blocks, int32_t* bits_out,
                                uint16_t* refs_out, int64_t* offs_out,
                                int64_t* end_out) {
  int64_t offset = start;
  int64_t i = 0;
  // Fast path (see mcraw_legacy_scan): below min(end_limit, len - 34)
  // neither truncation check can fire for any bits value.
  const int64_t safe = end_limit < len - 34 ? end_limit : len - 34;
  while (i < max_blocks && offset < safe) {
    const uint8_t b0 = data[offset];
    const int bits = b0 >> 4;
    refs_out[i] = (uint16_t)(((b0 & 0x0F) << 8) | data[offset + 1]);
    bits_out[i] = bits;
    offs_out[i] = offset + 2;
    offset += 2 + kLegacyBlockLength[bits];
    ++i;
  }
  for (; i < max_blocks; ++i) {
    if (offset >= end_limit) break;
    if (offset + 2 >= len) break;
    const uint8_t b0 = data[offset];
    int bits = (b0 >> 4) & 0x0F;
    if (bits > 16) bits = 16;
    const int64_t blen = kLegacyBlockLength[bits];
    if (offset + 2 + blen >= len) break;
    refs_out[i] = (uint16_t)(((b0 & 0x0F) << 8) | data[offset + 1]);
    bits_out[i] = bits;
    offs_out[i] = offset + 2;
    offset += 2 + blen;
  }
  *end_out = offset;
  return i;
}

}  // extern "C"
