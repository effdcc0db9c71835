// Legacy-codec (compressionType 6) block unpack + even/odd interleave.
//
// Replaces three generations of one TPU kernel in
// mcraw/kernels/pallas_legacy.py: _legacy_kernel_v6 (launched by
// _unpack_legacy_pallas_v6_raw), _legacy_kernel_v5 (_unpack_legacy_pallas_v5)
// and _legacy_kernel (_unpack_legacy_pallas). It computes their function, not
// their machinery: the chunk DMA, one-hot MXU byte picks, byte planes,
// 128-lane rows and dummy lanes for ragged padded widths exist to work
// around the TPU's lack of a gather.
//
// The function: block b has class c = bits <= 10 ? bits : 16 (bits clamped
// to 0..16; LEGACY_CLASS_OF_BITS in mcraw_torch/kernels/tables.py). Value j
// of the block is the c-bit field at bit j*c of the MSB-first, big-endian
// bitstream that starts at byte offsets[b] (class 16: big-endian uint16s,
// class 0: zeros), plus the block's reference, wrapped to 16 bits. Blocks
// 2p and 2p+1 fill the 32 columns of pair p as even and odd pixels; pair p
// sits at row p / (pw / 32), pw the width padded to 32, and the output is
// cropped to `width` (numpy_ref.legacy_interleave). A byte at or past
// n_bytes reads as 0. The plain version (mcraw_torch/kernels/legacy.py)
// reads the byte-field tables LEGACY_POS/RSH/MSK/LSH instead.
//
// What bounds it: bytes. A 4096x3072 12-bit frame reads a 14.2 MB payload
// plus 786,432 x (int32 bits, uint16 ref, int64 offset) = 11 MB and writes
// 25.2 MB, >= 0.0150 ms at 3.35 TB/s. The design follows one fact of the
// format: the blocks of consecutive pairs are consecutive in the stream, so
// a run of pairs reads one contiguous span of the payload.
//
// - A block of 4 warps takes a run of 32 consecutive pairs (a run may
//   cross a row). One thread per block of the codec loads its bits,
//   reference and offset once, coalesced, into shared memory; every thread
//   reads the run's first and last offsets and starts copying the span
//   [first, last + 40) into shared memory with 16-byte cp.async copies
//   before the metadata has landed. 3.2 KB of shared memory a block, so
//   16 blocks an SM hide each other's latency (8 warps a run were 2-3 %
//   slower, a persistent grid was not tried: it was slower for the modern
//   kernel).
// - Four threads a pair: thread q writes the 8 output pixels 8q .. 8q + 7
//   of the pair, values 4q .. 4q + 3 of both blocks, as one 16-byte store.
//   Those four values of class c <= 10 take 4c <= 40 bits from bit 4qc,
//   byte qc / 2 at shift 4 (qc % 2): one 8-byte big-endian window, built
//   from three 32-bit shared-memory words by two byte permutes, holds all
//   four, and a field is then one shift and one mask. Class 16 is the same
//   rule at c = 16 (8 bytes at byte 8q); class 0 reads nothing.
// - A pair that crosses the cropped width, or any pair when width % 8 != 0,
//   takes masked 2-byte stores instead.
// - Offsets the host prep cannot produce (not inside [first, last], a
//   negative first, a span larger than the staging buffer) send the run to
//   per-byte bounded reads from device memory. Either way a byte at or past
//   n_bytes reads as 0: the staged copy zero-fills it, so no input is read
//   past its end.
// - Every launch is a batch of F frames of one geometry (a single frame is
//   the batch of one), with a frame axis (blockIdx.y = f). Frame f reads
//   its own bytes [bases[f], bases[f] + lengths[f]) of one concatenated
//   buffer (both clamped to the buffer), its own rows of the (F, nblk)
//   bits, refs and frame-local offsets, and writes its own (height, width)
//   plane of the (F, height, width) output: the span check and every
//   bounded read use the frame's own length, so a byte at or past it reads
//   as 0, never as the next frame's, and each frame is exactly what a batch
//   of that frame alone gives. Indices within a frame stay 32-bit; the
//   frame's base pointers are int64.

#include <cstdint>

#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

// The buffers of the checked build (kernels/build.py BUFFERS), in order:
// the entry's global buffers, then the kernel's shared arrays.
enum Buffer : int {
  kBufPayload, kBufBits, kBufRefs, kBufOffsets, kBufOut, kBufBases, kBufLengths,
  kBufSSpan, kBufSOff, kBufSCls, kBufSRef,
};

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRunPairs = kThreads / 4;
constexpr int kRunBlocks = 2 * kRunPairs;
constexpr int kMaxBlockBytes = 2 + 32;  // inline header + the 16-bit class
// Bytes past a block's offset that its windows may touch: the last window
// of class 16 starts at byte 24, and three words from a word-aligned start
// reach 11 bytes past the window's first byte.
constexpr int kWindowReach = 40;
// The run's span, 16-byte aligned at both ends (up to 15 bytes more at
// each), rounded up to 16.
constexpr int kSpanBytes =
    ((kRunBlocks - 1) * kMaxBlockBytes + kWindowReach + 2 * 15 + 15) & ~15;
constexpr int kSpanWords = kSpanBytes / 4;

static_assert(kRunBlocks <= kThreads, "one thread loads each block's metadata");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ uint32_t byte_at(const uint8_t* __restrict__ p, int64_t n,
                                            int64_t i MCRAW_CK_PARAM) {
  return (i >= 0 && i < n) ? static_cast<uint32_t>(MCRAW_LD(kBufPayload, p, i)) : 0u;
}

// The 8-byte big-endian window at byte s of the staged span: words
// s/4 .. s/4 + 2, bytes picked in reverse order by two permutes.
__device__ __forceinline__ uint64_t staged_window(const uint32_t* span, int s MCRAW_CK_PARAM) {
  const int i = s >> 2;
  // __byte_perm(x, y, sel): result byte k is byte (sel >> 4k) & 7 of y:x.
  // Bytes a + 3, a + 2, a + 1, a (a = s % 4) give the big-endian word.
  const unsigned be = 0x0123u + 0x1111u * static_cast<unsigned>(s & 3);
  const uint32_t w0 = MCRAW_SLDN(kBufSSpan, span, kSpanBytes, span, i);
  const uint32_t w1 = MCRAW_SLDN(kBufSSpan, span, kSpanBytes, span, i + 1);
  const uint32_t w2 = MCRAW_SLDN(kBufSSpan, span, kSpanBytes, span, i + 2);
  const uint32_t hi = __byte_perm(w0, w1, be);
  const uint32_t lo = __byte_perm(w1, w2, be);
  return static_cast<uint64_t>(hi) << 32 | lo;
}

// The same window read byte by byte from device memory, 0 outside
// [0, n_bytes).
__device__ __forceinline__ uint64_t bounded_window(const uint8_t* __restrict__ payload,
                                                   int64_t n_bytes, int64_t s MCRAW_CK_PARAM) {
  uint64_t w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) w = w << 8 | byte_at(payload, n_bytes, s + k MCRAW_CK);
  return w;
}

// Values 4q .. 4q + 3 of a block of class c from its window (references
// not added): field k ends at bit 4 (qc % 2) + (k + 1) c of the window.
__device__ __forceinline__ void quad_values(uint64_t win, int c, int q, uint32_t (&v)[4]) {
  const int sh = 4 * ((q * c) & 1);
  const uint32_t mask = (1u << c) - 1u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = static_cast<uint32_t>(win >> (64 - sh - (k + 1) * c)) & mask;
  }
}

// Frame blockIdx.y of a batch: payload is the concatenated buffer of
// n_bytes bytes, bases / lengths its (F,) per-frame spans, nblk the stride
// of the metadata rows and frame_elems that of the output planes.
__global__ void __launch_bounds__(kThreads) unpack_legacy_kernel(
    const uint8_t* __restrict__ payload, int64_t n_bytes, const int32_t* __restrict__ bits,
    const uint16_t* __restrict__ refs, const int64_t* __restrict__ offsets,
    uint16_t* __restrict__ out, int64_t pairs, int64_t pairs_per_row, int64_t width,
    const int64_t* __restrict__ bases, const int64_t* __restrict__ lengths, int64_t nblk,
    int64_t frame_elems MCRAW_CK_KERNEL_PARAM) {
  MCRAW_CK_KERNEL_INIT
  const int64_t f = blockIdx.y;
  int64_t base = MCRAW_LD(kBufBases, bases, f);
  int64_t len = MCRAW_LD(kBufLengths, lengths, f);
  MCRAW_CK_WINDOW(kBufPayload, payload, base, len, 1)
  base = base < 0 ? 0 : (base > n_bytes ? n_bytes : base);
  len = len < 0 ? 0 : (len > n_bytes - base ? n_bytes - base : len);
  payload += base;
  n_bytes = len;
  bits += f * nblk;
  refs += f * nblk;
  offsets += f * nblk;
  out += f * frame_elems;
  __shared__ __align__(16) uint32_t s_span[kSpanWords];
  __shared__ int64_t s_off[kRunBlocks];
  __shared__ int32_t s_cls[kRunBlocks];
  __shared__ uint32_t s_ref[kRunBlocks];

  const int tid = threadIdx.x;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kRunPairs;
  const int nb = 2 * static_cast<int>(pairs - p0 < kRunPairs ? pairs - p0 : kRunPairs);
  const int64_t b0 = 2 * p0;

  // The span from the run's first and last offsets, copied while the
  // metadata loads; whether the run may read it is decided after both.
  const int64_t lo = MCRAW_LD(kBufOffsets, offsets, b0);
  const int64_t last = MCRAW_LD(kBufOffsets, offsets, b0 + nb - 1);
  const int64_t lo16 = lo & ~int64_t{15};
  const int64_t hi16 = ((last < n_bytes ? last : n_bytes) + kWindowReach + 15) & ~int64_t{15};
  const bool span_ok = lo >= 0 && last >= lo && last <= n_bytes && hi16 - lo16 <= kSpanBytes;
  if (span_ok) {
    const bool aligned = (reinterpret_cast<uintptr_t>(payload) & 15) == 0;
    const int chunks = static_cast<int>((hi16 - lo16) >> 4);
    for (int i = tid; i < chunks; i += kThreads) {
      const int64_t g = lo16 + 16 * static_cast<int64_t>(i);  // byte in the payload
      if (aligned && g + 16 <= n_bytes) {
        MCRAW_CP_ASYNC16(kBufSSpan, s_span, s_span + 4 * i, kBufPayload, payload + g);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int64_t j = g + 4 * k;
          MCRAW_SST(kBufSSpan, s_span, s_span, 4 * i + k,
                    byte_at(payload, n_bytes, j MCRAW_CK) |
                        byte_at(payload, n_bytes, j + 1 MCRAW_CK) << 8 |
                        byte_at(payload, n_bytes, j + 2 MCRAW_CK) << 16 |
                        byte_at(payload, n_bytes, j + 3 MCRAW_CK) << 24);
        }
      }
    }
  }
  bool ok = span_ok;
  if (tid < nb) {
    const int bb = MCRAW_LD(kBufBits, bits, b0 + tid);
    const int cl = bb < 0 ? 0 : (bb > 16 ? 16 : bb);
    const int64_t o = MCRAW_LD(kBufOffsets, offsets, b0 + tid);
    MCRAW_SST(kBufSCls, s_cls, s_cls, tid, cl <= 10 ? cl : 16);
    MCRAW_SST(kBufSRef, s_ref, s_ref, tid, MCRAW_LD(kBufRefs, refs, b0 + tid));
    MCRAW_SST(kBufSOff, s_off, s_off, tid, o);
    ok = ok && o >= lo && o <= last;
  }
  cp_async_wait_all();
  const bool staged = __syncthreads_and(ok);

  // 32-bit index math: pairs < 2^31 (checked at the launch).
  const int lp = tid >> 2;  // pair within the run
  const int q = tid & 3;
  const int p = static_cast<int>(p0) + lp;
  if (p >= pairs) return;
  const int ppr = static_cast<int>(pairs_per_row);
  const int y = p / ppr;
  const int x = 32 * (p - y * ppr) + 8 * q;
  if (x >= width) return;
  uint32_t v[2][4];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int lb = 2 * lp + e;
    const int c = MCRAW_SLD(kBufSCls, s_cls, s_cls, lb);
    if (c == 0) {
      v[e][0] = v[e][1] = v[e][2] = v[e][3] = 0u;
    } else {
      // the window's first byte
      const int64_t s = MCRAW_SLD(kBufSOff, s_off, s_off, lb) + ((q * c) >> 1);
      const uint64_t win = staged ? staged_window(s_span, static_cast<int>(s - lo16) MCRAW_CK)
                                  : bounded_window(payload, n_bytes, s MCRAW_CK);
      quad_values(win, c, q, v[e]);
    }
    const uint32_t ref = MCRAW_SLD(kBufSRef, s_ref, s_ref, lb);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[e][k] = (v[e][k] + ref) & 0xFFFFu;
  }
  uint16_t* o = out + static_cast<int64_t>(y) * width + x;
  if ((width & 7) == 0 && x + 8 <= width) {
    MCRAW_ST(kBufOut, reinterpret_cast<uint4*>(o), 0,
             make_uint4(v[0][0] | v[1][0] << 16, v[0][1] | v[1][1] << 16,
                        v[0][2] | v[1][2] << 16, v[0][3] | v[1][3] << 16));
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (x + k < width) MCRAW_ST(kBufOut, o, k, static_cast<uint16_t>(v[k & 1][k >> 1]));
    }
  }
}

}  // namespace

// Frame f of `frames` (<= 65,535, the grid's y limit; a single frame is
// frames = 1) unpacks bytes [bases[f], bases[f] + lengths[f]) of the
// n_bytes-byte buffer `payload` (clamped to it) with row f of the (frames,
// nblk) bits, refs and offsets into the whole (height, width) uint16 plane
// f (height * width apart) of `out`; padded_width is the width rounded up
// to a multiple of 32, and a row of bits/refs/offsets holds nblk = height *
// padded_width / 16 blocks. One block of threads for each run of kRunPairs
// pairs and frame. bases and lengths are device arrays of int64 bytes.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mcraw_unpack_legacy_batch(const uint8_t* payload, int64_t n_bytes,
                                         const int64_t* bases, const int64_t* lengths,
                                         int64_t frames, const int32_t* bits,
                                         const uint16_t* refs, const int64_t* offsets,
                                         uint16_t* out, int64_t height, int64_t width,
                                         int64_t padded_width,
                                         void* stream MCRAW_CK_ENTRY_PARAM) {
  const int64_t pairs_per_row = padded_width / 32;
  const int64_t pairs = height * pairs_per_row;
  if (frames <= 0 || pairs <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  if (pairs > 0x7FFFFFFF || frames > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t runs = (pairs + kRunPairs - 1) / kRunPairs;
  const dim3 grid(static_cast<unsigned>(runs), static_cast<unsigned>(frames));
  unpack_legacy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      payload, n_bytes, bits, refs, offsets, out, pairs, pairs_per_row, width, bases, lengths,
      2 * pairs,
      height * width MCRAW_CK_LAUNCH(mcraw_check::kUnpackLegacy,
                                     mcraw_check::kEntryUnpackLegacyBatch));
  return static_cast<int>(cudaGetLastError());
}
