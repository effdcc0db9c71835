// Modern-codec (compressionType 7) block unpack + Bayer de-interleave.
//
// Replaces mcraw/kernels/pallas_unpack.py::_unpack_kernel_v5 (launched by
// _unpack_image_pallas_v5). It computes the same function, not the same
// machinery: the TPU kernel's chunk DMA, one-hot row picks, byte planes,
// subgroup layout and static field-pass count exist to work around the
// TPU's lack of a gather.
//
// The function: value j of block b is the OR of at most three
// little-endian word fields
//   ((word[offset[b] / 4 + widx] >> rsh) & (2^nbits - 1)) << lsh
// from the class's descriptors (mcraw_torch/kernels/tables.py MODERN_W*),
// plus the block's reference, wrapped to 16 bits; class 0 yields the
// reference. Output pixel (r, x): t = r / 4, h = (r / 2) % 2, q = r % 2,
// txi = x / 64, k = (x % 64) / 2, c = x % 2; block b = 4 * (t * tx + txi)
// + 2q + c, value j = 32h + k (the transpose (ty, h, q, tx, k, c) of
// numpy_ref.modern_deinterleave).
//
// What bounds it: bytes. A 4096x3072 12-bit frame reads a ~15 MB payload
// plus 196,608 x (uint16 bits, uint16 ref, int64 offset) = 2.4 MB and
// writes 25.2 MB, >= 0.0126 ms at 3.35 TB/s. The design follows one fact
// of the format: the four blocks of a 4-row x 64-column tile are
// consecutive in the stream, and so are the tiles along the stream, so a
// run of tiles reads one contiguous span of the payload.
//
// - A block of 8 warps takes a run of kRunTiles consecutive tiles. It loads
//   each block's bits, reference and offset once, into shared memory, and
//   copies the run's payload span [offset of its first block, offset of
//   its last + 128) into shared memory with 16-byte cp.async copies.
// - One warp per tile: lane l writes row l / 8 of the tile, columns
//   8 (l % 8) .. + 7: four values of each of the row's two blocks, taken
//   from shared memory, packed into one 16-byte store (a warp writes 4
//   rows x 128 bytes). A tile that crosses the cropped width, or any tile
//   when width % 8 != 0, takes masked 2-byte stores instead.
// - Values 4i .. 4i + 3 of a block come from the same bytes of 8-byte
//   SIMD groups, so in every class but the 16-bit one their fields share
//   the word and the mask and their right shifts step by 8: one int4 per
//   field (widx, rsh, mask, lsh) serves all four values
//   (tables.pack_quad_descriptors), and each field's word is read once.
//   Blocks of the 16-bit class take the straight copy: their four values
//   are 8 consecutive bytes.
// - Rows past `rows` (a short encodedHeight) are not written; the caller
//   zeroes them. Offsets the host prep cannot produce (not ascending, not
//   8-byte aligned, or a span larger than the staging buffer) send the run
//   to per-word reads from device memory; either way a word outside the
//   payload reads as 0, so a malformed offset never reads past the buffer.
// - Every launch is a batch of F frames of one geometry (a single frame is
//   the batch of one), with a frame axis (blockIdx.y = f). Frame f reads
//   its own words [bases[f], bases[f] + lengths[f]) of one concatenated
//   buffer (both clamped to the buffer), its own rows of the (F, nblk)
//   bits, refs and frame-local offsets, and writes its own (height, width)
//   plane of the (F, height, width) output, so it computes exactly what a
//   batch of that frame alone computes: a word at or past the frame's own
//   length reads as 0, never as the next frame's. Indices within a frame
//   stay 32-bit; the frame's base pointers are int64.

#include <cstdint>

#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

// The buffers of the checked build (kernels/build.py BUFFERS), in order:
// the entry's global buffers, then the kernel's shared arrays.
enum Buffer : int {
  kBufWords, kBufBits, kBufRefs, kBufOffsets, kBufDesc, kBufClassIndex, kBufOut, kBufBases,
  kBufLengths, kBufSDesc, kBufSWords, kBufSOff, kBufSCls, kBufSRef,
};

#ifdef MCRAW_CHECKED
#define MCRAW_WORDS_CK , &ck, s_words
#else
#define MCRAW_WORDS_CK
#endif

constexpr int kClasses = 10;
constexpr int kQuads = 16;                // groups of 4 values in a block
constexpr int kFields = 3;
constexpr int kDescRow = kQuads * kFields + 1;  // + (field count, 0, 0, 0)
constexpr int kDesc = kClasses * kDescRow;      // int4 entries
constexpr int64_t kDescBytes = kDesc * sizeof(int4);
constexpr int kBitsLut = 17;
constexpr int kClass16 = kClasses - 1;    // the 16-bit class: straight copy
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTilesPerWarp = 4;
constexpr int kRunTiles = kTilesPerWarp * kWarps;
constexpr int kRunBlocks = 4 * kRunTiles;
constexpr int kMaxBlockBytes = 128;
// The run's span, 16-byte aligned at both ends.
constexpr int kSpanBytes = kRunBlocks * kMaxBlockBytes + 32;
constexpr int kSpanWords = kSpanBytes / 4;

static_assert(kRunBlocks <= kThreads, "one thread loads each block's metadata");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// The block's words: from the staged span, or (kStaged false) from device
// memory by index, 0 outside [0, n_words).
template <bool kStaged>
struct Words {
  const uint32_t* staged;  // the block's first word in the span
  const int32_t* words;
  int64_t first;           // the block's first word in the payload
  int64_t n_words;
#ifdef MCRAW_CHECKED
  const mcraw_check::Check* check;
  const uint32_t* span;    // the staged span's first word
#endif
  __device__ __forceinline__ uint32_t operator[](int i) const {
#ifdef MCRAW_CHECKED
    const mcraw_check::Check& ck = *check;
#endif
    if constexpr (kStaged) {
      return MCRAW_SLDN(kBufSWords, span, kSpanBytes, staged, i);
    } else {
      const int64_t wi = first + i;
      return (wi >= 0 && wi < n_words) ? static_cast<uint32_t>(MCRAW_LD(kBufWords, words, wi))
                                       : 0u;
    }
  }
};

// Values j0 .. j0 + 3 of a block of class `cls`, references not added.
template <bool kStaged>
__device__ __forceinline__ void block_values(const Words<kStaged>& w, const int4* desc,
                                             int cls, int j0,
                                             uint32_t (&v)[4] MCRAW_CK_PARAM) {
  if (cls == kClass16) {
    const uint32_t w0 = w[j0 >> 1];
    const uint32_t w1 = w[(j0 >> 1) + 1];
    v[0] = w0 & 0xFFFFu;
    v[1] = w0 >> 16;
    v[2] = w1 & 0xFFFFu;
    v[3] = w1 >> 16;
    return;
  }
  const int4* d = desc + cls * kDescRow;
  const int nf = MCRAW_SLDN(kBufSDesc, desc, kDescBytes, d, kDescRow - 1).x;
  v[0] = v[1] = v[2] = v[3] = 0u;
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    if (f >= nf) break;
    const int4 e = MCRAW_SLDN(kBufSDesc, desc, kDescBytes, d, (j0 >> 2) * kFields + f);
    // e: widx, rsh, mask, lsh
    const uint32_t ws = w[e.x] >> e.y;
    const uint32_t mask = static_cast<uint32_t>(e.z);
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] |= ((ws >> (8 * u)) & mask) << e.w;
  }
}

// Frame blockIdx.y of a batch: words is the concatenated buffer of n_words
// words, bases / lengths its (F,) per-frame spans, nblk the stride of the
// metadata rows and frame_elems that of the output planes.
__global__ void __launch_bounds__(kThreads) unpack_modern_kernel(
    const int32_t* __restrict__ words, int64_t n_words, const uint16_t* __restrict__ bits,
    const uint16_t* __restrict__ refs, const int64_t* __restrict__ offsets,
    const int4* __restrict__ desc, const int64_t* __restrict__ class_index,
    uint16_t* __restrict__ out, int64_t tx, int64_t tiles, int64_t rows, int64_t width,
    const int64_t* __restrict__ bases, const int64_t* __restrict__ lengths, int64_t nblk,
    int64_t frame_elems MCRAW_CK_KERNEL_PARAM) {
  MCRAW_CK_KERNEL_INIT
  const int64_t f = blockIdx.y;
  int64_t base = MCRAW_LD(kBufBases, bases, f);
  int64_t len = MCRAW_LD(kBufLengths, lengths, f);
  MCRAW_CK_WINDOW(kBufWords, words, base, len, 4)
  base = base < 0 ? 0 : (base > n_words ? n_words : base);
  len = len < 0 ? 0 : (len > n_words - base ? n_words - base : len);
  words += base;
  n_words = len;
  bits += f * nblk;
  refs += f * nblk;
  offsets += f * nblk;
  out += f * frame_elems;
  __shared__ int4 s_desc[kDesc];
  __shared__ __align__(16) uint32_t s_words[kSpanWords];
  __shared__ int64_t s_off[kRunBlocks];
  __shared__ int32_t s_cls[kRunBlocks];
  __shared__ uint32_t s_ref[kRunBlocks];

  const int tid = threadIdx.x;
  const int64_t run = blockIdx.x;
  const int64_t b0 = run * kRunBlocks;
  const int nb = static_cast<int>(4 * tiles - b0 < kRunBlocks ? 4 * tiles - b0 : kRunBlocks);
  for (int i = tid; i < kDesc; i += kThreads) {
    MCRAW_SST(kBufSDesc, s_desc, s_desc, i, MCRAW_LD(kBufDesc, desc, i));
  }
  if (tid < nb) {
    const unsigned bb = MCRAW_LD(kBufBits, bits, b0 + tid);
    MCRAW_SST(kBufSCls, s_cls, s_cls, tid,
              static_cast<int32_t>(MCRAW_LD(kBufClassIndex, class_index, bb > 16 ? 16 : bb)));
    MCRAW_SST(kBufSRef, s_ref, s_ref, tid, MCRAW_LD(kBufRefs, refs, b0 + tid));
    MCRAW_SST(kBufSOff, s_off, s_off, tid, MCRAW_LD(kBufOffsets, offsets, b0 + tid));
  }
  __syncthreads();

  const int64_t lo = MCRAW_SLD(kBufSOff, s_off, s_off, 0);
  const int64_t last = MCRAW_SLD(kBufSOff, s_off, s_off, nb - 1);
  const int64_t lo16 = lo & ~int64_t{15};
  const int64_t hi16 = ((last & ~int64_t{3}) + kMaxBlockBytes + 15) & ~int64_t{15};
  bool ok = lo >= 0 && hi16 - lo16 <= kSpanBytes;
  if (tid < nb) {
    const int64_t o = MCRAW_SLD(kBufSOff, s_off, s_off, tid);
    ok = ok && o >= lo && o <= last && (o & 7) == 0;
  }
  const bool staged = __syncthreads_and(ok);
  if (staged) {
    const bool aligned = (reinterpret_cast<uintptr_t>(words) & 15) == 0;
    const int64_t n_bytes = 4 * n_words;
    const int chunks = static_cast<int>((hi16 - lo16) >> 4);
    for (int i = tid; i < chunks; i += kThreads) {
      const int64_t g = lo16 + 16 * static_cast<int64_t>(i);  // byte in the payload
      uint32_t* dst = s_words + 4 * i;
      if (aligned && g + 16 <= n_bytes) {
        MCRAW_CP_ASYNC16(kBufSWords, s_words, dst, kBufWords, words + (g >> 2));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int64_t wi = (g >> 2) + k;
          MCRAW_SST(kBufSWords, s_words, dst, k,
                    wi < n_words ? static_cast<uint32_t>(MCRAW_LD(kBufWords, words, wi)) : 0u);
        }
      }
    }
    cp_async_wait_all();
  }
  __syncthreads();

  // The lane's row of the tile, its half of the block values and columns.
  const int lane = tid & 31;
  const int rl = lane >> 3;
  const int q = rl & 1;
  const int m = lane & 7;
  const int j0 = 32 * (rl >> 1) + 4 * m;
  const bool vec = (width & 7) == 0;
#pragma unroll 1
  for (int k = 0; k < kTilesPerWarp; ++k) {
    const int tl = (tid >> 5) + kWarps * k;  // tile within the run
    // 32-bit index math: tiles <= height * width / 256 < 2^23.
    const int tile = static_cast<int>(run) * kRunTiles + tl;
    if (tile >= tiles) break;
    const int t = tile / static_cast<int>(tx);
    const int r = 4 * t + rl;
    const int x = 64 * (tile - t * static_cast<int>(tx)) + 8 * m;
    if (r >= rows || x >= width) continue;
    uint32_t v[2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int lb = 4 * tl + 2 * q + c;
      const int64_t off = MCRAW_SLD(kBufSOff, s_off, s_off, lb);
      if (staged) {
        const Words<true> w{s_words + ((off - lo16) >> 2), words, 0, n_words MCRAW_WORDS_CK};
        block_values(w, s_desc, MCRAW_SLD(kBufSCls, s_cls, s_cls, lb), j0, v[c] MCRAW_CK);
      } else {
        const Words<false> w{nullptr, words, off >> 2, n_words MCRAW_WORDS_CK};
        block_values(w, s_desc, MCRAW_SLD(kBufSCls, s_cls, s_cls, lb), j0, v[c] MCRAW_CK);
      }
      const uint32_t ref = MCRAW_SLD(kBufSRef, s_ref, s_ref, lb);
#pragma unroll
      for (int u = 0; u < 4; ++u) v[c][u] = (v[c][u] + ref) & 0xFFFFu;
    }
    uint16_t* o = out + static_cast<int64_t>(r) * width + x;
    if (vec && x + 8 <= width) {
      MCRAW_ST(kBufOut, reinterpret_cast<uint4*>(o), 0,
               make_uint4(v[0][0] | v[1][0] << 16, v[0][1] | v[1][1] << 16,
                          v[0][2] | v[1][2] << 16, v[0][3] | v[1][3] << 16));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (x + e < width) MCRAW_ST(kBufOut, o, e, static_cast<uint16_t>(v[e & 1][e >> 1]));
      }
    }
  }
}

}  // namespace

// Frame f of `frames` (<= 65,535, the grid's y limit; a single frame is
// frames = 1) unpacks words [bases[f], bases[f] + lengths[f]) of the
// n_words-word buffer `words` (clamped to it) with row f of the (frames,
// nblk) bits, refs and offsets into plane f (frame_elems = height * width
// apart) of `out`: rows [0, rows) of each (., width) uint16 plane from its
// first `tiles` tiles (tiles = ceil(rows / 4) * tx), one block of threads
// for each run of kRunTiles and frame; rows past them keep whatever the
// caller allocated (zeros for a short encodedHeight). bases and lengths
// are device arrays of int64 words; desc is the (10, 49) int4 table of
// tables.pack_quad_descriptors. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int mcraw_unpack_modern_batch(const int32_t* words, int64_t n_words,
                                         const int64_t* bases, const int64_t* lengths,
                                         int64_t frames, int64_t nblk, const uint16_t* bits,
                                         const uint16_t* refs, const int64_t* offsets,
                                         const int32_t* desc, const int64_t* class_index,
                                         uint16_t* out, int64_t frame_elems, int64_t tx,
                                         int64_t tiles, int64_t rows, int64_t width,
                                         void* stream MCRAW_CK_ENTRY_PARAM) {
  if (frames <= 0 || tiles <= 0 || rows <= 0 || width <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t runs = (tiles + kRunTiles - 1) / kRunTiles;
  if (runs > 0x7FFFFFFF || frames > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(runs), static_cast<unsigned>(frames));
  unpack_modern_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      words, n_words, bits, refs, offsets, reinterpret_cast<const int4*>(desc), class_index,
      out, tx, tiles, rows, width, bases, lengths, nblk,
      frame_elems MCRAW_CK_LAUNCH(mcraw_check::kUnpackModern,
                                  mcraw_check::kEntryUnpackModernBatch));
  return static_cast<int>(cudaGetLastError());
}
