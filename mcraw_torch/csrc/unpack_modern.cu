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
// run of kRunTiles tiles reads one contiguous span of the payload. What it
// does about the bytes is keep each block's loads in flight while it
// unpacks and stores:
//
// - The grid is persistent: min(frames x runs, the blocks the card holds
//   at once), computed by the wrapper (kernels/unpack.py::modern_grid) from
//   mcraw_unpack_modern_resident. Block b takes the (frame, run) pairs
//   f * runs + run = b, b + gridDim.x, ..., frame-major; it steps its
//   frame and run by the grid's, so it divides only where it starts.
// - Warp kWarps of a block is its producer. For each of the block's runs
//   it loads each block's offset, bits (mapped to its class) and
//   reference, tests the offsets (below), and writes them into the next of
//   kStages stages of a ring in shared memory; one lane copies the run's
//   payload span [offset of its first block, offset of its last + 128),
//   16-byte aligned at both ends, into the stage with one 1-D TMA bulk copy
//   (cp.async.bulk), which completes the stage's full mbarrier. It runs up
//   to kStages runs ahead of the 8 unpacking warps, which release a stage
//   on its empty mbarrier: the next run's loads are in flight while they
//   unpack and store the current one. Where the span cannot go by bulk
//   copy (the frame's words not 16-byte aligned, or the span reaching past
//   the frame's payload), the unpacking warps copy it themselves with
//   16-byte cp.async copies, a word past the payload read as 0.
// - Once a block, the descriptor table goes into shared memory and the
//   17-entry class index into the producer's lanes (a shuffle maps bits).
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
//   zeroes them. Offsets the host prep cannot produce (outside [the run's
//   first, its last], not 8-byte aligned, or a span larger than a stage)
//   send the run to per-word reads from device memory; either way a word
//   outside the payload reads as 0, so a malformed offset never reads past
//   the buffer.
// - Every launch is a batch of F frames of one geometry (a single frame is
//   the batch of one). Frame f reads its own words [bases[f], bases[f] +
//   lengths[f]) of one concatenated buffer (both clamped to the buffer),
//   its own rows of the (F, nblk) bits, refs and frame-local offsets, and
//   writes its own (height, width) plane of the (F, height, width) output,
//   so it computes exactly what a batch of that frame alone computes: a
//   word at or past the frame's own length reads as 0, never as the next
//   frame's. Indices within a frame stay 32-bit; the frame's base pointers
//   are int64.

#include <cstdint>

#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

// The buffers of the checked build (kernels/build.py BUFFERS), in order:
// the entry's global buffers, then the kernel's shared arrays (the ring's
// stage arrays hold every stage).
enum Buffer : int {
  kBufWords, kBufBits, kBufRefs, kBufOffsets, kBufDesc, kBufClassIndex, kBufOut, kBufBases,
  kBufLengths, kBufSDesc, kBufSWords, kBufSOff, kBufSCls, kBufSRef, kBufSHead,
};

#ifdef MCRAW_CHECKED
#define MCRAW_WORDS_CK , &ck, &s_words[0][0]
// A bulk copy's source: n bytes from p, inside the words.
#define MCRAW_BULK_OK(p, n) mcraw_check::global_ok(ck, kBufWords, p, n, mcraw_check::kCpAsync)
#else
#define MCRAW_WORDS_CK
#define MCRAW_BULK_OK(p, n) true
#endif

constexpr int kClasses = 10;
constexpr int kQuads = 16;                // groups of 4 values in a block
constexpr int kFields = 3;
constexpr int kDescRow = kQuads * kFields + 1;  // + (field count, 0, 0, 0)
constexpr int kDesc = kClasses * kDescRow;      // int4 entries
constexpr int64_t kDescBytes = kDesc * sizeof(int4);
constexpr int kBitsLut = 17;              // class_index's entries: bits clamp to 16
constexpr int kClass16 = kClasses - 1;    // the 16-bit class: straight copy
constexpr int kWarps = 8;                 // the unpacking warps
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockThreads = kThreads + 32;  // and the producer warp
constexpr int kRunTiles = 32;             // kernels/unpack.py RUN_TILES
constexpr int kTilesPerWarp = kRunTiles / kWarps;
constexpr int kRunBlocks = 4 * kRunTiles;
constexpr int kMaxBlockBytes = 128;
// A run's span, 16-byte aligned at both ends.
constexpr int kSpanBytes = kRunBlocks * kMaxBlockBytes + 32;
constexpr int kSpanWords = kSpanBytes / 4;
// 3 stages and 3 blocks an SM: the fastest of (stages, blocks) = (2, 5),
// (2, 4), (3, 3) and (4, 2), the most that fit in an SM's shared memory,
// on an H100 (python -m mcraw_torch.kernel_ab, ms a batch of 16 UHD frames
// in turns: 0.1799, 0.1775, 0.1738, 0.1863; of 8: 0.0961, 0.0947, 0.0918,
// 0.0986; one 4096x3072 frame: 0.0263, 0.0251, 0.0249, 0.0262).
constexpr int kStages = 3;
constexpr int kBlocksPerSm = 3;

static_assert(kRunTiles % kWarps == 0, "each warp takes the same tiles of a run");
static_assert(kRunBlocks == 4 * 32, "each producer lane loads four blocks' metadata");
static_assert(kBitsLut <= 32, "a producer lane holds each class index entry");
static_assert(kSpanBytes % 16 == 0, "each stage's span starts 16-byte aligned");

// How a stage's run is staged.
enum How : int32_t {
  kBulk = 0,  // the span by the producer's bulk copy
  kCopy,      // the span by the unpacking warps' cp.async copies
  kByWord,    // not staged: per-word reads from device memory
};

// A stage's header, from the producer.
struct Head {
  int64_t lo16;   // the span's first byte in the frame's payload
  int32_t how, f, run;
  int32_t bytes;  // the span's length
};

// A block's dynamic shared memory, in this order: each stage's span,
// offsets, classes and references, the descriptor table, the stages'
// headers, their full and empty mbarriers.
constexpr int64_t kWordsBytes = int64_t{kStages} * kSpanBytes;
constexpr int64_t kOffAt = kWordsBytes;
constexpr int64_t kClsAt = kOffAt + int64_t{kStages} * kRunBlocks * sizeof(int64_t);
constexpr int64_t kRefAt = kClsAt + int64_t{kStages} * kRunBlocks * sizeof(int32_t);
constexpr int64_t kDescAt = kRefAt + int64_t{kStages} * kRunBlocks * sizeof(uint32_t);
constexpr int64_t kHeadAt = kDescAt + kDescBytes;
constexpr int64_t kBarAt = kHeadAt + int64_t{kStages} * sizeof(Head);
constexpr int64_t kSmemBytes = kBarAt + 2 * kStages * sizeof(uint64_t);
static_assert(kDescAt % 16 == 0 && kHeadAt % 8 == 0 && kBarAt % 8 == 0,
              "shared arrays stay aligned");

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem(dst)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem(bar)) : "memory");
}

// Arrives and adds `bytes` to the phase's expected transfer.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed (a fresh barrier
// counts the phase before its first, of parity 1, as complete).
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from `src` to `dst` (both 16-byte aligned)
// by the Tensor Memory Accelerator; they complete `bar`'s phase.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

// The unpacking warps' own barrier (the producer warp is not in it).
__device__ __forceinline__ void unpackers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
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
  const uint32_t* ring;    // the first word of the ring's spans
#endif
  __device__ __forceinline__ uint32_t operator[](int i) const {
#ifdef MCRAW_CHECKED
    const mcraw_check::Check& ck = *check;
#endif
    if constexpr (kStaged) {
      return MCRAW_SLDN(kBufSWords, ring, kWordsBytes, staged, i);
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

// A batch of `total` = frames x runs runs: words is the concatenated
// buffer of n_words words, bases / lengths its (F,) per-frame spans, nblk
// the stride of the metadata rows and frame_elems that of the output
// planes.
__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSm) unpack_modern_kernel(
    const int32_t* __restrict__ words, int64_t n_words, const uint16_t* __restrict__ bits,
    const uint16_t* __restrict__ refs, const int64_t* __restrict__ offsets,
    const int4* __restrict__ desc, const int64_t* __restrict__ class_index,
    uint16_t* __restrict__ out, int64_t tx, int64_t tiles, int64_t rows, int64_t width,
    const int64_t* __restrict__ bases, const int64_t* __restrict__ lengths, int64_t nblk,
    int64_t frame_elems, int total MCRAW_CK_KERNEL_PARAM) {
  MCRAW_CK_KERNEL_INIT
  extern __shared__ __align__(128) unsigned char s_smem[];
  auto& s_words = *reinterpret_cast<uint32_t (*)[kStages][kSpanWords]>(s_smem);
  auto& s_off = *reinterpret_cast<int64_t (*)[kStages][kRunBlocks]>(s_smem + kOffAt);
  auto& s_cls = *reinterpret_cast<int32_t (*)[kStages][kRunBlocks]>(s_smem + kClsAt);
  auto& s_ref = *reinterpret_cast<uint32_t (*)[kStages][kRunBlocks]>(s_smem + kRefAt);
  auto& s_desc = *reinterpret_cast<int4 (*)[kDesc]>(s_smem + kDescAt);
  auto& s_head = *reinterpret_cast<Head (*)[kStages]>(s_smem + kHeadAt);
  uint64_t* full = reinterpret_cast<uint64_t*>(s_smem + kBarAt);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + s, 32);         // every producer lane
      bar_init(empty + s, kThreads);  // every unpacking thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Frame f's words, its base and length clamped to the buffer; n: their
  // count.
  auto frame = [&](int f, int64_t& n) {
    int64_t base = MCRAW_LD(kBufBases, bases, f);
    int64_t len = MCRAW_LD(kBufLengths, lengths, f);
    MCRAW_CK_WINDOW(kBufWords, words, base, len, 4)
    base = base < 0 ? 0 : (base > n_words ? n_words : base);
    len = len < 0 ? 0 : (len > n_words - base ? n_words - base : len);
    n = len;
    return words + base;
  };
  const int runs = static_cast<int>((tiles + kRunTiles - 1) / kRunTiles);
  const int grid = static_cast<int>(gridDim.x);
  const int mine = (total - static_cast<int>(blockIdx.x) + grid - 1) / grid;  // the block's runs
  int stage = 0;
  uint32_t phase = 0;
  int cur = -1;  // the frame of `fw`
  const int32_t* fw = words;
  int64_t fn = 0;

  if (tid >= kThreads) {  // the producer warp
    const int lane = tid - kThreads;
    // The class index once a block: lane i < kBitsLut holds entry i.
    const int32_t lane_class = lane < kBitsLut
        ? static_cast<int32_t>(MCRAW_LD(kBufClassIndex, class_index, lane)) : 0;
    const int step_f = grid / runs;
    const int step_r = grid - step_f * runs;
    int f = static_cast<int>(blockIdx.x) / runs;
    int run = static_cast<int>(blockIdx.x) - f * runs;
    for (int k = 0; k < mine; ++k) {
      if (f != cur) {
        cur = f;
        fw = frame(f, fn);
      }
      const int64_t b0 = static_cast<int64_t>(run) * kRunBlocks;
      const int nb = static_cast<int>(4 * tiles - b0 < kRunBlocks ? 4 * tiles - b0 : kRunBlocks);
      const int64_t row = static_cast<int64_t>(f) * nblk + b0;
      int64_t o[4];
      int32_t cls[4];
      uint32_t ref[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int b = 4 * lane + u;
        uint32_t bb = 0u;
        o[u] = 0;
        ref[u] = 0u;
        if (b < nb) {
          o[u] = MCRAW_LD(kBufOffsets, offsets, row + b);
          bb = MCRAW_LD(kBufBits, bits, row + b);
          ref[u] = MCRAW_LD(kBufRefs, refs, row + b);
        }
        cls[u] = __shfl_sync(~0u, lane_class, bb < kBitsLut ? bb : kBitsLut - 1);
      }
      // The run's first and last offsets: lane 0's first, and the last
      // block's lane's.
      const int li = (nb - 1) & 3;
      const int64_t my_last = li == 0 ? o[0] : li == 1 ? o[1] : li == 2 ? o[2] : o[3];
      const int64_t lo = __shfl_sync(~0u, o[0], 0);
      const int64_t last = __shfl_sync(~0u, my_last, (nb - 1) >> 2);
      const int64_t lo16 = lo & ~int64_t{15};
      const int64_t hi16 = ((last & ~int64_t{3}) + kMaxBlockBytes + 15) & ~int64_t{15};
      bool ok = lo >= 0 && hi16 - lo16 <= kSpanBytes;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (4 * lane + u < nb) ok = ok && o[u] >= lo && o[u] <= last && (o[u] & 7) == 0;
      }
      const bool staged = __all_sync(~0u, ok);
      const bool bulk =
          staged && (reinterpret_cast<uintptr_t>(fw) & 15) == 0 && hi16 <= 4 * fn;
      bar_wait(empty + stage, phase ^ 1);  // the unpacking warps are done with the stage
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int b = 4 * lane + u;
        if (b < nb) {
          MCRAW_SST(kBufSOff, s_off, s_off[stage], b, o[u]);
          MCRAW_SST(kBufSCls, s_cls, s_cls[stage], b, cls[u]);
          MCRAW_SST(kBufSRef, s_ref, s_ref[stage], b, ref[u]);
        }
      }
      if (lane == 0) {
        const int32_t n = static_cast<int32_t>(staged ? hi16 - lo16 : 0);
        MCRAW_SST(kBufSHead, s_head, s_head, stage,
                  (Head{lo16, bulk ? kBulk : staged ? kCopy : kByWord, f, run, n}));
        uint32_t* dst = s_words[stage];
        if (bulk && MCRAW_SHARED_OK(kBufSWords, s_words, kWordsBytes, dst, n) &&
            MCRAW_BULK_OK(fw + (lo16 >> 2), n)) {
          bar_arrive_tx(full + stage, static_cast<uint32_t>(n));
          bulk_copy(dst, fw + (lo16 >> 2), static_cast<uint32_t>(n), full + stage);
        } else {
          bar_arrive(full + stage);  // no bulk copy (or the checked build's skipped one)
        }
      } else {
        bar_arrive(full + stage);
      }
      run += step_r;
      f += step_f;
      if (run >= runs) {
        run -= runs;
        ++f;
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  for (int i = tid; i < kDesc; i += kThreads) {
    MCRAW_SST(kBufSDesc, s_desc, s_desc, i, MCRAW_LD(kBufDesc, desc, i));
  }
  unpackers_sync();

  // The lane's row of the tile, its half of the block values and columns.
  const int lane = tid & 31;
  const int rl = lane >> 3;
  const int q = rl & 1;
  const int m = lane & 7;
  const int j0 = 32 * (rl >> 1) + 4 * m;
  const bool vec = (width & 7) == 0;
  uint16_t* fout = out;
#pragma unroll 1
  for (int k = 0; k < mine; ++k) {
    bar_wait(full + stage, phase);
    const Head h = MCRAW_SLD(kBufSHead, s_head, s_head, stage);
    if (h.f != cur) {
      cur = h.f;
      fw = frame(cur, fn);
      fout = out + static_cast<int64_t>(cur) * frame_elems;
    }
    if (h.how == kCopy) {
      const bool aligned = (reinterpret_cast<uintptr_t>(fw) & 15) == 0;
      const int64_t n_bytes = 4 * fn;
      for (int i = tid; i < (h.bytes >> 4); i += kThreads) {
        const int64_t g = h.lo16 + 16 * static_cast<int64_t>(i);  // byte in the payload
        uint32_t* dst = s_words[stage] + 4 * i;
        if (aligned && g + 16 <= n_bytes) {
          MCRAW_CP_ASYNC16(kBufSWords, s_words, dst, kBufWords, fw + (g >> 2));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t wi = (g >> 2) + e;
            MCRAW_SST(kBufSWords, s_words, dst, e,
                      wi < fn ? static_cast<uint32_t>(MCRAW_LD(kBufWords, fw, wi)) : 0u);
          }
        }
      }
      cp_async_wait_all();
      // The stage's next span may come by bulk copy, through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      unpackers_sync();
    }
    const bool staged = h.how != kByWord;
#pragma unroll 1
    for (int t = 0; t < kTilesPerWarp; ++t) {
      const int tl = (tid >> 5) + kWarps * t;  // tile within the run
      // 32-bit index math: tiles <= height * width / 256 < 2^23.
      const int tile = h.run * kRunTiles + tl;
      if (tile >= tiles) break;
      const int ty = tile / static_cast<int>(tx);
      const int r = 4 * ty + rl;
      const int x = 64 * (tile - ty * static_cast<int>(tx)) + 8 * m;
      if (r >= rows || x >= width) continue;
      uint32_t v[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int lb = 4 * tl + 2 * q + c;
        const int64_t off = MCRAW_SLD(kBufSOff, s_off, s_off[stage], lb);
        const int cls = MCRAW_SLD(kBufSCls, s_cls, s_cls[stage], lb);
        if (staged) {
          const Words<true> w{s_words[stage] + ((off - h.lo16) >> 2), fw, 0, fn MCRAW_WORDS_CK};
          block_values(w, s_desc, cls, j0, v[c] MCRAW_CK);
        } else {
          const Words<false> w{nullptr, fw, off >> 2, fn MCRAW_WORDS_CK};
          block_values(w, s_desc, cls, j0, v[c] MCRAW_CK);
        }
        const uint32_t ref = MCRAW_SLD(kBufSRef, s_ref, s_ref[stage], lb);
#pragma unroll
        for (int u = 0; u < 4; ++u) v[c][u] = (v[c][u] + ref) & 0xFFFFu;
      }
      uint16_t* o = fout + static_cast<int64_t>(r) * width + x;
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
    bar_arrive(empty + stage);  // this thread is done with the stage
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

}  // namespace

// The blocks of unpack_modern_kernel the current device holds at once
// (blocks an SM x SMs), the most a launch's grid needs; it also lets the
// kernel have its dynamic shared memory there. A CUDA error comes back
// negated (0 or less: no grid).
extern "C" int64_t mcraw_unpack_modern_resident() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(unpack_modern_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, unpack_modern_kernel,
                                                        kBlockThreads, kSmemBytes);
  }
  return err == cudaSuccess ? int64_t{sms} * per_sm : -static_cast<int64_t>(err);
}

// Frame f of `frames` (a single frame is frames = 1) unpacks words
// [bases[f], bases[f] + lengths[f]) of the n_words-word buffer `words`
// (clamped to it) with row f of the (frames, nblk) bits, refs and offsets
// into plane f (frame_elems = height * width apart) of `out`: rows [0,
// rows) of each (., width) uint16 plane from its first `tiles` tiles
// (tiles = ceil(rows / 4) * tx), in `grid` persistent blocks of threads
// (kernels/unpack.py::modern_grid: 1 <= grid <= frames x runs of
// kRunTiles, after mcraw_unpack_modern_resident on this device); rows past
// them keep whatever the caller allocated (zeros for a short
// encodedHeight). bases and lengths are device arrays of int64 words; desc
// is the (10, 49) int4 table of tables.pack_quad_descriptors. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int mcraw_unpack_modern_batch(const int32_t* words, int64_t n_words,
                                         const int64_t* bases, const int64_t* lengths,
                                         int64_t frames, int64_t nblk, const uint16_t* bits,
                                         const uint16_t* refs, const int64_t* offsets,
                                         const int32_t* desc, const int64_t* class_index,
                                         uint16_t* out, int64_t frame_elems, int64_t tx,
                                         int64_t tiles, int64_t rows, int64_t width,
                                         int64_t grid, void* stream MCRAW_CK_ENTRY_PARAM) {
  if (frames <= 0 || tiles <= 0 || rows <= 0 || width <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t runs = (tiles + kRunTiles - 1) / kRunTiles;
  if (runs > 0x7FFFFFFF / frames || grid < 1 || grid > frames * runs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unpack_modern_kernel<<<static_cast<unsigned>(grid), kBlockThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      words, n_words, bits, refs, offsets, reinterpret_cast<const int4*>(desc), class_index,
      out, tx, tiles, rows, width, bases, lengths, nblk, frame_elems,
      static_cast<int>(frames * runs) MCRAW_CK_LAUNCH(mcraw_check::kUnpackModern,
                                                      mcraw_check::kEntryUnpackModernBatch));
  return static_cast<int>(cudaGetLastError());
}
