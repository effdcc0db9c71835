// Modern-codec (compressionType 7) device prep: every block's payload byte
// offset.
//
// The counterpart of the offset computation of
// mcraw/kernels/pallas_unpack.py::_v6_build_meta (plain jnp outside any
// pallas_call: the prefix sum as two triangular matmuls on the MXU) and of
// mcraw/kernels/unpack.py::prepare_modern's offsets. For bits of shape
// (nblk,) or (F, nblk), each row its own scan:
//
//   offsets[f, i] = 16 + sum_{j < i} length(min(bits[f, j], 16))
//
// with length() the table tables.MODERN_BLOCK_LENGTH as arithmetic (8 b for
// b <= 6, then 64, 64, 80, 80 and 128 for 11..16), in int64: at 8K a row's
// sum reaches ~4e8.
//
// What bounds it: bytes. A 4096x3072 frame has 786,432 blocks: 1.57 MB of
// uint16 in, 6.29 MB of int64 out, >= 0.00235 ms at 3.35 TB/s. The design
// is one pass over the data, a single-pass scan with decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016):
//
// - A tile is kTile consecutive blocks of one row; a tile never straddles
//   two rows, and a row's first tile starts at 16. The grid has one block
//   of threads per tile of every row (one launch for F rows).
// - Each block of threads takes its tile from an atomic ticket (word 0 of
//   the status scratch), not from blockIdx: tiles are handed out in order,
//   so a tile waits only on tiles whose blocks already run, whatever order
//   the card starts blocks in.
// - A thread reads its kItems consecutive bits (two 16-byte loads where
//   the row is 16-byte aligned and the tile full, 2-byte loads otherwise),
//   maps them to lengths and sums them in registers; warp shuffles and
//   shared memory scan the threads' sums into the tile's exclusive
//   offsets (int32: a tile holds at most kTile * 128 bytes) and its total.
// - Tile status: word 1 + tile of the scratch, flag and value in one
//   64-bit word (kFlagAggregate | the tile's total, then kFlagPrefix | the
//   row's sum through the tile), written with st.release.gpu and read with
//   ld.acquire.gpu. Warp 0 publishes the tile's total, then looks back at
//   32 predecessors at a time, adding totals until the nearest one whose
//   prefix is known, and publishes its own prefix.
// - The tile's offsets go through shared memory (one pad word every 32,
//   so the blocked writes and the striped reads are free of bank
//   conflicts) to coalesced int64 stores.
//
// The status scratch belongs to the launch: the wrapper allocates it on
// the launch's stream and the entry zeroes it (cudaMemsetAsync) on that
// stream before the kernel, so launches on several streams of one card
// never share a ticket or a status word. The prep is two device
// operations: the memset and the kernel.

#include <cstdint>

#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

// The buffers of the checked build (kernels/build.py BUFFERS), in order:
// the entry's global buffers, then the kernel's shared arrays.
enum Buffer : int { kBufBits, kBufOffsets, kBufStatus, kBufSLocal, kBufSWarp, kBufSTile };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;  // blocks a tile (kernels/offsets.py TILE)
constexpr int kItems = kTile / kThreads;
// The tile's offsets in shared memory, one pad word after every 32.
constexpr int kLocalWords = kTile + (kTile - 1) / 32;
constexpr int64_t kMetadataOffset = 16;
constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned long long kValue = kFlagAggregate - 1;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kItems == 16, "a thread reads its bits as two 16-byte loads");

// tables.MODERN_BLOCK_LENGTH[min(b, 16)].
__device__ __forceinline__ int block_length(unsigned b) {
  return b <= 6 ? 8 * static_cast<int>(b) : b <= 8 ? 64 : b <= 10 ? 80 : 128;
}

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(kThreads)
    block_offsets_kernel(const uint16_t* __restrict__ bits, int64_t nblk, int64_t row_tiles,
                         int64_t* __restrict__ out,
                         unsigned long long* __restrict__ status MCRAW_CK_KERNEL_PARAM) {
  MCRAW_CK_KERNEL_INIT
  __shared__ int s_local[kLocalWords];
  __shared__ int s_warp[kWarps];
  __shared__ long long s_tile[2];  // the tile's number, its exclusive prefix in its row
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) {
    MCRAW_SST(kBufSTile, s_tile, s_tile, 0,
              static_cast<long long>(MCRAW_ATOMIC_TICKET(kBufStatus, status, blockIdx.x)));
  }
  __syncthreads();
  const int64_t g = MCRAW_SLD(kBufSTile, s_tile, s_tile, 0);
  const int64_t f = g / row_tiles;
  const int64_t j = g - f * row_tiles;  // the tile's place in its row
  const int64_t start = j * kTile;
  const int64_t n = nblk - start < kTile ? nblk - start : kTile;
  const uint16_t* row = bits + f * nblk;

  // The thread's lengths, then their exclusive sums within the thread.
  int len[kItems];
  const int64_t first = start + t * kItems;
  if (n == kTile && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(row + start);
    const uint4 a = MCRAW_LDG(kBufBits, v, 2 * t);
    const uint4 b = MCRAW_LDG(kBufBits, v, 2 * t + 1);
    const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      len[2 * k] = block_length(w[k] & 0xFFFFu);
      len[2 * k + 1] = block_length(w[k] >> 16);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      len[k] = first + k < nblk ? block_length(MCRAW_LDG(kBufBits, row, first + k)) : 0;
    }
  }
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int l = len[k];
    len[k] = sum;
    sum += l;
  }

  // The threads' sums scanned across the tile: within each warp by
  // shuffles, then the warps' totals by warp 0.
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) MCRAW_SST(kBufSWarp, s_warp, s_warp, warp, incl);
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? MCRAW_SLD(kBufSWarp, s_warp, s_warp, lane) : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) MCRAW_SST(kBufSWarp, s_warp, s_warp, lane, w);
  }
  __syncthreads();
  const int before = (warp > 0 ? MCRAW_SLD(kBufSWarp, s_warp, s_warp, warp - 1) : 0) +
                     incl - sum;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    MCRAW_SST(kBufSLocal, s_local, s_local, padded(t * kItems + k), before + len[k]);
  }

  // The tile's prefix in its row: decoupled look-back by warp 0.
  if (warp == 0) {
    const unsigned long long total =
        static_cast<unsigned long long>(MCRAW_SLD(kBufSWarp, s_warp, s_warp, kWarps - 1));
    unsigned long long* tiles = status + 1;
    long long prefix = 0;
    if (j == 0) {
      if (lane == 0) MCRAW_ST_RELEASE(kBufStatus, tiles, g, kFlagPrefix | total);
    } else {
      if (lane == 0) MCRAW_ST_RELEASE(kBufStatus, tiles, g, kFlagAggregate | total);
      const int64_t row_first = g - j;
      for (int64_t look = g - 1;; look -= 32) {
        // Lane l reads tile look - l; before the row's first tile, nothing
        // (the first tile's prefix ends every look-back).
        const int64_t p = look - lane;
        unsigned long long s;
        for (;;) {
          s = p >= row_first ? MCRAW_LD_ACQUIRE(kBufStatus, tiles, p, kFlagPrefix) : kFlagPrefix;
          if (__all_sync(kFull, s != 0)) break;
          __nanosleep(64);
        }
        const unsigned known = __ballot_sync(kFull, (s & kFlagPrefix) != 0);
        const int last = known ? __ffs(known) - 1 : 31;  // the nearest known prefix
        long long v = lane <= last ? static_cast<long long>(s & kValue) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        prefix += v;
        if (known) break;
      }
      if (lane == 0) {
        MCRAW_ST_RELEASE(kBufStatus, tiles, g,
                         kFlagPrefix | (static_cast<unsigned long long>(prefix) + total));
      }
    }
    if (lane == 0) MCRAW_SST(kBufSTile, s_tile, s_tile, 1, prefix);
  }
  __syncthreads();

  const long long base = kMetadataOffset + MCRAW_SLD(kBufSTile, s_tile, s_tile, 1);
  int64_t* dst = out + f * nblk + start;
  for (int e = t; e < n; e += kThreads) {
    MCRAW_ST(kBufOffsets, dst, e, base + MCRAW_SLD(kBufSLocal, s_local, s_local, padded(e)));
  }
}

// The launch's tiles, or -1 where the arguments cannot be launched.
int64_t launch_tiles(int64_t frames, int64_t nblk, int64_t status_words) {
  if (frames < 0 || nblk < 0) return -1;
  const int64_t tiles = frames * ((nblk + kTile - 1) / kTile);
  if (tiles > 0x7FFFFFFF || status_words < 1 + tiles) return -1;
  return tiles;
}

}  // namespace

// Row f of the (frames, nblk) uint16 bits into row f of the (frames, nblk)
// int64 offsets, each row its own scan from 16, in one launch (one frame's
// bits are the batch of one). status: status_words >= 1 + frames *
// ceil(nblk / kTile) int64 of scratch, zeroed here on `stream` before the
// launch. Returns cudaGetLastError() after the launch (0 on success;
// nothing is enqueued for no blocks), or cudaErrorInvalidValue for a
// scratch too small.
extern "C" int mcraw_block_offsets_batch(const uint16_t* bits, int64_t frames, int64_t nblk,
                                         int64_t* out, unsigned long long* status,
                                         int64_t status_words,
                                         void* stream MCRAW_CK_ENTRY_PARAM) {
  const int64_t tiles = launch_tiles(frames, nblk, status_words);
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t scratch = static_cast<size_t>(1 + tiles) * sizeof(unsigned long long);
  MCRAW_CK_HOST(mcraw_check::kBlockOffsets, mcraw_check::kEntryBlockOffsetsBatch, kBufStatus,
                kStore, static_cast<int64_t>(scratch))
  const cudaError_t err = cudaMemsetAsync(status, 0, scratch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_offsets_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      bits, nblk, tiles / frames, out,
      status MCRAW_CK_LAUNCH(mcraw_check::kBlockOffsets, mcraw_check::kEntryBlockOffsetsBatch));
  return static_cast<int>(cudaGetLastError());
}
