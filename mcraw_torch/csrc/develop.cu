// Develop: Bayer uint16 -> packed RGBA8888 (R | G<<8 | B<<16 | 0xFF<<24).
//
// Replaces mcraw/kernels/pallas_develop.py::_develop_kernel and
// _develop_emit (launched by develop_rgba_pallas). It computes their
// function, not their machinery: the row bands with double-buffered DMA,
// the 16-sublane-aligned halo scratch, the per-frame top padding and frame
// blocks, lane rolls with the wrapped lane zeroed and 128-lane width
// padding exist for VMEM and vregs.
//
// What bounds it: at 4096x3072 it reads 25.2 MB of uint16 and writes
// 50.3 MB of uint32, 75.5 MB in all, >= 0.0225 ms at 3.35 TB/s; the
// arithmetic is ~100 float and integer operations per pixel, so the design
// is about issuing few instructions per byte, and about keeping the reads
// in flight while those instructions issue:
//
// - The grid is persistent: a block walks 64x32 tiles (of every frame of
//   a batch). It stages a tile and a 2-pixel halo (the Malvar reach;
//   bilinear reads 1 of it) in shared memory as float32, normalizing each
//   value once, on its own CFA site:
//   clip((raw - black) * 1/(white - black), 0, 1), and for Malvar times its
//   site's white-balance gain. A tap outside [0, height) x [0, width) of its
//   own frame is 0 (Malvar: 0 times the gain), so any width and height work
//   unpadded and no frame reads its neighbour's rows. The walk steps its
//   tile coordinates by the grid's, so the loop divides only at a frame
//   change. The raw values reach the block by one of two paths:
//   - the ring (ring::develop_kernel): where rows are a multiple of 16
//     bytes, the base is 16-byte aligned and raw 0 normalizes to 0 on every
//     site (the host's test, kernels/develop.py::ring_takes), a producer
//     warp copies each tile's raw box (36 rows of 80 values, one frame of a
//     3-D tensor map) into a ring of kRingStages stages in shared memory
//     with the Tensor Memory Accelerator, up to kRingStages tiles ahead of
//     the 8 warps that develop them, each stage with a full and an empty
//     mbarrier. The hardware fills a box's part outside the frame with raw
//     0, which normalizes to the 0 the direct path stages there, so no
//     value needs a bounds test. The developing warps stage into one float
//     tile and meet at their own barrier twice a tile;
//   - direct (develop_kernel), any other input: each thread loads the next
//     tile's raw values, 4 a step in coalesced 4-byte pairs, into registers
//     while it develops the current one. A tile whose staged rectangle lies
//     inside its frame (all but the border tiles) takes a path without
//     bounds tests.
// - A launch takes one parameter row and one CFA for all its frames (by
//   value: the CFA a template argument, the parameters constants of the
//   instructions), or a row and a CFA for each frame (FrameRows, in device
//   memory; the mcraw_develop_rows* entries): a block then reads a frame's
//   row when its walk reaches the frame and develops the frame's tiles in
//   the loop of the frame's CFA, so each frame's output is bit for bit
//   that of a one-row launch of the frame alone.
// - Integer <-> float conversions issue at 1/8 of the float rate on this
//   card, so there are none per value: a raw value becomes a float by a
//   byte permute and an exact subtract, a bucket index is read off the
//   float's bits (below).
// - Each thread then develops two side-by-side 2x2 quads (4 x 2 pixels)
//   aligned to even coordinates, reading its 6x8 window with 16-byte shared
//   loads. Every output's CFA site is fixed by its place in the quad, and
//   the CFA is a template argument, so which taps belong to which channel
//   is known at compile time: absent taps of the bilinear sums are not
//   added (None below) and the Malvar selects vanish.
// - Each output row of 4 pixels goes out as one 16-byte store when
//   width % 4 == 0, else as masked 4-byte stores.
// - The sRGB curve is an exact 8-bit quantizer: code(lin) =
//   round(255 * srgb(lin)) as mcraw_torch.preview.develop_f64 defines it,
//   monotone in lin, so it is the count of thresholds thr[1..255] (float32,
//   computed on the host in float64) at or below lin. Over buckets even in
//   log2 lin, 128 an octave, the curve climbs less than one code a bucket,
//   so a bucket holds at most one threshold (checked on the host), and a
//   bucket is a run of floats with the same high 16 bits: lin reaches the
//   bucket's threshold when its low 16 bits reach the threshold's. So each
//   bucket is one 4-byte word, encoded on the host (kernels/develop.py
//   quantizer_table), and the code is the high half of one integer add of
//   that word and lin's low 16 bits; two byte permutes pack the three codes
//   and the alpha. No logf, expf, division or float compare is left per
//   pixel. The table (1666 words, 6.7 KB) is copied from device memory into
//   shared memory once per block. Log buckets, not 4096 even ones of
//   [0, 1]: a warp's 32 lookups then fall in fewer, closer entries, and
//   fewer of them collide in a shared-memory bank.
// - Clips are two NaN-propagating min/max instructions (the one before the
//   quantizer maps NaN to 0).
//
// Arithmetic before the curve, in float32, is that of the plain version
// (mcraw_torch/kernels/develop.py::develop_rgba_plain), step for step:
//   bilinear: per channel c, the taps of channel c only; R/B as the
//     separable [1,2,1]^T x [1,2,1] sum (rows, then columns), G as the cross
//     4*mid + up + down + right + left; times the closed-form normalizer
//     1/conv(mask) (R/B: fac(row) * fac(col); G: 1/4 at G sites, else
//     1/(4 - clipped arms)), times the white-balance gain; clip;
//   malvar: gain on every tap first, then the four MHC estimators k1..k4
//     and the per-site select (the horizontally adjacent site's channel
//     tells the two G phases apart); clip;
//   emit: m = XYZ(D50)->sRGB @ forward matrix as scalar multiply-adds, clip.
// Every product and sum goes through __fmul_rn / __fadd_rn / __fsub_rn, so
// nvcc contracts none of them into an FMA: each rounds once, as the plain
// version's torch ops do. A dropped absent tap was a +0.0 term of a sum of
// non-negative values, so the sums are bit for bit those of the plain
// version. The contract is <= 1 LSB per channel against the f64 model.

#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is reached through the runtime
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

// The buffers of the checked build (kernels/build.py BUFFERS), in order:
// the entry's buffers (params, cfa and the ring's tensor map in host
// memory), then the kernels' shared arrays, then the per-frame launch's
// row and CFA blocks (device memory).
enum Buffer : int {
  kBufRaw,
  kBufOut,
  kBufQuantizer,
  kBufParams,
  kBufCfa,
  kBufSTile,
  kBufSQ,
  kBufMap,
  kBufSRing,
  kBufRows,
  kBufCfas,
};

constexpr int kTileW = 64;                 // output pixels per block, across
constexpr int kTileH = 32;                 // and down
constexpr int kHalo = 2;                   // the Malvar reach
constexpr int kRowW = kTileW + 2 * kHalo;  // 68 floats: rows stay 16-byte aligned
constexpr int kRows = kTileH + 2 * kHalo;  // 36
constexpr int kQuadsPerRow = kRowW / 4;    // 4 staged values a step
constexpr int kQuads = kRows * kQuadsPerRow;
constexpr int kThreadsX = kTileW / 4;      // each thread: 4 columns
constexpr int kThreadsY = kTileH / 2;      // and 2 rows
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kQuadSteps = (kQuads + kThreads - 1) / kThreads;
// The sRGB quantizer's buckets (kernels/develop.py SRGB_BUCKET_BASE): lin's
// float bits >> 16, less this base, floored at 0; 1.0 is the last entry.
constexpr int kBucketBase = (0x39000000 >> 16) - 1;  // 2^-13
constexpr int kQuantizer = (0x3F800000 >> 16) - kBucketBase + 1;

static_assert(kRowW % 4 == 0, "rows must stay 16-byte aligned");
constexpr int64_t kTileBytes = sizeof(float) * kRows * kRowW;
constexpr int64_t kQuantizerBytes = sizeof(uint32_t) * kQuantizer;

// The ring path (kernels/develop.py RING_BOX): a tile's raw box is kRows
// rows of kBoxW uint16, one frame deep. It starts kBoxX0 columns left of
// the tile, not kHalo: the hardware takes a box only where its first
// column lies on a 16-byte boundary of the row (x0 - 2 faults with an
// illegal instruction, x0 - 8 does not), and a box row is a multiple of
// 16 bytes. Each stage starts 128-byte aligned, as a TMA destination must.
constexpr int kBoxX0 = 8;                                     // uint16 of 16 bytes
constexpr int kBoxW = (kBoxX0 + kTileW + kHalo + 7) / 8 * 8;  // 80: columns x0 - 8 .. x0 + 71
constexpr int kBoxBytes = 2 * kRows * kBoxW;                  // 5,760
constexpr int kStagePitch = (kBoxBytes + 127) / 128 * 128;
// 4 stages and 3 blocks an SM: the fastest of (stages, blocks) = (4, 3),
// (6, 3), (4, 2) and (8, 2) on an H100 (python -m mcraw_torch.kernel_ab).
constexpr int kRingStages = 4;
constexpr int kRingBlocks = 3;                      // blocks an SM
constexpr int kRingThreads = kThreads + 32;         // the developing warps and the producer
// Blocks an SM of a per-frame launch (both paths): 2, not 3, leaves
// registers for the frame's parameters (at 3, with 72 registers, both
// paths spill: a UHD batch of 8 took 0.325-0.341 ms against 0.266 for one
// row; at 2, 0.277-0.285; python -m mcraw_torch.kernel_ab on an H100).
constexpr int kRowsBlocks = 2;
constexpr int64_t kRingBytes = int64_t{kRingStages} * kStagePitch;
// A ring block's dynamic shared memory: the ring, the float tile, the
// quantizer, the barriers.
constexpr int64_t kRingSmemBytes =
    kRingBytes + kTileBytes + kQuantizerBytes + 2 * kRingStages * sizeof(uint64_t);
constexpr int kMaxDevices = 64;
static_assert((2 * kBoxW) % 16 == 0 && (2 * kBoxX0) % 16 == 0 && kTileW % kBoxX0 == 0,
              "a box's rows and first column must lie on 16-byte boundaries");
static_assert(kTileBytes % 16 == 0 && kQuantizerBytes % 8 == 0, "shared arrays stay aligned");

struct DevelopParams {
  float black[4];      // per 2x2 site
  float inv_scale[4];  // 1 / (white - black), per site
  float gain_site[4];  // white-balance gain of each site's channel (Malvar)
  float gain[3];       // 1 / as_shot_neutral, per channel (bilinear)
  float m[9];          // XYZ(D50)->sRGB @ forward matrix, row-major
};  // by value (__grid_constant__): static indices compile to constant loads

// A per-frame launch's parameters, in device memory: frame f's row of
// kernels/develop.py::pack_develop_params at rows + f * row_stride floats
// and its CFA (4 int32 channels) at cfas + f * cfa_stride: a row and a CFA
// of each frame's own (rows_fit).
struct FrameRows {
  const float* rows;
  const int32_t* cfas;
  int64_t row_stride, cfa_stride;
};

constexpr int kRowFloats = 17;  // b0..b3, white, g0..g2, m00..m22

// Whether the strides give each of `frames` frames a row and a CFA of its
// own (a launch of one frame reads only the first).
inline bool rows_fit(int64_t frames, int64_t row_stride, int64_t cfa_stride) {
  return frames == 1 || (row_stride >= kRowFloats && cfa_stride >= 4);
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// clip to [0, 1]; NaN stays NaN, as torch.clamp and jnp.clip leave it.
// Two NaN-propagating min/max instructions.
__device__ __forceinline__ float clip01(float v) {
  float lo, r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(lo) : "f"(v));
  asm("min.NaN.f32 %0, %1, 0f3F800000;" : "=f"(r) : "f"(lo));
  return r;
}

// A tap that is not of the channel being summed: sums drop it at compile
// time (it stood for a +0.0 term).
struct None {};
__device__ __forceinline__ None plus(None, None) { return {}; }
__device__ __forceinline__ float plus(float a, None) { return a; }
__device__ __forceinline__ float plus(None, float b) { return b; }
__device__ __forceinline__ float plus(float a, float b) { return add(a, b); }
__device__ __forceinline__ None times(float, None) { return {}; }
__device__ __forceinline__ float times(float k, float b) { return mul(k, b); }

// The Bayer pattern as a type: chan(site) for the 2x2 site
// (y & 1) << 1 | (x & 1), pos(c) the site of channel c (R or B).
template <int C0, int C1, int C2, int C3>
struct Cfa {
  __host__ __device__ static constexpr int chan(int site) {
    return site == 0 ? C0 : (site == 1 ? C1 : (site == 2 ? C2 : C3));
  }
  __host__ __device__ static constexpr int pos(int c) {
    return C0 == c ? 0 : (C1 == c ? 1 : (C2 == c ? 2 : 3));
  }
};

// The Bayer pattern of 4 channels (0 R, 1 G, 2 B, row-major over the 2x2
// sites): 0 rggb, 1 bggr, 2 grbg, 3 gbrg, -1 another pattern.
__host__ __device__ __forceinline__ int bayer_index(const int32_t* cfa) {
  switch (((cfa[0] * 3 + cfa[1]) * 3 + cfa[2]) * 3 + cfa[3]) {
    case ((0 * 3 + 1) * 3 + 1) * 3 + 2: return 0;
    case ((2 * 3 + 1) * 3 + 1) * 3 + 0: return 1;
    case ((1 * 3 + 0) * 3 + 2) * 3 + 1: return 2;
    case ((1 * 3 + 2) * 3 + 0) * 3 + 1: return 3;
    default: return -1;
  }
}

// The window w[6][8] of a thread: rows y - 2 .. y + 3 and columns
// x - 2 .. x + 5 around its first output (y, x), both even. Output
// (OY, OX), OY in 0..1 and OX in 0..3, sits at w[2 + OY][2 + OX] on site
// OY << 1 | (OX & 1); its tap (DY, DX) on site ((OY + DY) & 1) << 1 |
// ((OX + DX) & 1).
template <class P, int OY, int OX>
struct At {
  template <int DY, int DX>
  __host__ __device__ static constexpr int site() {
    return (((OY + DY + 4) & 1) << 1) | ((OX + DX + 4) & 1);
  }
  template <int DY, int DX>
  __device__ static __forceinline__ float tap(const float (&w)[6][8]) {
    return w[2 + OY + DY][2 + OX + DX];
  }
  // The tap if it lies on a site of channel C, else None.
  template <int C, int DY, int DX>
  __device__ static __forceinline__ auto of(const float (&w)[6][8]) {
    if constexpr (P::chan(site<DY, DX>()) == C) {
      return tap<DY, DX>(w);
    } else {
      return None{};
    }
  }
};

// 1 / (the [1,2,1] sum of one parity's mask along an axis), {0, 1/2, 1}:
// idx's parity is IdxPar, known at compile time.
template <int Par, int IdxPar>
__device__ __forceinline__ float fac(int idx, int last) {
  if constexpr (Par == IdxPar) {
    return 0.5f;  // the centre tap (2) alone: its neighbours are off-phase
  } else {
    const int f = (idx > 0) + (idx < last);
    return f == 2 ? 0.5f : (f == 1 ? 1.f : 0.f);
  }
}

// kEdge: the pixel may touch the frame's border; inside it every fac is
// 1/2 and no G arm is clipped.
template <class P, bool kEdge, int OY, int OX>
__device__ __forceinline__ void bilinear(const DevelopParams& p, const float (&w)[6][8],
                                         int y, int x, int height, int width,
                                         float (&rgb)[3]) {
  using A = At<P, OY, OX>;
  // R and B: separable [1,2,1] x [1,2,1] over the taps of the channel.
  auto rb = [&](auto c) {
    constexpr int C = decltype(c)::value;
    auto vm = plus(plus(A::template of<C, -1, -1>(w), times(2.f, A::template of<C, 0, -1>(w))),
                   A::template of<C, 1, -1>(w));
    auto v0 = plus(plus(A::template of<C, -1, 0>(w), times(2.f, A::template of<C, 0, 0>(w))),
                   A::template of<C, 1, 0>(w));
    auto vp = plus(plus(A::template of<C, -1, 1>(w), times(2.f, A::template of<C, 0, 1>(w))),
                   A::template of<C, 1, 1>(w));
    const float num = plus(plus(times(2.f, v0), vp), vm);  // a Bayer 3x3 holds every channel
    constexpr int pos = P::pos(C);
    const float inv = kEdge ? mul(fac<(pos >> 1), (OY & 1)>(y, height - 1),
                                  fac<(pos & 1), (OX & 1)>(x, width - 1))
                            : mul(0.5f, 0.5f);
    return clip01(mul(mul(num, inv), p.gain[C]));
  };
  rgb[0] = rb(std::integral_constant<int, 0>{});
  rgb[2] = rb(std::integral_constant<int, 2>{});
  // G: the cross 4 * mid + up + down + right + left.
  const float num = plus(plus(plus(plus(times(4.f, A::template of<1, 0, 0>(w)),
                                        A::template of<1, -1, 0>(w)),
                                   A::template of<1, 1, 0>(w)),
                              A::template of<1, 0, 1>(w)),
                         A::template of<1, 0, -1>(w));
  float inv = 0.25f;
  if constexpr (kEdge && P::chan(((OY & 1) << 1) | (OX & 1)) != 1) {
    const int arms = (y == 0) + (y == height - 1) + (x == 0) + (x == width - 1);
    inv = arms == 0 ? 0.25f : (arms == 1 ? 1.f / 3.f : (arms == 2 ? 0.5f : 1.f));
  }
  rgb[1] = clip01(mul(mul(num, inv), p.gain[1]));
}

template <class P, int OY, int OX>
__device__ __forceinline__ void malvar(const float (&w)[6][8], float (&rgb)[3]) {
  using A = At<P, OY, OX>;
  // Every tap was multiplied by its site's gain when the tile was staged.
  const float mid = A::template tap<0, 0>(w);
  const float h1 = add(A::template tap<0, 1>(w), A::template tap<0, -1>(w));
  const float h2 = add(A::template tap<0, 2>(w), A::template tap<0, -2>(w));
  const float v1 = add(A::template tap<-1, 0>(w), A::template tap<1, 0>(w));
  const float v2 = add(A::template tap<-2, 0>(w), A::template tap<2, 0>(w));
  const float d1 = add(add(add(A::template tap<-1, 1>(w), A::template tap<-1, -1>(w)),
                           A::template tap<1, 1>(w)),
                       A::template tap<1, -1>(w));
  const float hv2 = add(h2, v2);
  const float k1 = mul(sub(add(mul(4.f, mid), mul(2.f, add(h1, v1))), hv2), 0.125f);
  const float k2 =
      mul(add(sub(sub(add(mul(5.f, mid), mul(4.f, h1)), d1), h2), mul(0.5f, v2)), 0.125f);
  const float k3 =
      mul(add(sub(sub(add(mul(5.f, mid), mul(4.f, v1)), d1), v2), mul(0.5f, h2)), 0.125f);
  const float k4 = mul(sub(add(mul(6.f, mid), mul(2.f, d1)), mul(1.5f, hv2)), 0.125f);
  constexpr int site = ((OY & 1) << 1) | (OX & 1);
  constexpr int cm = P::chan(site);
  constexpr int hcm = P::chan(site ^ 1);  // the horizontally adjacent site's channel
  rgb[0] = clip01(cm == 0 ? mid : (cm == 1 ? (hcm == 0 ? k2 : k3) : k4));
  rgb[1] = clip01(cm == 1 ? mid : k1);
  rgb[2] = clip01(cm == 2 ? mid : (cm == 1 ? (hcm == 2 ? k2 : k3) : k4));
}

// The code round(255 * srgb(lin)) of lin in [0, 1], in byte 2 of the
// returned word (byte 3 is 0). Bucket k is read off lin's exponent and top
// 7 mantissa bits (an arithmetic shift: -0.0 is negative and lands in
// bucket 0, with every lin below 2^-13); q[k] = (base << 16) + (0x10000 -
// T), base the code at the bucket's start and T the low 16 bits of the one
// threshold inside it (base << 16 where it holds none, as bucket 0 never
// does). Inside a bucket lin's high 16 bits are fixed, so adding its low 16
// bits L carries one into the code exactly when L >= T, when lin reaches
// the threshold. No float-to-int conversion, which issues at 1/8 of the
// float rate, and no float compare.
__device__ __forceinline__ uint32_t quantize(float lin, const uint32_t* q MCRAW_CK_PARAM) {
  const int bits = __float_as_int(lin);
  const int k = max(bits >> 16, kBucketBase) - kBucketBase;  // the - goes into the load's offset
  return MCRAW_SLDN(kBufSQ, q, kQuantizerBytes, q, k) + (static_cast<uint32_t>(bits) & 0xFFFFu);
}

// R | G << 8 | B << 16 | 0xFF << 24 from the three quantize words: two byte
// permutes take each code's byte 2; B's word, whose byte 3 is 0, gets the
// alpha by the add that makes it.
__device__ __forceinline__ uint32_t emit(const DevelopParams& p, const float (&rgb)[3],
                                         const uint32_t* q MCRAW_CK_PARAM) {
  uint32_t code[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float lin = add(add(mul(p.m[3 * r], rgb[0]), mul(p.m[3 * r + 1], rgb[1])),
                          mul(p.m[3 * r + 2], rgb[2]));
    // clip to [0, 1], NaN to 0 (fmaxf returns the number): the quantizer's
    // index stays inside its table.
    code[r] = quantize(fminf(fmaxf(lin, 0.f), 1.f), q MCRAW_CK);
  }
  const uint32_t rg = __byte_perm(code[0], code[1], 0x0062);  // R in byte 0, G in byte 1
  return __byte_perm(rg, code[2] + 0xFF000000u, 0x7610);
}

template <class P, bool kMalvar, bool kEdge, int OY, int OX>
__device__ __forceinline__ uint32_t pixel(const DevelopParams& p, const float (&w)[6][8],
                                          int y, int x, int height, int width,
                                          const uint32_t* q MCRAW_CK_PARAM) {
  float rgb[3];
  if constexpr (kMalvar) {
    malvar<P, OY, OX>(w, rgb);
  } else {
    bilinear<P, kEdge, OY, OX>(p, w, y + OY, x + OX, height, width, rgb);
  }
  return emit(p, rgb, q MCRAW_CK);
}

template <class P, bool kMalvar, bool kEdge, int OY>
__device__ __forceinline__ void store_row(const DevelopParams& p, const float (&w)[6][8],
                                          uint32_t* __restrict__ frame_out, int y, int x,
                                          int height, int width,
                                          const uint32_t* q MCRAW_CK_PARAM) {
  if (y + OY >= height) return;
  const uint32_t v0 = pixel<P, kMalvar, kEdge, OY, 0>(p, w, y, x, height, width, q MCRAW_CK);
  const uint32_t v1 = pixel<P, kMalvar, kEdge, OY, 1>(p, w, y, x, height, width, q MCRAW_CK);
  const uint32_t v2 = pixel<P, kMalvar, kEdge, OY, 2>(p, w, y, x, height, width, q MCRAW_CK);
  const uint32_t v3 = pixel<P, kMalvar, kEdge, OY, 3>(p, w, y, x, height, width, q MCRAW_CK);
  uint32_t* o = frame_out + static_cast<int64_t>(y + OY) * width + x;
  if ((width & 3) == 0 && x + 3 < width) {
    MCRAW_ST(kBufOut, reinterpret_cast<uint4*>(o), 0, make_uint4(v0, v1, v2, v3));
  } else {
    if (x < width) MCRAW_ST(kBufOut, o, 0, v0);
    if (x + 1 < width) MCRAW_ST(kBufOut, o, 1, v1);
    if (x + 2 < width) MCRAW_ST(kBufOut, o, 2, v2);
    if (x + 3 < width) MCRAW_ST(kBufOut, o, 3, v3);
  }
}

// Develops the staged tile at (y0, x0) into frame_out: each of the kThreads
// developing threads its two 2x2 quads, from its 6x8 window of `tile`,
// which lies in the shared array `tiles` of `tiles_bytes`.
template <class P, bool kMalvar>
__device__ __forceinline__ void develop_tile(const DevelopParams& p, const float (*tile)[kRowW],
                                             const void* tiles, int64_t tiles_bytes,
                                             uint32_t* __restrict__ frame_out, int y0, int x0,
                                             int height, int width,
                                             const uint32_t* q MCRAW_CK_PARAM) {
  const int qx = threadIdx.x % kThreadsX;
  const int qy = threadIdx.x / kThreadsX;
  const int x = x0 + 4 * qx;
  const int y = y0 + 2 * qy;
  if (x >= width || y >= height) return;
  float w[6][8];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const float4* lo4 = reinterpret_cast<const float4*>(&tile[2 * qy + r][4 * qx]);
    const float4* hi4 = reinterpret_cast<const float4*>(&tile[2 * qy + r][4 * qx + 4]);
    const float4 lo = MCRAW_SLDN(kBufSTile, tiles, tiles_bytes, lo4, 0);
    const float4 hi = MCRAW_SLDN(kBufSTile, tiles, tiles_bytes, hi4, 0);
    w[r][0] = lo.x; w[r][1] = lo.y; w[r][2] = lo.z; w[r][3] = lo.w;
    w[r][4] = hi.x; w[r][5] = hi.y; w[r][6] = hi.z; w[r][7] = hi.w;
  }
  if (kMalvar || (x > 0 && x + 4 < width && y > 0 && y + 2 < height)) {
    store_row<P, kMalvar, false, 0>(p, w, frame_out, y, x, height, width, q MCRAW_CK);
    store_row<P, kMalvar, false, 1>(p, w, frame_out, y, x, height, width, q MCRAW_CK);
  } else {
    store_row<P, kMalvar, true, 0>(p, w, frame_out, y, x, height, width, q MCRAW_CK);
    store_row<P, kMalvar, true, 1>(p, w, frame_out, y, x, height, width, q MCRAW_CK);
  }
}

// -- where a tile's parameters come from ----------------------------------------

// A frame whose CFA is not a Bayer pattern: its tiles are written as 0.
struct NoCfa {};

// Writes 0 over the thread's two 2x2 quads of the tile at (y0, x0).
__device__ __forceinline__ void clear_tile(uint32_t* __restrict__ frame_out, int y0, int x0,
                                           int height, int width MCRAW_CK_PARAM) {
  const int x = x0 + 4 * static_cast<int>(threadIdx.x % kThreadsX);
  const int y = y0 + 2 * static_cast<int>(threadIdx.x / kThreadsX);
#pragma unroll
  for (int oy = 0; oy < 2; ++oy) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (y + oy < height && x + e < width) {
        MCRAW_ST(kBufOut, frame_out + static_cast<int64_t>(y + oy) * width + x, e, 0u);
      }
    }
  }
}

// The staged tile at (y0, x0) developed with CFA P (cleared for NoCfa).
template <class P, bool kMalvar>
__device__ __forceinline__ void develop_or_clear(const DevelopParams& p,
                                                 const float (*tile)[kRowW],
                                                 uint32_t* __restrict__ frame_out, int y0,
                                                 int x0, int height, int width,
                                                 const uint32_t* q MCRAW_CK_PARAM) {
  if constexpr (std::is_same_v<P, NoCfa>) {
    clear_tile(frame_out, y0, x0, height, width MCRAW_CK);
  } else {
    develop_tile<P, kMalvar>(p, tile, tile, kTileBytes, frame_out, y0, x0, height, width,
                             q MCRAW_CK);
  }
}

// A block's tiles and their parameters: walk(tile, tiles, frame_of, step)
// calls step(P{}, params) once a tile, tile += gridDim.x, while tile <
// tiles; frame_of() is the frame of the next tile.
//
// One row for the launch: the kernel's by-value parameters and the CFA P,
// a template argument.
template <class P>
struct OneRow {
  const DevelopParams& row;

  // The host takes the ring for one row only where raw 0 normalizes to 0.
  __device__ __forceinline__ constexpr bool masked(int, int, int, int) const { return false; }
  template <class FrameOf, class Step>
  __device__ __forceinline__ void walk(int& tile, int tiles, FrameOf&&,
                                       Step&& step MCRAW_CK_PARAM) const {
    while (tile < tiles) step(P{}, row);
  }
};

// A row for each frame (FrameRows): the block's walk goes a frame at a
// time (the tiles are frame-major); at each frame it reads the frame's row
// and CFA, makes the parameters as pack_params makes the one-row launch's,
// and walks the frame's tiles in a loop of the CFA's own instantiation,
// picked by a branch uniform over the block, the parameters fixed in it.
// They are registers there, where the one-row launch's are constants: the
// per-frame kernels take kRowsBlocks blocks an SM, so that they do not
// spill.
struct PerFrame {
  const FrameRows& rows;
  int cfa = -1;           // 0 rggb, 1 bggr, 2 grbg, 3 gbrg; -1 another pattern
  bool zero_fill = true;  // raw 0 normalizes to 0 on every site
  DevelopParams row;

  __device__ __forceinline__ void at(int f MCRAW_CK_PARAM) {
    const int64_t r0 = f * rows.row_stride, c0 = f * rows.cfa_stride;
    float v[kRowFloats];
#pragma unroll
    for (int i = 0; i < kRowFloats; ++i) v[i] = MCRAW_LDG(kBufRows, rows.rows, r0 + i);
    int32_t c[4];
    bool valid = true, exact = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = MCRAW_LDG(kBufCfas, rows.cfas, c0 + k);
      valid = valid && c[k] >= 0 && c[k] <= 2;
    }
    const float white = v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float diff = white - v[k];
      // kernels/develop.py::zero_fill_exact
      exact = exact && v[k] >= 0.f && diff >= 1.17549435e-38f && diff < __int_as_float(0x7F800000);
      row.black[k] = v[k];
      row.inv_scale[k] = 1.f / diff;
      row.gain_site[k] = c[k] == 0 ? v[5] : (c[k] == 1 ? v[6] : v[7]);
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) row.gain[ch] = v[5 + ch];
#pragma unroll
    for (int i = 0; i < 9; ++i) row.m[i] = v[8 + i];
    cfa = valid ? bayer_index(c) : -1;
    zero_fill = exact;
  }
  // Whether the ring must stage the tile at (y0, x0) with bounds tests:
  // the frame's raw 0 does not normalize to 0 and the tile's box reaches
  // past the frame, where the hardware fills raw 0.
  __device__ __forceinline__ bool masked(int y0, int x0, int height, int width) const {
    return !zero_fill && (y0 < kHalo || x0 < kHalo || y0 + kTileH + kHalo > height ||
                          x0 + kTileW + kHalo > width);
  }
  template <class FrameOf, class Step>
  __device__ __forceinline__ void walk(int& tile, int tiles, FrameOf&& frame_of,
                                       Step&& step MCRAW_CK_PARAM) {
    while (tile < tiles) {
      const int f = frame_of();
      at(f MCRAW_CK);
      auto run = [&](auto cfa) {
        do {
          step(cfa, row);
        } while (tile < tiles && frame_of() == f);
      };
      switch (cfa) {
        case 0: run(Cfa<0, 1, 1, 2>{}); break;
        case 1: run(Cfa<2, 1, 1, 0>{}); break;
        case 2: run(Cfa<1, 0, 2, 1>{}); break;
        case 3: run(Cfa<1, 2, 0, 1>{}); break;
        default: run(NoCfa{}); break;
      }
    }
  }
};

// A block's walk over tiles blockIdx.x, + gridDim.x, ... (frame-major,
// then rows of tiles): it steps its (frame, tile row, tile column) by the
// grid's (rows, columns), so no division is left in the loop but at a
// frame change. 32-bit index math: the host keeps tiles < 2^31. The steps
// (gridDim.x in rows and columns of tiles) are kernel arguments, made by
// the launch: read from the constant bank, they hold no register, where
// the ring's one-row kernels (72 registers a thread at 3 blocks an SM)
// spilled 4 to 12 bytes with them made in the kernel.
struct TileWalk {
  int f, ty, tx;
  int tiles_x, tiles_y, step_x, step_y;

  __device__ __forceinline__ TileWalk(int tiles_x_, int tiles_y_, int step_x_, int step_y_)
      : tiles_x(tiles_x_), tiles_y(tiles_y_), step_x(step_x_), step_y(step_y_) {
    const int per_frame = tiles_x * tiles_y;
    f = static_cast<int>(blockIdx.x) / per_frame;
    ty = (static_cast<int>(blockIdx.x) - f * per_frame) / tiles_x;
    tx = static_cast<int>(blockIdx.x) - f * per_frame - ty * tiles_x;
  }
  __device__ __forceinline__ int y0() const { return ty * kTileH; }
  __device__ __forceinline__ int x0() const { return tx * kTileW; }
  __device__ __forceinline__ void advance() {
    tx += step_x;
    ty += step_y;
    if (tx >= tiles_x) {
      tx -= tiles_x;
      ++ty;
    }
    if (ty >= tiles_y) {
      const int df = ty / tiles_y;
      f += df;
      ty -= df * tiles_y;
    }
  }
};

// Each thread's staged places: at step k, row sy[k] (>= kRows: none) and
// column sx[k] (a multiple of 4) of the tile.
__device__ __forceinline__ void staged_places(int (&sy)[kQuadSteps], int (&sx)[kQuadSteps]) {
#pragma unroll
  for (int k = 0; k < kQuadSteps; ++k) {
    const int q = threadIdx.x + k * kThreads;
    sy[k] = q / kQuadsPerRow;
    sx[k] = 4 * (q - sy[k] * kQuadsPerRow);
  }
}

// The uint16 in half `hi` of `word` as a float, exactly: the bits
// 0x4B00uuuu are 2^23 + u, and 2^23 + u - 2^23 is exact. A byte permute and
// an add, where an int-to-float conversion issues at 1/8 of the float rate.
__device__ __forceinline__ float u16_to_float(uint32_t word, bool hi) {
  return sub(__uint_as_float(__byte_perm(word, 0x4B00u, hi ? 0x5432u : 0x5410u)), 8388608.f);
}

// Four staged values: the raw pairs `words` (columns of parity 0, 1, 0, 1
// on a row of parity r), each normalized on its own site, 0 where `in` is
// false (outside the frame); for Malvar also times its site's gain.
template <bool kMalvar>
__device__ __forceinline__ float4 normalize4(const DevelopParams& p, int r, uint2 words,
                                             const bool (&in)[4]) {
  const float b0 = r ? p.black[2] : p.black[0], b1 = r ? p.black[3] : p.black[1];
  const float s0 = r ? p.inv_scale[2] : p.inv_scale[0];
  const float s1 = r ? p.inv_scale[3] : p.inv_scale[1];
  const float g0 = r ? p.gain_site[2] : p.gain_site[0];
  const float g1 = r ? p.gain_site[3] : p.gain_site[1];
  const uint32_t w[2] = {words.x, words.y};
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool odd = e & 1;
    const float u = u16_to_float(w[e >> 1], odd);
    v[e] = in[e] ? clip01(mul(sub(u, odd ? b1 : b0), odd ? s1 : s0)) : 0.f;
    if constexpr (kMalvar) v[e] = mul(v[e], odd ? g1 : g0);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// -- the direct path -------------------------------------------------------------

// Where a tile's staged values come from: frame f, rows y0 - 2 ..,
// columns x0 - 2 ..; `interior`: the staged rectangle lies inside the
// frame and every even column's pair is 4-byte aligned, so no value needs
// a bounds test. Uniform over the block.
struct TileAt {
  int f, y0, x0;
  bool interior;
};

// Loads the raw values of one tile and its halo, 4 a step (two pairs,
// each one 4-byte load where it is aligned), 0 outside the frame. `paired`:
// every even column's pair is 4-byte aligned (even width, aligned frame).
// (sy, sx) of step k is the thread's staged row and column.
template <bool kInterior>
__device__ __forceinline__ void load_tile(const uint16_t* __restrict__ fr, int y0, int x0,
                                          int height, int width, bool paired,
                                          const int (&sy)[kQuadSteps],
                                          const int (&sx)[kQuadSteps],
                                          uint2 (&raw)[kQuadSteps] MCRAW_CK_PARAM) {
#pragma unroll
  for (int k = 0; k < kQuadSteps; ++k) {
    const int gy = y0 - kHalo + sy[k];
    const int gx = x0 - kHalo + sx[k];  // even
    uint32_t v[2] = {0u, 0u};
    const uint16_t* row = fr + static_cast<int64_t>(gy) * width;
    if (kInterior) {
      if (sy[k] < kRows) {
        v[0] = MCRAW_LDG(kBufRaw, reinterpret_cast<const uint32_t*>(row + gx), 0);
        v[1] = MCRAW_LDG(kBufRaw, reinterpret_cast<const uint32_t*>(row + gx + 2), 0);
      }
    } else if (sy[k] < kRows && static_cast<unsigned>(gy) < static_cast<unsigned>(height)) {
      if (paired && gx >= 0 && gx + 3 < width) {
        v[0] = MCRAW_LDG(kBufRaw, reinterpret_cast<const uint32_t*>(row + gx), 0);
        v[1] = MCRAW_LDG(kBufRaw, reinterpret_cast<const uint32_t*>(row + gx + 2), 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (static_cast<unsigned>(gx + e) < static_cast<unsigned>(width)) {
            v[e >> 1] |= static_cast<uint32_t>(MCRAW_LDG(kBufRaw, row + gx, e)) << (16 * (e & 1));
          }
        }
      }
    }
    raw[k] = make_uint2(v[0], v[1]);
  }
}

// Normalizes the loaded values into the shared tile: each once, on its own
// site; for Malvar also times its site's gain; 0 outside the frame.
template <bool kMalvar, bool kInterior>
__device__ __forceinline__ void stage_tile(const DevelopParams& p, int y0, int x0, int height,
                                           int width, const int (&sy)[kQuadSteps],
                                           const int (&sx)[kQuadSteps],
                                           const uint2 (&raw)[kQuadSteps],
                                           float (*tile)[kRowW] MCRAW_CK_PARAM) {
#pragma unroll
  for (int k = 0; k < kQuadSteps; ++k) {
    if (sy[k] >= kRows) break;
    const int gy = y0 - kHalo + sy[k];
    const int gx = x0 - kHalo + sx[k];
    const bool row_in = kInterior || static_cast<unsigned>(gy) < static_cast<unsigned>(height);
    bool in[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      in[e] = kInterior ||
              (row_in && static_cast<unsigned>(gx + e) < static_cast<unsigned>(width));
    }
    // gy may be negative: & keeps the parity
    MCRAW_SSTN(kBufSTile, tile, kTileBytes, reinterpret_cast<float4*>(&tile[sy[k]][sx[k]]), 0,
               normalize4<kMalvar>(p, gy & 1, raw[k], in));
  }
}

// A persistent grid: each block walks tiles blockIdx.x, + gridDim.x, ...
// (frame-major, then rows of tiles), loading the next tile's raw values
// while it develops the current one, with each tile's parameters from
// `rows` (OneRow or PerFrame). The quantizer table (in device memory) is
// copied to shared memory once.
template <bool kMalvar, class Rows>
__device__ __forceinline__ void develop_direct(const uint16_t* __restrict__ raw,
                                               uint32_t* __restrict__ out, int height,
                                               int width, int tiles_x, int tiles_y, int tiles,
                                               int step_x, int step_y,
                                               const uint32_t* __restrict__ quantizer,
                                               Rows& rows MCRAW_CK_PARAM) {
  __shared__ __align__(16) float s_tile[kRows][kRowW];
  __shared__ uint32_t s_q[kQuantizer];

  const int tid = threadIdx.x;
  for (int i = tid; i < kQuantizer; i += kThreads) {
    MCRAW_SST(kBufSQ, s_q, s_q, i, MCRAW_LD(kBufQuantizer, quantizer, i));
  }
  const bool paired = (width & 1) == 0 && (reinterpret_cast<uintptr_t>(raw) & 3) == 0;
  const int64_t plane = static_cast<int64_t>(height) * width;
  int sy[kQuadSteps], sx[kQuadSteps];
  staged_places(sy, sx);

  TileWalk walk(tiles_x, tiles_y, step_x, step_y);
  auto at = [&]() {
    const int y0 = walk.y0(), x0 = walk.x0();
    const bool interior = paired && y0 >= kHalo && x0 >= kHalo &&
                          y0 + kTileH + kHalo <= height && x0 + kTileW + kHalo <= width;
    return TileAt{walk.f, y0, x0, interior};
  };
  auto load = [&](const TileAt& t, uint2 (&dst)[kQuadSteps]) {
    const uint16_t* fr = raw + static_cast<int64_t>(t.f) * plane;
    if (t.interior) {
      load_tile<true>(fr, t.y0, t.x0, height, width, paired, sy, sx, dst MCRAW_CK);
    } else {
      load_tile<false>(fr, t.y0, t.x0, height, width, paired, sy, sx, dst MCRAW_CK);
    }
  };

  uint2 cur[kQuadSteps];
  TileAt t = at();
  load(t, cur);
  int tile = blockIdx.x;
  auto step = [&](auto cfa, const DevelopParams& p) {
    using P = decltype(cfa);
    if (t.interior) {
      stage_tile<kMalvar, true>(p, t.y0, t.x0, height, width, sy, sx, cur, s_tile MCRAW_CK);
    } else {
      stage_tile<kMalvar, false>(p, t.y0, t.x0, height, width, sy, sx, cur, s_tile MCRAW_CK);
    }
    __syncthreads();
    const int y0 = t.y0, x0 = t.x0, frame = t.f;
    if (tile + static_cast<int>(gridDim.x) < tiles) {  // in flight while this tile develops
      walk.advance();
      t = at();
      load(t, cur);
    }
    develop_or_clear<P, kMalvar>(p, s_tile, out + frame * plane, y0, x0, height, width,
                                 s_q MCRAW_CK);
    __syncthreads();  // the tile is restaged next
    tile += gridDim.x;
  };
  rows.walk(tile, tiles, [&] { return t.f; }, step MCRAW_CK);
}

// The direct path with one row for the launch, of CFA P.
template <class P, bool kMalvar>
__global__ void __launch_bounds__(kThreads, 3)
    develop_kernel(const uint16_t* __restrict__ raw, uint32_t* __restrict__ out, int height,
                   int width, int tiles_x, int tiles_y, int tiles, int step_x, int step_y,
                   const uint32_t* __restrict__ quantizer,
                   const __grid_constant__ DevelopParams p MCRAW_CK_KERNEL_PARAM) {
  MCRAW_CK_KERNEL_INIT
  OneRow<P> rows{p};
  develop_direct<kMalvar>(raw, out, height, width, tiles_x, tiles_y, tiles, step_x, step_y,
                          quantizer,
                          rows MCRAW_CK);
}

// The direct path with a row and a CFA for each frame.
template <bool kMalvar>
__global__ void __launch_bounds__(kThreads, kRowsBlocks)
    develop_kernel(const uint16_t* __restrict__ raw, uint32_t* __restrict__ out, int height,
                   int width, int tiles_x, int tiles_y, int tiles, int step_x, int step_y,
                   const uint32_t* __restrict__ quantizer,
                   const __grid_constant__ FrameRows frame_rows MCRAW_CK_KERNEL_PARAM) {
  MCRAW_CK_KERNEL_INIT
  PerFrame rows{frame_rows};
  develop_direct<kMalvar>(raw, out, height, width, tiles_x, tiles_y, tiles, step_x, step_y,
                          quantizer,
                          rows MCRAW_CK);
}

// -- the ring path ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// The box at (x, y, f) of `map` into `dst`; its bytes complete `bar`'s
// phase. Coordinates may be negative: the hardware fills what lies outside
// the tensor with 0.
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map, int x, int y,
                                             int f, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(f), "r"(smem(bar))
      : "memory");
}

// The developing warps' own barrier (the producer warp is not in it).
__device__ __forceinline__ void developers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

// Normalizes one ring stage (the box's raw uint16, rows of kBoxW, staged
// column 0 at box column kBoxX0 - kHalo) into the float tile: every value
// as stage_tile normalizes one inside its frame. The box holds raw 0
// outside the frame. A one-row launch takes this path only where raw 0
// normalizes to 0 on every site, so that is what is staged there, as on
// the direct path; kMasked (a per-frame launch's frame where it does not,
// at a tile whose box reaches past the frame) stages 0 there by bounds
// tests against the tile at (y0, x0), as stage_tile does.
template <bool kMalvar, bool kMasked = false>
__device__ __forceinline__ void stage_ring(const DevelopParams& p, const uint16_t* stage,
                                           const void* ring_base, const int (&sy)[kQuadSteps],
                                           const int (&sx)[kQuadSteps],
                                           float (*tile)[kRowW], int y0, int x0, int height,
                                           int width MCRAW_CK_PARAM) {
#pragma unroll
  for (int k = 0; k < kQuadSteps; ++k) {
    if (sy[k] >= kRows) break;
    bool in[4] = {true, true, true, true};
    if constexpr (kMasked) {
      const int gy = y0 - kHalo + sy[k];
      const int gx = x0 - kHalo + sx[k];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        in[e] = static_cast<unsigned>(gy) < static_cast<unsigned>(height) &&
                static_cast<unsigned>(gx + e) < static_cast<unsigned>(width);
      }
    }
    // 4-byte aligned: two pairs
    const uint32_t* pairs = reinterpret_cast<const uint32_t*>(
        stage + sy[k] * kBoxW + (kBoxX0 - kHalo) + sx[k]);
    const uint2 words = make_uint2(MCRAW_SLDN(kBufSRing, ring_base, kRingBytes, pairs, 0),
                                   MCRAW_SLDN(kBufSRing, ring_base, kRingBytes, pairs, 1));
    // The tile's rows start on an even row of the frame, its columns on an
    // even column: the staged row's parity is its own.
    MCRAW_SSTN(kBufSTile, tile, kTileBytes,
               reinterpret_cast<float4*>(&tile[sy[k]][sx[k]]),
               0, normalize4<kMalvar>(p, sy[k] & 1, words, in));
  }
}

namespace ring {

// The same tile walk and arithmetic as ::develop_kernel (and the same name,
// by which a trace knows the develop), fed from a ring of raw boxes: warp
// kThreads / 32 is the producer, one lane of which copies each tile's box
// with the Tensor Memory Accelerator into the next stage once the
// developing warps have released it; they wait on the stage's full
// barrier, normalize it into the float tile, release the stage, meet at
// their own barrier, develop the tile and meet again before restaging it.
// Each tile's parameters come from `rows` (OneRow or PerFrame).
template <bool kMalvar, class Rows>
__device__ __forceinline__ void develop_ring(const CUtensorMap& map, uint32_t* __restrict__ out,
                                             int height, int width, int tiles_x, int tiles_y,
                                             int tiles, int step_x, int step_y,
                                             const uint32_t* __restrict__ quantizer,
                                             Rows& rows MCRAW_CK_PARAM) {
  extern __shared__ __align__(128) unsigned char s_smem[];
  uint16_t* s_ring = reinterpret_cast<uint16_t*>(s_smem);
  auto s_tile = reinterpret_cast<float (*)[kRowW]>(s_smem + kRingBytes);
  uint32_t* s_q = reinterpret_cast<uint32_t*>(s_smem + kRingBytes + kTileBytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(s_smem + kRingBytes + kTileBytes + kQuantizerBytes);
  uint64_t* empty = full + kRingStages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      bar_init(full + s, 1);               // the producer's arrival, and the box's bytes
      bar_init(empty + s, kThreads);       // every developing thread's
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  TileWalk walk(tiles_x, tiles_y, step_x, step_y);

  if (tid >= kThreads) {  // the producer warp: one lane issues every copy
    if (tid == kThreads) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        bar_wait(empty + stage, phase ^ 1);
        uint16_t* dst = s_ring + stage * (kStagePitch / 2);
        if (MCRAW_SHARED_OK(kBufSRing, s_ring, kRingBytes, dst, kBoxBytes)) {
          bar_arrive_tx(full + stage, kBoxBytes);
          tma_load_box(dst, &map, walk.x0() - kBoxX0, walk.y0() - kHalo, walk.f, full + stage);
        } else {
          bar_arrive(full + stage);  // the checked build's skipped copy
        }
        walk.advance();
        if (++stage == kRingStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  for (int i = tid; i < kQuantizer; i += kThreads) {
    MCRAW_SSTN(kBufSQ, s_q, kQuantizerBytes, s_q, i, MCRAW_LD(kBufQuantizer, quantizer, i));
  }
  const int64_t plane = static_cast<int64_t>(height) * width;
  int sy[kQuadSteps], sx[kQuadSteps];
  staged_places(sy, sx);
  int stage = 0;
  uint32_t phase = 0;
  int tile = blockIdx.x;
  auto step = [&](auto cfa, const DevelopParams& p) {
    using P = decltype(cfa);
    bar_wait(full + stage, phase);
    const uint16_t* box = s_ring + stage * (kStagePitch / 2);
    if (rows.masked(walk.y0(), walk.x0(), height, width)) {
      stage_ring<kMalvar, true>(p, box, s_ring, sy, sx, s_tile, walk.y0(), walk.x0(), height,
                                width MCRAW_CK);
    } else {
      stage_ring<kMalvar>(p, box, s_ring, sy, sx, s_tile, 0, 0, 0, 0 MCRAW_CK);
    }
    bar_arrive(empty + stage);
    developers_sync();  // every value of the float tile is staged
    develop_or_clear<P, kMalvar>(p, s_tile, out + walk.f * plane, walk.y0(), walk.x0(), height,
                                 width, s_q MCRAW_CK);
    walk.advance();
    developers_sync();  // every thread is past the tile, which is restaged next
    if (++stage == kRingStages) {
      stage = 0;
      phase ^= 1;
    }
    tile += gridDim.x;
  };
  rows.walk(tile, tiles, [&] { return walk.f; }, step MCRAW_CK);
}

// The ring with one row for the launch, of CFA P.
template <class P, bool kMalvar>
__global__ void __launch_bounds__(kRingThreads, kRingBlocks)
    develop_kernel(const __grid_constant__ CUtensorMap map, uint32_t* __restrict__ out,
                   int height, int width, int tiles_x, int tiles_y, int tiles, int step_x,
                   int step_y,
                   const uint32_t* __restrict__ quantizer,
                   const __grid_constant__ DevelopParams p MCRAW_CK_KERNEL_PARAM) {
  MCRAW_CK_KERNEL_INIT
  OneRow<P> rows{p};
  develop_ring<kMalvar>(map, out, height, width, tiles_x, tiles_y, tiles, step_x, step_y,
                        quantizer,
                        rows MCRAW_CK);
}

// The ring with a row and a CFA for each frame.
template <bool kMalvar>
__global__ void __launch_bounds__(kRingThreads, kRowsBlocks)
    develop_kernel(const __grid_constant__ CUtensorMap map, uint32_t* __restrict__ out,
                   int height, int width, int tiles_x, int tiles_y, int tiles, int step_x,
                   int step_y,
                   const uint32_t* __restrict__ quantizer,
                   const __grid_constant__ FrameRows frame_rows MCRAW_CK_KERNEL_PARAM) {
  MCRAW_CK_KERNEL_INIT
  PerFrame rows{frame_rows};
  develop_ring<kMalvar>(map, out, height, width, tiles_x, tiles_y, tiles, step_x, step_y,
                        quantizer,
                        rows MCRAW_CK);
}

}  // namespace ring

// -- the entries -----------------------------------------------------------------

// A launch's kernels, direct and ring: one row of CFA P (the argument a
// DevelopParams), or a row and a CFA for each frame (P FrameCfa, the
// argument a FrameRows).
struct FrameCfa {};

template <class P, bool kMalvar>
auto direct_kernel() {
  if constexpr (std::is_same_v<P, FrameCfa>) {
    return develop_kernel<kMalvar>;
  } else {
    return develop_kernel<P, kMalvar>;
  }
}

template <class P, bool kMalvar>
auto ring_kernel() {
  if constexpr (std::is_same_v<P, FrameCfa>) {
    return ring::develop_kernel<kMalvar>;
  } else {
    return ring::develop_kernel<P, kMalvar>;
  }
}

template <class P, bool kMalvar, class Arg>
cudaError_t launch_direct(const uint16_t* raw, uint32_t* out, int h, int w, int tiles_x,
                          int tiles_y, int tiles, const uint32_t* quantizer, const Arg& arg,
                          cudaStream_t s MCRAW_CK_ENTRY_PARAM) {
  const auto kernel = direct_kernel<P, kMalvar>();
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(tiles < cap ? tiles : cap);  // tiles < 2^31
  const int step_y = static_cast<int>(grid) / tiles_x;
  const int step_x = static_cast<int>(grid) - step_y * tiles_x;
  kernel<<<grid, kThreads, 0, s>>>(
      raw, out, h, w, tiles_x, tiles_y, tiles, step_x, step_y, quantizer,
      arg MCRAW_CK_LAUNCH(mcraw_check::kDevelop,
                          (std::is_same_v<P, FrameCfa> ? mcraw_check::kEntryDevelopRows
                                                       : mcraw_check::kEntryDevelop)));
  return cudaGetLastError();
}

template <class P, bool kMalvar, class Arg>
cudaError_t launch_ring(const CUtensorMap& map, uint32_t* out, int h, int w, int tiles_x,
                        int tiles_y, int tiles, const uint32_t* quantizer, const Arg& arg,
                        cudaStream_t s MCRAW_CK_ENTRY_PARAM) {
  constexpr int64_t smem_bytes = kRingSmemBytes;
  const auto kernel = ring_kernel<P, kMalvar>();
  // The persistent grid on each device, 0 until the first launch there,
  // which also lets the kernel have its dynamic shared memory.
  static int caps[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  int cap = dev < kMaxDevices ? caps[dev] : 0;
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem_bytes));
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRingThreads, smem_bytes);
    cap = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) caps[dev] = cap;
  }
  const unsigned grid = static_cast<unsigned>(tiles < cap ? tiles : cap);
  const int step_y = static_cast<int>(grid) / tiles_x;
  const int step_x = static_cast<int>(grid) - step_y * tiles_x;
  kernel<<<grid, kRingThreads, smem_bytes, s>>>(
      map, out, h, w, tiles_x, tiles_y, tiles, step_x, step_y, quantizer,
      arg MCRAW_CK_LAUNCH(mcraw_check::kDevelop,
                          (std::is_same_v<P, FrameCfa> ? mcraw_check::kEntryDevelopRowsRing
                                                       : mcraw_check::kEntryDevelopRing)));
  return cudaGetLastError();
}

// The kernel's parameters from the entry's host row and CFA (both copied
// into the kernel's by-value argument); false for a channel outside 0..2.
bool pack_params(const float* params, const int32_t* cfa, DevelopParams* p) {
  const float white = params[4];
  for (int k = 0; k < 4; ++k) {
    if (cfa[k] < 0 || cfa[k] > 2) return false;
    p->black[k] = params[k];
    p->inv_scale[k] = 1.f / (white - params[k]);
    p->gain_site[k] = params[5 + cfa[k]];
  }
  for (int c = 0; c < 3; ++c) p->gain[c] = params[5 + c];
  for (int i = 0; i < 9; ++i) p->m[i] = params[8 + i];
  return true;
}

// launch(Cfa<...>{}) for the Bayer pattern `cfa`, or cudaErrorInvalidValue
// for another pattern.
template <class Launch>
cudaError_t with_cfa(const int32_t* cfa, Launch&& launch) {
  switch (bayer_index(cfa)) {
    case 0: return launch(Cfa<0, 1, 1, 2>{});
    case 1: return launch(Cfa<2, 1, 1, 0>{});
    case 2: return launch(Cfa<1, 0, 2, 1>{});
    case 3: return launch(Cfa<1, 2, 0, 1>{});
    default: return cudaErrorInvalidValue;
  }
}

// The grid's tiles of `frames` frames; false for a size the kernels cannot
// index.
bool tiling(int64_t frames, int64_t height, int64_t width, int* tiles_x, int* tiles_y,
            int* tiles) {
  const int64_t gx = (width + kTileW - 1) / kTileW;
  const int64_t gy = (height + kTileH - 1) / kTileH;
  if (height * width > (int64_t{1} << 31) || gx * gy * frames > 0x7FFFFFFF) return false;
  *tiles_x = static_cast<int>(gx);
  *tiles_y = static_cast<int>(gy);
  *tiles = static_cast<int>(gx * gy * frames);
  return true;
}

// cuTensorMapEncodeTiled, reached through the runtime, so that the library
// links no -lcuda; nullptr where the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A 3-D tiled map of uint16 over `base`: dims and the box innermost first,
// the strides (bytes) of dims 1 and 2; no swizzle, and 0 outside the
// tensor. 0, the driver's CUresult, or -1 where there is no encoder.
int encode_u16_map(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[3],
                   const cuuint64_t (&strides)[2], const cuuint32_t (&box)[3]) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint32_t unit[3] = {1, 1, 1};
  return static_cast<int>(encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT16, 3, const_cast<void*>(base),
                                 dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                 CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace

// Develops `frames` (height, width) uint16 frames laid out one after
// another in `raw` into as many uint32 RGBA8888 frames in `out`, on the
// direct path. params: host pointer to pack_develop_params's row (at least
// 17 floats); cfa: host pointer to 4 int32 channels, one of the four Bayer
// patterns (both copied into the kernel's by-value argument); quantizer:
// device pointer to the kQuantizer words of develop.quantizer_table;
// malvar: 0 bilinear, 1 Malvar. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a size the kernel cannot index or another CFA.
extern "C" int mcraw_develop(const uint16_t* raw, uint32_t* out, int64_t frames,
                             int64_t height, int64_t width, const float* params,
                             const int32_t* cfa, const uint32_t* quantizer, int32_t malvar,
                             void* stream MCRAW_CK_ENTRY_PARAM) {
  if (frames <= 0 || height <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  int tx = 0, ty = 0, tiles = 0;
  if (!tiling(frames, height, width, &tx, &ty, &tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MCRAW_CK_HOST(mcraw_check::kDevelop, mcraw_check::kEntryDevelop, kBufParams, kHost,
                static_cast<int64_t>(17 * sizeof(float)))
  MCRAW_CK_HOST(mcraw_check::kDevelop, mcraw_check::kEntryDevelop, kBufCfa, kHost,
                static_cast<int64_t>(4 * sizeof(int32_t)))
  DevelopParams p;
  if (!pack_params(params, cfa, &p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(height);
  const int w = static_cast<int>(width);
  return static_cast<int>(with_cfa(cfa, [&](auto cfa_type) {
    using P = decltype(cfa_type);
    return malvar != 0 ? launch_direct<P, true>(raw, out, h, w, tx, ty, tiles, quantizer, p,
                                                s MCRAW_CK_ENTRY)
                       : launch_direct<P, false>(raw, out, h, w, tx, ty, tiles, quantizer, p,
                                                 s MCRAW_CK_ENTRY);
  }));
}

// Encodes into `map` (host memory, 128 bytes, a CUtensorMap) the 3-D tiled
// map of uint16 over the device address `base` that kernels/develop.py's
// ring_map_geometry describes: dims[3] and box[3] innermost first,
// strides[2] the bytes of a row and of a frame. Returns 0, the driver's
// CUresult, or -1 where the driver has no cuTensorMapEncodeTiled.
extern "C" int mcraw_develop_map(void* map, const void* base, const int64_t* dims,
                                 const int64_t* strides, const int32_t* box) {
  const cuuint64_t d[3] = {static_cast<cuuint64_t>(dims[0]), static_cast<cuuint64_t>(dims[1]),
                           static_cast<cuuint64_t>(dims[2])};
  const cuuint64_t st[2] = {static_cast<cuuint64_t>(strides[0]),
                            static_cast<cuuint64_t>(strides[1])};
  const cuuint32_t b[3] = {static_cast<cuuint32_t>(box[0]), static_cast<cuuint32_t>(box[1]),
                           static_cast<cuuint32_t>(box[2])};
  CUtensorMap m;
  std::memset(&m, 0, sizeof m);
  const int err = encode_u16_map(&m, base, d, st, b);
  if (err == 0) std::memcpy(map, &m, sizeof m);
  return err;
}

#ifdef MCRAW_CHECKED
namespace {

// The checked build's test of a ring entry's map: it must be the map that
// mcraw_develop_map encodes from raw and its shape; else a host fault on
// map, and false.
bool map_matches(const void* map, const uint16_t* raw, int64_t frames, int64_t height,
                 int64_t width, int entry, mcraw_check::Args* check_args) {
  const cuuint64_t d[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(height),
                           static_cast<cuuint64_t>(frames)};
  const cuuint64_t st[2] = {static_cast<cuuint64_t>(2 * width),
                            static_cast<cuuint64_t>(2 * width * height)};
  const cuuint32_t b[3] = {kBoxW, kRows, 1};
  CUtensorMap want;
  std::memset(&want, 0, sizeof want);
  const int err = encode_u16_map(&want, raw, d, st, b);
  const unsigned char* got = static_cast<const unsigned char*>(map);
  const unsigned char* ref = reinterpret_cast<const unsigned char*>(&want);
  int64_t at = err != 0 ? 0 : -1;
  for (int64_t i = 0; at < 0 && i < static_cast<int64_t>(sizeof want); ++i) {
    if (got[i] != ref[i]) at = i;
  }
  if (at < 0) return true;
  mcraw_check::host_fault(check_args, mcraw_check::kDevelop, entry, kBufMap,
                          mcraw_check::kHost, at, sizeof want);
  return false;
}

}  // namespace
#endif

// As mcraw_develop, on the ring path, with `map` (host memory, 128 bytes)
// the tensor map of `raw` that mcraw_develop_map encoded: the caller takes
// this entry only where width % 8 == 0, raw is 16-byte aligned and raw 0
// normalizes to 0 on every site (kernels/develop.py::ring_takes); this
// returns cudaErrorInvalidValue where the first two do not hold. The
// checked build also holds the map's reach, frames * height * width
// uint16, to raw's extent (a cp.async fault, on the host), and the map to
// the one this entry encodes from those numbers (a host fault on map).
extern "C" int mcraw_develop_ring(const uint16_t* raw, uint32_t* out, int64_t frames,
                                  int64_t height, int64_t width, const float* params,
                                  const int32_t* cfa, const uint32_t* quantizer, int32_t malvar,
                                  const void* map, void* stream MCRAW_CK_ENTRY_PARAM) {
  if (frames <= 0 || height <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  int tx = 0, ty = 0, tiles = 0;
  if (!tiling(frames, height, width, &tx, &ty, &tiles) || width % 8 != 0 ||
      reinterpret_cast<uintptr_t>(raw) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MCRAW_CK_HOST(mcraw_check::kDevelop, mcraw_check::kEntryDevelopRing, kBufParams, kHost,
                static_cast<int64_t>(17 * sizeof(float)))
  MCRAW_CK_HOST(mcraw_check::kDevelop, mcraw_check::kEntryDevelopRing, kBufCfa, kHost,
                static_cast<int64_t>(4 * sizeof(int32_t)))
  MCRAW_CK_HOST(mcraw_check::kDevelop, mcraw_check::kEntryDevelopRing, kBufMap, kHost,
                static_cast<int64_t>(sizeof(CUtensorMap)))
  MCRAW_CK_HOST(mcraw_check::kDevelop, mcraw_check::kEntryDevelopRing, kBufRaw, kCpAsync,
                frames * height * width * static_cast<int64_t>(sizeof(uint16_t)))
  alignas(64) CUtensorMap m;
  std::memcpy(&m, map, sizeof m);
#ifdef MCRAW_CHECKED
  if (!map_matches(map, raw, frames, height, width, mcraw_check::kEntryDevelopRing,
                   check_args)) {
    return 0;
  }
#endif
  DevelopParams p;
  if (!pack_params(params, cfa, &p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(height);
  const int w = static_cast<int>(width);
  return static_cast<int>(with_cfa(cfa, [&](auto cfa_type) {
    using P = decltype(cfa_type);
    return malvar != 0 ? launch_ring<P, true>(m, out, h, w, tx, ty, tiles, quantizer, p,
                                              s MCRAW_CK_ENTRY)
                       : launch_ring<P, false>(m, out, h, w, tx, ty, tiles, quantizer, p,
                                               s MCRAW_CK_ENTRY);
  }));
}

// As mcraw_develop, with a row and a CFA for each frame, in device memory:
// frame f's pack_develop_params row (at least 17 floats) at rows + f *
// row_stride floats, its 4 int32 channels at cfas + f * cfa_stride
// (rows_fit, else cudaErrorInvalidValue). Each frame's output is bit
// for bit mcraw_develop's of that frame alone with its own row and CFA. A
// frame whose CFA is not one of the four Bayer patterns is not developed:
// the caller checks the CFAs it uploads. The checked build holds each
// frame's reads of both blocks to their extents.
extern "C" int mcraw_develop_rows(const uint16_t* raw, uint32_t* out, int64_t frames,
                                  int64_t height, int64_t width, const float* rows,
                                  int64_t row_stride, const int32_t* cfas, int64_t cfa_stride,
                                  const uint32_t* quantizer, int32_t malvar,
                                  void* stream MCRAW_CK_ENTRY_PARAM) {
  if (frames <= 0 || height <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  int tx = 0, ty = 0, tiles = 0;
  if (!tiling(frames, height, width, &tx, &ty, &tiles) ||
      !rows_fit(frames, row_stride, cfa_stride)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FrameRows r{rows, cfas, row_stride, cfa_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(height);
  const int w = static_cast<int>(width);
  return static_cast<int>(
      malvar != 0
          ? launch_direct<FrameCfa, true>(raw, out, h, w, tx, ty, tiles, quantizer, r,
                                          s MCRAW_CK_ENTRY)
          : launch_direct<FrameCfa, false>(raw, out, h, w, tx, ty, tiles, quantizer, r,
                                           s MCRAW_CK_ENTRY));
}

// As mcraw_develop_rows, on the ring path, with `map` as for
// mcraw_develop_ring (width % 8 == 0 and raw 16-byte aligned, else
// cudaErrorInvalidValue). It takes any row: a frame whose raw 0 does not
// normalize to 0 stages its border tiles with bounds tests.
extern "C" int mcraw_develop_rows_ring(const uint16_t* raw, uint32_t* out, int64_t frames,
                                       int64_t height, int64_t width, const float* rows,
                                       int64_t row_stride, const int32_t* cfas,
                                       int64_t cfa_stride, const uint32_t* quantizer,
                                       int32_t malvar, const void* map,
                                       void* stream MCRAW_CK_ENTRY_PARAM) {
  if (frames <= 0 || height <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  int tx = 0, ty = 0, tiles = 0;
  if (!tiling(frames, height, width, &tx, &ty, &tiles) || width % 8 != 0 ||
      reinterpret_cast<uintptr_t>(raw) % 16 != 0 || !rows_fit(frames, row_stride, cfa_stride)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MCRAW_CK_HOST(mcraw_check::kDevelop, mcraw_check::kEntryDevelopRowsRing, kBufMap, kHost,
                static_cast<int64_t>(sizeof(CUtensorMap)))
  MCRAW_CK_HOST(mcraw_check::kDevelop, mcraw_check::kEntryDevelopRowsRing, kBufRaw, kCpAsync,
                frames * height * width * static_cast<int64_t>(sizeof(uint16_t)))
  alignas(64) CUtensorMap m;
  std::memcpy(&m, map, sizeof m);
#ifdef MCRAW_CHECKED
  if (!map_matches(map, raw, frames, height, width, mcraw_check::kEntryDevelopRowsRing,
                   check_args)) {
    return 0;
  }
#endif
  const FrameRows r{rows, cfas, row_stride, cfa_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(height);
  const int w = static_cast<int>(width);
  return static_cast<int>(
      malvar != 0 ? launch_ring<FrameCfa, true>(m, out, h, w, tx, ty, tiles, quantizer, r,
                                                s MCRAW_CK_ENTRY)
                  : launch_ring<FrameCfa, false>(m, out, h, w, tx, ty, tiles, quantizer, r,
                                                 s MCRAW_CK_ENTRY));
}
