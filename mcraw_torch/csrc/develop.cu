// Develop: Bayer uint16 -> packed RGBA8888 (R | G<<8 | B<<16 | 0xFF<<24).
//
// Replaces mcraw/kernels/pallas_develop.py::_develop_kernel and
// _develop_emit (launched by develop_rgba_pallas). It computes their
// function, not their machinery: the row bands with double-buffered DMA,
// the 16-sublane-aligned halo scratch, the per-frame top padding and frame
// blocks, lane rolls with the wrapped lane zeroed and 128-lane width
// padding exist for VMEM and vregs; an H100 reads device memory by address.
//
// One thread per output pixel (x, y) of frame blockIdx.z, 32x8 threads a
// block, so a warp stores 32 neighbouring uint32. Each thread loads the
// taps it needs once from global memory (through L1/L2: neighbouring
// threads share them): the 3x3 neighbourhood for bilinear, the 13 taps of
// the 5x5 cross-and-diagonal that Malvar-He-Cutler uses. Every tap is
// normalized on its own CFA site, clip((raw - black) * 1/(white - black),
// 0, 1); a tap outside [0, height) x [0, width) of its own frame is 0, so
// any width and any height work with no padding, and no frame reads its
// neighbour's rows. Which site a tap sits on follows from the parities of
// its offset, so each thread picks its four sites' parameters once (Sites)
// and every index after that is a compile-time constant.
//
// Arithmetic, in float32, is that of the plain version
// (mcraw_torch/kernels/develop.py::develop_rgba_plain), step for step:
//   bilinear: per channel c, the taps of channel c only; R/B as the
//     separable [1,2,1]^T x [1,2,1] sum (rows, then columns), G as the cross
//     4*mid + up + down + right + left; times the closed-form normalizer
//     1/conv(mask) (R/B: fac(row) * fac(col); G: 1/4 at G sites, else
//     1/(4 - clipped arms)), times the white-balance gain; clip;
//   malvar: gain on every tap first, then the four MHC estimators k1..k4
//     and the per-site select (the horizontally adjacent site's channel
//     tells the two G phases apart); clip;
//   emit: m = XYZ(D50)->sRGB @ forward matrix as scalar multiply-adds, clip,
//     the sRGB curve 1.055 * expf(logf(max(x, 1e-12)) / 2.4) - 0.055 above
//     0.0031308 (12.92 * x below), round half to even (rintf) of x * 255.
// Every product and sum goes through __fmul_rn / __fadd_rn / __fsub_rn, so
// nvcc contracts none of them into an FMA: each rounds once, as the plain
// version's torch ops do. expf, logf and the division are the accurate ones
// (the build has no fast-math). The contract is <= 1 LSB per channel
// against the f64 model (mcraw_torch.preview.develop_f64).
//
// What bounds it: at 4096x3072 it reads 25.2 MB of uint16 and writes
// 50.3 MB of uint32, 75.5 MB in all, >= 0.023 ms at 3.35 TB/s. It takes
// about ten times that (0.29 ms bilinear, 0.26 ms Malvar on an H100 SXM at
// 700 W: 256 and 289 GB/s), so instruction issue bounds it, not bytes: each
// raw value is loaded and normalized again by each of the 9 or 13 threads
// whose window holds it, and every pixel runs three accurate logf + expf
// pairs and IEEE divisions. Staging a normalized tile in shared memory is
// the next step, and work for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

struct DevelopParams {
  float black[4];      // per 2x2 site
  float inv_scale[4];  // 1 / (white - black), per site
  float gain[3];       // 1 / as_shot_neutral, per channel
  float m[9];          // XYZ(D50)->sRGB @ forward matrix, row-major
  int cfa[4];          // channel (0 R, 1 G, 2 B) of each 2x2 site
  int pos[3];          // the 2x2 site of R (pos[0]) and of B (pos[2])
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// clip to [0, 1]; NaN stays NaN, as torch.clamp and jnp.clip leave it.
__device__ __forceinline__ float clip01(float v) {
  return v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
}

template <typename T>
__device__ __forceinline__ T pick(const T (&a)[4], int k) {
  return k == 0 ? a[0] : (k == 1 ? a[1] : (k == 2 ? a[2] : a[3]));
}

// The parameters of the 2x2 sites as seen from one pixel: entry r belongs to
// every tap (y + dy, x + dx) with r = (dy & 1) << 1 | (dx & 1), i.e. to site
// k ^ r of the pixel's own site k = (y & 1) << 1 | (x & 1). Picked once per
// thread with selects, so that every later
// index is known at compile time: indexing the by-value parameters at run
// time would copy them to local memory.
struct Sites {
  float black[4], inv_scale[4], gain[4];
  int chan[4];
};

__device__ __forceinline__ Sites sites_of(const DevelopParams& p, int y, int x) {
  const int k = ((y & 1) << 1) | (x & 1);
  Sites s;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    s.black[r] = pick(p.black, k ^ r);
    s.inv_scale[r] = pick(p.inv_scale, k ^ r);
    s.chan[r] = pick(p.cfa, k ^ r);
    s.gain[r] = s.chan[r] == 0 ? p.gain[0] : (s.chan[r] == 1 ? p.gain[1] : p.gain[2]);
  }
  return s;
}

__device__ __forceinline__ constexpr int rel(int dy, int dx) { return ((dy & 1) << 1) | (dx & 1); }

// t[R + dy][R + dx]: the normalized tap at (y + dy, x + dx), 0 outside the
// frame. Each tap is loaded once; taps the demosaic does not use are dead
// code and not loaded.
template <int R>
__device__ __forceinline__ void load_taps(const uint16_t* __restrict__ raw, int height,
                                          int width, int y, int x, const Sites& s,
                                          float (&t)[2 * R + 1][2 * R + 1]) {
#pragma unroll
  for (int dy = -R; dy <= R; ++dy) {
#pragma unroll
    for (int dx = -R; dx <= R; ++dx) {
      const int yy = y + dy;
      const int xx = x + dx;
      float v = 0.f;
      if (yy >= 0 && yy < height && xx >= 0 && xx < width) {
        const float raw_v = static_cast<float>(raw[static_cast<int64_t>(yy) * width + xx]);
        v = clip01(mul(sub(raw_v, s.black[rel(dy, dx)]), s.inv_scale[rel(dy, dx)]));
      }
      t[R + dy][R + dx] = v;
    }
  }
}

// 1 / (the [1,2,1] sum of one parity's mask along an axis): {0, 1/2, 1}.
__device__ __forceinline__ float fac(int idx, int par, int last) {
  const bool b0 = (idx & 1) == par;
  const bool bm = idx > 0 && ((idx - 1) & 1) == par;
  const bool bp = idx < last && ((idx + 1) & 1) == par;
  const float f = (b0 ? 2.f : 0.f) + (bm ? 1.f : 0.f) + (bp ? 1.f : 0.f);
  return f > 0.f ? 1.f / f : 0.f;
}

__device__ __forceinline__ void bilinear(const DevelopParams& p, const Sites& s,
                                         const float (&t)[3][3], int y, int x, int height,
                                         int width, float (&rgb)[3]) {
  // The tap at (dy, dx) if its site is channel c, else 0.
  auto of = [&](int c, int dy, int dx) {
    return s.chan[rel(dy, dx)] == c ? t[1 + dy][1 + dx] : 0.f;
  };
#pragma unroll
  for (int c = 0; c < 3; c += 2) {  // R and B: separable [1,2,1] x [1,2,1]
    float v[3];
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      v[1 + dx] = add(add(of(c, -1, dx), mul(2.f, of(c, 0, dx))), of(c, 1, dx));
    }
    const float num = add(add(mul(2.f, v[1]), v[2]), v[0]);
    const float inv = mul(fac(y, p.pos[c] >> 1, height - 1), fac(x, p.pos[c] & 1, width - 1));
    rgb[c] = clip01(mul(mul(num, inv), p.gain[c]));
  }
  // G: the cross 4 * mid + up + down + right + left.
  const float num = add(add(add(add(mul(4.f, of(1, 0, 0)), of(1, -1, 0)), of(1, 1, 0)),
                            of(1, 0, 1)),
                        of(1, 0, -1));
  float inv = 0.25f;
  if (s.chan[0] != 1) {
    const int arms = (y == 0) + (y == height - 1) + (x == 0) + (x == width - 1);
    inv = arms == 0 ? 0.25f : (arms == 1 ? 1.f / 3.f : (arms == 2 ? 0.5f : 1.f));
  }
  rgb[1] = clip01(mul(mul(num, inv), p.gain[1]));
}

__device__ __forceinline__ void malvar(const Sites& s, const float (&t)[5][5],
                                       float (&rgb)[3]) {
  // The tap at (dy, dx) times its site's white-balance gain.
  auto wb = [&](int dy, int dx) { return mul(t[2 + dy][2 + dx], s.gain[rel(dy, dx)]); };
  const float mid = wb(0, 0);
  const float h1 = add(wb(0, 1), wb(0, -1));
  const float h2 = add(wb(0, 2), wb(0, -2));
  const float v1 = add(wb(-1, 0), wb(1, 0));
  const float v2 = add(wb(-2, 0), wb(2, 0));
  const float d1 = add(add(add(wb(-1, 1), wb(-1, -1)), wb(1, 1)), wb(1, -1));
  const float hv2 = add(h2, v2);
  const float k1 = mul(sub(add(mul(4.f, mid), mul(2.f, add(h1, v1))), hv2), 0.125f);
  const float k2 =
      mul(add(sub(sub(add(mul(5.f, mid), mul(4.f, h1)), d1), h2), mul(0.5f, v2)), 0.125f);
  const float k3 =
      mul(add(sub(sub(add(mul(5.f, mid), mul(4.f, v1)), d1), v2), mul(0.5f, h2)), 0.125f);
  const float k4 = mul(sub(add(mul(6.f, mid), mul(2.f, d1)), mul(1.5f, hv2)), 0.125f);
  const int cm = s.chan[0];
  const int hcm = s.chan[1];  // the horizontally adjacent site's channel
  rgb[0] = clip01(cm == 0 ? mid : (cm == 1 ? (hcm == 0 ? k2 : k3) : k4));
  rgb[1] = clip01(cm == 1 ? mid : k1);
  rgb[2] = clip01(cm == 2 ? mid : (cm == 1 ? (hcm == 2 ? k2 : k3) : k4));
}

__device__ __forceinline__ uint32_t emit(const float (&m)[9], const float (&rgb)[3]) {
  uint32_t packed = 0xFF000000u;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float lin = clip01(
        add(add(mul(m[3 * r], rgb[0]), mul(m[3 * r + 1], rgb[1])), mul(m[3 * r + 2], rgb[2])));
    const float lo = lin < 1e-12f ? 1e-12f : lin;
    const float curve = sub(mul(1.055f, expf(__fdiv_rn(logf(lo), 2.4f))), 0.055f);
    const float v = clip01(lin <= 0.0031308f ? mul(12.92f, lin) : curve);
    packed |= static_cast<uint32_t>(__float2int_rn(mul(v, 255.f))) << (8 * r);
  }
  return packed;
}

template <bool kMalvar>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    develop_kernel(const uint16_t* __restrict__ raw, uint32_t* __restrict__ out,
                   int height, int width, const DevelopParams p) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= width || y >= height) return;
  const int64_t base = static_cast<int64_t>(blockIdx.z) * height * width;
  const Sites s = sites_of(p, y, x);
  float rgb[3];
  if constexpr (kMalvar) {
    float t[5][5];
    load_taps<2>(raw + base, height, width, y, x, s, t);
    malvar(s, t, rgb);
  } else {
    float t[3][3];
    load_taps<1>(raw + base, height, width, y, x, s, t);
    bilinear(p, s, t, y, x, height, width, rgb);
  }
  out[base + static_cast<int64_t>(y) * width + x] = emit(p.m, rgb);
}

}  // namespace

// Develops `frames` (height, width) uint16 frames laid out one after
// another in `raw` into as many uint32 RGBA8888 frames in `out`.
// params: host pointer to pack_develop_params's row (at least 17 floats);
// cfa: host pointer to 4 int32 channels; malvar: 0 bilinear, 1 Malvar. Both
// are copied into the kernel's by-value argument, so nothing is uploaded.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a size the grid cannot hold.
extern "C" int mcraw_develop(const uint16_t* raw, uint32_t* out, int64_t frames,
                             int64_t height, int64_t width, const float* params,
                             const int32_t* cfa, int32_t malvar, void* stream) {
  if (frames <= 0 || height <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t gx = (width + kBlockX - 1) / kBlockX;
  const int64_t gy = (height + kBlockY - 1) / kBlockY;
  if (gx > 0x7FFFFFFF || gy > 65535 || frames > 65535 || height * width > (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DevelopParams p;
  const float white = params[4];
  for (int k = 0; k < 4; ++k) {
    p.black[k] = params[k];
    p.inv_scale[k] = 1.f / (white - params[k]);
    p.cfa[k] = cfa[k];
    if (cfa[k] < 0 || cfa[k] > 2) return static_cast<int>(cudaErrorInvalidValue);
    p.pos[cfa[k]] = k;
  }
  for (int c = 0; c < 3; ++c) p.gain[c] = params[5 + c];
  for (int i = 0; i < 9; ++i) p.m[i] = params[8 + i];

  const dim3 block(kBlockX, kBlockY);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(frames));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(height);
  const int w = static_cast<int>(width);
  if (malvar) {
    develop_kernel<true><<<grid, block, 0, s>>>(raw, out, h, w, p);
  } else {
    develop_kernel<false><<<grid, block, 0, s>>>(raw, out, h, w, p);
  }
  return static_cast<int>(cudaGetLastError());
}
