"""Develop: Bayer uint16 -> packed RGBA8888, in one pass.

The port of the JAX package's fused develop kernel
(``mcraw/kernels/pallas_develop.py::_develop_kernel`` + ``_develop_emit``,
launched by ``develop_rgba_pallas``). Per pixel, in float32:

1. normalize every tap by its CFA site: ``clip((raw - black) * 1/(white -
   black), 0, 1)``; taps outside the frame are 0;
2. demosaic, bilinear or Malvar-He-Cutler 5x5, with white balance (the
   gains 1/as_shot_neutral) after the normalized convolution (bilinear) or
   on every tap before it (Malvar); clip;
3. the 3x3 matrix XYZ(D50)->sRGB @ forward matrix, clip, the sRGB curve
   ``1.055 * exp(log(x) / 2.4) - 0.055`` (linear below 0.0031308), and
   ``round(x * 255)`` half to even;
4. pack R | G<<8 | B<<16 | 0xFF<<24 into one uint32.

:func:`develop_rgba_plain` is that function in plain torch, with the
kernel's arithmetic and order of operations; :func:`develop_rgba_device`
is the wrapper: the plain version only for CPU tensors, the hand-written
CUDA kernel (``csrc/develop.cu``) for CUDA tensors, anything else raises.
A (B, H, W) batch develops each frame on its own: no tap reads a
neighbouring frame. It takes one parameter row and one CFA for every
frame, or a row and a CFA for each frame (:func:`develop_rgba_device`'s
per-frame form, counted by ``develop.frame_rows``): each frame's output is
then bit for bit that of the frame alone with its own row and CFA.

The kernel's raw values reach shared memory by one of two paths, the
output bit for bit the same: the ring, where :func:`ring_takes` holds
(rows a multiple of 16 bytes, a 16-byte-aligned base, raw 0 normalizing to
0; a per-frame launch needs the first two alone, :func:`ring_fits`), a
producer warp copying each tile's box (:data:`RING_BOX`) with the
Tensor Memory Accelerator through a tensor map (:func:`ring_map_geometry`,
encoded once per address and shape); else direct, each thread loading its
values. The counters ``develop.ring`` and ``develop.direct`` of
:mod:`mcraw_torch.observe` count the launches of each, ``develop.frame_rows``
the frames developed with a row of their own (on either device).

Not ported: the streamed-table normalizer (``inv2d``), ``gamma_mode="poly"``,
``ablate`` and ``band_rows``, which select TPU variants and timings.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import observe
from ..metadata import CFA_PATTERNS
from . import build

DEMOSAICS = ("bilinear", "malvar")
# The four 2x2 Bayer patterns: 0=R, 1=G, 2=B, the two G sites on a diagonal.
BAYER_CFAS = tuple(tuple(cfa) for cfa in CFA_PATTERNS.values())
N_PARAMS = 17  # b0..b3, white, g0..g2, m00..m22
# The kernel's sRGB quantizer buckets: bucket k >= 1 holds the float32 lin
# whose bits >> 16 are SRGB_BUCKET_BASE + k (128 buckets an octave, from
# 2^-13 up); bucket 0 holds [0, 2^-13); the last one holds 1.0.
SRGB_BUCKET_BASE = (0x39000000 >> 16) - 1  # 0x39000000 is 2^-13
SRGB_ENTRIES = (0x3F800000 >> 16) - SRGB_BUCKET_BASE + 1  # 0x3F800000 is 1.0

# Launch counters: the kernel's launches and the plain version's calls.
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0

# The ring path's box of raw uint16 a 64x32 tile, innermost first
# (columns, rows, frames): rows y0 - 2 .. y0 + 33 (the tile and its 2-pixel
# halo) and columns x0 - 8 .. x0 + 71, 8 to the left where the halo needs
# 2: the hardware copies a box only from a first column on a 16-byte
# boundary, and a row of 160 bytes is a multiple of 16 (csrc/develop.cu
# kBoxX0, kBoxW, kRows).
RING_BOX = (80, 36, 1)
RING_MAPS_KEPT = 64  # encoded tensor maps kept, by (address, frames, height, width)
_MAPS: dict[tuple[int, int, int, int], np.ndarray] = {}


def pack_develop_params(
    black_level, white_level, as_shot_neutral, forward_matrix
) -> np.ndarray:
    """(1, 128) float32 parameter row: [b0..b3, white, 1/neutral (3),
    m = XYZ(D50)->sRGB @ forward_matrix (9, row-major), 0...]. The same
    row, bit for bit, as ``pallas_develop.pack_develop_params``."""
    from ..preview import _XYZ_D50_TO_SRGB

    p = np.zeros((1, 128), dtype=np.float32)
    p[0, 0:4] = np.asarray(black_level, dtype=np.float32)
    p[0, 4] = np.float32(white_level)
    p[0, 5:8] = 1.0 / np.asarray(as_shot_neutral, dtype=np.float32)
    m = _XYZ_D50_TO_SRGB @ np.asarray(
        forward_matrix, dtype=np.float32
    ).reshape(3, 3)
    p[0, 8:17] = m.reshape(-1)
    return p


def srgb_code_f64(lin) -> np.ndarray:
    """round(255 * srgb(lin)) as int64 in float64, lin clipped to [0, 1]
    first: the last step of :func:`mcraw_torch.preview.develop_f64`, which
    calls it."""
    x = np.clip(np.asarray(lin, np.float64), 0, 1)
    v = np.where(x <= 0.0031308, 12.92 * x, 1.055 * np.power(x, 1 / 2.4) - 0.055)
    return np.round(np.clip(v, 0, 1) * 255.0).astype(np.int64)


@functools.cache
def srgb_thresholds() -> np.ndarray:
    """(257,) float32 thr: thr[c], 1 <= c <= 255, is the least float32
    lin in [0, 1] with :func:`srgb_code_f64` (lin) >= c; thr[0] = -inf and
    thr[256] = +inf. The code is monotone in lin, so the code of
    a float32 lin is the largest c with thr[c] <= lin. Found by bisection
    over the float32 bit patterns of [0, 1], which order as the values."""
    lo = np.zeros(255, np.int64)  # code(lo) < c, or lo = 0
    hi = np.full(255, np.float32(1.0).view(np.int32), np.int64)  # code(hi) >= c
    c = np.arange(1, 256)
    while np.any(hi - lo > 1):
        mid = (lo + hi) // 2
        ok = srgb_code_f64(mid.astype(np.int32).view(np.float32)) >= c
        hi = np.where(ok, mid, hi)
        lo = np.where(ok, lo, mid)
    thr = np.empty(257, np.float32)
    thr[0], thr[256] = -np.inf, np.inf
    thr[1:256] = hi.astype(np.int32).view(np.float32)
    return thr


def srgb_bucket_starts() -> np.ndarray:
    """(SRGB_ENTRIES,) float32, the least lin of each quantizer bucket."""
    k = np.arange(SRGB_ENTRIES, dtype=np.int64)
    start = ((SRGB_BUCKET_BASE + k) << 16).astype(np.int32).view(np.float32)
    start[0] = 0.0
    return start


@functools.cache
def srgb_quantizer() -> tuple[np.ndarray, np.ndarray]:
    """The kernel's quantizer buckets: (next_thr, base), (SRGB_ENTRIES,)
    float32 and uint8, base[k] the code at bucket k's start and next_thr[k]
    = thr[base[k] + 1] of :func:`srgb_thresholds`, the one threshold that
    can lie inside the bucket. Buckets are even in log2 lin, 128 an octave,
    so the lin of one warp's neighbouring pixels fall in few, nearby
    entries; the curve climbs at most ~78 codes an octave (at lin = 1), so
    a bucket holds at most one threshold, and [0, 2^-13) none (code 1
    starts at 1.52e-4): this raises if one held two, or bucket 0 one.
    :func:`quantizer_table` encodes them for the kernel."""
    thr = srgb_thresholds()
    start = srgb_bucket_starts()
    last = np.append(np.nextafter(start[1:], np.float32(0)), np.float32(1.0))
    base = np.searchsorted(thr[1:256], start, side="right")
    top = np.searchsorted(thr[1:256], last, side="right")
    if np.any(top - base > 1):
        raise AssertionError("an sRGB quantizer bucket holds two thresholds")
    if top[0] != base[0]:
        raise AssertionError("the sRGB quantizer's bucket 0 holds a threshold")
    return np.ascontiguousarray(thr[base + 1]), base.astype(np.uint8)


def quantizer_table() -> np.ndarray:
    """(SRGB_ENTRIES,) int32, the kernel's form of :func:`srgb_quantizer`:
    one word a bucket, (base << 16) + (0x10000 - T) where the bucket holds
    a threshold whose float32 bits' low 16 are T, else base << 16. A
    bucket k >= 1 is the floats whose high 16 bits are SRGB_BUCKET_BASE +
    k, so its threshold lies inside it exactly when the threshold's high 16
    bits are those; then for a lin of the bucket with low 16 bits L,
    (word + L) >> 16 is base + (L >= T), base + (lin >= threshold).
    6,664 bytes."""
    next_thr, base = srgb_quantizer()
    bits = next_thr.view(np.int32).astype(np.int64)
    inside = (bits >> 16) == SRGB_BUCKET_BASE + np.arange(SRGB_ENTRIES)
    inside[0] = False  # bucket 0 gathers every high half up to its own; no threshold
    word = (base.astype(np.int64) << 16) + np.where(inside, 0x10000 - (bits & 0xFFFF), 0)
    return word.astype(np.int32)


def srgb_quantize(lin) -> np.ndarray:
    """The kernel's quantizer in NumPy, its integer rule step for step: lin
    clipped to [0, 1] in float32 (NaN gives 0), its bits; the bucket, the
    bits' high 16 (an arithmetic shift: -0.0 is negative) floored at
    SRGB_BUCKET_BASE, less it; the code, the high half of the bucket's
    :func:`quantizer_table` word plus the bits' low 16. int64 codes."""
    lin = np.nan_to_num(np.clip(np.asarray(lin, np.float32), 0, 1))
    bits = lin.view(np.int32).astype(np.int64)
    k = np.maximum(bits >> 16, SRGB_BUCKET_BASE) - SRGB_BUCKET_BASE
    return (quantizer_table()[k].astype(np.int64) + (bits & 0xFFFF)) >> 16


_QUANTIZER: dict[str, torch.Tensor] = {}


def _quantizer_on(device: torch.device) -> torch.Tensor:
    """:func:`quantizer_table` on `device`, uploaded once per device."""
    key = str(device)
    if key not in _QUANTIZER:
        _QUANTIZER[key] = torch.from_numpy(quantizer_table()).to(device)
    return _QUANTIZER[key]


def _params_row(params) -> np.ndarray:
    p = np.ascontiguousarray(np.asarray(params, dtype=np.float32).reshape(-1))
    if p.size < N_PARAMS:
        raise ValueError(f"params has {p.size} values, need {N_PARAMS}")
    return p


def _check(raw: torch.Tensor, cfa, demosaic: str) -> None:
    if raw.dtype != torch.uint16 or raw.dim() not in (2, 3):
        raise ValueError(
            f"raw must be a (H, W) or (B, H, W) uint16 tensor, got {raw.dtype} "
            f"{tuple(raw.shape)}"
        )
    if tuple(cfa) not in BAYER_CFAS:
        raise ValueError(f"cfa must be one of the Bayer patterns {BAYER_CFAS}, got {cfa}")
    if demosaic not in DEMOSAICS:
        raise ValueError(f"demosaic must be one of {DEMOSAICS}, got {demosaic!r}")


def _bilinear_inv(h: int, w: int, cfa, device) -> list[torch.Tensor]:
    """Closed-form 1/conv(mask) for R, G, B (``pallas_develop.py:269-318``),
    each broadcastable to (h, w).

    R/B: kernel and single-phase mask factorize, so the normalizer is
    fac(row) * fac(col) with fac in {0, 1/2, 1}. G: a G site's cross arms
    are never G, so 1/4 there; a non-G site's arms are all G, so 1/(4 -
    clipped arms). Every value is the correctly rounded float32 of 1/n,
    equal bit for bit to the table where the table is finite."""
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]

    def fac(idx, par, last):
        b0 = (idx & 1) == par
        bm = (idx > 0) & (((idx - 1) & 1) == par)
        bp = (idx < last) & (((idx + 1) & 1) == par)
        f = b0.to(torch.float32) * 2.0 + bm.to(torch.float32) + bp.to(torch.float32)
        return torch.where(f > 0, 1.0 / f, 0.0)

    pos = {ch: i for i, ch in enumerate(cfa)}  # channel -> 2x2 index
    inv = {
        c: fac(rows, pos[c] // 2, h - 1) * fac(cols, pos[c] % 2, w - 1)
        for c in (0, 2)
    }
    arms = ((rows == 0).to(torch.int64) + (rows == h - 1).to(torch.int64)
            + (cols == 0).to(torch.int64) + (cols == w - 1).to(torch.int64))
    by_arms = torch.tensor([0.25, 1.0 / 3.0, 0.5, 1.0, 1.0], device=device)
    chan = site_map(torch.tensor(cfa, device=device), h, w)
    inv[1] = torch.where(chan == 1, 0.25, by_arms[arms])
    return [inv[0], inv[1], inv[2]]


def site_map(v: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(h, w) map of the per-site values v[0..3] (2x2 index by parity)."""
    yy = (torch.arange(h, device=v.device) % 2 == 0)[:, None]
    xx = (torch.arange(w, device=v.device) % 2 == 0)[None, :]
    return torch.where(yy, torch.where(xx, v[0], v[1]), torch.where(xx, v[2], v[3]))


def pack_rgba(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint32 R | G<<8 | B<<16 | 0xFF<<24 of three 0..255 channel tensors,
    packed in int64 (torch has no shifts on uint32)."""
    r, g, b = (c.to(torch.int64) for c in (r, g, b))
    return (r | (g << 8) | (b << 16) | (0xFF << 24)).to(torch.uint32)


def develop_rgba_plain(
    raw: torch.Tensor, params, *, cfa, demosaic: str = "bilinear"
) -> torch.Tensor:
    """Plain torch version of the develop kernel, on raw's device.

    raw: (H, W) or (B, H, W) uint16; params: the host row of
    :func:`pack_develop_params`. Returns uint32 RGBA8888 of raw's shape.

    float32 throughout, with the kernel's order of operations
    (:func:`develop_lin_plain`), then the sRGB curve in float32. The
    transcendentals are torch's, where the kernel's curve is the exact
    quantizer (:func:`srgb_quantize`), so kernel and plain version may
    still differ by one LSB at a rounding boundary."""
    global PLAIN_CALLS
    with build.COUNTER_LOCK:
        PLAIN_CALLS += 1
    out = []
    for lin in develop_lin_plain(raw, params, cfa=cfa, demosaic=demosaic):
        curve = 1.055 * torch.exp(torch.log(lin.clamp_min(1e-12)) / 2.4) - 0.055
        srgb = torch.where(lin <= 0.0031308, 12.92 * lin, curve)
        out.append(torch.round(srgb.clamp(0.0, 1.0) * 255.0))
    return pack_rgba(*out)


def develop_lin_plain(
    raw: torch.Tensor, params, *, cfa, demosaic: str = "bilinear"
) -> torch.Tensor:
    """The develop's linear sRGB before the curve, in plain torch on raw's
    device: (3, *raw.shape) float32, each channel clipped to [0, 1], the
    kernel's own values. The taps of each sum are added in the kernel's
    order and products and sums round one at a time. Shifts are zero
    padding + slices per frame; there is no conv2d and no matmul, so TF32
    cannot enter on the card. The kernel's RGBA is :func:`srgb_quantize`
    of these, channel for channel."""
    _check(raw, cfa, demosaic)
    cfa = tuple(int(c) for c in cfa)
    p = [float(v) for v in _params_row(params)[:N_PARAMS]]
    b, wf, g, m = p[0:4], np.float32(p[4]), p[5:8], p[8:17]
    frames = raw if raw.dim() == 3 else raw[None]
    _, h, w = frames.shape
    dev = raw.device
    if h == 0 or w == 0:
        return torch.empty((3, *raw.shape), dtype=torch.float32, device=dev)

    inv_sc = [float(np.float32(1.0) / (wf - np.float32(bk))) for bk in b]
    bl = site_map(torch.tensor(b, device=dev), h, w)
    isc = site_map(torch.tensor(inv_sc, device=dev), h, w)
    x = ((frames.to(torch.float32) - bl) * isc).clamp(0.0, 1.0)
    chan = site_map(torch.tensor(cfa, device=dev), h, w)

    def shifts(t, r):
        # sh(dy, dx)[..., y, x] = t[..., y + dy, x + dx], 0 outside the frame.
        tp = torch.nn.functional.pad(t, (r, r, r, r))
        return lambda dy, dx: tp[:, r + dy : r + dy + h, r + dx : r + dx + w]

    if demosaic == "malvar":
        gs = site_map(torch.tensor([g[c] for c in cfa], device=dev), h, w)
        sh = shifts(x * gs, 2)
        mid = sh(0, 0)
        h1 = sh(0, 1) + sh(0, -1)
        h2 = sh(0, 2) + sh(0, -2)
        v1 = sh(-1, 0) + sh(1, 0)
        v2 = sh(-2, 0) + sh(2, 0)
        d1 = sh(-1, 1) + sh(-1, -1) + sh(1, 1) + sh(1, -1)
        k1 = (4.0 * mid + 2.0 * (h1 + v1) - (h2 + v2)) * 0.125
        k2 = (5.0 * mid + 4.0 * h1 - d1 - h2 + 0.5 * v2) * 0.125
        k3 = (5.0 * mid + 4.0 * v1 - d1 - v2 + 0.5 * h2) * 0.125
        k4 = (6.0 * mid + 2.0 * d1 - 1.5 * (h2 + v2)) * 0.125
        # Channel of the horizontally adjacent site: tells the G phases apart.
        hcm = site_map(torch.tensor([cfa[1], cfa[0], cfa[3], cfa[2]], device=dev), h, w)
        gg = torch.where(chan == 1, mid, k1)
        rr = torch.where(chan == 0, mid,
                         torch.where(chan == 1, torch.where(hcm == 0, k2, k3), k4))
        bb = torch.where(chan == 2, mid,
                         torch.where(chan == 1, torch.where(hcm == 2, k2, k3), k4))
        rgb = [t.clamp(0.0, 1.0) for t in (rr, gg, bb)]
    else:
        inv = _bilinear_inv(h, w, cfa, dev)
        rgb = []
        for c in range(3):
            sh = shifts(torch.where(chan == c, x, 0.0), 1)
            if c == 1:  # cross: 4 * mid + up + down + right + left
                num = 4.0 * sh(0, 0) + sh(-1, 0) + sh(1, 0) + sh(0, 1) + sh(0, -1)
            else:  # [1, 2, 1]^T x [1, 2, 1], separable: rows, then columns
                v = {dx: sh(-1, dx) + 2.0 * sh(0, dx) + sh(1, dx) for dx in (-1, 0, 1)}
                num = 2.0 * v[0] + v[1] + v[-1]
            rgb.append((num * inv[c] * g[c]).clamp(0.0, 1.0))

    lin = [(m[3 * r] * rgb[0] + m[3 * r + 1] * rgb[1] + m[3 * r + 2] * rgb[2]).clamp(0.0, 1.0)
           for r in range(3)]
    return torch.stack(lin).reshape(3, *raw.shape)


def zero_fill_exact(params) -> bool:
    """Whether raw 0 normalizes to 0 on every site of the parameter row:
    every black >= 0 and every white - black, in float32 as the kernel's
    entry subtracts, finite and at least float32's least normal number, so
    that 1 / (white - black) is finite and > 0. Then clip((0 - black) *
    1/(white - black), 0, 1) is 0, and a box that the hardware fills with
    raw 0 outside the frame stages the 0 that the direct path stages there
    (Malvar multiplies both by the same gain)."""
    return _zero_fill_exact(_params_row(params)[:5].tobytes())


@functools.lru_cache(maxsize=64)
def _zero_fill_exact(black_white: bytes) -> bool:
    p = np.frombuffer(black_white, np.float32)
    black, diff = p[:4], p[4] - p[:4]
    return bool(((black >= 0) & (diff >= np.finfo(np.float32).tiny) & (diff < np.inf)).all())


def ring_fits(address: int, width: int) -> bool:
    """Whether a contiguous uint16 tensor at device `address`, `width`
    values wide, can be read through a tensor map: its rows a multiple of
    16 bytes and its base 16-byte aligned. A per-frame launch then takes
    the ring (its kernel stages a frame whose raw 0 does not normalize to 0
    with bounds tests at the border)."""
    return width % 8 == 0 and address % 16 == 0


def ring_takes(address: int, width: int, params) -> bool:
    """Whether a one-row launch of such a tensor develops on the ring path:
    :func:`ring_fits` and :func:`zero_fill_exact`. Anything else takes the
    direct path."""
    return ring_fits(address, width) and zero_fill_exact(params)


def ring_map_geometry(frames: int, height: int, width: int) -> dict:
    """The ring's tensor map of a contiguous (frames, height, width) uint16
    tensor, as ``csrc/develop.cu::mcraw_develop_map`` takes it: "dims" and
    "box" innermost first, "strides" the bytes of a row and of a frame;
    also "box_bytes", what each copy brings, and "elements", what the map
    spans."""
    return {
        "dims": (width, height, frames),
        "strides": (2 * width, 2 * width * height),
        "box": RING_BOX,
        "box_bytes": 2 * int(np.prod(RING_BOX)),
        "elements": frames * height * width,
    }


def encode_tensor_map(lib, address: int, frames: int, height: int, width: int) -> np.ndarray:
    """The tensor map (128 bytes) of :func:`ring_map_geometry` over device
    `address`, encoded by the kernel library `lib` (``build.load``'s)."""
    g = ring_map_geometry(frames, height, width)
    dims, strides = (np.asarray(g[k], np.int64) for k in ("dims", "strides"))
    box = np.asarray(g["box"], np.int32)
    tmap = np.zeros(16, np.uint64)
    err = lib.mcraw_develop_map(tmap.ctypes.data, address, dims.ctypes.data,
                                strides.ctypes.data, box.ctypes.data)
    if err != 0:
        raise RuntimeError(f"mcraw_develop_map: cuTensorMapEncodeTiled failed "
                           f"(CUresult {err}) for {g}")
    return tmap


def _tensor_map(address: int, frames: int, height: int, width: int) -> np.ndarray:
    """:func:`encode_tensor_map` by this process's library, kept by address
    and shape: the caching allocator hands a loop the same planes step
    after step."""
    key = (address, frames, height, width)
    tmap = _MAPS.get(key)
    if tmap is None:
        tmap = encode_tensor_map(build.lib(), address, frames, height, width)
        if len(_MAPS) >= RING_MAPS_KEPT:
            _MAPS.clear()
        _MAPS[key] = tmap
    return tmap


def per_frame(cfa) -> bool:
    """Whether `cfa` gives a CFA for each frame: an (F, 4) array or
    tensor, not one 4-sequence."""
    return (cfa.dim() if isinstance(cfa, torch.Tensor) else np.ndim(cfa)) == 2


def _frame_blocks(raw: torch.Tensor, rows, cfas) -> tuple[torch.Tensor, torch.Tensor]:
    """(F, N >= 17) float32 rows and (F, 4) int32 CFAs on raw's device,
    each of unit stride along a row, F the frames of raw. A block given on
    the host is checked (every CFA a Bayer pattern) and copied to the
    device; one already there is taken as it is."""
    frames = raw.shape[0] if raw.dim() == 3 else 1
    blocks = []
    for block, dtype, width in ((rows, torch.float32, N_PARAMS), (cfas, torch.int32, 4)):
        t = block if isinstance(block, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(block, dtype=np.float32 if dtype == torch.float32 else np.int32))
        if t.dim() != 2 or t.shape[0] != frames or t.shape[1] < width:
            raise ValueError(f"a per-frame develop of {frames} frame(s) takes ({frames}, >= "
                             f"{width}) rows and CFAs, got {tuple(t.shape)}")
        if t.device.type != raw.device.type:
            if dtype == torch.int32:
                bad = [tuple(c) for c in t[:, :4].tolist() if tuple(c) not in BAYER_CFAS]
                if bad:
                    raise ValueError(f"cfa must be one of the Bayer patterns {BAYER_CFAS}, "
                                     f"got {bad[0]}")
            t = t.to(raw.device)
        if t.dtype != dtype or t.stride(1) != 1 or (frames > 1 and t.stride(0) < width):
            t = t.to(dtype).contiguous()
        blocks.append(t)
    return blocks[0], blocks[1]


def _develop_frames_plain(raw: torch.Tensor, rows, cfas, demosaic: str) -> torch.Tensor:
    """The per-frame develop on the CPU: each frame through
    :func:`develop_rgba_plain` with its own row and CFA."""
    _check(raw, BAYER_CFAS[0], demosaic)
    frames = raw if raw.dim() == 3 else raw[None]
    rows, cfas = _frame_blocks(frames, rows, cfas)
    rows, cfas = rows.numpy(), cfas.numpy()
    out = [develop_rgba_plain(f, rows[i], cfa=tuple(int(c) for c in cfas[i][:4]),
                              demosaic=demosaic)
           for i, f in enumerate(frames)]
    stacked = torch.stack(out) if out else torch.empty(frames.shape, dtype=torch.uint32)
    return stacked.reshape(raw.shape)


@observe.spanned("develop")
def develop_rgba_device(
    raw: torch.Tensor, params, *, cfa, demosaic: str = "bilinear"
) -> torch.Tensor:
    """Develop (H, W) or (B, H, W) uint16 Bayer to uint32 RGBA8888.

    params, cfa: the host (1, 128) float32 row of
    :func:`pack_develop_params` and one of :data:`BAYER_CFAS`, for every
    frame; or, per frame, (B, >= 17) rows and (B, 4) int32 CFAs, tensors
    or arrays: on the host they are checked and copied to raw's device, on
    it they are read as they are (a CFA there that is not a Bayer pattern
    leaves its frame undeveloped).
    demosaic: "bilinear" or "malvar". CUDA tensors launch the kernel on
    the current stream (one row goes in by value, no copy to the device);
    CPU tensors take :func:`develop_rgba_plain`, frame by frame for
    per-frame rows; any other device raises."""
    global KERNEL_LAUNCHES
    each = per_frame(cfa)
    if raw.device.type == "cpu":
        if each:
            out = _develop_frames_plain(raw, params, cfa, demosaic)
            observe.count("develop.frame_rows", out.shape[0] if out.dim() == 3 else 1)
            return out
        return develop_rgba_plain(raw, params, cfa=cfa, demosaic=demosaic)
    if raw.device.type != "cuda":
        raise ValueError(f"no develop kernel for device {raw.device}")
    _check(raw, BAYER_CFAS[0] if each else cfa, demosaic)
    raw = raw.contiguous()
    quantizer = _quantizer_on(raw.device)
    frames, h, w = (raw.shape if raw.dim() == 3 else (1, *raw.shape))
    out = torch.empty(raw.shape, dtype=torch.uint32, device=raw.device)
    if out.numel() == 0:
        return out
    malvar = DEMOSAICS.index(demosaic)
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        if each:
            prm, cfas = _frame_blocks(raw, params, cfa)
            ring = ring_fits(raw.data_ptr(), w)
            args = (raw.data_ptr(), out.data_ptr(), frames, h, w,
                    prm.data_ptr(), prm.stride(0), cfas.data_ptr(), cfas.stride(0),
                    quantizer.data_ptr(), malvar)
            buffers = (raw, out, quantizer, None, None, None, None)
            if ring:
                tmap = _tensor_map(raw.data_ptr(), frames, h, w)
                build.launch("mcraw_develop_rows_ring", (*buffers, tmap, None, prm, cfas),
                             *args, tmap.ctypes.data, stream)
            else:
                build.launch("mcraw_develop_rows", (*buffers, None, None, prm, cfas), *args,
                             stream)
        else:
            prm = _params_row(params)
            cfa32 = np.asarray(cfa, dtype=np.int32)
            ring = ring_takes(raw.data_ptr(), w, prm)
            args = (raw.data_ptr(), out.data_ptr(), frames, h, w, prm.ctypes.data,
                    cfa32.ctypes.data, quantizer.data_ptr(), malvar)
            if ring:
                tmap = _tensor_map(raw.data_ptr(), frames, h, w)
                build.launch("mcraw_develop_ring",
                             (raw, out, quantizer, prm, cfa32, None, None, tmap),
                             *args, tmap.ctypes.data, stream)
            else:
                build.launch("mcraw_develop", (raw, out, quantizer, prm, cfa32), *args, stream)
    with build.COUNTER_LOCK:
        KERNEL_LAUNCHES += 1
    observe.count("develop.ring" if ring else "develop.direct", 1)
    if each:
        observe.count("develop.frame_rows", frames)
    return out
