"""Preview on PyTorch: packed payload -> display-ready RGB on the device.

The port of :mod:`mcraw.preview`. A frame decodes through
:class:`mcraw_torch.Decoder` and develops (black/white normalize, white
balance, demosaic, camera -> XYZ(D50) -> sRGB, sRGB curve, quantize) to
(H, W) uint32 RGBA8888 (R | G<<8 | B<<16 | 0xFF<<24) on the decoder's
device:

- frames of height >= 3 go through :func:`develop_rgba`, i.e. the
  hand-written CUDA develop kernel (``csrc/develop.cu``) for a CUDA tensor
  and its plain torch version for a CPU tensor, in bilinear or
  Malvar-He-Cutler demosaic;
- frames of height <= 2 go through :func:`develop`, the counterpart of the
  JAX package's XLA pipeline (plain torch there too; bilinear only), as in
  ``mcraw.preview._fused_eligible``.

The forward matrix is interpolated between the container's two
illuminants at the as-shot white point (:mod:`mcraw_torch.color`, the
port's copy of ``mcraw.color``).

The NumPy part of this module is a copy of the JAX package's f64 model
(:func:`develop_f64`) and its constants, made with the same operations in
the same order: ``mcraw.preview`` imports JAX, and the model is the ground
truth wherever there is no JAX (``chip_smoke.py`` on the card). A CPU test
holds the copy equal to the original.
"""

from __future__ import annotations

import numpy as np
import torch

from . import observe
from .color import interpolated_matrices
from .kernels.develop import (
    develop_rgba_device,
    pack_develop_params,
    pack_rgba,
    site_map,
    srgb_code_f64,
)
from .metadata import ContainerMetadata, FrameMetadata

# XYZ (D50) -> linear sRGB (D65), Bradford-adapted.
_XYZ_D50_TO_SRGB = np.array(
    [
        [3.1338561, -1.6168667, -0.4906146],
        [-0.9787684, 1.9161415, 0.0334540],
        [0.0719453, -0.2289914, 1.4052427],
    ],
    dtype=np.float32,
)

_K_CROSS = np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]], dtype=np.float32)
_K_FULL = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.float32)

# Calls of :func:`develop`, the height <= 2 path (no kernel there).
DEVELOP_CALLS = 0


# -- the f64 model (NumPy only) --------------------------------------------


def _phase_masks(height: int, width: int, cfa: tuple[int, ...]):
    """(3, H, W) one-hot masks for R/G/B sites of a 2x2 CFA."""
    yy = np.arange(height)[:, None] % 2
    xx = np.arange(width)[None, :] % 2
    chan = np.empty((height, width), dtype=np.int32)
    for py in range(2):
        for px in range(2):
            chan[(yy == py) & (xx == px)] = cfa[2 * py + px]
    return np.stack([(chan == c).astype(np.float32) for c in range(3)])


def _np_conv2same(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    h, w = x.shape
    p = np.pad(x, 1)
    acc = np.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            if k[dy, dx]:
                acc += k[dy, dx] * p[dy : dy + h, dx : dx + w]
    return acc


def _malvar_f64(x: np.ndarray, chan: np.ndarray, hc: np.ndarray):
    """Malvar-He-Cutler 5x5 gradient-corrected demosaic on a
    white-balanced mosaic (float64, zero-padded taps, per-pixel
    site-class select). Returns (R, G, B) planes (unclipped).

    x: normalized+WB mosaic; chan: per-site channel (0/1/2); hc: channel
    of the HORIZONTALLY adjacent site (disambiguates the two G phases).
    """
    h, w = x.shape
    p = np.pad(x, 2)

    def sh(dy, dx):
        return p[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w]

    h1 = sh(0, 1) + sh(0, -1)
    v1 = sh(1, 0) + sh(-1, 0)
    h2 = sh(0, 2) + sh(0, -2)
    v2 = sh(2, 0) + sh(-2, 0)
    d1 = sh(1, 1) + sh(1, -1) + sh(-1, 1) + sh(-1, -1)
    # The four MHC estimators (x 1/8): G at a chroma site; chroma with
    # its same-color neighbors in-ROW; in-COLUMN; and diagonal.
    k1 = (4.0 * x + 2.0 * (h1 + v1) - (h2 + v2)) * 0.125
    k2 = (5.0 * x + 4.0 * h1 - d1 - h2 + 0.5 * v2) * 0.125
    k3 = (5.0 * x + 4.0 * v1 - d1 - v2 + 0.5 * h2) * 0.125
    k4 = (6.0 * x + 2.0 * d1 - 1.5 * (h2 + v2)) * 0.125

    g = np.where(chan == 1, x, k1)
    r = np.where(
        chan == 0, x,
        np.where(chan == 1, np.where(hc == 0, k2, k3), k4),
    )
    b = np.where(
        chan == 2, x,
        np.where(chan == 1, np.where(hc == 2, k2, k3), k4),
    )
    return r, g, b


def develop_f64(raw, black, white, neutral, fwd, cfa,
                demosaic: str = "bilinear") -> np.ndarray:
    """Scalar float64 model of the exact preview pipeline (normalize ->
    WB folded into the demosaic normalizer -> mask-normalized bilinear
    demosaic -> fwd matrix -> XYZ(D50)->sRGB -> gamma -> quantize).
    Returns (H, W, 3) int64 u8 channel values.

    demosaic="malvar": the Malvar-He-Cutler 5x5 gradient-corrected
    kernels instead of bilinear, with WB applied before the demosaic and
    border taps zero-padded.

    The ground truth the develop kernel and its plain version are held to
    (<= 1 LSB per channel)."""
    h, w = raw.shape
    yy = np.arange(h)[:, None] % 2
    xx = np.arange(w)[None, :] % 2
    b = np.asarray(black, np.float64)
    bl = np.where(yy == 0, np.where(xx == 0, b[0], b[1]),
                  np.where(xx == 0, b[2], b[3]))
    x = np.clip((raw.astype(np.float64) - bl) / (float(white) - bl), 0, 1)
    gains = 1.0 / np.asarray(neutral, np.float64)
    if demosaic == "malvar":
        cfa = tuple(cfa)
        pos = yy * 2 + xx
        chan = np.choose(pos, cfa)
        hc = np.choose(pos ^ 1, cfa)
        xm = x * gains[chan]
        r, g, gb = _malvar_f64(xm, chan, hc)
        rgb = np.clip(np.stack([r, g, gb], -1), 0, 1)
    else:
        masks = _phase_masks(h, w, tuple(cfa)).astype(np.float64)
        chans = []
        for c, k in ((0, _K_FULL), (1, _K_CROSS), (2, _K_FULL)):
            k = k.astype(np.float64)
            num = _np_conv2same(x * masks[c], k)
            den = _np_conv2same(masks[c], k)
            chans.append(num / den * gains[c])
        rgb = np.clip(np.stack(chans, -1), 0, 1)
    m = _XYZ_D50_TO_SRGB.astype(np.float64) @ np.asarray(fwd, np.float64)
    return srgb_code_f64(rgb @ m.T)


def _inv_dens(height: int, width: int, cfa: tuple[int, ...]) -> np.ndarray:
    """(3, H, W) float32 1/conv(mask): the bilinear normalizer table of
    :func:`develop`. Built per call: the port needs it only at height <= 2."""
    masks = _phase_masks(height, width, cfa)
    return np.stack(
        [
            1.0 / _np_conv2same(masks[ch], k)
            for ch, k in ((0, _K_FULL), (1, _K_CROSS), (2, _K_FULL))
        ]
    ).astype(np.float32)


# -- torch -------------------------------------------------------------------


def _conv2same(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Single-channel 3x3 'same' convolution as shifted adds, in the tap
    order of ``mcraw.preview._conv2same`` (no conv2d, so no TF32)."""
    h, w = x.shape
    p = torch.nn.functional.pad(x, (1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            wgt = float(k[dy, dx])
            if wgt == 0.0:
                continue
            t = p[dy : dy + h, dx : dx + w]
            t = t * wgt if wgt != 1.0 else t
            acc = t if acc is None else acc + t
    return acc


def bilinear_demosaic(raw: torch.Tensor, masks, inv_dens: torch.Tensor,
                      gains=None) -> torch.Tensor:
    """Mask-normalized bilinear demosaic on raw's device, the counterpart
    of ``mcraw.preview.bilinear_demosaic``. raw: (H, W) float32; masks:
    3-list of (H, W) float32; inv_dens: (3, H, W) 1/conv(mask) (borders
    included); gains: optional (3,) per-channel scale folded into the
    normalizer as ``inv_dens[c] * gains[c]``. Returns (H, W, 3)."""
    if gains is not None:
        gains = torch.as_tensor(gains, dtype=torch.float32, device=raw.device)
    out = []
    for c, k in ((0, _K_FULL), (1, _K_CROSS), (2, _K_FULL)):
        num = _conv2same(raw * masks[c], k)
        inv = inv_dens[c] if gains is None else inv_dens[c] * gains[c]
        out.append(num * inv)
    return torch.stack(out, dim=-1)


def develop(raw_u16: torch.Tensor, black_level, white_level, as_shot_neutral,
            forward_matrix, *, cfa: tuple[int, ...]) -> torch.Tensor:
    """(H, W) uint16 Bayer -> (H, W, 3) uint8 sRGB preview, bilinear, on
    raw's device: the counterpart of ``mcraw.preview.develop`` (plain torch
    there as in the JAX package, which runs it as XLA, not as a kernel).

    The demosaic is :func:`bilinear_demosaic` with the 1/conv(mask) table
    (:func:`_inv_dens`); white balance multiplies into it. The preview takes this path only at
    height <= 2, where the develop kernel is not used."""
    global DEVELOP_CALLS
    DEVELOP_CALLS += 1
    h, w = raw_u16.shape
    dev = raw_u16.device
    f32 = np.float32
    chan = site_map(torch.tensor(tuple(cfa), device=dev), h, w)
    b = np.asarray(black_level, f32)
    bl = site_map(torch.tensor(b, device=dev), h, w)
    inv_scale = site_map(torch.tensor(f32(1.0) / (f32(white_level) - b), device=dev), h, w)
    x = ((raw_u16.to(torch.float32) - bl) * inv_scale).clamp(0.0, 1.0)

    gains = torch.from_numpy(f32(1.0) / np.asarray(as_shot_neutral, f32)).to(dev)
    inv_dens = torch.from_numpy(_inv_dens(h, w, tuple(cfa))).to(dev)
    masks = [(chan == c).to(torch.float32) for c in range(3)]
    rgb = bilinear_demosaic(x, masks, inv_dens, gains).clamp(0.0, 1.0).unbind(-1)

    m = _XYZ_D50_TO_SRGB @ np.asarray(forward_matrix, f32)
    out = []
    for r in range(3):
        lin = (float(m[r, 0]) * rgb[0] + float(m[r, 1]) * rgb[1]
               + float(m[r, 2]) * rgb[2]).clamp(0.0, 1.0)
        srgb = torch.where(
            lin <= 0.0031308, 12.92 * lin,
            1.055 * torch.pow(lin, 1.0 / 2.4) - 0.055,
        )
        out.append(torch.round(srgb.clamp(0.0, 1.0) * 255.0).to(torch.uint8))
    return torch.stack(out, dim=-1)


def develop_rgba(raw_u16: torch.Tensor, black_level, white_level,
                 as_shot_neutral, forward_matrix, *, cfa: tuple,
                 demosaic: str = "bilinear") -> torch.Tensor:
    """(H, W) or (B, H, W) uint16 Bayer -> uint32 RGBA8888 of the same
    leading shape, through the develop kernel (plain version on the CPU).
    Within 1 LSB per channel of :func:`develop_f64`, in either demosaic
    mode ("bilinear" or "malvar")."""
    with observe.span("develop.params"):
        params = pack_develop_params(
            np.asarray(black_level), np.asarray(white_level),
            np.asarray(as_shot_neutral), np.asarray(forward_matrix),
        )
    return develop_rgba_device(raw_u16, params, cfa=tuple(cfa), demosaic=demosaic)


def _fused_eligible(height: int, width: int) -> bool:
    """The develop kernel takes any width; only heights <= 2 take
    :func:`develop` (``mcraw.preview._fused_eligible``)."""
    return height > 2


def _frame_rgba(img: torch.Tensor, fm: FrameMetadata, cm: ContainerMetadata,
                cfa: tuple, demosaic: str = "bilinear") -> torch.Tensor:
    """Develop one decoded frame to (H, W) uint32 RGBA8888: the kernel
    where eligible, else :func:`develop` packed to RGBA. Malvar needs the
    kernel, so it raises at height <= 2, with the JAX package's text."""
    fwd, _, _ = interpolated_matrices(cm, fm.as_shot_neutral)
    args = (cm.black_level, np.float32(cm.white_level), fm.as_shot_neutral,
            fwd.astype(np.float32))
    if _fused_eligible(fm.height, fm.width):
        return develop_rgba(img, *args, cfa=cfa, demosaic=demosaic)
    if demosaic != "bilinear":
        raise ValueError(
            f"demosaic={demosaic!r} needs the fused kernel, which this "
            f"geometry ({fm.height}x{fm.width}) cannot use"
        )
    rgb = develop(img, *args, cfa=cfa)
    return pack_rgba(rgb[..., 0], rgb[..., 1], rgb[..., 2])


def rgba_to_rgb(rgba: torch.Tensor) -> torch.Tensor:
    """(..., W) uint32 RGBA8888 -> (..., W, 3) uint8, a view of its bytes
    (the card is little-endian; torch has no shifts on uint32)."""
    return rgba.view(torch.uint8).reshape(*rgba.shape, 4)[..., :3]


def preview_frame_rgba(decoder, timestamp: int,
                       demosaic: str = "bilinear") -> torch.Tensor:
    """Decode + develop one frame on the decoder's device: (H, W) uint32
    RGBA8888."""
    img, meta = decoder.load_frame_device(timestamp)
    cm = ContainerMetadata(decoder.container_metadata)
    return _frame_rgba(img, FrameMetadata(meta), cm, tuple(cm.cfa_pattern),
                       demosaic=demosaic)


def preview_frame(decoder, timestamp: int,
                  demosaic: str = "bilinear") -> torch.Tensor:
    """Decode + develop one frame on the decoder's device: (H, W, 3) uint8.
    Prefer :func:`preview_frame_rgba` for playback."""
    return rgba_to_rgb(preview_frame_rgba(decoder, timestamp, demosaic=demosaic))


def preview_clip(decoder, timestamps=None, batch_frames: int = 8,
                 demosaic: str = "bilinear"):
    """Playback: yields (timestamp, (H, W) uint32 RGBA8888 on the device)
    for each frame in order, decoding in batched launches of up to
    `batch_frames` frames (``decoder.decode_batch_iter``) and developing
    each frame of a batch with its own parameters."""
    if timestamps is None:
        timestamps = decoder.frames
    cm = ContainerMetadata(decoder.container_metadata)
    cfa = tuple(cm.cfa_pattern)
    i = 0
    for imgs, metas in decoder.decode_batch_iter(timestamps, chunk_frames=batch_frames):
        for img, meta in zip(imgs, metas):
            yield timestamps[i], _frame_rgba(img, FrameMetadata(meta), cm, cfa,
                                             demosaic=demosaic)
            i += 1
