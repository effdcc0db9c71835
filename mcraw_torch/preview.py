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

Frames of one geometry develop in one launch, each with its own clip's
and its own frame's metadata: :func:`frame_develop_rows` makes the
frames' parameter rows and CFAs (their white points solved in one batch)
and :func:`develop_frames_rgba` develops the frames with them.
:func:`preview_clip` plays one clip so, a batch a launch;
:func:`preview_clips` plays several clips in sync, a tick a launch, with
the rows of every frame made when it starts.

The NumPy part of this module is a copy of the JAX package's f64 model
(:func:`develop_f64`) and its constants, made with the same operations in
the same order: ``mcraw.preview`` imports JAX, and the model is the ground
truth wherever there is no JAX (``chip_smoke.py`` on the card). A CPU test
holds the copy equal to the original.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import observe
from .color import interpolated_forward_batch, interpolated_matrices
from .kernels.develop import (
    develop_rgba_device,
    pack_develop_params,
    pack_rgba,
    site_map,
    srgb_code_f64,
)
from .metadata import ContainerMetadata, FrameMetadata
from .parallel import SHARE_GEOMETRY

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


# -- a row for each frame ------------------------------------------------------

ROW_WORDS = 128  # pack_develop_params's row


class FrameRows(NamedTuple):
    """Frames' develop parameters on a device: (F, 128) float32 rows of
    :func:`~mcraw_torch.kernels.develop.pack_develop_params` and (F, 4)
    int32 CFAs, a frame each."""

    rows: torch.Tensor
    cfas: torch.Tensor

    def frames(self, lo: int, hi: int) -> "FrameRows":
        """Frames [lo, hi): views of these, no copy."""
        return FrameRows(self.rows[lo:hi], self.cfas[lo:hi])


class _Clip(NamedTuple):
    """What a clip's container metadata gives each of its frames' rows."""

    black: np.ndarray
    white: np.float32
    cfa: np.ndarray  # (4,) int32
    matrices: tuple | None  # (cm1, cm2, fm1, fm2) float64; None: fm1 alone
    fm1: np.ndarray


def _clip(meta) -> _Clip:
    """The parsed container metadata `meta` (a ContainerMetadata or its JSON)."""
    cm = meta if isinstance(meta, ContainerMetadata) else ContainerMetadata(meta)
    fm1 = np.asarray(cm.forward_matrix(1), np.float64).reshape(3, 3)
    matrices = None if _single_illuminant(cm) else tuple(
        np.asarray(m, np.float64).reshape(3, 3)
        for m in (cm.color_matrix(1), cm.color_matrix(2), fm1, cm.forward_matrix(2)))
    return _Clip(np.asarray(cm.black_level), np.float32(cm.white_level),
                 np.frombuffer(cm.cfa_pattern, np.uint8).astype(np.int32), matrices, fm1)


def _single_illuminant(cm: ContainerMetadata) -> bool:
    """Whether the container lacks the second matrix set, so that
    :func:`interpolated_matrices` takes forwardMatrix1 alone."""
    raw = cm.raw
    return not (isinstance(raw, dict) and "colorMatrix1" in raw and "colorMatrix2" in raw
                and "forwardMatrix2" in raw)


def frame_develop_rows(container_metas, frame_metas, device="cpu") -> FrameRows:
    """The develop parameters of F frames, each from its own clip's container
    metadata and its own frame metadata (ContainerMetadata / FrameMetadata
    or their JSON), on `device`: row f is :func:`pack_develop_params` of the
    clip's black and white levels, the frame's as-shot neutral and the
    forward matrix interpolated at it (:func:`interpolated_matrices`), bit
    for bit, and CFA f the clip's ``sensorArrangment``.

    Every white point is solved in one batch
    (:func:`~mcraw_torch.color.interpolated_forward_batch`), whose cost is
    mostly its iterations, not its frames: so a player makes the rows of
    all it opens at once (a clip, the clips of a multicam shot) and takes
    a step's with :meth:`FrameRows.frames`. The span
    ``develop.frame_params`` times the call; the counter
    ``color.white_solves`` counts the white points solved. On a card the
    rows and CFAs go in one copy from pinned memory, queued on the current
    stream."""
    with observe.span("develop.frame_params"):
        container_metas = list(container_metas)  # held, so that no id is reused
        parsed: dict[int, _Clip] = {}  # by the argument: a shot repeats its clips'
        clips = []
        for c in container_metas:
            if id(c) not in parsed:
                parsed[id(c)] = _clip(c)
            clips.append(parsed[id(c)])
        neutrals = [np.asarray((f if isinstance(f, FrameMetadata) else FrameMetadata(f))
                               .as_shot_neutral) for f in frame_metas]
        if len(clips) != len(neutrals):
            raise ValueError(f"{len(clips)} container metadata for {len(neutrals)} frames")
        solve = [i for i, c in enumerate(clips) if c.matrices is not None]
        fwd = {}
        if solve:
            mats = [np.stack([clips[i].matrices[j] for i in solve]) for j in range(4)]
            fwd = dict(zip(solve, interpolated_forward_batch(
                np.stack([neutrals[i] for i in solve]), *mats)))
            observe.count("color.white_solves", len(solve))
        device = torch.device(device)
        host = torch.empty((len(clips), ROW_WORDS + 4), dtype=torch.int32,
                           pin_memory=device.type == "cuda")
        words = host.numpy()
        for i, c in enumerate(clips):
            f = fwd[i] if i in fwd else c.fm1
            words[i, :ROW_WORDS] = pack_develop_params(
                c.black, np.asarray(c.white), neutrals[i], f.astype(np.float32))[0].view(np.int32)
            words[i, ROW_WORDS:] = c.cfa
        if device.type != "cpu":
            host = host.to(device, non_blocking=True)
        return FrameRows(host[:, :ROW_WORDS].view(torch.float32), host[:, ROW_WORDS:])


def develop_frames_rgba(planes: torch.Tensor, rows, cfas,
                        demosaic: str = "bilinear") -> torch.Tensor:
    """(F, H, W) uint16 Bayer planes -> (F, H, W) uint32 RGBA8888 in one
    launch of the develop kernel (its plain version on the CPU), frame f
    with row f and CFA f (:func:`frame_develop_rows`'s): bit for bit each
    frame developed alone with its own row and CFA."""
    return develop_rgba_device(planes, rows, cfa=cfas, demosaic=demosaic)


def _batch_rgba(imgs: torch.Tensor, metas: list, cms: list, demosaic: str,
                rows: FrameRows | None = None) -> torch.Tensor:
    """A decoded batch (F, H, W), frame f of container metadata cms[f] and
    frame JSON metas[f], developed to (F, H, W) RGBA: one per-frame launch
    where the kernel takes the geometry (with `rows`, the frames' made
    already, else made here), else frame by frame."""
    if _fused_eligible(imgs.shape[-2], imgs.shape[-1]):
        if rows is None:
            rows = frame_develop_rows(cms, metas, imgs.device)
        return develop_frames_rgba(imgs, rows.rows, rows.cfas, demosaic=demosaic)
    return torch.stack([_frame_rgba(img, FrameMetadata(m), cm, tuple(cm.cfa_pattern),
                                    demosaic=demosaic)
                        for img, m, cm in zip(imgs, metas, cms)])


def preview_clip(decoder, timestamps=None, batch_frames: int = 8,
                 demosaic: str = "bilinear"):
    """Playback: yields (timestamp, (H, W) uint32 RGBA8888 on the device)
    for each frame in order, decoding in batched launches of up to
    `batch_frames` frames (``decoder.decode_batch_iter``) and developing
    each batch in one launch, each frame with its own parameters
    (:func:`frame_develop_rows` of the batch)."""
    if timestamps is None:
        timestamps = decoder.frames
    cm = ContainerMetadata(decoder.container_metadata)
    i = 0
    for imgs, metas in decoder.decode_batch_iter(timestamps, chunk_frames=batch_frames):
        for rgba in _batch_rgba(imgs, metas, [cm] * len(metas), demosaic):
            yield timestamps[i], rgba
            i += 1


def preview_clips(decoders, timestamps=None, demosaic: str = "bilinear"):
    """Multiview playback of several clips of one codec and raster in sync:
    yields ([each clip's timestamp], (C, H, W) uint32 RGBA8888 on the first
    decoder's device) a tick, the tick's frame of every clip decoded in one
    batch (clip-major within the tick, as ``parallel.decode_clips``
    interleaves them) and developed in one launch, each frame with its own
    clip's and frame's metadata. The rows of every frame played are made
    here, at the call, in one :func:`frame_develop_rows` of each frame's
    metadata (read without its payload); a tick takes its slice.
    `timestamps`: a list of each clip's, or None for every frame of each.
    Unequal frame counts, mixed codecs and mixed rasters raise ValueError,
    as ``decode_clips`` does."""
    if timestamps is None:
        timestamps = [d.frames for d in decoders]
    if len(timestamps) != len(decoders):
        raise ValueError(f"{len(timestamps)} timestamp lists for {len(decoders)} clips")
    if len({len(ts) for ts in timestamps}) != 1:
        raise ValueError("clips must contribute equal frame counts")
    cms = [ContainerMetadata(d.container_metadata) for d in decoders]
    ticks = list(zip(*timestamps))
    rows = frame_develop_rows(cms * len(ticks),
                              [d._reader.frame_payload(t)[1] for tick in ticks
                               for d, t in zip(decoders, tick)],
                              decoders[0].device if decoders else "cpu")
    return _play_ticks(decoders, ticks, cms, rows, demosaic)


def _play_ticks(decoders, ticks, cms, rows: FrameRows, demosaic: str):
    from .pipeline import _uncompress_error_text

    c = len(decoders)
    for t, tick in enumerate(ticks):
        frames = [d._checked_frame(ts) for d, ts in zip(decoders, tick)]
        if len({modern for *_, modern in frames}) != 1:
            raise ValueError("mixed codecs across clips")
        if len({(fm.width, fm.height) for _, _, fm, _ in frames}) != 1:
            raise ValueError(SHARE_GEOMETRY)
        _, _, fm, modern = frames[0]
        with _uncompress_error_text(modern):
            imgs = decoders[0]._decode_payloads([p for p, *_ in frames], fm, modern, None)
        yield list(tick), _batch_rgba(imgs, [meta for _, meta, *_ in frames], cms, demosaic,
                                      rows.frames(t * c, (t + 1) * c))
