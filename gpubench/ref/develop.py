"""The develop's model in float64, frozen for the benchmark's reference.

Bayer uint16 -> 8-bit sRGB codes, as the preview pipeline states it:
normalize each CFA site by its black level and the white level, clip to
[0, 1]; demosaic, bilinear (mask-normalized 3x3, white balance after it)
or Malvar-He-Cutler (5x5 gradient-corrected, white balance before it),
taps outside the frame zero; clip; the forward matrix then XYZ(D50) ->
linear sRGB; the sRGB curve; ``round(255 x)``, half to even. The same
operations in the same order as the JAX package's ``preview.develop_f64``,
written in plain torch so that it runs on the card after a run's window.
It imports nothing of the program or of JAX.

`dtype` is the precision the model computes in: float64 for the
reference, a lower one for the control that the comparison has to refuse.
"""

from __future__ import annotations

import numpy as np
import torch

# XYZ (D50) -> linear sRGB (D65), Bradford-adapted; float32 constants as
# the pipeline states them.
XYZ_D50_TO_SRGB = np.array(
    [
        [3.1338561, -1.6168667, -0.4906146],
        [-0.9787684, 1.9161415, 0.0334540],
        [0.0719453, -0.2289914, 1.4052427],
    ],
    dtype=np.float32,
)
# The channel (0 R, 1 G, 2 B) of each 2x2 site, row-major, by mosaic.
CFA_PATTERNS = {
    "rggb": (0, 1, 1, 2),
    "bggr": (2, 1, 1, 0),
    "grbg": (1, 0, 2, 1),
    "gbrg": (1, 2, 0, 1),
}
K_CROSS = ((0, 1, 0), (1, 4, 1), (0, 1, 0))
K_FULL = ((1, 2, 1), (2, 4, 2), (1, 2, 1))


def _conv3(x: torch.Tensor, k) -> torch.Tensor:
    h, w = x.shape
    p = torch.nn.functional.pad(x, (1, 1, 1, 1))
    acc = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            if k[dy][dx]:
                acc = acc + k[dy][dx] * p[dy : dy + h, dx : dx + w]
    return acc


def _malvar(x: torch.Tensor, chan: torch.Tensor, hc: torch.Tensor):
    h, w = x.shape
    p = torch.nn.functional.pad(x, (2, 2, 2, 2))

    def sh(dy, dx):
        return p[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w]

    h1, v1 = sh(0, 1) + sh(0, -1), sh(1, 0) + sh(-1, 0)
    h2, v2 = sh(0, 2) + sh(0, -2), sh(2, 0) + sh(-2, 0)
    d1 = sh(1, 1) + sh(1, -1) + sh(-1, 1) + sh(-1, -1)
    k1 = (4.0 * x + 2.0 * (h1 + v1) - (h2 + v2)) * 0.125
    k2 = (5.0 * x + 4.0 * h1 - d1 - h2 + 0.5 * v2) * 0.125
    k3 = (5.0 * x + 4.0 * v1 - d1 - v2 + 0.5 * h2) * 0.125
    k4 = (6.0 * x + 2.0 * d1 - 1.5 * (h2 + v2)) * 0.125
    g = torch.where(chan == 1, x, k1)
    r = torch.where(chan == 0, x, torch.where(chan == 1, torch.where(hc == 0, k2, k3), k4))
    b = torch.where(chan == 2, x, torch.where(chan == 1, torch.where(hc == 2, k2, k3), k4))
    return r, g, b


def develop(raw: torch.Tensor, black, white, neutral, fwd, cfa, demosaic: str = "bilinear",
            dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(H, W, 3) int64 sRGB codes of one (H, W) integer Bayer plane.

    black: 4 levels, one per 2x2 site; white: the white level; neutral:
    the as-shot neutral (the gains are its inverse); fwd: the 3x3 forward
    matrix; cfa: the channel (0 R, 1 G, 2 B) of each 2x2 site, row-major."""
    h, w = raw.shape
    dev = raw.device

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), device=dev).to(dtype)

    yy = (torch.arange(h, device=dev) % 2)[:, None]
    xx = (torch.arange(w, device=dev) % 2)[None, :]
    pos = yy * 2 + xx  # the 2x2 site of each pixel
    b = t(black)
    bl = b[pos]
    x = ((raw.to(dtype) - bl) / (t(float(white)) - bl)).clamp(0, 1)
    gains = 1.0 / t(neutral)
    cfa_t = torch.as_tensor(tuple(cfa), device=dev)
    chan = cfa_t[pos]
    if demosaic == "malvar":
        hc = cfa_t[pos ^ 1]
        r, g, bb = _malvar(x * gains[chan], chan, hc)
        rgb = torch.stack([r, g, bb], -1).clamp(0, 1)
    elif demosaic == "bilinear":
        chans = []
        for c, k in ((0, K_FULL), (1, K_CROSS), (2, K_FULL)):
            mask = (chan == c).to(dtype)
            chans.append(_conv3(x * mask, k) / _conv3(mask, k) * gains[c])
        rgb = torch.stack(chans, -1).clamp(0, 1)
    else:
        raise ValueError(f"unknown demosaic {demosaic!r}")
    m = t(XYZ_D50_TO_SRGB.astype(np.float64) @ np.asarray(fwd, np.float64))
    lin = (rgb @ m.T).clamp(0, 1)
    v = torch.where(lin <= 0.0031308, 12.92 * lin, 1.055 * torch.pow(lin, 1 / 2.4) - 0.055)
    return torch.round(v.clamp(0, 1) * 255.0).to(torch.int64)
