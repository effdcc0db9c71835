# A copy of mcraw/color.py, kept in the port so that mcraw_torch imports nothing of
# mcraw; tests/test_torch_standalone.py holds the two equal.
"""Full dual-illuminant DNG color math (f64, host-side).

The container carries the complete DNG camera-profile matrix set —
colorMatrix1/2 (XYZ -> camera at CalibrationIlluminant1/2) and
forwardMatrix1/2 (white-balanced camera -> XYZ D50) — which the reference
example simply copies into DNG tags (example.cpp:69-72, :117-124;
CalibrationIlluminant1 = 21 = D65, 2 = 17 = Standard A). DNG *consumers*
then interpolate the two matrix pairs by the correlated color temperature
of the as-shot white point. This module implements that rendering-side
math (per the DNG 1.4 specification, chapter "Mapping Camera Color Space
to CIE XYZ Space") so the TPU preview pipeline can use the properly
interpolated forward matrix instead of forwardMatrix1 alone:

  - CIE 1960 UCS coordinates and Robertson's isotherm method for CCT
    (Robertson 1968, the method the DNG SDK uses);
  - the self-consistent white-point iteration: the interpolation weight
    depends on the white point's CCT, which depends on the interpolated
    color matrix mapping the camera neutral to XYZ — iterate to a fixed
    point (DNG SDK dng_color_spec::NeutralToXY);
  - inverse-temperature (mired) interpolation between the calibration
    illuminants, clamped outside their range.

Everything here is float64 NumPy on 3-vectors/3x3 matrices — exactness
is not an issue; this also serves as the scalar reference model for the
preview fidelity bound (tests/test_preview.py).
"""

from __future__ import annotations

import numpy as np

# Robertson (1968) isotherm data: (mired, u, v, slope). Standard published
# table (Wyszecki & Stiles, Color Science; also the DNG SDK's
# dng_temperature.cpp kTempTable).
_ROBERTSON = np.array([
    [0.0, 0.18006, 0.26352, -0.24341],
    [10.0, 0.18066, 0.26589, -0.25479],
    [20.0, 0.18133, 0.26846, -0.26876],
    [30.0, 0.18208, 0.27119, -0.28539],
    [40.0, 0.18293, 0.27407, -0.30470],
    [50.0, 0.18388, 0.27709, -0.32675],
    [60.0, 0.18494, 0.28021, -0.35156],
    [70.0, 0.18611, 0.28342, -0.37915],
    [80.0, 0.18740, 0.28668, -0.40955],
    [90.0, 0.18880, 0.28997, -0.44278],
    [100.0, 0.19032, 0.29326, -0.47888],
    [125.0, 0.19462, 0.30141, -0.58204],
    [150.0, 0.19962, 0.30921, -0.70471],
    [175.0, 0.20525, 0.31647, -0.84901],
    [200.0, 0.21142, 0.32312, -1.0182],
    [225.0, 0.21807, 0.32909, -1.2168],
    [250.0, 0.22511, 0.33439, -1.4512],
    [275.0, 0.23247, 0.33904, -1.7298],
    [300.0, 0.24010, 0.34308, -2.0637],
    [325.0, 0.24792, 0.34655, -2.4681],
    [350.0, 0.25591, 0.34951, -2.9641],
    [375.0, 0.26400, 0.35200, -3.5814],
    [400.0, 0.27218, 0.35407, -4.3633],
    [425.0, 0.28039, 0.35577, -5.3762],
    [450.0, 0.28863, 0.35714, -6.7262],
    [475.0, 0.29685, 0.35823, -8.5955],
    [500.0, 0.30505, 0.35907, -11.324],
    [525.0, 0.31320, 0.35968, -15.628],
    [550.0, 0.32129, 0.36011, -23.325],
    [575.0, 0.32931, 0.36038, -40.770],
    [600.0, 0.33724, 0.36051, -116.45],
])

# DNG SDK illuminant -> CCT mapping (dng_camera_profile): the container's
# fixed pair is CalibrationIlluminant1 = D65, 2 = Standard A
# (example.cpp:117-118).
ILLUMINANT_CCT = {17: 2850.0, 20: 5500.0, 21: 6500.0, 22: 7500.0, 23: 5000.0}
CCT_ILLUM1 = ILLUMINANT_CCT[21]  # D65
CCT_ILLUM2 = ILLUMINANT_CCT[17]  # Standard A

# D50 white point in xy (the iteration's starting guess, per the SDK).
_D50_XY = (0.3457, 0.3585)


def xy_from_xyz(xyz) -> tuple[float, float]:
    x, y, z = (float(v) for v in xyz)
    s = x + y + z
    if s <= 0.0 or not np.isfinite(s):
        return _D50_XY
    return x / s, y / s


def uv_from_xy(xy) -> tuple[float, float]:
    """CIE 1960 UCS from xy (dng_temperature's Set_xy_coord form)."""
    x, y = xy
    d = 1.5 - x + 6.0 * y
    return 2.0 * x / d, 3.0 * y / d


def cct_from_xy(xy) -> float:
    """Correlated color temperature via Robertson's isotherm method."""
    u, v = uv_from_xy(xy)
    last_dt = 0.0
    best_mired = _ROBERTSON[-1, 0]
    for i in range(1, len(_ROBERTSON)):
        ri, ui, vi, ti = _ROBERTSON[i]
        # signed distance of (u, v) from isotherm i (unit normal along
        # the isotherm direction (1, t)/sqrt(1+t^2))
        du, dv = u - ui, v - vi
        dt = (dv - du * ti) / np.sqrt(1.0 + ti * ti)
        if i == 1 and dt <= 0.0:
            return 1e6 / max(_ROBERTSON[0, 0], 1e-9) if _ROBERTSON[0, 0] else 1e38
        if dt <= 0.0 or i == len(_ROBERTSON) - 1:
            rp, up, vp, tp = _ROBERTSON[i - 1]
            dtp = ((v - vp) - (u - up) * tp) / np.sqrt(1.0 + tp * tp)
            denom = dtp - dt
            f = dtp / denom if denom != 0.0 else 0.0
            f = min(max(f, 0.0), 1.0)
            best_mired = rp + f * (ri - rp)
            break
        last_dt = dt  # noqa: F841 — kept for clarity of the walk
    return 1e6 / max(best_mired, 1e-9)


def _interp_weight(cct: float) -> float:
    """Weight of the illuminant-1 (D65) matrices, mired-interpolated
    between the two calibration CCTs and clamped (DNG 1.4 spec)."""
    lo, hi = sorted((CCT_ILLUM1, CCT_ILLUM2))
    cct = min(max(cct, lo), hi)
    # inverse-temperature interpolation
    g = (1.0 / cct - 1.0 / CCT_ILLUM2) / (1.0 / CCT_ILLUM1 - 1.0 / CCT_ILLUM2)
    return min(max(g, 0.0), 1.0)


def neutral_to_xy(neutral, cm1, cm2) -> tuple[float, float]:
    """Self-consistent white point of a camera-space neutral.

    The XYZ->camera matrix depends on the white point's CCT, which
    depends on the matrix — iterate to a fixed point (<= 30 rounds, like
    dng_color_spec::NeutralToXY). cm1/cm2 are (3,3) XYZ->camera at
    D65/StdA. Returns xy."""
    neutral = np.asarray(neutral, dtype=np.float64).reshape(3)
    cm1 = np.asarray(cm1, dtype=np.float64).reshape(3, 3)
    cm2 = np.asarray(cm2, dtype=np.float64).reshape(3, 3)
    last = _D50_XY
    for _ in range(30):
        g = _interp_weight(cct_from_xy(last))
        m = g * cm1 + (1.0 - g) * cm2
        try:
            xyz = np.linalg.solve(m, neutral)
        except np.linalg.LinAlgError:
            return last
        nxt = xy_from_xyz(xyz)
        if abs(nxt[0] - last[0]) + abs(nxt[1] - last[1]) < 1e-7:
            return nxt
        last = nxt
    return last


def interpolated_matrices(container_meta, neutral):
    """(forward_matrix, color_matrix, weight) interpolated at the as-shot
    white point — the full dual-illuminant DNG rendering math. Falls back
    to the 1-matrices when the 2-set is absent (weight 1.0)."""
    from .metadata import ContainerMetadata

    cm = (
        container_meta
        if isinstance(container_meta, ContainerMetadata)
        else ContainerMetadata(container_meta)
    )
    fm1 = np.asarray(cm.forward_matrix(1), np.float64).reshape(3, 3)
    # Single-illuminant fallback ONLY when the 2-set is genuinely ABSENT;
    # a present-but-malformed matrix must raise (MetadataError), not
    # silently degrade the preview (review r5).
    raw = cm.raw
    if not (
        isinstance(raw, dict)
        and "colorMatrix1" in raw
        and "colorMatrix2" in raw
        and "forwardMatrix2" in raw
    ):
        return fm1, np.full((3, 3), np.nan), 1.0
    cm1 = np.asarray(cm.color_matrix(1), np.float64).reshape(3, 3)
    cm2 = np.asarray(cm.color_matrix(2), np.float64).reshape(3, 3)
    fm2 = np.asarray(cm.forward_matrix(2), np.float64).reshape(3, 3)
    xy = neutral_to_xy(neutral, cm1, cm2)
    g = _interp_weight(cct_from_xy(xy))
    return g * fm1 + (1.0 - g) * fm2, g * cm1 + (1.0 - g) * cm2, g


# -- many white points at once --------------------------------------------------
#
# The functions above, element for element over arrays: the same float64
# operations in the same order, so that each element equals the scalar
# function's result bit for bit (tests/test_torch_multiview.py). A player
# develops a frame of each clip a tick, each at its own as-shot neutral.


def _cct_from_uv(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """:func:`cct_from_xy` of each (u, v): Robertson's walk, every element
    ending where its own walk ends."""
    cct = np.full(u.shape, np.nan)
    done = np.zeros(u.shape, bool)
    last = len(_ROBERTSON) - 1
    for i in range(1, len(_ROBERTSON)):
        ri, ui, vi, ti = _ROBERTSON[i]
        du, dv = u - ui, v - vi
        dt = (dv - du * ti) / np.sqrt(1.0 + ti * ti)
        if i == 1:
            first = dt <= 0.0
            cct[first] = 1e6 / max(_ROBERTSON[0, 0], 1e-9) if _ROBERTSON[0, 0] else 1e38
            done |= first
        hit = ~done & ((dt <= 0.0) | (i == last))
        if hit.any():
            rp, up, vp, tp = _ROBERTSON[i - 1]
            dtp = ((v[hit] - vp) - (u[hit] - up) * tp) / np.sqrt(1.0 + tp * tp)
            denom = dtp - dt[hit]
            f = np.zeros(denom.shape)
            nz = denom != 0.0
            f[nz] = dtp[nz] / denom[nz]
            f = np.minimum(np.maximum(f, 0.0), 1.0)
            cct[hit] = 1e6 / np.maximum(rp + f * (ri - rp), 1e-9)
            done |= hit
        if done.all():
            break
    return cct


def _interp_weights(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """:func:`_interp_weight` (:func:`cct_from_xy` (x, y)) of each white
    point."""
    d = 1.5 - x + 6.0 * y
    cct = _cct_from_uv(2.0 * x / d, 3.0 * y / d)
    lo, hi = sorted((CCT_ILLUM1, CCT_ILLUM2))
    cct = np.minimum(np.maximum(cct, lo), hi)
    g = (1.0 / cct - 1.0 / CCT_ILLUM2) / (1.0 / CCT_ILLUM1 - 1.0 / CCT_ILLUM2)
    return np.minimum(np.maximum(g, 0.0), 1.0)


def neutral_to_xy_batch(neutrals, cm1, cm2) -> np.ndarray:
    """(n, 2) :func:`neutral_to_xy` of n neutrals (n, 3), each with its own
    cm1, cm2 (n, 3, 3): the fixed point for all of them at once, each
    element stopping where its own iteration stops."""
    neutrals = np.asarray(neutrals, np.float64).reshape(-1, 3)
    cm1 = np.asarray(cm1, np.float64).reshape(-1, 3, 3)
    cm2 = np.asarray(cm2, np.float64).reshape(-1, 3, 3)
    n = len(neutrals)
    last = np.empty((n, 2))
    last[:] = _D50_XY
    out = last.copy()
    live = np.arange(n)
    for _ in range(30):
        if not len(live):
            return out
        g = _interp_weights(last[live, 0], last[live, 1])[:, None, None]
        m = g * cm1[live] + (1.0 - g) * cm2[live]
        try:
            xyz = np.linalg.solve(m, neutrals[live][:, :, None])[:, :, 0]
        except np.linalg.LinAlgError:  # a singular matrix: the scalar function's own way
            for k in live:
                out[k] = neutral_to_xy(neutrals[k], cm1[k], cm2[k])
            return out
        s = xyz[:, 0] + xyz[:, 1] + xyz[:, 2]
        bad = (s <= 0.0) | ~np.isfinite(s)
        nxt = np.empty((len(live), 2))
        nxt[:] = _D50_XY
        ok = ~bad
        nxt[ok, 0] = xyz[ok, 0] / s[ok]
        nxt[ok, 1] = xyz[ok, 1] / s[ok]
        step = np.abs(nxt[:, 0] - last[live, 0]) + np.abs(nxt[:, 1] - last[live, 1])
        conv = step < 1e-7
        out[live[conv]] = nxt[conv]
        last[live] = nxt
        out[live[~conv]] = nxt[~conv]
        live = live[~conv]
    return out


def interpolated_forward_batch(neutrals, cm1, cm2, fm1, fm2) -> np.ndarray:
    """(n, 3, 3) forward matrices of :func:`interpolated_matrices` for n
    frames, each with its own neutral and its clip's matrices (all (n, 3)
    or (n, 3, 3), float64): the matrices interpolated at each white point,
    bit for bit the scalar function's."""
    xy = neutral_to_xy_batch(neutrals, cm1, cm2)
    g = _interp_weights(xy[:, 0], xy[:, 1])[:, None, None]
    fm1 = np.asarray(fm1, np.float64).reshape(-1, 3, 3)
    fm2 = np.asarray(fm2, np.float64).reshape(-1, 3, 3)
    return g * fm1 + (1.0 - g) * fm2
