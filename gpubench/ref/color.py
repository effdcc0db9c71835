"""The DNG 1.4 dual-illuminant color math in float64, for the benchmark's
reference: a frame's forward matrix interpolated at its as-shot white
point between a clip's two calibration illuminants.

From the DNG 1.4 specification, chapter 6 ("Mapping Camera Color Space to
CIE XYZ Space"), as a DNG reader applies it to the matrices a MotionCam
container carries (motioncam-decoder ``example.cpp``: CalibrationIlluminant1
is D65 (6504 K), 2 is Standard A (2856 K), taken as 6500 K and 2850 K):

- the white point of a camera neutral is the fixed point of
  ``xy = chromaticity(inverse(CM(xy)) . neutral)``, from D50, where CM(xy)
  = g CM1 + (1 - g) CM2 and g is the weight of illuminant 1 at xy's
  correlated color temperature; iterated at most 30 times, until a step
  moves x + y by less than 1e-7 (the DNG SDK's NeutralToXY);
- the temperature by Robertson's method (1968): the isotherms of the CIE
  1960 UCS (u, v) diagram from the published table, the point's signed
  distance to each, and the reciprocal temperature interpolated between
  the two isotherms where the distance changes sign;
- the weight by reciprocal temperature (mired), clamped to [0, 1] outside
  the two calibration temperatures;
- the forward matrix ``g FM1 + (1 - g) FM2``.

Plain NumPy; it imports nothing of the program or of JAX.
"""

from __future__ import annotations

import numpy as np

# Robertson's isotherms: reciprocal megakelvin, u, v, slope (Wyszecki and
# Stiles, Color Science, 2nd ed., table 1(3.11)).
ISOTHERMS = np.array([
    (0, 0.18006, 0.26352, -0.24341), (10, 0.18066, 0.26589, -0.25479),
    (20, 0.18133, 0.26846, -0.26876), (30, 0.18208, 0.27119, -0.28539),
    (40, 0.18293, 0.27407, -0.30470), (50, 0.18388, 0.27709, -0.32675),
    (60, 0.18494, 0.28021, -0.35156), (70, 0.18611, 0.28342, -0.37915),
    (80, 0.18740, 0.28668, -0.40955), (90, 0.18880, 0.28997, -0.44278),
    (100, 0.19032, 0.29326, -0.47888), (125, 0.19462, 0.30141, -0.58204),
    (150, 0.19962, 0.30921, -0.70471), (175, 0.20525, 0.31647, -0.84901),
    (200, 0.21142, 0.32312, -1.0182), (225, 0.21807, 0.32909, -1.2168),
    (250, 0.22511, 0.33439, -1.4512), (275, 0.23247, 0.33904, -1.7298),
    (300, 0.24010, 0.34308, -2.0637), (325, 0.24792, 0.34655, -2.4681),
    (350, 0.25591, 0.34951, -2.9641), (375, 0.26400, 0.35200, -3.5814),
    (400, 0.27218, 0.35407, -4.3633), (425, 0.28039, 0.35577, -5.3762),
    (450, 0.28863, 0.35714, -6.7262), (475, 0.29685, 0.35823, -8.5955),
    (500, 0.30505, 0.35907, -11.324), (525, 0.31320, 0.35968, -15.628),
    (550, 0.32129, 0.36011, -23.325), (575, 0.32931, 0.36038, -40.770),
    (600, 0.33724, 0.36051, -116.45),
], dtype=np.float64)
T_ILLUMINANT_1 = 6500.0  # D65
T_ILLUMINANT_2 = 2850.0  # Standard A
D50_XY = np.array([0.3457, 0.3585])


def temperature(xy) -> float:
    """Correlated color temperature (K) of chromaticity xy by Robertson's
    method; infinite above the first isotherm's reach."""
    x, y = float(xy[0]), float(xy[1])
    den = -2.0 * x + 12.0 * y + 3.0
    u, v = 4.0 * x / den, 6.0 * y / den
    mired, iu, iv, slope = ISOTHERMS.T
    # Signed distance along each isotherm's normal; it falls through 0 as
    # the temperature passes the isotherm's.
    dist = ((v - iv) - (u - iu) * slope) / np.sqrt(1.0 + slope * slope)
    if dist[1] <= 0.0:
        return np.inf
    below = np.nonzero(dist[1:] <= 0.0)[0]
    i = below[0] + 1 if len(below) else len(ISOTHERMS) - 1
    d0, d1 = dist[i - 1], dist[i]
    f = min(max(d0 / (d0 - d1) if d0 != d1 else 0.0, 0.0), 1.0)
    return 1e6 / max(mired[i - 1] + f * (mired[i] - mired[i - 1]), 1e-9)


def weight(t: float) -> float:
    """Weight of illuminant 1's matrices at temperature t: linear in 1/t
    between the calibration temperatures, clamped outside them."""
    t = min(max(t, T_ILLUMINANT_2), T_ILLUMINANT_1)
    g = (1.0 / t - 1.0 / T_ILLUMINANT_2) / (1.0 / T_ILLUMINANT_1 - 1.0 / T_ILLUMINANT_2)
    return min(max(g, 0.0), 1.0)


def white_point(neutral, cm1, cm2) -> np.ndarray:
    """xy of a camera neutral: the fixed point from D50 (see the module)."""
    neutral = np.asarray(neutral, np.float64).reshape(3)
    cm1 = np.asarray(cm1, np.float64).reshape(3, 3)
    cm2 = np.asarray(cm2, np.float64).reshape(3, 3)
    xy = D50_XY.copy()
    for _ in range(30):
        g = weight(temperature(xy))
        xyz = np.linalg.solve(g * cm1 + (1.0 - g) * cm2, neutral)
        s = xyz.sum()
        nxt = xyz[:2] / s if np.isfinite(s) and s > 0.0 else D50_XY.copy()
        done = abs(nxt[0] - xy[0]) + abs(nxt[1] - xy[1]) < 1e-7
        xy = nxt
        if done:
            break
    return xy


def forward_matrix(neutral, cm1, cm2, fm1, fm2) -> tuple[np.ndarray, float]:
    """The forward matrix interpolated at the neutral's white point, and
    illuminant 1's weight there."""
    g = weight(temperature(white_point(neutral, cm1, cm2)))
    fm = g * np.asarray(fm1, np.float64).reshape(3, 3) + \
        (1.0 - g) * np.asarray(fm2, np.float64).reshape(3, 3)
    return fm, g
