"""mcraw_torch develop: the f64 model's copy, the parameter row, the plain
version of the develop kernel and its wrapper, held against the JAX
package's f64 model and its Pallas develop kernel (interpret mode) on the
same numpy-seeded inputs.

Tolerances: the model copy and the parameter row are bit-equal (same NumPy
operations); the plain version is <= 1 LSB per channel against the Pallas
kernel and against the f64 model (float32 arithmetic, transcendentals of
another library), with alpha 255; batched equals single calls bit for bit.
The CUDA kernel is checked on the card by test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcraw import preview as JP
from mcraw.kernels import pallas_develop as PD
from mcraw.metadata import CFA_PATTERNS
from mcraw_torch import preview as P
from mcraw_torch.kernels import develop as D

SENSORS = ("rggb", "bggr", "grbg", "gbrg")
MODES = ("bilinear", "malvar")
BLACK = np.array([64, 60, 70, 64], np.float32)
WHITE = 4095.0
NEUTRAL = np.array([0.61, 1.0, 0.72], np.float32)
FWD = np.array(
    [[0.86, 0.08, 0.02], [0.04, 0.91, 0.05], [0.01, 0.06, 0.76]], np.float32
)


def channels(rgba: np.ndarray):
    """(..., 3) int64 channels and the alpha of uint32 RGBA8888."""
    a = np.asarray(rgba).astype(np.int64)
    return np.stack([a & 0xFF, (a >> 8) & 0xFF, (a >> 16) & 0xFF], -1), a >> 24


def plain(raw: np.ndarray, cfa, demosaic: str, params=None) -> np.ndarray:
    if params is None:
        params = D.pack_develop_params(BLACK, WHITE, NEUTRAL, FWD)
    out = D.develop_rgba_plain(
        torch.from_numpy(raw), params, cfa=cfa, demosaic=demosaic
    )
    assert out.dtype == torch.uint32 and out.shape == raw.shape
    return out.to(torch.int64).numpy()


# -- the f64 model and the parameter row -------------------------------------


def test_xyz_to_srgb_constant_equals_jax_package():
    assert P._XYZ_D50_TO_SRGB.dtype == JP._XYZ_D50_TO_SRGB.dtype
    assert np.array_equal(P._XYZ_D50_TO_SRGB, JP._XYZ_D50_TO_SRGB)


@pytest.mark.parametrize("demosaic", MODES)
@pytest.mark.parametrize("sensor", SENSORS)
def test_develop_f64_equals_jax_package(sensor, demosaic):
    rng = np.random.default_rng(len(sensor) + len(demosaic))
    raw = rng.integers(0, 4096, size=(22, 37), dtype=np.uint16)
    cfa = tuple(CFA_PATTERNS[sensor])
    args = (raw, BLACK, WHITE, NEUTRAL, FWD, cfa)
    got = P.develop_f64(*args, demosaic=demosaic)
    assert got.dtype == np.int64 and got.shape == (22, 37, 3)
    assert np.array_equal(got, JP.develop_f64(*args, demosaic=demosaic))


@pytest.mark.parametrize("shape", [(1, 6), (2, 5), (7, 12)])
def test_inv_dens_equals_jax_package(shape):
    for sensor in SENSORS:
        cfa = tuple(CFA_PATTERNS[sensor])
        with np.errstate(divide="ignore"):
            assert np.array_equal(P._inv_dens(*shape, cfa), JP._inv_dens(*shape, cfa))


@pytest.mark.parametrize(
    "black, white, neutral, fwd",
    [
        (BLACK, WHITE, NEUTRAL, FWD),
        (np.zeros(4), 1023.0, [0.4831, 1.0, 0.6517],
         np.diag([0.9642, 1.0, 0.8249])),
        ((16, 20, 24, 28), np.float32(65535.0), (0.55, 1.0, 0.71),
         [0.6, 0.2, 0.16, 0.25, 0.7, 0.05, 0.02, 0.18, 0.62]),
    ],
)
def test_pack_develop_params_bit_equal(black, white, neutral, fwd):
    got = D.pack_develop_params(black, white, neutral, fwd)
    want = PD.pack_develop_params(black, white, neutral, fwd)
    assert got.dtype == np.float32 and got.shape == (1, 128)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# -- the plain version against the Pallas kernel and the f64 model -----------


@pytest.mark.parametrize("demosaic", MODES)
@pytest.mark.parametrize(
    "shape, sensor",
    [((40, 256), "rggb"), ((36, 250), "bggr"), ((64, 128), "grbg"),
     ((48, 320), "gbrg"), ((3, 66), "bggr")],
)
def test_plain_equals_pallas_and_f64(shape, sensor, demosaic):
    """band_rows=16 on the JAX side puts its band seams inside the Malvar
    halo; (3, 66) is the least height the kernel takes."""
    h, w = shape
    cfa = tuple(CFA_PATTERNS[sensor])
    rng = np.random.default_rng(h * w)
    raw = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
    raw[0, :7] = 0
    raw[-1, -7:] = 4095
    params = D.pack_develop_params(BLACK, WHITE, NEUTRAL, FWD)
    got, alpha = channels(plain(raw, cfa, demosaic, params))
    pallas, palpha = channels(PD.develop_rgba_pallas(
        jnp.asarray(raw), jnp.asarray(params), None, height=h, width=w,
        cfa=cfa, demosaic=demosaic, band_rows=16, interpret=True,
    ))
    model = P.develop_f64(raw, BLACK, WHITE, NEUTRAL, FWD, cfa, demosaic=demosaic)
    assert (alpha == 255).all() and (palpha == 255).all()
    assert np.abs(got - pallas).max() <= 1
    assert np.abs(got - model).max() <= 1
    assert np.abs(pallas - model).max() <= 1


@pytest.mark.parametrize("sensor", SENSORS)
@pytest.mark.parametrize("demosaic", MODES)
def test_plain_all_cfas_within_one_lsb_of_f64(sensor, demosaic):
    """Saturated, black and mid-grey areas beside noise, at a ragged width."""
    cfa = tuple(CFA_PATTERNS[sensor])
    rng = np.random.default_rng(21)
    raw = rng.integers(0, 4096, size=(13, 45), dtype=np.uint16)
    raw[:4, :10] = 4095
    raw[4:8, 10:20] = 0
    raw[8:, 20:30] = 2048
    got, alpha = channels(plain(raw, cfa, demosaic))
    model = P.develop_f64(raw, BLACK, WHITE, NEUTRAL, FWD, cfa, demosaic=demosaic)
    assert (alpha == 255).all()
    assert np.abs(got - model).max() <= 1


@pytest.mark.parametrize(
    "shape", [(3, 3), (3, 5), (4, 3), (5, 7), (36, 250), (66, 128)]
)
def test_bilinear_closed_form_equals_table(shape):
    """The closed-form normalizer is bit-equal to 1/conv(mask) wherever the
    develop kernel runs (height >= 3; the table is finite from width 3)."""
    h, w = shape
    for sensor in SENSORS:
        cfa = tuple(CFA_PATTERNS[sensor])
        got = torch.stack(
            [t.expand(h, w) for t in D._bilinear_inv(h, w, cfa, torch.device("cpu"))]
        ).numpy()
        want = P._inv_dens(h, w, cfa)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), sensor


@pytest.mark.parametrize("demosaic", MODES)
@pytest.mark.parametrize("h", [3, 5, 66])
def test_batched_equals_single_calls(h, demosaic):
    """Black, white and noise frames: any tap read across a frame border
    would show in the frame beside it."""
    w = 70
    rng = np.random.default_rng(h)
    frames = np.stack([
        np.zeros((h, w), np.uint16),
        np.full((h, w), 4095, np.uint16),
        rng.integers(0, 4096, size=(h, w), dtype=np.uint16),
    ])
    cfa = tuple(CFA_PATTERNS["grbg"])
    batched = plain(frames, cfa, demosaic)
    singles = np.stack([plain(f, cfa, demosaic) for f in frames])
    assert np.array_equal(batched, singles)


# -- the wrapper ----------------------------------------------------------------


def test_wrapper_takes_plain_version_on_cpu():
    raw = np.random.default_rng(0).integers(0, 4096, size=(6, 10), dtype=np.uint16)
    params = D.pack_develop_params(BLACK, WHITE, NEUTRAL, FWD)
    calls, launches = D.PLAIN_CALLS, D.KERNEL_LAUNCHES
    out = D.develop_rgba_device(torch.from_numpy(raw), params, cfa=(0, 1, 1, 2),
                                demosaic="malvar")
    assert (D.PLAIN_CALLS, D.KERNEL_LAUNCHES) == (calls + 1, launches)
    assert np.array_equal(out.to(torch.int64).numpy(),
                          plain(raw, (0, 1, 1, 2), "malvar", params))


def test_wrapper_raises_off_cpu_and_cuda():
    params = D.pack_develop_params(BLACK, WHITE, NEUTRAL, FWD)
    raw = torch.zeros((4, 4), dtype=torch.uint16, device="meta")
    with pytest.raises(ValueError, match="no develop kernel"):
        D.develop_rgba_device(raw, params, cfa=(0, 1, 1, 2))


@pytest.mark.parametrize(
    "raw, cfa, demosaic, match",
    [
        (torch.zeros((4, 4), dtype=torch.int32), (0, 1, 1, 2), "bilinear", "uint16"),
        (torch.zeros((4,), dtype=torch.uint16), (0, 1, 1, 2), "bilinear", "uint16"),
        (torch.zeros((4, 4), dtype=torch.uint16), (0, 1, 2, 1), "bilinear", "Bayer"),
        (torch.zeros((4, 4), dtype=torch.uint16), (0, 1, 1, 2), "ahd", "demosaic"),
    ],
)
def test_plain_rejects_bad_inputs(raw, cfa, demosaic, match):
    params = D.pack_develop_params(BLACK, WHITE, NEUTRAL, FWD)
    with pytest.raises(ValueError, match=match):
        D.develop_rgba_device(raw, params, cfa=cfa, demosaic=demosaic)


def test_empty_frame():
    params = D.pack_develop_params(BLACK, WHITE, NEUTRAL, FWD)
    out = D.develop_rgba_plain(torch.zeros((2, 0, 5), dtype=torch.uint16), params,
                               cfa=(0, 1, 1, 2))
    assert out.shape == (2, 0, 5) and out.dtype == torch.uint32


# -- the kernel's sRGB quantizer (host side) ----------------------------------


def test_srgb_code_is_the_f64_models_curve():
    """develop_f64 ends in srgb_code_f64: the model through the original
    mcraw.preview curve equals the copy's on a frame with every code."""
    raw = np.random.default_rng(3).integers(0, 4096, size=(40, 64), dtype=np.uint16)
    got = P.develop_f64(raw, BLACK, WHITE, NEUTRAL, FWD, CFA_PATTERNS["rggb"])
    want = JP.develop_f64(raw, BLACK, WHITE, NEUTRAL, FWD, CFA_PATTERNS["rggb"])
    assert np.array_equal(got, want)
    lin = np.linspace(-0.5, 1.5, 4001)
    curve = np.where(np.clip(lin, 0, 1) <= 0.0031308, 12.92 * np.clip(lin, 0, 1),
                     1.055 * np.power(np.clip(lin, 0, 1), 1 / 2.4) - 0.055)
    assert np.array_equal(D.srgb_code_f64(lin),
                          np.round(np.clip(curve, 0, 1) * 255.0).astype(np.int64))


def test_srgb_thresholds_are_the_code_steps():
    """thr[c] is the least float32 with code c: its predecessor has c - 1."""
    thr = D.srgb_thresholds()
    assert thr.dtype == np.float32 and thr.shape == (257,)
    c = np.arange(1, 256)
    t = thr[1:256]
    assert np.all(np.diff(t) > 0) and t[0] > 0 and t[-1] <= 1
    assert np.array_equal(D.srgb_code_f64(t), c)
    assert np.array_equal(D.srgb_code_f64(np.nextafter(t, np.float32(0))), c - 1)


@pytest.mark.parametrize("ulps", [-2, -1, 0, 1, 2])
def test_quantizer_exact_at_every_threshold(ulps):
    """The quantizer equals round(255 * srgb) of the f64 model at every
    threshold and at its float32 neighbours."""
    t = D.srgb_thresholds()[1:256]
    lin = t.view(np.int32) + np.int32(ulps)
    lin = np.clip(lin.view(np.float32), 0, 1)
    assert np.array_equal(D.srgb_quantize(lin), D.srgb_code_f64(lin))


def test_quantizer_exact_on_a_dense_sample():
    """Every float32 step at the bottom of [0, 1], 2^22 + 1 even steps
    over it, and random floats, with both ends."""
    low = np.arange(0, 1 << 16, dtype=np.int32).view(np.float32)
    even = np.linspace(0, 1, (1 << 22) + 1).astype(np.float32)
    rand = np.random.default_rng(8).random(1 << 20, dtype=np.float32)
    for lin in (low, even, rand, np.array([0, 1], np.float32)):
        assert np.array_equal(D.srgb_quantize(lin), D.srgb_code_f64(lin))


def test_quantizer_table_layout():
    """The kernel's (SRGB_ENTRIES, 2) int32 table: next threshold's bits,
    base code; a bucket starts where lin's bits >> 16 step, each bucket
    holds at most one threshold; NaN and -0.0 give 0, 1.0 gives 255."""
    tab = D.quantizer_table()
    next_thr, base = D.srgb_quantizer()
    assert tab.shape == (D.SRGB_ENTRIES, 2) and tab.dtype == np.int32
    assert np.array_equal(tab[:, 0].view(np.float32), next_thr)
    assert np.array_equal(tab[:, 1], base)
    start = D.srgb_bucket_starts()
    assert start[1] == np.float32(2.0 ** -13) and start[-1] == 1.0
    assert np.all(np.diff(start) > 0)
    assert np.array_equal(base, D.srgb_code_f64(start))
    assert base[0] == 0 and base[-1] == 255 and next_thr[-1] == np.inf
    assert np.all(next_thr[:-1] >= start[:-1])
    edge = np.array([np.nan, -0.0, -1.0, 0.0, 1.0, 2.0, np.inf], np.float32)
    assert D.srgb_quantize(edge).tolist() == [0, 0, 0, 0, 255, 255, 255]
