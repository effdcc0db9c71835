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
    """The kernel's table: one int32 word a bucket, 6,664 bytes; a bucket
    starts where lin's bits >> 16 step and holds at most one threshold;
    (word + L) >> 16, L the low 16 bits of lin's float32 bits, is the
    bucket's base at its start and base + 1 from its threshold on, where
    its word's low half is 0x10000 less the threshold's low half; NaN and
    -0.0 give 0, 1.0 gives 255."""
    tab = D.quantizer_table()
    next_thr, base = D.srgb_quantizer()
    assert tab.shape == (D.SRGB_ENTRIES,) and tab.dtype == np.int32 and tab.nbytes == 6664
    start = D.srgb_bucket_starts()
    assert start[1] == np.float32(2.0 ** -13) and start[-1] == 1.0
    assert np.all(np.diff(start) > 0)
    assert np.array_equal(base, D.srgb_code_f64(start))
    assert base[0] == 0 and base[-1] == 255 and next_thr[-1] == np.inf
    assert np.all(next_thr[:-1] >= start[:-1])
    word = tab.astype(np.int64)
    low = lambda f: f.view(np.int32).astype(np.int64) & 0xFFFF  # noqa: E731
    assert np.array_equal((word + low(start)) >> 16, base)
    end = np.append(np.nextafter(start[1:], np.float32(0)), np.float32(1.0))
    inside = next_thr <= end
    assert inside.sum() == 255 and not inside[0]  # every threshold, none in bucket 0
    t = next_thr[inside]
    assert np.array_equal((word[inside] + low(t)) >> 16, base[inside].astype(np.int64) + 1)
    assert np.array_equal(word[inside] & 0xFFFF, (0x10000 - low(t)) & 0xFFFF)
    assert np.array_equal(word[~inside], base[~inside].astype(np.int64) << 16)
    edge = np.array([np.nan, -0.0, -1.0, 0.0, 1.0, 2.0, np.inf], np.float32)
    assert D.srgb_quantize(edge).tolist() == [0, 0, 0, 0, 255, 255, 255]


# Every bucket, in groups: bucket 0 ([0, 2^-13) and -0.0), the thirteen
# octaves 2^-13 .. 1 of 128 buckets each, and 1.0's bucket.
BUCKET_GROUPS = [(0, 1)] + [(1 + 128 * o, 129 + 128 * o) for o in range(13)] + [(1665, 1666)]


@pytest.mark.parametrize("first, stop", BUCKET_GROUPS)
def test_quantizer_exact_over_every_bucket(first, stop):
    """In each bucket of [first, stop): its first float, its last, and its
    threshold with the threshold's predecessor take srgb_code_f64's code.
    A bucket holds at most one threshold and the code is monotone, so the
    code is constant from the bucket's start up to the threshold's
    predecessor and from the threshold to the bucket's end: these four
    cover every float32 in [0, 1]."""
    assert D.SRGB_ENTRIES == BUCKET_GROUPS[-1][1]
    start = D.srgb_bucket_starts()
    end = np.append(np.nextafter(start[1:], np.float32(0)), np.float32(1.0))
    next_thr, _ = D.srgb_quantizer()
    k = np.arange(first, stop)
    thr = next_thr[k][next_thr[k] <= end[k]]
    pred = np.nextafter(thr, np.float32(0))
    lin = np.concatenate([start[k], end[k], thr, pred]).astype(np.float32)
    if first == 0:
        lin = np.append(lin, np.float32(-0.0))
    assert np.array_equal(D.srgb_quantize(lin), D.srgb_code_f64(lin))
    # The constant runs: the code at a bucket's start holds up to the
    # threshold's predecessor (or the bucket's end), and the threshold's up
    # to the end.
    has = next_thr[k] <= end[k]
    upto = np.where(has, np.nextafter(next_thr[k], np.float32(0)), end[k])
    assert np.array_equal(D.srgb_code_f64(upto), D.srgb_code_f64(start[k]))
    assert np.array_equal(D.srgb_code_f64(end[k][has]), D.srgb_code_f64(thr))


@pytest.mark.parametrize("demosaic", MODES)
@pytest.mark.parametrize("sensor", SENSORS)
def test_exact_quantizer_of_plain_lin_within_one_lsb_of_f64(sensor, demosaic):
    """develop_lin_plain is the plain version before its curve, (3, ...)
    float32 in [0, 1]; its exact codes (the kernel's RGBA, which the card
    tests hold bit for bit) are within 1 LSB of the f64 model and of the
    plain version's float32 curve, and never farther from the model."""
    cfa = tuple(CFA_PATTERNS[sensor])
    raw = np.random.default_rng(len(sensor) * 7 + len(demosaic)).integers(
        0, 4096, size=(2, 21, 38), dtype=np.uint16)
    params = D.pack_develop_params(BLACK, WHITE, NEUTRAL, FWD)
    lin = D.develop_lin_plain(torch.from_numpy(raw), params, cfa=cfa, demosaic=demosaic)
    assert lin.dtype == torch.float32 and lin.shape == (3, *raw.shape)
    assert bool(((lin >= 0) & (lin <= 1)).all())
    exact = np.moveaxis(D.srgb_quantize(lin.numpy()), 0, -1)
    got, _ = channels(plain(raw, cfa, demosaic, params))
    assert np.abs(exact - got).max() <= 1
    for f in range(raw.shape[0]):
        model = P.develop_f64(raw[f], BLACK, WHITE, NEUTRAL, FWD, cfa, demosaic=demosaic)
        assert np.abs(exact[f] - model).max() <= 1
        assert (exact[f] != model).sum() <= (got[f] != model).sum()


# -- the ring path's host side: which path, and its tensor map -------------------

# The card tests' shapes: the grade step's batch, a 12 MP frame, the
# batch-edge frames (width 72), small aligned frames; and the ragged ones.
RING_SHAPES = [(8, 2160, 3840), (1, 2160, 3840), (1, 3024, 4032), (3, 3, 72), (3, 5, 72),
               (3, 66, 72), (1, 16, 128), (2, 40, 136), (1, 3, 64)]
RAGGED_SHAPES = [(1, 5, 7), (1, 3, 101), (1, 37, 251), (1, 36, 250), (1, 65, 130),
                 (3, 5, 250), (3, 66, 70)]


@pytest.mark.parametrize("frames, height, width", RING_SHAPES + RAGGED_SHAPES)
def test_ring_map_geometry(frames, height, width):
    """The tensor map spans exactly the (frames, height, width) uint16
    tensor: dims innermost first, a row's and a frame's bytes as strides
    (multiples of 16 wherever width % 8 == 0, as the map asks), and one box
    of a 64x32 tile, its 2-pixel halo and the 6 columns more on the left
    that put the box's first column on a 16-byte boundary, one frame deep,
    rows of 160 bytes."""
    g = D.ring_map_geometry(frames, height, width)
    assert g["dims"] == (width, height, frames)
    assert g["strides"] == (2 * width, 2 * width * height)
    assert g["box"] == D.RING_BOX == (8 + 64 + 8, 32 + 2 * 2, 1)
    assert 2 * g["box"][0] % 16 == 0 and g["box_bytes"] == 2 * 80 * 36 == 5760
    nbytes = torch.empty((frames, height, width), dtype=torch.uint16).nbytes
    assert 2 * g["elements"] == nbytes == g["strides"][1] * frames
    assert all(s % 16 == 0 for s in g["strides"]) == (width % 8 == 0)


@pytest.mark.parametrize("frames, height, width", RING_SHAPES + RAGGED_SHAPES)
@pytest.mark.parametrize("offset", [0, 2, 8, 16])
def test_ring_takes_shape_and_alignment(frames, height, width, offset):
    """The ring path needs width % 8 == 0 and a 16-byte-aligned base; a
    slice 2 or 8 bytes off the boundary takes the direct path."""
    params = D.pack_develop_params(BLACK, WHITE, NEUTRAL, FWD)
    want = width % 8 == 0 and offset % 16 == 0
    assert D.ring_takes((1 << 40) + offset, width, params) is want


@pytest.mark.parametrize("black, white, takes", [
    ((64, 60, 70, 64), 4095.0, True),
    ((56, 60, 64, 72), 4095.0, True),
    ((0, 0, 0, 0), 4095.0, True),
    ((63.5, 64.25, 65, 1023), 1023.5, True),  # fractional and odd levels
    ((-0.0, 0, 0, 0), 1.0, True),
    ((-1, 60, 70, 64), 4095.0, False),  # raw 0 would normalize to 1/4096
    ((64, 60, -0.5, 64), 4095.0, False),
    ((64, 60, 70, 4095), 4095.0, False),  # white == black: 1/0
    ((64, 60, 70, 5000), 4095.0, False),  # white < black: a negative scale
    ((64, 60, float("nan"), 64), 4095.0, False),
    ((64, 60, 70, 64), float("inf"), False),
])
def test_zero_fill_exact(black, white, takes):
    """raw 0 normalizes to +0.0 on every site exactly where the ring path
    is allowed; a negative black level or a scale that is not finite and
    positive keeps the direct path, whose bounds tests stage 0 there."""
    params = D.pack_develop_params(np.asarray(black, np.float32), white, NEUTRAL, FWD)
    assert D.zero_fill_exact(params) is takes
    assert D.ring_takes(1 << 40, 3840, params) is takes
    b = torch.from_numpy(params[0, 0:4].copy())
    with np.errstate(divide="ignore"):
        inv = torch.from_numpy(np.float32(1.0) / (params[0, 4] - params[0, 0:4]))
    zero = ((torch.zeros(4) - b) * inv).clamp(0.0, 1.0)  # the kernel's and plain's normalization
    if takes:
        assert torch.equal(zero, torch.zeros(4)) and not torch.signbit(zero).any()
    else:  # raw 0 is not 0 on some site, or the scale is not a finite positive number
        assert (zero != 0).any() or not (torch.isfinite(inv) & (inv > 0)).all()


class _FakeMapLib:
    """mcraw_develop_map on the CPU: records the geometry it was given and
    writes 128 bytes of its own; `err` is returned."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def mcraw_develop_map(self, out, address, dims, strides, box):
        import ctypes

        read = lambda p, n, t: list((t * n).from_address(p))  # noqa: E731
        self.calls.append((address, read(dims, 3, ctypes.c_int64),
                           read(strides, 2, ctypes.c_int64), read(box, 3, ctypes.c_int32)))
        ctypes.memmove(out, bytes(range(len(self.calls), len(self.calls) + 128)), 128)
        return self.err


@pytest.mark.parametrize("frames", [1, 8])
def test_tensor_map_is_encoded_once_per_address_and_shape(frames, monkeypatch):
    """The wrapper encodes a map from ring_map_geometry once per (address,
    frames, height, width) and keeps at most RING_MAPS_KEPT; an encoder
    error raises."""
    from mcraw_torch.kernels import build

    lib = _FakeMapLib()
    monkeypatch.setattr(build, "lib", lambda: lib)
    monkeypatch.setattr(D, "_MAPS", {})
    a = D._tensor_map(1 << 40, frames, 2160, 3840)
    assert D._tensor_map(1 << 40, frames, 2160, 3840) is a and len(lib.calls) == 1
    assert a.nbytes == 128 and a.view(np.uint8)[0] == 1
    g = D.ring_map_geometry(frames, 2160, 3840)
    assert lib.calls[0] == (1 << 40, list(g["dims"]), list(g["strides"]), list(g["box"]))
    D._tensor_map((1 << 40) + 256, frames, 2160, 3840)
    D._tensor_map(1 << 40, frames, 2160, 3832)
    assert len(lib.calls) == 3 and len(D._MAPS) == 3
    for k in range(D.RING_MAPS_KEPT):
        D._tensor_map((2 << 40) + 16 * k, frames, 8, 8)
    assert len(D._MAPS) <= D.RING_MAPS_KEPT
    monkeypatch.setattr(build, "lib", lambda: _FakeMapLib(err=1))
    with pytest.raises(RuntimeError, match="CUresult 1"):
        D._tensor_map(3 << 40, frames, 2160, 3840)
