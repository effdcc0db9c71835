"""mcraw_torch preview: decode + develop through mcraw_torch.Decoder on the
CPU (the develop kernel's plain version), held against mcraw.preview on
mcraw.Decoder(backend="jax") (its Pallas develop kernel in interpret mode)
and against the f64 model, on modern and legacy clips with non-identity
dual-illuminant matrices and a warm as-shot neutral.

Tolerance: <= 1 LSB per channel (float32 arithmetic, transcendentals of
another library); preview_clip equals preview_frame_rgba bit for bit."""

import numpy as np
import pytest
import torch

from mcraw import encode as E
from mcraw import preview as JP
from mcraw.color import interpolated_matrices
from mcraw.metadata import ContainerMetadata, example_container_metadata
from mcraw.metadata import example_frame_metadata
from mcraw.pipeline import Decoder as JaxDecoder
from mcraw_torch import Decoder
from mcraw_torch import preview as P
from mcraw_torch.kernels import develop as D

# Matrix pairs of tests/test_preview.py: XYZ->camera at D65 / Standard A and
# the (white-balanced camera)->XYZ(D50) forward matrices.
_CM1 = np.array([[0.79, -0.23, -0.07], [-0.43, 1.32, 0.05],
                 [-0.07, 0.18, 0.54]])
_CM2 = np.array([[0.92, -0.31, -0.01], [-0.50, 1.42, 0.08],
                 [-0.04, 0.22, 0.42]])
_FM1 = np.array([[0.62, 0.22, 0.12], [0.26, 0.72, 0.02],
                 [0.03, 0.12, 0.67]])
_FM2 = np.array([[0.68, 0.18, 0.10], [0.30, 0.68, 0.02],
                 [0.05, 0.10, 0.67]])
# A Standard-A-ish camera neutral: the interpolation weight lands near FM2.
_WARM = (_CM2 @ np.array([0.4476 / 0.4074, 1.0, (1 - 0.4476 - 0.4074) / 0.4074]))
_WARM = (_WARM / _WARM[1]).tolist()

FRAMES = {  # timestamp: (codec, height, width)
    1: (7, 18, 200),
    2: (6, 20, 96),
    3: (7, 2, 64),
    4: (7, 1, 64),
}


def container(sensor: str = "bggr") -> dict:
    cm = example_container_metadata(sensor=sensor, black_level=(64, 60, 70, 64),
                                    white_level=4095.0)
    cm["colorMatrix1"], cm["colorMatrix2"] = _CM1.ravel().tolist(), _CM2.ravel().tolist()
    cm["forwardMatrix1"], cm["forwardMatrix2"] = _FM1.ravel().tolist(), _FM2.ravel().tolist()
    return cm


@pytest.fixture(scope="module")
def clip():
    """(container bytes, {timestamp: source image})."""
    rng = np.random.default_rng(31)
    writer = E.ContainerWriter(container())
    imgs = {}
    for ts, (codec, h, w) in FRAMES.items():
        img = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
        payload = E.encode_modern(img) if codec == 7 else E.encode_legacy(img)
        fm = example_frame_metadata(w, h, codec)
        fm["asShotNeutral"] = _WARM
        writer.add_frame(ts, payload, fm)
        imgs[ts] = img
    return writer.finish(), imgs


def rgb_of(rgba: torch.Tensor) -> np.ndarray:
    a = rgba.to(torch.int64).numpy()
    assert ((a >> 24) == 0xFF).all()
    return np.stack([a & 0xFF, (a >> 8) & 0xFF, (a >> 16) & 0xFF], -1)


def f64_model(blob, img, demosaic):
    cm = ContainerMetadata(JaxDecoder(blob, backend="numpy").container_metadata)
    fwd, _, g = interpolated_matrices(cm, _WARM)
    assert g < 0.1  # warm neutral: near the Standard A matrices
    return P.develop_f64(img, cm.black_level, cm.white_level, _WARM, fwd,
                         tuple(cm.cfa_pattern), demosaic=demosaic)


@pytest.mark.parametrize("demosaic", ["bilinear", "malvar"])
@pytest.mark.parametrize("ts", [1, 2])
def test_preview_frame_equals_jax_package(clip, ts, demosaic):
    """Modern (ts 1) and legacy (ts 2) frames: preview_frame_rgba and
    preview_frame against mcraw.preview.preview_frame and the f64 model."""
    blob, imgs = clip
    d = Decoder(blob, device="cpu")
    calls = D.PLAIN_CALLS
    rgba = P.preview_frame_rgba(d, ts, demosaic=demosaic)
    rgb = P.preview_frame(d, ts, demosaic=demosaic)
    assert D.PLAIN_CALLS == calls + 2
    h, w = FRAMES[ts][1:]
    assert rgba.shape == (h, w) and rgba.dtype == torch.uint32
    assert rgb.shape == (h, w, 3) and rgb.dtype == torch.uint8
    got = rgb_of(rgba)
    assert np.array_equal(rgb.numpy().astype(np.int64), got)
    want = np.asarray(JP.preview_frame(JaxDecoder(blob, backend="jax"), ts,
                                       demosaic=demosaic)).astype(np.int64)
    assert np.abs(got - want).max() <= 1
    assert np.abs(got - f64_model(blob, imgs[ts], demosaic)).max() <= 1


def test_preview_clip_equals_preview_frame_rgba(clip):
    blob, _ = clip
    d = Decoder(blob, device="cpu")
    frames = list(P.preview_clip(d, timestamps=[1, 2, 3]))
    assert [ts for ts, _ in frames] == [1, 2, 3]
    for ts, rgba in frames:
        assert torch.equal(rgba.to(torch.int64),
                           P.preview_frame_rgba(d, ts).to(torch.int64))
    malvar = list(P.preview_clip(d, timestamps=[2], demosaic="malvar"))
    assert torch.equal(malvar[0][1].to(torch.int64),
                       P.preview_frame_rgba(d, 2, demosaic="malvar").to(torch.int64))


def test_height_two_takes_develop_path(clip):
    """Height <= 2 takes the table-normalized develop, as in the JAX
    package (plain XLA there, no Pallas kernel)."""
    blob, _ = clip
    d = Decoder(blob, device="cpu")
    calls, plain_calls = P.DEVELOP_CALLS, D.PLAIN_CALLS
    got = rgb_of(P.preview_frame_rgba(d, 3))
    assert (P.DEVELOP_CALLS, D.PLAIN_CALLS) == (calls + 1, plain_calls)
    want = np.asarray(JP.preview_frame(JaxDecoder(blob, backend="jax"), 3))
    assert got.shape == (2, 64, 3)
    assert np.abs(got - want.astype(np.int64)).max() <= 1


@pytest.mark.parametrize("ts", [3, 4])
def test_malvar_needs_the_kernel(clip, ts):
    blob, _ = clip
    with pytest.raises(ValueError) as want:
        JP.preview_frame(JaxDecoder(blob, backend="jax"), ts, demosaic="malvar")
    with pytest.raises(ValueError) as got:
        P.preview_frame(Decoder(blob, device="cpu"), ts, demosaic="malvar")
    assert str(got.value) == str(want.value)
    assert "needs the fused kernel" in str(got.value)


def test_height_one_shape(clip):
    """The JAX path divides 0 by 0 at height 1 (the table has no finite
    normalizer there), so only the shape is pinned."""
    blob, _ = clip
    with np.errstate(divide="ignore"):
        rgba = P.preview_frame_rgba(Decoder(blob, device="cpu"), 4)
    assert rgba.shape == (1, 64) and rgba.dtype == torch.uint32


def test_develop_equals_jax_develop():
    """develop() against mcraw.preview.develop, which it ports, at a height
    where both have finite normalizers everywhere."""
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    h, w = 5, 40
    raw = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
    black = np.array([64, 60, 70, 64], np.float32)
    neutral = np.array([0.45, 1.0, 0.8], np.float32)
    fwd = _FM1.astype(np.float32)
    cfa = (2, 1, 1, 0)
    got = P.develop(torch.from_numpy(raw), black, np.float32(4095), neutral, fwd,
                    cfa=cfa)
    want = np.asarray(JP.develop(
        jnp.asarray(raw), jnp.asarray(black), jnp.asarray(np.float32(4095)),
        jnp.asarray(neutral), jnp.asarray(fwd), JP._inv_dens_device(h, w, cfa),
        height=h, width=w, cfa=cfa,
    ))
    assert got.dtype == torch.uint8 and got.shape == (h, w, 3)
    assert np.abs(got.numpy().astype(np.int64) - want.astype(np.int64)).max() <= 1


def test_rgba_to_rgb_is_a_byte_view():
    rgba = torch.tensor([[0xFF030201, 0xFFFFFEFD]], dtype=torch.int64).to(torch.uint32)
    assert P.rgba_to_rgb(rgba).tolist() == [[[1, 2, 3], [253, 254, 255]]]


@pytest.mark.parametrize("with_gains", [False, True])
@pytest.mark.parametrize("sensor", ["rggb", "bggr", "grbg", "gbrg"])
@pytest.mark.parametrize("shape", [(4, 8), (36, 250), (37, 251)])
def test_bilinear_demosaic_equals_jax(shape, sensor, with_gains):
    """bilinear_demosaic against mcraw.preview.bilinear_demosaic, bit for
    bit: both convolve as the same shifted adds in the same order, and the
    weights (1, 2, 4) make every product exact, so no contraction into an
    FMA can change a sum; the normalizer is one product either way."""
    import jax.numpy as jnp

    from mcraw.metadata import CFA_PATTERNS

    h, w = shape
    cfa = tuple(CFA_PATTERNS[sensor])
    rng = np.random.default_rng(sum(shape) + len(sensor))
    raw = rng.random((h, w), dtype=np.float32)
    masks = JP._phase_masks(h, w, cfa)
    inv_dens = JP._inv_dens(h, w, cfa)
    gains = rng.uniform(0.5, 2.5, 3).astype(np.float32) if with_gains else None
    want = np.asarray(JP.bilinear_demosaic(
        jnp.asarray(raw), [jnp.asarray(m) for m in masks], jnp.asarray(inv_dens),
        None if gains is None else jnp.asarray(gains)))
    got = P.bilinear_demosaic(
        torch.from_numpy(raw), [torch.from_numpy(m) for m in masks],
        torch.from_numpy(inv_dens), None if gains is None else torch.from_numpy(gains))
    assert got.dtype == torch.float32 and got.shape == (h, w, 3)
    assert np.array_equal(got.numpy(), want, equal_nan=True)
