"""mcraw_torch.Decoder against mcraw.Decoder (NumPy backend, and the JAX
backend with Pallas in interpret mode) on the same small synthetic clips:
modern, legacy and a mix of both codecs."""

import numpy as np
import pytest
import torch

from mcraw import encode as E
from mcraw import errors as JE
from mcraw.metadata import example_container_metadata, example_frame_metadata
from mcraw.pipeline import Decoder as JaxDecoder
from mcraw_torch import Decoder
from mcraw_torch.errors import DecodeError, IOException, MotionCamException


def make_clip(seed=0, num_frames=3, h=16, w=192, codec=7):
    """codec: 7, 6, or "mixed" (frames alternate 7, 6, 7, ...)."""
    rng = np.random.default_rng(seed)
    writer = E.ContainerWriter(example_container_metadata())
    imgs = []
    for i in range(num_frames):
        img = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
        imgs.append(img)
        ct = (7, 6)[i % 2] if codec == "mixed" else codec
        payload = E.encode_modern(img) if ct == 7 else E.encode_legacy(img)
        writer.add_frame(100 + i, payload, example_frame_metadata(w, h, ct))
        writer.add_audio(rng.integers(-100, 100, size=64).astype(np.int16), i * 1000)
    return writer.finish(), imgs


@pytest.fixture(scope="module")
def clip():
    return make_clip()


REFERENCES = [("numpy", "auto"), ("jax", "pallas")]


@pytest.mark.parametrize("backend, kernel", REFERENCES)
def test_decoder_matches_reference(clip, backend, kernel):
    assert_matches_reference(*clip, backend, kernel)


@pytest.mark.parametrize("backend, kernel", REFERENCES)
def test_legacy_decoder_matches_reference(backend, kernel):
    """Codec 6, at a ragged padded width (1000 pads to 1024)."""
    assert_matches_reference(*make_clip(seed=3, h=8, w=1000, codec=6),
                             backend, kernel)


@pytest.mark.parametrize("backend, kernel", REFERENCES)
def test_mixed_codec_decoder_matches_reference(backend, kernel):
    assert_matches_reference(*make_clip(seed=4, num_frames=4, codec="mixed"),
                             backend, kernel)


def assert_matches_reference(blob, imgs, backend, kernel):
    ref = JaxDecoder(blob, backend=backend, kernel=kernel)
    with Decoder(blob, device="cpu") as d:
        assert d.device == torch.device("cpu")
        assert d.frames == d.get_frames() == ref.frames
        assert d.container_metadata == ref.container_metadata
        assert d.typed_metadata.audio_sample_rate == ref.typed_metadata.audio_sample_rate
        assert d.audio_sample_rate_hz() == ref.audio_sample_rate_hz()
        assert d.num_audio_channels() == ref.num_audio_channels()
        for (ta, sa), (tb, sb) in zip(d.load_audio(), ref.load_audio(), strict=True):
            assert ta == tb and np.array_equal(sa, sb)
        for (ta, sa), (tb, sb) in zip(d.audio_chunks(), ref.audio_chunks(), strict=True):
            assert ta == tb and np.array_equal(sa, sb)
        for ts, img in zip(d.frames, imgs, strict=True):
            got, meta = d.load_frame(ts)
            want, ref_meta = ref.load_frame(ts)
            assert got.dtype == np.uint16 and meta == ref_meta
            assert np.array_equal(got, np.asarray(want))
            assert np.array_equal(got, img)


def test_load_frame_device_returns_tensor(clip):
    blob, imgs = clip
    d = Decoder(blob, device="cpu")
    img, meta = d.load_frame_device(d.frames[0])
    assert isinstance(img, torch.Tensor)
    assert img.dtype == torch.uint16 and img.device.type == "cpu"
    assert meta["width"] == 192
    assert np.array_equal(img.numpy(), imgs[0])


def _single_frame(payload, w=128, h=8, codec=7):
    writer = E.ContainerWriter(example_container_metadata())
    writer.add_frame(1, payload, example_frame_metadata(w, h, codec))
    return writer.finish()


def test_truncated_frame_raises_reference_text():
    img = np.random.default_rng(1).integers(0, 4096, size=(8, 128), dtype=np.uint16)
    blob = _single_frame(E.encode_modern(img)[:40])
    with pytest.raises(IOException, match="^Failed to uncompress frame$") as got:
        Decoder(blob, device="cpu").load_frame(1)
    assert isinstance(got.value.__cause__, DecodeError)
    with pytest.raises(JE.IOException, match="^Failed to uncompress frame$"):
        JaxDecoder(blob, backend="numpy").load_frame(1)


LEGACY_TEXT = "^Failed to uncompress legacy frame$"


@pytest.mark.parametrize("keep", [1, 200, -2])
def test_truncated_legacy_frame_raises_reference_text(keep):
    """Cut inside the first header, inside the chain, and just before the
    mandatory trailing byte."""
    img = np.random.default_rng(1).integers(0, 4096, size=(8, 128), dtype=np.uint16)
    blob = _single_frame(E.encode_legacy(img, add_offset_table=False)[:keep],
                         codec=6)
    with pytest.raises(IOException, match=LEGACY_TEXT) as got:
        Decoder(blob, device="cpu").load_frame(1)
    assert isinstance(got.value.__cause__, DecodeError)
    with pytest.raises(JE.IOException, match=LEGACY_TEXT):
        JaxDecoder(blob, backend="numpy").load_frame(1)


@pytest.mark.parametrize("w, h", [(0, 8), (128, 0)])
def test_degenerate_geometry_raises_reference_text(w, h):
    img = np.random.default_rng(2).integers(0, 4096, size=(8, 128), dtype=np.uint16)
    blob = _single_frame(E.encode_modern(img), w=w, h=h)
    with pytest.raises(IOException, match="^Failed to uncompress frame$"):
        Decoder(blob, device="cpu").load_frame(1)
    with pytest.raises(JE.IOException, match="^Failed to uncompress frame$"):
        JaxDecoder(blob, backend="numpy").load_frame(1)


@pytest.mark.parametrize("w, h", [(0, 8), (128, 0)])
def test_degenerate_legacy_geometry_raises_reference_text(w, h):
    img = np.random.default_rng(2).integers(0, 4096, size=(8, 128), dtype=np.uint16)
    blob = _single_frame(E.encode_legacy(img), w=w, h=h, codec=6)
    with pytest.raises(IOException, match=LEGACY_TEXT):
        Decoder(blob, device="cpu").load_frame(1)
    with pytest.raises(JE.IOException, match=LEGACY_TEXT):
        JaxDecoder(blob, backend="numpy").load_frame(1)


def test_invalid_compression_type():
    img = np.zeros((4, 64), np.uint16)
    blob = _single_frame(E.encode_modern(img), w=64, h=4, codec=99)
    with pytest.raises(IOException, match="Invalid compression type"):
        Decoder(blob, device="cpu").load_frame(1)


def test_legacy_clip_raises_not_ported():
    """The legacy codec is ported: a legacy clip raises nothing and decodes
    exactly, on the host and as a tensor."""
    blob, imgs = make_clip(num_frames=2, codec=6)
    d = Decoder(blob, device="cpu")
    assert len(d.frames) == 2
    for ts, img in zip(d.frames, imgs, strict=True):
        got, meta = d.load_frame(ts)
        assert meta["compressionType"] == 6
        assert got.dtype == np.uint16 and np.array_equal(got, img)
        t, _ = d.load_frame_device(ts)
        assert t.dtype == torch.uint16 and np.array_equal(t.numpy(), img)


def test_cuda_without_card_raises(clip, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MotionCamException, match="no CUDA device"):
        Decoder(clip[0], device="cuda")


def test_unknown_device_raises(clip):
    with pytest.raises(ValueError, match="unsupported device"):
        Decoder(clip[0], device="meta")

