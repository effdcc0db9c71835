"""The frozen reference against the frozen encoder, on small frames of both
codecs; the frozen encoder and the reference's develop model against the
program's, so that both sides start from the same inputs and the reference
says what the program's documents say."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench import encode, frames, spec
from gpubench.ref import codec, develop, tables

SHAPES = [(24, 192), (30, 250), (8, 64), (64, 512)]


def images(h, w, seed=3):
    rng = np.random.default_rng(seed)
    yield frames.image(h, w, 1, seed, "mix", 12)
    yield frames.image(h, w, 2, seed, "mix", 10)
    yield rng.integers(0, 1 << 16, (h, w), dtype=np.uint16)  # every width up to 16 bits
    yield np.full((h, w), 5000, np.uint16)  # references above 12 bits
    img = rng.integers(0, 1 << 16, (h, w), dtype=np.uint16)
    img[: h // 2] = 7
    yield img


@pytest.mark.parametrize("codec_name", ["modern", "legacy"])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_decodes_the_encoder_exactly(codec_name, shape):
    h, w = shape
    for img in images(h, w):
        payload = np.frombuffer(encode.encode(img, codec_name), np.uint8)
        got = codec.decode(payload, codec_name, w, h)
        assert got.dtype == torch.int32 and got.shape == (h, w)
        np.testing.assert_array_equal(got.numpy(), img.astype(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_encoder_writes_the_programs_bytes(shape):
    from mcraw_torch import encode as program

    for img in images(*shape):
        assert encode.encode_modern(img) == program.encode_modern(img)
        assert encode.encode_legacy(img) == program.encode_legacy(img)


def test_legacy_chain_raises_where_the_serial_walk_does():
    img = frames.image(8, 64, 0, 1, "mix", 12)
    payload = np.frombuffer(encode.encode_legacy(img), np.uint8)
    nblk = 8 * 2 * 2
    data = torch.from_numpy(payload.copy())
    heads = codec.legacy_chain(data, nblk)
    assert heads[0] == 0 and bool((heads[1:] > heads[:-1]).all())
    last = int(heads[-1])
    end = last + 2 + int(tables.LEGACY_BLOCK_LENGTH[payload[last] >> 4])
    # The serial walk needs one byte past the last block (a `>=` check).
    codec.legacy_chain(data[: end + 1], nblk)
    with pytest.raises(codec.DecodeError):
        codec.legacy_chain(data[:end], nblk)


@pytest.mark.parametrize("demosaic", ["bilinear", "malvar"])
def test_develop_model_is_the_programs_f64_model(demosaic):
    from mcraw_torch import preview

    g = frames.grade(spec.load("modern-grade").config)
    raw = frames.image(20, 36, 0, 5, "mix", 12)
    cfa = (2, 1, 1, 0)
    fwd = np.reshape(g["forward"], (3, 3))
    want = preview.develop_f64(raw, g["black"], g["white"], g["neutral"], fwd, cfa,
                               demosaic=demosaic)
    got = develop.develop(torch.from_numpy(raw.astype(np.int32)), g["black"], g["white"],
                          g["neutral"], fwd, cfa, demosaic)
    np.testing.assert_array_equal(got.numpy(), want)
    low = develop.develop(torch.from_numpy(raw.astype(np.int32)), g["black"], g["white"],
                          g["neutral"], fwd, cfa, demosaic, dtype=torch.bfloat16)
    assert int((low - got).abs().max()) > 1, "the control's precision must be seen"
