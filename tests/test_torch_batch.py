"""mcraw_torch's batched decode on the CPU against the JAX package: the
Decoder's decode_batch / decode_batch_iter / make_frame_decoder, the JAX
package's six batch entry points (Pallas in interpret mode, or its XLA
batch path) routed to the port's batched decode, the batched preview_clip,
the batched plain versions against their single-frame ones, and the
repairs that came with the slice (the CPU codecs, the audio loader, the
container accessor). Tolerance: 0 for every decode (the codecs are
lossless and integer-only); <= 1 LSB per channel for develop against the
JAX package, 0 against the port's own preview_frame_rgba. The batched CUDA
kernels are checked on the card by test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mcraw
from mcraw import encode as E
from mcraw import errors as JX
from mcraw import parallel as JPAR
from mcraw import preview as JPV
from mcraw.kernels import pallas_legacy as PL
from mcraw.kernels import pallas_unpack as PK
from mcraw.kernels import tables as JT
from mcraw.kernels import unpack as JU
from mcraw.metadata import example_container_metadata, example_frame_metadata
from mcraw.pipeline import Decoder as JaxDecoder

import mcraw_torch
from mcraw_torch import Decoder
from mcraw_torch import preview as P
from mcraw_torch.errors import DecodeError, IOException
from mcraw_torch.kernels import legacy as L
from mcraw_torch.kernels import offsets as O
from mcraw_torch.kernels import staging as S
from mcraw_torch.kernels import unpack as U
from mcraw_torch.kernels.staging import Staging
from mcraw_torch.kernels.tables import modern_tables
from mcraw_torch.kernels.unpack import decode_modern_batch

CPU = torch.device("cpu")


def frames_of(seed, specs):
    """Images for (codec, width, height[, encoded rows]) specs; a modern
    frame with fewer encoded rows than its height has a short
    encodedHeight (the rows past 4*ceil(rows/4) decode as zeros)."""
    rng = np.random.default_rng(seed)
    out = []
    for codec, w, h, *enc in specs:
        rows = enc[0] if enc else h
        img = rng.integers(0, 4096, size=(rows, w), dtype=np.uint16)
        payload = E.encode_modern(img) if codec == 7 else E.encode_legacy(img)
        full = np.zeros((h, w), np.uint16)
        full[:rows] = img
        out.append((codec, w, h, payload, full))
    return out


def clip_of(frames, cm=None):
    writer = E.ContainerWriter(cm or example_container_metadata())
    rng = np.random.default_rng(len(frames))
    for i, (codec, w, h, payload, _) in enumerate(frames):
        writer.add_frame(100 + i, payload, example_frame_metadata(w, h, codec))
        writer.add_audio(rng.integers(-99, 99, size=64).astype(np.int16), i * 1000)
    return writer.finish()


# (codec, width, height[, encoded rows]): the sizes of the slice's tests.
HOMOGENEOUS = {
    "modern 256x16": [(7, 256, 16)] * 3,
    "modern 250x16": [(7, 250, 16)] * 3,
    "modern 4000x8 short": [(7, 4000, 8, 4)] * 2,
    "legacy 256x16": [(6, 256, 16)] * 3,
    "legacy 250x16": [(6, 250, 16)] * 3,
}
# tests/test_pipeline.py::test_decode_batch_iter_heterogeneous's clip.
HETEROGENEOUS = [(7, 128, 16), (7, 128, 16), (6, 128, 16), (7, 256, 32),
                 (7, 256, 32), (6, 256, 32), (6, 256, 32)]


@pytest.mark.parametrize("name", HOMOGENEOUS)
def test_decode_batch_equals_jax_decoder(name):
    frames = frames_of(list(HOMOGENEOUS).index(name), HOMOGENEOUS[name])
    blob = clip_of(frames)
    d = Decoder(blob, device="cpu")
    imgs, metas = d.decode_batch()
    ref_imgs, ref_metas = JaxDecoder(blob, backend="jax").decode_batch()
    ref_imgs = np.asarray(ref_imgs)
    assert imgs.dtype == torch.uint16 and imgs.device == CPU
    assert imgs.shape == (len(frames), frames[0][2], frames[0][1])
    assert metas == ref_metas
    # The JAX package's batch crops a short encodedHeight to the rows that
    # exist; its load_frame, like the port, keeps (H, W) with zero rows.
    rows = ref_imgs.shape[1]
    assert rows == (4 if "short" in name else frames[0][2])
    assert np.array_equal(imgs.numpy()[:, :rows], ref_imgs)
    ref = JaxDecoder(blob, backend="jax")
    for img, ts in zip(imgs.numpy(), d.frames, strict=True):
        assert np.array_equal(img, np.asarray(ref.load_frame(ts)[0]))
    assert np.array_equal(imgs.numpy(), np.stack([f[4] for f in frames]))


@pytest.mark.parametrize("chunk", [1, 2, 4, 16])
def test_decode_batch_iter_heterogeneous_equals_jax(chunk):
    frames = frames_of(7, HETEROGENEOUS)
    blob = clip_of(frames)
    d = Decoder(blob, device="cpu")
    ref = JaxDecoder(blob, backend="jax")
    got = list(d.decode_batch_iter(chunk_frames=chunk))
    want = list(ref.decode_batch_iter(chunk_frames=chunk))
    assert [m for _, m in got] == [m for _, m in want]
    for (a, _), (b, _) in zip(got, want, strict=True):
        assert np.array_equal(a.numpy(), np.asarray(b))
    flat = [img for imgs, _ in got for img in imgs.numpy()]
    assert all(np.array_equal(a, f[4]) for a, f in zip(flat, frames, strict=True))


def test_decode_batch_iter_timestamps_and_runs():
    """A subset of timestamps, in stream order; runs never merge frames of
    different (codec, width, height) and chunk_frames <= 0 raises as in the
    JAX package."""
    frames = frames_of(8, HETEROGENEOUS)
    blob = clip_of(frames)
    d = Decoder(blob, device="cpu")
    ts = d.frames[3:]
    sizes = [imgs.shape[0] for imgs, _ in d.decode_batch_iter(ts, chunk_frames=3)]
    ref = [np.asarray(i).shape[0] for i, _ in
           JaxDecoder(blob, backend="jax").decode_batch_iter(ts, chunk_frames=3)]
    assert sizes == ref == [2, 1, 1]
    assert d._homogeneous_runs(d.frames) == [[100, 101], [102], [103, 104], [105, 106]]
    for bad in (0, -1):
        with pytest.raises(ValueError, match="chunk_frames must be positive"):
            list(d.decode_batch_iter(chunk_frames=bad))
        with pytest.raises(ValueError, match="chunk_frames must be positive"):
            list(JaxDecoder(blob, backend="jax").decode_batch_iter(chunk_frames=bad))


@pytest.mark.parametrize(
    "specs, port_error, jax_error, text",
    [
        ([(7, 128, 16), (6, 128, 16)], IOException, JX.IOException,
         "mixed codecs in one batch"),
        ([(7, 128, 16), (7, 256, 16)], ValueError, ValueError, "share geometry"),
        ([(6, 128, 16), (6, 256, 16)], ValueError, ValueError, "share geometry"),
        # Same (width, height), different encodedHeight: mixed encoded tiles.
        ([(7, 128, 16), (7, 128, 16, 8)], ValueError, ValueError, "share geometry"),
    ],
)
def test_decode_batch_errors_equal_jax(specs, port_error, jax_error, text):
    blob = clip_of(frames_of(9, specs))
    with pytest.raises(port_error, match=text):
        Decoder(blob, device="cpu").decode_batch()
    with pytest.raises(jax_error, match=text):
        JaxDecoder(blob, backend="jax").decode_batch()


def test_decode_batch_of_no_frames_raises_as_jax():
    blob = clip_of(frames_of(10, [(7, 128, 16)]))
    with pytest.raises(IndexError):
        Decoder(blob, device="cpu").decode_batch([])
    with pytest.raises(IndexError):
        JaxDecoder(blob, backend="jax").decode_batch([])


@pytest.mark.parametrize("codec", [7, 6])
def test_decode_batch_bad_frame_raises_load_frame_text(codec):
    """A truncated frame in a batch raises what load_frame_device raises for
    it: the reference's uncompress text, the diagnosis on __cause__."""
    frames = frames_of(11, [(codec, 128, 8)] * 3)
    codec, w, h, payload, img = frames[1]
    frames[1] = (codec, w, h, payload[: len(payload) // 2], img)
    d = Decoder(clip_of(frames), device="cpu")
    with pytest.raises(IOException) as single:
        d.load_frame_device(d.frames[1])
    with pytest.raises(IOException) as batch:
        d.decode_batch()
    assert str(batch.value) == str(single.value)
    assert str(batch.value).startswith("Failed to uncompress")
    assert isinstance(batch.value.__cause__, DecodeError)


# -- the JAX package's batch entry points, routed to the port's batched decode


def modern_payloads(seed, n, h, w, maxv=4095):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, maxv + 1, size=(h, w), dtype=np.uint16) for _ in range(n)]
    return imgs, [np.frombuffer(E.encode_modern(i), np.uint8) for i in imgs]


def legacy_payloads(seed, n, h, w, maxv=4095):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, maxv + 1, size=(h, w), dtype=np.uint16) for _ in range(n)]
    return imgs, [np.frombuffer(E.encode_legacy(i), np.uint8) for i in imgs]


SHAPES = [(16, 256), (16, 250)]


@pytest.mark.parametrize("shape", SHAPES)
def test_routes_decode_modern_device_v6_batch(shape):
    h, w = shape
    imgs, payloads = modern_payloads(20 + w, 3, h, w)
    lights = [PK.prepare_modern_light(p, w, h) for p in payloads]
    rmax = max(len(li[0]) for li in lights)
    p32s = np.zeros((len(lights), rmax), dtype=np.int32)
    for i, li in enumerate(lights):
        p32s[i, : len(li[0])] = li[0]
    want = np.asarray(PK.decode_modern_device_v6_batch(
        jnp.asarray(p32s), jnp.asarray(np.stack([li[1] for li in lights])),
        jnp.asarray(np.stack([li[2] for li in lights])),
        ty=lights[0][3], tx=lights[0][4], height=h, width=w, interpret=True))
    got = decode_modern_batch(payloads, w, h, Staging(CPU)).numpy()
    assert np.array_equal(got, want) and np.array_equal(got, np.stack(imgs))


@pytest.mark.parametrize("entry", ["v5", "v4", "xla"])
@pytest.mark.parametrize("shape", SHAPES)
def test_routes_modern_plan_batches(shape, entry):
    """decode_modern_pallas_batch_v5 (kernel #1), decode_modern_pallas_batch
    (kernel #3) and parallel.decode_frames_batched (the XLA batch path)."""
    h, w = shape
    imgs, payloads = modern_payloads(30 + w, 3, h, w, maxv=65535)
    plans = [JU.prepare_modern(p, w, h) for p in payloads]
    if entry == "v5":
        want = PK.decode_modern_pallas_batch_v5(plans, interpret=True)
    elif entry == "v4":
        want = PK.decode_modern_pallas_batch(plans, interpret=True)
    else:
        want = JPAR.decode_frames_batched(plans, True, mesh=None)
    got = decode_modern_batch(payloads, w, h, Staging(CPU)).numpy()
    assert np.array_equal(got, np.asarray(want)) and np.array_equal(got, np.stack(imgs))


@pytest.mark.parametrize("shape", SHAPES)
def test_routes_decode_legacy_device_v6_batch(shape):
    h, w = shape
    imgs, payloads = legacy_payloads(40 + w, 3, h, w)
    lights = [PL.prepare_legacy_light(p, w, h) for p in payloads]
    rmax = max(len(li[0]) for li in lights)
    p32s = np.zeros((len(lights), rmax), dtype=np.int32)
    for i, li in enumerate(lights):
        p32s[i, : len(li[0])] = li[0]
    want = np.asarray(PL.decode_legacy_device_v6_batch.__wrapped__(
        jnp.asarray(p32s), jnp.asarray(np.stack([li[1] for li in lights])),
        jnp.asarray(np.stack([li[2] for li in lights])),
        jnp.asarray(np.stack([np.asarray(li[3], np.int32) for li in lights])),
        pw=lights[0][4], h=h, width=w, rows=max(li[5] for li in lights),
        interpret=True))
    got = L.decode_legacy_batch(payloads, w, h, Staging(CPU)).numpy()
    assert np.array_equal(got, want) and np.array_equal(got, np.stack(imgs))


@pytest.mark.parametrize("entry", ["v5", "xla"])
@pytest.mark.parametrize("shape", SHAPES)
def test_routes_legacy_plan_batches(shape, entry):
    """decode_legacy_pallas_batch_v5 (kernel #6) and
    parallel.decode_frames_batched (the XLA batch path)."""
    h, w = shape
    imgs, payloads = legacy_payloads(50 + w, 3, h, w, maxv=65535)
    plans = [JU.prepare_legacy(p, w, h) for p in payloads]
    if entry == "v5":
        want = PL.decode_legacy_pallas_batch_v5(plans, interpret=True)
    else:
        want = JPAR.decode_frames_batched(plans, False, mesh=None)
    got = L.decode_legacy_batch(payloads, w, h, Staging(CPU)).numpy()
    assert np.array_equal(got, np.asarray(want)) and np.array_equal(got, np.stack(imgs))


# -- FrameDecoder ---------------------------------------------------------------


@pytest.mark.parametrize("codec", [7, 6])
def test_frame_decoder_equals_jax(codec):
    """Outputs and num_programs against mcraw's make_frame_decoder with
    kernel="pallas" on a homogeneous clip; every call a fresh tensor."""
    frames = frames_of(60 + codec, [(codec, 128, 16)] * 3)
    blob = clip_of(frames)
    fd = Decoder(blob, device="cpu").make_frame_decoder()
    ref = JaxDecoder(blob, backend="jax", kernel="pallas").make_frame_decoder()
    outs = []
    for ts, f in zip(Decoder(blob, device="cpu").frames, frames, strict=True):
        got, meta = fd(ts)
        want, ref_meta = ref(ts)
        assert got.dtype == torch.uint16 and meta == ref_meta
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(got.numpy(), f[4])
        outs.append(got)
    assert fd.num_programs == ref.num_programs == 1
    # Later calls did not overwrite earlier results.
    assert all(np.array_equal(o.numpy(), f[4]) for o, f in zip(outs, frames))


def test_frame_decoder_heterogeneous_keys():
    """One program per (codec, geometry) key; bigger frames of a key after
    smaller ones grow its buffer and still decode exactly."""
    frames = frames_of(70, HETEROGENEOUS + [(7, 128, 16), (6, 256, 32)])
    d = Decoder(clip_of(frames), device="cpu")
    fd = d.make_frame_decoder()
    for ts, f in zip(d.frames, frames, strict=True):
        img, _ = fd(ts)
        assert np.array_equal(img.numpy(), f[4])
    assert fd.num_programs == 4


def test_frame_decoder_errors_equal_load_frame():
    frames = frames_of(71, [(7, 128, 8)] * 2)
    codec, w, h, payload, img = frames[1]
    frames[1] = (codec, w, h, payload[:40], img)
    d = Decoder(clip_of(frames), device="cpu")
    fd = d.make_frame_decoder()
    with pytest.raises(IOException, match="^Failed to uncompress frame$"):
        fd(d.frames[1])
    assert np.array_equal(fd(d.frames[0])[0].numpy(), frames[0][4])


# -- preview_clip on batches -------------------------------------------------


@pytest.fixture(scope="module")
def preview_clip_blob():
    cm = example_container_metadata(sensor="bggr", black_level=(64, 60, 70, 64),
                                    white_level=4095.0)
    return clip_of(frames_of(80, [(7, 128, 16), (7, 128, 16), (6, 128, 16),
                                  (7, 128, 16)]), cm)


@pytest.mark.parametrize("demosaic", ["bilinear", "malvar"])
def test_preview_clip_equals_jax_and_preview_frame(preview_clip_blob, demosaic):
    d = Decoder(preview_clip_blob, device="cpu")
    ts = d.frames[1:]
    got = list(P.preview_clip(d, ts, 2, demosaic=demosaic))
    want = list(JPV.preview_clip(JaxDecoder(preview_clip_blob, backend="jax"), ts, 2,
                                 demosaic=demosaic))
    assert [t for t, _ in got] == [t for t, _ in want] == ts
    for (t, rgba), (_, ref) in zip(got, want, strict=True):
        assert rgba.dtype == torch.uint32 and rgba.shape == (16, 128)
        a = rgba.to(torch.int64).numpy()
        b = np.asarray(ref).astype(np.int64)
        for s in (0, 8, 16, 24):
            assert np.abs(((a >> s) & 0xFF) - ((b >> s) & 0xFF)).max() <= 1
        single = P.preview_frame_rgba(d, t, demosaic=demosaic)
        assert torch.equal(rgba.to(torch.int64), single.to(torch.int64))


def test_preview_clip_takes_the_reference_signature(preview_clip_blob):
    """A positional third argument is batch_frames, as in mcraw."""
    d = Decoder(preview_clip_blob, device="cpu")
    calls = []
    real = d.decode_batch_iter

    def spy(timestamps=None, chunk_frames=16):
        calls.append(chunk_frames)
        return real(timestamps, chunk_frames)

    d.decode_batch_iter = spy
    assert len(list(P.preview_clip(d, None, 3))) == 4
    assert len(list(P.preview_clip(d, batch_frames=1, demosaic="malvar"))) == 4
    assert calls == [3, 1]


# -- the batched plain versions against their single-frame ones -------------------


def random_modern_frames(rng, n, ty, tx):
    nblk = 4 * ty * tx
    words, bits, refs = [], [], []
    for _ in range(n):
        b = rng.integers(0, 1 << 16, size=nblk, dtype=np.uint16)
        size = S.slot_bytes(16 + int(JT.MODERN_BLOCK_LENGTH.take(b, mode="clip").sum()),
                            U.TAIL_BYTES)
        words.append(rng.integers(0, 256, size=size, dtype=np.uint8).view("<i4"))
        bits.append(b)
        refs.append(rng.integers(0, 1 << 16, size=nblk, dtype=np.uint16))
    return words, np.stack(bits), np.stack(refs)


def concat(slots):
    starts, total = S.slot_layout([s.nbytes for s in slots])
    buf = np.concatenate([s.view(np.uint8) for s in slots])
    assert len(buf) == total
    return buf, starts, np.array([s.nbytes for s in slots], np.int64)


@pytest.mark.parametrize("ty, tx, height, width", [(3, 2, 12, 128), (5, 3, 19, 150),
                                                   (2, 2, 13, 128)])
def test_modern_batch_plain_equals_single_calls(ty, tx, height, width):
    """Random words, bits 0..65535 and refs; frame 1's offsets shuffled and
    its last blocks pointed past its own slot: it reads zeros there, not
    frame 2's words, and its neighbours do not change."""
    rng = np.random.default_rng(ty * tx)
    words, bits, refs = random_modern_frames(rng, 3, ty, tx)
    buf, starts, nbytes = concat(words)
    t_bits = torch.from_numpy(bits)
    offs = U.block_offsets(t_bits, modern_tables(CPU))
    assert offs.shape == bits.shape
    offs[1] = offs[1][torch.from_numpy(rng.permutation(bits.shape[1]))]
    offs[1, -3:] = torch.tensor([int(nbytes[1]) - 4, int(nbytes[1]), int(nbytes[1]) + 64])
    kw = dict(ty=ty, tx=tx, height=height, width=width)
    w = torch.from_numpy(buf.view("<i4"))
    batch_args = (w, torch.from_numpy(starts // 4), torch.from_numpy(nbytes // 4), t_bits,
                  torch.from_numpy(refs), offs)
    before = (U.PLAIN_CALLS, U.KERNEL_LAUNCHES)
    got = U.decode_modern_batch_device(*batch_args, **kw)
    assert (U.PLAIN_CALLS, U.KERNEL_LAUNCHES) == (before[0] + 1, before[1])
    assert got.shape == (3, height, width) and got.dtype == torch.uint16
    for f in range(3):
        single = U.decode_modern_plain(torch.from_numpy(words[f]), t_bits[f],
                                       torch.from_numpy(refs[f]), offs[f].contiguous(), **kw)
        assert torch.equal(got[f].to(torch.int32), single.to(torch.int32)), f


@pytest.mark.parametrize("height, width", [(8, 96), (5, 50), (24, 1000), (3, 33)])
def test_legacy_batch_plain_equals_single_calls(height, width):
    rng = np.random.default_rng(height + width)
    nblk = L.num_blocks(width, height)
    payloads, bits, refs, offsets = [], [], [], []
    for _ in range(3):
        b = rng.integers(0, 17, size=nblk).astype(np.int32)
        step = 2 + JT.LEGACY_BLOCK_LENGTH[b].astype(np.int64)
        payloads.append(rng.integers(0, 256, size=int(step.sum()) + 1 + L.TAIL_BYTES,
                                     dtype=np.uint8))
        bits.append(b)
        refs.append(rng.integers(0, 1 << 16, size=nblk).astype(np.uint16))
        offsets.append(np.cumsum(step) - step + 2)
    offsets[1] = offsets[1][rng.permutation(nblk)]
    offsets[1][-3:] = len(payloads[1]) + np.arange(-2, 1)
    slots = [np.concatenate([p, np.zeros(S.slot_bytes(len(p) - L.TAIL_BYTES, L.TAIL_BYTES) - len(p),
                                         np.uint8)]) for p in payloads]
    buf, starts, _ = concat(slots)
    lengths = np.array([len(p) for p in payloads], np.int64)
    args = [torch.from_numpy(a) for a in (buf, starts, lengths, np.stack(bits),
                                          np.stack(refs), np.stack(offsets))]
    kw = dict(height=height, width=width)
    got = L.decode_legacy_batch_device(*args, **kw)
    assert got.shape == (3, height, width)
    for f in range(3):
        single = L.decode_legacy_plain(*(torch.from_numpy(a) for a in (
            payloads[f], bits[f], refs[f], offsets[f])), **kw)
        assert torch.equal(got[f].to(torch.int32), single.to(torch.int32)), f


def test_frame_spans_clamp_to_the_buffer():
    spans = S.frame_spans(torch.tensor([0, 8, -4, 30, 12]), torch.tensor([8, 100, 6, 5, -1]), 20)
    assert spans == [(0, 8), (8, 20), (0, 6), (20, 20), (12, 12)]


def test_empty_words_read_as_zero():
    """A frame whose span is empty reads every word as 0: the plane is its
    references."""
    refs = torch.arange(4, dtype=torch.int64).to(torch.uint16)
    out = U.decode_modern_plain(torch.empty(0, dtype=torch.int32),
                                torch.full((4,), 7, dtype=torch.uint16), refs,
                                torch.zeros(4, dtype=torch.int64), ty=1, tx=1, height=4,
                                width=64)
    assert torch.equal(out.to(torch.int64),
                       U.decode_modern_plain(torch.zeros(64, dtype=torch.int32),
                                             torch.full((4,), 7, dtype=torch.uint16), refs,
                                             torch.zeros(4, dtype=torch.int64), ty=1, tx=1,
                                             height=4, width=64).to(torch.int64))


def test_batch_wrappers_check_inputs_and_never_fall_back():
    frames = frames_of(90, [(7, 128, 8)] * 2)
    payloads = [np.frombuffer(f[3], np.uint8) for f in frames]
    dev = U.stage_modern_batch(Staging(CPU), payloads, 128, 8)
    offs = U.block_offsets(dev.bits, modern_tables(CPU))
    kw = dict(ty=dev.tiles_y, tx=dev.tiles_x, height=8, width=128)
    with pytest.raises(ValueError, match="offsets"):
        U.decode_modern_batch_device(dev.words, dev.bases, dev.lengths, dev.bits, dev.refs,
                                     offs.to(torch.int32), **kw)
    with pytest.raises(ValueError, match="lengths"):
        U.decode_modern_batch_device(dev.words, dev.bases, dev.lengths[:1], dev.bits,
                                     dev.refs, offs, **kw)
    with pytest.raises(ValueError, match="bits"):
        U.decode_modern_batch_device(dev.words, dev.bases, dev.lengths, dev.bits[:, 1:],
                                     dev.refs, offs, **kw)
    before = (U.PLAIN_CALLS, L.PLAIN_CALLS)
    meta = [t.to("meta") for t in (dev.words, dev.bases, dev.lengths, dev.bits, dev.refs, offs)]
    with pytest.raises(ValueError, match="no unpack kernel"):
        U.decode_modern_batch_device(*meta, **kw)
    lmeta = [torch.empty(s, dtype=dt, device="meta") for s, dt in (
        ((64,), torch.uint8), ((1,), torch.int64), ((1,), torch.int64),
        ((1, 32), torch.int32), ((1, 32), torch.uint16), ((1, 32), torch.int64))]
    with pytest.raises(ValueError, match="no legacy unpack kernel"):
        L.decode_legacy_batch_device(*lmeta, height=2, width=256)
    assert (U.PLAIN_CALLS, L.PLAIN_CALLS) == before


def test_batch_host_prep_slots():
    """Each payload sits in its 16-byte aligned slot as a single frame's
    staging (the batch of one) lays it out; geometry mixes raise."""
    frames = frames_of(91, [(7, 192, 8), (7, 192, 8, 4), (7, 192, 8)])
    ok = [np.frombuffer(f[3], np.uint8) for f in (frames[0], frames[2])]
    batch = U.stage_modern_batch(Staging(CPU), ok, 192, 8)
    raw = batch.words.numpy().view(np.uint8)
    for f, p in enumerate(ok):
        single = U.stage_modern(Staging(CPU), p, 192, 8)
        lo = int(batch.bases[f]) * 4
        assert lo % 16 == 0 and batch.lengths[f] == single.words.numel()
        assert np.array_equal(raw[lo : lo + 4 * int(batch.lengths[f])],
                              single.words.numpy().view(np.uint8))
        assert np.array_equal(batch.bits[f].numpy(), single.bits[0].numpy())
    with pytest.raises(ValueError, match="share geometry"):
        U.stage_modern_batch(Staging(CPU), [np.frombuffer(f[3], np.uint8) for f in frames],
                             192, 8)
    lframes = frames_of(92, [(6, 100, 6)] * 3)
    lb = L.stage_legacy_batch(Staging(CPU), [np.frombuffer(f[3], np.uint8) for f in lframes],
                              100, 6)
    for f, (_, _, _, p, _) in enumerate(lframes):
        single = L.stage_legacy(Staging(CPU), np.frombuffer(p, np.uint8), 100, 6)
        lo, n = int(lb.bases[f]), int(single.lengths[0])
        assert lo % 16 == 0 and lb.lengths[f] == n == len(p) + L.TAIL_BYTES
        assert np.array_equal(lb.payload[lo : lo + n].numpy(), single.payload[:n].numpy())
        for rows, one in zip(lb[3:], single[3:]):
            assert np.array_equal(rows[f].numpy(), one[0].numpy())


@pytest.mark.parametrize("spec", [(7, 128, 8), (7, 200, 13), (7, 192, 16, 4), (6, 100, 6),
                                  (6, 96, 8), (6, 33, 5)])
def test_single_frame_views_equal_the_batch_of_one(spec):
    """A frame is the batch of one: decode_*_device and decode_*_plain of
    one frame's loose tensors, and block_offsets_device of its (nblk,)
    bits, equal frame 0 (row 0) of the staged batch of one element for
    element, and the frame decodes exactly."""
    codec, w, h, payload, img = frames_of(93, [spec])[0]
    payload = np.frombuffer(payload, np.uint8)
    if codec == 7:
        bt = U.stage_modern(Staging(CPU), payload, w, h)
        offs = O.block_offsets_device(bt.bits)
        assert offs.shape == bt.bits.shape and bt.bits.shape[0] == 1
        assert torch.equal(O.block_offsets_device(bt.bits[0]), offs[0])
        kw = dict(ty=bt.tiles_y, tx=bt.tiles_x, height=h, width=w)
        batch = U.decode_modern_batch_device(*bt[:5], offs, **kw)
        loose = (bt.words, bt.bits[0], bt.refs[0], offs[0])
        views = (U.decode_modern_device, U.decode_modern_plain)
    else:
        bt = L.stage_legacy(Staging(CPU), payload, w, h)
        kw = dict(height=h, width=w)
        batch = L.decode_legacy_batch_device(*bt, **kw)
        loose = (bt.payload[: bt.lengths[0]], *(t[0] for t in bt[3:]))
        views = (L.decode_legacy_device, L.decode_legacy_plain)
    assert batch.shape == (1, h, w)
    for view in views:
        assert torch.equal(view(*loose, **kw), batch[0]), view.__name__
    assert np.array_equal(batch[0].numpy(), img)


def test_staging_lays_out_aligned_views_and_reuses_its_buffers():
    """Host arrays 16-byte aligned, one upload of all of them with their
    shapes and dtypes; a smaller call reuses the buffers, a larger one
    grows them, and a decoder's later frames do not disturb earlier
    outputs."""
    st = Staging(CPU)
    a, b, c = st.host(((5,), np.uint8), ((2, 3), np.int64), ((0,), np.uint16))
    assert all(x.ctypes.data % 16 == 0 for x in (a, b))
    a[:], b[:] = np.arange(5), [[1, -2, 3], [4, 5, -6]]
    da, db, dc = st.upload()
    assert (da.dtype, db.dtype, dc.dtype) == (torch.uint8, torch.int64, torch.uint16)
    assert db.shape == (2, 3) and dc.shape == (0,)
    assert np.array_equal(da.numpy(), np.arange(5)) and np.array_equal(db.numpy(), b)
    host = st._host
    st.host(((12,), np.int32))
    assert st._host is host
    st.host(((1000,), np.int64))
    assert st._host is not host and st._host.numel() == 8000
    frames = frames_of(95, [(7, 256, 16), (7, 128, 8), (6, 256, 16), (6, 128, 8)])
    d = Decoder(clip_of(frames), device="cpu")
    outs = [d.load_frame_device(ts)[0] for ts in d.frames]
    for out, f in zip(outs, frames, strict=True):
        assert np.array_equal(out.numpy(), f[4])


# -- repairs: the CPU codecs, the audio loader, the container accessor ------------


@pytest.mark.parametrize("shape", [(16, 256), (8, 100), (13, 200)])
def test_codecs_equal_mcraw(shape):
    h, w = shape
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 1 << 16, size=(h, w), dtype=np.uint16)
    for enc, mine, ref in ((E.encode_modern, mcraw_torch.decode_modern, mcraw.decode_modern),
                           (E.encode_legacy, mcraw_torch.decode_legacy, mcraw.decode_legacy)):
        payload = np.frombuffer(enc(img), np.uint8)
        got = mine(payload, w, h, device="cpu")
        assert isinstance(got, np.ndarray) and got.dtype == np.uint16
        assert np.array_equal(got, ref(payload, w, h)) and np.array_equal(got, img)


@pytest.mark.parametrize("codec, cut", [(7, 10), (7, 40), (6, 1), (6, 200), (6, -2)])
def test_codecs_reject_what_mcraw_rejects(codec, cut):
    img = np.random.default_rng(3).integers(0, 4096, size=(8, 128), dtype=np.uint16)
    enc, mine, ref = ((E.encode_modern, mcraw_torch.decode_modern, mcraw.decode_modern)
                      if codec == 7 else
                      (lambda i: E.encode_legacy(i, add_offset_table=False),
                       mcraw_torch.decode_legacy, mcraw.decode_legacy))
    payload = np.frombuffer(enc(img)[:cut], np.uint8)
    with pytest.raises(JX.DecodeError) as want:
        ref(payload, 128, 8)
    with pytest.raises(DecodeError) as got:
        mine(payload, 128, 8, device="cpu")
    if codec == 7:  # the legacy texts are the native scan's, as in load_frame
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("codec", [7, 6])
def test_codecs_run_on_the_card_by_default(monkeypatch, codec):
    """Without device=..., the codecs ask for the card: with none they raise
    the "no CUDA device" MotionCamException (no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.random.default_rng(4).integers(0, 4096, size=(8, 128), dtype=np.uint16)
    enc, mine = ((E.encode_modern, mcraw_torch.decode_modern) if codec == 7
                 else (E.encode_legacy, mcraw_torch.decode_legacy))
    payload = np.frombuffer(enc(img), np.uint8)
    with pytest.raises(mcraw_torch.MotionCamException, match="no CUDA device"):
        mine(payload, 128, 8)
    assert np.array_equal(mine(payload, 128, 8, device="cpu"), img)


def test_codecs_keep_one_staging_per_device(monkeypatch):
    """The codecs keep one Staging per device, not a new one a call, and
    calls from several threads at once each get their own frame back."""
    from concurrent.futures import ThreadPoolExecutor

    from mcraw_torch import codecs

    made = []
    monkeypatch.setattr(codecs, "_STAGINGS", {})
    monkeypatch.setattr(codecs, "Staging", lambda dev: made.append(Staging(dev)) or made[-1])
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 4096, size=(8 + 4 * (i % 3), 128 + 64 * (i % 2)), dtype=np.uint16)
            for i in range(12)]

    def run(i):
        enc, dec = ((E.encode_modern, mcraw_torch.decode_modern) if i % 2
                    else (E.encode_legacy, mcraw_torch.decode_legacy))
        h, w = imgs[i].shape
        return dec(np.frombuffer(enc(imgs[i]), np.uint8), w, h, device="cpu")

    with ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(run, range(len(imgs))))
    assert all(np.array_equal(out, img) for out, img in zip(outs, imgs, strict=True))
    assert len(made) == 1 and codecs._STAGINGS == {CPU: made[0]}


def test_exports_equal_mcraw():
    for name in ("ContainerReader", "ItemType", "COMPRESSION_TYPE", "COMPRESSION_TYPE_LEGACY",
                 "ContainerMetadata", "FrameMetadata", "decode_modern", "decode_legacy",
                 "Decoder"):
        assert hasattr(mcraw_torch, name) and hasattr(mcraw, name)
    assert mcraw_torch.COMPRESSION_TYPE == mcraw.COMPRESSION_TYPE == 7
    assert mcraw_torch.COMPRESSION_TYPE_LEGACY == mcraw.COMPRESSION_TYPE_LEGACY == 6
    assert ({m.name: int(m) for m in mcraw_torch.ItemType}
            == {m.name: int(m) for m in mcraw.ItemType})


def test_container_metadata_and_audio_loader_equal_mcraw():
    blob = clip_of(frames_of(93, [(7, 128, 8)] * 3))
    d, ref = Decoder(blob, device="cpu"), JaxDecoder(blob, backend="numpy")
    assert d.get_container_metadata() == ref.get_container_metadata() == d.container_metadata
    loader = d.load_audio_stream()
    assert d.load_audio_stream() is loader
    rl = ref.load_audio_stream()
    first, ref_first = loader.next(), rl.next()
    assert first[0] == ref_first[0] and np.array_equal(first[1], ref_first[1])
    # The state persists across calls: iteration resumes after the first.
    rest = list(d.load_audio_stream())
    ref_rest = list(ref.load_audio_stream())
    assert len(rest) == len(ref_rest) == 2
    for (ta, sa), (tb, sb) in zip(rest, ref_rest):
        assert ta == tb and np.array_equal(sa, sb)
    assert loader.next() is None and rl.next() is None


def test_audio_loader_does_not_advance_past_a_failed_chunk():
    blob = clip_of(frames_of(94, [(7, 128, 8)] * 3))
    for dec in (Decoder(blob, device="cpu"), JaxDecoder(blob, backend="numpy")):
        reader = dec._reader
        real = reader.audio_chunk
        fail = {"on": True}
        reader.audio_chunk = lambda i: None if (i == 1 and fail["on"]) else real(i)
        loader = dec.load_audio_stream()
        assert loader.next()[0] == 0
        assert loader.next() is None and loader.next() is None  # index stays at 1
        fail["on"] = False
        assert loader.next()[0] == 1000 and loader.next()[0] == 2000
        assert loader.next() is None
