"""mcraw_torch.soak, the standing differential soak of the port, on the CPU.

- Each generator the soak copies gives the same arrays and bytes as its
  original in ``tools/`` for the same seed (the draws in the same order).
- Each decode leg at fixed seeds: the port's plain CPU paths against
  ``mcraw.kernels.numpy_ref`` (the same array, or both raise), at the
  Decoder boundary against ``mcraw.Decoder(backend="numpy")`` (the same
  array, or the same exception class and text), on a sample against the
  JAX XLA path (``mcraw.kernels.unpack.decode_*_device``), and the leg's
  own checks report nothing.
- Noncanonical payloads of the mutation leg through the JAX package's
  Pallas entry points in interpret mode, against the port.

Tolerance 0 everywhere: the codecs are lossless.
"""

import struct

import numpy as np
import pytest
import torch

from mcraw import encode as JE
from mcraw.kernels import numpy_ref as NR
from mcraw.pipeline import Decoder as JaxDecoder
from mcraw_torch import soak as S
from mcraw_torch import codecs
from mcraw_torch.pipeline import Decoder
from tools import soak_differential as TD
from tools import soak_mutation as TM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The frames are small: more intra-op threads only contend with the
    other test workers' (the soak's children run with one too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outcome(fn):
    """(array, None) or (None, exception class name and text)."""
    try:
        return np.asarray(fn()), None
    except Exception as e:  # noqa: BLE001 - the exception is the outcome
        return None, (type(e).__name__, str(e))


# -- the generators against their originals ----------------------------------------


@pytest.mark.parametrize("seed", range(10))
def test_random_image_equals_tools(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    h, w = 4 + 4 * seed, 16 + 37 * seed
    assert np.array_equal(S.random_image(a, h, w), TD.random_image(b, h, w))
    assert a.integers(0, 1 << 30) == b.integers(0, 1 << 30)  # the same draws


@pytest.mark.parametrize("seed", range(6))
def test_bayer_scene_equals_tools(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    assert np.array_equal(S.bayer_scene(a, 24, 70), TM.bayer_scene(b, 24, 70))
    assert a.integers(0, 1 << 30) == b.integers(0, 1 << 30)


@pytest.mark.parametrize("cap_bits, cap_ref", [(16, 0xFFFF), (15, 0x0FFF)])
def test_make_coder_equals_tools(cap_bits, cap_ref):
    """The coder's (bits, refs) choices, seen through both encoders: the
    same payload bytes for the same seed."""
    img = np.random.default_rng(5).integers(0, 1 << 16, (12, 130), np.uint16)
    mine = S.make_coder(np.random.default_rng(9), cap_bits=cap_bits, cap_ref=cap_ref,
                        wrap_ok=True)
    theirs = TM.make_coder(np.random.default_rng(9), cap_bits=cap_bits, cap_ref=cap_ref,
                           wrap_ok=True)
    if cap_bits == 16:
        a = S.E.encode_modern(img, coder=mine)
        b = JE.encode_modern(img, coder=theirs)
    else:
        a = S.E.encode_legacy(img, coder=mine)
        b = JE.encode_legacy(img, coder=theirs)
    assert a == b


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_make_phone_coder_equals_tools(legacy, seed):
    img = TM.bayer_scene(np.random.default_rng(seed), 16, 200)
    mine = S.make_phone_coder(np.random.default_rng(seed + 50), legacy=legacy)
    theirs = TM.make_phone_coder(np.random.default_rng(seed + 50), legacy=legacy)
    enc_a = S.E.encode_legacy if legacy else S.E.encode_modern
    enc_b = JE.encode_legacy if legacy else JE.encode_modern
    assert enc_a(img, coder=mine) == enc_b(img, coder=theirs)


def _tools_codec_iteration(rng):
    """One iteration of tools/soak_differential.py's loop (:82-141)."""
    h = int(rng.integers(4, 200)) & ~3 or 4
    w = int(rng.integers(16, 700))
    img = TD.random_image(rng, h, w)
    ew = (w + 63) // 64 * 64 + 64 * int(rng.integers(0, 3))
    eh = (h + 3) // 4 * 4 + 4 * int(rng.integers(0, 3))
    modern = JE.encode_modern(img, encoded_width=ew, encoded_height=eh)
    table = bool(rng.integers(0, 2))
    crows = None if rng.integers(0, 2) else int(rng.integers(1, h + 4))
    legacy = JE.encode_legacy(img, chunk_rows=crows, add_offset_table=table)
    return img, modern, legacy


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_case_equals_tools(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        m, lg = S.codec_case(a)
        img, modern, legacy = _tools_codec_iteration(b)
        assert np.array_equal(m.frame.source, img) and np.array_equal(lg.frame.source, img)
        assert m.frame.payload == modern and lg.frame.payload == legacy
        assert (m.frame.height, m.frame.width) == img.shape
    assert a.integers(0, 1 << 30) == b.integers(0, 1 << 30)


def _tools_mutation_iteration(rng, iters):
    """One iteration of tools/soak_mutation.py's loop (:177-266)."""
    h = int(rng.integers(4, 120)) & ~3 or 4
    w = int(rng.integers(16, 500))
    phone = iters % 2 == 0
    if phone:
        img = TM.bayer_scene(rng, h, w)
        pitch = int(rng.choice([64, 128, 256, 512]))
        ew = -(-w // pitch) * pitch
        rowg = int(rng.choice([4, 8, 16, 32]))
        eh = -(-h // rowg) * rowg
        gaps, meta_tail, meta_coder = (b"", b""), None, None
        main_coder = TM.make_phone_coder(rng, legacy=False)
    else:
        img = TM.random_image(rng, h, w)
        ew = (w + 63) // 64 * 64 + 64 * int(rng.integers(0, 3))
        eh = h + int(rng.integers(0, 9))
        gaps = (rng.bytes(int(rng.integers(0, 64))), rng.bytes(int(rng.integers(0, 64))))
        meta_tail = rng.integers(0, 1 << 16, size=int(rng.integers(0, 64)), dtype=np.uint16)
        main_coder = TM.make_coder(rng, cap_bits=16, cap_ref=0xFFFF, wrap_ok=True)
        meta_coder = TM.make_coder(rng, cap_bits=15, cap_ref=0x0FFF, wrap_ok=True)
    modern = JE.encode_modern(img, encoded_width=ew, encoded_height=eh, coder=main_coder,
                              meta_coder=meta_coder, meta_tail=meta_tail, gaps=gaps)
    leg_coder = (TM.make_phone_coder(rng, legacy=True) if phone
                 else TM.make_coder(rng, cap_bits=15, cap_ref=0x0FFF, wrap_ok=True))
    table = bool(rng.integers(0, 2))
    crows = None if rng.integers(0, 2) else int(rng.integers(1, h + 4))
    legacy = JE.encode_legacy(img, chunk_rows=crows, add_offset_table=table, coder=leg_coder)
    return img, modern, legacy


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mutation_case_equals_tools(seed):
    """Both flavours: noncanonical on odd iterations, phone on even."""
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for it in (1, 2, 3, 4):
        m, lg = S.mutation_case(a, it)
        img, modern, legacy = _tools_mutation_iteration(b, it)
        assert np.array_equal(m.frame.source, img)
        assert m.frame.payload == modern and lg.frame.payload == legacy
        assert m.frame.what == ("phone" if it % 2 == 0 else "noncanonical")
    assert a.integers(0, 1 << 30) == b.integers(0, 1 << 30)


@pytest.mark.parametrize("kind", ["bits_off", "refs_off", "enc_w_mod", "enc_w_small"])
def test_malformed_header_edits_are_the_pins(kind):
    """The four header edits of tests/test_malformed_parity.py:89-104, as
    the malformed leg draws them."""
    img = np.random.default_rng(1).integers(0, 4096, (16, 192), np.uint16)
    p = S.E.encode_modern(img)
    ew, eh, bo, ro = struct.unpack("<IIII", p[:16])
    want = {"bits_off": (ew, eh, len(p) + 1, ro), "refs_off": (ew, eh, bo, len(p) + 1),
            "enc_w_mod": (ew + 3, eh, bo, ro), "enc_w_small": (64, eh, bo, ro)}[kind]
    rng = np.random.default_rng(0)
    for _ in range(200):  # the draw of `kind` among the modern mutations
        got = S.malform(rng, S.Frame(7, p, 192, 16, img), ew, eh)
        if got.what == kind:
            break
    assert struct.unpack("<IIII", got.payload[:16]) == want
    assert got.payload[16:] == p[16:] and got.source is None


def test_bits_over_16_keeps_the_stream_decodable():
    """bits values above 16 re-encoded into the bits stream: the stream
    still parses, the entries read back as written, and where every entry
    changed was of the 16-bit class the frame still decodes exactly."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 1 << 16, (8, 128), np.uint16)
    p = S.E.encode_modern(img)
    for _ in range(5):
        q, exact = S.with_bits_over_16(rng, p)
        data = np.frombuffer(q, np.uint8)
        bits, _ = S.native.decode_metadata_stream(data, struct.unpack("<I", q[8:12])[0])
        assert bits.max() > 16 and exact  # full-range blocks: all of the 16-bit class
        assert np.array_equal(NR.decode_modern(data, 128, 8), img)
        assert np.array_equal(codecs.decode_modern(data, 128, 8, device="cpu"), img)


def test_batch_with_a_payload_shorter_than_its_header(tmp_path):
    """A truncation can leave a modern payload shorter than the 8 bytes of
    its encoded geometry. The batch paths' expectation must not read that
    geometry: the malformed leg died there on the card (seed 9, iteration
    4364: a 7-byte payload among 257 x 4 frames), a fault of the soak, not
    of the port. Every path then gives the plain outcome."""
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 4096, (4, 257), np.uint16) for _ in range(2)]
    good = [S.Frame(7, S.E.encode_modern(img), 257, 4, img, "extra") for img in imgs]
    frames = [S.Frame(7, good[0].payload[:7], 257, 4, None, "truncate"), good[1]]
    assert S.encoded_tiles(frames[0]) is None and S.encoded_tiles(frames[1]) == (1, 5)
    runner = S.Leg("malformed", 1, "cpu", tmp_path)
    runner.iteration = 1
    runner.clip, stamps = S.write_clip(frames)
    runner.frames = dict(zip(stamps, frames))
    runner.outcomes = {ts: runner._plain(f) for ts, f in runner.frames.items()}
    runner.drive_group(Decoder(runner.clip, "cpu"), stamps)
    assert runner.failures == 0
    assert runner.paths["decode_batch"]["calls"] == 1


# -- the legs against the JAX package -----------------------------------------------


def _leg(leg, seed, tmp_path, iterations):
    runner = S.Leg(leg, seed, "cpu", tmp_path)
    for _ in range(iterations):
        runner.step()
        yield runner


@pytest.mark.parametrize("leg", S.DECODE_LEGS)
@pytest.mark.parametrize("seed", [3, 4])
def test_leg_equals_numpy_ref(leg, seed, tmp_path):
    """Every frame of 4 iterations: the port's plain outcome equals
    numpy_ref's (same array, or both raise DecodeError); the leg's own
    checks (every path against the plain path, the source where the
    payload is format-legal) report nothing."""
    seen = set()
    for runner in _leg(leg, seed, tmp_path, 4):
        for ts, f in runner.frames.items():
            ref = NR.decode_modern if f.codec == 7 else NR.decode_legacy
            arr, err = _outcome(lambda: ref(f.data, f.width, f.height))
            mine = runner.outcomes[ts]
            if err:
                assert mine.error and mine.error[0] == err[0] == "DecodeError", (f.what, err)
            else:
                assert mine.error is None and np.array_equal(mine.arrays[0], arr), f.what
            seen.add(f.what)
        assert runner.failures == 0
    assert runner.iteration == 4 and not list(tmp_path.glob("FAIL_*"))
    if leg == "malformed":
        assert len(seen) >= 4


@pytest.mark.parametrize("leg", S.DECODE_LEGS)
def test_leg_at_the_decoder_equals_jax_decoder(leg, tmp_path):
    """The iteration's clip through mcraw.Decoder(backend="numpy") and the
    port's CPU Decoder, frame by frame: the same array, or the same
    exception class and text (the reference's outer IOException text)."""
    for runner in _leg(leg, 8, tmp_path, 4):
        ours, theirs = Decoder(runner.clip, "cpu"), JaxDecoder(runner.clip, backend="numpy")
        for ts in runner.frames:
            a, ea = _outcome(lambda: ours.load_frame(ts)[0])
            b, eb = _outcome(lambda: theirs.load_frame(ts)[0])
            assert ea == eb
            assert ea or np.array_equal(a, b)


@pytest.mark.parametrize("leg", S.DECODE_LEGS)
def test_leg_sample_equals_jax_xla_path(leg, tmp_path):
    """One iteration's case frames through the JAX package's XLA path
    (``mcraw.kernels.unpack.prepare_*`` + ``decode_*_device``, the path
    tools/soak_*.py sample): the same outcome as the port's plain path.
    The XLA path gives only the encoded rows of a short encodedHeight; the
    port's rows past them are zero."""
    from mcraw.kernels import unpack as XU

    runner = next(_leg(leg, 12, tmp_path, 1))
    for ts, f in list(runner.frames.items())[:1] + [
            (t, g) for t, g in runner.frames.items() if g.codec == 6][:1]:
        if f.codec == 7:
            def xla():
                plan = XU.prepare_modern(f.data, f.width, f.height)
                return XU.decode_modern_device(plan.payload, plan.offsets, plan.cls, plan.refs,
                                               tiles_y=plan.tiles_y, tiles_x=plan.tiles_x,
                                               width=f.width, height=f.height)
        else:
            def xla():
                lp = XU.prepare_legacy(f.data, f.width, f.height)
                return XU.decode_legacy_device(lp.payload, lp.offsets, lp.cls, lp.refs,
                                               padded_width=lp.padded_width, width=f.width,
                                               height=f.height)
        arr, err = _outcome(xla)
        mine = runner.outcomes[ts]
        if err:
            assert mine.error and mine.error[0] == err[0], (f.what, err, mine)
            continue
        rows = arr.shape[0]
        assert mine.error is None, (f.what, mine)
        assert np.array_equal(mine.arrays[0][:rows], arr) and not mine.arrays[0][rows:].any()


# -- noncanonical payloads through the Pallas kernels (interpret mode) ---------------


def _noncanonical(seed):
    """A 16 x 192 full-range frame encoded by the mutation leg's coders
    (refs below the minimum, wrap-around refs, nibbles up to 15 or 16, junk
    gaps and stream tails): (image, modern payload, legacy payload)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 1 << 16, size=(16, 192), dtype=np.uint16)
    modern = S.E.encode_modern(
        img, coder=S.make_coder(rng, cap_bits=16, cap_ref=0xFFFF, wrap_ok=True),
        meta_coder=S.make_coder(rng, cap_bits=15, cap_ref=0x0FFF, wrap_ok=True),
        meta_tail=rng.integers(0, 1 << 16, size=17, dtype=np.uint16),
        gaps=(rng.bytes(11), rng.bytes(5)))
    legacy = S.E.encode_legacy(img, coder=S.make_coder(rng, cap_bits=15, cap_ref=0x0FFF,
                                                       wrap_ok=True))
    return img, np.frombuffer(modern, np.uint8), np.frombuffer(legacy, np.uint8)


@pytest.mark.parametrize("entry", ["modern_v5", "modern_v6", "legacy_v5", "legacy_v6"])
def test_noncanonical_through_pallas_equals_port(entry):
    """As tests/test_malformed_parity.py:212-265 runs the Pallas entry
    points, held against the port's plain path on the same payload."""
    import jax.numpy as jnp

    from mcraw.kernels import pallas_legacy as PL
    from mcraw.kernels import pallas_unpack as PK

    img, modern, legacy = _noncanonical(21)
    h, w = img.shape
    if entry == "modern_v5":
        out = PK.decode_modern_pallas(modern, w, h, interpret=True)
    elif entry == "modern_v6":
        p32, bits, refs, ty, tx, (rows, sub_rows, nf) = PK.prepare_modern_light(modern, w, h)
        out = PK.decode_modern_device_v6.__wrapped__(
            jnp.asarray(p32), jnp.asarray(bits), jnp.asarray(refs), ty=ty, tx=tx, height=h,
            width=w, rows=rows, sub_rows=sub_rows, nfields=nf, interpret=True)
    elif entry == "legacy_v5":
        out = PL.decode_legacy_pallas_v5(legacy, w, h, interpret=True)
    else:
        lp32, offs, lbits, lrefs, pw, lrows = PL.prepare_legacy_light(legacy, w, h)
        out = PL.decode_legacy_device_v6.__wrapped__(
            jnp.asarray(lp32), jnp.asarray(offs), jnp.asarray(lbits),
            jnp.asarray(np.asarray(lrefs, np.int32)), pw=pw, h=h, width=w, rows=lrows,
            interpret=True)
    port = (codecs.decode_modern(modern, w, h, device="cpu") if entry.startswith("modern")
            else codecs.decode_legacy(legacy, w, h, device="cpu"))
    assert np.array_equal(np.asarray(out), port) and np.array_equal(port, img)
