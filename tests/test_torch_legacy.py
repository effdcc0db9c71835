"""mcraw_torch legacy unpack: host scan, plain decode and the kernel's
closed form, held against the NumPy oracle and the JAX package's legacy
Pallas kernels (interpret mode), on the same numpy-seeded inputs. Exact:
the codec is integer-only. The CUDA kernel is checked on the card by
test_torch_gpu.py."""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcraw import encode as E
from mcraw.kernels import numpy_ref as R
from mcraw.kernels import pallas_legacy as PL
from mcraw.kernels import tables as T
from mcraw.kernels import unpack as JU
from mcraw_torch.errors import DecodeError
from mcraw_torch.kernels import legacy as L
from mcraw_torch.kernels import native
from mcraw_torch.kernels.staging import Staging
from mcraw_torch.kernels.tables import legacy_tables

CPU = torch.device("cpu")
SHAPES = [(8, 96), (5, 50), (24, 1000), (16, 1920), (4, 4032)]
LARGE = (128, 8192)  # 65,536 blocks: the parallel scans engage


def bogus_table(payload: np.ndarray) -> np.ndarray:
    """The payload with every trailing chunk-table entry moved one byte
    into its block, so that each segment straddles a block boundary."""
    p = bytearray(payload.tobytes())
    for k, pos in enumerate(R.legacy_chunk_offsets(payload)):
        end = len(p) - 1 - 5 * k
        p[end - 4 : end] = struct.pack(">I", pos + 1)
    return np.frombuffer(bytes(p), np.uint8)


def encode(img: np.ndarray, table: str) -> np.ndarray:
    payload = np.frombuffer(
        E.encode_legacy(img, add_offset_table=table != "none"), np.uint8
    )
    return bogus_table(payload) if table == "bogus" else payload


@pytest.mark.parametrize("table", ["table", "none"])
@pytest.mark.parametrize("maxv", [0, 1, 3, 255, 1023, 4095, 65535])
@pytest.mark.parametrize("shape", SHAPES)
def test_decode_equals_oracle(shape, maxv, table):
    h, w = shape
    rng = np.random.default_rng(h * w + maxv)
    img = rng.integers(0, maxv + 1, size=(h, w), dtype=np.uint16)
    payload = encode(img, table)
    out = L.decode_legacy(payload, w, h, Staging(CPU))
    assert out.dtype == torch.uint16 and out.shape == (h, w)
    assert np.array_equal(out.numpy(), R.decode_legacy(payload, w, h))
    assert np.array_equal(out.numpy(), img)


@pytest.mark.parametrize("shape", [(24, 1000), LARGE])
def test_bogus_table_decodes_exactly(shape, monkeypatch):
    monkeypatch.setattr(native.os, "cpu_count", lambda: 8)
    h, w = shape
    img = np.random.default_rng(5).integers(0, 4096, size=(h, w), dtype=np.uint16)
    payload = encode(img, "bogus")
    good = R.legacy_chunk_offsets(encode(img, "table"))
    assert R.legacy_chunk_offsets(payload) == [p + 1 for p in good]
    out = L.decode_legacy(payload, w, h, Staging(CPU)).numpy()
    assert np.array_equal(out, img)


@pytest.mark.parametrize(
    "table, scan",
    [("table", "parallel"), ("none", "speculative"), ("bogus", "speculative")],
)
def test_large_frame_scan_ladder(table, scan, monkeypatch):
    """At >= 1 << 16 blocks the table-backed scan takes a good table; a
    missing or bogus one goes on to the speculative scan. Both equal the
    serial walk, and the frame decodes exactly."""
    monkeypatch.setattr(native.os, "cpu_count", lambda: 8)  # multicore host
    h, w = LARGE
    assert L.num_blocks(w, h) == L.LEGACY_PARALLEL_MIN_BLOCKS
    img = np.random.default_rng(8).integers(0, 4096, size=(h, w), dtype=np.uint16)
    payload = encode(img, table)
    nblk = L.num_blocks(w, h)
    scanned, got_scan = L.scan_chain(payload, nblk)
    assert got_scan == (scan if native.have_native() else "serial")
    staged = [t[0].numpy() for t in L.stage_legacy(Staging(CPU), payload, w, h)[3:]]
    for got, staged_rows, want in zip(scanned, staged, R.legacy_scan(payload, nblk)):
        assert np.array_equal(got, want) and np.array_equal(staged_rows, want)
    out = L.decode_legacy(payload, w, h, Staging(CPU)).numpy()
    assert np.array_equal(out, img)


@pytest.mark.parametrize("table", ["table", "none"])
@pytest.mark.parametrize("shape", [*SHAPES, LARGE])
def test_host_prep_matches_jax(shape, table):
    """bits, refs and offsets equal the JAX package's two host preps
    (values; the JAX preps narrow offsets to int32, the port keeps int64)."""
    h, w = shape
    img = np.random.default_rng(3).integers(0, 4096, size=(h, w), dtype=np.uint16)
    payload = encode(img, table)
    frame = L.stage_legacy(Staging(CPU), payload, w, h)  # the batch of one
    assert frame.bits.dtype == torch.int32 and frame.refs.dtype == torch.uint16
    assert frame.offsets.dtype == torch.int64
    assert frame.bits.shape == frame.refs.shape == frame.offsets.shape == (1, L.num_blocks(w, h))
    assert (frame.bases.tolist(), frame.lengths.tolist()) == ([0], [len(payload) + L.TAIL_BYTES])
    frame = L.DeviceLegacyBatch(*(t.numpy() for t in frame[:3]),
                                *(t[0].numpy() for t in frame[3:]))
    _p32, offs, bits, refs, _pw, _rows = PL.prepare_legacy_light(payload, w, h)
    assert np.array_equal(frame.bits, bits) and np.array_equal(frame.refs, refs)
    assert np.array_equal(frame.offsets, offs)
    plan = JU.prepare_legacy(payload, w, h)
    assert np.array_equal(T.LEGACY_CLASS_INDEX[frame.bits], plan.cls)
    assert np.array_equal(frame.refs, plan.refs)
    assert np.array_equal(frame.offsets, plan.offsets)
    # Upload buffer: the payload and TAIL_BYTES zeros, the frame's window.
    window = frame.payload[: frame.lengths[0]]
    assert len(window) == len(payload) + L.TAIL_BYTES
    assert np.array_equal(window[: len(payload)], payload)
    assert not window[len(payload):].any()


def _jax_v6(payload, w, h):
    p32, offs, bits, refs, pw, rows = PL.prepare_legacy_light(payload, w, h)
    return PL.decode_legacy_device_v6.__wrapped__(
        jnp.asarray(p32), jnp.asarray(offs), jnp.asarray(bits),
        jnp.asarray(np.asarray(refs, np.int32)),
        pw=pw, h=h, width=w, rows=rows, interpret=True,
    )


JAX_KERNELS = {
    "v6": _jax_v6,
    "v5": lambda p, w, h: PL.decode_legacy_pallas_v5(p, w, h, interpret=True),
    "v1": lambda p, w, h: PL.decode_legacy_pallas(p, w, h, interpret=True),
}


@pytest.mark.parametrize("maxv", [4095, 65535])
@pytest.mark.parametrize("shape", [(16, 1920), (24, 1000)])
@pytest.mark.parametrize("kernel", sorted(JAX_KERNELS))
def test_decode_equals_jax_pallas(kernel, shape, maxv):
    """The port against the three generations of the JAX legacy kernel
    (_legacy_kernel_v6, _v5 and the first, whose entry point
    decode_legacy_pallas the port routes to its one kernel)."""
    h, w = shape
    img = np.random.default_rng(maxv + w).integers(0, maxv + 1, size=(h, w),
                                                  dtype=np.uint16)
    payload = encode(img, "table")
    out = L.decode_legacy(payload, w, h, Staging(CPU)).numpy()
    assert np.array_equal(out, np.asarray(JAX_KERNELS[kernel](payload, w, h)))
    assert np.array_equal(out, img)


def synthetic_chain(rng, h, w):
    """Random payload bytes on a header chain of random bits 0..16 (11..16
    the 16-bit class) and refs 0..4095: offsets are the cumulative sum of
    2 + the block length, just past each header. The first 17 blocks take
    every bits value once."""
    nblk = L.num_blocks(w, h)
    bits = rng.integers(0, 17, size=nblk).astype(np.int32)
    bits[:17] = np.arange(17)
    refs = rng.integers(0, 4096, size=nblk).astype(np.uint16)
    step = 2 + T.LEGACY_BLOCK_LENGTH[bits].astype(np.int64)
    offsets = np.cumsum(step) - step + 2
    payload = rng.integers(0, 256, size=int(step.sum()) + 1 + L.TAIL_BYTES,
                           dtype=np.uint8)
    return payload, bits, refs, offsets


def funnel(payload, bits, refs, offsets, h, w):
    """The kernel's closed form in NumPy: value j of a block is the c-bit
    field at bit j*c of a 3-byte big-endian window, bytes past the payload
    0."""
    b = np.clip(bits.astype(np.int64), 0, 16)[:, None]
    c = np.where(b <= 10, b, 16)
    bit = np.arange(16)[None, :] * c
    i = offsets[:, None] + (bit >> 3)
    pad = np.concatenate([payload, np.zeros(3, np.uint8)]).astype(np.int64)
    win = pad[i] << 16 | pad[i + 1] << 8 | pad[i + 2]
    v = (win >> (24 - (bit & 7) - c)) & ((1 << c) - 1)
    img = R.legacy_interleave(v.astype(np.uint16), refs, h, R.legacy_padded_width(w))
    return img[:, :w]


def byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint64 arrays: result byte k is byte
    (sel >> 4k) & 7 of the 8 bytes y:x."""
    b = y << np.uint64(32) | x
    out = np.zeros(np.broadcast(b, sel).shape, np.uint64)
    for k in range(4):
        idx = (sel >> np.uint64(4 * k)) & np.uint64(7)
        out |= ((b >> (np.uint64(8) * idx)) & np.uint64(0xFF)) << np.uint64(8 * k)
    return out


def staged_window(words, s):
    """The kernel's 8-byte big-endian window at byte s: the three 32-bit
    little-endian words from s // 4, bytes picked by two permutes."""
    i, a = s >> 2, (s & 3).astype(np.uint64)
    be = np.uint64(0x0123) + np.uint64(0x1111) * a
    hi = byte_perm(words[i], words[i + 1], be)
    lo = byte_perm(words[i + 1], words[i + 2], be)
    return hi << np.uint64(32) | lo


def quad_values(win, c, q):
    """Values 4q .. 4q + 3 of a class-c block from its window: (..., 4)."""
    c = np.asarray(c, np.int64)[..., None]
    sh = 4 * ((np.asarray(q) * c[..., 0]) & 1)[..., None]
    k = np.arange(4)
    shift = (64 - sh - (k + 1) * c).astype(np.uint64)
    mask = ((np.int64(1) << c) - 1).astype(np.uint64)
    return (np.asarray(win, np.uint64)[..., None] >> shift) & mask


def window_rule(payload, bits, refs, offsets, h, w):
    """The redesigned kernel's arithmetic in NumPy: thread q of pair p
    takes values 4q .. 4q + 3 of blocks 2p and 2p + 1 from one window each
    at byte offset + qc // 2 and writes columns 8q .. 8q + 7 of the pair.
    Bytes past the payload read 0 (the staged copy's zero fill)."""
    pw = R.legacy_padded_width(w)
    pairs = h * pw // 32
    cl = np.clip(bits.astype(np.int64), 0, 16)
    c = np.where(cl <= 10, cl, 16)
    b = 2 * np.arange(pairs)[:, None, None] + np.arange(2)[None, None, :]  # (p, 1, e)
    q = np.arange(4)[None, :, None]  # (1, q, 1)
    cb = c[b]
    s = offsets[b] + ((q * cb) >> 1)  # (p, q, e)
    size = max(int(s.max()) + 12, len(payload))
    buf = np.zeros(size + -size % 4, np.uint8)
    buf[: len(payload)] = payload
    words = buf.view("<u4").astype(np.uint64)
    v = quad_values(staged_window(words, s), cb, q)  # (p, q, e, k)
    v = np.where(cb[..., None] == 0, 0, v).astype(np.int64)
    v = (v + refs.astype(np.int64)[b][..., None]) & 0xFFFF
    img = v.transpose(0, 1, 3, 2).reshape(h, pw)  # columns 8q + 2k + e
    return img[:, :w].astype(np.uint16)


def table_values(payload, cls_index, offset, j):
    """Value j of a block at `offset` by the byte-field tables of the JAX
    package (bytes past the payload 0)."""
    v = 0
    for f in range(T.LEGACY_MAX_FIELDS):
        i = offset + int(T.LEGACY_POS[cls_index, j, f])
        byte = int(payload[i]) if 0 <= i < len(payload) else 0
        v |= ((byte >> int(T.LEGACY_RSH[cls_index, j, f]))
              & int(T.LEGACY_MSK[cls_index, j, f])) << int(T.LEGACY_LSH[cls_index, j, f])
    return v


@pytest.mark.parametrize("a", range(4))
@pytest.mark.parametrize("q", range(4))
@pytest.mark.parametrize("c", [*range(11), 16])
def test_four_values_from_one_window(c, q, a):
    """One pair, its first block of class c placed so that quad q's window
    starts at byte a of a 32-bit word: the window rule equals the byte-field
    tables and the plain version, for random payload bytes."""
    rng = np.random.default_rng(100 * c + 10 * q + a)
    cls_index = T.LEGACY_CLASSES.index(c)
    for _ in range(8):
        bits = np.array([c if c <= 10 else rng.integers(11, 17),
                         rng.integers(0, 17)], np.int32)
        o0 = 4 + (a - ((q * c) >> 1)) % 4
        o1 = o0 + 2 + int(T.LEGACY_BLOCK_LENGTH[bits[0]])
        offsets = np.array([o0, o1], np.int64)
        refs = rng.integers(0, 1 << 16, size=2).astype(np.uint16)
        payload = rng.integers(0, 256, size=o1 + 34 + L.TAIL_BYTES, dtype=np.uint8)
        assert (o0 + ((q * c) >> 1)) % 4 == a
        words = np.concatenate([payload, np.zeros(16, np.uint8)])
        words = words[: len(words) // 4 * 4].view("<u4").astype(np.uint64)
        win = staged_window(words, np.array(o0 + ((q * c) >> 1)))
        got = quad_values(win, c, q).astype(np.int64)
        want = [table_values(payload, cls_index, o0, 4 * q + k) for k in range(4)]
        assert got.tolist() == want
        plain = L.decode_legacy_plain(
            *(torch.from_numpy(x) for x in (payload, bits, refs, offsets)),
            height=1, width=32,
        ).numpy().astype(np.int64)
        assert plain[0, 8 * q : 8 * q + 8 : 2].tolist() == [
            (v + int(refs[0])) & 0xFFFF for v in want
        ]
        assert np.array_equal(window_rule(payload, bits, refs, offsets, 1, 32), plain)


@pytest.mark.parametrize(
    "shape", [(8, 96), (5, 50), (24, 1000), (2, 4000), (2, 4036), (2, 4090), (7, 33), (9, 1)]
)
def test_plain_equals_window_rule(shape):
    """Whole frames: runs of pairs that cross rows, ragged widths, refs up to
    65535 (the sum wraps), no zero tail after the payload."""
    h, w = shape
    rng = np.random.default_rng(h * w)
    payload, bits, refs, offsets = synthetic_chain(rng, h, w)
    refs = rng.integers(0, 1 << 16, size=len(refs)).astype(np.uint16)
    payload = payload[: -L.TAIL_BYTES]
    got = L.decode_legacy_device(
        *(torch.from_numpy(a) for a in (payload, bits, refs, offsets)),
        height=h, width=w,
    )
    assert np.array_equal(got.numpy(), window_rule(payload, bits, refs, offsets, h, w))


@pytest.mark.parametrize("shape", [(8, 96), (5, 50), (24, 1000), (3, 4032)])
def test_plain_equals_kernel_closed_form(shape):
    h, w = shape
    rng = np.random.default_rng(h + w)
    payload, bits, refs, offsets = synthetic_chain(rng, h, w)
    assert set(np.unique(bits)) == set(range(17))
    got = L.decode_legacy_device(
        *(torch.from_numpy(a) for a in (payload, bits, refs, offsets)),
        height=h, width=w,
    )
    assert np.array_equal(got.numpy(), funnel(payload, bits, refs, offsets, h, w))


@pytest.mark.parametrize(
    "field, ref",
    [
        ("pos", T.LEGACY_POS),
        ("rsh", T.LEGACY_RSH),
        ("msk", T.LEGACY_MSK),
        ("lsh", T.LEGACY_LSH),
        ("class_index", T.LEGACY_CLASS_INDEX),
        ("class_of_bits", T.LEGACY_CLASS_OF_BITS),
        ("block_length", T.LEGACY_BLOCK_LENGTH),
    ],
)
def test_legacy_tables_equal_reference(field, ref):
    got = getattr(legacy_tables("cpu"), field)
    assert got.dtype == torch.int64 and got.shape == ref.shape
    assert np.array_equal(got.numpy(), ref)


def test_truncated_payload_raises_decode_error():
    img = np.random.default_rng(6).integers(0, 4096, size=(8, 96), dtype=np.uint16)
    payload = np.frombuffer(E.encode_legacy(img)[:200], np.uint8)
    with pytest.raises(DecodeError, match="legacy stream truncated"):
        L.decode_legacy(payload, 96, 8, Staging(CPU))


def test_wrapper_checks_inputs():
    rng = np.random.default_rng(1)
    payload, bits, refs, offsets = (
        torch.from_numpy(a) for a in synthetic_chain(rng, 2, 160)
    )
    kw = dict(height=2, width=160)
    with pytest.raises(ValueError, match="offsets"):
        L.decode_legacy_device(payload, bits, refs, offsets.to(torch.int32), **kw)
    with pytest.raises(ValueError, match="bits must"):
        L.decode_legacy_device(payload, bits.to(torch.uint16), refs, offsets, **kw)
    with pytest.raises(ValueError, match="refs has"):
        L.decode_legacy_device(payload, bits, refs[:3], offsets, **kw)


def test_no_fallback_off_the_cpu():
    """A tensor that is not on the CPU never takes the plain version: the
    kernel launches (CUDA) or the call raises."""
    t = lambda n, dt: torch.empty(n, dtype=dt, device="meta")  # noqa: E731
    before = L.PLAIN_CALLS
    with pytest.raises(ValueError, match="no legacy unpack kernel"):
        L.decode_legacy_device(
            t(64, torch.uint8), t(4, torch.int32), t(4, torch.uint16),
            t(4, torch.int64), height=2, width=32,
        )
    assert L.PLAIN_CALLS == before


def test_plain_counter_counts_cpu_calls():
    img = np.zeros((2, 32), np.uint16)
    payload = np.frombuffer(E.encode_legacy(img), np.uint8)
    before = (L.PLAIN_CALLS, L.KERNEL_LAUNCHES)
    L.decode_legacy(payload, 32, 2, Staging(CPU))
    assert (L.PLAIN_CALLS, L.KERNEL_LAUNCHES) == (before[0] + 1, before[1])
