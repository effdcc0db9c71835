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
    out = L.decode_legacy(payload, w, h, CPU)
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
    out = L.decode_legacy(payload, w, h, CPU).numpy()
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
    frame = L.prepare_legacy(payload, w, h)
    assert frame.scan == (scan if native.have_native() else "serial")
    for got, want in zip(frame[1:4], R.legacy_scan(payload, L.num_blocks(w, h))):
        assert np.array_equal(got, want)
    out = L.decode_legacy(payload, w, h, CPU).numpy()
    assert np.array_equal(out, img)


@pytest.mark.parametrize("table", ["table", "none"])
@pytest.mark.parametrize("shape", [*SHAPES, LARGE])
def test_host_prep_matches_jax(shape, table):
    """bits, refs and offsets equal the JAX package's two host preps
    (values; the JAX preps narrow offsets to int32, the port keeps int64)."""
    h, w = shape
    img = np.random.default_rng(3).integers(0, 4096, size=(h, w), dtype=np.uint16)
    payload = encode(img, table)
    frame = L.prepare_legacy(payload, w, h)
    assert frame.bits.dtype == np.int32 and frame.refs.dtype == np.uint16
    assert frame.offsets.dtype == np.int64
    _p32, offs, bits, refs, _pw, _rows = PL.prepare_legacy_light(payload, w, h)
    assert np.array_equal(frame.bits, bits) and np.array_equal(frame.refs, refs)
    assert np.array_equal(frame.offsets, offs)
    plan = JU.prepare_legacy(payload, w, h)
    assert np.array_equal(T.LEGACY_CLASS_INDEX[frame.bits], plan.cls)
    assert np.array_equal(frame.refs, plan.refs)
    assert np.array_equal(frame.offsets, plan.offsets)
    # Upload buffer: the payload and TAIL_BYTES zeros.
    assert len(frame.payload) == len(payload) + L.TAIL_BYTES
    assert np.array_equal(frame.payload[: len(payload)], payload)
    assert not frame.payload[len(payload):].any()


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
    out = L.decode_legacy(payload, w, h, CPU).numpy()
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
        L.decode_legacy(payload, 96, 8, CPU)


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
    L.decode_legacy(payload, 32, 2, CPU)
    assert (L.PLAIN_CALLS, L.KERNEL_LAUNCHES) == (before[0] + 1, before[1])
