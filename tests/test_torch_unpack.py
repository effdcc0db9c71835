"""mcraw_torch modern unpack: host prep, device prep and the plain decode
held against the NumPy oracle and the JAX package's v6 path (Pallas in
interpret mode), on the same numpy-seeded inputs, and the routes of the
older kernel generations' entry points. Exact: the codec is integer-only.
The CUDA kernel is checked on the card by test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcraw import encode as E
from mcraw import errors as JE
from mcraw.kernels import numpy_ref as R
from mcraw.kernels import pallas_unpack as PK
from mcraw.kernels import tables as T
from mcraw.kernels import unpack as JU
from mcraw.metadata import example_container_metadata, example_frame_metadata
from mcraw.pipeline import Decoder as JaxDecoder
from mcraw_torch import Decoder
from mcraw_torch.errors import DecodeError
from mcraw_torch.kernels import unpack as U
from mcraw_torch.kernels.staging import Staging
from mcraw_torch.kernels.tables import modern_tables
from mcraw_torch.kernels.unpack import decode_modern_frame


def random_inputs(rng, ty, tx):
    """Random payload bytes, bits 0..65535 and refs 0..65535."""
    nblk = 4 * ty * tx
    bits = rng.integers(0, 1 << 16, size=nblk, dtype=np.uint16)
    refs = rng.integers(0, 1 << 16, size=nblk, dtype=np.uint16)
    lengths = T.MODERN_BLOCK_LENGTH.take(bits, mode="clip")
    size = 16 + int(lengths.sum()) + U.TAIL_BYTES
    size += (-size) % 16
    payload = rng.integers(0, 256, size=size, dtype=np.uint8)
    return payload, bits, refs


def oracle(payload, bits, refs, ty, tx, height, width):
    """numpy_ref.unpack_blocks + modern_deinterleave, cropped, zero rows
    past 4*ty."""
    b = np.minimum(bits.astype(np.int64), 16)
    lengths = T.MODERN_BLOCK_LENGTH[b]
    offs = 16 + np.concatenate(([0], np.cumsum(lengths)[:-1]))
    padded = np.zeros(len(payload) + 128, np.uint8)
    padded[: len(payload)] = payload
    windows = padded[offs[:, None] + np.arange(128)]
    vals = R.unpack_blocks(windows, b, modern=True)
    img = R.modern_deinterleave(vals, refs, ty, tx)[:height, :width]
    out = np.zeros((height, width), np.uint16)
    out[: img.shape[0]] = img
    return out, offs


@pytest.mark.parametrize(
    "ty, tx, height, width",
    [(1, 1, 4, 64), (3, 2, 12, 128), (5, 3, 19, 150), (2, 2, 13, 128)],
)
def test_plain_decode_random_equals_oracle(ty, tx, height, width):
    rng = np.random.default_rng(100 * ty + tx)
    payload, bits, refs = random_inputs(rng, ty, tx)
    want, offs = oracle(payload, bits, refs, ty, tx, height, width)
    t_bits = torch.from_numpy(bits)
    offsets = U.block_offsets(t_bits, modern_tables("cpu"))
    assert offsets.dtype == torch.int64
    assert np.array_equal(offsets.numpy(), offs)
    words = torch.from_numpy(payload.view("<i4"))
    got = U.decode_modern_device(
        words, t_bits, torch.from_numpy(refs), offsets,
        ty=ty, tx=tx, height=height, width=width,
    )
    assert got.dtype == torch.uint16 and got.shape == (height, width)
    assert np.array_equal(got.numpy(), want)


def _content(rng, kind, h, w):
    if kind == "widths":  # one bit width 0..16 per 64-column tile
        img = np.zeros((h, w), np.uint16)
        for i in range(0, w, 64):
            b = (i // 64) % 17
            img[:, i : i + 64] = rng.integers(0, 1 << b, size=(h, min(64, w - i)))
        return img
    img = rng.integers(0, 1 << 16, size=(h, w), dtype=np.uint16)
    if kind == "worst":  # full-range noise plus one 5-bit tile
        img[0:4, 0:64] = rng.integers(0, 32, size=(4, min(64, w)))
    return img


@pytest.mark.parametrize("kind", ["widths", "all16", "worst"])
@pytest.mark.parametrize("shape", [(16, 256), (8, 100), (13, 200)])
def test_encoded_frames_equal_oracle_and_jax_v6(shape, kind):
    h, w = shape
    rng = np.random.default_rng(h * w)
    img = _content(rng, kind, h, w)
    payload = np.frombuffer(E.encode_modern(img), dtype=np.uint8)
    out = decode_modern_frame(payload, w, h, Staging("cpu")).numpy()
    assert np.array_equal(out, img)
    assert np.array_equal(out, R.decode_modern(payload, w, h))
    p32, bits, refs, ty, tx, _spans = PK.prepare_modern_light(payload, w, h)
    jax_out = np.asarray(
        PK.decode_modern_device_v6(
            jnp.asarray(p32), jnp.asarray(bits), jnp.asarray(refs),
            ty=ty, tx=tx, height=h, width=w, interpret=True,
        )
    )
    assert np.array_equal(out, jax_out)


def test_all_bit_widths_in_one_frame():
    """Every header value 0..16 (with 11..16 the 16-bit class)."""
    rng = np.random.default_rng(3)
    h, w = 8, 17 * 64
    img = np.zeros((h, w), np.uint16)
    for b in range(17):
        img[:, 64 * b : 64 * (b + 1)] = rng.integers(0, 1 << b, size=(h, 64))
    payload = np.frombuffer(E.encode_modern(img), dtype=np.uint8)
    frame = U.scan_modern(payload, w, h)
    assert set(np.minimum(frame.bits, 16)) >= set(range(11))
    out = decode_modern_frame(payload, w, h, Staging("cpu")).numpy()
    assert np.array_equal(out, img)


@pytest.mark.parametrize("shape", [(16, 256), (8, 100), (13, 200)])
def test_host_prep_matches_jax(shape):
    h, w = shape
    rng = np.random.default_rng(7)
    img = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
    payload = np.frombuffer(E.encode_modern(img), dtype=np.uint8)
    frame = U.stage_modern(Staging("cpu"), payload, w, h)  # the batch of one
    _p32, bits, refs, ty, tx, _ = PK.prepare_modern_light(payload, w, h)
    assert (frame.tiles_y, frame.tiles_x) == (ty, tx)
    assert frame.bits.dtype == torch.uint16 and frame.refs.dtype == torch.uint16
    assert frame.bits.shape == frame.refs.shape == (1, 4 * ty * tx)
    assert np.array_equal(frame.bits[0].numpy(), bits)
    assert np.array_equal(frame.refs[0].numpy(), refs)
    assert (frame.bases.tolist(), frame.lengths.tolist()) == ([0], [frame.words.numel()])
    # Upload buffer: payload + >= 128 zero bytes, 16-byte multiple.
    raw = frame.words.numpy().view(np.uint8)
    assert frame.words.dtype == torch.int32
    assert len(raw) % 16 == 0 and len(raw) >= len(payload) + 128
    assert np.array_equal(raw[: len(payload)], payload)
    assert not raw[len(payload):].any()


def _malformed(kind):
    img = np.random.default_rng(9).integers(0, 4096, size=(8, 128), dtype=np.uint16)
    p = bytearray(E.encode_modern(img))
    width = 128
    if kind == "short header":
        p = p[:10]
    elif kind == "offsets out of bounds":
        p[8:12] = (len(p) + 1).to_bytes(4, "little")
    elif kind == "enc_w % 64":
        p[0:4] = (100).to_bytes(4, "little")
    elif kind == "enc_w < width":
        width = 192
    elif kind == "truncated main data":
        # Declare a taller frame: the streams are long enough (their count
        # is padded to 64) but the main data is not.
        p[4:8] = (16).to_bytes(4, "little")
    return np.frombuffer(bytes(p), np.uint8), width


@pytest.mark.parametrize(
    "kind",
    ["short header", "offsets out of bounds", "enc_w % 64", "enc_w < width",
     "truncated main data"],
)
def test_host_prep_errors_match_jax(kind):
    payload, width = _malformed(kind)
    with pytest.raises(JE.DecodeError) as ref:
        PK.prepare_modern_light(payload, width, 8)
    with pytest.raises(DecodeError) as got:
        U.stage_modern(Staging("cpu"), payload, width, 8)
    assert type(got.value).__name__ == type(ref.value).__name__
    assert str(got.value) == str(ref.value)


def test_short_encoded_height_equals_numpy_decoder():
    """0 < 4*ceil(encodedHeight/4) < height: the rows that exist, zeros
    below, as mcraw's NumPy decoder gives."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 4096, size=(6, 128), dtype=np.uint16)
    writer = E.ContainerWriter(example_container_metadata())
    writer.add_frame(5, E.encode_modern(img), example_frame_metadata(128, 16, 7))
    blob = writer.finish()
    want, _ = JaxDecoder(blob, backend="numpy").load_frame(5)
    got, _ = Decoder(blob, device="cpu").load_frame(5)
    assert got.shape == (16, 128)
    assert np.array_equal(got, want)
    assert not got[8:].any()


def test_wrapper_checks_inputs():
    rng = np.random.default_rng(1)
    payload, bits, refs = random_inputs(rng, 1, 1)
    words = torch.from_numpy(payload.view("<i4"))
    b, r = torch.from_numpy(bits), torch.from_numpy(refs)
    offs = U.block_offsets(b, modern_tables("cpu"))
    kw = dict(ty=1, tx=1, height=4, width=64)
    with pytest.raises(ValueError, match="offsets"):
        U.decode_modern_device(words, b, r, offs.to(torch.int32), **kw)
    with pytest.raises(ValueError, match="bits has"):
        U.decode_modern_device(words, b[:3], r, offs, **kw)


def test_no_fallback_off_the_cpu():
    """A tensor that is not on the CPU never takes the plain version: the
    kernel launches (CUDA) or the call raises."""
    t = lambda n, dt: torch.empty(n, dtype=dt, device="meta")  # noqa: E731
    before = U.PLAIN_CALLS
    with pytest.raises(ValueError, match="no unpack kernel"):
        U.decode_modern_device(
            t(64, torch.int32), t(4, torch.uint16), t(4, torch.uint16),
            t(4, torch.int64), ty=1, tx=1, height=4, width=64,
        )
    assert U.PLAIN_CALLS == before


def test_plain_counter_counts_cpu_calls():
    rng = np.random.default_rng(2)
    payload, bits, refs = random_inputs(rng, 1, 1)
    b = torch.from_numpy(bits)
    offs = U.block_offsets(b, modern_tables("cpu"))
    before = (U.PLAIN_CALLS, U.KERNEL_LAUNCHES)
    U.decode_modern_device(
        torch.from_numpy(payload.view("<i4")), b, torch.from_numpy(refs), offs,
        ty=1, tx=1, height=4, width=64,
    )
    assert (U.PLAIN_CALLS, U.KERNEL_LAUNCHES) == (before[0] + 1, before[1])


@pytest.mark.parametrize("maxv", [4095, 65535])
@pytest.mark.parametrize("shape", [(16, 256), (8, 100)])
def test_routes_decode_modern_pallas(shape, maxv):
    """_unpack_kernel_v4's entry point, decode_modern_pallas, routes to the
    port's modern decode (kernel #1's CUDA kernel on the card)."""
    h, w = shape
    img = np.random.default_rng(maxv + w).integers(0, maxv + 1, size=(h, w),
                                                  dtype=np.uint16)
    payload = np.frombuffer(E.encode_modern(img), dtype=np.uint8)
    out = decode_modern_frame(payload, w, h, Staging("cpu")).numpy()
    want = np.asarray(PK.decode_modern_pallas(payload, w, h, interpret=True))
    assert np.array_equal(out, want) and np.array_equal(out, img)


@pytest.mark.parametrize("maxv", [4095, 65535])
@pytest.mark.parametrize("shape", [(16, 256), (8, 100)])
def test_routes_unpack_blocks_pallas_v2(shape, maxv):
    """_unpack_kernel_v2 (via _unpack_blocks_pallas_v2 over prepare_chunked)
    gives per-block values with each block's reference already added; its
    de-interleave with zero refs, cropped, equals the port's decode."""
    h, w = shape
    img = np.random.default_rng(maxv + h).integers(0, maxv + 1, size=(h, w),
                                                  dtype=np.uint16)
    payload = np.frombuffer(E.encode_modern(img), dtype=np.uint8)
    plan = JU.prepare_modern(payload, w, h)
    payload2d, base_rows, meta, num_chunks, n = PK.prepare_chunked(plan)
    vals = np.asarray(
        PK._unpack_blocks_pallas_v2(
            jnp.asarray(payload2d), jnp.asarray(base_rows), jnp.asarray(meta),
            num_chunks=num_chunks, interpret=True,
        )
    )[:n]
    zero = np.zeros(n, np.uint16)
    want = R.modern_deinterleave(vals, zero, plan.tiles_y, plan.tiles_x)[:h, :w]
    out = decode_modern_frame(payload, w, h, Staging("cpu")).numpy()
    assert np.array_equal(out, want) and np.array_equal(out, img)


# -- the kernel's launch arguments and descriptor table (host side) -----------


@pytest.mark.parametrize(
    "ty, tx, height, width, want",
    [
        (768, 64, 3072, 4096, (3072, 49152)),
        (756, 63, 3024, 4032, (3024, 47628)),  # W % 64 != 0
        (768, 64, 3072, 4036, (3072, 49152)),  # W % 8 != 0
        (10, 8, 50, 512, (40, 80)),  # short encodedHeight
        (3, 2, 11, 100, (11, 6)),  # crop inside the last tile row
        (1, 1, 4, 64, (4, 1)),
        (4, 4, 0, 256, (0, 0)),
        (4, 4, 16, 0, (16, 0)),
    ],
)
def test_unpack_launch_arguments(ty, tx, height, width, want):
    """Rows the kernel writes and the tiles that hold them, by shape."""
    assert tuple(U.unpack_launch(ty, tx, height, width)) == want


# csrc/unpack_modern.cu: a block stages the payload span of a run of
# kRunTiles tiles in a buffer of 4 * kRunTiles * 128 + 32 bytes.
RUN_TILES = 32


def test_run_span_fits_the_staging_buffer():
    """A run's payload span, from its first block's offset (16-byte aligned
    down) to its last block's end (aligned up), never exceeds the kernel's
    shared buffer, even when every block is 16-bit: every offset the host
    prep makes is 8-byte aligned."""
    nblk = 4 * RUN_TILES
    for bits in (np.full(3 * nblk, 16), np.random.default_rng(4).integers(0, 17, 3 * nblk)):
        lengths = T.MODERN_BLOCK_LENGTH[bits]
        offs = 16 + np.concatenate(([0], np.cumsum(lengths)[:-1]))
        assert np.all(offs % 8 == 0)
        for r in range(3):
            lo, last = offs[r * nblk], offs[r * nblk + nblk - 1]
            span = ((last & ~3) + 128 + 15 & ~15) - (lo & ~15)
            assert span <= nblk * 128 + 32


def _kernel_constant(name: str) -> int:
    """An integer constant of csrc/unpack_modern.cu."""
    import re
    from pathlib import Path

    text = (Path(U.__file__).resolve().parents[1] / "csrc" / "unpack_modern.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_run_tiles_are_the_kernels():
    assert U.RUN_TILES == _kernel_constant("kRunTiles") == RUN_TILES


@pytest.mark.parametrize(
    "frames, tiles, resident, want",
    [
        (1, 8, 660, (1, 1, 0)),  # a small frame: its one run, nothing ahead
        (1, 16 * 16, 660, (8, 8, 0)),  # every run in one wave
        (1, 768 * 64, 660, (1536, 660, 876)),  # 4096x3072, the batch of one
        (8, 540 * 60, 660, (8104, 660, 7444)),  # the grade step's UHD batch
        (16, 540 * 60, 660, (16208, 660, 15548)),  # the decode step's
        (3, 33, 4, (6, 4, 2)),  # a partial run a frame; blocks cross frames
        (2, 64, 4, (4, 4, 0)),
        (5, 1, 1, (5, 1, 4)),  # one block walks every frame
    ],
)
def test_modern_grid(frames, tiles, resident, want):
    """The persistent grid: min(runs, resident) blocks; every run after a
    block's first is loaded while the block is on an earlier one."""
    got = U.modern_grid(frames, tiles, resident)
    assert tuple(got) == want
    assert got.runs == got.grid + got.ahead


def test_modern_grid_needs_a_resident_block():
    with pytest.raises(ValueError, match="holds no block"):
        U.modern_grid(1, 8, 0)


@pytest.mark.parametrize("frames", [8, 16])
def test_runs_ahead_share_at_the_cells_shapes(frames):
    """On an H100 (132 SMs) at the kernel's blocks an SM, a UHD batch of 8
    or 16 loads more than 90 % of its runs ahead; a frame whose runs fit
    in one wave loads none ahead."""
    resident = 132 * _kernel_constant("kBlocksPerSm")
    uhd = U.modern_grid(frames, 540 * 60, resident)
    assert uhd.ahead / uhd.runs > 0.9
    assert U.modern_grid(1, 8, resident).ahead == 0


def _quad_values(words: np.ndarray, cls: int, quads: np.ndarray) -> np.ndarray:
    """The kernel's block_values over all 64 values of one block, in NumPy:
    the straight copy for the 16-bit class, else one descriptor row per
    field of each group of four values, right shifts 8 apart."""
    w = words.astype(np.int64)
    if cls == len(T.MODERN_CLASSES) - 1:
        j = np.arange(64)
        return (w[j >> 1] >> (16 * (j & 1))) & 0xFFFF
    v = np.zeros(64, np.int64)
    nf = quads[cls, 48, 0]
    for i in range(16):
        for f in range(nf):
            widx, rsh, mask, lsh = quads[cls, 3 * i + f]
            ws = w[widx] >> rsh
            for u in range(4):
                v[4 * i + u] |= ((ws >> (8 * u)) & mask) << lsh
    return v


def test_quad_descriptors_compute_every_class():
    """pack_quad_descriptors, read as the kernel reads it, gives every
    class's values from random words exactly as the word-field tables."""
    from mcraw_torch.kernels import tables as PT

    quads = PT.pack_quad_descriptors()
    assert quads.shape == (10, 49, 4) and quads.dtype == np.int32
    rng = np.random.default_rng(9)
    for cls in range(len(T.MODERN_CLASSES)):
        words = rng.integers(0, 1 << 32, size=32, dtype=np.uint64).astype(np.uint32)
        w = words.astype(np.int64)
        f = (w[T.MODERN_WIDX[cls]] >> T.MODERN_WRSH[cls]) & ((1 << T.MODERN_WNB[cls]) - 1)
        want = np.bitwise_or.reduce(f << T.MODERN_WLSH[cls], axis=1)
        assert np.array_equal(_quad_values(words, cls, quads), want), T.MODERN_CLASSES[cls]
