"""mcraw_torch's CUDA kernels on the card, against their plain torch
versions and the NumPy oracle. Every test here is marked `gpu` and skips
where torch.cuda.is_available() is false. The file imports no JAX and
nothing of mcraw, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from mcraw_torch import Decoder, codecs
from mcraw_torch import encode as E
from mcraw_torch import preview as P
from mcraw_torch import soak as S
from mcraw_torch.kernels import checksum as C
from mcraw_torch.kernels import develop as D
from mcraw_torch.kernels import legacy as L
from mcraw_torch.kernels import offsets as O
from mcraw_torch.kernels import tables as T
from mcraw_torch.kernels import unpack as U
from mcraw_torch.kernels.tables import modern_tables
from mcraw_torch.metadata import CFA_PATTERNS, example_container_metadata, example_frame_metadata

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    # The plain versions hold no matmul or conv; TF32 stays off all the same.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "ty, tx, height, width",
    [(3, 2, 12, 128), (25, 7, 99, 420), (3, 2, 20, 100), (768, 64, 3072, 4096)],
)
def test_unpack_kernel_equals_plain(cuda, ty, tx, height, width):
    """Random payload, bits 0..65535 (clamped), refs 0..65535 (wrap)."""
    rng = np.random.default_rng(ty * tx)
    nblk = 4 * ty * tx
    bits = rng.integers(0, 1 << 16, size=nblk, dtype=np.uint16)
    refs = rng.integers(0, 1 << 16, size=nblk, dtype=np.uint16)
    size = 16 + int(T.MODERN_BLOCK_LENGTH.take(bits, mode="clip").sum())
    size += U.TAIL_BYTES + (-(size + U.TAIL_BYTES)) % 16
    payload = rng.integers(0, 256, size=size, dtype=np.uint8)
    words = torch.from_numpy(payload.view("<i4")).to(cuda)
    b, r = torch.from_numpy(bits).to(cuda), torch.from_numpy(refs).to(cuda)
    offs = U.block_offsets(b, modern_tables(cuda))
    kw = dict(ty=ty, tx=tx, height=height, width=width)
    launches = U.KERNEL_LAUNCHES
    got = U.decode_modern_device(words, b, r, offs, **kw)
    want = U.decode_modern_plain(words, b, r, offs, **kw)
    torch.cuda.synchronize()
    assert U.KERNEL_LAUNCHES == launches + 1
    assert got.shape == (height, width) and got.dtype == torch.uint16
    assert torch.equal(got.to(torch.int32), want.to(torch.int32))


def edge_unpack_inputs(rng, ty: int, tx: int, content: str, device):
    """Unpack inputs with bits chosen by `content`: "per_tile" (every block
    of tile i at bits i % 17, so each tile holds one width and every width
    0..16 occurs), "all16" (every block at a 16-bit width 11..16), or
    "scrambled" (random bits and the prep's offsets shuffled, which the
    kernel must read word by word from device memory)."""
    nblk = 4 * ty * tx
    if content == "per_tile":
        bits = (np.arange(nblk) // 4 % 17).astype(np.uint16)
    elif content == "all16":
        bits = rng.integers(11, 17, size=nblk, dtype=np.uint16)
    else:
        bits = rng.integers(0, 17, size=nblk, dtype=np.uint16)
    refs = rng.integers(0, 1 << 16, size=nblk, dtype=np.uint16)
    size = 16 + int(T.MODERN_BLOCK_LENGTH.take(bits, mode="clip").sum())
    size += U.TAIL_BYTES + (-(size + U.TAIL_BYTES)) % 16
    payload = rng.integers(0, 256, size=size, dtype=np.uint8)
    words = torch.from_numpy(payload.view("<i4")).to(device)
    b, r = torch.from_numpy(bits).to(device), torch.from_numpy(refs).to(device)
    offs = U.block_offsets(b, modern_tables(device))
    if content == "scrambled":
        offs = offs[torch.from_numpy(rng.permutation(nblk)).to(device)].contiguous()
    return words, b, r, offs


@pytest.mark.parametrize(
    "ty, tx, height, width, content",
    [
        (768, 64, 3072, 4032, "per_tile"),  # the last tile column cropped away
        (768, 63, 3072, 4000, "random"),  # W % 64 != 0: a tile crosses the crop
        (768, 64, 3072, 4036, "per_tile"),  # W % 8 != 0: masked stores
        (768, 64, 3072, 4090, "random"),
        (10, 8, 50, 512, "random"),  # short encodedHeight: rows 40.. stay zero
        (7, 5, 28, 300, "all16"),
        (9, 4, 36, 256, "scrambled"),
    ],
)
def test_unpack_kernel_edges(cuda, ty, tx, height, width, content):
    """The redesigned kernel's edge cases, element for element against the
    plain version."""
    rng = np.random.default_rng(ty + tx + width)
    words, b, r, offs = edge_unpack_inputs(rng, ty, tx, content, cuda)
    kw = dict(ty=ty, tx=tx, height=height, width=width)
    got = U.decode_modern_device(words, b, r, offs, **kw)
    want = U.decode_modern_plain(words, b, r, offs, **kw)
    torch.cuda.synchronize()
    assert got.shape == (height, width)
    assert torch.equal(got.to(torch.int32), want.to(torch.int32))


def legacy_inputs(rng, height: int, width: int, content: str):
    """Random payload bytes on a synthetic header chain: bits 0..16 (every
    value among the first 17 blocks), offsets the cumulative sum of 2 + the
    block length. `content`: "chain" (refs 0..4095), "wrap" (refs 0..65535,
    so that value + ref wraps), "shuffled" (the offsets permuted: the kernel
    takes bounded reads from device memory), "near_end" (the last nine
    blocks start from 4 bytes before to 4 bytes past the end of the
    payload: bounded reads again) or "no_tail" (no zero tail after the
    payload: the staged copy zero-fills past its end)."""
    nblk = L.num_blocks(width, height)
    bits = rng.integers(0, 17, size=nblk).astype(np.int32)
    bits[:17] = np.arange(17)
    hi = 1 << 16 if content == "wrap" else 4096
    refs = rng.integers(0, hi, size=nblk).astype(np.uint16)
    step = 2 + T.LEGACY_BLOCK_LENGTH[bits].astype(np.int64)
    offsets = np.cumsum(step) - step + 2
    tail = 0 if content == "no_tail" else 1 + L.TAIL_BYTES
    payload = rng.integers(0, 256, size=int(step.sum()) + tail, dtype=np.uint8)
    if content == "shuffled":
        offsets = offsets[rng.permutation(nblk)]
    elif content == "near_end":
        offsets[-9:] = len(payload) + np.arange(-4, 5)
    return payload, bits, refs, offsets


@pytest.mark.parametrize(
    "height, width, content",
    [
        (8, 96, "chain"), (5, 50, "chain"), (24, 1000, "chain"), (3024, 4032, "chain"),
        (3072, 4096, "chain"),
        # Ragged widths: masked stores (W % 8 != 0) and runs of pairs that
        # cross rows (4000 / 32 = 125 pairs a row).
        (3072, 4000, "wrap"), (64, 4036, "wrap"), (64, 4090, "wrap"), (50, 33, "wrap"),
        (70, 1, "wrap"),
        (40, 256, "shuffled"), (3072, 4096, "shuffled"),
        (16, 96, "near_end"), (24, 1000, "near_end"),
        (24, 1000, "no_tail"), (3, 4090, "no_tail"),
    ],
)
def test_unpack_legacy_kernel_equals_plain(cuda, height, width, content):
    """The kernel element for element against the plain version."""
    rng = np.random.default_rng(height + width)
    inputs = legacy_inputs(rng, height, width, content)
    args = [torch.from_numpy(a).to(cuda) for a in inputs]
    kw = dict(height=height, width=width)
    launches = L.KERNEL_LAUNCHES
    got = L.decode_legacy_device(*args, **kw)
    want = L.decode_legacy_plain(*args, **kw)
    torch.cuda.synchronize()
    assert L.KERNEL_LAUNCHES == launches + 1
    assert got.shape == (height, width) and got.dtype == torch.uint16
    assert torch.equal(got.to(torch.int32), want.to(torch.int32))


@pytest.mark.parametrize(
    "shape, dtype, lo, start",
    [
        ((1, 1), np.uint16, 0, 0),
        ((7, 13), np.uint16, 0, 0),
        ((3, 4, 5), np.uint32, 0, 0),
        ((1000, 1000), np.uint32, (1 << 32) - 4096, 0),
        ((3072, 4096), np.uint16, 0, 0),
        # Overflows the JAX kernel's row-capped VMEM band; any shape here.
        ((6144, 4096), np.uint32, 0, 0),
        # Views that start off a 16-byte boundary (x.view(-1)[start:]).
        ((3072, 4096), np.uint16, 0, 1),
        ((1000, 1000), np.uint32, (1 << 32) - 4096, 3),
        # A 16-byte multiple, and lengths 1..17 from every start: scalar
        # heads and tails around 0..2 vectors.
        ((4096,), np.uint16, 0, 0),
        *(((n,), np.uint16, 0, n % 8) for n in range(1, 18)),
        *(((n,), np.uint32, 0, n % 4) for n in range(1, 18)),
    ],
)
def test_checksum_kernel_equals_plain(cuda, shape, dtype, lo, start):
    hi = 1 << (8 * np.dtype(dtype).itemsize)
    a = np.random.default_rng(2).integers(lo, hi, size=start + int(np.prod(shape)),
                                          dtype=np.uint64).astype(dtype)
    x = torch.from_numpy(a).to(cuda)[start:].view(shape)
    launches = C.KERNEL_LAUNCHES
    got = int(C.device_checksum(x))
    assert C.KERNEL_LAUNCHES == launches + 1
    want = int(a[start:].astype(np.int64).sum() & 0xFFFFFFFF)
    assert got == int(C.checksum_plain(x)) == want


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16, np.uint16, np.int32,
                                   np.uint32, np.int64, np.uint64])
@pytest.mark.parametrize("shape", [(1,), (7, 13), (3072, 4096)])
def test_checksum_kernel_takes_every_integer_dtype(cuda, shape, dtype):
    """Every integer dtype, its full range, through the kernel (after its
    conversion to 32-bit words on the card), never the plain version."""
    info = np.iinfo(dtype)
    a = np.random.default_rng(len(shape)).integers(info.min, info.max, size=shape,
                                                   dtype=dtype, endpoint=True)
    x = torch.from_numpy(a).to(cuda)
    before = (C.KERNEL_LAUNCHES, C.PLAIN_CALLS)
    got = int(C.device_checksum(x))
    assert (C.KERNEL_LAUNCHES, C.PLAIN_CALLS) == (before[0] + 1, before[1])
    assert got == int(a.astype(np.int64).sum() & 0xFFFFFFFF)


# -- the block offsets (the modern device prep) ---------------------------------

# (shape, bits drawn from [lo, hi)): one block; one below, at and one above a
# tile; 0..65535 where the clamp matters; all 0 (every offset 16); all >= 16
# at 8K (the largest sums); 4K; batches of 4K frames, F = 1 against the
# single entry below.
OFFSETS_CASES = [
    ((1,), 0, 1 << 16), ((4095,), 0, 1 << 16), ((4096,), 0, 1 << 16), ((4097,), 0, 1 << 16),
    ((8191,), 0, 17), ((8193,), 0, 1 << 16), ((3 * 4096 + 5,), 0, 1), ((3_145_728,), 16, 1 << 16),
    ((786_432,), 0, 1 << 16), ((1, 786_432), 0, 17), ((2, 786_432), 0, 1 << 16),
    ((5, 786_432), 0, 17), ((8, 786_432), 16, 1 << 16), ((3, 4097), 0, 1 << 16),
    ((7, 1), 0, 1 << 16),
]


@pytest.mark.parametrize("shape, lo, hi", OFFSETS_CASES)
def test_block_offsets_kernel_equals_plain(cuda, shape, lo, hi):
    rng = np.random.default_rng([len(shape), shape[-1], lo])
    bits = torch.from_numpy(rng.integers(lo, hi, size=shape, dtype=np.uint16)).to(cuda)
    launches, plain = O.KERNEL_LAUNCHES, O.PLAIN_CALLS
    got = O.block_offsets_device(bits)
    torch.cuda.synchronize()
    assert (O.KERNEL_LAUNCHES, O.PLAIN_CALLS) == (launches + 1, plain)
    assert got.shape == shape and got.dtype == torch.int64 and got.device == bits.device
    assert torch.equal(got, O.block_offsets_plain(bits))
    if hi == 1:
        assert bool((got == 16).all())


def test_block_offsets_kernel_views_and_single_rows(cuda):
    """A view off a 16-byte boundary, a (1, nblk) batch against the single
    entry, and row 0 of it as parallel.decode_frame_sharded passes it."""
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.integers(0, 1 << 16, size=(1, 9000), dtype=np.uint16)).to(cuda)
    for view in (x.view(-1)[1:], x.view(-1)[3:8196], x[0]):
        assert torch.equal(O.block_offsets_device(view), O.block_offsets_plain(view))
    assert torch.equal(O.block_offsets_device(x)[0], O.block_offsets_device(x[0]))
    assert torch.equal(U.block_offsets(x, modern_tables(cuda)), O.block_offsets_plain(x))


def test_block_offsets_kernel_on_four_streams_at_once(cuda):
    """Four streams of one card each launch a batch at the same time; each
    launch has its own status scratch and gives its own answer."""
    rng = np.random.default_rng(32)
    inputs = [torch.from_numpy(rng.integers(0, 1 << 16, size=(3, 786_432), dtype=np.uint16))
              .to(cuda) for _ in range(4)]
    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()
    for _ in range(3):
        outs = []
        for s, bits in zip(streams, inputs):
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                torch.cuda._sleep(100_000)  # the launches queue behind each other's
                outs.append(O.block_offsets_device(bits))
        torch.cuda.synchronize()
        for bits, got in zip(inputs, outs):
            assert torch.equal(got, O.block_offsets_plain(bits))


def test_block_offsets_kernel_empty(cuda):
    launches = O.KERNEL_LAUNCHES
    for shape in ((0,), (4, 0), (0, 5)):
        got = O.block_offsets_device(torch.zeros(shape, dtype=torch.uint16, device=cuda))
        assert got.shape == shape and got.dtype == torch.int64
    assert O.KERNEL_LAUNCHES == launches


def test_decoder_on_card(cuda):
    """Modern and legacy frames in one clip; each goes through its codec's
    kernel and no plain version."""
    rng = np.random.default_rng(4)
    writer = E.ContainerWriter(example_container_metadata())
    imgs = []
    frames = [(7, 16, 256, 4095), (7, 13, 200, 4095), (7, 64, 2048, 4095),
              (6, 16, 256, 4095), (6, 8, 1000, 65535), (6, 24, 4032, 4095)]
    for i, (ct, h, w, maxv) in enumerate(frames):
        img = rng.integers(0, maxv + 1, size=(h, w), dtype=np.uint16)
        imgs.append(img)
        payload = E.encode_modern(img) if ct == 7 else E.encode_legacy(img)
        writer.add_frame(i, payload, example_frame_metadata(w, h, ct))
    d = Decoder(writer.finish(), device="cuda")
    counts = (U.KERNEL_LAUNCHES, U.PLAIN_CALLS, L.KERNEL_LAUNCHES, L.PLAIN_CALLS)
    for ts, img in zip(d.frames, imgs, strict=True):
        out, _ = d.load_frame_device(ts)
        assert out.device.type == "cuda" and out.dtype == torch.uint16
        assert np.array_equal(out.cpu().numpy(), img)
    assert (U.KERNEL_LAUNCHES, U.PLAIN_CALLS, L.KERNEL_LAUNCHES, L.PLAIN_CALLS) == (
        counts[0] + 3, counts[1], counts[2] + 3, counts[3]
    )


def _channels(rgba: torch.Tensor) -> np.ndarray:
    a = rgba.to(torch.int64).cpu().numpy()
    assert ((a >> 24) == 0xFF).all()
    return np.stack([a & 0xFF, (a >> 8) & 0xFF, (a >> 16) & 0xFF], -1)


DEVELOP_ARGS = (
    np.array([64, 60, 70, 64], np.float32), 4095.0,
    np.array([0.61, 1.0, 0.72], np.float32),
    np.array([[0.86, 0.08, 0.02], [0.04, 0.91, 0.05], [0.01, 0.06, 0.76]], np.float32),
)


@pytest.mark.parametrize("demosaic", ["bilinear", "malvar"])
@pytest.mark.parametrize(
    "shape, sensor",
    [((16, 128), "rggb"), ((36, 250), "bggr"), ((3, 64), "grbg"), ((5, 7), "gbrg"),
     ((3024, 4032), "bggr"), ((37, 251), "rggb"), ((3, 101), "gbrg"),
     ((65, 130), "grbg")],
)
def test_develop_kernel_equals_plain_and_f64(cuda, shape, sensor, demosaic):
    """<= 1 LSB per channel against the plain version on the card and the
    f64 model; alpha 255."""
    h, w = shape
    cfa = tuple(CFA_PATTERNS[sensor])
    raw = np.random.default_rng(h + w).integers(0, 4096, size=shape, dtype=np.uint16)
    params = D.pack_develop_params(*DEVELOP_ARGS)
    x = torch.from_numpy(raw).to(cuda)
    launches = D.KERNEL_LAUNCHES
    got = D.develop_rgba_device(x, params, cfa=cfa, demosaic=demosaic)
    want = D.develop_rgba_plain(x, params, cfa=cfa, demosaic=demosaic)
    torch.cuda.synchronize()
    assert D.KERNEL_LAUNCHES == launches + 1
    assert got.shape == shape and got.dtype == torch.uint32
    g = _channels(got)
    assert np.abs(g - _channels(want)).max() <= 1
    if h * w <= 1 << 16:
        model = P.develop_f64(raw, *DEVELOP_ARGS, cfa, demosaic=demosaic)
        assert np.abs(g - model).max() <= 1


@pytest.mark.parametrize("demosaic", ["bilinear", "malvar"])
@pytest.mark.parametrize("h", [3, 5, 66])
def test_develop_kernel_batched_equals_single(cuda, h, demosaic):
    """Black, white and noise frames in one launch: no frame reads its
    neighbour's rows."""
    w = 70
    frames = np.stack([
        np.zeros((h, w), np.uint16), np.full((h, w), 4095, np.uint16),
        np.random.default_rng(h).integers(0, 4096, size=(h, w), dtype=np.uint16),
    ])
    params = D.pack_develop_params(*DEVELOP_ARGS)
    x = torch.from_numpy(frames).to(cuda)
    kw = dict(cfa=(1, 0, 2, 1), demosaic=demosaic)
    batched = D.develop_rgba_device(x, params, **kw)
    singles = torch.stack([D.develop_rgba_device(f, params, **kw) for f in x])
    assert torch.equal(batched.to(torch.int64), singles.to(torch.int64))


@pytest.mark.parametrize("demosaic", ["bilinear", "malvar"])
def test_develop_kernel_batch_of_odd_frames(cuda, demosaic):
    """A (3, 5, 250) batch (frames 1250 pixels apart, W % 4 != 0) equals
    three single calls bit for bit and each is within 1 LSB of plain."""
    frames = np.random.default_rng(7).integers(0, 4096, size=(3, 5, 250), dtype=np.uint16)
    params = D.pack_develop_params(*DEVELOP_ARGS)
    x = torch.from_numpy(frames).to(cuda)
    kw = dict(cfa=(2, 1, 1, 0), demosaic=demosaic)
    batched = D.develop_rgba_device(x, params, **kw)
    singles = torch.stack([D.develop_rgba_device(f, params, **kw) for f in x])
    plain = D.develop_rgba_plain(x, params, **kw)
    assert torch.equal(batched.to(torch.int64), singles.to(torch.int64))
    assert np.abs(_channels(batched) - _channels(plain)).max() <= 1


def _develop_path(x, params, **kw) -> tuple[torch.Tensor, str]:
    """The develop of `x` on the card and the path it took, by the
    develop.ring and develop.direct counters."""
    from mcraw_torch import observe

    with observe.tracing() as rec:
        out = D.develop_rgba_device(x, params, **kw)
        torch.cuda.synchronize()
    paths = {k: v for k, v in rec.counters.items() if k.startswith("develop.")}
    assert len(paths) == 1 and sum(paths.values()) == 1, paths
    return out, next(iter(paths)).removeprefix("develop.")


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `x` whose base lies 2 bytes past a 16-byte
    boundary: a slice of a longer buffer."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    y = buf[1 : 1 + x.numel()].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == 2 and y.is_contiguous()
    return y


@pytest.mark.parametrize("demosaic", ["bilinear", "malvar"])
@pytest.mark.parametrize("shape, sensor", [((8, 2160, 3840), "bggr"), ((3024, 4032), "rggb")])
def test_develop_ring_path_equals_direct(cuda, shape, sensor, demosaic):
    """The grade step's batch and a 12 MP frame take the ring path; the
    same values 2 bytes off a 16-byte boundary take the direct path; the
    two RGBA are equal bit for bit, and within 1 LSB of plain."""
    cfa = tuple(CFA_PATTERNS[sensor])
    raw = np.random.default_rng(shape[-1]).integers(0, 4096, size=shape, dtype=np.uint16)
    params = D.pack_develop_params(*DEVELOP_ARGS)
    x = torch.from_numpy(raw).to(cuda)
    ring, path = _develop_path(x, params, cfa=cfa, demosaic=demosaic)
    assert path == "ring"
    direct, path = _develop_path(_misaligned(x), params, cfa=cfa, demosaic=demosaic)
    assert path == "direct"
    assert torch.equal(ring.to(torch.int64), direct.to(torch.int64))
    plain = D.develop_rgba_plain(x[:1] if x.dim() == 3 else x, params, cfa=cfa,
                                 demosaic=demosaic)
    assert np.abs(_channels(ring[:1] if x.dim() == 3 else ring) - _channels(plain)).max() <= 1


@pytest.mark.parametrize("shape", [(36, 250), (37, 251), (3, 101), (5, 7), (65, 130)])
def test_develop_direct_path_for_ragged_widths(cuda, shape):
    """Widths that are not a multiple of 8 take the direct path."""
    raw = np.random.default_rng(3).integers(0, 4096, size=shape, dtype=np.uint16)
    _, path = _develop_path(torch.from_numpy(raw).to(cuda),
                            D.pack_develop_params(*DEVELOP_ARGS), cfa=(0, 1, 1, 2))
    assert path == "direct"


def test_develop_direct_path_where_raw_zero_is_not_zero(cuda):
    """A negative black level (raw 0 normalizes above 0) takes the direct
    path, even at an aligned width that is a multiple of 8."""
    black, white, neutral, fwd = DEVELOP_ARGS
    params = D.pack_develop_params(np.array([-4, 60, 70, 64], np.float32), white, neutral, fwd)
    raw = np.random.default_rng(5).integers(0, 4096, size=(40, 136), dtype=np.uint16)
    x = torch.from_numpy(raw).to(cuda)
    got, path = _develop_path(x, params, cfa=(2, 1, 1, 0))
    assert path == "direct"
    want = D.develop_rgba_plain(x, params, cfa=(2, 1, 1, 0))
    assert np.abs(_channels(got) - _channels(want)).max() <= 1


def _frame_rows(frames: int, zero_fill: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """(frames, 128) rows, each frame's own black levels, neutral and
    forward matrix, and (frames, 4) CFAs, the four Bayer patterns in turn;
    without `zero_fill`, frame 1's first black level is below 0."""
    black, white, neutral, fwd = DEVELOP_ARGS
    rows = np.concatenate([D.pack_develop_params(
        black + (-68 if f == 1 and not zero_fill else f), white,
        neutral * np.float32(1 + 0.05 * f), fwd * np.float32(1 - 0.03 * f))
        for f in range(frames)])
    return rows, np.array([D.BAYER_CFAS[f % 4] for f in range(frames)], np.int32)


def _rows_path(x, rows, cfas, **kw) -> tuple[torch.Tensor, str]:
    """The per-frame develop of `x` on the card and the path it took; one
    launch, with a row for each frame."""
    from mcraw_torch import observe

    with observe.tracing() as rec:
        out = D.develop_rgba_device(x, rows, cfa=cfas, **kw)
        torch.cuda.synchronize()
    c = {k: v for k, v in rec.counters.items() if k.startswith("develop.")}
    assert c.pop("develop.frame_rows") == x.shape[0] and len(c) == 1 and sum(c.values()) == 1, c
    return out, next(iter(c)).removeprefix("develop.")


@pytest.mark.parametrize("demosaic", ["bilinear", "malvar"])
@pytest.mark.parametrize("shape, zero_fill", [((8, 2160, 3840), True), ((4, 66, 1024), False),
                                              ((3, 37, 250), True), ((2, 5, 64), False)])
def test_develop_rows_ring_and_direct_equal_single_calls(cuda, shape, zero_fill, demosaic):
    """A row and a CFA for each frame, in one launch: on the ring (an
    aligned width that is a multiple of 8, even for a frame whose raw 0
    does not normalize to 0) and on the direct path, bit for bit single
    calls with each frame's own row and CFA."""
    raw = np.random.default_rng(shape[-1]).integers(0, 4096, size=shape, dtype=np.uint16)
    if shape[0] == 8:
        raw[1], raw[3] = 4095, 0
    x = torch.from_numpy(raw).to(cuda)
    rows, cfas = _frame_rows(shape[0], zero_fill)
    singles = torch.stack([D.develop_rgba_device(x[f], rows[f], cfa=tuple(cfas[f]),
                                                 demosaic=demosaic) for f in range(shape[0])])
    rows_d, cfas_d = torch.from_numpy(rows).to(cuda), torch.from_numpy(cfas).to(cuda)
    got, path = _rows_path(x, rows_d, cfas_d, demosaic=demosaic)
    assert path == ("ring" if shape[-1] % 8 == 0 else "direct")
    assert torch.equal(got.to(torch.int64), singles.to(torch.int64))
    direct, path = _rows_path(_misaligned(x), rows, cfas, demosaic=demosaic)
    assert path == "direct"
    assert torch.equal(direct.to(torch.int64), singles.to(torch.int64))


@pytest.mark.parametrize("demosaic", ["bilinear", "malvar"])
def test_develop_rows_of_one_row_equal_the_one_row_launch(cuda, demosaic):
    """One row and CFA repeated for every frame, as a block and as an
    expanded view, give the one-row launch's RGBA; a per-frame launch takes
    a row for each frame, so one row for three frames raises, and the C
    entry refuses rows that overlap."""
    from mcraw_torch.kernels import build

    raw = np.random.default_rng(9).integers(0, 4096, size=(3, 66, 1024), dtype=np.uint16)
    x = torch.from_numpy(raw).to(cuda)
    rows, cfas = _frame_rows(3)
    want = D.develop_rgba_device(x, rows[2], cfa=tuple(cfas[2]), demosaic=demosaic)
    rep, _ = _rows_path(x, np.repeat(rows[2:3], 3, 0), np.repeat(cfas[2:3], 3, 0),
                        demosaic=demosaic)
    row_d, cfa_d = torch.from_numpy(rows[2:3]).to(cuda), torch.from_numpy(cfas[2:3]).to(cuda)
    view, _ = _rows_path(x, row_d.expand(3, -1), cfa_d.expand(3, -1), demosaic=demosaic)
    assert torch.equal(rep, want) and torch.equal(view, want)
    with pytest.raises(ValueError, match="per-frame develop of 3"):
        D.develop_rgba_device(x, row_d, cfa=cfa_d, demosaic=demosaic)
    out = torch.empty(x.shape, dtype=torch.uint32, device=cuda)
    rc = build.lib().mcraw_develop_rows(
        x.data_ptr(), out.data_ptr(), 3, 66, 1024, row_d.data_ptr(), 0, cfa_d.data_ptr(), 0,
        D._quantizer_on(cuda).data_ptr(), D.DEMOSAICS.index(demosaic),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 1  # cudaErrorInvalidValue


def test_develop_rows_checks_host_cfas_and_leaves_a_device_non_bayer_frame_zero(cuda):
    """A CFA given on the host that is not a Bayer pattern raises; one
    already on the card leaves its frame's RGBA 0 and develops the others."""
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, 4096, size=(2, 40, 136), dtype=np.uint16)).to(cuda)
    rows, cfas = _frame_rows(2)
    bad = cfas.copy()
    bad[1] = (0, 0, 1, 2)
    with pytest.raises(ValueError, match="Bayer"):
        D.develop_rgba_device(x, rows, cfa=bad)
    got, _ = _rows_path(x, torch.from_numpy(rows).to(cuda), torch.from_numpy(bad).to(cuda))
    assert int(got[1].to(torch.int64).abs().sum()) == 0
    assert torch.equal(got[0], D.develop_rgba_device(x[0], rows[0], cfa=tuple(cfas[0])))


def test_frame_develop_rows_on_the_card_equal_the_host_rows(cuda):
    """The rows and CFAs that frame_develop_rows copies to the card equal
    the ones it makes on the host, and develop as them."""
    cms, fms = [], []
    for k, sensor in enumerate(CFA_PATTERNS):
        cm = example_container_metadata(sensor=sensor, black_level=(60 + k, 61, 62, 63),
                                        white_level=4095.0)
        cm.update(colorMatrix1=[0.79, -0.23, -0.07, -0.43, 1.32, 0.05, -0.07, 0.18, 0.54],
                  colorMatrix2=[0.92, -0.31, -0.01, -0.50, 1.42, 0.08, -0.04, 0.22, 0.42])
        cms.append(cm)
        fm = example_frame_metadata(136, 40)
        fm["asShotNeutral"] = [0.45 + 0.1 * k, 1.0, 0.8 - 0.1 * k]
        fms.append(fm)
    host = P.frame_develop_rows(cms, fms)
    dev = P.frame_develop_rows(cms, fms, cuda)
    assert dev.rows.device.type == "cuda" and torch.equal(dev.rows.cpu(), host.rows)
    assert torch.equal(dev.cfas.cpu(), host.cfas)
    x = torch.from_numpy(np.random.default_rng(6).integers(
        0, 4096, size=(4, 40, 136), dtype=np.uint16))
    got = P.develop_frames_rgba(x.to(cuda), dev.rows, dev.cfas)
    want = P.develop_frames_rgba(x, host.rows, host.cfas)
    assert np.abs(_channels(got) - _channels(want)).max() <= 1


@pytest.mark.parametrize("demosaic", ["bilinear", "malvar"])
@pytest.mark.parametrize("h", [3, 5, 66])
def test_develop_ring_batch_equals_single(cuda, h, demosaic):
    """On the ring path, a 0, a 4095 and a noise frame in one launch equal
    three single calls bit for bit: the hardware's zero fill stops at each
    frame's edge."""
    w = 72
    frames = np.stack([
        np.zeros((h, w), np.uint16), np.full((h, w), 4095, np.uint16),
        np.random.default_rng(h).integers(0, 4096, size=(h, w), dtype=np.uint16),
    ])
    params = D.pack_develop_params(*DEVELOP_ARGS)
    x = torch.from_numpy(frames).to(cuda)
    kw = dict(cfa=(1, 0, 2, 1), demosaic=demosaic)
    batched, path = _develop_path(x, params, **kw)
    assert path == "ring"
    singles = []
    for f in x:
        one, path = _develop_path(f, params, **kw)
        assert path == "ring"
        singles.append(one)
    assert torch.equal(batched.to(torch.int64), torch.stack(singles).to(torch.int64))


@pytest.mark.parametrize("demosaic", ["bilinear", "malvar"])
@pytest.mark.parametrize("sensor", ["rggb", "bggr", "grbg", "gbrg"])
def test_develop_ring_every_cfa_within_one_lsb(cuda, sensor, demosaic):
    """The ring path, every CFA and both demosaics, at a shape whose tiles
    reach past the frame on every side (2 frames of 40 x 136): within 1 LSB
    per channel of plain and of the f64 model."""
    cfa = tuple(CFA_PATTERNS[sensor])
    raw = np.random.default_rng(40).integers(0, 4096, size=(2, 40, 136), dtype=np.uint16)
    params = D.pack_develop_params(*DEVELOP_ARGS)
    x = torch.from_numpy(raw).to(cuda)
    got, path = _develop_path(x, params, cfa=cfa, demosaic=demosaic)
    assert path == "ring"
    g = _channels(got)
    assert np.abs(g - _channels(D.develop_rgba_plain(x, params, cfa=cfa,
                                                     demosaic=demosaic))).max() <= 1
    for k in range(2):
        model = P.develop_f64(raw[k], *DEVELOP_ARGS, cfa, demosaic=demosaic)
        assert np.abs(g[k] - model).max() <= 1


def test_develop_misaligned_slice_takes_the_direct_path(cuda):
    """A frame whose width is a multiple of 8 but whose base is 2 bytes off
    a 16-byte boundary (a slice) takes the direct path, with the aligned
    copy's RGBA."""
    raw = np.random.default_rng(9).integers(0, 4096, size=(48, 256), dtype=np.uint16)
    params = D.pack_develop_params(*DEVELOP_ARGS)
    x = torch.from_numpy(raw).to(cuda)
    flat = torch.cat([torch.zeros(1, dtype=torch.uint16, device=cuda), x.reshape(-1)])
    view = flat[1:].view(48, 256)
    assert view.data_ptr() % 16 == 2
    got, path = _develop_path(view, params, cfa=(0, 1, 1, 2))
    assert path == "direct"
    want, path = _develop_path(x, params, cfa=(0, 1, 1, 2))
    assert path == "ring"
    assert torch.equal(got.to(torch.int64), want.to(torch.int64))


def _exact_rgba(x: torch.Tensor, rows: np.ndarray, cfas: np.ndarray, demosaic: str):
    """The RGBA every develop form must give bit for bit: the exact sRGB
    quantizer (srgb_quantize, the count of thresholds at or below lin) of
    the plain version's float32 lin on the card, each frame with its row
    and CFA. The kernel computes that lin step for step, so this holds
    the quantizer's rule itself: the exact code of every lin."""
    frames = []
    for f in range(x.shape[0]):
        lin = D.develop_lin_plain(x[f], rows[f], cfa=tuple(cfas[f]), demosaic=demosaic)
        codes = [torch.from_numpy(D.srgb_quantize(c.cpu().numpy())) for c in lin]
        frames.append(D.pack_rgba(*codes))
    return torch.stack(frames).to(torch.int64)


# The grade step's batch (a saturated and a black frame among its 8), the
# shapes above whose tiles reach past the frame, and the ragged ones.
EXACT_SHAPES = [(8, 2160, 3840), (1, 16, 128), (2, 5, 64), (3, 37, 250), (4, 66, 1024),
                (1, 5, 7), (1, 3, 101), (1, 65, 130), (1, 37, 251)]


@pytest.mark.parametrize("demosaic", ["bilinear", "malvar"])
@pytest.mark.parametrize("each", [False, True], ids=["one_row", "row_a_frame"])
@pytest.mark.parametrize("shape", EXACT_SHAPES)
def test_develop_every_form_gives_the_exact_code_of_its_lin(cuda, shape, each, demosaic):
    """Ring and direct, one row and a row a frame, bilinear and Malvar:
    every channel is the exact quantizer's code of the plain version's lin
    (the rule of every build of the kernel since the quantizer was exact),
    so each form's RGBA is bit for bit what it was."""
    raw = np.random.default_rng(shape[-1] + 1).integers(0, 4096, size=shape, dtype=np.uint16)
    if shape[0] == 8:
        raw[1], raw[3] = 4095, 0
    x = torch.from_numpy(raw).to(cuda)
    rows, cfas = _frame_rows(shape[0])
    if not each:
        rows, cfas = np.repeat(rows[:1], shape[0], 0), np.repeat(cfas[:1], shape[0], 0)
    want = _exact_rgba(x, rows, cfas, demosaic)
    paths = []
    for y in (x, _misaligned(x)):
        if each:
            got, path = _rows_path(y, rows, cfas, demosaic=demosaic)
        else:
            got, path = _develop_path(y, rows[0], cfa=tuple(cfas[0]), demosaic=demosaic)
        paths.append(path)
        differ = int((got.cpu().to(torch.int64) != want).sum())
        assert differ == 0, f"{path}: {differ} pixels differ"
    assert paths == ["ring" if shape[-1] % 8 == 0 else "direct", "direct"]


def test_preview_on_card(cuda):
    """A modern and a legacy frame through preview_frame_rgba on the card:
    one develop launch each, no plain call, within 1 LSB of the f64 model."""
    from mcraw_torch.color import interpolated_matrices
    from mcraw_torch.metadata import ContainerMetadata

    rng = np.random.default_rng(6)
    cm = example_container_metadata(sensor="bggr", black_level=(64, 60, 70, 64),
                                    white_level=4095.0)
    writer = E.ContainerWriter(cm)
    imgs = [rng.integers(0, 4096, size=(64, 256), dtype=np.uint16),
            rng.integers(0, 4096, size=(24, 200), dtype=np.uint16)]
    for i, img in enumerate(imgs):
        h, w = img.shape
        payload = E.encode_modern(img) if i == 0 else E.encode_legacy(img)
        writer.add_frame(i, payload, example_frame_metadata(w, h, 7 if i == 0 else 6))
    d = Decoder(writer.finish(), device="cuda")
    counts = (D.KERNEL_LAUNCHES, D.PLAIN_CALLS, P.DEVELOP_CALLS)
    outs = [P.preview_frame_rgba(d, ts, demosaic="malvar") for ts in d.frames]
    assert (D.KERNEL_LAUNCHES, D.PLAIN_CALLS, P.DEVELOP_CALLS) == (
        counts[0] + 2, counts[1], counts[2]
    )
    meta = ContainerMetadata(d.container_metadata)
    neutral = example_frame_metadata(1, 1)["asShotNeutral"]
    fwd, _, _ = interpolated_matrices(meta, neutral)
    for img, rgba in zip(imgs, outs):
        model = P.develop_f64(img, meta.black_level, meta.white_level, neutral, fwd,
                              tuple(meta.cfa_pattern), demosaic="malvar")
        assert np.abs(_channels(rgba) - model).max() <= 1


# -- batched kernels: one launch with a frame axis ------------------------------


def _slots(arrays):
    """Concatenate per-frame buffers (each a multiple of 16 bytes) into one
    uint8 buffer: (buffer, (F,) starts in bytes, (F,) sizes in bytes)."""
    sizes = np.array([a.nbytes for a in arrays], np.int64)
    assert not (sizes % 16).any()
    return (np.concatenate([a.reshape(-1).view(np.uint8) for a in arrays]),
            np.cumsum(sizes) - sizes, sizes)


def modern_batch_inputs(rng, contents, ty, tx, device, past_end=None):
    """Per-frame inputs of edge_unpack_inputs for each of `contents`, and
    their concatenation; frame `past_end` also gets its last three blocks
    pointed at and past the end of its own slot."""
    frames = [edge_unpack_inputs(rng, ty, tx, c, device) for c in contents]
    if past_end is not None:
        w, b, r, offs = frames[past_end]
        n = 4 * w.numel()
        offs[-3:] = torch.tensor([n - 4, n, n + 64], device=device)
    buf, starts, sizes = _slots([f[0].cpu().numpy() for f in frames])
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    batch = (put(buf.view("<i4")), put(starts // 4), put(sizes // 4),
             torch.stack([f[1] for f in frames]), torch.stack([f[2] for f in frames]),
             torch.stack([f[3] for f in frames]))
    return frames, batch


@pytest.mark.parametrize(
    "ty, tx, height, width, contents",
    [
        (768, 64, 3072, 4096, ("random", "per_tile", "all16")),
        (768, 63, 3072, 4000, ("random", "random", "random")),
        (768, 64, 3072, 4090, ("per_tile", "random", "all16")),
        (10, 8, 50, 512, ("random", "all16", "random")),  # short encodedHeight
        (9, 4, 36, 256, ("random", "scrambled", "random")),  # shuffled + past its end
    ],
)
def test_unpack_batch_kernel_equals_single_calls_and_plain(cuda, ty, tx, height, width,
                                                            contents):
    rng = np.random.default_rng(ty + tx + width)
    past_end = 1 if "scrambled" in contents else None
    frames, batch = modern_batch_inputs(rng, contents, ty, tx, cuda, past_end)
    kw = dict(ty=ty, tx=tx, height=height, width=width)
    launches = U.KERNEL_LAUNCHES
    got = U.decode_modern_batch_device(*batch, **kw)
    torch.cuda.synchronize()
    assert U.KERNEL_LAUNCHES == launches + 1
    assert got.shape == (len(contents), height, width) and got.dtype == torch.uint16
    plain = U.decode_modern_batch_plain(*batch, **kw)
    assert torch.equal(got.to(torch.int32), plain.to(torch.int32))
    for f, frame in enumerate(frames):
        single = U.decode_modern_device(*frame, **kw)
        assert torch.equal(got[f].to(torch.int32), single.to(torch.int32)), f


def test_unpack_persistent_blocks_walk_across_frames(cuda):
    """A batch with more runs than the card holds blocks, so each block
    walks runs of several frames: frames of unequal payload length, two
    runs with a malformed offset between good ones (the per-word path), a
    frame 4 bytes off 16-byte alignment and one cut inside its last block
    (their spans copied by cp.async, not by bulk copy), a short
    encodedHeight and a width not a multiple of 8; equal to the plain
    version bit for bit."""
    from mcraw_torch import observe

    ty, tx, height, width = 30, 33, 126, 64 * 33 - 3  # 31 runs a frame, the last partial
    runs = -(-ty * tx // U.RUN_TILES)
    with torch.cuda.device(cuda):
        resident = U._resident(cuda)
    frames = -(-5 * resident // (2 * runs))
    contents = [("random", "per_tile", "all16")[f % 3] for f in range(frames)]
    rng = np.random.default_rng(23)
    _, (words, bases, lengths, bits, refs, offs) = modern_batch_inputs(rng, contents, ty, tx,
                                                                        cuda)
    w, b, n = (t.cpu().numpy().copy() for t in (words, bases, lengths))
    assert len(set(n.tolist())) > 1
    # Frame 2 one word past its 16-byte slot, frame 3 and on back in theirs.
    pad = [np.zeros(k, w.dtype) for k in (1, 3)]
    w = np.concatenate([w[:b[2]], pad[0], w[b[2]:b[3]], pad[1], w[b[3]:]])
    b[2] += 1
    b[3:] += 4
    n[3] = (int(offs[3, -1]) + 16) // 4  # ends inside its last block
    words, bases, lengths = (torch.from_numpy(a).to(cuda) for a in (w, b, n))
    offs[1, 5 * 128 + 17] += 4  # not 8-byte aligned: run 5 of frame 1 by word
    offs[frames - 2, 9 * 128 + 40] = 4 * int(n[frames - 2]) + 64  # past its end
    batch = (words, bases, lengths, bits, refs, offs)
    kw = dict(ty=ty, tx=tx, height=height, width=width)
    with observe.tracing() as record:
        got = U.decode_modern_batch_device(*batch, **kw)
    torch.cuda.synchronize()
    assert record.counters["unpack.modern.runs"] == frames * runs > 2 * resident
    assert record.counters["unpack.modern.runs_ahead"] == frames * runs - resident
    plain = U.decode_modern_batch_plain(*batch, **kw)
    assert torch.equal(got.to(torch.int32), plain.to(torch.int32))
    assert not got[:, 4 * ty:].to(torch.int32).any()


@pytest.mark.parametrize("frames", [8, 16])
def test_unpack_counts_the_runs_loaded_ahead(cuda, frames):
    """unpack.modern.runs_ahead / runs: above 0.9 for a UHD batch of 8 or
    16 (equal to the plain version), 0 for a frame of one run."""
    from mcraw_torch import observe

    rng = np.random.default_rng(frames)
    ty, tx = 540, 60
    _, batch = modern_batch_inputs(rng, ("random", "per_tile") * (frames // 2), ty, tx, cuda)
    kw = dict(ty=ty, tx=tx, height=2160, width=3840)
    with observe.tracing() as record:
        got = U.decode_modern_batch_device(*batch, **kw)
    torch.cuda.synchronize()
    runs, ahead = (record.counters[f"unpack.modern.{k}"] for k in ("runs", "runs_ahead"))
    assert runs == frames * -(-ty * tx // U.RUN_TILES) and ahead / runs > 0.9
    plain = U.decode_modern_batch_plain(*batch, **kw)
    assert torch.equal(got.to(torch.int32), plain.to(torch.int32))
    small = edge_unpack_inputs(rng, 2, 4, "random", cuda)
    with observe.tracing() as record:
        one = U.decode_modern_device(*small, ty=2, tx=4, height=8, width=256)
    assert (record.counters["unpack.modern.runs"], record.counters["unpack.modern.runs_ahead"]
            ) == (1, 0)
    want = U.decode_modern_plain(*small, ty=2, tx=4, height=8, width=256)
    assert torch.equal(one.to(torch.int32), want.to(torch.int32))


def legacy_batch_inputs(rng, height, width, contents, device):
    frames = [legacy_inputs(rng, height, width, c) for c in contents]
    slots = [np.concatenate([p, np.zeros((-len(p)) % 16, np.uint8)]) for p, *_ in frames]
    buf, starts, _ = _slots(slots)
    lengths = np.array([len(p) for p, *_ in frames], np.int64)
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    batch = [put(a) for a in (buf, starts, lengths)] + [
        put(np.stack([f[k] for f in frames])) for k in (1, 2, 3)]
    return [[put(a) for a in f] for f in frames], batch


@pytest.mark.parametrize(
    "height, width, contents",
    [
        (3072, 4096, ("chain", "wrap", "chain")),
        (3072, 4000, ("wrap", "chain", "wrap")),
        (50, 33, ("wrap", "wrap", "chain")),
        (24, 1000, ("chain", "shuffled", "chain")),
        (16, 96, ("chain", "near_end", "no_tail")),
    ],
)
def test_unpack_legacy_batch_kernel_equals_single_calls_and_plain(cuda, height, width,
                                                                   contents):
    rng = np.random.default_rng(height * width)
    frames, batch = legacy_batch_inputs(rng, height, width, contents, cuda)
    kw = dict(height=height, width=width)
    launches = L.KERNEL_LAUNCHES
    got = L.decode_legacy_batch_device(*batch, **kw)
    torch.cuda.synchronize()
    assert L.KERNEL_LAUNCHES == launches + 1
    assert got.shape == (len(contents), height, width)
    plain = L.decode_legacy_batch_plain(*batch, **kw)
    assert torch.equal(got.to(torch.int32), plain.to(torch.int32))
    for f, frame in enumerate(frames):
        single = L.decode_legacy_device(*frame, **kw)
        assert torch.equal(got[f].to(torch.int32), single.to(torch.int32)), f


def test_batch_surface_on_card(cuda):
    """decode_batch_iter, FrameDecoder and the batched preview_clip on a
    mixed clip: one unpack launch per run, no plain call, exact."""
    rng = np.random.default_rng(8)
    writer = E.ContainerWriter(example_container_metadata(sensor="bggr", white_level=4095.0))
    imgs = []
    specs = [(7, 16, 256), (7, 16, 256), (7, 16, 256), (6, 16, 256), (6, 24, 4032),
             (6, 24, 4032)]
    for i, (ct, h, w) in enumerate(specs):
        img = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
        imgs.append(img)
        payload = E.encode_modern(img) if ct == 7 else E.encode_legacy(img)
        writer.add_frame(i, payload, example_frame_metadata(w, h, ct))
    d = Decoder(writer.finish(), device="cuda")
    counts = (U.KERNEL_LAUNCHES, L.KERNEL_LAUNCHES, U.PLAIN_CALLS, L.PLAIN_CALLS)
    outs = [img for imgs_, _ in d.decode_batch_iter(chunk_frames=2) for img in imgs_]
    assert (U.KERNEL_LAUNCHES, L.KERNEL_LAUNCHES, U.PLAIN_CALLS, L.PLAIN_CALLS) == (
        counts[0] + 2, counts[1] + 2, counts[2], counts[3])
    fd = d.make_frame_decoder()
    for ts, img, out in zip(d.frames, imgs, outs, strict=True):
        assert np.array_equal(out.cpu().numpy(), img)
        assert np.array_equal(fd(ts)[0].cpu().numpy(), img)
    assert fd.num_programs == 3
    for (ts, rgba) in P.preview_clip(d, batch_frames=4):
        assert torch.equal(rgba.to(torch.int64), P.preview_frame_rgba(d, ts).to(torch.int64))


# -- the export, verify, the trace and the host codecs on the card ---------------------


def _export_clip_blob(name: str, corrupt_at=None):
    """Clips of the export tests, written with the port's encoder: modern,
    legacy, and both codecs at two geometries; frame `corrupt_at` gets an
    8-byte zero payload."""
    specs = {"modern": [(7, 64, 2048)] * 4, "legacy": [(6, 24, 4032)] * 3,
             "mixed": [(7, 16, 256), (6, 16, 256), (7, 64, 2048), (6, 24, 4032)]}[name]
    rng = np.random.default_rng(len(name))
    writer = E.ContainerWriter(example_container_metadata())
    for i, (ct, h, w) in enumerate(specs):
        img = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
        payload = E.encode_modern(img) if ct == 7 else E.encode_legacy(img)
        if i == corrupt_at:
            payload = b"\x00" * 8
        writer.add_frame(100 + i, payload, example_frame_metadata(w, h, ct))
        writer.add_audio(rng.integers(-99, 99, size=64).astype(np.int16), i * 1000)
    return writer.finish(), [ct for ct, _, _ in specs]


@pytest.mark.parametrize("name", ["modern", "legacy", "mixed"])
def test_export_clip_on_card_equals_cpu(cuda, tmp_path, name):
    """export_clip on the card writes the CPU export's bytes, with one
    unpack launch of each frame's codec per frame and no plain call."""
    from mcraw_torch.clip import export_clip

    blob, codecs = _export_clip_blob(name)
    counts = (U.KERNEL_LAUNCHES, L.KERNEL_LAUNCHES, U.PLAIN_CALLS, L.PLAIN_CALLS)
    stats = export_clip(Decoder(blob, device="cuda"), str(tmp_path / "cuda"))
    assert (U.KERNEL_LAUNCHES, L.KERNEL_LAUNCHES, U.PLAIN_CALLS, L.PLAIN_CALLS) == (
        counts[0] + codecs.count(7), counts[1] + codecs.count(6), counts[2], counts[3])
    export_clip(Decoder(blob, device="cpu"), str(tmp_path / "cpu"))
    assert stats.frames_done == len(codecs) and {"parse", "unpack", "emit"} <= set(
        stats.stage_timing)
    for i in range(len(codecs)):
        name = f"frame_{i:06d}.dng"
        assert (tmp_path / "cuda" / name).read_bytes() == (tmp_path / "cpu" / name).read_bytes()


@pytest.mark.parametrize("name", ["modern", "legacy", "mixed"])
def test_verify_on_card_equals_cpu(cuda, tmp_path, capsys, name):
    """A full verify on the card reports what it reports on the CPU, for a
    clip with a corrupt frame."""
    import json

    from mcraw_torch import cli

    blob, _ = _export_clip_blob(name, corrupt_at=1)
    path = tmp_path / "clip.mcraw"
    path.write_bytes(blob)
    runs = []
    for device in ("cuda", "cpu"):
        rc = cli.main(["verify", str(path), "--device", device])
        runs.append((rc, capsys.readouterr().out))
    assert runs[0] == runs[1] and runs[0][0] == 1
    assert [f["timestamp"] for f in json.loads(runs[0][1])["frames_failed"]] == [101]


def test_device_trace_records_the_unpack_kernel(cuda, tmp_path):
    """device_trace on the card: the Chrome trace holds each codec's unpack
    kernel as a device kernel event once per exported frame (CUPTI sees the
    kernels of the ctypes-bound library)."""
    import json

    from mcraw_torch.clip import export_clip
    from mcraw_torch.observe import device_trace

    blob, codecs = _export_clip_blob("mixed")
    with device_trace(str(tmp_path / "t"), cuda):
        export_clip(Decoder(blob, device="cuda"), str(tmp_path / "out"))
        torch.cuda.synchronize()
    (trace,) = (tmp_path / "t").glob("*.pt.trace.json")
    kernels = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    assert sum("unpack_modern_kernel" in k for k in kernels) == codecs.count(7)
    assert sum("unpack_legacy_kernel" in k for k in kernels) == codecs.count(6)


def test_spans_on_the_card_hold_each_launch(cuda, tmp_path):
    """The program's spans under device_trace on the card: each wrapper
    body holds its one launch.<entry> span, a launch per kernel launch
    counted, and each kernel of the trace was launched (its runtime call,
    by correlation id) inside the launch span of its own entry."""
    import json

    from mcraw_torch import observe
    from mcraw_torch.kernels.staging import Staging

    rng = np.random.default_rng(31)
    images = [rng.integers(0, 4096, size=(64, 256)).astype(np.uint16) for _ in range(2)]
    modern = [np.frombuffer(E.encode_modern(img), np.uint8) for img in images]
    legacy = [np.frombuffer(E.encode_legacy(img), np.uint8) for img in images]
    counters = (U, L, D, C, O)
    before = [m.KERNEL_LAUNCHES for m in counters]
    with observe.device_trace(str(tmp_path / "t"), cuda) as rec:
        mb = U.stage_modern_batch(Staging(cuda), modern, 256, 64)
        offs = U.block_offsets(mb.bits, modern_tables(cuda))
        planes = U.decode_modern_batch_device(mb.words, mb.bases, mb.lengths, mb.bits, mb.refs,
                                              offs, ty=mb.tiles_y, tx=mb.tiles_x, height=64,
                                              width=256)
        rgba = P.develop_rgba(planes, np.zeros(4), 4095.0, np.ones(3), np.eye(3),
                              cfa=(0, 1, 1, 2))
        C.device_checksum(rgba)
        lb = L.stage_legacy_batch(Staging(cuda), legacy, 256, 64)
        L.decode_legacy_batch_device(*lb, height=64, width=256)
        torch.cuda.synchronize()
    launched = sum(m.KERNEL_LAUNCHES for m in counters) - sum(before)
    by_id = {r.id: r for r in rec.rows}
    launches = [r for r in rec.rows if r.name.startswith("launch.")]
    assert len(launches) == launched == 5
    assert sorted(by_id[r.parent].name for r in launches) == [
        "checksum", "develop", "offsets", "unpack.legacy", "unpack.modern"]
    assert rec.summary()["counters"]["h2d_bytes"] > 0
    events = json.loads(next((tmp_path / "t").glob("*.pt.trace.json")).read_text())["traceEvents"]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    spans = [e for e in events if e.get("name", "").startswith("mcraw.launch.")]
    kernels = [e for e in events if e.get("cat") == "kernel" and "_kernel" in e["name"]
               and any(k in e["name"] for k in ("unpack", "develop", "checksum", "offsets"))]
    assert len(kernels) == 5
    for k in kernels:
        call = runtime[k["args"]["correlation"]]
        inside = [m["name"] for m in spans if m.get("tid") == call.get("tid")
                  and m["ts"] <= call["ts"] and call["ts"] + call["dur"] <= m["ts"] + m["dur"]]
        stem = k["name"].split("_kernel")[0].split("::")[-1].removeprefix("void ")
        assert len(inside) == 1 and inside[0].startswith("mcraw.launch.mcraw_" + stem), (
            k["name"], inside)


def test_single_frame_decode_launches_only_batch_entries(cuda):
    """Decoder.load_frame_device of a modern and of a legacy frame: a
    frame is the batch of one, so the launch spans it opens are the batch
    entries' alone, one a kernel, and the frame decodes exactly."""
    from mcraw_torch import observe

    rng = np.random.default_rng(33)
    imgs = [rng.integers(0, 4096, size=(64, 256), dtype=np.uint16) for _ in range(2)]
    writer = E.ContainerWriter(example_container_metadata())
    writer.add_frame(0, E.encode_modern(imgs[0]), example_frame_metadata(256, 64, 7))
    writer.add_frame(1, E.encode_legacy(imgs[1]), example_frame_metadata(256, 64, 6))
    d = Decoder(writer.finish(), device="cuda")
    want = (["launch.mcraw_block_offsets_batch", "launch.mcraw_unpack_modern_batch"],
            ["launch.mcraw_unpack_legacy_batch"])
    for ts, img, names in zip(d.frames, imgs, want, strict=True):
        with observe.tracing() as rec:
            out, _ = d.load_frame_device(ts)
            torch.cuda.synchronize()
        assert sorted(r.name for r in rec.rows if r.name.startswith("launch.")) == names
        assert out.shape == img.shape and np.array_equal(out.cpu().numpy(), img)


@pytest.mark.parametrize("codec", [7, 6])
def test_host_codecs_on_card_equal_cpu(cuda, codec):
    """mcraw_torch.decode_modern / decode_legacy run on the card by default
    (one launch) and equal device="cpu"."""
    import mcraw_torch

    img = np.random.default_rng(codec).integers(0, 1 << 16, size=(24, 4032), dtype=np.uint16)
    enc, dec, mod = ((E.encode_modern, mcraw_torch.decode_modern, U) if codec == 7
                     else (E.encode_legacy, mcraw_torch.decode_legacy, L))
    payload = np.frombuffer(enc(img), np.uint8)
    launches = mod.KERNEL_LAUNCHES
    got = dec(payload, 4032, 24)
    assert mod.KERNEL_LAUNCHES == launches + 1
    assert isinstance(got, np.ndarray) and got.dtype == np.uint16
    assert np.array_equal(got, dec(payload, 4032, 24, device="cpu"))
    assert np.array_equal(got, img)


# -- the mesh surface on the card (mcraw_torch.parallel) ---------------------------


def _mesh_clip(codec: int, n: int, h: int, w: int, seed: int):
    rng = np.random.default_rng(seed)
    writer = E.ContainerWriter(example_container_metadata())
    imgs = []
    for i in range(n):
        img = rng.integers(0, 1 << 16, size=(h, w), dtype=np.uint16)
        imgs.append(img)
        payload = E.encode_modern(img) if codec == 7 else E.encode_legacy(img)
        writer.add_frame(100 + i, payload, example_frame_metadata(w, h, codec))
    return writer.finish(), imgs


def _card_mesh(cuda, n: int):
    from mcraw_torch import parallel as PAR

    return PAR.Mesh((torch.device("cuda", 0),) * n)


@pytest.mark.parametrize("codec", [7, 6])
def test_decode_batch_on_a_card_mesh(cuda, codec):
    """Four shards on one card: one unpack launch a shard on its own
    stream and staging, no plain call, each shard on its device, the whole
    batch equal to the CPU decode and the sources."""
    from mcraw_torch import parallel as PAR

    blob, imgs = _mesh_clip(codec, 8, 24, 4032, codec)
    mod = U if codec == 7 else L
    d = Decoder(blob, device="cuda")
    counts = (mod.KERNEL_LAUNCHES, mod.PLAIN_CALLS)
    got, _ = d.decode_batch(mesh=_card_mesh(cuda, 4))
    assert (mod.KERNEL_LAUNCHES, mod.PLAIN_CALLS) == (counts[0] + 4, counts[1])
    assert isinstance(got, PAR.Sharded) and got.shape == (8, 24, 4032)
    assert all(s.device.type == "cuda" and s.shape == (2, 24, 4032) for s in got.shards)
    assert np.array_equal(got.numpy(), np.stack(imgs))
    assert np.array_equal(got.to(cuda).cpu().numpy(), np.stack(imgs))
    with pytest.raises(ValueError, match="not divisible"):
        d.decode_batch(d.frames[:3], mesh=_card_mesh(cuda, 4))


@pytest.mark.parametrize("codec, h, n", [(7, 3072, 4), (7, 26, 3), (6, 3072, 4), (6, 13, 4)])
def test_frame_sharded_on_a_card_mesh(cuda, codec, h, n):
    """One frame in n row bands on one card: one launch a band, exact."""
    blob, (img,) = _mesh_clip(codec, 1, h, 4096 if h > 100 else 250, 10 + h)
    mod = U if codec == 7 else L
    d = Decoder(blob, device="cuda")
    counts = (mod.KERNEL_LAUNCHES, mod.PLAIN_CALLS)
    got, _ = d.load_frame_sharded(100, _card_mesh(cuda, n))
    assert (mod.KERNEL_LAUNCHES, mod.PLAIN_CALLS) == (counts[0] + n, counts[1])
    assert np.array_equal(got.numpy(), img)
    assert np.array_equal(got.numpy(), d.load_frame(100)[0])


def test_frame_sharded_short_encoded_height_on_a_card(cuda):
    rng = np.random.default_rng(12)
    img = rng.integers(0, 4096, size=(64, 512), dtype=np.uint16)
    writer = E.ContainerWriter(example_container_metadata())
    writer.add_frame(1, E.encode_modern(img[:20]), example_frame_metadata(512, 64))
    d = Decoder(writer.finish(), device="cuda")
    got, _ = d.load_frame_sharded(1, _card_mesh(cuda, 4))
    want = np.zeros_like(img)
    want[:20] = img[:20]
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), d.load_frame(1)[0])


def test_decode_batch_iter_and_clips_on_a_card_mesh(cuda):
    from mcraw_torch import parallel as PAR

    blob, imgs = _mesh_clip(7, 11, 16, 256, 13)
    d = Decoder(blob, device="cuda")
    chunks = list(d.decode_batch_iter(chunk_frames=6, mesh=_card_mesh(cuda, 8)))
    assert [c[0].shape[0] for c in chunks] == [8, 3]
    assert isinstance(chunks[0][0], PAR.Sharded) and chunks[1][0].device == d.device
    flat = np.concatenate([chunks[0][0].numpy(), chunks[1][0].cpu().numpy()])
    assert np.array_equal(flat, np.stack(imgs))
    clips = [_mesh_clip(7, 4, 16, 256, 20 + c) for c in range(4)]
    got, _ = PAR.decode_clips([Decoder(b, device="cuda") for b, _ in clips],
                              mesh=_card_mesh(cuda, 4))
    assert got.shape == (4, 4, 16, 256) and got.device.type == "cuda"
    assert np.array_equal(got.cpu().numpy(), np.stack([np.stack(i) for _, i in clips]))


# -- the soak's fixed-seed cases on the card (mcraw_torch.soak) ------------------------


@pytest.mark.parametrize("leg", S.DECODE_LEGS)
@pytest.mark.parametrize("seed", [3, 4])
def test_soak_leg_on_card(cuda, leg, seed, tmp_path):
    """Twin of tests/test_torch_soak.py::test_leg_equals_numpy_ref: six
    iterations of the leg on the card, every decode path held to the plain
    CPU path and to the source, each result's device checksum to its host
    sum; the codecs' kernels launched and no plain version ran."""
    row = S.run_leg(leg, seed, "cuda", float("inf"), 6, tmp_path)
    assert row["iterations"] == 6 and row["failures"] == 0, row
    assert not any(row["plain_calls"].values()), row
    assert row["launches"]["unpack_modern"] and row["launches"]["unpack_legacy"], row
    # A malformed case may fail a batch path outright; the good frames after
    # it always decode on the single-frame paths.
    paths = ("codecs", "load_frame_device") if leg == "malformed" else S.PATHS
    assert all(row["paths"][p]["unpack_launches"] for p in paths), row["paths"]
    assert not list(tmp_path.glob("FAIL_*"))


def test_soak_injected_wrong_decoder_on_card(cuda, tmp_path):
    row = S.run_leg("codec", 3, "cuda", float("inf"), 1, tmp_path, inject="wrong")
    assert row["failures"] >= 2
    assert {p.name.split("_t")[0] for p in tmp_path.glob("FAIL_*.npz")} == {
        "FAIL_codec_s3_i1_load_frame_device"}


def _noncanonical_frames(seed):
    """A 16 x 192 full-range frame encoded by the mutation leg's coders
    (the twin of tests/test_torch_soak.py::_noncanonical)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 1 << 16, size=(16, 192), dtype=np.uint16)
    modern = E.encode_modern(
        img, coder=S.make_coder(rng, cap_bits=16, cap_ref=0xFFFF, wrap_ok=True),
        meta_coder=S.make_coder(rng, cap_bits=15, cap_ref=0x0FFF, wrap_ok=True),
        meta_tail=rng.integers(0, 1 << 16, size=17, dtype=np.uint16),
        gaps=(rng.bytes(11), rng.bytes(5)))
    legacy = E.encode_legacy(img, coder=S.make_coder(rng, cap_bits=15, cap_ref=0x0FFF,
                                                     wrap_ok=True))
    return img, {7: modern, 6: legacy}


@pytest.mark.parametrize("codec", [7, 6])
def test_noncanonical_on_card(cuda, codec):
    """Twin of tests/test_torch_soak.py::test_noncanonical_through_pallas_
    equals_port: the codec function and the Decoder on the card give the
    source exactly."""
    img, payloads = _noncanonical_frames(21)
    h, w = img.shape
    decode = codecs.decode_modern if codec == 7 else codecs.decode_legacy
    data = np.frombuffer(payloads[codec], np.uint8)
    assert np.array_equal(decode(data, w, h, device=cuda), img)
    writer = E.ContainerWriter(example_container_metadata())
    writer.add_frame(1, payloads[codec], example_frame_metadata(w, h, codec))
    d = Decoder(writer.finish(), device=cuda)
    assert np.array_equal(d.load_frame_device(1)[0].cpu().numpy(), img)


@pytest.mark.parametrize("codec, kind", [(7, k) for k in S.MODERN_MALFORMED]
                         + [(6, k) for k in S.LEGACY_MALFORMED])
def test_malformed_kind_on_card(cuda, codec, kind):
    """Each malformed mutation of the soak on the card: the codec function
    and the Decoder give the plain CPU path's outcome (the same array, or
    the same exception; no launch before an error), and a known-good frame
    then decodes exactly on the same Decoder."""
    rng = np.random.default_rng(31)
    img = rng.integers(0, 4096, size=(16, 192), dtype=np.uint16)
    enc = E.encode_modern if codec == 7 else E.encode_legacy
    base = S.Frame(codec, enc(img), 192, 16, img)
    ew, eh = S.encoded_geometry(base) if codec == 7 else (0, 0)
    for _ in range(500):
        bad = S.malform(rng, base, ew, eh)
        if bad.what == kind:
            break
    assert bad.what == kind
    plain = S.Leg._plain(bad)
    mod = U if codec == 7 else L
    decode = codecs.decode_modern if codec == 7 else codecs.decode_legacy
    before = mod.KERNEL_LAUNCHES
    got = S.caught(lambda: decode(bad.data, 192, 16, device=cuda))
    assert S.Outcome(None if got[1] else (got[0],), got[1]).same(plain)
    # A launch exactly when the frame decodes and has rows to write (an
    # encodedHeight of 0 writes none).
    assert (mod.KERNEL_LAUNCHES > before) == (plain.error is None and S.rows_written(bad) > 0)
    writer = E.ContainerWriter(example_container_metadata())
    writer.add_frame(1, bad.payload, example_frame_metadata(192, 16, codec))
    writer.add_frame(2, base.payload, example_frame_metadata(192, 16, codec))
    d = Decoder(writer.finish(), device=cuda)
    plain_calls = mod.PLAIN_CALLS
    got = S.caught(lambda: d.load_frame_device(1)[0].cpu().numpy())
    assert S.Outcome(None if got[1] else (got[0],), got[1]).same(S.decoder_expect(bad, plain))
    assert np.array_equal(d.load_frame_device(2)[0].cpu().numpy(), img)
    assert mod.PLAIN_CALLS == plain_calls


@pytest.mark.parametrize("leg, seed", [("container", 2), ("json", 3)])
def test_soak_cli_leg_on_card(cuda, leg, seed, tmp_path):
    """Twin of tests/test_torch_soak_cli.py::test_cli_leg_reports_no_
    difference: the port's CLI on the card against ``python -m mcraw
    --backend numpy`` (which needs no JAX), byte for byte."""
    from mcraw_torch import soak_cli as SC

    runner = SC.CliLeg(leg, seed, "cuda", tmp_path / "failures")
    for _ in range(3):
        runner.step()
    row = runner.summary(0.0)
    assert row["failures"] == 0 and row["commands"] == {cmd: 3 for cmd in SC.COMMANDS}


def test_bench_quick_on_card(cuda):
    """``python -m mcraw_torch.bench --quick`` on the card at the full
    sizes: exit 0, every leg of bench.py's line a positive number, no gate
    failure, no error, each leg's kernels launched and no plain call."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from mcraw_torch import bench as B

    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-m", "mcraw_torch.bench", "--quick"], cwd=root,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.splitlines()[-1])
    assert line["gate_failures"] == [] and line["errors"] == []
    for key in B.KEYS[1:]:
        if key != "unit":
            assert isinstance(line[key], float) and line[key] > 0, (key, line[key])
    assert torch.cuda.get_device_name(0) in line["metric"]
    assert not any(line["plain_calls"].values())
    kernels = {"value": "unpack_modern", "legacy_fps_4k": "unpack_legacy",
               "decode_develop_fps": "develop", "decode_develop_legacy_fps": "unpack_legacy"}
    for leg, kernel in kernels.items():
        assert line["legs"][leg]["launches"][kernel] > 0, leg
        assert line["legs"][leg]["launches"]["checksum"] > 0, leg
        trace = line["legs"][leg]["trace"]
        assert any(kernel in name for name in trace["device_ms_per_frame"]), (leg, trace)
        assert 0 < trace["busy_share"] <= 1


# -- the checked build: every access held to its buffer's extent -------------------


@pytest.fixture(scope="module")
def checked_run():
    """``python -m mcraw_torch.bounds`` in a child process (the checked
    build cannot share this process with the default library): its JSON
    line."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    res = subprocess.run([sys.executable, "-m", "mcraw_torch.bounds"],
                         cwd=Path(__file__).resolve().parents[1], capture_output=True,
                         text=True, timeout=900)
    assert res.returncode in (0, 1) and res.stdout.strip(), res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_checked_run_holds(cuda, checked_run):
    assert checked_run["problems"] == []
    assert checked_run["library"].startswith("libmcraw_torch_checked_")


@pytest.mark.parametrize("kernel", ["unpack_modern", "unpack_legacy", "develop", "checksum",
                                    "block_offsets"])
def test_checked_launches_equal_the_default_library(cuda, checked_run, kernel):
    """Each clean checked launch gives the default library's output bit
    for bit, with no fault."""
    from mcraw_torch import bounds

    cases = [(name, fn) for name, k, fn in bounds.clean_cases(cuda) if k == kernel]
    want = {name: bounds.digest(fn()) for name, fn in cases}
    assert {name: checked_run["clean"].get(name) for name in want} == want
    assert checked_run["launches"][kernel] >= len(cases)
    assert checked_run["faults"].get(kernel, 0) == 0


def _negative_ids():
    from mcraw_torch import bounds

    return [f"{k}-{kind}-{buf}" for k, kind, buf, _ in bounds.NEGATIVE]


@pytest.mark.parametrize("case", _negative_ids())
def test_checked_fires_on_an_understated_extent(cuda, checked_run, case):
    """A clean launch with one buffer's checked extent cut short faults,
    names that buffer and counts a fault of the kind of access."""
    kernel, kind, buf = case.split("-")
    row = next(r for r in checked_run["negative"]
               if (r["kernel"], r["kind"], r["buffer"]) == (kernel, kind, buf))
    assert row["fired"] and row["named"] == buf and row["counts"][kind] > 0, row
    assert f"of {buf} at byte" in row["text"]
    assert kind in checked_run["fired"][kernel]
    if (kernel, kind) == ("checksum", "store"):  # the host's memset and the kernel's add
        assert row["counts"]["store"] >= 2, row


@pytest.mark.parametrize("kernel", ["unpack_modern", "unpack_legacy"])
def test_checked_batch_reads_only_its_frames_windows(cuda, checked_run, kernel):
    """A batch with a frame whose shuffled offsets point past its own end
    reads nothing outside any frame's window and faults nowhere; with the
    checked windows cut short, the reads there are counted, not faulted."""
    w = checked_run["windows"][kernel]
    assert w["past_end_cross_frame_reads"] == 0
    assert w["cut_cross_frame_reads"] > 0
    assert checked_run["faults"].get(kernel, 0) == 0


def test_checked_build_refused_after_the_default(cuda):
    from mcraw_torch.kernels import build

    build.lib()
    with pytest.raises(RuntimeError, match="already loaded"):
        build.use_checked()
    assert not build.checked() and build.loaded() == build.library_path()
