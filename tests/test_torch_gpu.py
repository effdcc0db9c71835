"""mcraw_torch's CUDA kernels on the card, against their plain torch
versions and the NumPy oracle. Every test here is marked `gpu` and skips
where torch.cuda.is_available() is false. The file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from mcraw import encode as E
from mcraw.kernels import tables as T
from mcraw.metadata import example_container_metadata, example_frame_metadata
from mcraw_torch import Decoder
from mcraw_torch.kernels import checksum as C
from mcraw_torch.kernels import legacy as L
from mcraw_torch.kernels import unpack as U
from mcraw_torch.kernels.tables import modern_tables

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
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


@pytest.mark.parametrize(
    "height, width", [(8, 96), (5, 50), (24, 1000), (3024, 4032), (3072, 4096)]
)
def test_unpack_legacy_kernel_equals_plain(cuda, height, width):
    """Random payload bytes on a synthetic header chain: bits 0..16 (every
    value among the first 17 blocks), refs 0..4095, offsets the cumulative
    sum of 2 + the block length."""
    rng = np.random.default_rng(height + width)
    nblk = L.num_blocks(width, height)
    bits = rng.integers(0, 17, size=nblk).astype(np.int32)
    bits[:17] = np.arange(17)
    refs = rng.integers(0, 4096, size=nblk).astype(np.uint16)
    step = 2 + T.LEGACY_BLOCK_LENGTH[bits].astype(np.int64)
    offsets = np.cumsum(step) - step + 2
    payload = rng.integers(0, 256, size=int(step.sum()) + 1 + L.TAIL_BYTES,
                           dtype=np.uint8)
    args = [torch.from_numpy(a).to(cuda) for a in (payload, bits, refs, offsets)]
    kw = dict(height=height, width=width)
    launches = L.KERNEL_LAUNCHES
    got = L.decode_legacy_device(*args, **kw)
    want = L.decode_legacy_plain(*args, **kw)
    torch.cuda.synchronize()
    assert L.KERNEL_LAUNCHES == launches + 1
    assert got.shape == (height, width) and got.dtype == torch.uint16
    assert torch.equal(got.to(torch.int32), want.to(torch.int32))


@pytest.mark.parametrize(
    "shape, dtype, lo",
    [
        ((1, 1), np.uint16, 0),
        ((7, 13), np.uint16, 0),
        ((3, 4, 5), np.uint32, 0),
        ((1000, 1000), np.uint32, (1 << 32) - 4096),
        ((3072, 4096), np.uint16, 0),
        # Overflows the JAX kernel's row-capped VMEM band; any shape here.
        ((6144, 4096), np.uint32, 0),
    ],
)
def test_checksum_kernel_equals_plain(cuda, shape, dtype, lo):
    hi = 1 << (8 * np.dtype(dtype).itemsize)
    a = np.random.default_rng(2).integers(lo, hi, size=shape, dtype=np.uint64)
    a = a.astype(dtype)
    x = torch.from_numpy(a).to(cuda)
    launches = C.KERNEL_LAUNCHES
    got = int(C.device_checksum(x))
    assert C.KERNEL_LAUNCHES == launches + 1
    assert got == int(C.checksum_plain(x)) == int(a.astype(np.int64).sum() & 0xFFFFFFFF)


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
