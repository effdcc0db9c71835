"""mcraw_torch.kernels.offsets, the modern codec's device prep, on the CPU:
the plain version held against the JAX package's ``prepare_modern`` offsets
on encoded frames and against a NumPy oracle on random bits (one frame and
batches, row by row), the wrapper's routes and counts, and its input
checks. Exact: the offsets are integers. The CUDA kernel is checked
against the plain version on the card by test_torch_gpu.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mcraw.kernels import tables as JT
from mcraw.kernels import unpack as JU
from mcraw_torch import encode as E
from mcraw_torch.kernels import build
from mcraw_torch.kernels import offsets as O
from mcraw_torch.kernels import unpack as U
from mcraw_torch.kernels.staging import Staging
from mcraw_torch.kernels.tables import modern_tables


def oracle(bits: np.ndarray) -> np.ndarray:
    """16 + the exclusive prefix sum of the clamped bits' block lengths,
    row by row, in int64."""
    lengths = JT.MODERN_BLOCK_LENGTH[np.minimum(bits.astype(np.int64), 16)].astype(np.int64)
    return 16 + np.cumsum(lengths, axis=-1) - lengths


def _image(rng, kind: str, h: int, w: int) -> np.ndarray:
    if kind == "12-bit":
        return rng.integers(0, 1 << 12, size=(h, w), dtype=np.uint16)
    img = rng.integers(0, 1 << 16, size=(h, w), dtype=np.uint16)
    if kind == "worst":  # full-range noise plus one 5-bit tile
        img[0:4, 0:64] = rng.integers(0, 32, size=(4, min(64, w)))
    return img


@pytest.mark.parametrize("kind", ["12-bit", "worst", "all16"])
@pytest.mark.parametrize("shape", [(4, 64), (16, 256), (13, 200), (64, 1024)])
def test_plain_equals_jax_prepare_modern(shape, kind):
    h, w = shape
    rng = np.random.default_rng([h, w, len(kind)])
    payload = np.frombuffer(E.encode_modern(_image(rng, kind, h, w)), dtype=np.uint8)
    scan = U.scan_modern(payload, w, h)
    got = O.block_offsets_plain(torch.from_numpy(scan.bits))
    want = JU.prepare_modern(payload, w, h).offsets
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (4095,), (4096,), (4097,), (3 * O.TILE + 17,),
                                   (1, 4097), (2, 8191), (3, 1000)])
@pytest.mark.parametrize("content", ["random", "zeros", "all16"])
def test_plain_equals_numpy_oracle(shape, content):
    rng = np.random.default_rng([len(shape), shape[-1]])
    lo, hi = {"random": (0, 1 << 16), "zeros": (0, 1), "all16": (16, 1 << 16)}[content]
    bits = rng.integers(lo, hi, size=shape, dtype=np.uint16)
    got = O.block_offsets_plain(torch.from_numpy(bits)).numpy()
    assert got.dtype == np.int64 and got.shape == shape
    assert np.array_equal(got, oracle(bits))
    for f in range(bits.shape[0] if bits.ndim == 2 else 0):  # each row its own scan
        assert np.array_equal(got[f], oracle(bits[f]))
    if content == "zeros":
        assert (got == 16).all()


def test_plain_sums_in_int64():
    """8K worth of all-16 blocks: the last offset passes 2^31 / 8, the sum
    stays exact."""
    bits = np.full(3_145_728, 16, np.uint16)
    got = O.block_offsets_plain(torch.from_numpy(bits))
    assert int(got[-1]) == 16 + 128 * (bits.size - 1) == int(oracle(bits)[-1])


def test_wrapper_routes_cpu_to_plain_and_counts():
    bits = torch.from_numpy(np.arange(5000, dtype=np.uint16).reshape(2, 2500))
    before = (O.PLAIN_CALLS, O.KERNEL_LAUNCHES)
    got = O.block_offsets_device(bits)
    assert (O.PLAIN_CALLS, O.KERNEL_LAUNCHES) == (before[0] + 1, before[1])
    assert np.array_equal(got.numpy(), oracle(bits.numpy()))
    # unpack.block_offsets keeps its signature and goes through the wrapper.
    got = U.block_offsets(bits[0], modern_tables("cpu"))
    assert (O.PLAIN_CALLS, O.KERNEL_LAUNCHES) == (before[0] + 2, before[1])
    assert np.array_equal(got.numpy(), oracle(bits[0].numpy()))


def test_wrapper_raises_on_another_device():
    with pytest.raises(ValueError, match="no block offsets kernel for device meta"):
        O.block_offsets_device(torch.empty(8, dtype=torch.uint16, device="meta"))


@pytest.mark.parametrize("what", ["dtype", "rank 0", "rank 3", "not contiguous"])
@pytest.mark.parametrize("fn", [O.block_offsets_plain, O.block_offsets_device])
def test_bad_inputs_raise(fn, what):
    bits = torch.zeros((4, 6), dtype=torch.uint16)
    bad = {"dtype": bits.to(torch.int32), "rank 0": bits[0, 0],
           "rank 3": bits.reshape(2, 2, 6), "not contiguous": bits.t()}[what]
    with pytest.raises(ValueError, match="bits must be a contiguous"):
        fn(bad)


@pytest.mark.parametrize("frames, nblk, words", [(1, 1, 2), (1, 4096, 2), (1, 4097, 3),
                                                 (5, 786_432, 961), (8, 0, 1)])
def test_status_words(frames, nblk, words):
    assert O.status_words(frames, nblk) == words


def test_tile_matches_the_source():
    src = (Path(build.CSRC) / "block_offsets.cu").read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == O.TILE


@pytest.mark.parametrize("batch", [False, True])
def test_modern_decode_runs_the_prep_once(batch):
    """The slice on the CPU: one decode (a frame, or a batch of three) calls
    the prep once, and gives the source images."""
    rng = np.random.default_rng(7)
    imgs = [_image(rng, "12-bit", 12, 192) for _ in range(3 if batch else 1)]
    payloads = [np.frombuffer(E.encode_modern(img), np.uint8) for img in imgs]
    before = (O.PLAIN_CALLS, U.PLAIN_CALLS)
    if batch:
        out = U.decode_modern_batch(payloads, 192, 12, Staging("cpu")).numpy()
    else:
        out = U.decode_modern_frame(payloads[0], 192, 12, Staging("cpu")).numpy()[None]
    assert (O.PLAIN_CALLS, U.PLAIN_CALLS) == (before[0] + 1, before[1] + 1)
    assert np.array_equal(out, np.stack(imgs))
