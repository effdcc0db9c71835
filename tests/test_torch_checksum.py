"""mcraw_torch device_checksum against numpy and the JAX package's
checksum (its XLA reduction and the Pallas kernel in interpret mode).
Exact: wrap-around uint32 sums. The CUDA kernel is checked on the card by test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcraw.kernels import checksum as JC
from mcraw_torch.kernels import checksum as C


def host_checksum(a):
    return int(a.astype(np.int64).sum() & 0xFFFFFFFF)


def _array(shape, dtype, near_top=False, seed=0):
    rng = np.random.default_rng(seed)
    hi = 1 << (8 * np.dtype(dtype).itemsize)
    lo = hi - 4096 if near_top else 0
    return rng.integers(lo, hi, size=shape, dtype=np.uint64).astype(dtype)


CASES = [
    ((1, 1), np.uint16, False),
    ((7, 13), np.uint16, False),
    ((5,), np.uint16, False),
    ((3, 4, 5), np.uint32, False),
    ((7, 13), np.uint32, True),
    ((64, 300), np.uint32, True),
    ((61, 999), np.uint16, True),
]


@pytest.mark.parametrize("shape, dtype, near_top", CASES)
def test_plain_equals_numpy_and_jax(shape, dtype, near_top):
    a = _array(shape, dtype, near_top)
    got = C.device_checksum(torch.from_numpy(a))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == host_checksum(a)
    assert int(got) == int(JC.device_checksum(jnp.asarray(a)))


@pytest.mark.parametrize(
    "shape, dtype", [((16, 256), np.uint16), ((8, 128), np.uint32),
                     ((24, 384), np.uint32)]
)
def test_plain_equals_pallas_interpret(shape, dtype):
    a = _array(shape, dtype, near_top=True, seed=1)
    want = int(JC._checksum_2d(jnp.asarray(a), interpret=True))
    assert int(C.checksum_plain(torch.from_numpy(a))) == want


def test_rejects_other_dtypes():
    """Integer dtypes only, as the JAX package's checksum."""
    for dtype in (torch.float32, torch.bool, torch.float16):
        with pytest.raises(ValueError, match="integer"):
            C.device_checksum(torch.zeros(4, dtype=dtype))


INTEGER_DTYPES = [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32, np.int64,
                  np.uint64]


@pytest.mark.parametrize("dtype", INTEGER_DTYPES)
@pytest.mark.parametrize("shape", [(1,), (7, 13), (3, 4, 5)])
def test_any_integer_dtype_equals_numpy(shape, dtype):
    """Every integer dtype, its full range (negative values as two's
    complement), against numpy's int64 sum and the JAX package's
    checksum (its uint32 reduction)."""
    info = np.iinfo(dtype)
    a = np.random.default_rng(len(shape)).integers(info.min, info.max, size=shape,
                                                   dtype=dtype, endpoint=True)
    before = (C.PLAIN_CALLS, C.KERNEL_LAUNCHES)
    got = C.device_checksum(torch.from_numpy(a))
    assert (C.PLAIN_CALLS, C.KERNEL_LAUNCHES) == (before[0] + 1, before[1])
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == host_checksum(a)
    if np.dtype(dtype).itemsize <= 4:  # JAX keeps 64-bit types off by default
        assert int(got) == int(JC.device_checksum(jnp.asarray(a)))


@pytest.mark.parametrize("dtype", INTEGER_DTYPES)
@pytest.mark.parametrize("shape", [(), (1,), (7, 13), (3, 4, 5)])
def test_kernel_elements_keep_the_sum(shape, dtype):
    """What the kernel sums for each integer dtype (16- or 32-bit words,
    contiguous) has the wrap-around sum of the tensor, also for a strided
    view; the kernel itself runs on the card (test_torch_gpu.py)."""
    info = np.iinfo(dtype)
    a = np.random.default_rng(len(shape)).integers(info.min, info.max, size=(2, *shape),
                                                   dtype=dtype, endpoint=True)
    x = torch.from_numpy(a)[1]
    words, elem_bytes = C.kernel_elements(x.transpose(0, -1) if x.dim() > 1 else x)
    assert words.is_contiguous() and words.element_size() == elem_bytes in (2, 4)
    raw = words.numpy().view(np.uint16 if elem_bytes == 2 else np.uint32)
    assert int(raw.astype(np.uint64).sum()) & 0xFFFFFFFF == host_checksum(a[1])


def test_no_fallback_off_the_cpu():
    before = C.PLAIN_CALLS
    with pytest.raises(ValueError, match="no checksum kernel"):
        C.device_checksum(torch.empty(4, dtype=torch.uint16, device="meta"))
    assert C.PLAIN_CALLS == before


def vector_split(addr: int, n: int, itemsize: int):
    """The kernel's split of n elements from byte address `addr`: (head,
    nvec, tail start): scalars up to the first 16-byte boundary, whole
    16-byte vectors, scalars after the last whole vector."""
    per = 16 // itemsize
    head = min(n, (-addr % 16) // itemsize)
    nvec = (n - head) // per
    return head, nvec, head + nvec * per


def grid_stride_order(nvec: int, grid: int, threads: int, loads: int):
    """The vectors each thread loads: steps of `loads` loads a grid stride
    apart, each load guarded by the vector count."""
    stride = grid * threads
    order = []
    for t in range(stride):
        for i in range(t, nvec, loads * stride):
            order += [j for j in range(i, i + loads * stride, stride) if j < nvec]
    return order


def split_model(a: np.ndarray, start: int, grid: int = 2, threads: int = 4,
                loads: int = 8) -> int:
    """The kernel's sum of a[start:] in NumPy, the buffer 16-byte aligned:
    scalar head and tail, the body as 32-bit words (uint16 halves summed in
    32-bit lanes), every vector loaded once by the grid stride."""
    itemsize = a.dtype.itemsize
    x = a[start:]
    head, nvec, tail = vector_split(start * itemsize, len(x), itemsize)
    assert (start + head) * itemsize % 16 == 0 or nvec == 0
    order = grid_stride_order(nvec, grid, threads, loads)
    assert sorted(order) == list(range(nvec))
    vec = x[head:tail].view("<u4").reshape(nvec, 4).astype(np.uint64)
    if itemsize == 2:
        vec = (vec & 0xFFFF) + (vec >> 16)
    acc = int(vec[order].sum()) if nvec else 0
    acc += int(x[:head].astype(np.uint64).sum()) + int(x[tail:].astype(np.uint64).sum())
    return acc & 0xFFFFFFFF


@pytest.mark.parametrize("start", range(8))
@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_head_body_tail_split(dtype, start):
    """Start offsets 0..7 elements and lengths 0..70: the split model equals
    the plain version."""
    a = _array((start + 70,), dtype, near_top=True, seed=start)
    for n in range(71):
        got = split_model(a[: start + n], start, threads=1 + n % 4, loads=1 + n % 8)
        assert got == int(C.checksum_plain(torch.from_numpy(a[start : start + n])))
