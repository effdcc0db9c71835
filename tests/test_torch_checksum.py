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
    with pytest.raises(ValueError, match="uint16 or uint32"):
        C.device_checksum(torch.zeros(4, dtype=torch.int32))


def test_no_fallback_off_the_cpu():
    before = C.PLAIN_CALLS
    with pytest.raises(ValueError, match="no checksum kernel"):
        C.device_checksum(torch.empty(4, dtype=torch.uint16, device="meta"))
    assert C.PLAIN_CALLS == before

