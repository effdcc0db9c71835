"""mcraw_torch descriptor tables against the JAX package's tables."""

import numpy as np
import pytest
import torch

from mcraw.kernels import pallas_unpack as PK
from mcraw.kernels import tables as T
from mcraw_torch.kernels.tables import modern_tables, pack_descriptors


@pytest.mark.parametrize(
    "field, ref",
    [
        ("widx", T.MODERN_WIDX),
        ("rsh", T.MODERN_WRSH),
        ("nbits", T.MODERN_WNB),
        ("lsh", T.MODERN_WLSH),
        ("class_index", T.MODERN_CLASS_INDEX),
        ("block_length", T.MODERN_BLOCK_LENGTH),
    ],
)
def test_tables_equal_reference(field, ref):
    got = getattr(modern_tables("cpu"), field)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), ref)


def test_packed_descriptors_unpack_to_fields():
    p = pack_descriptors()
    assert p.dtype == np.int32 and p.shape == (10, 64, 3)
    assert np.array_equal(p & 31, T.MODERN_WIDX)
    assert np.array_equal((p >> 5) & 31, T.MODERN_WRSH)
    assert np.array_equal((p >> 10) & 31, T.MODERN_WNB)
    assert np.array_equal((p >> 15) & 15, T.MODERN_WLSH)


def _value_from_port(words, ci, j):
    v = 0
    for f in range(3):
        nb = int(T.MODERN_WNB[ci, j, f])
        if nb:
            w = int(words[T.MODERN_WIDX[ci, j, f]])
            v |= ((w >> int(T.MODERN_WRSH[ci, j, f])) & ((1 << nb) - 1)) << int(
                T.MODERN_WLSH[ci, j, f]
            )
    return v


def _value_from_v5(words, packed):
    """Funnel form of the TPU kernel: ((word << lsh1) >>> rsh2) << lsh."""
    v = 0
    for d in packed:
        d = int(d)
        widx, lsh1, rsh2, lsh = d & 31, (d >> 5) & 31, (d >> 10) & 31, d >> 15
        w = int(words[widx])
        v |= ((((w << lsh1) & 0xFFFFFFFF) >> rsh2) << lsh) & 0xFFFFFFFF
    return v


def test_v5_lane_tables_agree():
    """The JAX kernel's lane-packed tables (_MODERN_TABLES_V5) describe the
    same values: empty slots there duplicate slot 0, so compare the OR of
    each value's fields over random payload words, not the slots."""
    rng = np.random.default_rng(5)
    ncls = len(T.MODERN_CLASSES)
    v5 = PK._MODERN_TABLES_V5.reshape(2, ncls, 3, 128)  # (c, cls, f, lane)
    for ci in range(ncls):
        for lane in range(128):
            h, m = lane >> 6, lane & 63
            j, c = 32 * h + (m >> 1), m & 1
            packed = v5[c, ci, :, lane]
            if T.MODERN_CLASSES[ci] == 0:
                assert not packed.any()  # class 0: no fields at all
                continue
            for _ in range(4):
                words = rng.integers(0, 1 << 32, size=32, dtype=np.uint64)
                assert _value_from_v5(words, packed) == _value_from_port(
                    words, ci, j
                ), (ci, j)
