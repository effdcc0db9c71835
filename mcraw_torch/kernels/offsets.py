"""The modern codec's device prep: every block's payload byte offset.

For bits of shape (nblk,) or (F, nblk) uint16, each row its own scan::

    offsets[..., i] = 16 + sum_{j < i} block_length[min(bits[..., j], 16)]

in int64: the ``offs`` of the JAX package's ``_v6_build_meta``
(``mcraw/kernels/pallas_unpack.py``, plain jnp outside any ``pallas_call``)
and ``mcraw.kernels.unpack.prepare_modern(...).offsets``. The hand-written
CUDA kernel (``csrc/block_offsets.cu``, a single-pass scan with decoupled
look-back) computes it in one launch, after one memset of its tile-status
scratch, for a batch (one frame's bits are the batch of one). CPU tensors
take :func:`block_offsets_plain`, the torch chain (cast, clamp, gather,
``torch.cumsum``, subtract, add).
"""

from __future__ import annotations

import torch

from .. import observe
from . import build
from . import numpy_ref as R
from .tables import ModernTables, modern_tables

KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0

TILE = 4096  # blocks a tile of the kernel (csrc/block_offsets.cu kTile)


def _check(bits: torch.Tensor) -> None:
    if bits.dtype != torch.uint16 or bits.dim() not in (1, 2) or not bits.is_contiguous():
        raise ValueError(
            f"bits must be a contiguous (nblk,) or (F, nblk) {torch.uint16} tensor, got "
            f"{bits.dtype} {tuple(bits.shape)}"
            + ("" if bits.is_contiguous() else ", not contiguous"))


def block_offsets_plain(bits: torch.Tensor, tables: ModernTables | None = None
                        ) -> torch.Tensor:
    """Plain torch version (any device): the int64 offsets of `bits`, along
    its last axis; `tables` defaults to the modern tables on bits' device."""
    global PLAIN_CALLS
    with build.COUNTER_LOCK:
        PLAIN_CALLS += 1
    _check(bits)
    tables = modern_tables(bits.device) if tables is None else tables
    lengths = tables.block_length[bits.to(torch.int64).clamp_(max=16)]
    return R.METADATA_OFFSET + torch.cumsum(lengths, -1) - lengths


def status_words(frames: int, nblk: int) -> int:
    """int64 words of the kernel's scratch: a ticket, then one status word
    a tile of every row."""
    return 1 + frames * -(-nblk // TILE)


@observe.spanned("offsets")
def block_offsets_device(bits: torch.Tensor, tables: ModernTables | None = None
                         ) -> torch.Tensor:
    """(nblk,) or (F, nblk) int64 offsets of contiguous uint16 bits.

    CUDA tensors launch the kernel on the current stream (no host sync; the
    kernel computes the table's lengths itself, so `tables` is not read);
    its status scratch is allocated on that stream, so launches on several
    streams never share it. CPU tensors take :func:`block_offsets_plain`;
    any other device raises."""
    global KERNEL_LAUNCHES
    if bits.device.type == "cpu":
        return block_offsets_plain(bits, tables)
    if bits.device.type != "cuda":
        raise ValueError(f"no block offsets kernel for device {bits.device}")
    _check(bits)
    out = torch.empty(bits.shape, dtype=torch.int64, device=bits.device)
    if out.numel() == 0:
        return out
    nblk = bits.shape[-1]
    frames = bits.numel() // nblk  # (nblk,) bits: the batch of one
    status = torch.empty(status_words(frames, nblk), dtype=torch.int64, device=bits.device)
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.launch("mcraw_block_offsets_batch", (bits, out, status), bits.data_ptr(), frames,
                     nblk, out.data_ptr(), status.data_ptr(), status.numel(), stream)
    with build.COUNTER_LOCK:
        KERNEL_LAUNCHES += 1
    return out
