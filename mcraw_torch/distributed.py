"""Multi-process clip decode on ``torch.distributed``.

The port of :mod:`mcraw.distributed`. Every process opens the same
container, decodes a disjoint contiguous range of its frames on its own
device and writes its slice of the output sequence. Frames are independent,
so the process group carries control data only (a checksum, a barrier),
never decode data: gloo on CPU tensors serves whichever device decodes, and
two processes may share one card, which NCCL refuses.

- :func:`export_clip_distributed`: each process exports its frame range
  with globally consistent file numbering, no communication.
- :func:`decode_batch_global_mesh`: each process decodes its frames in one
  batched launch and contributes them as its shard of one ``DTensor``
  over a ``DeviceMesh`` of the processes, for consumers that reduce over
  it.

A ``DeviceMesh`` over ranks is process-major by construction, so the
reference's check of the mesh's process order has no counterpart.
"""

from __future__ import annotations

import torch.distributed as dist


def initialize(init_method: str, num_processes: int, process_id: int,
               backend: str = "gloo") -> None:
    """Join the process group, e.g. ``initialize("tcp://localhost:29500", 2,
    rank)``. Nothing is read from the environment: the address, the world
    size and the rank are given."""
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)


def frame_shard(frames: list[int], process_index: int | None = None,
                process_count: int | None = None) -> tuple[list[int], int]:
    """This process's contiguous slice of the clip: (timestamps,
    first_index). Contiguous, not round-robin, so each process reads one
    sequential byte range of the file. The rank and world size of the
    process group are the defaults."""
    pi = dist.get_rank() if process_index is None else process_index
    pc = dist.get_world_size() if process_count is None else process_count
    n = len(frames)
    lo, hi = pi * n // pc, (pi + 1) * n // pc
    return frames[lo:hi], lo


def export_clip_distributed(decoder, output_dir: str, resume: bool = False, **kw):
    """Whole-clip DNG export sharded across processes (no communication):
    :func:`~mcraw_torch.clip.export_clip` of this process's
    :func:`frame_shard`, numbered from its first global index. Every
    process must see the same container; returns this process's
    ExportStats."""
    from .clip import export_clip

    mine, first = frame_shard(decoder.frames)
    return export_clip(decoder, output_dir, timestamps=mine, resume=resume, first_index=first,
                       **kw)


def decode_batch_global_mesh(decoder, timestamps: list[int], mesh):
    """Decode `timestamps` into one (F, H, W) uint16 ``DTensor`` sharded
    along frames over `mesh`, a 1-D ``DeviceMesh`` of the processes.

    Each process decodes only its contiguous frames, in one batched launch
    on the decoder's device (``Decoder.decode_batch``), and contributes them
    as its shard (``DTensor.from_local``, ``Shard(0)``; the DTensor lives
    on the mesh's device type). Returns (the DTensor, this process's frame
    JSON). F not a multiple of the mesh size raises ValueError."""
    from torch.distributed.tensor import DTensor, Shard

    if mesh.ndim != 1:
        raise ValueError(f"the mesh must be 1-D, got {mesh.ndim} dimensions")
    f, n = len(timestamps), mesh.size()
    if f % n != 0:
        raise ValueError(f"batch of {f} not divisible by {n} devices")
    (pi,) = mesh.get_coordinate()
    local, metas = decoder.decode_batch(timestamps[pi * f // n : (pi + 1) * f // n])
    return DTensor.from_local(local, mesh, [Shard(0)]), metas
