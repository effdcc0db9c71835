"""mcraw_torch.distributed on the CPU: two real processes join a gloo
process group (as tests/test_distributed.py's two JAX processes join a
coordinator), build the same seeded 8-frame clip as
tests/_distributed_worker.py, decode it as one DTensor over a DeviceMesh of
the two, reduce it across them, and export disjoint halves of one globally
numbered DNG sequence, each DNG byte-identical to mcraw.clip.export_clip's.
frame_shard against mcraw.distributed.frame_shard. The worker is this
file's own __main__:

    python tests/test_torch_distributed.py PORT RANK OUTDIR
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
FRAMES, H, W = 8, 16, 128


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_clip():
    """tests/_distributed_worker.py's clip, written by the port's encoder:
    (container bytes, source images)."""
    from mcraw_torch import encode as E
    from mcraw_torch.metadata import example_container_metadata, example_frame_metadata

    rng = np.random.default_rng(1234)
    writer = E.ContainerWriter(example_container_metadata())
    frames = []
    for i in range(FRAMES):
        img = rng.integers(0, 4096, size=(H, W), dtype=np.uint16)
        frames.append(img)
        writer.add_frame(100 + i, E.encode_modern(img), example_frame_metadata(W, H))
    return writer.finish(), frames


def worker(port: str, rank: int, outdir: str) -> int:
    """One of two processes: decode the clip on the global mesh, check its
    shard and the cross-process sum, export this process's frames."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from mcraw_torch import Decoder
    from mcraw_torch import distributed as D

    D.initialize(f"tcp://localhost:{port}", 2, rank)
    assert (dist.get_rank(), dist.get_world_size()) == (rank, 2)
    blob, frames = make_clip()
    d = Decoder(blob, device="cpu")
    mesh = DeviceMesh("cpu", [0, 1])

    imgs, metas = D.decode_batch_global_mesh(d, d.frames, mesh)
    assert imgs.shape == (FRAMES, H, W) and imgs.dtype == torch.uint16
    assert [m["width"] for m in metas] == [W] * 4  # this process's frames only
    local = imgs.to_local()
    assert local.shape == (4, H, W)
    for k in range(4):
        assert np.array_equal(local[k].numpy(), frames[4 * rank + k]), k
    # A reduction across the processes: the global sum on every one.
    total = int(imgs.to(torch.int64).sum().full_tensor())
    assert total == sum(int(f.astype(np.int64).sum()) for f in frames), total
    try:
        D.decode_batch_global_mesh(d, d.frames[:3], mesh)
        raise AssertionError("an uneven batch did not raise")
    except ValueError as e:
        assert str(e) == "batch of 3 not divisible by 2 devices", e

    stats = D.export_clip_distributed(d, outdir)
    assert stats.frames_done == 4 and stats.frames_failed == 0, stats.errors
    dist.barrier()
    dist.destroy_process_group()
    print(f"WORKER-OK {rank} first={D.frame_shard(d.frames, rank, 2)[1]}")
    return 0


def test_two_process_global_mesh_and_export(tmp_path):
    port = _free_port()
    outdir = tmp_path / "dng"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [
        subprocess.Popen([sys.executable, __file__, str(port), str(rank), str(outdir)],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-3000:]}"
        assert f"WORKER-OK {rank} first={4 * rank}" in out
    names = sorted(os.listdir(outdir))
    assert names == [f"frame_{i:06d}.dng" for i in range(FRAMES)]

    # The same clip through mcraw's export on the CPU, in this process.
    from mcraw.clip import export_clip
    from mcraw.pipeline import Decoder as JaxDecoder

    blob, _ = make_clip()
    ref = tmp_path / "ref"
    stats = export_clip(JaxDecoder(blob, backend="numpy"), str(ref))
    assert stats.frames_done == FRAMES
    for n in names:
        assert (outdir / n).read_bytes() == (ref / n).read_bytes(), n


@pytest.mark.parametrize("n_frames", range(10))
def test_frame_shard_equals_mcraw(n_frames):
    from mcraw import distributed as JD

    from mcraw_torch import distributed as D

    frames = [100 + 7 * i for i in range(n_frames)]
    for count in range(1, 5):
        got = [D.frame_shard(frames, i, count) for i in range(count)]
        assert got == [JD.frame_shard(frames, i, count) for i in range(count)]
        assert [t for ts, _ in got for t in ts] == frames  # disjoint, in order


def test_one_process_group_defaults(tmp_path):
    """In a group of one: frame_shard takes the whole clip by default, and
    decode_batch_global_mesh on a one-process mesh equals decode_batch."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from mcraw_torch import Decoder
    from mcraw_torch import distributed as D

    D.initialize(f"tcp://localhost:{_free_port()}", 1, 0)
    try:
        blob, frames = make_clip()
        d = Decoder(blob, device="cpu")
        assert D.frame_shard(d.frames) == (d.frames, 0)
        imgs, metas = D.decode_batch_global_mesh(d, d.frames[:6], DeviceMesh("cpu", [0]))
        want, want_metas = d.decode_batch(d.frames[:6])
        assert metas == want_metas
        assert torch.equal(imgs.full_tensor().to(torch.int32), want.to(torch.int32))
        assert np.array_equal(imgs.to_local().numpy(), np.stack(frames[:6]))
        stats = D.export_clip_distributed(d, str(tmp_path / "out"), prefetch=2, writers=2)
        assert stats.frames_done == FRAMES
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1], int(sys.argv[2]), sys.argv[3]))
