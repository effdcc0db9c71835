"""Whole-clip export: streaming, overlapped, resumable.

The port of ``mcraw.clip``, with its surface and behaviour. The export has
three stages with different resources:
  1. host parse, checks and host prep (CPU; the C++ host scans),
  2. H2D transfer and the codec's unpack kernel (the card),
  3. DNG serialization and file write (CPU).
``prefetch`` prepare workers run stages 1 and 2, ``writers`` writer threads
stage 3. The launches are asynchronous, so a worker prepares its next frame
while the card decodes the one before; each writer copies its frame to the
host (the D2H waits for the kernel) off the main thread. At most
``prefetch + writers`` frames are in flight (prepared, not yet written):
``mcraw.clip`` prepares every frame ahead of its writers, which on a long
clip holds most of the clip's frames on the device at once.

Each prepare worker decodes through its own
:class:`~mcraw_torch.pipeline.FrameDecoder` (one per thread, made from the
decoder): a :class:`~mcraw_torch.kernels.staging.Staging` is one set of
buffers, and a second stage on it overwrites the first's, so no Staging is
shared between threads. All work stays on the device's current stream, and
the H2D is the staging's synchronous pageable copy: a worker reuses its host
buffer only after the copy out of it has returned.

Per-frame error isolation: a frame that raises
:class:`~mcraw_torch.errors.MotionCamException` is reported in
:attr:`ExportStats.errors` and skipped, not fatal to the clip. Resume:
frames whose DNG already exists are skipped.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from .emit.dng import dng_bytes
from .emit.wav import write_wav
from .errors import MotionCamException
from .observe import StageTimer, Throughput, log_event
from .pipeline import Decoder
from .util import outpath as _outpath


@dataclass
class ExportStats:
    frames_done: int = 0
    frames_skipped: int = 0
    frames_failed: int = 0
    errors: list = field(default_factory=list)
    wall_seconds: float = 0.0
    stage_timing: dict = field(default_factory=dict)
    throughput: dict = field(default_factory=dict)

    @property
    def fps(self) -> float:
        return self.frames_done / self.wall_seconds if self.wall_seconds else 0.0


def export_clip(
    decoder: Decoder,
    output_dir: str,
    timestamps: list[int] | None = None,
    resume: bool = False,
    prefetch: int = 4,
    writers: int = 4,
    progress=None,
    first_index: int = 0,
) -> ExportStats:
    """Export frames to frame_NNNNNN.dng with a prepare/decode/write
    pipeline; ``first_index`` offsets the output numbering (a shard of a
    clip starts at its global index). ``progress(i, path)`` is called from
    the writer threads after each frame is written."""
    os.makedirs(output_dir, exist_ok=True)
    if timestamps is None:
        timestamps = decoder.frames
    container_meta = decoder.container_metadata

    stats = ExportStats()
    stats_lock = threading.Lock()  # write() runs on up to `writers` threads
    timer = StageTimer()
    thr = Throughput()
    if decoder.timer is None:
        decoder.timer = timer  # parse/unpack stages attribute here
    t0 = time.perf_counter()
    log_event(
        "export_clip_start",
        output_dir=output_dir,
        frames=len(timestamps),
        backend=decoder.device.type,
    )

    todo: list[tuple[int, int, str]] = []
    for i, ts in enumerate(timestamps, start=first_index):
        path = _outpath(output_dir, f"frame_{i:06d}.dng")
        if resume and os.path.exists(path):
            stats.frames_skipped += 1
            continue
        todo.append((i, ts, path))

    workers = threading.local()  # each prepare thread's own FrameDecoder

    def prepare(item):
        i, ts, path = item
        if not hasattr(workers, "decode"):
            workers.decode = decoder.make_frame_decoder()
        try:
            img, meta = workers.decode(ts)
            return (i, ts, path, img, meta, None)
        except MotionCamException as e:
            return (i, ts, path, None, None, e)

    def write(item):
        i, ts, path, img, meta, err = item
        if err is not None:
            with stats_lock:
                stats.frames_failed += 1
                stats.errors.append((ts, str(err)))
            return
        with timer.stage("emit"):
            arr = img.cpu().numpy()  # the D2H waits here, off the main thread
            blob = dng_bytes(arr, meta, container_meta)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        with stats_lock:
            stats.frames_done += 1
            thr.add(frames=1, in_bytes=arr.nbytes, out_bytes=len(blob))
        if progress is not None:
            progress(i, path)

    # A frame holds its decoded image on the device from its prepare until
    # its write; preparing outruns writing, so the frames in flight are
    # bounded, or a long clip fills the card's memory.
    in_flight = threading.BoundedSemaphore(max(1, prefetch) + max(1, writers))

    def write_and_release(item):
        try:
            write(item)
        finally:
            in_flight.release()

    def prepare_and_queue(item):
        try:
            return write_pool.submit(write_and_release, prepare(item))
        except BaseException:
            in_flight.release()
            raise

    try:
        with ThreadPoolExecutor(max_workers=max(1, writers)) as write_pool:
            with ThreadPoolExecutor(max_workers=max(1, prefetch)) as prep_pool:
                queued = []
                for item in todo:
                    in_flight.acquire()
                    queued.append(prep_pool.submit(prepare_and_queue, item))
                for f in queued:
                    f.result().result()
    finally:
        if decoder.timer is timer:
            decoder.timer = None

    stats.wall_seconds = time.perf_counter() - t0
    stats.stage_timing = timer.summary()
    stats.throughput = thr.summary()
    timer.log()
    log_event(
        "export_clip_done",
        frames_done=stats.frames_done,
        frames_failed=stats.frames_failed,
        frames_skipped=stats.frames_skipped,
        wall_seconds=round(stats.wall_seconds, 3),
        **stats.throughput,
    )
    return stats


def export_wav(decoder: Decoder, output_dir: str) -> str:
    path = _outpath(output_dir, "audio.wav")
    write_wav(
        path,
        decoder.audio_sample_rate_hz(),
        decoder.num_audio_channels(),
        decoder.load_audio(),
    )
    return path
