"""mcraw_torch.clip against mcraw.clip: the same inputs (clips written by
mcraw's encoder from a numpy seed) through the port's export on the CPU and
mcraw's with the NumPy backend give byte-identical DNGs and WAVs and the same
statistics (tolerance 0). Each test follows one of tests/test_clip_export.py;
the thread tests check that the export's prepare workers share no staging
buffers and that the launch counters lose no update."""

import logging
import os
import sys
import threading
import time

import numpy as np
import pytest

from mcraw import clip as JC
from mcraw import encode as E
from mcraw.metadata import example_container_metadata, example_frame_metadata
from mcraw.pipeline import Decoder as JaxDecoder
from mcraw_torch import Decoder
from mcraw_torch import clip as PC
from mcraw_torch.emit.dng import dng_bytes
from mcraw_torch.kernels import legacy as L
from mcraw_torch.kernels import native
from mcraw_torch.kernels import unpack as U
from mcraw_torch.kernels.staging import Staging

# (codec, width, height) of each frame: modern, legacy, and a clip that
# mixes both codecs and two geometries.
CLIPS = {
    "modern": [(7, 192, 16)] * 5,
    "legacy": [(6, 200, 16)] * 4,
    "mixed": [(7, 192, 16), (6, 200, 16), (7, 128, 8), (6, 96, 12), (7, 192, 16)],
}


def make_clip(seed: int, frames, corrupt_at=None):
    """(container bytes, source images); frame `corrupt_at` gets an 8-byte
    zero payload in place of its image."""
    rng = np.random.default_rng(seed)
    writer = E.ContainerWriter(example_container_metadata())
    imgs = []
    for i, (codec, w, h) in enumerate(frames):
        img = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
        payload = E.encode_modern(img) if codec == 7 else E.encode_legacy(img)
        if i == corrupt_at:
            payload, img = b"\x00" * 8, None
        writer.add_frame(100 + i, payload, example_frame_metadata(w, h, codec))
        writer.add_audio(rng.integers(-100, 100, size=64).astype(np.int16), i * 1000)
        imgs.append(img)
    return writer.finish(), imgs


def both_exports(blob, tmp_path, **kw):
    """export_clip of the port (device="cpu") and of mcraw (backend="numpy")
    into tmp_path/mine and tmp_path/ref: (stats, stats)."""
    got = PC.export_clip(Decoder(blob, device="cpu"), str(tmp_path / "mine"), **kw)
    want = JC.export_clip(JaxDecoder(blob, backend="numpy"), str(tmp_path / "ref"), **kw)
    return got, want


def same_files(tmp_path) -> list[str]:
    names = sorted(os.listdir(tmp_path / "mine"))
    assert names == sorted(os.listdir(tmp_path / "ref"))
    for n in names:
        assert (tmp_path / "mine" / n).read_bytes() == (tmp_path / "ref" / n).read_bytes(), n
    return names


def counts(stats):
    return (stats.frames_done, stats.frames_skipped, stats.frames_failed, stats.errors)


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_export_clip_full(tmp_path, name):
    blob, imgs = make_clip(1, CLIPS[name])
    got, want = both_exports(blob, tmp_path)
    assert counts(got) == counts(want) == (len(imgs), 0, 0, [])
    assert same_files(tmp_path) == [f"frame_{i:06d}.dng" for i in range(len(imgs))]
    d = Decoder(blob, device="cpu")
    for i, (ts, img) in enumerate(zip(d.frames, imgs)):
        _, meta = d._reader.frame_payload(ts)
        want_dng = dng_bytes(img, meta, d.container_metadata)
        assert (tmp_path / "mine" / f"frame_{i:06d}.dng").read_bytes() == want_dng
    assert got.fps > 0 and got.wall_seconds > 0


@pytest.mark.parametrize("name", ["modern", "mixed"])
def test_export_resume_skips_existing(tmp_path, name):
    blob, imgs = make_clip(2, CLIPS[name])
    d, ref = Decoder(blob, device="cpu"), JaxDecoder(blob, backend="numpy")
    PC.export_clip(d, str(tmp_path / "mine"), timestamps=d.frames[:2])
    JC.export_clip(ref, str(tmp_path / "ref"), timestamps=ref.frames[:2])
    got, want = both_exports(blob, tmp_path, resume=True)
    assert counts(got) == counts(want) == (len(imgs) - 2, 2, 0, [])
    same_files(tmp_path)


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_export_isolates_corrupt_frame(tmp_path, name):
    """One corrupt frame is reported with its timestamp and the reference's
    error text, and skipped; the rest of the clip is written."""
    blob, imgs = make_clip(3, CLIPS[name], corrupt_at=1)
    got, want = both_exports(blob, tmp_path)
    assert counts(got) == counts(want)
    assert (got.frames_done, got.frames_failed) == (len(imgs) - 1, 1)
    assert got.errors[0][0] == 101
    same_files(tmp_path)


@pytest.mark.parametrize("first_index", [0, 7])
def test_export_first_index(tmp_path, first_index):
    blob, imgs = make_clip(4, CLIPS["mixed"])
    d = Decoder(blob, device="cpu")
    got, want = both_exports(blob, tmp_path, timestamps=d.frames[1:4], first_index=first_index)
    assert counts(got) == counts(want) == (3, 0, 0, [])
    assert same_files(tmp_path) == [f"frame_{first_index + i:06d}.dng" for i in range(3)]


def test_export_progress_calls(tmp_path):
    blob, imgs = make_clip(5, CLIPS["modern"])
    calls = {}
    for side, export, d in (("mine", PC.export_clip, Decoder(blob, device="cpu")),
                            ("ref", JC.export_clip, JaxDecoder(blob, backend="numpy"))):
        seen = []
        export(d, str(tmp_path / side), progress=lambda i, p: seen.append((i, p)))
        calls[side] = sorted((i, os.path.basename(p)) for i, p in seen)
    assert calls["mine"] == calls["ref"] == [(i, f"frame_{i:06d}.dng") for i in range(5)]


def test_export_emits_observability(tmp_path, caplog):
    """export_clip drives observe: stage timings for parse / unpack / emit
    and the start / stage_timing / done events on the mcraw_torch logger;
    the timer it attached is detached afterwards."""
    blob, _ = make_clip(6, CLIPS["mixed"])
    d = Decoder(blob, device="cpu")
    with caplog.at_level(logging.INFO, logger="mcraw_torch"):
        stats = PC.export_clip(d, str(tmp_path))
    assert set(stats.stage_timing) == {"parse", "unpack", "emit"}
    assert all(v["count"] == 5 for v in stats.stage_timing.values())
    assert stats.throughput["frames"] == 5
    events = [r.message for r in caplog.records if r.name == "mcraw_torch"]
    assert [e.split('"')[3] for e in events] == [
        "export_clip_start", "stage_timing", "export_clip_done"]
    assert '"backend": "cpu"' in events[0] and '"frames": 5' in events[0]
    assert d.timer is None


def test_export_keeps_a_timer_the_caller_set(tmp_path):
    from mcraw_torch.observe import StageTimer

    blob, _ = make_clip(6, CLIPS["modern"])
    d = Decoder(blob, device="cpu")
    d.timer = mine = StageTimer()
    stats = PC.export_clip(d, str(tmp_path))
    assert d.timer is mine
    assert mine.summary()["parse"]["count"] == mine.summary()["unpack"]["count"] == 5
    assert set(stats.stage_timing) == {"emit"}


def test_export_wav(tmp_path):
    blob, _ = make_clip(7, CLIPS["mixed"])
    os.makedirs(tmp_path / "mine", exist_ok=True)
    os.makedirs(tmp_path / "ref", exist_ok=True)
    a = PC.export_wav(Decoder(blob, device="cpu"), str(tmp_path / "mine"))
    b = JC.export_wav(JaxDecoder(blob, backend="numpy"), str(tmp_path / "ref"))
    assert os.path.basename(a) == os.path.basename(b) == "audio.wav"
    same_files(tmp_path)


# -- threads ---------------------------------------------------------------------------


def test_prepare_workers_share_no_staging(tmp_path, monkeypatch):
    """Each prepare worker has its own FrameDecoder: no Staging is laid out
    by two threads, and every DNG is byte-identical to mcraw's. Each layout
    sleeps a little so that the four workers all take frames."""
    frames = [(7, 192, 16), (6, 200, 16)] * 5
    blob, _ = make_clip(8, frames)
    users: dict[int, set] = {}
    host = Staging.host

    def recording_host(self, *parts):
        users.setdefault(id(self), set()).add(threading.get_ident())
        time.sleep(0.005)
        return host(self, *parts)

    monkeypatch.setattr(Staging, "host", recording_host)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got, want = both_exports(blob, tmp_path, prefetch=4, writers=4)
    finally:
        sys.setswitchinterval(switch)
    assert counts(got) == counts(want) == (10, 0, 0, [])
    same_files(tmp_path)
    assert all(len(threads) == 1 for threads in users.values()), users
    assert len(set().union(*users.values())) > 1  # several workers took part
    # At most one staging per (worker, codec, geometry): two keys here.
    assert len(users) <= 2 * len(set().union(*users.values()))


def test_launch_counters_lose_no_update(tmp_path):
    """The wrappers count under a lock: an export from four workers, with a
    short switch interval, counts exactly one plain call per frame."""
    blob, _ = make_clip(9, [(7, 64, 8), (6, 64, 8)] * 12)
    before = (U.PLAIN_CALLS, L.PLAIN_CALLS)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        stats = PC.export_clip(Decoder(blob, device="cpu"), str(tmp_path), prefetch=8)
    finally:
        sys.setswitchinterval(switch)
    assert stats.frames_done == 24
    assert (U.PLAIN_CALLS - before[0], L.PLAIN_CALLS - before[1]) == (12, 12)


def test_scan_pool_is_made_once_under_threads(monkeypatch):
    """Legacy parallel scans from several export workers at once share one
    scan pool (a check-then-act without the lock made one per thread)."""
    import concurrent.futures as cf

    made = []
    real = cf.ThreadPoolExecutor

    def slow_pool(*args, **kw):
        time.sleep(0.05)
        made.append(real(*args, **kw))
        return made[-1]

    monkeypatch.setattr(native, "_SCAN_POOL", None)
    monkeypatch.setattr(cf, "ThreadPoolExecutor", slow_pool)
    got = []
    threads = [threading.Thread(target=lambda: got.append(native._scan_pool()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(made) == 1 and len(got) == 4 and all(p is made[0] for p in got)
    made[0].shutdown()


def test_export_bounds_the_frames_in_flight(tmp_path, monkeypatch):
    """A slow writer holds the prepare workers back: at most prefetch +
    writers frames are decoded and not yet written at any time (mcraw's
    export prepares every frame ahead of its writers), and the DNGs are
    still mcraw's."""
    from mcraw_torch import pipeline

    blob, imgs = make_clip(10, [(7, 64, 8)] * 12)
    lock, alive, peak = threading.Lock(), [0], [0]
    decode, emit = pipeline.FrameDecoder.__call__, PC.dng_bytes

    def counted_decode(self, ts):
        out = decode(self, ts)
        with lock:
            alive[0] += 1
            peak[0] = max(peak[0], alive[0])
        return out

    def slow_emit(*args):
        time.sleep(0.02)
        with lock:
            alive[0] -= 1
        return emit(*args)

    monkeypatch.setattr(pipeline.FrameDecoder, "__call__", counted_decode)
    monkeypatch.setattr(PC, "dng_bytes", slow_emit)
    got, want = both_exports(blob, tmp_path, prefetch=2, writers=1)
    assert counts(got) == counts(want) == (12, 0, 0, [])
    same_files(tmp_path)
    assert alive[0] == 0 and 1 <= peak[0] <= 3


def test_export_raises_what_is_not_a_frame_error(tmp_path, monkeypatch):
    """An error other than MotionCamException (a fault, not a corrupt frame)
    ends the export with that error, as in mcraw, and detaches the timer;
    the frames in flight do not hang it."""
    from mcraw_torch import pipeline

    blob, _ = make_clip(11, [(7, 64, 8)] * 8)
    decode = pipeline.FrameDecoder.__call__

    def failing(self, ts):
        if ts == 103:
            raise RuntimeError("device fault")
        return decode(self, ts)

    monkeypatch.setattr(pipeline.FrameDecoder, "__call__", failing)
    d = Decoder(blob, device="cpu")
    with pytest.raises(RuntimeError, match="device fault"):
        PC.export_clip(d, str(tmp_path), prefetch=2, writers=1)
    assert d.timer is None
