"""mcraw_torch.observe against mcraw.observe: the same events, fields and
summaries; the stage timer's lock under threads; device_trace on
torch.profiler (a no-op without a directory, a Chrome trace with one, the
card by default, and an error, not a silent skip, where the profiler
cannot record or there is no card); the program's spans (off by default,
nested with parents and self time, on the profiler's clock, the
allocator read at open and close only, apart by thread)."""

import gc
import json
import logging
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mcraw import observe as JO
from mcraw_torch import observe as PO


def test_log_event_equals_mcraw(caplog):
    with caplog.at_level(logging.INFO):
        for mod in (PO, JO):
            mod.log_event("decode", clip="x.mcraw", frames=7, path=object)
    mine, ref = caplog.records[-2:]
    assert (mine.name, ref.name) == ("mcraw_torch", "mcraw")
    assert mine.message == ref.message
    assert json.loads(mine.message)["event"] == "decode"


def test_stage_timer_and_throughput_shapes_equal_mcraw(caplog):
    timers = []
    for mod in (PO, JO):
        t = mod.StageTimer()
        for name in ("unpack", "parse", "parse"):
            with t.stage(name):
                pass
        timers.append(t.summary())
    assert [{k: v["count"] for k, v in s.items()} for s in timers] == [
        {"parse": 2, "unpack": 1}] * 2
    assert list(timers[0]) == list(timers[1]) == ["parse", "unpack"]
    sums = []
    for mod in (PO, JO):
        th = mod.Throughput()
        th.add(frames=3, in_bytes=300, out_bytes=600)
        sums.append(th.summary())
    assert list(sums[0]) == list(sums[1]) == ["frames", "fps", "in_GBps", "out_GBps"]
    assert sums[0]["frames"] == sums[1]["frames"] == 3 and sums[0]["fps"] > 0
    with caplog.at_level(logging.INFO, logger="mcraw_torch"):
        t = PO.StageTimer()
        with t.stage("emit"):
            pass
        t.log()
    rec = json.loads(caplog.records[-1].message)
    assert rec["event"] == "stage_timing" and rec["emit"]["count"] == 1


def test_stage_timer_counts_every_stage_under_threads():
    """The timer's lock: 8 threads x 500 stages, a short switch interval,
    no count lost."""
    t = PO.StageTimer()

    def work():
        for _ in range(500):
            with t.stage("emit"):
                pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert t.summary()["emit"]["count"] == 4000


@pytest.mark.parametrize("trace_dir", [None, ""])
def test_device_trace_is_a_no_op_without_a_directory(tmp_path, monkeypatch, trace_dir):
    monkeypatch.chdir(tmp_path)
    with PO.device_trace(trace_dir, "cuda"):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_device_trace_writes_a_chrome_trace(tmp_path):
    from mcraw_torch import Decoder
    from mcraw_torch.encode import ContainerWriter, encode_modern
    from mcraw_torch.metadata import example_container_metadata, example_frame_metadata

    writer = ContainerWriter(example_container_metadata())
    writer.add_frame(1, encode_modern(torch.arange(64 * 8).reshape(8, 64).numpy()
                                      .astype("uint16")), example_frame_metadata(64, 8))
    d = Decoder(writer.finish(), device="cpu")
    with PO.device_trace(str(tmp_path / "t"), d.device):
        d.load_frame(d.frames[0])
    (trace,) = (tmp_path / "t").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "aten::cumsum" in names  # the plain unpack's device prep


def test_device_trace_raises_where_it_cannot_record(tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity

    # A card that the profiler cannot trace: the CUDA activity is missing.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="cannot record"):
        with PO.device_trace(str(tmp_path / "t"), "cuda:0"):
            pass
    with pytest.raises(RuntimeError):
        with PO.device_trace("/proc/no/such/dir", "cpu"):
            torch.ones(2).sum()


@pytest.mark.parametrize("args", [(), ("cuda",)])
def test_device_trace_records_the_card_by_default(tmp_path, monkeypatch, args):
    """As mcraw.observe.device_trace(trace_dir) records the device, the
    port's records the card unless asked for the CPU: with no card it
    raises the "no CUDA device" error and writes no CPU-only trace."""
    from mcraw_torch import MotionCamException

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MotionCamException, match="no CUDA device"):
        with PO.device_trace(str(tmp_path / "t"), *args):
            torch.ones(2).sum()
    assert not (tmp_path / "t").exists()


# -- the program's spans ------------------------------------------------------------


def _modern_batch(frames=2, height=8, width=64):
    """A small modern batch staged on the CPU: (staging, DeviceBatch)."""
    from mcraw_torch.encode import encode_modern
    from mcraw_torch.kernels import unpack as U
    from mcraw_torch.kernels.staging import Staging

    rng = np.random.default_rng(5)
    payloads = [np.frombuffer(encode_modern(rng.integers(0, 4096, size=(height, width))
                                            .astype(np.uint16)), np.uint8)
                for _ in range(frames)]
    staging = Staging("cpu")
    return staging, U.stage_modern_batch(staging, payloads, width, height)


def _step(batch, height=8, width=64):
    """One grade step of the benchmark's shape, on the CPU: offsets,
    batched unpack, develop, checksum."""
    from mcraw_torch import preview as P
    from mcraw_torch.kernels import checksum as C
    from mcraw_torch.kernels import unpack as U
    from mcraw_torch.kernels.tables import modern_tables

    offsets = U.block_offsets(batch.bits, modern_tables("cpu"))
    planes = U.decode_modern_batch_device(
        batch.words, batch.bases, batch.lengths, batch.bits, batch.refs, offsets,
        ty=batch.tiles_y, tx=batch.tiles_x, height=height, width=width)
    rgba = P.develop_rgba(planes, np.zeros(4, np.float32), np.float32(4095),
                          np.ones(3, np.float32), np.eye(3, dtype=np.float32),
                          cfa=(0, 1, 1, 2))
    return C.device_checksum(rgba)


def _events(path) -> list[dict]:
    (trace,) = path.glob("*.pt.trace.json")
    return json.loads(trace.read_text())["traceEvents"]


def test_spans_are_off_by_default(tmp_path):
    """Off: a span is the one shared no-op context; the wrappers and the
    staging record no row and no mcraw. annotation under a running
    profiler, and no gc callback is installed."""
    from torch.profiler import ProfilerActivity, profile

    assert PO.span("offsets") is PO.span("stage.h2d")
    callbacks = list(gc.callbacks)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(_modern_batch()[1])
        PO.count("h2d_bytes", 10)
    prof.export_chrome_trace(str(tmp_path / "off.pt.trace.json"))
    assert not [e for e in _events(tmp_path) if str(e.get("name", "")).startswith(PO.PREFIX)]
    assert gc.callbacks == callbacks and PO._tracer is None


def test_spans_nest_with_parents_and_self_time():
    with PO.tracing() as rec:
        with PO.span("outer"):
            with PO.span("inner"):
                time.sleep(0.002)
            with PO.span("inner"):
                pass
            time.sleep(0.001)
        with PO.span("outer"):
            gc.collect()
    rows = sorted(rec.rows, key=lambda r: r.start_ns)
    outer, inner0, inner1, outer1, collected = rows
    assert [r.name for r in rows] == ["outer", "inner", "inner", "outer", "gc"]
    assert outer.parent is None and outer1.parent is None
    assert inner0.parent == inner1.parent == outer.id and collected.parent == outer1.id
    assert len({r.id for r in rec.rows}) == 5
    assert {r.thread for r in rec.rows} == {threading.get_ident()}
    s = rec.summary()["spans"]
    assert s["outer"]["count"] == 2 and s["inner"]["count"] == 2 and s["gc"]["count"] >= 1
    children = sum(r.end_ns - r.start_ns for r in (inner0, inner1, collected))
    total = sum(r.end_ns - r.start_ns for r in (outer, outer1))
    assert s["outer"]["self_seconds"] == pytest.approx((total - children) / 1e9, abs=2e-6)
    assert s["outer"]["self_seconds"] >= 0.001 - 1e-4
    assert s["inner"]["self_seconds"] == s["inner"]["seconds"] >= 0.002
    assert rec.counters["gc.gen2"] >= 1  # gc.collect() is a full collection
    assert gc.callbacks.count(rec._gc) == 0 and PO._tracer is None


def test_tracing_is_one_record_at_a_time():
    with PO.tracing():
        with pytest.raises(RuntimeError, match="already on"):
            with PO.tracing():
                pass
    with PO.tracing() as rec:
        pass
    assert rec.rows == [] and PO._tracer is None


def test_wrappers_and_staging_are_spans():
    """The staging's scan, layout and H2D (and its bytes), and each
    wrapper's body: offsets, unpack.modern, develop.params, develop,
    checksum. A C-entry launch is launch.<entry>, round the library
    lookup and the call."""
    from mcraw_torch.kernels import build

    with PO.tracing() as rec:
        staging, batch = _modern_batch()
        _step(batch)
    names = [r.name for r in rec.rows]
    assert names == ["stage.scan", "stage.layout", "stage.h2d", "offsets", "unpack.modern",
                     "develop.params", "develop", "checksum"]
    assert all(r.parent is None for r in rec.rows)
    assert rec.counters["h2d_bytes"] == staging._used > 0

    class Lib:
        @staticmethod
        def mcraw_checksum(*args):
            time.sleep(0.001)
            return 0

    build_lib = build.lib
    build.lib = lambda: Lib
    try:
        with PO.tracing() as rec:
            with PO.span("checksum"):
                build.launch("mcraw_checksum", (), 1, 2)
    finally:
        build.lib = build_lib
    launch, wrapper = rec.rows  # in the order they ended
    assert launch.name == "launch.mcraw_checksum" and launch.parent == wrapper.id
    s = rec.summary()["spans"]
    assert s["launch.mcraw_checksum"]["count"] == 1 and s["launch.mcraw_checksum"]["seconds"] >= 1e-3
    assert s["checksum"]["self_seconds"] < s["checksum"]["seconds"] - 1e-3 + 1e-4


def test_spans_land_in_the_profilers_trace_on_its_clock(tmp_path):
    """Each span is an mcraw.<name> event of the trace, and its row's host
    times agree with it within 0.1 ms once shifted by a window annotation
    opened right after its host time was logged (and by no more than the
    time that opening took); relative to the first span, within 0.1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):  # the first annotation under a profiler is slow
            pass
        t0_ns = time.time_ns()
        with record_function("window"):
            opened_us = (time.time_ns() - t0_ns) / 1e3
            with PO.tracing() as rec:
                _step(_modern_batch()[1])
    prof.export_chrome_trace(str(tmp_path / "on.pt.trace.json"))
    events = _events(tmp_path)
    (window,) = [e for e in events if e.get("name") == "window"]
    shift = float(window["ts"]) - t0_ns / 1e3
    ours = sorted((e for e in events if str(e.get("name", "")).startswith(PO.PREFIX)),
                  key=lambda e: float(e["ts"]))
    rows = sorted((r for r in rec.rows if r.name != "gc"), key=lambda r: r.start_ns)
    assert [e["name"] for e in ours] == [PO.PREFIX + r.name for r in rows]
    first_row, first_event = rows[0].start_ns / 1e3, float(ours[0]["ts"])
    for e, r in zip(ours, rows):
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        assert r.start_ns / 1e3 + shift == pytest.approx(start, abs=100 + opened_us)
        assert r.end_ns / 1e3 + shift == pytest.approx(end, abs=100 + opened_us)
        assert r.start_ns / 1e3 - first_row == pytest.approx(start - first_event, abs=100)


def test_allocator_counters_are_read_at_open_and_close(monkeypatch):
    reads = []

    def memory_stats(device=None):
        reads.append(device)
        n = len(reads)
        return {"num_device_alloc": 10 * n, "num_device_free": 3 * n, "num_alloc_retries": 0}

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    with PO.tracing() as rec:
        for _ in range(50):
            with PO.span("offsets"):
                pass
        assert len(reads) == 1
    assert len(reads) == 2
    assert (rec.counters["cuda.num_device_alloc"], rec.counters["cuda.num_device_free"],
            rec.counters["cuda.num_alloc_retries"]) == (10, 3, 0)


def test_spans_keep_their_threads_apart():
    """8 threads x 300 nested spans under a short switch interval: no row
    lost, each child's parent the span open on its own thread."""
    def work():
        for _ in range(300):
            with PO.span("outer"):
                with PO.span("inner"):
                    pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with PO.tracing() as rec:
            threads = [threading.Thread(target=work) for _ in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    by_id = {r.id: r for r in rec.rows}
    inner = [r for r in rec.rows if r.name == "inner"]
    assert len(inner) == len(rec.rows) - len(inner) - sum(r.name == "gc" for r in rec.rows)
    assert len(inner) == 2400
    for r in inner:
        parent = by_id[r.parent]
        assert parent.name == "outer" and parent.thread == r.thread
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns


def test_device_trace_holds_the_programs_spans(tmp_path, caplog):
    """device_trace turns the spans on: its trace holds the staging and the
    wrappers as mcraw.<name>, it yields their record, and it logs their
    summary and counters as one span_timing event."""
    with caplog.at_level(logging.INFO, logger="mcraw_torch"):
        with PO.device_trace(str(tmp_path / "t"), "cpu") as rec:
            _step(_modern_batch()[1])
    names = {e.get("name") for e in _events(tmp_path / "t")}
    assert {"mcraw.stage.h2d", "mcraw.offsets", "mcraw.unpack.modern", "mcraw.develop",
            "mcraw.checksum"} <= names
    (event,) = [json.loads(r.message) for r in caplog.records
                if json.loads(r.message)["event"] == "span_timing"]
    assert event["spans"] == rec.summary()["spans"] and event["spans"]["checksum"]["count"] == 1
    assert event["counters"]["h2d_bytes"] > 0 and PO._tracer is None
