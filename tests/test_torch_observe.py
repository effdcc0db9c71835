"""mcraw_torch.observe against mcraw.observe: the same events, fields and
summaries; the stage timer's lock under threads; device_trace on
torch.profiler (a no-op without a directory, a Chrome trace with one, the
card by default, and an error, not a silent skip, where the profiler
cannot record or there is no card)."""

import json
import logging
import sys
import threading

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
