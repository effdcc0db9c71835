"""Observability: structured logging, per-stage timing, profiler hooks.

The port of ``mcraw.observe``: a stage timer that aggregates parse /
unpack / emit costs, a frames-per-second counter and structured JSON-line
log records, with the same event names, fields and summaries, on the
``mcraw_torch`` logger; and :func:`device_trace`, a ``torch.profiler``
trace context (the CPU activity, plus the card's kernels and copies on a
CUDA device) written as a Chrome trace, and :func:`device_events` /
:func:`busy_us` to read the card's activity back from one.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

logger = logging.getLogger("mcraw_torch")


def log_event(event: str, **fields) -> None:
    """Structured (JSON-line) log record."""
    logger.info("%s", json.dumps({"event": event, **fields}, default=str))


@dataclass
class StageTimer:
    """Aggregates wall time per pipeline stage.

    >>> t = StageTimer()
    >>> with t.stage("parse"): ...
    >>> t.summary()  # {'parse': {'seconds': ..., 'count': 1}}
    """

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    # Stages run on thread pools (export_clip's prep/write workers);
    # += on the dicts is a read-modify-write that needs the lock.
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def summary(self) -> dict:
        return {
            k: {"seconds": round(self.totals[k], 6), "count": self.counts[k]}
            for k in sorted(self.totals)
        }

    def log(self) -> None:
        log_event("stage_timing", **self.summary())


@dataclass
class Throughput:
    """North-star counter: frames (and bytes) per second."""

    frames: int = 0
    in_bytes: int = 0
    out_bytes: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    def add(self, frames: int = 1, in_bytes: int = 0, out_bytes: int = 0):
        self.frames += frames
        self.in_bytes += in_bytes
        self.out_bytes += out_bytes

    def summary(self) -> dict:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "frames": self.frames,
            "fps": round(self.frames / dt, 2),
            "in_GBps": round(self.in_bytes / dt / 1e9, 3),
            "out_GBps": round(self.out_bytes / dt / 1e9, 3),
        }


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device: torch.device | str = "cuda"):
    """torch.profiler trace context (no-op when `trace_dir` is falsy).

    Records the CPU activity, and the CUDA activity (kernels, copies) when
    `device` is a CUDA device (the default: the card, as
    ``mcraw.observe.device_trace`` records the device; without a card it
    raises, as ``resolve_device`` does), and writes one Chrome trace,
    ``<host>_<pid>.<n>.pt.trace.json``, into `trace_dir` on exit. Pass
    ``device="cpu"`` for the CPU activity alone. A profiler that fails to
    start or to write raises."""
    if not trace_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile, supported_activities,
                                tensorboard_trace_handler)

    from .pipeline import resolve_device

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    missing = set(activities) - set(supported_activities())
    if missing:
        # torch.profiler would only warn and record nothing of them.
        raise RuntimeError(f"torch.profiler cannot record {sorted(a.name for a in missing)} "
                           "in this build")
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(trace_dir))):
        yield


# The device's activity in a Chrome trace of torch.profiler.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(events: list[dict]) -> list[dict]:
    """The kernel, memcpy and memset events of a Chrome trace's events."""
    return [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]


def busy_us(device: list[dict]) -> float:
    """The union of the events' intervals, in the trace's microseconds."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total
