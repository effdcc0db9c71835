"""Observability: structured logging, per-stage timing, profiler hooks.

The port of ``mcraw.observe``: a stage timer that aggregates parse /
unpack / emit costs, a frames-per-second counter and structured JSON-line
log records, with the same event names, fields and summaries, on the
``mcraw_torch`` logger; and :func:`device_trace`, a ``torch.profiler``
trace context (the CPU activity, plus the card's kernels and copies on a
CUDA device) written as a Chrome trace, and :func:`device_events` /
:func:`busy_us` to read the card's activity back from one.

The program's own spans: :func:`span` (a context) and :func:`spanned` (a
decorator) mark where the work happens — each C-entry launch
(``launch.<entry>``), each kernel wrapper's body (``offsets``,
``unpack.modern``, ``unpack.legacy``, ``develop``, ``develop.params``,
``checksum``) and the staging of a frame or a batch (``stage.scan``,
``stage.layout``, ``stage.h2d``). They are off until :func:`tracing` turns
them on for the process: off, a span is one test of a module-level flag
and a shared no-op context. On, each span keeps a :class:`Row` (host times
by ``time.time_ns``, its thread, its id and its parent's) and opens a
profiler annotation ``mcraw.<name>``: under a running profiler the span
lands in the same trace as the card's kernels, on the thread that started
the profiler, as an operator event. The annotation is
``torch._C._profiler._RecordFunctionFast``, a C++ scope about ten times
cheaper a span than ``torch.profiler.record_function``, whose cost would
slow the traced steps it measures. The record's summary is a
:class:`StageTimer` with each span's self time. The record also counts
Python's garbage collections (each one a ``gc`` row), the CUDA caching
allocator's device allocations, frees and retries over the record, and
the bytes :class:`~mcraw_torch.kernels.staging.Staging` sends host to
device. :func:`device_trace` records them inside its
profiler.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import json
import logging
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import NamedTuple

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
    # A span's time less its child spans' (the tracer's summary only).
    self_totals: dict = field(default_factory=lambda: defaultdict(float))
    # Stages run on thread pools (export_clip's prep/write workers);
    # += on the dicts is a read-modify-write that needs the lock.
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float, self_seconds: float | None = None) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1
            if self_seconds is not None:
                self.self_totals[name] += self_seconds

    def summary(self) -> dict:
        out = {}
        for k in sorted(self.totals):
            out[k] = {"seconds": round(self.totals[k], 6), "count": self.counts[k]}
            if k in self.self_totals:
                out[k]["self_seconds"] = round(self.self_totals[k], 6)
        return out

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


# The program's spans --------------------------------------------------------

PREFIX = "mcraw."  # a span's profiler annotation: PREFIX + its name
ALLOCATOR_STATS = ("num_device_alloc", "num_device_free", "num_alloc_retries")
_tracer: "Trace | None" = None  # the open record; None while tracing is off
_NOOP = contextlib.nullcontext()


class Row(NamedTuple):
    """One span of a record: host times by ``time.time_ns``."""

    name: str
    start_ns: int
    end_ns: int
    thread: int  # threading.get_ident() of the thread it ran on
    id: int
    parent: int | None  # the innermost span open on its thread when it began


class Trace:
    """The record of one :func:`tracing` context: its rows and counters,
    complete once the context has closed, and their summary."""

    def __init__(self):
        self.rows: list[Row] = []  # in the order the spans ended
        self.counters: dict[str, int] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._gcs = [0] * len(gc.get_count())  # collections by generation
        self._allocator0: dict = {}

    def stack(self) -> list[int]:
        """The ids of the spans open on this thread, innermost last."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def _gc(self, phase: str, info: dict) -> None:
        # gc.callbacks: each collection a "gc" row, under the span it stopped.
        if phase == "start":
            self._local.gc_start = time.time_ns()
            return
        start = getattr(self._local, "gc_start", None)
        if start is None:  # began before the record opened
            return
        self._local.gc_start = None
        stack = self.stack()
        self.rows.append(Row("gc", start, time.time_ns(), threading.get_ident(), next(self._ids),
                             stack[-1] if stack else None))
        self._gcs[info["generation"]] += 1

    def _open(self) -> None:
        self._allocator0 = _allocator_stats()
        gc.callbacks.append(self._gc)

    def _close(self) -> None:
        gc.callbacks.remove(self._gc)
        end = _allocator_stats()
        for k in ALLOCATOR_STATS if end else ():
            self.counters[f"cuda.{k}"] = end[k] - self._allocator0.get(k, 0)
        for gen, n in enumerate(self._gcs):
            self.counters[f"gc.gen{gen}"] = n

    def summary(self) -> dict:
        """{"spans": name -> seconds, count, self_seconds (its time less its
        child spans'); "counters": ...}"""
        children: dict = defaultdict(int)
        for r in self.rows:
            if r.parent is not None:
                children[r.parent] += r.end_ns - r.start_ns
        timer = StageTimer()
        for r in self.rows:
            ns = r.end_ns - r.start_ns
            timer.add(r.name, ns / 1e9, (ns - children[r.id]) / 1e9)
        return {"spans": timer.summary(), "counters": dict(sorted(self.counters.items()))}


def _allocator_stats() -> dict:
    """The caching allocator's ALLOCATOR_STATS summed over the cards, or {}
    where CUDA is not initialized (it has allocated nothing yet)."""
    if not torch.cuda.is_initialized():
        return {}
    stats = [torch.cuda.memory_stats(d) for d in range(torch.cuda.device_count())]
    return {k: sum(s.get(k, 0) for s in stats) for k in ALLOCATOR_STATS}


class _Span:
    __slots__ = ("trace", "name", "stack", "id", "parent", "start", "annotation")

    def __init__(self, trace: Trace, name: str):
        self.trace, self.name = trace, name

    def __enter__(self):
        self.stack = stack = self.trace.stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.trace._ids)
        stack.append(self.id)
        self.annotation = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self.annotation.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.annotation.__exit__(*exc)
        self.stack.pop()
        self.trace.rows.append(Row(self.name, self.start, end, threading.get_ident(), self.id,
                                   self.parent))
        return False


def span(name: str):
    """A context that records span `name` while :func:`tracing` is on; a
    shared no-op context while it is off."""
    if _tracer is None:
        return _NOOP
    return _Span(_tracer, name)


def spanned(name: str):
    """Decorator: every call of the function is span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _tracer is None:
                return fn(*args, **kwargs)
            with _Span(_tracer, name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int) -> None:
    """Adds n to the open record's counter `name`; nothing while tracing is
    off."""
    if _tracer is not None:
        _tracer.count(name, n)


@contextlib.contextmanager
def tracing():
    """Turns the program's spans and counters on for the process and yields
    their :class:`Trace`, complete once the context closes. One at a time:
    a second raises RuntimeError."""
    global _tracer
    if _tracer is not None:
        raise RuntimeError("tracing is already on")
    record = Trace()
    record._open()
    _tracer = record
    try:
        yield record
    finally:
        _tracer = None
        record._close()


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device: torch.device | str = "cuda"):
    """torch.profiler trace context (no-op when `trace_dir` is falsy).

    Records the CPU activity, and the CUDA activity (kernels, copies) when
    `device` is a CUDA device (the default: the card, as
    ``mcraw.observe.device_trace`` records the device; without a card it
    raises, as ``resolve_device`` does), and writes one Chrome trace,
    ``<host>_<pid>.<n>.pt.trace.json``, into `trace_dir` on exit. Pass
    ``device="cpu"`` for the CPU activity alone. A profiler that fails to
    start or to write raises. The program's spans are on inside it
    (:func:`tracing`): the trace holds them as ``mcraw.<name>``, the context
    yields their record, and their summary and counters are logged as one
    ``span_timing`` event."""
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
        with tracing() as record:
            yield record
    log_event("span_timing", **record.summary())


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
