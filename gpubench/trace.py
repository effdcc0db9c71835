"""The traced window: the harness's host spans, torch.profiler's trace of
the card, and what the per-layer metrics read from them.

The harness opens a span around each call into a layer. In the traced
window a span is also a ``torch.profiler.record_function`` annotation,
``gb.<name>``, where the profiler records it (the thread that started the
profiler), and a row of host times (``time.time_ns``) from any thread. One
annotation, ``gb.window``, opened right after the window's start is logged,
ties the host's clock to the trace's. From the trace:

- busy: the union of the device operations' intervals inside the window;
- each device operation's total time by name;
- each idle gap, named by the innermost harness span open on the host when
  it began ("host" where none was);
- each step's device time. The profiler mirrors each annotation onto the
  card's timeline (``gpu_user_annotation``) around the operations launched
  inside it, so an operation belongs to the step whose mirror holds it;
  else to its kernel's step by name (:data:`~gpubench.roofline.KERNEL_STEP`),
  a memset to the step of the kernel after it on its stream.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from .roofline import KERNEL_STEP

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "gb."
WINDOW = PREFIX + "window"
SPAN_LOOKBACK = 32


class Spans:
    """Host spans of the traced window: (name, start ns, end ns), from any
    thread, and each a ``gb.<name>`` annotation for the profiler. Off (a
    no-op) until :meth:`start`."""

    def __init__(self):
        self.rows: list[tuple[str, int, int]] = []
        self.on = False
        self._lock = threading.Lock()

    def start(self) -> None:
        self.rows, self.on = [], True

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        from torch.profiler import record_function

        t0 = time.time_ns()
        try:
            with record_function(PREFIX + name):
                yield
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.rows.append((name, t0, t1))


def kernel_name(name: str) -> str:
    """A kernel's name without its signature, template arguments and
    namespaces."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].rsplit("::", 1)[-1]


@contextlib.contextmanager
def profiled(path: Path, device_type: str, warm=None):
    """torch.profiler over the block (the CPU, and the card on a card), its
    trace written to `path`; yields the start of the window (ns), logged
    right before the ``gb.window`` annotation opens. `warm`, a call run
    under the profiler before the window opens: the first launches under
    it are slow."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device_type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if warm is not None:
            warm()
            if device_type == "cuda":
                torch.cuda.synchronize()
        t0 = time.time_ns()
        with record_function(WINDOW):
            yield t0
            if device_type == "cuda":
                torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))


@dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: dict = field(default_factory=dict)  # name -> seconds
    idle_gaps: list = field(default_factory=list)  # [(host span, seconds)], longest first
    step_s: dict = field(default_factory=dict)  # harness step -> device seconds
    attributed: dict = field(default_factory=dict)  # how: operations


def _union(intervals):
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def _innermost(rows: list[tuple[str, float, float]]):
    """at(t): the name of the innermost of `rows` (name, start, end) open at
    t, or None. Rows overlap only across the few client threads, so the row
    open at t is among the last ones to start before it."""
    rows = sorted(rows, key=lambda r: r[1])
    starts = [r[1] for r in rows]

    def at(t: float) -> str | None:
        i = bisect.bisect_right(starts, t)
        for r in reversed(rows[max(0, i - SPAN_LOOKBACK) : i]):
            if r[2] >= t:
                return r[0]
        return None

    return at


def summarize(events: list[dict], spans: list[tuple[str, int, int]], t0_ns: int) -> Summary:
    """The traced window of a Chrome trace's `events`, with the harness's
    host `spans`; `t0_ns` is the host time logged at the window's start.
    Times below are the trace's microseconds."""
    window = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError(f"the trace has no {WINDOW} annotation")
    lo = float(window[0]["ts"])
    hi = lo + float(window[0]["dur"])
    shift = lo - t0_ns / 1e3  # trace us - host us

    def annotations(cat):
        return [(e["name"][len(PREFIX):], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                for e in events if e.get("cat") == cat and e.get("name", "").startswith(PREFIX)
                and e["name"] != WINDOW]

    host_rows = [(n, a, b) for n, a, b, _ in annotations("user_annotation")]
    host_rows += [(n, a / 1e3 + shift, b / 1e3 + shift) for n, a, b in spans]
    host_at = _innermost(host_rows)

    device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    device = [e for e in device if float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    busy = _union([(max(lo, float(e["ts"])), min(hi, float(e["ts"]) + float(e["dur"])))
                   for e in device])
    s = Summary(window_s=(hi - lo) / 1e6, busy_s=sum(b - a for a, b in busy) / 1e6)

    def name(e):
        return kernel_name(e["name"]) if e["cat"] == "kernel" else e["name"]

    for e in device:
        s.device_ops[name(e)] = s.device_ops.get(name(e), 0.0) + float(e["dur"]) / 1e6
    s.device_ops = dict(sorted(s.device_ops.items(), key=lambda kv: -kv[1]))

    gaps, prev = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            gaps.append((host_at(prev) or "host", (a - prev) / 1e6))
        prev = max(prev, b)
    s.idle_gaps = sorted(gaps, key=lambda g: -g[1])[:10]

    mirrors: dict = {}
    for n, a, b, e in annotations("gpu_user_annotation"):
        mirrors.setdefault(e.get("tid"), []).append((n, a, b))
    mirror_at = {tid: _innermost(rows) for tid, rows in mirrors.items()}
    by_stream: dict = {}
    for e in sorted(device, key=lambda e: float(e["ts"])):
        by_stream.setdefault(e.get("tid"), []).append(e)
    how: dict[str, int] = {}
    for tid, ops in by_stream.items():
        pending = []  # memsets waiting for the kernel after them
        for e in ops:
            mid = float(e["ts"]) + float(e["dur"]) / 2
            step, kind = (mirror_at[tid](mid) if tid in mirror_at else None), "annotation"
            if step is None and e["cat"] == "kernel":
                step, kind = KERNEL_STEP.get(name(e)), "name"
            if step is None and e["cat"] == "gpu_memset":
                pending.append(e)
                continue
            for m in pending + [e]:
                k = kind if m is e else f"{kind}, next kernel"
                how[k] = how.get(k, 0) + 1
                key = step or "other"
                s.step_s[key] = s.step_s.get(key, 0.0) + float(m["dur"]) / 1e6
            pending = []
        for m in pending:
            how["none"] = how.get("none", 0) + 1
            s.step_s["other"] = s.step_s.get("other", 0.0) + float(m["dur"]) / 1e6
    s.attributed = how
    return s


def read(path: Path) -> list[dict]:
    return json.loads(Path(path).read_text())["traceEvents"]
