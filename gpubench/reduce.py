"""What the per-layer metrics' readers (``metrics/<name>.py``) share: the
readings of one run's spans, counters and trace. Each returns None where
the run has nothing to read, and the harness then leaves the metric out of
its line.

A reader gets the run's record (:class:`Record`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .roofline import PEAK_BYTES_PER_S, STEPS


@dataclass
class Record:
    device_kind: str
    spans: dict  # host span -> (seconds, count), over the measured window
    trace: object = None  # trace.Summary of the traced window
    traced_bytes: dict = field(default_factory=dict)  # roofline step -> bytes it must move


def idle_pct(run: Record) -> float | None:
    """The traced window's share, in %, in which the card ran nothing."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_pct(run: Record, step: str) -> float | None:
    """The step's bytes at the card's published bandwidth over the device
    time the trace gives the step, in %."""
    t, peak = run.trace, PEAK_BYTES_PER_S.get(run.device_kind)
    moved = run.traced_bytes.get(step)
    if t is None or not peak or not moved:
        return None
    seconds = sum(t.step_s.get(s, 0.0) for s in STEPS[step])
    if seconds <= 0:
        return None
    return 100.0 * moved / peak / seconds


def span_ms(run: Record, name: str) -> float | None:
    """The mean of a host span over the window, in ms."""
    total, count = run.spans.get(name, (0.0, 0))
    return 1e3 * total / count if count else None
