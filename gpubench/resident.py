"""A shot held on the card, looped over in batched steps (traffic mode
``resident``): the grading and decoding cells.

Set-up stages the shot with the program's own batch staging
(``kernels.unpack.stage_modern_batch`` / ``kernels.legacy.stage_legacy_batch``),
one staging for each batch of ``batch_frames`` consecutive shot frames. A
step is one batch through the program:

1. ``kernels.unpack.block_offsets`` (the modern codec's device prep);
2. ``decode_modern_batch_device`` / ``decode_legacy_batch_device``;
3. with ``develop`` set, ``preview.develop_rgba`` of the (F, H, W) planes,
   with the shot's one set of grade parameters;
4. ``kernels.checksum.device_checksum`` of what the step made (the RGBA,
   or the planes), added into one device accumulator: the consumer that
   reads each frame once.

The loop plays the shot's batches in order, again and again, and keeps at
most ``in_flight`` steps queued on the card before it waits for the oldest.
It keeps the outputs of a few steps, at times drawn from the seed, for the
check after the window.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from . import check
from .trace import Spans


class Shot:
    """The staged shot and its step on one device."""

    def __init__(self, inputs, config: dict, traffic: dict, device):
        from mcraw_torch.kernels import legacy as L
        from mcraw_torch.kernels import unpack as U
        from mcraw_torch.kernels.staging import Staging

        self.config, self.traffic, self.device = config, traffic, device
        self.h, self.w = config["height"], config["width"]
        self.modern = config["codec"] == "modern"
        n = traffic["batch_frames"]
        order = inputs.order
        if len(order) % n:
            raise ValueError(f"a shot of {len(order)} frames does not split into batches of {n}")
        self.frames = [order[i : i + n] for i in range(0, len(order), n)]
        stage = U.stage_modern_batch if self.modern else L.stage_legacy_batch
        self.batches = [stage(Staging(device), [inputs.payloads[k] for k in frames], self.w, self.h)
                        for frames in self.frames]
        self.grade = inputs.grade
        self.demosaic = traffic.get("develop")

    def step_fn(self, spans: Spans):
        """step(batch index, accumulator) -> (planes, what was summed, its
        checksum)."""
        from mcraw_torch import preview as P
        from mcraw_torch.kernels import checksum as C
        from mcraw_torch.kernels import legacy as L
        from mcraw_torch.kernels import unpack as U
        from mcraw_torch.kernels.tables import modern_tables

        h, w = self.h, self.w
        g = self.grade
        black, white = np.asarray(g["black"]), np.float32(g["white"])
        neutral = np.float32(g["neutral"])
        fwd = np.float32(g["forward"]).reshape(3, 3)
        cfa = self.cfa
        tables = modern_tables(self.device) if self.modern else None

        def step(b: int, acc: torch.Tensor):
            bt = self.batches[b]
            if self.modern:
                with spans("offsets"):
                    offsets = U.block_offsets(bt.bits, tables)
                with spans("decode"):
                    planes = U.decode_modern_batch_device(
                        bt.words, bt.bases, bt.lengths, bt.bits, bt.refs, offsets,
                        ty=bt.tiles_y, tx=bt.tiles_x, height=h, width=w)
            else:
                with spans("decode"):
                    planes = L.decode_legacy_batch_device(*bt, height=h, width=w)
            out = planes
            if self.demosaic is not None:
                with spans("develop"):
                    out = P.develop_rgba(planes, black, white, neutral, fwd, cfa=cfa,
                                         demosaic=self.demosaic)
            with spans("checksum"):
                summed = C.device_checksum(out)
                acc.add_(summed)
            return planes, out, summed

        return step

    @property
    def cfa(self) -> tuple:
        from .ref.develop import CFA_PATTERNS

        return CFA_PATTERNS[self.config["sensor"]]


def _event(device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _wait(ev) -> None:
    if ev is not None:
        ev.synchronize()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """The closed loop over the shot's batches."""

    def __init__(self, shot: Shot, spans: Spans):
        self.shot, self.spans = shot, spans
        self.step = shot.step_fn(spans)
        self.acc = torch.zeros((), dtype=torch.int64, device=shot.device)
        self.next = 0  # the next batch to play

    def run(self, seconds: float | None, steps: int | None = None, keep_at=()) -> dict:
        """Steps until `seconds` have passed (or `steps` steps), then wait
        for the card. Returns the steps, the seconds from the first enqueue
        to the card's last result, the host's seconds spent enqueueing, the
        batches played and the kept outputs [(frames, planes, rgba, the
        step's checksum)]."""
        shot, device = self.shot, self.shot.device
        in_flight = self.shot.traffic["in_flight"]
        keep = sorted(keep_at)
        queued = collections.deque()
        kept, played = [], []
        enqueue = 0.0
        n = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds if seconds is not None else None
        while (steps is None or n < steps) and (deadline is None
                                                or time.perf_counter() < deadline):
            b = self.next
            self.next = (b + 1) % len(shot.batches)
            t = time.perf_counter()
            planes, out, summed = self.step(b, self.acc)
            enqueue += time.perf_counter() - t
            played.append(b)
            if keep and (t - t0) >= keep[0] * (seconds or 0):
                keep.pop(0)
                kept.append((shot.frames[b], planes, out if shot.demosaic else None, summed))
            queued.append(_event(device))
            if len(queued) > in_flight:
                _wait(queued.popleft())
            n += 1
        _sync(device)
        return {"steps": n, "seconds": time.perf_counter() - t0, "enqueue_s": enqueue,
                "played": played, "kept": kept}


def warm(loop: Loop, keep: int) -> None:
    """Every batch once, holding as many outputs as the window keeps, so
    that the window allocates nothing new."""
    held = loop.run(None, steps=len(loop.shot.batches), keep_at=[0.0] * keep)
    del held
    loop.next = 0


def run(cell, inputs, device, seconds: float, trace_path, seed: int, setup) -> dict:
    """One run of a resident cell: the staged shot, the warm-up, the
    window, the traced window where `trace_path` is set, and the check."""
    config, traffic = cell.config, cell.traffic
    with setup("stage"):
        shot = Shot(inputs, config, traffic, device)
        _sync(device)
    spans = Spans()
    loop = Loop(shot, spans)
    rng = np.random.default_rng([seed, 11])
    keep_at = sorted(rng.uniform(0.05, 0.95, traffic["check_steps"]).tolist())
    with setup("warm"):
        warm(loop, len(keep_at))
    setup.done()

    acc0 = int(loop.acc)
    res = loop.run(seconds, keep_at=keep_at)
    acc = (int(loop.acc) - acc0) & check.MASK
    per_step = traffic["batch_frames"]
    frames = res["steps"] * per_step
    out = {"rate": frames / res["seconds"], "attempted": frames, "failed": 0,
           "spans": {"enqueue": (res["enqueue_s"], res["steps"])},
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0}
    if trace_path is not None:
        from .trace import profiled, read, summarize

        loop.next = 0
        with profiled(trace_path, device.type, warm=lambda: loop.run(None, steps=2)) as t0_ns:
            spans.start()
            traced = loop.run(traffic["trace_seconds"])
        spans.on = False
        out["trace"] = summarize(read(trace_path), spans.rows, t0_ns)
        out["traced_bytes"] = _bytes(shot, inputs, traced["played"])
        out["spans_rows"] = spans.rows

    # The check, once the window has closed and the program's state is freed.
    summed = None
    if traffic.get("develop") is None:
        summed = [k for b in res["played"] for k in shot.frames[b]]
    kept, grade, cfa, demosaic = res["kept"], shot.grade, shot.cfa, shot.demosaic
    del shot, loop, res
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = check.Reference(inputs.payloads, config, device)
    checks = check.Checks()
    checks.add("unchecked", int(not kept), 0)
    check.resident(checks, kept, ref, config, grade, cfa, demosaic, acc, summed)
    out["checks"] = checks
    out["control"] = lambda dtype=check.CONTROL_DEVELOP_DTYPE: _control(
        kept, ref, config, grade, cfa, demosaic, summed, dtype)
    return out


def _control(kept, ref, config, grade, cfa, demosaic, summed, dtype) -> check.Checks:
    checks = check.Checks()
    check.resident(checks, kept, ref, config, grade, cfa, demosaic, 0, summed, control=dtype)
    return checks


def _bytes(shot: Shot, inputs, played: list[int]) -> dict:
    """The bytes the traced steps' decode and develop must move."""
    from .roofline import decode_bytes, develop_bytes

    c = shot.config
    per_frame = [decode_bytes(c["codec"], len(p), c["width"], c["height"])
                 for p in inputs.payloads]
    frames = [k for b in played for k in shot.frames[b]]
    out = {"decode": sum(per_frame[k] for k in frames)}
    if shot.demosaic is not None:
        out["develop"] = len(frames) * develop_bytes(c["width"], c["height"])
    return out
