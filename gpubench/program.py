"""The program's own spans (``mcraw_torch.observe``) in a cell's traced
window and in its set-up's staging, and the numbers read from them.

    python3 -m gpubench.program --workload <name> --seed <n> [--seconds <s>]

runs one resident cell on the card: the inputs from the seed, the staging
twice (the program's tracer off, then on: the shot kept is the second),
the warm-up; windows of `--seconds` with the tracer off and on in turns
(off, on, on, off; no profiler); then the cell's traced window
(``trace_seconds``, torch.profiler, the harness's ``gb.`` spans) once with
the tracer off and once on. It prints one JSON line: the card and its power
limit; the numbers of :data:`READINGS` from the traced window with the
tracer on and from the staging; the share of the harness's step spans that
the program's spans cover, in all and by span; the longest idle gaps named
by the harness's span and the program's innermost one; the program's
summary and counters; and what the tracer costs, as rate and enqueue a
step with it off and on (the windows with it on give its readings without
the profiler too).
The traces and the program's rows go to ``gpubench_runs/``. No check is
made: ``python3 -m gpubench.run`` decides ``correct``.

A step is one batch through the program, so a traced window's steps are
its count of ``unpack.*`` spans (one a step in every resident cell).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import subprocess
import sys
import time

from .trace import DEVICE_CATS, PREFIX, WINDOW, _innermost, _union

PROGRAM = "mcraw."  # the program's span <name> is the trace's event mcraw.<name>
STEP = "unpack."  # the program's span that each step opens once
LAUNCH = "launch."  # a C-entry launch: launch.<entry>
WRAPPERS = ("offsets", "unpack.modern", "unpack.legacy", "develop", "develop.params",
            "checksum")
STAGE_HOST = ("stage.scan", "stage.layout")
STAGE_H2D = ("stage.h2d",)
HARNESS_STEPS = ("offsets", "decode", "develop", "checksum")  # the harness's spans of a step


def steps(spans: dict) -> int:
    """Steps of a record's summary (``Trace.summary()["spans"]``)."""
    return sum(v["count"] for k, v in spans.items() if k.startswith(STEP))


def _per_step_ms(spans: dict, seconds: float) -> float | None:
    n = steps(spans)
    return 1e3 * seconds / n if n else None


def launch_ms(spans: dict) -> float | None:
    """The host's time in the C-entry launches (``launch.*``: the library
    lookup, the ctypes call, the CUDA launch), per step, in ms."""
    return _per_step_ms(spans, sum(v["seconds"] for k, v in spans.items()
                                   if k.startswith(LAUNCH)))


def wrap_ms(spans: dict) -> float | None:
    """The kernel wrappers' own host time, less their launches (checks,
    table lookups, allocations, the device guard, the develop's
    parameters), per step, in ms."""
    return _per_step_ms(spans, sum(spans[k]["self_seconds"] for k in WRAPPERS if k in spans))


def gc_ms(spans: dict) -> float | None:
    """Python's garbage collections, per step, in ms (0 where none ran)."""
    return _per_step_ms(spans, spans.get("gc", {}).get("seconds", 0.0))


def stage_seconds(spans: dict, names) -> float | None:
    """The staging spans `names` over a record, in s; None where it has
    none."""
    picked = [spans[k]["seconds"] for k in names if k in spans]
    return sum(picked) if picked else None


# metric -> (the record it reads: "window" or "staging", its reading)
READINGS = {
    "launch_ms": ("window", launch_ms),
    "wrap_ms": ("window", wrap_ms),
    "gc_ms": ("window", gc_ms),
    "stage_scan_s": ("staging", lambda spans: stage_seconds(spans, STAGE_HOST)),
    "stage_h2d_s": ("staging", lambda spans: stage_seconds(spans, STAGE_H2D)),
}


def readings(window: dict, staging: dict) -> dict:
    """Each of :data:`READINGS` from the summaries' spans of the traced
    window's record and of set-up's staging's."""
    spans = {"window": window, "staging": staging}
    return {name: read(spans[which]) for name, (which, read) in READINGS.items()}


def coverage(harness_rows, program_rows, names=HARNESS_STEPS) -> float | None:
    """The share of the host time inside the harness's spans `names` that
    the program's spans cover; both in host ns."""
    merged = _union([(r[1], r[2]) for r in program_rows])
    starts = [lo for lo, _ in merged]
    inside = [(a, b) for n, a, b in harness_rows if n in names]
    covered = 0.0
    for a, b in inside:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(merged) and merged[i][0] < b:
            covered += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
            i += 1
    total = sum(b - a for a, b in inside)
    return covered / total if total else None


def idle_gaps(events: list[dict], harness_rows, program_rows, t0_ns: int, top: int = 10):
    """The traced window's idle gaps as ``trace.summarize`` finds them,
    each named by the harness span open when it began and, where one was,
    the program's innermost span: ``<harness span>/<program span>``
    ("host" for the harness part where none of its spans was open). The
    program's spans are its ``mcraw.`` events of the trace, on the trace's
    clock; its rows, shifted by the window's host time, only for the
    collections (``gc``, no event) or where the trace has no such event."""
    (window,) = [e for e in events if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
    lo = float(window["ts"])
    hi = lo + float(window["dur"])
    shift = lo - t0_ns / 1e3
    harness = [(e["name"][len(PREFIX):], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in events if e.get("cat") == "user_annotation"
               and e.get("name", "").startswith(PREFIX) and e["name"] != WINDOW]
    harness += [(n, a / 1e3 + shift, b / 1e3 + shift) for n, a, b in harness_rows]
    harness_at = _innermost(harness)
    traced = [(e["name"][len(PROGRAM):], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("cat") in ("cpu_op", "user_annotation")
              and e.get("name", "").startswith(PROGRAM) and "dur" in e]
    program_at = _innermost(traced + [(r[0], r[1] / 1e3 + shift, r[2] / 1e3 + shift)
                                      for r in program_rows if r[0] == "gc" or not traced])
    device = [(max(lo, float(e["ts"])), min(hi, float(e["ts"]) + float(e["dur"])))
              for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
              and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    gaps, prev = [], lo
    for a, b in _union(device) + [[hi, hi]]:
        if a > prev:
            name, inner = harness_at(prev) or "host", program_at(prev)
            gaps.append((f"{name}/{inner}" if inner else name, (a - prev) / 1e6))
        prev = max(prev, b)
    return sorted(gaps, key=lambda g: -g[1])[:top]


def card(device) -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def measure(cell, seed: int, seconds: float, device, workers: int | None = None) -> dict:
    """One cell's set-up, windows and traced windows as the module's
    docstring says; the result line's fields."""
    import torch
    from mcraw_torch import observe

    from . import reduce, resident, run
    from .trace import Spans, profiled, read, summarize

    traffic = cell.traffic
    encoding = run.Encoding(cell, seed, run.WORKERS if workers is None else workers)
    try:
        run.load_kernels(device)
        inputs = run.make_inputs(cell, seed, encoding)
    finally:
        encoding.close(stop=True)

    staged_s = {}
    for side in ("off", "on"):
        shot = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        with observe.tracing() if side == "on" else contextlib.nullcontext() as staging:
            shot = resident.Shot(inputs, cell.config, traffic, device)
            resident._sync(device)
        staged_s[side] = time.perf_counter() - t
    spans = Spans()
    loop = resident.Loop(shot, spans)
    resident.warm(loop, 0)

    frames = traffic["batch_frames"]
    windows: dict = {"off": [], "on": []}
    for side in ("off", "on", "on", "off"):
        with observe.tracing() if side == "on" else contextlib.nullcontext() as rec:
            res = loop.run(seconds)
        windows[side].append({"rate": frames * res["steps"] / res["seconds"],
                              "enqueue_ms": 1e3 * res["enqueue_s"] / res["steps"]})
        if rec is not None:  # the same readings without the profiler
            windows[side][-1].update(readings(rec.summary()["spans"], {}))

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    traced: dict = {}
    for side in ("off", "on"):
        path = run.RUNS / f"{cell.name}.{seed}.program-{side}.trace.json"
        loop.next = 0
        with profiled(path, device.type, warm=lambda: loop.run(None, steps=2)) as t0_ns:
            spans.start()
            with observe.tracing() if side == "on" else contextlib.nullcontext() as window:
                res = loop.run(traffic["trace_seconds"])
        spans.on = False
        events = read(path)
        summary = summarize(events, spans.rows, t0_ns)
        record = reduce.Record(kind, {"enqueue": (res["enqueue_s"], res["steps"])}, summary,
                               resident._bytes(shot, inputs, res["played"]))
        traced[side] = {"enqueue_ms": reduce.span_ms(record, "enqueue"),
                        "rate": frames * res["steps"] / res["seconds"],
                        "idle_pct": reduce.idle_pct(record),
                        "decode_roofline": reduce.roofline_pct(record, "decode"),
                        "develop_roofline": reduce.roofline_pct(record, "develop"),
                        "idle_gaps": summary.idle_gaps}
    harness_rows = spans.rows
    rows = run.RUNS / f"{cell.name}.{seed}.program.json"
    rows.write_text(json.dumps({"staging": [list(r) for r in staging.rows],
                                "window": [list(r) for r in window.rows],
                                "harness": harness_rows}))
    mode = traffic["rate_metric"].split("_")[0]
    program = {"window": window.summary(), "staging": staging.summary()}
    got = readings(program["window"]["spans"], program["staging"]["spans"])
    return {
        "workload": cell.name, "seed": seed, "card": card(device),
        "steps": steps(program["window"]["spans"]),
        "metrics": {(f"{k}.{mode}" if which == "window" else k): got[k]
                    for k, (which, _) in READINGS.items()},
        "coverage": coverage(harness_rows, window.rows),
        "coverage_by_span": {n: coverage(harness_rows, window.rows, (n,)) for n in HARNESS_STEPS},
        "idle_gaps": idle_gaps(events, harness_rows, window.rows, t0_ns),
        "program": program,
        "cost": {"staging_s": staged_s, "windows": windows, "traced": traced},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.program")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    from . import spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        print("gpubench.program: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(json.dumps(measure(cell, args.seed % (1 << 64), args.seconds, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
