"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``gpubench/``
and the program, ``mcraw_torch/``. The cell's entry in ``BENCHMARK.json``
names its configuration (``configs/<config>.json``) and its traffic
(``traffic/<traffic>.json``), whose ``mode`` names the module of this
package that drives it: ``resident`` (:mod:`gpubench.resident`), a shot
held on the card.

A run: the inputs made from the seed (the distinct frames encoded by
worker processes while the parent loads torch), the program's kernels loaded (built at a checkout's first
run, into ``mcraw_torch/build/``), the inputs staged, every shape the
window uses warmed up; then the window of ``--seconds``; with ``--trace 1``
a second, traced window (torch.profiler, its trace and the harness's spans
written under ``gpubench_runs/`` in the checkout); then the check against
the plain reference. Set-up's parts go to standard error on one line;
the numbers compared, each beside its limit, are the last lines there.
The last line on standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer ones with ``--trace 1``), ``device``,
``breakdown`` (``--trace 1``) and ``checks``.

Exit codes: 0 with a result; 2 without a card or with too few; 3 when the
program cannot be imported; 4 when JAX or the JAX package was loaded; 5
when the run raised.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RUNS = ROOT / "gpubench_runs"
# Kernel caches at fixed places inside the checkout, set before torch loads.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(RUNS / "cache" / sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "mcraw")
# Set-up processes that encode the frames: two cores are left to the parent,
# which loads torch and reaches the card meanwhile.
WORKERS = max(1, min(8, (os.cpu_count() or 1) - 2))


@dataclass
class Inputs:
    payloads: list  # (n,) uint8 payload of each distinct frame
    order: list  # the distinct frame of each shot or clip frame
    grade: dict  # frames.grade


class Setup:
    """Set-up's parts by the host clock, and its end: the window's start."""

    def __init__(self, t0: float):
        self.t0, self.parts, self.end = t0, {}, None

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t

    def done(self) -> None:
        self.end = time.perf_counter()

    @property
    def seconds(self) -> float:
        return self.end - self.t0


class Encoding:
    """The distinct frames of a run, encoded from the seed by worker
    processes (``python3 -m gpubench.frames``, the frames dealt round-robin)
    started before the parent loads torch and reaches the card, so that the
    two overlap. A thread a worker drains its output as it comes."""

    def __init__(self, cell, seed: int, workers: int):
        c = cell.config
        self.distinct = cell.traffic["distinct_frames"]
        workers = max(1, min(workers, self.distinct, os.cpu_count() or 1))
        head = [str(c["height"]), str(c["width"]), str(seed), c["content"], str(c["bit_depth"]),
                c["codec"]]
        self.ks = [list(range(w, self.distinct, workers)) for w in range(workers)]
        self.procs = [subprocess.Popen([sys.executable, "-m", "gpubench.frames", *head,
                                        *map(str, ks)], cwd=ROOT, stdout=subprocess.PIPE)
                      for ks in self.ks]
        self.outs: list[list[bytes]] = [[] for _ in self.procs]
        self.threads = [threading.Thread(target=self._drain, args=(p.stdout, out), daemon=True)
                        for p, out in zip(self.procs, self.outs)]
        for t in self.threads:
            t.start()

    @staticmethod
    def _drain(pipe, out: list) -> None:
        while head := pipe.read(8):
            out.append(pipe.read(int.from_bytes(head, "little")))

    def payloads(self) -> list:
        """(n,) uint8 payload of each distinct frame, once every worker has
        ended."""
        import numpy as np

        self.close()
        by_k = {k: p for ks, out in zip(self.ks, self.outs) for k, p in zip(ks, out)}
        bad = [p.returncode for p in self.procs if p.returncode != 0]
        if bad or len(by_k) != self.distinct:
            raise RuntimeError(f"frame encoding failed: exit codes {bad}, "
                               f"{len(by_k)} of {self.distinct} frames")
        return [np.frombuffer(by_k[k], np.uint8) for k in range(self.distinct)]

    def close(self, stop: bool = False) -> None:
        """Wait for every worker and its reader; with `stop`, end the
        workers first."""
        for p in self.procs:
            if stop and p.poll() is None:
                p.kill()
            p.wait()
        for t in self.threads:
            t.join()
        for p in self.procs:
            p.stdout.close()


def make_inputs(cell, seed: int, encoding: Encoding) -> Inputs:
    """The distinct frames' payloads, the order of the shot and the grade,
    all drawn from the seed."""
    from . import frames

    t = cell.traffic
    order = frames.order(seed, t["distinct_frames"], t["frames"], salt=5)
    return Inputs(encoding.payloads(), order, frames.grade(cell.config))


def load_kernels(device) -> None:
    """The program's host scans and, on a card, its CUDA kernels: built at
    a checkout's first run, loaded after."""
    from mcraw_torch.kernels import build, native

    native.get_lib()
    if device.type == "cuda":
        build.lib()


def run_cell(cell, seed: int, seconds: float, trace: bool, device, workers: int = WORKERS,
             t_start: float | None = None, encoding: Encoding | None = None) -> dict:
    """One run of `cell` on `device`: the result's fields, and under
    ``"control"`` a call that checks the control in the program's place.
    `encoding`: the run's inputs already being encoded (else they are
    encoded here, in `workers` processes)."""
    import importlib

    import torch

    from . import spec
    from .reduce import Record

    seed = seed % (1 << 64)
    setup = Setup(T_START if t_start is None else t_start)
    setup.parts["start"] = time.perf_counter() - setup.t0  # interpreter, torch, the card
    if encoding is None:
        encoding = Encoding(cell, seed, workers)
    with setup("kernels"):
        load_kernels(device)
    with setup("inputs"):
        inputs = make_inputs(cell, seed, encoding)
    trace_path = RUNS / f"{cell.name}.{seed}.trace.json" if trace else None
    mode = importlib.import_module(f"gpubench.{cell.traffic['mode']}")
    out = mode.run(cell, inputs, device, seconds, trace_path, seed, setup)

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    record = Record(kind, out["spans"], out.get("trace"), out.get("traced_bytes", {}))
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {cell.traffic["rate_metric"]: out["rate"], "setup_s": setup.seconds}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": out["checks"].correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                         "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}}
    summary = out.get("trace")
    if trace and summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": list(summary.device_ops.items())[:10],
                               "idle_gaps": [list(g) for g in summary.idle_gaps]}
        spans_path = trace_path.with_name(trace_path.name.replace(".trace.", ".spans."))
        spans_path.write_text(json.dumps({
            "window_spans": out["spans"], "traced_spans": out.get("spans_rows", []),
            "step_s": summary.step_s, "attributed": summary.attributed,
            "traced_bytes": out.get("traced_bytes", {})}))
    result["checks"] = out["checks"].line()
    window = {"rate": out["rate"], "attempted": out["attempted"],
              "spans_ms": {k: 1e3 * t / n for k, (t, n) in out["spans"].items() if n}}
    return {"result": result, "setup": {k: round(v, 4) for k, v in setup.parts.items()},
            "setup_s": setup.seconds, "window": window, "control": out["control"]}


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from . import spec

    cell = spec.load(args.workload)
    seed = args.seed % (1 << 64)
    encoding = Encoding(cell, seed, WORKERS)
    try:
        return _main(args, cell, seed, encoding)
    finally:
        encoding.close(stop=True)


def _main(args, cell, seed: int, encoding: Encoding) -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import mcraw_torch  # noqa: F401
    except ImportError as e:
        print(f"gpubench: the program cannot be imported: {e}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        run = run_cell(cell, seed, args.seconds, bool(args.trace), device, encoding=encoding)
    except Exception:
        traceback.print_exc()
        return 5
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: the run loaded {bad}", file=sys.stderr)
        return 4
    result = run["result"]
    print(json.dumps({"setup": run["setup"], "setup_s": run["setup_s"]}), file=sys.stderr)
    print(json.dumps({"window": run["window"]}), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
