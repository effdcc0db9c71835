"""The port's bench: the legs of the repository's ``bench.py`` on one CUDA
card, through the port's own entry points, each gated by its checksum.

    python -m mcraw_torch.bench [--legs LEG,...] [--seed 11]
        [--device cuda|cpu] [--quick] [--size HxW]

It prints one JSON line with ``bench.py``'s keys (``bench.py:956-989``):

- ``value``: frames/s of 4096x3072 12-bit "mix" frames, each frame the
  device prep, the modern unpack kernel and the checksum
  (``kernels.unpack.unpack_modern``, ``kernels.checksum.device_checksum``);
  ``unpack_gbps`` = (mean payload + 2·H·W) × ``value``;
- ``worst_case_fps``, ``all16_fps``: the same on "worst" (full-range noise
  with one 5-bit tile) and "all16" (full-range noise) frames;
- ``legacy_fps_4k``: the legacy unpack kernel and the checksum a frame
  (``kernels.legacy.unpack_legacy``), on the first four "mix" images
  encoded with ``encode_legacy``;
- ``decode_develop_fps``, ``decode_develop_malvar_fps``,
  ``decode_develop_legacy_fps``: a pair of frames a step, one batched
  decode of the two (``decode_modern_batch_device`` /
  ``decode_legacy_batch_device``), one develop launch of the (2, H, W)
  result (``kernels.develop.develop_rgba_device``, ``bench.py``'s
  parameters), the checksum of the RGBA;
- ``fps_1080p``, ``legacy_fps_1080p``: ``value`` and ``legacy_fps_4k`` at
  1920x1080;
- ``latency_ms_single_frame`` (median; ``_p90``, ``latency_samples``): one
  staged 4K frame, host clock from the launch to
  ``device_checksum(...).item()``;
- ``vs_baseline`` = ``value`` / 720, the north-star floor (``baseline``
  says so);

and the port's own: ``metric`` and ``device`` name the card (its name and
power limit from ``nvidia-smi``), ``legs`` holds each leg's bursts,
quartiles and launches, ``launches`` / ``plain_calls`` each kernel's count
over the run, ``gate_failures`` and ``errors`` what went wrong.

The frames are ``bench.make_frames``'s (:func:`make_frames`: the same
draws, seed 11), encoded with :mod:`mcraw_torch.encode` and made anew each
run (large frames in a pool of processes, one a core). Every leg stages its distinct frames
once, each in its own :class:`~mcraw_torch.kernels.staging.Staging`,
before it times anything: as in ``bench.py``, no leg times the host prep
or the H2D.

Timing: a throughput leg runs a warm-up burst, then at least 5 bursts,
each cycling over its staged frames in a fixed order, timed by CUDA events
on the current stream (the host clock on the CPU). Its value is the median
burst's frames/s, with the best and the quartiles beside it, and the
host's time to enqueue a frame. The L2 is not flushed: a burst's distinct
4K frames are far beyond the 50 MB L2. On the card one more burst runs
under torch.profiler (the card's activity only): its ``trace`` gives the
device time a frame by kernel and the device's busy share.

Gates: before timing, each distinct frame's ``device_checksum`` must equal
the host's ``img.astype(np.int64).sum() & 0xFFFFFFFF``. In a burst every
step's checksum is added into one device tensor, read once at the end and
held to the expected sum mod 2^32. A develop leg also holds its decode per
frame and one full RGBA frame within 1 LSB per channel, alpha 255, of
``preview.develop_f64``; its bursts are held to the sum of its gated
steps' checksums. A gate that fails leaves the leg's key null and is listed
under ``gate_failures``; a leg that raises is listed under ``errors``.
Either makes the exit code 1, after every leg has run and the line has
been printed. Nothing falls back: no plain version on the card, no CPU in
place of the card. Without a card the default ``--device cuda`` exits 2
and prints nothing on stdout.

``--quick``: 2 distinct frames a leg, bursts of 8 frames (4 pairs), the
same gates. ``--size HxW`` sets the geometry of every leg (the CPU tests
run at small sizes).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import statistics
import sys
import tempfile
import time
import traceback
from concurrent.futures import Executor, ProcessPoolExecutor
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import encode as E
from . import preview as P
from .errors import MotionCamException
from .kernels import checksum as C
from .kernels import develop as D
from .kernels import legacy as L
from .kernels import offsets as O
from .kernels import unpack as U
from .kernels.staging import Staging
from .kernels.tables import modern_tables
from .observe import busy_us, device_events
from .pipeline import resolve_device
from .soak import card_name

SIZE_4K = (3072, 4096)  # (height, width)
SIZE_1080P = (1080, 1920)
SEED = 11
FRAMES = 8  # distinct frames of a modern leg (bench.py:41)
LEGACY_FRAMES = 4  # the first "mix" images, encoded legacy (bench.py:402)
QUICK_FRAMES = 2
MASK = 0xFFFFFFFF
BASELINE_FPS = 720.0
BASELINE = ("value / 720: the north-star floor, 30x realtime at 24 fps (bench.py:955); "
            "the compiled C++ reference decoder it would be measured against is not in "
            "the repository")
# bench.py:463-469: black 0, white 4095, unit neutral, diag(D50 white) as
# the forward matrix; an RGGB mosaic.
CFA = (0, 1, 1, 2)
DEVELOP_MODEL = (np.zeros(4), 4095.0, np.ones(3), np.diag([0.9642, 1.0, 0.8249]))
# Frames of more pixels than this in one set are encoded in a process pool.
POOL_PIXELS = 1 << 22
COUNTED = {"unpack_modern": U, "unpack_legacy": L, "checksum": C, "develop": D,
           "block_offsets": O}


class Timing(NamedTuple):
    bursts: int  # timed bursts, after one warm-up burst
    burst_frames: int  # frames a burst of an unpack leg
    burst_pairs: int  # pairs a burst of a develop leg
    latency_samples: int  # after LATENCY_WARMUP


FULL = Timing(bursts=10, burst_frames=256, burst_pairs=32, latency_samples=200)
QUICK = Timing(bursts=5, burst_frames=8, burst_pairs=4, latency_samples=200)
LATENCY_WARMUP = 10

# The keys of bench.py's line (bench.py:956-989), in its order.
KEYS = ("metric", "value", "unit", "vs_baseline", "unpack_gbps", "worst_case_fps",
        "all16_fps", "legacy_fps_4k", "decode_develop_fps", "decode_develop_malvar_fps",
        "decode_develop_legacy_fps", "fps_1080p", "legacy_fps_1080p",
        "latency_ms_single_frame")


# -- the frames -----------------------------------------------------------------


def draw_images(h: int, w: int, content: str, frames: int, seed: int = SEED
                ) -> list[np.ndarray]:
    """bench.py:79-109, draw for draw: "mix" (a smooth 12-bit field plus
    noise, its period a frame's own), "all16" (full-range noise) or "worst"
    (full-range noise with one 5-bit 4x64 tile)."""
    rng = np.random.default_rng(seed)
    imgs = []
    for k in range(frames):
        if content in ("all16", "worst"):
            img = rng.integers(0, 1 << 16, size=(h, w), dtype=np.uint16)
            if content == "worst":
                img[0:4, 0:64] = rng.integers(0, 32, size=(4, 64), dtype=np.uint16)
        elif content == "mix":
            base = (
                np.sin(np.arange(w) / (97 + k))[None, :]
                * np.cos(np.arange(h) / (61 + k))[:, None]
                * 1200
                + 2000
            )
            img = (base + rng.normal(0, 30, size=(h, w))).clip(0, 4095).astype(np.uint16)
        else:
            raise ValueError(f"unknown content {content!r} (mix, worst or all16)")
        imgs.append(img)
    return imgs


def encode_pool() -> ProcessPoolExecutor:
    """A pool of spawned processes for :func:`encode_all`, one a core; a
    process starts at its first task."""
    return ProcessPoolExecutor(os.cpu_count() or 1,
                               mp_context=multiprocessing.get_context("spawn"))


def encode_all(imgs: list[np.ndarray], codec: str, pool: Executor | None = None
               ) -> list[np.ndarray]:
    """Each image encoded (codec "modern" or "legacy") as a uint8 payload;
    in `pool`, one image a task, where the set holds more than POOL_PIXELS
    pixels."""
    encode = E.encode_modern if codec == "modern" else E.encode_legacy
    if pool is None or sum(img.size for img in imgs) <= POOL_PIXELS:
        return [np.frombuffer(encode(img), np.uint8) for img in imgs]
    return [np.frombuffer(p, np.uint8) for p in pool.map(encode, imgs)]


def make_frames(h: int, w: int, content: str = "mix", frames: int = FRAMES,
                seed: int = SEED, codec: str = "modern", pool: Executor | None = None
                ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """``bench.make_frames(h, w, content)`` with ``frames`` frames: the
    same images and, for the modern codec, the same payload bytes. The
    legacy legs' frames are ``codec="legacy"`` of "mix": the first images
    of the modern set, encoded with ``encode_legacy`` (bench.py:409-413)."""
    imgs = draw_images(h, w, content, frames, seed)
    return imgs, encode_all(imgs, codec, pool)


def host_sum(img: np.ndarray) -> int:
    return int(img.astype(np.int64).sum() & MASK)


# -- gates and counts --------------------------------------------------------------


class GateFailure(Exception):
    """A gate did not hold: the leg's key stays null."""

    def __init__(self, what: str, want, got):
        super().__init__(f"{what}: want {want}, got {got}")
        self.what, self.want, self.got = what, want, got


def counts() -> tuple[dict, dict]:
    """Each kernel's launches and its plain version's calls so far."""
    return ({k: m.KERNEL_LAUNCHES for k, m in COUNTED.items()},
            {k: m.PLAIN_CALLS for k, m in COUNTED.items()})


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def quartiles(xs: list[float]) -> tuple[float, float, float]:
    if len(xs) < 2:
        return xs[0], xs[0], xs[0]
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return q1, q2, q3


def kernel_name(name: str) -> str:
    """A trace's kernel name without its signature, template arguments and
    namespaces: ``unpack_modern_kernel``, ``reduce_kernel``, ..."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].rsplit("::", 1)[-1]


def device_split(events: list[dict], frames: int, wall_ms: float) -> dict:
    """From a Chrome trace's events: each kernel's (by
    :func:`kernel_name`), memcpy's and memset's device ms a frame, the
    union of their intervals a frame and over `wall_ms` (the busy share),
    and the device operations a frame."""
    device = device_events(events)
    split: dict[str, float] = {}
    for e in device:
        key = kernel_name(e["name"]) if e["cat"] == "kernel" else e["cat"]
        split[key] = split.get(key, 0.0) + e["dur"] / 1e3 / frames
    busy_ms = busy_us(device) / 1e3
    return {"device_ms_per_frame": dict(sorted(split.items(), key=lambda kv: -kv[1])),
            "busy_ms_per_frame": busy_ms / frames, "busy_share": busy_ms / wall_ms,
            "device_ops_per_frame": len(device) / frames}


# -- the legs ---------------------------------------------------------------------


class Bench:
    """One run: the device, the sizes, the frames made so far, and what
    went wrong."""

    def __init__(self, device: torch.device, seed: int, quick: bool,
                 size: tuple[int, int] | None):
        self.device = device
        self.seed = seed
        self.quick = quick
        self.timing = QUICK if quick else FULL
        self.size = size or SIZE_4K
        self.size_1080p = size or SIZE_1080P
        self._frames: dict[tuple, tuple] = {}
        self.pool: Executor | None = None
        self.frames_s = 0.0
        self.gate_failures: list[dict] = []
        self.errors: list[dict] = []

    def distinct(self, codec: str) -> int:
        if self.quick:
            return QUICK_FRAMES
        return FRAMES if codec == "modern" else LEGACY_FRAMES

    def frames(self, size, content: str, codec: str):
        """(imgs, payloads) of a leg, made once a run."""
        key = (size, content, codec)
        if key not in self._frames:
            t0 = time.perf_counter()
            self._frames[key] = make_frames(*size, content, self.distinct(codec), self.seed,
                                            codec, self.pool)
            self.frames_s += time.perf_counter() - t0
        return self._frames[key]

    # -- timing

    def burst(self, steps: list[Callable[[], torch.Tensor]], count: int
              ) -> tuple[float, float, int]:
        """`count` steps, cycling over `steps` in order, each step's
        checksum added into one device tensor: (ms, host ms to enqueue,
        the sum mod 2^32, read once at the end)."""
        acc = torch.zeros((), dtype=torch.int64, device=self.device)
        n = len(steps)
        events = self.device.type == "cuda"
        if events:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for i in range(count):
            acc.add_(steps[i % n]())
        ms = enqueue_ms = (time.perf_counter() - t0) * 1e3
        if events:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        return ms, enqueue_ms, int(acc.item()) & MASK

    def throughput(self, steps, wants: list[int], frames_per_step: int, count: int) -> dict:
        """A warm-up burst, then the timed bursts, each held to the sum of
        `wants` (one a step) over its steps."""
        want = sum(wants[i % len(wants)] for i in range(count)) & MASK
        fps, ms_frame, enqueue_frame = [], [], []
        frames = count * frames_per_step
        for b in range(self.timing.bursts + 1):
            ms, enqueue_ms, got = self.burst(steps, count)
            if got != want:
                raise GateFailure(f"burst {b} checksum sum", want, got)
            if b:  # burst 0 warms up
                fps.append(frames / ms * 1e3)
                ms_frame.append(ms / frames)
                enqueue_frame.append(enqueue_ms / frames)
        q1, med, q3 = quartiles(fps)
        return {"fps": med, "best_fps": max(fps), "q1_fps": q1, "q3_fps": q3,
                "bursts": len(fps), "burst_frames": frames, "distinct_frames": len(wants)
                * frames_per_step, "ms_per_frame": statistics.median(ms_frame),
                "enqueue_ms_per_frame": statistics.median(enqueue_frame),
                "clock": "cuda events" if self.device.type == "cuda" else "host",
                "trace": self.traced_burst(steps, count, frames, want)}

    def traced_burst(self, steps, count: int, frames: int, want: int) -> dict | None:
        """One more burst, after the timed ones, under torch.profiler (the
        card's activity only): the device time a frame by kernel, the
        device's busy share of the burst's wall, and the burst's own time
        (what the tracing costs). None on the CPU."""
        if self.device.type != "cuda":
            return None
        from torch.profiler import ProfilerActivity, profile

        with tempfile.TemporaryDirectory() as tmp:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                ms, _, got = self.burst(steps, count)
                wall_ms = (time.perf_counter() - t0) * 1e3
            path = os.path.join(tmp, "burst.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        if got != want:
            raise GateFailure("traced burst checksum sum", want, got)
        return {"ms_per_frame": ms / frames, **device_split(events, frames, wall_ms)}

    # -- the three kinds of leg

    def unpack_leg(self, codec: str, content: str, size) -> dict:
        """A frame a step: device prep (modern), the codec's unpack kernel,
        the checksum."""
        h, w = size
        imgs, payloads = self.frames(size, content, codec)
        if codec == "modern":
            staged = [U.stage_modern(Staging(self.device), p, w, h) for p in payloads]
            unpack = U.unpack_modern
        else:
            staged = [L.stage_legacy(Staging(self.device), p, w, h) for p in payloads]
            unpack = L.unpack_legacy
        steps = [lambda f=f: C.device_checksum(unpack(f, w, h)) for f in staged]
        wants = [host_sum(img) for img in imgs]
        for i, (step, want) in enumerate(zip(steps, wants)):
            got = int(step().item())
            if got != want:
                raise GateFailure(f"frame {i} checksum", want, got)
        row = self.throughput(steps, wants, 1, self.timing.burst_frames)
        row["payload_bytes_mean"] = sum(len(p) for p in payloads) / len(payloads)
        return row

    def develop_leg(self, codec: str, demosaic: str) -> dict:
        """A pair of frames a step: one batched decode of the two, one
        develop launch of the (2, H, W) result, the checksum of the RGBA."""
        h, w = self.size
        imgs, payloads = self.frames(self.size, "mix", codec)
        params = D.pack_develop_params(*(np.asarray(a, np.float32) for a in DEVELOP_MODEL))
        pairs = [(k, k + 1) for k in range(0, len(payloads) - 1, 2)]
        if codec == "modern":
            tables = modern_tables(self.device)
            batches = [U.stage_modern_batch(Staging(self.device), [payloads[a], payloads[b]],
                                            w, h) for a, b in pairs]

            def decode(bt):
                return U.decode_modern_batch_device(
                    bt.words, bt.bases, bt.lengths, bt.bits, bt.refs,
                    U.block_offsets(bt.bits, tables),
                    ty=bt.tiles_y, tx=bt.tiles_x, height=h, width=w)
        else:
            batches = [L.stage_legacy_batch(Staging(self.device), [payloads[a], payloads[b]],
                                            w, h) for a, b in pairs]

            def decode(bt):
                return L.decode_legacy_batch_device(*bt, height=h, width=w)

        def develop(bt):
            return D.develop_rgba_device(decode(bt), params, cfa=CFA, demosaic=demosaic)

        for (a, b), bt in zip(pairs, batches):
            two = decode(bt)
            for f, k in enumerate((a, b)):
                got = int(C.device_checksum(two[f]).item())
                if got != host_sum(imgs[k]):
                    raise GateFailure(f"frame {k} decode checksum", host_sum(imgs[k]), got)
        rgba = develop(batches[0])[0].cpu().numpy().astype(np.int64)
        model = P.develop_f64(imgs[0], *DEVELOP_MODEL, CFA, demosaic=demosaic)
        got3 = np.stack([(rgba >> s) & 0xFF for s in (0, 8, 16)], axis=-1)
        err = int(np.abs(got3 - model).max())
        if err > 1:
            raise GateFailure("frame 0 RGB against develop_f64, max |err| (LSB)", 1, err)
        alpha = int(((rgba >> 24) & 0xFF).min())
        if alpha != 255:
            raise GateFailure("frame 0 alpha, min", 255, alpha)
        steps = [lambda bt=bt: C.device_checksum(develop(bt)) for bt in batches]
        wants = [int(step().item()) for step in steps]  # each step's decode gated above
        row = self.throughput(steps, wants, 2, self.timing.burst_pairs)
        row["develop_max_abs_err"] = err
        return row

    def latency_leg(self) -> dict:
        """One staged frame decoded and summed, the host waiting for the
        sum each time: the host clock per sample."""
        h, w = self.size
        imgs, payloads = self.frames(self.size, "mix", "modern")
        frame = U.stage_modern(Staging(self.device), payloads[0], w, h)
        want = host_sum(imgs[0])
        samples = []
        for i in range(LATENCY_WARMUP + self.timing.latency_samples):
            t0 = time.perf_counter()
            got = int(C.device_checksum(U.unpack_modern(frame, w, h)).item())
            ms = (time.perf_counter() - t0) * 1e3
            if got != want:
                raise GateFailure(f"sample {i} checksum", want, got)
            if i >= LATENCY_WARMUP:
                samples.append(ms)
        return {"ms": statistics.median(samples),
                "p90_ms": statistics.quantiles(samples, n=10, method="inclusive")[-1],
                "best_ms": min(samples), "samples": len(samples), "clock": "host"}

    # -- the run

    def run(self, legs: list[str]) -> dict:
        with encode_pool() as self.pool:
            return self._run(legs)

    def _run(self, legs: list[str]) -> dict:
        rows, launches, plain = {}, *counts()
        t0 = time.perf_counter()
        for name in legs:
            t_leg = time.perf_counter()
            before, before_plain = counts()
            try:
                row = LEGS[name](self)
            except GateFailure as g:
                self.gate_failures.append({"leg": name, "what": g.what, "want": g.want,
                                           "got": g.got})
                row = None
            except Exception as e:  # reported below; the other legs still run
                traceback.print_exc()
                self.errors.append({"leg": name, "error": f"{type(e).__name__}: {e}"})
                row = None
            after, after_plain = counts()
            if row is not None:
                row.update(seconds=time.perf_counter() - t_leg,
                           launches=delta(after, before), plain_calls=delta(after_plain,
                                                                            before_plain))
                rows[name] = row
            print(json.dumps({"leg": name, "ok": row is not None,
                              "seconds": time.perf_counter() - t_leg}), file=sys.stderr,
                  flush=True)
        after, after_plain = counts()
        return self.line(rows, delta(after, launches), delta(after_plain, plain),
                         time.perf_counter() - t0)

    def line(self, rows: dict, launches: dict, plain: dict, seconds: float) -> dict:
        def fps(name):
            return rows[name]["fps"] if name in rows else None

        h, w = self.size
        value = fps("value")
        gbps = None
        if value is not None:
            gbps = (rows["value"]["payload_bytes_mean"] + 2 * h * w) * value / 1e9
        lat = rows.get("latency_ms_single_frame")
        if self.device.type == "cuda":
            card = torch.cuda.get_device_name(self.device)
            where, device = f"1 {card}", card_name(self.device)
        else:
            where = device = "cpu, plain torch"
        geometry = "4K" if self.size == SIZE_4K else f"{w}x{h}"
        return {
            "metric": f"{geometry} 12-bit MCRAW decode throughput ({where})",
            "value": value,
            "unit": "frames/sec",
            "vs_baseline": None if value is None else value / BASELINE_FPS,
            "unpack_gbps": gbps,
            **{key: fps(key) for key in KEYS[5:13]},
            "latency_ms_single_frame": lat["ms"] if lat else None,
            "latency_ms_single_frame_p90": lat["p90_ms"] if lat else None,
            "latency_samples": lat["samples"] if lat else None,
            "device": device,
            "baseline": BASELINE,
            "gate_failures": self.gate_failures,
            "errors": self.errors,
            "seed": self.seed,
            "quick": self.quick,
            "size": [h, w],
            "size_1080p": list(self.size_1080p),
            "legs": rows,
            "launches": launches,
            "plain_calls": plain,
            "frames_s": self.frames_s,
            "seconds": seconds,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        }


# Each leg, in bench.py's order (bench.py:865-952; the latency comes from
# the headline's run there).
LEGS: dict[str, Callable[[Bench], dict]] = {
    "value": lambda b: b.unpack_leg("modern", "mix", b.size),
    "latency_ms_single_frame": Bench.latency_leg,
    "worst_case_fps": lambda b: b.unpack_leg("modern", "worst", b.size),
    "all16_fps": lambda b: b.unpack_leg("modern", "all16", b.size),
    "legacy_fps_4k": lambda b: b.unpack_leg("legacy", "mix", b.size),
    "decode_develop_fps": lambda b: b.develop_leg("modern", "bilinear"),
    "decode_develop_legacy_fps": lambda b: b.develop_leg("legacy", "bilinear"),
    "decode_develop_malvar_fps": lambda b: b.develop_leg("modern", "malvar"),
    "fps_1080p": lambda b: b.unpack_leg("modern", "mix", b.size_1080p),
    "legacy_fps_1080p": lambda b: b.unpack_leg("legacy", "mix", b.size_1080p),
}


# -- the command line -----------------------------------------------------------------


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m mcraw_torch.bench")
    ap.add_argument("--legs", default=",".join(LEGS),
                    help="comma-separated, run in bench.py's order: " + ", ".join(LEGS))
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--quick", action="store_true",
                    help="2 distinct frames a leg, short bursts, the same gates")
    ap.add_argument("--size", default=None, metavar="HxW",
                    help="the geometry of every leg (default 3072x4096 and 1080x1920)")
    args = ap.parse_args(argv)
    legs = args.legs.split(",")
    unknown = sorted(set(legs) - set(LEGS))
    if unknown:
        ap.error(f"unknown legs {unknown}")
    args.legs = [name for name in LEGS if name in legs]
    if args.size is not None:
        try:
            h, w = (int(v) for v in args.size.lower().split("x"))
        except ValueError:
            ap.error(f"--size takes HxW, got {args.size!r}")
        if h < 1 or w < 1:
            ap.error(f"--size {args.size}: both sides must be positive")
        args.size = (h, w)
    return args


def main(argv=None) -> int:
    args = parse(argv)
    try:
        device = resolve_device(args.device)
    except (MotionCamException, ValueError) as e:
        print(f"mcraw_torch.bench: {e}", file=sys.stderr)
        return 2
    bench = Bench(device, args.seed, args.quick, args.size)
    on_card = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
    with on_card:
        result = bench.run(args.legs)
    print(json.dumps(result), flush=True)
    return 1 if result["gate_failures"] or result["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
