"""An eight-angle multicam shot played in sync (traffic mode ``multiview``):
each angle a clip with its own container metadata, each frame with its own
as-shot neutral, developed as shot.

The configuration's ``angles`` give each clip's black and white levels,
``sensorArrangment``, colorMatrix1/2 and forwardMatrix1/2, and the ends of
its as-shot neutral's drift over the clip: at tick t of T, neutral =
neutral_from + t / (T - 1) (neutral_to - neutral_from), red and blue times
1 + e, e drawn from the seed within the traffic's ``flicker``. The shot is
tick-major: angle a at tick t plays shot frame n t + a of the order drawn
from the seed (:func:`gpubench.frames.order`), n the angles.

Set-up stages the shot a tick at a time with the program's batch staging,
as :mod:`gpubench.resident` stages a batch, then makes the develop rows and
CFAs of every frame of the shot on the card, as a player opening the shot
makes them: one ``preview.frame_develop_rows`` of every frame's clip and
frame metadata (set-up's part ``rows``). A step is one tick through the
program, each part under a harness span:

1. ``params``: the tick's n rows and CFAs of the shot's
   (``FrameRows.frames``);
2. ``offsets`` and ``decode``: as in the resident cells;
3. ``develop``: ``preview.develop_frames_rgba``, each frame with its row;
4. ``checksum`` of the RGBA into the window's accumulator.

The loop is :class:`gpubench.resident.Loop`. The check holds each sampled
frame's RGBA to the float64 model (:mod:`gpubench.ref.develop`) of its
reference plane with that frame's own metadata, its forward matrix from
:mod:`gpubench.ref.color`. A program without the per-frame entry points
cannot run this mode: it raises at once.

The controls of ``correct``, read on the card over several seeds by

    python3 -m gpubench.multiview --workload <name> --seeds a,b,c [--seconds 3]

(one JSON line a seed, then each number's largest program reading and each
control's smallest): the develop in bfloat16 on planes one bit short (and
float16 beside it), as ``gpubench.control`` reads them; and every frame of
a tick developed with the tick's first frame's parameters and CFA.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import check, resident
from .ref import color as RC
from .ref.develop import CFA_PATTERNS
from .trace import Spans


class Tick(list):
    """The distinct frame of each angle at one tick, and the tick."""

    def __init__(self, frames, tick: int):
        super().__init__(frames)
        self.tick = tick


def _f32(values) -> list[float]:
    """The values as a container carries them: float32, which its reader
    takes (``std::vector<float>``)."""
    return [float(v) for v in np.asarray(values, np.float32).ravel()]


def neutrals(config: dict, traffic: dict, seed: int) -> np.ndarray:
    """(ticks, angles, 3) float32 as-shot neutral of every frame."""
    angles = config["angles"]
    ticks = traffic["frames"] // len(angles)
    t = (np.arange(ticks) / max(ticks - 1, 1))[:, None, None]
    lo = np.array([a["neutral_from"] for a in angles], np.float64)[None]
    hi = np.array([a["neutral_to"] for a in angles], np.float64)[None]
    e = np.random.default_rng([seed, 13]).uniform(-1.0, 1.0, (ticks, len(angles), 3))
    e[..., 1] = 0.0  # green stays 1
    return ((lo + t * (hi - lo)) * (1.0 + traffic["flicker"] * e)).astype(np.float32)


def container_json(angle: dict) -> dict:
    """An angle's container metadata, as the clip would carry it."""
    return {"blackLevel": list(angle["black"]), "whiteLevel": float(angle["white"]),
            "sensorArrangment": angle["sensor"],
            **{k: _f32(angle[k]) for k in ("colorMatrix1", "colorMatrix2", "forwardMatrix1",
                                           "forwardMatrix2")}}


def frame_grade(angle: dict, neutral: np.ndarray) -> dict:
    """The reference's develop parameters of one frame: its clip's levels,
    its neutral and the forward matrix interpolated at it."""
    cm = container_json(angle)
    fwd, _ = RC.forward_matrix(np.asarray(neutral, np.float64),
                               *(cm[k] for k in ("colorMatrix1", "colorMatrix2",
                                                 "forwardMatrix1", "forwardMatrix2")))
    return {"black": list(angle["black"]), "white": float(angle["white"]),
            "neutral": np.asarray(neutral, np.float64).tolist(),
            "forward": fwd.reshape(-1).tolist(), "cfa": CFA_PATTERNS[angle["sensor"]]}


class Shoot(resident.Shot):
    """The staged shot (a batch a tick) and its step, with each angle's
    container metadata and each frame's frame metadata as the program
    takes them."""

    def __init__(self, inputs, config: dict, traffic: dict, device, seed: int):
        from mcraw_torch import preview as P
        from mcraw_torch.metadata import ContainerMetadata, FrameMetadata

        missing = [f for f in ("frame_develop_rows", "develop_frames_rgba") if not hasattr(P, f)]
        if missing:
            raise RuntimeError(f"the program has no per-frame develop: mcraw_torch.preview "
                               f"lacks {missing}")
        angles = config["angles"]
        if traffic["batch_frames"] != len(angles) or \
                traffic["frames"] != len(angles) * config["ticks_per_clip"]:
            raise ValueError(f"a tick is one frame of each of the {len(angles)} angles: "
                             f"{config['ticks_per_clip']} ticks")
        if config["codec"] != "modern":
            raise ValueError("the multiview cells play modern-codec clips")
        super().__init__(inputs, config, traffic, device)
        self.frames = [Tick(f, t) for t, f in enumerate(self.frames)]
        self.angles = angles
        self.neutrals = neutrals(config, traffic, seed)
        self.containers = [ContainerMetadata(container_json(a)) for a in angles]
        h, w = config["height"], config["width"]
        self.metas = [[FrameMetadata({"width": w, "height": h, "compressionType": 7,
                                      "asShotNeutral": _f32(n)}) for n in tick]
                      for tick in self.neutrals]
        self.params_s = 0.0
        self.rows = None

    def make_rows(self) -> None:
        """The develop rows and CFAs of every frame of the shot, tick-major,
        on the device: the program's, from each frame's metadata."""
        from mcraw_torch import preview as P

        self.rows = P.frame_develop_rows(self.containers * len(self.metas),
                                         [m for tick in self.metas for m in tick], self.device)

    def step_fn(self, spans: Spans):
        """step(tick, accumulator) -> (planes, RGBA, its checksum)."""
        from mcraw_torch import preview as P
        from mcraw_torch.kernels import checksum as C
        from mcraw_torch.kernels import unpack as U
        from mcraw_torch.kernels.tables import modern_tables

        h, w = self.h, self.w
        n = len(self.angles)
        tables = modern_tables(self.device)

        def step(b: int, acc: torch.Tensor):
            bt = self.batches[b]
            t = time.perf_counter()
            with spans("params"):
                rows = self.rows.frames(n * b, n * b + n)
            self.params_s += time.perf_counter() - t
            with spans("offsets"):
                offsets = U.block_offsets(bt.bits, tables)
            with spans("decode"):
                planes = U.decode_modern_batch_device(
                    bt.words, bt.bases, bt.lengths, bt.bits, bt.refs, offsets,
                    ty=bt.tiles_y, tx=bt.tiles_x, height=h, width=w)
            with spans("develop"):
                out = P.develop_frames_rgba(planes, rows.rows, rows.cfas, demosaic=self.demosaic)
            with spans("checksum"):
                summed = C.device_checksum(out)
                acc.add_(summed)
            return planes, out, summed

        return step

    def sampled(self, kept: list) -> list:
        """The loop's kept steps [(frames, planes, RGBA, checksum)], each
        with its frames' grades, as :func:`frame_checks` takes them."""
        return [(frames, planes, rgba, summed,
                 [frame_grade(self.angles[a], self.neutrals[frames.tick, a])
                  for a in range(len(frames))])
                for frames, planes, rgba, summed in kept]


def run(cell, inputs, device, seconds: float, trace_path, seed: int, setup) -> dict:
    """One run of a multiview cell: the staged shot, its rows, the warm-up
    (every tick once), the window, the traced window where `trace_path` is
    set, and the check."""
    config, traffic = cell.config, cell.traffic
    with setup("stage"):
        shoot = Shoot(inputs, config, traffic, device, seed)
        resident._sync(device)
    with setup("rows"):
        shoot.make_rows()
        resident._sync(device)
    spans = Spans()
    loop = resident.Loop(shoot, spans)
    rng = np.random.default_rng([seed, 11])
    keep_at = sorted(rng.uniform(0.05, 0.95, traffic["check_steps"]).tolist())
    with setup("warm"):
        resident.warm(loop, len(keep_at))
    setup.done()

    shoot.params_s = 0.0
    res = loop.run(seconds, keep_at=keep_at)
    frames = res["steps"] * traffic["batch_frames"]
    out = {"rate": frames / res["seconds"], "attempted": frames, "failed": 0,
           "spans": {"enqueue": (res["enqueue_s"], res["steps"]),
                     "params": (shoot.params_s, res["steps"])},
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
        out["traced_bytes"] = _bytes(shoot, inputs, traced["played"])
        out["spans_rows"] = spans.rows

    # The check, once the window has closed and the program's state is freed.
    kept = shoot.sampled(res["kept"])
    demosaic = shoot.demosaic
    del shoot, loop, res
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = check.Reference(inputs.payloads, config, device)
    checks = frame_checks(kept, ref, config, demosaic)
    out["checks"] = checks
    out["control"] = lambda dtype=check.CONTROL_DEVELOP_DTYPE, first_row=False: frame_checks(
        kept, ref, config, demosaic, dtype=dtype, first_row=first_row)
    return out


def frame_checks(kept, ref: check.Reference, config: dict, demosaic: str,
                 dtype: torch.dtype | None = None, first_row: bool = False) -> check.Checks:
    """The numbers of :mod:`gpubench.check` over the sampled ticks, each
    frame against the model of its reference plane with its own grade.

    A control puts the reference in the program's place: with `dtype`, the
    develop in that precision on planes one bit short (as the resident
    cells' control); with `first_row`, every frame of a tick developed in
    float64 with the tick's first frame's grade and CFA."""
    checks = check.Checks()
    checks.add("unchecked", int(not kept), 0)
    mismatch, err, off, codes_n, alpha, sums_off = 0, 0, 0, 0, 0, 0
    control = first_row or dtype is not None
    for frames, planes, rgba, step_sum, grades in kept:
        if dtype is not None:
            planes = torch.stack([check.drop_lsb(ref.plane(k)) for k in frames])
        for f, k in enumerate(frames):
            mismatch += int((planes[f].to(torch.int32) != ref.plane(k)).sum())
            g = grades[f]
            want = ref.develop(k, g, g["cfa"], demosaic)
            if dtype is not None:
                codes = ref.develop(k, g, g["cfa"], demosaic, dtype)
            elif first_row:
                codes = ref.develop(k, grades[0], grades[0]["cfa"], demosaic)
            else:
                b = rgba[f].view(torch.uint8).reshape(*rgba[f].shape, 4).to(torch.int64)
                codes = b[..., :3]
                alpha += int((b[..., 3] != 255).sum())
            diff = (codes - want).abs()
            err = max(err, int(diff.max()))
            off += int((diff != 0).sum())
            codes_n += diff.numel()
        if not control:
            sums_off += int(int(step_sum) != check.word_sum(rgba))
    limits = config["limits"]
    checks.add("plane_mismatch", mismatch, 0)
    checks.add("rgba_max_err", err, limits["rgba_max_err"])
    checks.add("rgba_off_ppm", 1e6 * off / max(codes_n, 1), limits["rgba_off_ppm"])
    checks.add("alpha_off", alpha, 0)
    checks.add("step_checksum_off", sums_off, 0)
    return checks


def _bytes(shoot: Shoot, inputs, played: list[int]) -> dict:
    """The bytes the traced steps' decode and develop must move: the
    develop's plane in, RGBA out and each frame's row and CFA."""
    from .roofline import decode_bytes, develop_bytes

    c = shoot.config
    frames = [k for b in played for k in shoot.frames[b]]
    row_bytes = 4 * (128 + 4)
    return {"decode": sum(decode_bytes(c["codec"], len(inputs.payloads[k]), c["width"],
                                       c["height"]) for k in frames),
            "develop": len(frames) * (develop_bytes(c["width"], c["height"]) + row_bytes)}


CONTROLS = {"control": dict(dtype=torch.bfloat16), "control_float16": dict(dtype=torch.float16),
            "control_first_row": dict(dtype=None, first_row=True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.multiview")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    from . import run, spec

    if not torch.cuda.is_available():
        print("gpubench.multiview: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = spec.load(args.workload)
    readings: dict[str, dict[str, list]] = {"program": {}, **{k: {} for k in CONTROLS}}
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(cell, seed, args.seconds, False, device)
        line = {"program": {k: v["value"] for k, v in out["result"]["checks"].items()}}
        for name, kw in CONTROLS.items():
            line[name] = {k: v for k, (v, _) in out["control"](**kw).rows.items()}
        del out
        torch.cuda.empty_cache()
        for name, got in line.items():
            for k, v in got.items():
                readings[name].setdefault(k, []).append(v)
        print(json.dumps({"seed": seed, **line}), flush=True)
    last = {"workload": args.workload,
            "program_max": {k: max(v) for k, v in readings.pop("program").items()}}
    for name, got in readings.items():
        last[f"{name}_min"] = {k: min(v) for k, v in got.items()}
    print(json.dumps(last), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
