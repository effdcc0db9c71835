"""The readings the limits of ``correct`` are set from, on the card, at a
cell's own size: the program's compared numbers over many seeds (the lower
reading) and the control's (the upper one), in one process.

    python3 -m gpubench.control --workload <name> --seeds 101,102,... [--seconds 3]

For each seed: one run of the cell with a short window, its numbers, then
the control's numbers on the same kept outputs' inputs: the reference one
step below the configuration's precision put in the program's place
(:mod:`gpubench.check`), its develop in bfloat16 (the control) and in
float16 (read beside it). One JSON line a seed, and a last line with each
number's largest program reading and smallest readings of each control.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from . import run, spec

    if not torch.cuda.is_available():
        print("gpubench.control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = spec.load(args.workload)
    dtypes = {"control": torch.bfloat16, "control_float16": torch.float16}
    readings: dict[str, dict[str, list]] = {"program": {}, **{k: {} for k in dtypes}}
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(cell, seed, args.seconds, False, device)
        line = {"program": {k: v["value"] for k, v in out["result"]["checks"].items()}}
        for name, dtype in dtypes.items():
            line[name] = {k: v for k, (v, _) in out["control"](dtype).rows.items()}
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
