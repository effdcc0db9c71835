"""Command-line interface: the decode path of ``python -m mcraw``.

``python -m mcraw_torch <file> [-n N]`` prints the frame count, writes
``audio.wav``, then ``frame_%06d.dng`` for the first N frames: stdout and
files byte-identical to ``python -m mcraw <file> [-n N]`` (and so to the
C++ reference example), for clips of either codec or a mix of both.
Extras: ``--output-dir``, ``--resume`` (skip DNGs that exist) and
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain torch
versions).

``python -m mcraw_torch preview <file> [-n N] [--output-dir D]
[--demosaic bilinear|malvar] [--device cuda|cpu]`` develops the first N
frames (default 1) to ``preview_%06d.ppm`` (binary P6 sRGB), as
``python -m mcraw preview`` does. The JAX package's other subcommands are
not ported yet.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

from .emit.dng import write_dng
from .emit.wav import write_wav
from .errors import MotionCamException
from .pipeline import Decoder
from .preview import preview_frame
from .util import outpath as _outpath

USAGE = "Usage: decoder <input file> [-n number of frames to export]"
NOT_PORTED = ("info", "encode", "verify")


def _decode_body(args: argparse.Namespace) -> int:
    try:
        d = Decoder(args.input, device=args.device)
        frames = d.frames
        container_metadata = d.container_metadata

        print(f"Found {len(frames)} frames")

        end_frame = args.num_frames
        if end_frame is None or end_frame < 0:
            end_frame = len(frames)
        end_frame = min(len(frames), max(0, end_frame))

        outdir = args.output_dir
        os.makedirs(outdir, exist_ok=True)

        write_wav(
            _outpath(outdir, "audio.wav"),
            d.audio_sample_rate_hz(),
            d.num_audio_channels(),
            d.load_audio(),
        )

        for i in range(end_frame):
            path = _outpath(outdir, f"frame_{i:06d}.dng")
            if args.resume and os.path.exists(path):
                continue
            img, metadata = d.load_frame(frames[i])
            print(f"Writing {path}")
            write_dng(path, img, metadata, container_metadata)
    except MotionCamException as e:
        print(f"Error: {e}", file=sys.stderr)
        return -1
    return 0


def _decode_args(argv: list[str]) -> argparse.Namespace:
    # Reference argv edges (mcraw.cli.main): for `<file> ...` a dangling
    # `-n` is ignored, the -n value is prefix-parsed like std::stoi ("2x" ->
    # 2), and unrecognized extra arguments are ignored.
    ref_compat = not argv[0].startswith("-")
    if ref_compat:
        if len(argv) == 2 and argv[1] == "-n":
            argv = argv[:1]
        elif len(argv) >= 3 and argv[1] == "-n":
            m = re.match(r"[+-]?\d+", argv[2].strip())
            if m:
                argv[2] = m.group(0)

    ap = argparse.ArgumentParser(prog="mcraw_torch")
    ap.add_argument("input")
    ap.add_argument("-n", dest="num_frames", type=int, default=None,
                    help="number of frames to export")
    ap.add_argument("--output-dir", default=".")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--resume", action="store_true",
                    help="skip frames whose DNG already exists")
    if ref_compat:
        args, _extras = ap.parse_known_args(argv)
    else:
        args = ap.parse_args(argv)
    return args


def _preview_body(args: argparse.Namespace) -> int:
    """Develop frames to viewable sRGB images (binary PPM, no deps)."""
    try:
        d = Decoder(args.input, device=args.device)
        frames = d.frames
        n = len(frames) if args.num_frames is None else min(args.num_frames, len(frames))
        os.makedirs(args.output_dir, exist_ok=True)
        for i in range(n):
            rgb = preview_frame(d, frames[i], demosaic=args.demosaic).cpu().numpy()
            path = os.path.join(args.output_dir, f"preview_{i:06d}.ppm")
            with open(path, "wb") as f:
                f.write(b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]))
                f.write(rgb.tobytes())
            print(f"Writing {path}")
    except MotionCamException as e:
        print(f"Error: {e}", file=sys.stderr)
        return -1
    return 0


def _preview_args(argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="mcraw_torch preview")
    ap.add_argument("input")
    ap.add_argument("-n", dest="num_frames", type=int, default=1)
    ap.add_argument("--output-dir", default=".")
    ap.add_argument("--demosaic", default="bilinear",
                    choices=("bilinear", "malvar"),
                    help="malvar: 5x5 gradient-corrected (MHC) demosaic")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(USAGE)
        return -1
    if argv[0] in NOT_PORTED:
        print(f"Error: '{argv[0]}' is not yet ported to mcraw_torch; use "
              f"python -m mcraw {argv[0]}", file=sys.stderr)
        return 2
    if argv[0] == "preview":
        body, args = _preview_body, _preview_args(argv[1:])
    else:
        body, args = _decode_body, _decode_args(argv)
    try:
        return body(args)
    except BrokenPipeError:
        # stdout consumer (e.g. `| head`) closed early: exit quietly.
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
