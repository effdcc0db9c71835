"""Command-line interface: the decode and preview paths of ``python -m mcraw``.

``python -m mcraw_torch <file> [-n N]`` and ``python -m mcraw_torch decode
<file> [-n N]`` print the frame count, write ``audio.wav``, then
``frame_%06d.dng`` for the first N frames: stdout and files byte-identical
to ``python -m mcraw <file> [-n N]`` (and so to the C++ reference example),
for clips of either codec or a mix of both. ``<file> ...`` keeps the
reference's argv edges; ``decode`` parses strictly. Extras:
``--output-dir``, ``--resume`` (skip DNGs that exist), ``--batch`` (decode
in batched launches of ``--batch-frames`` frames, default 16; every frame
is written, as the reference's batch branch does) and ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain torch versions).
``--pipeline``, ``--verbose`` and ``--trace-dir`` are not ported yet.

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
NOT_PORTED_FLAGS = ("pipeline", "verbose", "trace_dir")


def _not_ported(what: str, use: str) -> int:
    print(f"Error: '{what}' is not yet ported to mcraw_torch; use "
          f"python -m mcraw {use}", file=sys.stderr)
    return 2


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

        if args.batch and args.batch_frames <= 0:
            print("Error: --batch-frames must be positive", file=sys.stderr)
            return -1

        if args.batch and end_frame > 0:
            # Chunked launches bound device and host memory on long clips;
            # each chunk comes to the host once.
            i = 0
            for imgs, metas in d.decode_batch_iter(
                frames[:end_frame], chunk_frames=args.batch_frames
            ):
                imgs = imgs.cpu().numpy()
                for img, metadata in zip(imgs, metas):
                    path = _outpath(outdir, f"frame_{i:06d}.dng")
                    print(f"Writing {path}")
                    write_dng(path, img, metadata, container_metadata)
                    i += 1
        else:
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


def _decode_args(argv: list[str], ref_compat: bool) -> argparse.Namespace:
    # Reference argv edges (mcraw.cli.main) for `<file> ...`: a dangling
    # `-n` is ignored, the -n value is prefix-parsed like std::stoi ("2x" ->
    # 2), and unrecognized extra arguments are ignored. `decode <file> ...`
    # parses strictly.
    if ref_compat:
        if len(argv) == 2 and argv[1] == "-n":
            argv = argv[:1]
        elif len(argv) >= 3 and argv[1] == "-n":
            m = re.match(r"[+-]?\d+", argv[2].strip())
            if m:
                argv[2] = m.group(0)

    ap = argparse.ArgumentParser(prog="mcraw_torch" if ref_compat else "mcraw_torch decode")
    ap.add_argument("input")
    ap.add_argument("-n", dest="num_frames", type=int, default=None,
                    help="number of frames to export")
    ap.add_argument("--output-dir", default=".")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--batch", action="store_true",
                    help="decode frames in batched launches")
    ap.add_argument("--batch-frames", type=int, default=16,
                    help="frames per batched launch (bounds memory)")
    ap.add_argument("--resume", action="store_true",
                    help="skip frames whose DNG already exists")
    ap.add_argument("--pipeline", action="store_true", help="not yet ported")
    ap.add_argument("--verbose", action="store_true", help="not yet ported")
    ap.add_argument("--trace-dir", default=None, help="not yet ported")
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
        return _not_ported(argv[0], argv[0])
    if argv[0] == "preview":
        body, args = _preview_body, _preview_args(argv[1:])
    else:
        sub = argv[0] == "decode"
        ref_compat = not sub and not argv[0].startswith("-")
        body, args = _decode_body, _decode_args(argv[sub:], ref_compat)
        for flag in NOT_PORTED_FLAGS:
            if getattr(args, flag):
                name = "--" + flag.replace("_", "-")
                return _not_ported(name, f"decode {name}")
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
