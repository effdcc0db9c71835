"""Command-line interface: the surface of ``python -m mcraw``.

``python -m mcraw_torch <file> [-n N]`` and ``python -m mcraw_torch decode
<file> [-n N]`` print the frame count, write ``audio.wav``, then
``frame_%06d.dng`` for the first N frames: stdout and files byte-identical
to ``python -m mcraw <file> [-n N]`` (and so to the C++ reference example),
for clips of either codec or a mix of both. ``<file> ...`` keeps the
reference's argv edges; ``decode`` parses strictly. Extras:
``--output-dir``, ``--resume`` (skip DNGs that exist), ``--batch`` (decode
in batched launches of ``--batch-frames`` frames, default 16; every frame
is written, as the reference's batch branch does), ``--pipeline`` (the
overlapped export of :func:`mcraw_torch.clip.export_clip`: ``Writing``
lines in the order the writer threads finish, then ``Exported N frames in
...``; a failed frame is reported on stderr and skipped), ``--verbose``
(JSON-line log records and, with ``--pipeline``, the stage timing and
throughput, on stderr), ``--trace-dir D`` (a ``torch.profiler`` Chrome
trace of the decode in D) and ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain torch versions).

Other subcommands, as ``python -m mcraw``'s:

- ``info <file>``: the container summary as JSON (reads the container only).
- ``verify <file> [--quick] [--device cuda|cpu]``: a JSON integrity report
  with per-frame and per-chunk isolation, exit 1 if anything is corrupt;
  ``--quick`` walks the container and bounds-checks the payload headers
  without decoding, the full check decodes every frame on ``--device``.
- ``encode <out> [--frames N] [--width W] [--height H] [--codec 6|7]
  [--seed S]``: a synthetic clip, byte-identical to ``python -m mcraw
  encode``'s for the same arguments.
- ``preview <file> [-n N] [--output-dir D] [--demosaic bilinear|malvar]
  [--device cuda|cpu]``: develops the first N frames (default 1) to
  ``preview_%06d.ppm`` (binary P6 sRGB).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import sys
import threading

import numpy as np

from .container import ContainerReader
from .emit.dng import write_dng
from .emit.wav import write_wav
from .errors import MotionCamException
from .pipeline import Decoder, resolve_device
from .preview import preview_frame
from .util import outpath as _outpath

USAGE = "Usage: decoder <input file> [-n number of frames to export]"
SUBCOMMANDS = ("decode", "info", "encode", "preview", "verify")


def _cmd_decode(args: argparse.Namespace) -> int:
    if args.verbose:
        logging.basicConfig(level=logging.INFO, stream=sys.stderr, format="%(message)s")
    from .observe import device_trace

    # A trace of the card needs the card: no card is the decoder's clean
    # error, not the profiler's.
    device = resolve_device(args.device) if args.trace_dir else args.device
    with device_trace(args.trace_dir, device):
        return _decode_body(args)


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

        if args.pipeline:
            return _export(d, frames[:end_frame], outdir, args)

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


def _export(d: Decoder, timestamps: list[int], outdir: str, args) -> int:
    """decode --pipeline: export_clip, a line per written frame, a failed
    frame's error on stderr, the summary line."""
    from .clip import export_clip

    lock = threading.Lock()  # the writer threads print

    def progress(i: int, path: str) -> None:
        with lock:
            print(f"Writing {path}")

    stats = export_clip(d, outdir, timestamps=timestamps, resume=args.resume,
                        progress=progress)
    for ts, err in stats.errors:
        print(f"Error: frame {ts}: {err}", file=sys.stderr)
    print(f"Exported {stats.frames_done} frames in "
          f"{stats.wall_seconds:.2f}s ({stats.fps:.1f} fps)")
    if args.verbose:
        print(f"stage timing: {stats.stage_timing}", file=sys.stderr)
        print(f"throughput: {stats.throughput}", file=sys.stderr)
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
    ap.add_argument("--pipeline", action="store_true",
                    help="overlapped prepare/decode/write export pipeline")
    ap.add_argument("--verbose", action="store_true",
                    help="structured logs + per-stage timings (stderr)")
    ap.add_argument("--trace-dir", default=None,
                    help="capture a torch.profiler trace to this dir")
    if ref_compat:
        args, _extras = ap.parse_known_args(argv)
    else:
        args = ap.parse_args(argv)
    return args


def _cmd_info(args: argparse.Namespace) -> int:
    with ContainerReader(args.input) as r:
        meta = r.container_metadata
        # Container JSON may legally parse to a non-object (the reference
        # only faults when it reads a key); info reports null fields then.
        if not isinstance(meta, dict):
            meta = {}
        extra = meta.get("extraData")
        if not isinstance(extra, dict):
            extra = {}
        frames = r.frames
        info = {
            "frames": len(frames),
            "first_timestamp": frames[0] if frames else None,
            "last_timestamp": frames[-1] if frames else None,
            "audio_chunks": r.num_audio_chunks,
            "audio_sample_rate": extra.get("audioSampleRate"),
            "audio_channels": extra.get("audioChannels"),
        }
        if frames:
            _, fmeta = r.frame_payload(frames[0])
            if not isinstance(fmeta, dict):
                fmeta = {}
            info.update(
                width=fmeta.get("width"),
                height=fmeta.get("height"),
                compression_type=fmeta.get("compressionType"),
            )
    print(json.dumps(info, indent=2))
    return 0


# _quick_payload_checks is a copy of mcraw.cli's, so that the port imports
# nothing of mcraw.


def _quick_payload_checks(payload, fm) -> None:
    """Structural payload-header validation for `verify --quick`: the bounds
    the modern decoder enforces before decoding (RawData.cpp:547-554), plus
    legacy first-header reachability, with no payload-body decode."""
    from .kernels import tables as T
    from .kernels.numpy_ref import read_metadata_header

    if fm.compression_type == 7:
        ew, eh, bits_off, refs_off = read_metadata_header(np.asarray(payload))
        if bits_off > len(payload) or refs_off > len(payload):
            raise ValueError(
                f"metadata stream offsets out of bounds "
                f"({bits_off}, {refs_off} > {len(payload)})"
            )
        if ew % T.MODERN_BLOCK != 0:
            raise ValueError(f"encodedWidth {ew} not a multiple of 64")
        if ew < fm.width:
            raise ValueError(f"encodedWidth {ew} < width {fm.width}")
    else:
        # Legacy: inline 2-byte headers; the first block of row 0 must be
        # reachable and its declared payload must fit strictly inside the
        # buffer. The decoder's bounds are `offset + 2 + len >= n`
        # (RawData_Legacy.cpp:387/:398, the trailing-byte quirk), so an
        # exact-length payload fails full decode and must fail quick too.
        if fm.height > 0 and fm.width > 0:
            if len(payload) < 2:
                raise ValueError("legacy payload too short for first header")
            bits = min(int(payload[0]) >> 4, 16)
            blen = int(T.LEGACY_BLOCK_LENGTH[bits])
            if 2 + blen >= len(payload):
                raise ValueError(
                    f"legacy first block (bits={bits}, {blen}B) "
                    f"exceeds payload ({len(payload)}B, trailing byte "
                    f"required)"
                )


def _cmd_verify(args: argparse.Namespace) -> int:
    """Clip integrity check: decode every frame and read every audio chunk
    under per-item error isolation, report JSON, exit 1 if anything is
    corrupt. --quick walks the container items, parses frame metadata and
    bounds-checks payload headers without decoding payload bodies."""
    from .metadata import FrameMetadata

    # Resolved before the clip is opened: no card is a clean error of the
    # command (exit -1), not a container_error of the clip.
    device = "cpu" if args.quick else resolve_device(args.device)
    try:
        d = Decoder(args.input, device=device)
    except Exception as e:  # noqa: BLE001 - any open failure is reported
        # The input of this tool is potentially corrupt files: any
        # open-time failure must still yield the promised JSON report.
        print(json.dumps({"ok": False, "container_error": str(e)}, indent=2))
        return 1
    with d:
        frames_failed = []
        for ts in d.frames:
            try:
                if args.quick:
                    payload, meta = d._reader.frame_payload(ts)
                    fm = FrameMetadata(meta)
                    if fm.compression_type not in (6, 7):
                        raise ValueError(f"unknown compressionType {fm.compression_type}")
                    if fm.width <= 0 or fm.height <= 0:
                        raise ValueError(f"bad geometry {fm.width}x{fm.height}")
                    _quick_payload_checks(payload, fm)
                else:
                    img, meta = d.load_frame(ts)
                    fm = FrameMetadata(meta)
                    if img.shape != (fm.height, fm.width):
                        raise ValueError(
                            f"short decode: {img.shape} != ({fm.height}, {fm.width})"
                        )
            except Exception as e:  # noqa: BLE001 - per-frame isolation: keep scanning
                frames_failed.append({"timestamp": ts, "error": str(e)})
        audio_failed = 0
        audio_skipped = 0
        num_chunks = d._reader.num_audio_chunks
        for i in range(num_chunks):
            try:
                if d._reader.audio_chunk(i) is None:
                    # The reference's batch loader skips chunks with invalid
                    # offsets (Decoder.cpp:173-174): a clip it plays cleanly
                    # must not verify as failed. Reported on its own.
                    audio_skipped += 1
            except Exception:  # noqa: BLE001 - per-chunk isolation
                audio_failed += 1
        report = {
            "frames": len(d.frames),
            "frames_ok": len(d.frames) - len(frames_failed),
            "frames_failed": frames_failed,
            "audio_chunks": num_chunks,
            "audio_chunks_failed": audio_failed,
            "audio_chunks_skipped_by_reference": audio_skipped,
            "mode": "quick" if args.quick else "full",
            "ok": not frames_failed and audio_failed == 0,
        }
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


def _cmd_encode(args: argparse.Namespace) -> int:
    """Author a synthetic .mcraw (testing / demo)."""
    from . import encode as E
    from .metadata import example_container_metadata, example_frame_metadata

    rng = np.random.default_rng(args.seed)
    writer = E.ContainerWriter(example_container_metadata())
    for i in range(args.frames):
        img = rng.integers(0, 4096, size=(args.height, args.width), dtype=np.uint16)
        payload = E.encode_modern(img) if args.codec == 7 else E.encode_legacy(img)
        writer.add_frame(
            1000 + 33 * i, payload, example_frame_metadata(args.width, args.height, args.codec)
        )
        writer.add_audio(rng.integers(-3000, 3000, size=2048).astype(np.int16), i * 10**6)
    with open(args.output, "wb") as f:
        f.write(writer.finish())
    print(f"Wrote {args.output}")
    return 0


def _cmd_preview(args: argparse.Namespace) -> int:
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


def _subcommand_args(cmd: str, argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog=f"mcraw_torch {cmd}")
    if cmd == "encode":
        ap.add_argument("output")
        ap.add_argument("--frames", type=int, default=3)
        ap.add_argument("--width", type=int, default=256)
        ap.add_argument("--height", type=int, default=64)
        ap.add_argument("--codec", type=int, default=7, choices=(6, 7))
        ap.add_argument("--seed", type=int, default=0)
        return ap.parse_args(argv)
    ap.add_argument("input")
    if cmd == "verify":
        ap.add_argument("--quick", action="store_true",
                        help="structure-only walk (no payload decode)")
    if cmd in ("verify", "preview"):
        ap.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    if cmd == "preview":
        ap.add_argument("-n", dest="num_frames", type=int, default=1)
        ap.add_argument("--output-dir", default=".")
        ap.add_argument("--demosaic", default="bilinear",
                        choices=("bilinear", "malvar"),
                        help="malvar: 5x5 gradient-corrected (MHC) demosaic")
    return ap.parse_args(argv)


COMMANDS = {"info": _cmd_info, "verify": _cmd_verify, "encode": _cmd_encode,
            "preview": _cmd_preview}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(USAGE)
        return -1
    if argv[0] in COMMANDS:
        fn, args = COMMANDS[argv[0]], _subcommand_args(argv[0], argv[1:])
    else:
        sub = argv[0] == "decode"
        ref_compat = argv[0] not in SUBCOMMANDS and not argv[0].startswith("-")
        fn, args = _cmd_decode, _decode_args(argv[sub:], ref_compat)
    try:
        return fn(args)
    except MotionCamException as e:
        # Uniform clean failure for what a subcommand does not handle
        # itself: corrupt metadata gives "Error: ...", not a traceback.
        print(f"Error: {e}", file=sys.stderr)
        return -1
    except BrokenPipeError:
        # stdout consumer (e.g. `| head`) closed early: exit quietly.
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
