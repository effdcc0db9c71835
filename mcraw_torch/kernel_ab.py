"""Time the develop and modern unpack kernels against an earlier version of
their sources, and against variants of the current ones, in turns, on one
CUDA card.

    python -m mcraw_torch.kernel_ab OLD_CSRC [--variant NAME=CSRC ...] [--n 20]

OLD_CSRC is a directory with an earlier ``mcraw_torch/csrc`` (for example
unpacked from ``git archive <commit> mcraw_torch/csrc`` into a git-ignored
directory) whose ``mcraw_develop`` and ``mcraw_unpack_modern`` keep the
entry points of commit 5002859. A variant is a full copy of today's
``csrc`` with an edit (same entry points), for a diagnostic or a candidate.
Every library is built with the same flags. Each kernel is timed at a
4096x3072 12-bit frame (CUDA-event median of n launches, the 50 MB L2
flushed before each) in the order old, new, variants, the variants again
in reverse, new, old. The outputs are compared: unpack element for element
against the plain version; develop by the channels that differ from the
plain version and from the f64 model, and whether a variant's output equals
the new kernel's bit for bit. Prints one JSON line per result, the card's
name and power limit first, and the ``-Xptxas -v`` lines of every build.
Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from . import encode as E
from . import preview as P
from .kernels import build
from .kernels import develop as D
from .kernels import unpack as U
from .kernels.tables import modern_tables, pack_descriptors

H, W = 3072, 4096
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
L2_FLUSH_BYTES = 256 << 20
SPIN_CYCLES = 200_000  # ~0.11 ms at the H100's 1.755 GHz boost clock
RGGB = (0, 1, 1, 2)
BENCH_DEVELOP_ARGS = (
    np.zeros(4, np.float32), 4095.0, np.ones(3, np.float32),
    np.diag([0.9642, 1.0, 0.8249]).astype(np.float32),
)


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def twelve_bit(rng, k: int) -> np.ndarray:
    """chip_smoke.py's 12-bit content: a smooth field plus noise."""
    base = (np.sin(np.arange(W) / (97 + k))[None, :]
            * np.cos(np.arange(H) / (61 + k))[:, None] * 1200 + 2000)
    return (base + rng.normal(0, 30, size=(H, W))).clip(0, 4095).astype(np.uint16)


def time_cuda(fn, n: int) -> float:
    """Median ms of `fn` over n runs by CUDA events, L2 flushed before each.
    A spin of ~0.1 ms on the card after the flush keeps it busy while the
    host enqueues `fn`, so the events time the card's work and not the
    host's launch path."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def old_library(csrc: Path) -> ctypes.CDLL:
    """The earlier sources built with today's flags, entry points bound with
    the signatures of commit 5002859."""
    lib = ctypes.CDLL(str(build.build(csrc, build.BUILD_DIR / "ab_old")))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.mcraw_unpack_modern.restype = ctypes.c_int
    lib.mcraw_unpack_modern.argtypes = [p, i64, p, p, p, p, p, p, i64, i64, i64, p]
    lib.mcraw_develop.restype = ctypes.c_int
    lib.mcraw_develop.argtypes = [p, p, i64, i64, i64, p, p, ctypes.c_int32, p]
    return lib


def ptxas_lines(csrc: Path, build_dir: Path) -> list[str]:
    log = build.library_path(csrc, build_dir).with_suffix(".log")
    keep = ("Compiling entry", "registers", "spill", "stack frame")
    return [ln.strip() for ln in log.read_text().splitlines() if any(k in ln for k in keep)]


def turns(name: str, fns: dict, n: int, bound_ms: float, **kw) -> None:
    """Times each of `fns` (old, new, variants...) twice, in the order
    forward then backward, and prints them with the share of the bound."""
    order = list(fns) + list(fns)[::-1]
    ms = {k: [] for k in fns}
    for k in order:
        ms[k].append(time_cuda(fns[k], n))
    emit(kernel=name, turns_ms=ms, bound_ms=bound_ms,
         share_of_bound={k: bound_ms / statistics.mean(v) for k, v in ms.items()},
         n=n, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mcraw_torch.kernel_ab")
    ap.add_argument("old_csrc", type=Path)
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=CSRC",
                    help="a copy of today's csrc with an edit, timed beside new")
    ap.add_argument("--n", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda", 0)
    build.lib()
    old = old_library(args.old_csrc)
    emit(ptxas_new=ptxas_lines(build.CSRC, build.BUILD_DIR),
         ptxas_old=ptxas_lines(args.old_csrc, build.BUILD_DIR / "ab_old"))
    variants = {}
    for spec in args.variant:
        name, csrc = spec.split("=", 1)
        out_dir = build.BUILD_DIR / f"ab_{name}"
        variants[name] = build.load(build.build(Path(csrc), out_dir))
        emit(variant=name, ptxas=ptxas_lines(Path(csrc), out_dir))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    # Modern unpack at a 4K 12-bit frame.
    rng = np.random.default_rng(21)
    payload = np.frombuffer(E.encode_modern(twelve_bit(rng, 0)), np.uint8)
    frame = U.upload(U.prepare_modern(payload, W, H), dev)
    tab = modern_tables(dev)
    offs = U.block_offsets(frame.bits, tab)
    kw = dict(ty=frame.tiles_y, tx=frame.tiles_x, height=H, width=W)
    packed = torch.from_numpy(pack_descriptors()).to(dev)  # the old kernel's table
    outs = {k: torch.empty((H, W), dtype=torch.uint16, device=dev) for k in ("old", *variants)}

    def unpack_old():
        build.check(old.mcraw_unpack_modern(
            frame.words.data_ptr(), frame.words.numel(), frame.bits.data_ptr(),
            frame.refs.data_ptr(), offs.data_ptr(), packed.data_ptr(),
            tab.class_index.data_ptr(), outs["old"].data_ptr(), frame.tiles_x, H, W,
            stream()), "old mcraw_unpack_modern")

    def unpack_variant(name):
        def run():
            build.check(variants[name].mcraw_unpack_modern(
                frame.words.data_ptr(), frame.words.numel(), frame.bits.data_ptr(),
                frame.refs.data_ptr(), offs.data_ptr(), tab.quads.data_ptr(),
                tab.class_index.data_ptr(), outs[name].data_ptr(), frame.tiles_x,
                frame.tiles_y * frame.tiles_x, H, W, stream()), f"{name} mcraw_unpack_modern")
        return run

    fns = {"old": unpack_old,
           "new": lambda: U.decode_modern_device(frame.words, frame.bits, frame.refs, offs, **kw)}
    fns |= {name: unpack_variant(name) for name in variants}
    results = {k: f() for k, f in fns.items()}
    want = U.decode_modern_plain(frame.words, frame.bits, frame.refs, offs, **kw).to(torch.int32)
    torch.cuda.synchronize()
    got = {k: results["new"] if k == "new" else outs[k] for k in fns}
    nblk = frame.bits.numel()
    moved = len(payload) + nblk * (2 + 2 + 8) + 2 * H * W
    turns("unpack_modern", fns, args.n, moved / PEAK_BYTES_PER_S * 1e3,
          frame=f"{W}x{H} 12-bit", bytes=moved,
          exact={k: bool(torch.equal(v.to(torch.int32), want)) for k, v in got.items()})

    # Develop at a 4K 12-bit frame, the bench's parameters.
    x = torch.from_numpy(twelve_bit(np.random.default_rng(14), 0)).to(dev)
    params = D.pack_develop_params(*BENCH_DEVELOP_ARGS)
    prm = np.ascontiguousarray(params.reshape(-1))
    cfa32 = np.asarray(RGGB, np.int32)
    quantizer = D._quantizer_on(dev)
    moved = H * W * (2 + 4)

    def channels(a):
        a = a.to(torch.int64).cpu()
        return torch.stack([(a >> s) & 0xFF for s in (0, 8, 16)], -1)

    def differ(a, b):
        d = (channels(a) - b).abs()
        return {"max_abs_err": int(d.max().item()), "channels_differ": int((d != 0).sum().item())}

    for mode in D.DEMOSAICS:
        outs = {k: torch.empty((H, W), dtype=torch.uint32, device=dev)
                for k in ("old", *variants)}

        def develop_old():
            build.check(old.mcraw_develop(
                x.data_ptr(), outs["old"].data_ptr(), 1, H, W, prm.ctypes.data,
                cfa32.ctypes.data, D.DEMOSAICS.index(mode), stream()), "old mcraw_develop")

        def develop_variant(name):
            def run():
                build.check(variants[name].mcraw_develop(
                    x.data_ptr(), outs[name].data_ptr(), 1, H, W, prm.ctypes.data,
                    cfa32.ctypes.data, quantizer.data_ptr(), D.DEMOSAICS.index(mode),
                    stream()), f"{name} mcraw_develop")
            return run

        fns = {"old": develop_old,
               "new": lambda: D.develop_rgba_device(x, params, cfa=RGGB, demosaic=mode)}
        fns |= {name: develop_variant(name) for name in variants}
        results = {k: f() for k, f in fns.items()}
        plain = D.develop_rgba_plain(x, params, cfa=RGGB, demosaic=mode)
        torch.cuda.synchronize()
        got = {k: results["new"] if k == "new" else outs[k] for k in fns}
        model = torch.from_numpy(P.develop_f64(
            x.cpu().numpy(), *BENCH_DEVELOP_ARGS, RGGB, demosaic=mode))
        turns(f"develop_{mode}", fns, args.n, moved / PEAK_BYTES_PER_S * 1e3,
              frame=f"{W}x{H} 12-bit", bytes=moved,
              vs_plain={k: differ(v, channels(plain)) for k, v in got.items()},
              vs_f64={k: differ(v, model) for k, v in got.items()},
              plain_vs_f64=differ(plain, model), channels=3 * H * W,
              equals_new={k: bool(torch.equal(v.to(torch.int64), got["new"].to(torch.int64)))
                          for k, v in got.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
