"""Time the five CUDA kernels (modern unpack, develop, legacy unpack,
checksum, the modern device prep) against an earlier version of their
sources, and against variants of the current ones, in turns, on one CUDA
card.

    python -m mcraw_torch.kernel_ab OLD_CSRC [--variant NAME=CSRC ...]
        [--kernels unpack_modern,develop,unpack_legacy,checksum,block_offsets] [--n 20]

OLD_CSRC is a directory with an earlier ``mcraw_torch/csrc`` (for example
unpacked from ``git archive <commit> mcraw_torch/csrc`` into a git-ignored
directory) whose entry points keep today's signatures (those of commit
f00dff1 and later, which have the unpacks' batch entries; the modern
unpack's takes its grid since its kernel is persistent, and an older
one's is called without). A variant is a
full copy of today's ``csrc`` with an edit (same entry points), for a
diagnostic or a candidate. Every library is built with the same flags.
Each kernel is timed at a 4096x3072 12-bit frame (the unpacks and the
device prep as the batch of one), the modern unpack also at the grade
step's batch of 8 and the decode step's of 16 distinct 3840x2160 frames
(its ``unpack.modern.runs`` / ``runs_ahead`` counters beside), the develop
also at the grade step's
batch of 8 3840x2160 frames (and there with a row and a CFA for each
frame, beside the one-row launch of the same frames, where a build has the
per-frame entry) (CUDA-event median of n launches, the 50 MB L2 flushed before each
by writing 256 MB, as chip_smoke.py does, and again by reading them) in
the order old, new, variants, the variants again in reverse, new, old:
the modern unpack on ``encode_modern``'s payload, the legacy unpack on
``encode_legacy``'s (chip_smoke.py's first legacy frame), the checksum on
that frame's uint16 plane, the device prep on the modern payload's bits,
one frame and a batch of 8 (the grade step's) in one launch; a build whose
sources have no prep entry (older than the prep kernel) sits out its turns.
A checksum time is everything a call enqueues:
the new kernel's entry zeroes its own output word, the old one's caller
does (a fill launch, as its wrapper did). The outputs are compared: the
unpacks element for element and the checksum by value against the plain
version; develop by the channels that differ from the plain version and
from the f64 model (the first frame), whether each build's output (the
old one's and the variants') equals the new kernel's bit for bit, each
build reading the quantizer table of its own layout (:func:`quantizer_for`),
and which path (the ``develop.ring`` and ``develop.direct`` counters) the
new wrapper took. The checksum is also timed at 16 elements: the fixed cost of
a call. Prints one JSON line per result, the card's name and power limit
first, the ``-Xptxas -v`` lines of every build, and which kernel functions
compile to the same SASS in the old and the new build (``cuobjdump
-sass``, each function's name without its anonymous-namespace hash), with
the instruction counts of those that do not.
Needs one card.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from . import encode as E
from . import observe
from . import preview as P
from .kernels import build
from .kernels import checksum as C
from .kernels import develop as D
from .kernels import legacy as L
from .kernels import numpy_ref as R
from .kernels import offsets as O
from .kernels import unpack as U
from .kernels.staging import Staging
from .kernels.tables import modern_tables

H, W = 3072, 4096
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
L2_FLUSH_BYTES = 256 << 20
SPIN_CYCLES = 200_000  # ~0.11 ms at the H100's 1.755 GHz boost clock
RGGB = (0, 1, 1, 2)
BENCH_DEVELOP_ARGS = (
    np.zeros(4, np.float32), 4095.0, np.ones(3, np.float32),
    np.diag([0.9642, 1.0, 0.8249]).astype(np.float32),
)
KERNELS = ("unpack_modern", "develop", "unpack_legacy", "checksum", "block_offsets")
OFFSETS_FRAMES = (1, 8)  # the device prep's cases: one frame, the grade step's batch
# The develop's cases (frames, height, width): a 4096x3072 frame, and the
# grade step's batch of 8 BT.2020 UHD frames (gpubench's grade cells).
DEVELOP_SHAPES = ((1, H, W), (8, 2160, 3840))
# The modern unpack's cases (frames, height, width): a 4096x3072 frame,
# the grade step's batch of 8 UHD frames and the decode step's of 16.
UNPACK_SHAPES = ((1, H, W), (8, 2160, 3840), (16, 2160, 3840))


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def twelve_bit(rng, k: int, h: int = H, w: int = W) -> np.ndarray:
    """chip_smoke.py's 12-bit content: a smooth field plus noise."""
    base = (np.sin(np.arange(w) / (97 + k))[None, :]
            * np.cos(np.arange(h) / (61 + k))[:, None] * 1200 + 2000)
    return (base + rng.normal(0, 30, size=(h, w))).clip(0, 4095).astype(np.uint16)


def develop_bytes(frames: int, h: int, w: int) -> int:
    """The develop's bytes: the uint16 plane in, the uint32 RGBA out."""
    return frames * h * w * (2 + 4)


def time_cuda(fn, n: int, flush_by: str = "write") -> float:
    """Median ms of `fn` over n runs by CUDA events, L2 flushed before each:
    by writing a 256 MB buffer ("write", which leaves the L2 full of dirty
    lines that the timed work must write back as it evicts them) or by
    reading it ("read": the L2 holds clean lines). A spin of ~0.1 ms on the
    card after the flush keeps it busy while the host enqueues `fn`, so the
    events time the card's work and not the host's launch path."""
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    words = flush.view(torch.int64)
    fn()
    times = []
    for _ in range(n):
        if flush_by == "write":
            flush.zero_()
        else:
            words.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_lines(csrc: Path, build_dir: Path) -> list[str]:
    log = build.library_path(csrc, build_dir).with_suffix(".log")
    keep = ("Compiling entry", "registers", "spill", "stack frame")
    return [ln.strip() for ln in log.read_text().splitlines() if any(k in ln for k in keep)]


def sass_functions(lib: Path) -> dict[str, list[str]]:
    """Each kernel function's SASS instructions in `lib`, by its name
    without the anonymous-namespace hash (which follows the file's
    contents)."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", m.group(1))
            out[cur] = []
        elif cur and (m := re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?);", line)):
            out[cur].append(m.group(1).strip())
    return out


def turns(name: str, fns: dict, n: int, bound_ms: float, **kw) -> None:
    """Times each of `fns` (old, new, variants...) twice, in the order
    forward then backward, after a flush by writing (`turns_ms`, as
    chip_smoke.py times) and by reading (`turns_ms_clean_l2`), and prints
    them with the share of the bound."""
    order = list(fns) + list(fns)[::-1]
    ms = {k: [] for k in fns}
    clean = {k: [] for k in fns}
    for k in order:
        ms[k].append(time_cuda(fns[k], n, "write"))
        clean[k].append(time_cuda(fns[k], n, "read"))
    emit(kernel=name, turns_ms=ms, turns_ms_clean_l2=clean, bound_ms=bound_ms,
         share_of_bound={k: bound_ms / statistics.mean(v) for k, v in ms.items()},
         n=n, **kw)


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def in_turns(libs: dict, call, new) -> dict:
    """old (where `libs` has it), new, then the variants: `call(name)` runs
    library `name`, `new` the current kernel through its wrapper."""
    old = {"old": call("old")} if "old" in libs else {}
    return old | {"new": new} | {k: call(k) for k in libs if k != "old"}


def with_entry(libs: dict, entry: str) -> dict:
    """The libraries that have the C entry `entry`: an earlier csrc may
    not."""
    return {k: lib for k, lib in libs.items() if hasattr(lib, entry)}


def offsets_bytes(frames: int, nblk: int) -> int:
    """The device prep's bytes: each block's uint16 bits in, its int64
    offset out."""
    return frames * nblk * (2 + 8)


def unpack_grid(lib, frames: int, tiles: int) -> tuple:
    """The grid argument of `lib`'s modern unpack entry for a launch, as
    the wrapper computes it (unpack.modern_grid from the library's own
    resident blocks); none for a csrc older than the persistent kernel."""
    if not hasattr(lib, "mcraw_unpack_modern_resident"):
        return ()
    resident = lib.mcraw_unpack_modern_resident()
    build.check(max(-resident, 0), "mcraw_unpack_modern_resident")
    return (U.modern_grid(frames, tiles, resident).grid,)


def modern_payloads(frames: int, h: int, w: int) -> list:
    """`frames` distinct 12-bit frames (twelve_bit, frame k's own field),
    each encode_modern's payload: payloads of different sizes."""
    rng = np.random.default_rng(21)
    return [np.frombuffer(E.encode_modern(twelve_bit(rng, k, h, w)), np.uint8)
            for k in range(frames)]


def ab_unpack_modern(libs: dict, dev, n: int) -> None:
    """The modern unpack at a 4096x3072 frame (the batch of one) and at the
    cells' steps (UNPACK_SHAPES): each build's output held to the plain
    version's; bytes as gpubench/roofline.py counts them (payload, bits
    and refs in, plane out) plus the int64 offsets the kernel reads."""
    tab = modern_tables(dev)
    encoded = {}
    for frames, h, w in UNPACK_SHAPES:
        if (h, w) not in encoded:
            most = max(f for f, hh, ww in UNPACK_SHAPES if (hh, ww) == (h, w))
            encoded[h, w] = modern_payloads(most, h, w)
        payloads = encoded[h, w][:frames]
        batch = U.stage_modern_batch(Staging(dev), payloads, w, h)
        offs = U.block_offsets(batch.bits, tab)
        args = (batch.words, batch.bases, batch.lengths, batch.bits, batch.refs, offs)
        kw = dict(ty=batch.tiles_y, tx=batch.tiles_x, height=h, width=w)
        nblk = batch.bits.shape[1]
        launch = U.unpack_launch(batch.tiles_y, batch.tiles_x, h, w)
        outs = {k: torch.empty((frames, h, w), dtype=torch.uint16, device=dev) for k in libs}

        def call(name):
            grid = unpack_grid(libs[name], frames, launch.tiles)

            def run():
                build.check(libs[name].mcraw_unpack_modern_batch(
                    batch.words.data_ptr(), batch.words.numel(), batch.bases.data_ptr(),
                    batch.lengths.data_ptr(), frames, nblk, batch.bits.data_ptr(),
                    batch.refs.data_ptr(), offs.data_ptr(), tab.quads.data_ptr(),
                    tab.class_index.data_ptr(), outs[name].data_ptr(), h * w, batch.tiles_x,
                    launch.tiles, launch.rows, w, *grid, stream()),
                    f"{name} mcraw_unpack_modern_batch")
            return run

        fns = in_turns(libs, call, lambda: U.decode_modern_batch_device(*args, **kw))
        with observe.tracing() as record:
            results = {k: f() for k, f in fns.items()}
        want = U.decode_modern_batch_plain(*args, **kw).to(torch.int32)
        torch.cuda.synchronize()
        got = {k: results["new"] if k == "new" else outs[k] for k in fns}
        moved = sum(map(len, payloads)) + frames * (nblk * (2 + 2 + 8) + 2 * h * w)
        turns("unpack_modern", fns, n, moved / PEAK_BYTES_PER_S * 1e3,
              frame=f"{frames}x{w}x{h} 12-bit", frames=frames, bytes=moved,
              payload_bytes=[len(p) for p in payloads],
              counters={k: v for k, v in record.counters.items() if k.startswith("unpack.")},
              exact={k: bool(torch.equal(v.to(torch.int32), want)) for k, v in got.items()})
        del outs, results, got, want, batch, offs, args


def quantizer_for(csrc: Path, dev) -> torch.Tensor:
    """The quantizer table that `csrc`'s develop.cu reads, on `dev`: a
    word a bucket (``develop.quantizer_table``), or, in a csrc older than
    that layout (its table of ``uint2``), the bucket's (next threshold's
    float32 bits, base) pair."""
    if "sizeof(uint2) * kQuantizer" not in (csrc / "develop.cu").read_text():
        return D._quantizer_on(dev)
    next_thr, base = D.srgb_quantizer()
    pairs = np.stack([next_thr.view(np.int32), base.astype(np.int32)], -1)
    return torch.from_numpy(pairs).to(dev)


def ab_develop(libs: dict, tables: dict, dev, n: int) -> None:
    """`tables`: each library's quantizer table (:func:`quantizer_for`)."""
    params = D.pack_develop_params(*BENCH_DEVELOP_ARGS)
    prm = np.ascontiguousarray(params.reshape(-1))
    cfa32 = np.asarray(RGGB, np.int32)

    def channels(a):
        a = a.to(torch.int64)
        return torch.stack([(a >> s) & 0xFF for s in (0, 8, 16)], -1)

    def differ(a, b):
        d = (channels(a) - b).abs()
        return {"max_abs_err": int(d.max().item()), "channels_differ": int((d != 0).sum().item())}

    for frames, h, w in DEVELOP_SHAPES:
        rng = np.random.default_rng(14)
        x = torch.from_numpy(np.stack([twelve_bit(rng, k, h, w) for k in range(frames)]))
        x = (x[0] if frames == 1 else x).to(dev)
        moved = develop_bytes(frames, h, w)
        # A build with the ring entry takes it where the wrapper would.
        ring = D.ring_takes(x.data_ptr(), w, prm)
        maps = {k: D.encode_tensor_map(lib, x.data_ptr(), frames, h, w)
                for k, lib in with_entry(libs, "mcraw_develop_ring").items() if ring}
        for mode in D.DEMOSAICS:
            outs = {k: torch.empty(x.shape, dtype=torch.uint32, device=dev) for k in libs}

            def call(name):
                args = (x.data_ptr(), outs[name].data_ptr(), frames, h, w, prm.ctypes.data,
                        cfa32.ctypes.data, tables[name].data_ptr(), D.DEMOSAICS.index(mode))

                def run():
                    if name in maps:
                        err = libs[name].mcraw_develop_ring(*args, maps[name].ctypes.data,
                                                            stream())
                    else:
                        err = libs[name].mcraw_develop(*args, stream())
                    build.check(err, f"{name} develop")
                return run

            fns = in_turns(libs, call,
                           lambda: D.develop_rgba_device(x, params, cfa=RGGB, demosaic=mode))
            with observe.tracing() as record:
                results = {k: f() for k, f in fns.items()}
            plain = channels(D.develop_rgba_plain(x, params, cfa=RGGB, demosaic=mode))
            torch.cuda.synchronize()
            got = {k: results["new"] if k == "new" else outs[k] for k in fns}
            # The f64 model of the first frame (a batch's others would take
            # minutes on the host).
            first = torch.from_numpy(P.develop_f64(
                x.reshape(-1, h, w)[0].cpu().numpy(), *BENCH_DEVELOP_ARGS, RGGB,
                demosaic=mode)).to(dev)
            turns(f"develop_{mode}", fns, n, moved / PEAK_BYTES_PER_S * 1e3,
                  frame=f"{frames}x{w}x{h} 12-bit", frames=frames, bytes=moved,
                  path={k: v for k, v in record.counters.items() if k.startswith("develop.")},
                  ring_entry=sorted(maps),
                  vs_plain={k: differ(v, plain) for k, v in got.items()},
                  vs_f64_first_frame={k: differ(v.reshape(-1, h, w)[0], first)
                                      for k, v in got.items()},
                  plain_vs_f64_first_frame={
                      "max_abs_err": int((plain.reshape(-1, h, w, 3)[0] - first).abs().max()),
                  },
                  channels=3 * frames * h * w,
                  equals_new={k: bool(torch.equal(v.to(torch.int64),
                                                  got["new"].to(torch.int64)))
                              for k, v in got.items()})
            del outs, results, got, plain


def frame_rows(frames: int, seed: int = 19) -> tuple[np.ndarray, np.ndarray]:
    """(frames, 128) rows and (frames, 4) CFAs of a multiview step: each
    frame its own black levels in [56, 72], neutral and forward matrix, the
    four Bayer patterns in turn."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([D.pack_develop_params(
        rng.integers(56, 73, 4).astype(np.float32), 4095.0,
        np.array([rng.uniform(0.4, 0.9), 1.0, rng.uniform(0.4, 0.9)], np.float32),
        (np.diag([0.9642, 1.0, 0.8249]) + rng.normal(0, 0.05, (3, 3))).astype(np.float32))
        for _ in range(frames)])
    cfas = np.array([D.BAYER_CFAS[f % 4] for f in range(frames)], np.int32)
    return rows, cfas


def ab_develop_rows(libs: dict, tables: dict, dev, n: int) -> None:
    """The per-frame develop at the grade step's batch (8 UHD frames, a row
    and a CFA each), timed beside the one-row launch of the same frames
    (row 0, CFA 0 for all) in the same turns, each library with its own
    quantizer table (`tables`); each output held to single calls with each
    frame's own row and CFA, and to the new kernel's bit for bit."""
    frames, h, w = DEVELOP_SHAPES[-1]
    rng = np.random.default_rng(14)
    x = torch.from_numpy(np.stack([twelve_bit(rng, k, h, w) for k in range(frames)])).to(dev)
    rows, cfas = frame_rows(frames)
    rows_d, cfas_d = torch.from_numpy(rows).to(dev), torch.from_numpy(cfas).to(dev)
    moved = develop_bytes(frames, h, w) + frames * (rows.shape[1] * 4 + 16)
    quantizer = D._quantizer_on(dev)  # the current build's, for the one-row launch
    tmap = D.encode_tensor_map(build.lib(), x.data_ptr(), frames, h, w)
    for mode in D.DEMOSAICS:
        singles = torch.stack([D.develop_rgba_device(x[f], rows[f], cfa=tuple(cfas[f]),
                                                     demosaic=mode) for f in range(frames)])
        rows_libs = with_entry(libs, "mcraw_develop_rows_ring")
        outs = {k: torch.empty(x.shape, dtype=torch.uint32, device=dev) for k in rows_libs}

        def call(name):
            maps = D.encode_tensor_map(libs[name], x.data_ptr(), frames, h, w)

            def run():
                build.check(libs[name].mcraw_develop_rows_ring(
                    x.data_ptr(), outs[name].data_ptr(), frames, h, w, rows_d.data_ptr(),
                    rows_d.stride(0), cfas_d.data_ptr(), cfas_d.stride(0),
                    tables[name].data_ptr(), D.DEMOSAICS.index(mode), maps.ctypes.data,
                    stream()), f"{name} develop rows")
            return run

        one = torch.empty(x.shape, dtype=torch.uint32, device=dev)
        prm, cfa0 = np.ascontiguousarray(rows[0]), np.asarray(cfas[0], np.int32)

        def one_row():
            build.check(build.lib().mcraw_develop_ring(
                x.data_ptr(), one.data_ptr(), frames, h, w, prm.ctypes.data, cfa0.ctypes.data,
                quantizer.data_ptr(), D.DEMOSAICS.index(mode), tmap.ctypes.data, stream()),
                "one row")

        fns = {**({"old": call("old")} if "old" in rows_libs else {}),
               "new": lambda: D.develop_rgba_device(x, rows_d, cfa=cfas_d, demosaic=mode),
               "one_row": one_row,
               **{k: call(k) for k in rows_libs if k != "old"}}
        with observe.tracing() as record:
            results = {k: f() for k, f in fns.items()}
        torch.cuda.synchronize()
        got = {k: results["new"] if k == "new" else outs.get(k, one) for k in fns}
        turns(f"develop_rows_{mode}", fns, n, moved / PEAK_BYTES_PER_S * 1e3,
              frame=f"{frames}x{w}x{h} 12-bit, a row and a CFA each", frames=frames,
              bytes=moved,
              path={k: v for k, v in record.counters.items() if k.startswith("develop.")},
              equals_single_calls={k: bool(torch.equal(v.to(torch.int64),
                                                       singles.to(torch.int64)))
                                   for k, v in got.items() if k != "one_row"},
              equals_new={k: bool(torch.equal(v.to(torch.int64), got["new"].to(torch.int64)))
                          for k, v in got.items() if k != "one_row"})
        del outs, results, got, singles


def legacy_image() -> np.ndarray:
    """chip_smoke.py's first legacy frame."""
    return twelve_bit(np.random.default_rng(12), 0)


def ab_unpack_legacy(libs: dict, dev, n: int) -> None:
    payload = np.frombuffer(E.encode_legacy(legacy_image()), np.uint8)
    frame = L.stage_legacy(Staging(dev), payload, W, H)  # the batch of one
    scan = L.scan_chain(payload, L.num_blocks(W, H))[1]
    kw = dict(height=H, width=W)
    outs = {k: torch.empty((1, H, W), dtype=torch.uint16, device=dev) for k in libs}

    def call(name):
        def run():
            build.check(libs[name].mcraw_unpack_legacy_batch(
                frame.payload.data_ptr(), frame.payload.numel(), frame.bases.data_ptr(),
                frame.lengths.data_ptr(), 1, frame.bits.data_ptr(), frame.refs.data_ptr(),
                frame.offsets.data_ptr(), outs[name].data_ptr(), H, W,
                R.legacy_padded_width(W), stream()), f"{name} mcraw_unpack_legacy_batch")
        return run

    fns = in_turns(libs, call, lambda: L.decode_legacy_batch_device(*frame, **kw))
    results = {k: f() for k, f in fns.items()}
    want = L.decode_legacy_batch_plain(*frame, **kw).to(torch.int32)
    torch.cuda.synchronize()
    got = {k: results["new"] if k == "new" else outs[k] for k in fns}
    nblk = L.num_blocks(W, H)
    moved = len(payload) + 2 * H * W + nblk * (4 + 2 + 8)
    turns("unpack_legacy", fns, n, moved / PEAK_BYTES_PER_S * 1e3,
          frame=f"legacy {W}x{H} 12-bit", bytes=moved, scan=scan,
          exact={k: bool(torch.equal(v.to(torch.int32), want)) for k, v in got.items()})


def ab_block_offsets(libs: dict, dev, n: int) -> None:
    rng = np.random.default_rng(21)
    payload = np.frombuffer(E.encode_modern(twelve_bit(rng, 0)), np.uint8)
    one = U.stage_modern(Staging(dev), payload, W, H).bits.clone()  # (1, nblk)
    nblk = one.shape[1]
    entry = "mcraw_block_offsets_batch"
    have = with_entry(libs, entry)
    for frames in OFFSETS_FRAMES:
        bits = one.repeat(frames, 1)
        words = O.status_words(frames, nblk)
        outs = {k: torch.empty(bits.shape, dtype=torch.int64, device=dev) for k in have}
        status = {k: torch.empty(words, dtype=torch.int64, device=dev) for k in have}

        def call(name):
            fn = getattr(have[name], entry)

            def run():
                build.check(fn(bits.data_ptr(), frames, nblk, outs[name].data_ptr(),
                               status[name].data_ptr(), words, stream()), f"{name} {entry}")
            return run

        fns = in_turns(have, call, lambda: O.block_offsets_device(bits))
        results = {k: f() for k, f in fns.items()}
        want = O.block_offsets_plain(bits.cpu())
        torch.cuda.synchronize()
        got = {k: results["new"] if k == "new" else outs[k] for k in fns}
        moved = offsets_bytes(frames, nblk)
        turns("block_offsets", fns, n, moved / PEAK_BYTES_PER_S * 1e3,
              frames=frames, blocks=nblk, bytes=moved, without_entry=sorted(set(libs) - set(have)),
              exact={k: bool(torch.equal(v.cpu(), want)) for k, v in got.items()})


def checksum_fns(libs: dict, x: torch.Tensor) -> tuple[dict, dict]:
    """Callables for one checksum of `x` by each build (old, new,
    variants), and the output words of the libraries called directly."""
    outs = {k: torch.empty((), dtype=torch.int64, device=x.device) for k in libs}

    def call(name):
        def run():
            if name == "old":  # the parent's entry adds into a word its caller zeroes
                outs[name].zero_()
            build.check(libs[name].mcraw_checksum(
                x.data_ptr(), x.numel(), x.element_size(), outs[name].data_ptr(), stream()),
                f"{name} mcraw_checksum")
        return run

    return in_turns(libs, call, lambda: C.device_checksum(x)), outs


def ab_checksum(libs: dict, img: torch.Tensor, n: int) -> None:
    fns, outs = checksum_fns(libs, img)
    results = {k: f() for k, f in fns.items()}
    want = int(C.checksum_plain(img).item())
    got = {k: int((results["new"] if k == "new" else outs[k]).item()) for k in fns}
    moved = 2 * img.numel() + 4
    turns("checksum", fns, n, moved / PEAK_BYTES_PER_S * 1e3,
          input=f"{W}x{H} uint16 (the legacy frame's plane)", bytes=moved,
          exact={k: v == want for k, v in got.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mcraw_torch.kernel_ab")
    ap.add_argument("old_csrc", type=Path)
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=CSRC",
                    help="a copy of today's csrc with an edit, timed beside new")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help=f"comma-separated subset of {','.join(KERNELS)}")
    ap.add_argument("--n", type=int, default=20)
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernels takes {','.join(KERNELS)}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda", 0)
    build.lib()
    libs = {"old": build.load(build.build(args.old_csrc, build.BUILD_DIR / "ab_old"))}
    tables = {"old": quantizer_for(args.old_csrc, dev)}
    emit(ptxas_new=ptxas_lines(build.CSRC, build.BUILD_DIR),
         ptxas_old=ptxas_lines(args.old_csrc, build.BUILD_DIR / "ab_old"))
    old = sass_functions(build.library_path(args.old_csrc, build.BUILD_DIR / "ab_old"))
    new = sass_functions(build.library_path())
    emit(sass={"functions_old": len(old), "functions_new": len(new),
               "identical": sum(old.get(k) == v for k, v in new.items()),
               "differ": sorted(k for k, v in new.items() if old.get(k) != v),
               "instructions_old_new": {k: [len(old.get(k, [])), len(v)]
                                        for k, v in sorted(new.items()) if old.get(k) != v}})
    for spec in args.variant:
        name, csrc = spec.split("=", 1)
        out_dir = build.BUILD_DIR / f"ab_{name}"
        libs[name] = build.load(build.build(Path(csrc), out_dir))
        tables[name] = quantizer_for(Path(csrc), dev)
        emit(variant=name, ptxas=ptxas_lines(Path(csrc), out_dir))

    if "unpack_modern" in kernels:
        ab_unpack_modern(libs, dev, args.n)
    if "develop" in kernels:
        ab_develop(libs, tables, dev, args.n)
        ab_develop_rows(libs, tables, dev, args.n)
    if "unpack_legacy" in kernels:
        ab_unpack_legacy(libs, dev, args.n)
    if "checksum" in kernels:
        ab_checksum(libs, torch.from_numpy(legacy_image()).to(dev), args.n)
        # The fixed cost of a call (launches, zeroing, reduction): 16 elements.
        tiny = torch.from_numpy(legacy_image()[0, :16].copy()).to(dev)
        turns("checksum_16_elements", checksum_fns(libs, tiny)[0], args.n,
              (2 * tiny.numel() + 4) / PEAK_BYTES_PER_S * 1e3)
    if "block_offsets" in kernels:
        ab_block_offsets(libs, dev, args.n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
