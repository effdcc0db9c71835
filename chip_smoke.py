#!/usr/bin/env python3
"""Smoke run of mcraw_torch on one CUDA card: build, check, decode, develop,
time.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing one JSON line; any
failure exits non-zero and prints no result:

1. device: torch and CUDA versions, the card's name and power limit.
2. build: nvcc builds the kernels from ``mcraw_torch/csrc``.
3. kernels: each CUDA kernel against its plain torch version on the card:
   element-exact for the integer kernels (modern unpack at four geometries
   with bits 0..65535 and wrapping refs, and at the tiled kernel's edges:
   widths 4032, 4000 (W % 64 != 0), 4036 and 4090 (W % 8 != 0), a short
   encodedHeight, bits 0..16 one width a tile, all-16-bit blocks, shuffled
   offsets; legacy unpack on a synthetic header chain with bits 0..16 at
   five geometries up to 4096x3072 and at its edges: widths 4000 (runs
   that cross rows), 4036, 4090, 33 and 1 with refs up to 65535, shuffled
   offsets, offsets around the end of the payload, no zero tail; checksum
   at odd shapes, 4K uint16, (6144, 4096) uint32, views that start off a
   16-byte boundary, lengths 1..17; the block offsets, the modern device
   prep, at one block, a tile and one either side, bits 0..65535, all 0,
   all >= 16 at 3,145,728 blocks, a 4K frame, batches of F = 1, 2, 5 and 8
   4K frames, views off a 16-byte boundary, a (1, nblk) batch against the
   single entry, four streams launching at once), <= 1 LSB per channel with alpha 255 for develop
   (both demosaic modes at (16, 128), (36, 250), (3, 64) and (3024, 4032);
   the tiled kernel's edges (37, 251), (65, 130), (3, 101), (5, 7),
   (33, 66); (3072, 4096) in the bench's parameters; all four CFAs at a
   small size; the small ones also against the f64 model; a (3, 5, 250),
   a (2, 3072, 4096) and an (8, 2160, 3840) batch, the grade step's, with
   a 4095 and a 0 frame among its smooth ones, bit-equal to single calls;
   that batch again with a row for each frame and the four CFAs in turn,
   the multiview step's, on the ring and on the direct path, bit-equal to
   single calls with each frame's own row and CFA;
   by the ``develop.ring`` / ``develop.direct`` counters, each case on the
   path its shape gives: the ring where the width is a multiple of 8 and
   the black levels >= 0, else direct); each batched
   unpack (one launch with a frame axis) element-exact against its plain
   batched version and against one launch per frame alone: F = 3 4K
   frames of the decode clips (modern 12-bit, worst case, all-16; legacy
   12-bit, 12-bit, 16-bit), synthetic batches at widths 4000 and 4090
   (modern), 4000 and 33 (legacy), a short encodedHeight, and a frame whose
   offsets are shuffled and point past its own end between two plain ones.
   The digest of every kernel output of this phase is kept.
   checked: the checked build of the kernels (``-DMCRAW_CHECKED``, built
   beside the default one from phase 2 on): in a child process
   (``--checked-child``), every input of phase 3 (the same seeds and
   payloads) and ``mcraw_torch.bounds``' clean cases through the checked
   library, with no fault and each output bit-equal to the default
   library's; every negative case of ``mcraw_torch.bounds`` (a buffer's
   checked extent understated) fires on its buffer and kind, for each
   kernel and each kind of access it makes; a batch frame whose offsets
   point past its own end reads nothing outside its window, and windows
   cut short count their cross-frame reads. One line ``{"checked": ...}``.
4. main paths, each with the launch counters set to 0 just before it and
   read just after:
   - decode, one per codec: a 4096x3072 modern clip (three 12-bit frames,
     a worst-case frame, an all-16-bit frame, audio) and a legacy clip (two
     4096x3072 12-bit frames, a full-range 16-bit frame, a 4032x3024 frame,
     a frame without the trailing chunk table, audio), written with
     mcraw_torch.encode and decoded by
     ``mcraw_torch.Decoder(path, device="cuda").load_frame_device``; every
     frame equals its source image and its device checksum the host's. The
     counters must show one unpack launch of the clip's codec and one
     checksum launch per frame, and no plain-version call. On every main
     path below too, each modern unpack launch (a frame, a batch, a band)
     comes with one block offsets launch and a legacy one with none. The legacy phase
     prints which host scan walked each frame's header chain and whether
     the native scans were built.
   - batched decode: ``decode_batch()`` over the modern clip's five frames
     (one run), ``decode_batch_iter(chunk_frames=2)`` on the modern clip and
     ``(chunk_frames=4)`` on the legacy clip (its 4032x3024 frame splits
     the runs), and ``make_frame_decoder()`` over every frame of both; every
     frame equals its source and its device checksum the host's, one unpack
     launch per run chunk (per frame for the frame decoder), no plain call,
     one frame-decoder program per (codec, geometry).
   - develop: a clip of three 4096x3072 12-bit modern frames and one
     4032x3024 legacy frame (white 4095, black (64, 60, 70, 64), bggr,
     dual-illuminant matrices, a warm neutral) through
     ``mcraw_torch.preview.preview_frame_rgba`` on the card, every frame
     bilinear and two in Malvar; each RGBA within 1 LSB of the f64 model
     of its source image; one develop launch per call, no plain call, no
     height <= 2 develop; ``preview_clip(d, batch_frames=2)`` gives the
     same RGBA (device checksum) as ``preview_frame_rgba`` for every frame,
     with one unpack and one develop launch per run (the legacy frame
     splits them; the develop takes a row for each frame).
   - export: ``mcraw_torch.clip.export_clip(Decoder(clip, device="cuda"),
     prefetch=4, writers=4)`` on each decode clip: every DNG byte-identical
     to ``dng_bytes`` of its source image, one unpack launch of the clip's
     codec per frame, no plain call, ``stage_timing`` with parse, unpack
     and emit (emit once a frame), no Staging laid out by two threads; then
     a small clip with an 8-byte corrupt payload between two good frames:
     one frame failed, with the error text of ``python -m mcraw decode
     --pipeline --backend numpy``, the good frames byte-identical to its.
   - mesh (``mcraw_torch.parallel``): M = (cuda:0,) * 4, four shards on
     the one card, each with its own staging and stream. With the counters
     set to 0 before each path and read after: ``decode_batch(mesh=M)`` and
     ``decode_batch(mesh=default_mesh())`` on the modern clip's frames
     repeated to 8 and the legacy clip's 4096x3072 frames (one unpack
     launch a shard, shard d on its device; a batch of 3 on M raises the
     "not divisible" ValueError); ``decode_batch_iter(chunk_frames=6,
     mesh=M)`` over 11 frames (chunks of 8 and 3, the 3 on the decoder's
     device); ``load_frame_sharded(ts, M)`` on every frame of both clips
     (one launch a band); ``parallel.decode_clips`` of the modern clip and
     a second one (seed 16), four frames each; and the dry run: the develop
     clip's 4K frames repeated to 8 in one batched decode over M, one
     batched develop launch a shard, a cross-shard mean of the RGB, each
     RGBA within 1 LSB of the f64 model. Every frame equals its source and
     its device checksum the host's; no plain call.
   - two processes (``mcraw_torch.distributed``): two copies of this
     script (``--worker``) in a gloo process group on localhost, both on
     cuda:0: ``decode_batch_global_mesh`` of the modern clip's frames
     repeated to 8 (a DTensor over a cuda DeviceMesh, four frames and one
     launch a rank, each frame's device checksum the host's, and an
     all-reduce of the ranks' checksums equal to the host's); then
     ``export_clip_distributed`` of the clip's 5 frames, every DNG
     byte-identical to the single-process ``export_clip``'s.
   - soak (``mcraw_torch.soak``, seed 2026): the codec, mutation and
     malformed legs for 60 s each on the checked build (``--checked``: no
     fault) and the container and json CLI legs for 30 s each, every leg in
     a child process, all at once. Every decode
     path of every iteration gives the plain CPU path's outcome (and the
     source where the payload is format-legal), each result's device
     checksum the host's sum; the CLI legs match ``python -m mcraw ...
     --backend numpy`` byte for byte. One line a leg; a failure, a crash,
     a decode path without an unpack launch or a plain call on the card
     fails the phase. The launches are the legs' own counts, summed.
   - bench (``python -m mcraw_torch.bench --quick``, a child process): the
     legs of ``bench.py`` at their full sizes, 2 distinct frames a leg,
     each gated by its checksum. Exit 0, every key of ``bench.py``'s line
     (``bench.py:956-989``), every leg a positive number, no gate failure,
     no error, every kernel launched and no plain call; the bench's line
     is printed as ``{"phase": "bench", ...}``. The launches are the
     bench's own counts.
5. CLI: per decode clip, ``python -m mcraw_torch clip -n 5``, ``... decode
   clip -n 5`` and ``... decode clip -n 5 --batch --batch-frames 2``
   against ``python -m mcraw clip -n 5 --backend numpy``, the four at
   once: identical stdout, byte-identical audio.wav and DNGs. Against
   ``python -m mcraw ... --backend numpy``, four processes at a time:
   ``info``, ``verify`` and
   ``verify --quick`` on both decode clips and the corrupt clip (identical
   stdout and exit code), ``encode --codec 7`` and ``--codec 6``
   (byte-identical files), and per decode clip ``decode -n 5 --pipeline``
   (the same Found line and multiset of Writing lines, an Exported line,
   byte-identical files) with ``--verbose`` (a stage_timing event with
   parse, unpack and emit on stderr) and with ``--trace-dir`` (the codec's
   unpack kernel once per frame among the trace's device kernels).
   ``python -m mcraw_torch preview <develop clip> -n 2 --demosaic
   malvar``: PPMs within 1 of the f64 model.
6. times on the card (printed, not asserted): CUDA-event medians of each
   kernel and its plain version at the 4K 12-bit frame of its codec (both
   demosaic modes for develop; the block offsets also at F = 2, 5 and 8,
   beside the torch chain they replaced), the ``load_frame_device`` split: host prep
   (the legacy scan also on its own), its one H2D, device prep (modern) and
   kernel, the ``preview_frame_rgba`` split: decode and develop; and for
   ``decode_batch`` of the modern clip's five frames and the legacy clip's
   first three, the wall per frame and its split (host prep, the scans
   alone, H2D, device prep, kernel) beside the same ``decode_batch``
   through a new staging (cold host buffers) and ``load_frame_device`` of
   the same frames in the same turns, the batched launch against F single
   launches (CUDA events), and ``FrameDecoder`` against
   ``load_frame_device`` per frame. Per decode clip, its frames repeated to
   64 (the 8 frames in flight reach steady state), in 2 turns,
   ``export_clip``'s wall and fps beside the sequential decode loop
   (``load_frame`` and ``write_dng`` per frame, over 10 frames), the
   stage_timing split and the count of cold Stagings; then one export
   under ``mcraw_torch.observe.device_trace``: the device busy share (the
   union of kernel, memcpy and memset intervals over the export's wall).
   On M: ``load_frame_sharded`` against ``load_frame_device`` per 4K
   frame of each codec, ``decode_batch(mesh=M)`` against ``decode_batch()``
   per frame (modern, F = 8), and the CUDA-event time of the four band
   launches against one launch of the whole frame (their outputs held
   equal).

The line before last is ``{"kernels": [...]}``: one entry per TPU kernel
of the repo (eight; the routed ones carry the numbers of the CUDA kernel
that computes them) and one for the block offsets (the counterpart of
``_v6_build_meta``'s offsets, plain jnp) with its launches on the main paths, its error, its
times, its bound from this run's bytes and operations, and the time of
one torch call that computes the same function where there is one. The
last line is ``{"ok": true, "device": {...}}``. Needs one card, no network,
no JAX and nothing of mcraw (the CLI phase runs ``python -m mcraw`` as a
separate process to compare with).
"""

from __future__ import annotations

import contextlib
import filecmp
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H, W = 3072, 4096
N_TIMED = 20
L2_FLUSH_BYTES = 256 << 20  # > the H100's 50 MB L2
SPIN_CYCLES = 200_000  # ~0.11 ms at the H100's 1.755 GHz boost clock
# The spin before a timed call of several launches (~2.3 ms): each launch
# takes the host tens of microseconds to enqueue, so a short spin would
# time the host's launch rate, not the card.
MULTI_SPIN_CYCLES = 4_000_000
# H100 SXM data sheet, at the 700 W limit: HBM3 rate, float32 outside the
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# float32 operations per pixel of the develop function (plain version's
# arithmetic): normalize 4; demosaic ~41 bilinear (R and B 16 each, G 9),
# ~40 Malvar; matrix + clip 21; curve + round 27 (a pow counted as 3).
DEVELOP_FP32_OPS_PER_PIXEL = 93


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


if not (ROOT / "mcraw_torch" / "csrc").is_dir() or not (ROOT / "mcraw").is_dir():
    fail(f"run from a checkout of the repository ({ROOT} has no mcraw_torch/)")
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    fail("torch.cuda.is_available() is false: this script needs a CUDA card")
# The plain versions hold no matmul or conv; TF32 stays off all the same.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

import mcraw_torch  # noqa: E402
from mcraw_torch import bench as BENCH  # noqa: E402
from mcraw_torch import bounds as BOUNDS  # noqa: E402
from mcraw_torch import distributed as DIST  # noqa: E402
from mcraw_torch import encode as E  # noqa: E402  (the fixture writer)
from mcraw_torch import observe  # noqa: E402
from mcraw_torch import parallel as PAR  # noqa: E402
from mcraw_torch import preview as P  # noqa: E402
from mcraw_torch.clip import export_clip  # noqa: E402
from mcraw_torch.color import interpolated_matrices  # noqa: E402
from mcraw_torch.emit.dng import dng_bytes, write_dng  # noqa: E402
from mcraw_torch.kernels import build  # noqa: E402
from mcraw_torch.kernels import checksum as C  # noqa: E402
from mcraw_torch.kernels import develop as D  # noqa: E402
from mcraw_torch.kernels import legacy as L  # noqa: E402
from mcraw_torch.kernels import native  # noqa: E402  (the C++ host scans)
from mcraw_torch.kernels import offsets as O  # noqa: E402
from mcraw_torch.kernels import tables as T  # noqa: E402
from mcraw_torch.kernels import unpack as U  # noqa: E402
from mcraw_torch.kernels.staging import Staging, slot_layout  # noqa: E402
from mcraw_torch.kernels.tables import modern_tables  # noqa: E402
from mcraw_torch.metadata import (  # noqa: E402
    CFA_PATTERNS,
    ContainerMetadata,
    FrameMetadata,
    example_container_metadata,
    example_frame_metadata,
)
from mcraw_torch.observe import busy_us, device_events, device_trace  # noqa: E402

DEV = torch.device("cuda", 0)


def host_checksum(a: np.ndarray) -> int:
    return int(a.astype(np.int64).sum() & 0xFFFFFFFF)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# -- phase 1 -------------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    emit(
        "device", torch=torch.__version__, cuda=torch.version.cuda,
        card=card, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
    )
    return card


# -- phase 2 -------------------------------------------------------------------


# The checked build (-DMCRAW_CHECKED) runs beside the default build and the
# kernels phases; the checked phase waits for it.
CHECKED_BUILD: dict = {}


def _checked_build() -> None:
    t0 = time.perf_counter()
    try:
        CHECKED_BUILD["path"] = build.build(checked=True)
    except RuntimeError as e:  # raised again by the checked phase
        CHECKED_BUILD["error"] = e
    CHECKED_BUILD["seconds"] = time.perf_counter() - t0


def phase_build() -> None:
    CHECKED_BUILD["thread"] = threading.Thread(target=_checked_build)
    CHECKED_BUILD["thread"].start()
    t0 = time.perf_counter()
    build.lib()
    secs = time.perf_counter() - t0
    log = build.library_path().with_suffix(".log")
    ptxas = [
        ln.strip() for ln in (log.read_text().splitlines() if log.exists() else [])
        if "registers" in ln or "Compiling entry" in ln
    ]
    emit("build", seconds=secs, library=str(build.library_path().relative_to(ROOT)),
         ptxas=ptxas)


# -- phase 3 -------------------------------------------------------------------


def random_unpack_inputs(rng, ty: int, tx: int):
    """Random payload words, bits 0..65535 (clamped by the decoder) and refs
    0..65535 (uint16 wrap), with offsets from the device prep."""
    nblk = 4 * ty * tx
    bits = rng.integers(0, 1 << 16, size=nblk, dtype=np.uint16)
    refs = rng.integers(0, 1 << 16, size=nblk, dtype=np.uint16)
    lengths = T.MODERN_BLOCK_LENGTH.take(bits, mode="clip")
    size = 16 + int(lengths.sum()) + U.TAIL_BYTES
    size += (-size) % 16
    words = rng.integers(-(1 << 31), 1 << 31, size=size // 4, dtype=np.int64)
    words = words.astype(np.int32)
    w, b, r = (torch.from_numpy(a).to(DEV) for a in (words, bits, refs))
    return w, b, r, U.block_offsets(b, modern_tables(DEV))


def edge_unpack_inputs(rng, ty: int, tx: int, content: str):
    """Unpack inputs whose bits follow `content`: "per_tile" (every block of
    tile i at bits i % 17, so each tile holds one width and all of 0..16
    occur), "all16" (every block 16-bit: the straight copy), "scrambled"
    (random bits, the offsets shuffled: the kernel reads such a run word by
    word from device memory) or "random"."""
    nblk = 4 * ty * tx
    if content == "per_tile":
        bits = (np.arange(nblk) // 4 % 17).astype(np.uint16)
    elif content == "all16":
        bits = rng.integers(11, 17, size=nblk, dtype=np.uint16)
    else:
        bits = rng.integers(0, 17, size=nblk, dtype=np.uint16)
    refs = rng.integers(0, 1 << 16, size=nblk, dtype=np.uint16)
    size = 16 + int(T.MODERN_BLOCK_LENGTH[bits].sum()) + U.TAIL_BYTES
    size += (-size) % 16
    payload = rng.integers(0, 256, size=size, dtype=np.uint8)
    w, b, r = (torch.from_numpy(a).to(DEV) for a in (payload.view("<i4"), bits, refs))
    offs = U.block_offsets(b, modern_tables(DEV))
    if content == "scrambled":
        offs = offs[torch.from_numpy(rng.permutation(nblk)).to(DEV)].contiguous()
    return w, b, r, offs


# (ty, tx, height, width, content): the unpack kernel's edges. 4032: the
# last tile column cropped away; 4000: a tile crosses the crop (W % 64 !=
# 0); 4036, 4090: W % 8 != 0, masked stores; 40 of 50 rows encoded (a
# short encodedHeight: the rest stay zero); every tile one width 0..16.
UNPACK_EDGES = (
    (768, 64, H, 4032, "per_tile"),
    (768, 63, H, 4000, "random"),
    (768, 64, H, 4036, "per_tile"),
    (768, 64, H, 4090, "random"),
    (10, 8, 50, 512, "random"),
    (768, 64, H, W, "per_tile"),
    (7, 5, 28, 300, "all16"),
    (9, 4, 36, 256, "scrambled"),
)


def random_legacy_inputs(rng, h: int, w: int, content: str):
    """Random payload bytes on a synthetic header chain: bits 0..16 (every
    value among the first 17 blocks), offsets the cumulative sum of 2 + the
    block length, just past each header. `content`: "chain" (refs
    0..4095), "wrap" (refs 0..65535: value + ref wraps), "shuffled" (the
    offsets permuted: bounded reads from device memory), "near_end" (the
    last nine blocks start from 4 bytes before to 4 bytes past the end of
    the payload: bounded reads again), "no_tail" (no zero tail: the staged
    copy zero-fills past the payload)."""
    nblk = L.num_blocks(w, h)
    bits = rng.integers(0, 17, size=nblk).astype(np.int32)
    bits[:17] = np.arange(17)
    refs = rng.integers(0, 1 << 16 if content == "wrap" else 4096,
                        size=nblk).astype(np.uint16)
    step = 2 + T.LEGACY_BLOCK_LENGTH[bits].astype(np.int64)
    offsets = np.cumsum(step) - step + 2
    tail = 0 if content == "no_tail" else 1 + L.TAIL_BYTES
    payload = rng.integers(0, 256, size=int(step.sum()) + tail, dtype=np.uint8)
    if content == "shuffled":
        offsets = offsets[rng.permutation(nblk)]
    elif content == "near_end":
        offsets[-9:] = len(payload) + np.arange(-4, 5)
    return [torch.from_numpy(a).to(DEV) for a in (payload, bits, refs, offsets)]


# (height, width, content): the legacy kernel's cases. 4000: runs of pairs
# cross rows (125 pairs a row); 4036, 4090, 33, 1: W % 8 != 0, masked
# stores.
LEGACY_CASES = (
    (8, 96, "chain"), (5, 50, "chain"), (24, 1000, "chain"), (3024, 4032, "chain"),
    (H, W, "chain"), (H, 4000, "wrap"), (64, 4036, "wrap"), (64, 4090, "wrap"),
    (50, 33, "wrap"), (70, 1, "wrap"), (40, 256, "shuffled"), (H, W, "shuffled"),
    (16, 96, "near_end"), (24, 1000, "near_end"), (24, 1000, "no_tail"),
    (3, 4090, "no_tail"),
)


def phase_kernels(rng) -> dict:
    errs = {"unpack_modern": 0, "unpack_legacy": 0, "checksum": 0}
    # (ty, tx, height, width): exact, cropped + ragged, short rows, 4K.
    for ty, tx, h, w in ((3, 2, 12, 128), (25, 7, 99, 420), (3, 2, 20, 100),
                         (768, 64, H, W)):
        words, bits, refs, offs = random_unpack_inputs(rng, ty, tx)
        kw = dict(ty=ty, tx=tx, height=h, width=w)
        got = U.decode_modern_device(words, bits, refs, offs, **kw)
        want = U.decode_modern_plain(words, bits, refs, offs, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs["unpack_modern"] = max(errs["unpack_modern"], err)
        check(got.shape == (h, w) and err == 0,
              f"unpack kernel != plain at ty={ty} tx={tx} ({h}x{w}): err {err}")
        emit("kernels", kernel="unpack_modern", ty=ty, tx=tx, height=h,
             width=w, max_abs_err=err)
    for ty, tx, h, w, content in UNPACK_EDGES:
        words, bits, refs, offs = edge_unpack_inputs(rng, ty, tx, content)
        kw = dict(ty=ty, tx=tx, height=h, width=w)
        got = U.decode_modern_device(words, bits, refs, offs, **kw)
        want = U.decode_modern_plain(words, bits, refs, offs, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs["unpack_modern"] = max(errs["unpack_modern"], err)
        check(got.shape == (h, w) and err == 0,
              f"unpack kernel != plain at edge ty={ty} tx={tx} ({h}x{w}) {content}: "
              f"err {err}")
        emit("kernels", kernel="unpack_modern", case="edge", content=content, ty=ty,
             tx=tx, height=h, width=w, max_abs_err=err)
    for h, w, content in LEGACY_CASES:
        args = random_legacy_inputs(rng, h, w, content)
        got = L.decode_legacy_device(*args, height=h, width=w)
        want = L.decode_legacy_plain(*args, height=h, width=w)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs["unpack_legacy"] = max(errs["unpack_legacy"], err)
        check(got.shape == (h, w) and err == 0,
              f"legacy unpack kernel != plain at {h}x{w} {content}: err {err}")
        emit("kernels", kernel="unpack_legacy", height=h, width=w, content=content,
             blocks=L.num_blocks(w, h), max_abs_err=err)
    # (shape, dtype, lo, start): x.view(-1)[start:] viewed as `shape`;
    # starts off a 16-byte boundary, lengths 1..17 from every start, one
    # 16-byte multiple.
    cases = [
        ((1, 1), np.uint16, 0, 0), ((7, 13), np.uint16, 0, 0), ((H, W), np.uint16, 0, 0),
        ((2 * H, W), np.uint32, 0, 0), ((1000, 1000), np.uint32, (1 << 32) - 4096, 0),
        ((H, W), np.uint16, 0, 1), ((1000, 1000), np.uint32, (1 << 32) - 4096, 3),
        ((4096,), np.uint16, 0, 0),
        *(((n,), np.uint16, 0, n % 8) for n in range(1, 18)),
        *(((n,), np.uint32, 0, n % 4) for n in range(1, 18)),
    ]
    for shape, dtype, lo, start in cases:
        hi = 1 << (8 * np.dtype(dtype).itemsize)
        a = rng.integers(lo, hi, size=start + int(np.prod(shape)), dtype=np.uint64)
        a = a.astype(dtype)
        x = torch.from_numpy(a).to(DEV)[start:].view(shape)
        got = int(C.device_checksum(x).item())
        want = int(C.checksum_plain(x).item())
        ref = host_checksum(a[start:])
        err = abs(got - want)
        errs["checksum"] = max(errs["checksum"], err, abs(got - ref))
        check(got == want == ref,
              f"checksum {np.dtype(dtype).name}{shape} from {start}: kernel {got} "
              f"plain {want} host {ref}")
        emit("kernels", kernel="checksum", dtype=np.dtype(dtype).name, shape=list(shape),
             start=start, max_abs_err=err)
    errs["block_offsets"] = phase_kernels_offsets(rng)
    errs["develop"] = phase_kernels_develop(rng)
    return errs


NBLK_4K = 4 * (H // 4) * (W // 64)  # 196,608 blocks of 64 values
# (shape, bits drawn from [lo, hi)): the block offsets' edges. One block;
# one below, at and one above a tile; 0..65535 where the clamp matters; all
# 0 (every offset 16); all >= 16 at 3,145,728 blocks (the largest sums,
# ~4e8); a 4K frame; batches of 4K frames (F = 1 also against the single
# entry, below).
OFFSETS_CASES = (
    ((1,), 0, 1 << 16), ((O.TILE - 1,), 0, 1 << 16), ((O.TILE,), 0, 1 << 16),
    ((O.TILE + 1,), 0, 1 << 16), ((3 * O.TILE + 5,), 0, 1), ((3_145_728,), 16, 1 << 16),
    ((NBLK_4K,), 0, 1 << 16), ((1, NBLK_4K), 0, 17), ((2, NBLK_4K), 0, 1 << 16),
    ((5, NBLK_4K), 0, 17), ((8, NBLK_4K), 16, 1 << 16), ((3, O.TILE + 1), 0, 1 << 16),
)


def phase_kernels_offsets(rng) -> int:
    """The block offsets kernel against its plain version on the card,
    element for element: OFFSETS_CASES; views off a 16-byte boundary; a
    (1, nblk) batch against the single entry on its row 0 (the view
    parallel.decode_frame_sharded passes); four streams, each launching a
    batch at once. The max error."""
    err = 0

    def held(bits, what: str) -> torch.Tensor:
        nonlocal err
        launches = O.KERNEL_LAUNCHES
        got = O.block_offsets_device(bits)
        torch.cuda.synchronize()
        check(O.KERNEL_LAUNCHES == launches + 1, f"block offsets {what}: launches")
        want = O.block_offsets_plain(bits)
        e = max_abs_err(got, want)
        err = max(err, e)
        check(got.shape == bits.shape and got.dtype == torch.int64 and e == 0,
              f"block offsets {what}: {got.dtype} {tuple(got.shape)}, err {e}")
        emit("kernels", kernel="block_offsets", case=what, shape=list(bits.shape),
             last=int(got.reshape(-1)[-1]), max_abs_err=e)
        return got

    for shape, lo, hi in OFFSETS_CASES:
        bits = put(rng.integers(lo, hi, size=shape, dtype=np.uint16))
        got = held(bits, f"[{lo}, {hi})")
        check(hi != 1 or bool((got == 16).all()), "block offsets of zero bits != 16")
    x = put(rng.integers(0, 1 << 16, size=(1, 9000), dtype=np.uint16))
    held(x.view(-1)[1:], "view from element 1")
    held(x.view(-1)[3:8196], "view from element 3")
    row = held(x[0], "row 0 of a (1, nblk) batch")
    check(torch.equal(held(x, "(1, nblk) batch")[0], row), "block offsets: F = 1 != single")
    inputs = [put(rng.integers(0, 1 << 16, size=(3, NBLK_4K), dtype=np.uint16))
              for _ in range(4)]
    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()
    outs = []
    for s, bits in zip(streams, inputs):
        with torch.cuda.stream(s):
            torch.cuda._sleep(SPIN_CYCLES)  # the four launches overlap
            outs.append(O.block_offsets_device(bits))
    torch.cuda.synchronize()
    for i, (bits, got) in enumerate(zip(inputs, outs)):
        e = max_abs_err(got, O.block_offsets_plain(bits))
        err = max(err, e)
        check(e == 0, f"block offsets on stream {i} of 4: err {e}")
    emit("kernels", kernel="block_offsets", case="four streams at once",
         shape=[3, NBLK_4K], max_abs_err=0)
    return err


def slots(arrays):
    """Concatenate per-frame buffers (each a multiple of 16 bytes) into one
    uint8 buffer: (buffer, (F,) starts in bytes, (F,) sizes in bytes), the
    layout of the batched host prep."""
    sizes = np.array([a.nbytes for a in arrays], np.int64)
    check(not (sizes % 16).any(), "slots must be 16-byte multiples")
    starts, _ = slot_layout(sizes)
    return np.concatenate([a.reshape(-1).view(np.uint8) for a in arrays]), starts, sizes


def put(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(DEV)


def synthetic_modern_batch(rng, ty: int, tx: int, contents, past_end=None):
    """Per-frame edge_unpack_inputs for each of `contents` and their batch;
    frame `past_end` also gets its last three blocks pointed at and past
    the end of its own slot (it must read zeros there, not its
    neighbour's words)."""
    frames = [edge_unpack_inputs(rng, ty, tx, c) for c in contents]
    if past_end is not None:
        n = 4 * frames[past_end][0].numel()
        frames[past_end][3][-3:] = torch.tensor([n - 4, n, n + 64], device=DEV)
    buf, starts, sizes = slots([f[0].cpu().numpy() for f in frames])
    batch = (put(buf.view("<i4")), put(starts // 4), put(sizes // 4),
             *(torch.stack([f[k] for f in frames]) for k in (1, 2, 3)))
    return frames, batch


def encoded_modern_batch(payloads, h: int, w: int):
    """The batched host prep, upload and device prep of encoded payloads,
    and each frame's own inputs (its own slot of the buffer)."""
    dev = U.stage_modern_batch(Staging(DEV), payloads, w, h)
    offs = U.block_offsets(dev.bits, modern_tables(DEV))
    batch = (dev.words, dev.bases, dev.lengths, dev.bits, dev.refs, offs)
    frames = [(dev.words[lo : lo + n], dev.bits[f], dev.refs[f], offs[f])
              for f, (lo, n) in enumerate(zip(dev.bases.tolist(), dev.lengths.tolist()))]
    return frames, batch, dict(ty=dev.tiles_y, tx=dev.tiles_x, height=h, width=w)


def synthetic_legacy_batch(rng, h: int, w: int, contents):
    frames = [random_legacy_inputs(rng, h, w, c) for c in contents]
    pads = [np.concatenate([f[0].cpu().numpy(), np.zeros((-f[0].numel()) % 16, np.uint8)])
            for f in frames]
    buf, starts, _ = slots(pads)
    lengths = np.array([f[0].numel() for f in frames], np.int64)
    batch = (put(buf), put(starts), put(lengths),
             *(torch.stack([f[k] for f in frames]) for k in (1, 2, 3)))
    return frames, batch


def encoded_legacy_batch(payloads, h: int, w: int):
    dev = L.stage_legacy_batch(Staging(DEV), payloads, w, h)
    frames = [(dev.payload[lo : lo + n], dev.bits[f], dev.refs[f], dev.offsets[f])
              for f, (lo, n) in enumerate(zip(dev.bases.tolist(), dev.lengths.tolist()))]
    return frames, tuple(dev), dict(height=h, width=w)


def batch_check(name: str, batched, plain, single, frames, batch, kw, what: str) -> int:
    """One batched launch against its plain batched version and against a
    launch per frame of its own inputs alone (`single`, its batch of one),
    element for element; the max error."""
    launches = COUNTED[name].KERNEL_LAUNCHES
    got = batched(*batch, **kw)
    torch.cuda.synchronize()
    check(COUNTED[name].KERNEL_LAUNCHES == launches + 1, f"{name} batch {what}: launches")
    want = plain(*batch, **kw)
    singles = torch.stack([single(*f, **kw) for f in frames])
    torch.cuda.synchronize()
    err = max(max_abs_err(got, want), max_abs_err(got, singles))
    check(got.shape == (len(frames), kw["height"], kw["width"]) and err == 0,
          f"{name} batch {what}: {tuple(got.shape)}, err {err} against plain / singles")
    emit("kernels", kernel=name, case="batch", what=what, frames=len(frames),
         height=kw["height"], width=kw["width"], max_abs_err=err,
         equals_plain=True, equals_single_calls=True)
    return err


def phase_kernels_batch(rng, payloads, lpayloads) -> dict:
    """Each batched unpack (one launch with a frame axis) against its plain
    batched version and against a launch per frame alone: F = 3 4K
    frames of the decode clips (modern: 12-bit, worst case, all-16; legacy:
    12-bit, 12-bit, 16-bit), synthetic batches at widths 4000 and 4090
    (modern) or 4000 and 33 (legacy), a short encodedHeight, and a frame
    whose offsets are shuffled and point past its own end, between two
    plain ones."""
    errs = {"unpack_modern": 0, "unpack_legacy": 0}
    modern = (U.decode_modern_batch_device, U.decode_modern_batch_plain,
              U.decode_modern_device)
    legacy = (L.decode_legacy_batch_device, L.decode_legacy_batch_plain,
              L.decode_legacy_device)
    cases = [("unpack_modern", modern, "4K 12-bit, worst, all-16",
              lambda: encoded_modern_batch([payloads[i] for i in (0, 3, 4)], H, W))]
    for ty, tx, h, w, contents, past_end, what in (
        (768, 63, H, 4000, ("random",) * 3, None, "W 4000"),
        (768, 64, H, 4090, ("per_tile", "random", "all16"), None, "W 4090"),
        (10, 8, 50, 512, ("random", "all16", "random"), None, "short encodedHeight"),
        (9, 4, 36, 256, ("random", "scrambled", "random"), 1, "shuffled + past its end"),
    ):
        cases.append(("unpack_modern", modern, what, lambda ty=ty, tx=tx, h=h, w=w,
                      c=contents, p=past_end: (*synthetic_modern_batch(rng, ty, tx, c, p),
                                               dict(ty=ty, tx=tx, height=h, width=w))))
    cases.append(("unpack_legacy", legacy, "4K 12-bit, 12-bit, 16-bit",
                  lambda: encoded_legacy_batch(lpayloads[:3], H, W)))
    for h, w, contents, what in (
        (H, 4000, ("wrap", "chain", "wrap"), "W 4000"),
        (50, 33, ("wrap", "chain", "wrap"), "W 33"),
        (24, 1000, ("chain", "shuffled", "chain"), "shuffled"),
        (16, 96, ("chain", "near_end", "no_tail"), "past its end, no tail"),
    ):
        cases.append(("unpack_legacy", legacy, what, lambda h=h, w=w, c=contents: (
            *synthetic_legacy_batch(rng, h, w, c), dict(height=h, width=w))))
    for name, fns, what, make in cases:
        frames, batch, kw = make()
        errs[name] = max(errs[name], batch_check(name, *fns, frames, batch, kw, what))
        del frames, batch
    return errs


# Develop parameters: the CPU tests' (black, white, neutral, forward matrix)
# and the bench's (bench.py:465-470).
DEVELOP_ARGS = (
    np.array([64, 60, 70, 64], np.float32), 4095.0,
    np.array([0.61, 1.0, 0.72], np.float32),
    np.array([[0.86, 0.08, 0.02], [0.04, 0.91, 0.05], [0.01, 0.06, 0.76]],
             np.float32),
)
BENCH_DEVELOP_ARGS = (
    np.zeros(4, np.float32), 4095.0, np.ones(3, np.float32),
    np.diag([0.9642, 1.0, 0.8249]).astype(np.float32),
)
MODES = ("bilinear", "malvar")
RGGB = tuple(CFA_PATTERNS["rggb"])
F64_MAX_PIXELS = 1 << 16  # the kernels phase holds shapes up to this to the model


def rgba_channels(rgba: torch.Tensor, what: str) -> torch.Tensor:
    """(..., 3) int16 channels of uint32 RGBA8888, on rgba's device; fails
    unless every alpha is 255."""
    a = rgba.to(torch.int64)
    check(bool(((a >> 24) == 0xFF).all()), f"{what}: alpha != 255")
    return torch.stack([(a >> s) & 0xFF for s in (0, 8, 16)], -1).to(torch.int16)


def channel_diff(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """(max |a - b|, count of channels that differ) of two channel tensors."""
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return int(d.max().item()), int((d != 0).sum().item())


def develop_path(x: torch.Tensor, params, **kw) -> tuple[torch.Tensor, str]:
    """One develop launch and the path it took ("ring" or "direct"), by
    the ``develop.ring`` / ``develop.direct`` counters."""
    with observe.tracing() as rec:
        out = D.develop_rgba_device(x, params, **kw)
    paths = {k: v for k, v in rec.counters.items() if k.startswith("develop.")}
    check(len(paths) == 1 and sum(paths.values()) == 1, f"develop path counters {paths}")
    return out, next(iter(paths)).removeprefix("develop.")


def develop_check(raw: np.ndarray, args, cfa, demosaic: str, what: str, path: str) -> int:
    """The develop kernel against its plain version on the card (and the
    f64 model at small shapes), <= 1 LSB per channel, on `path`; the max
    error against the plain version."""
    x = torch.from_numpy(raw).to(DEV)
    params = D.pack_develop_params(*args)
    got, took = develop_path(x, params, cfa=cfa, demosaic=demosaic)
    check(took == path, f"develop {what} {tuple(raw.shape)}: the {took} path, not {path}")
    want = D.develop_rgba_plain(x, params, cfa=cfa, demosaic=demosaic)
    torch.cuda.synchronize()
    check(got.shape == raw.shape and got.dtype == torch.uint32,
          f"develop {what}: {got.dtype} {tuple(got.shape)}")
    g = rgba_channels(got, f"develop {what}")
    err, ndiff = channel_diff(g, rgba_channels(want, f"develop plain {what}"))
    row = dict(kernel="develop", case=what, shape=list(raw.shape), cfa=list(cfa),
               demosaic=demosaic, path=took, max_abs_err=err, channels_differ=ndiff)
    if raw.size <= F64_MAX_PIXELS:
        frames = raw.reshape(-1, *raw.shape[-2:])
        model = torch.from_numpy(np.stack(
            [P.develop_f64(f, *args, cfa, demosaic=demosaic) for f in frames]
        ).reshape(*raw.shape, 3))
        row["f64_err"], row["f64_channels_differ"] = channel_diff(g.cpu(), model)
        check(row["f64_err"] <= 1, f"develop {what} {demosaic}: {row['f64_err']} from f64")
    check(err <= 1, f"develop kernel vs plain {what} {demosaic}: err {err}")
    emit("kernels", **row)
    return err


def develop_singles_check(x: torch.Tensor, params, cfa, demosaic: str, what: str,
                          path: str) -> None:
    """A batch in one launch bit-equal to one launch a frame, every launch
    on `path`."""
    batched, took = develop_path(x, params, cfa=cfa, demosaic=demosaic)
    singles = [develop_path(f, params, cfa=cfa, demosaic=demosaic) for f in x]
    torch.cuda.synchronize()
    paths = {took} | {p for _, p in singles}
    check(paths == {path}, f"develop {what} {demosaic}: paths {paths}, not {path}")
    check(torch.equal(batched.to(torch.int64),
                      torch.stack([o for o, _ in singles]).to(torch.int64)),
          f"develop {what} {demosaic} != single calls")
    emit("kernels", kernel="develop", case=what, shape=list(x.shape), demosaic=demosaic,
         path=path, equals_single_calls=True)


def uhd_batch(rng) -> np.ndarray:
    """The grade step's (8, 2160, 3840): smooth 12-bit frames with an all-4095
    frame after the first and an all-0 frame after the third. 2160 rows are
    not a multiple of the 32-row tile, so the last tiles' boxes reach past
    each frame's bottom: a row of the next frame read there would show."""
    frames = [twelve_bit(rng, k, 2160, 3840) for k in range(8)]
    frames[1][:] = 4095
    frames[3][:] = 0
    return np.stack(frames)


def frame_rows(frames: int) -> tuple[np.ndarray, np.ndarray]:
    """(frames, 128) rows and (frames, 4) CFAs of a multiview step: frame
    f's black levels DEVELOP_ARGS's plus f, its own neutral and forward
    matrix, the four Bayer patterns in turn."""
    black, white, neutral, fwd = DEVELOP_ARGS
    rows = np.concatenate([D.pack_develop_params(
        black + f, white, neutral * np.float32(1 + 0.03 * f),
        fwd * np.float32(1 - 0.02 * f)) for f in range(frames)])
    return rows, np.array([D.BAYER_CFAS[f % 4] for f in range(frames)], np.int32)


def develop_rows_check(raw: np.ndarray, demosaic: str, what: str) -> int:
    """A batch with a row and a CFA for each frame in one launch, on the
    ring and (a copy 2 bytes off alignment) on the direct path: both bit
    for bit one launch a frame with its own row and CFA, within 1 LSB of the
    plain version frame by frame; the max error against it."""
    x = torch.from_numpy(raw).to(DEV)
    rows, cfas = frame_rows(len(raw))
    rows_d, cfas_d = torch.from_numpy(rows).to(DEV), torch.from_numpy(cfas).to(DEV)
    buf = torch.empty(x.numel() + 1, dtype=torch.uint16, device=DEV)
    off = buf[1:].view(x.shape)
    off.copy_(x)
    singles = torch.stack([D.develop_rgba_device(x[f], rows[f], cfa=tuple(cfas[f]),
                                                 demosaic=demosaic) for f in range(len(raw))])
    err = 0
    for src, path in ((x, "ring"), (off, "direct")):
        with observe.tracing() as rec:
            got = D.develop_rgba_device(src, rows_d, cfa=cfas_d, demosaic=demosaic)
        counters = {k: v for k, v in rec.counters.items() if k.startswith("develop.")}
        check(counters == {f"develop.{path}": 1, "develop.frame_rows": len(raw)},
              f"develop {what} {demosaic}: counters {counters}")
        check(torch.equal(got.to(torch.int64), singles.to(torch.int64)),
              f"develop {what} {demosaic} ({path}) != single calls")
    g = rgba_channels(got, f"develop {what}")
    for f in range(len(raw)):
        plain = D.develop_rgba_plain(x[f], rows[f], cfa=tuple(cfas[f]), demosaic=demosaic)
        e, _ = channel_diff(g[f], rgba_channels(plain, f"develop plain {what}"))
        err = max(err, e)
    torch.cuda.synchronize()
    check(err <= 1, f"develop {what} {demosaic} vs plain: err {err}")
    emit("kernels", kernel="develop", case=what, shape=list(raw.shape), demosaic=demosaic,
         cfas=cfas.tolist(), paths=["ring", "direct"], equals_single_calls=True,
         max_abs_err=err)
    return err


def phase_kernels_develop(rng) -> int:
    err = 0
    bggr = tuple(CFA_PATTERNS["bggr"])
    uhd = uhd_batch(rng)
    for demosaic in MODES:
        for h, w, path in ((16, 128, "ring"), (36, 250, "direct"), (3, 64, "ring"),
                           (3024, 4032, "ring")):
            raw = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
            err = max(err, develop_check(raw, DEVELOP_ARGS, bggr, demosaic, "test", path))
        # Edges of the tiled kernel: odd W and H, W % 4 != 0 (masked
        # stores), H = 3, tiles cut on both axes; no width a multiple of 8.
        for h, w in ((37, 251), (65, 130), (3, 101), (5, 7), (33, 66)):
            raw = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
            err = max(err, develop_check(raw, DEVELOP_ARGS, bggr, demosaic, "edge", "direct"))
        # A (3, 5, 250) batch: frames 1250 pixels apart, so not 16-byte
        # aligned; bit-equal to three single calls, <= 1 of plain and f64.
        small = rng.integers(0, 4096, size=(3, 5, 250), dtype=np.uint16)
        err = max(err, develop_check(small, DEVELOP_ARGS, bggr, demosaic, "batch", "direct"))
        develop_singles_check(torch.from_numpy(small).to(DEV),
                              D.pack_develop_params(*DEVELOP_ARGS), bggr, demosaic,
                              "(3, 5, 250) batch", "direct")
        err = max(err, develop_check(twelve_bit(rng, 0), BENCH_DEVELOP_ARGS, RGGB,
                                     demosaic, "bench", "ring"))
        for sensor, cfa in CFA_PATTERNS.items():
            raw = rng.integers(0, 4096, size=(20, 50), dtype=np.uint16)
            err = max(err, develop_check(raw, DEVELOP_ARGS, tuple(cfa), demosaic,
                                         f"cfa {sensor}", "direct"))
        # Two frames in one launch against two single calls, bit for bit.
        x = torch.from_numpy(np.stack([twelve_bit(rng, k) for k in (1, 2)])).to(DEV)
        develop_singles_check(x, D.pack_develop_params(*BENCH_DEVELOP_ARGS), RGGB, demosaic,
                              "batched", "ring")
        # The grade step's batch, against plain and against single calls.
        err = max(err, develop_check(uhd, DEVELOP_ARGS, bggr, demosaic, "grade batch", "ring"))
        develop_singles_check(torch.from_numpy(uhd).to(DEV),
                              D.pack_develop_params(*DEVELOP_ARGS), bggr, demosaic,
                              "grade batch", "ring")
        # The multiview step: eight rows and the four CFAs in one launch.
        err = max(err, develop_rows_check(uhd, demosaic, "multiview batch"))
    return err


# -- the checked phase ------------------------------------------------------------

# The launch wrappers whose outputs the checked phase holds bit-equal.
RECORDED = ((U, "decode_modern_device"), (U, "decode_modern_batch_device"),
            (L, "decode_legacy_device"), (L, "decode_legacy_batch_device"),
            (D, "develop_rgba_device"), (C, "device_checksum"), (O, "block_offsets_device"))


@contextlib.contextmanager
def recording():
    """Within the block, the digest of every launch wrapper's output, in
    call order."""
    digests = []
    saved = [(mod, name, getattr(mod, name)) for mod, name in RECORDED]

    def wrap(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            digests.append(f"{name} {BOUNDS.digest(out)}")
            return out
        return call

    for mod, name, fn in saved:
        setattr(mod, name, wrap(name, fn))
    try:
        yield digests
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def checked_child(work: str) -> int:
    """``chip_smoke.py --checked-child WORK``: the kernels phases' inputs
    (the same seeds, the decode clips' payloads saved in WORK) and
    ``mcraw_torch.bounds``' clean cases on the checked build, then its
    negative cases and batch windows; one JSON line."""
    path = build.use_checked()
    z = np.load(Path(work) / "checked_payloads.npz")
    payloads, lpayloads = ([z[f"{k}{i}"] for i in range(n)] for k, n in
                           (("m", int(z["modern"])), ("l", int(z["legacy"]))))
    with contextlib.redirect_stdout(sys.stderr):  # the phases' own lines
        with recording() as digests:
            phase_kernels(np.random.default_rng(2024))
        with recording() as batch_digests:
            phase_kernels_batch(np.random.default_rng(2025), payloads, lpayloads)
    bounds_clean = {name: BOUNDS.digest(fn()) for name, _, fn in BOUNDS.clean_cases(DEV)}
    clean = BOUNDS.counts()
    negative, fired, problems = BOUNDS.negative(DEV)
    windows, more = BOUNDS.windows(DEV)
    print(json.dumps({"library": path.name, "digests": digests + batch_digests,
                      "bounds_clean": bounds_clean, **clean, "fired": fired,
                      "negative": negative, "windows": windows,
                      "problems": problems + more}), flush=True)
    return 0


def phase_checked(work: Path, digests: list, payloads, lpayloads) -> dict:
    """The checked build (every global load and store, cp.async and shared
    index of the four kernels held to its buffer's extent) in a child
    process: every input of the kernels phases and mcraw_torch.bounds'
    clean cases with no fault, each output bit-equal to the default
    library's here; every negative case fires on its buffer and kind; a
    batch frame past its own end reads nothing outside its window, and cut
    windows count their cross-frame reads."""
    t0 = time.perf_counter()
    CHECKED_BUILD["thread"].join()
    if "error" in CHECKED_BUILD:
        raise CHECKED_BUILD["error"]
    np.savez(work / "checked_payloads.npz", modern=len(payloads), legacy=len(lpayloads),
             **{f"m{i}": p for i, p in enumerate(payloads)},
             **{f"l{i}": p for i, p in enumerate(lpayloads)})
    want_bounds = {name: BOUNDS.digest(fn()) for name, _, fn in BOUNDS.clean_cases(DEV)}
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--checked-child",
                           str(work)], cwd=ROOT, capture_output=True, text=True, timeout=900)
    child_s = time.perf_counter() - t1
    check(proc.returncode == 0 and proc.stdout.strip(),
          f"checked child exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    got = res["digests"]
    check(len(got) == len(digests), f"checked: {len(got)} outputs, default {len(digests)}")
    differ = [(i, a, b) for i, (a, b) in enumerate(zip(got, digests)) if a != b]
    check(not differ, f"checked outputs differ from the default library's: {differ[:5]}")
    check(res["bounds_clean"] == want_bounds,
          f"checked bounds cases differ: {res['bounds_clean']} vs {want_bounds}")
    faults = sum(res["faults"].values())
    check(faults == 0, f"checked: faults on clean inputs {res['faults']}")
    check(not res["problems"], f"checked: {res['problems']}")
    kinds = {}
    for kernel, kind, _, _ in BOUNDS.NEGATIVE:
        kinds.setdefault(kernel, []).append(kind)
    check(res["fired"] == kinds, f"checked: fired {res['fired']}, want {kinds}")
    check(all(res["launches"].get(k, 0) > 0 for k in build.KERNELS),
          f"checked launches {res['launches']}")
    line = {"library": res["library"], "launches": res["launches"], "faults": faults,
            "fired": res["fired"], "cross_frame_reads": res["cross_frame_reads"],
            "outputs_bit_equal": len(got) + len(want_bounds), "windows": res["windows"],
            "build_s": CHECKED_BUILD["seconds"], "child_s": child_s,
            "phase_s": time.perf_counter() - t0}
    print(json.dumps({"checked": line}), flush=True)
    return line


# -- phase 4 -------------------------------------------------------------------


def twelve_bit(rng, k: int, h: int = H, w: int = W) -> np.ndarray:
    """The bench's 12-bit content: a smooth field plus noise."""
    base = (
        np.sin(np.arange(w) / (97 + k))[None, :]
        * np.cos(np.arange(h) / (61 + k))[:, None] * 1200 + 2000
    )
    return (base + rng.normal(0, 30, size=(h, w))).clip(0, 4095).astype(np.uint16)


def make_clip(path: Path):
    """Three 12-bit frames (the bench's recipe), a worst-case frame
    (full-range noise + one 5-bit tile) and an all-16-bit frame."""
    rng = np.random.default_rng(11)
    imgs = [twelve_bit(rng, k) for k in range(3)]
    worst = rng.integers(0, 1 << 16, size=(H, W), dtype=np.uint16)
    worst[0:4, 0:64] = rng.integers(0, 32, size=(4, 64), dtype=np.uint16)
    imgs.append(worst)
    imgs.append(rng.integers(0, 1 << 16, size=(H, W), dtype=np.uint16))

    writer = E.ContainerWriter(example_container_metadata())
    payloads = []
    for i, img in enumerate(imgs):
        payload = E.encode_modern(img)
        payloads.append(np.frombuffer(payload, dtype=np.uint8))
        writer.add_frame(1000 + 33 * i, payload, example_frame_metadata(W, H, 7))
        writer.add_audio(
            rng.integers(-3000, 3000, size=2048).astype(np.int16), i * 10**6
        )
    path.write_bytes(writer.finish())
    return imgs, payloads


LEGACY_FRAMES = (  # (what, height, width, trailing chunk table)
    ("12-bit", H, W, True),
    ("12-bit", H, W, True),
    ("16-bit", H, W, True),
    ("12-bit", 3024, 4032, True),
    ("12-bit", H, W, False),
)


def make_legacy_clip(path: Path):
    """The legacy clip of LEGACY_FRAMES, 12-bit frames in the bench's
    recipe, the 16-bit one full-range noise."""
    rng = np.random.default_rng(12)
    writer = E.ContainerWriter(example_container_metadata())
    imgs, payloads = [], []
    for i, (what, h, w, table) in enumerate(LEGACY_FRAMES):
        if what == "16-bit":
            img = rng.integers(0, 1 << 16, size=(h, w), dtype=np.uint16)
        else:
            img = twelve_bit(rng, i, h, w)
        payload = E.encode_legacy(img, add_offset_table=table)
        imgs.append(img)
        payloads.append(np.frombuffer(payload, dtype=np.uint8))
        writer.add_frame(2000 + 33 * i, payload, example_frame_metadata(w, h, 6))
        writer.add_audio(
            rng.integers(-3000, 3000, size=2048).astype(np.int16), i * 10**6
        )
    path.write_bytes(writer.finish())
    return imgs, payloads


COUNTED = {"unpack_modern": U, "unpack_legacy": L, "checksum": C, "develop": D,
           "block_offsets": O}


def unpacks(kernel: str, n: int) -> dict:
    """The launches of n unpacks (frames, batches or bands) of `kernel`'s
    codec: a modern one launches the block offsets once before each."""
    return {kernel: n} | ({"block_offsets": n} if kernel == "unpack_modern" else {})


def reset_counters() -> None:
    for mod in COUNTED.values():
        mod.KERNEL_LAUNCHES = mod.PLAIN_CALLS = 0


def phase_main_path(name: str, clip: Path, imgs, kernel: str) -> dict:
    """Decode every frame of `clip` on the card; `kernel` is the unpack
    kernel its codec must go through, once per frame."""
    with mcraw_torch.Decoder(str(clip), device="cuda") as d:
        check(len(d.frames) == len(imgs), f"{len(d.frames)} frames in {name}")
        reset_counters()
        t0 = time.perf_counter()
        outs = []
        for ts in d.frames:
            img, meta = d.load_frame_device(ts)
            outs.append((img, C.device_checksum(img), meta))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: mod.KERNEL_LAUNCHES for k, mod in COUNTED.items()}
        plain = {k: mod.PLAIN_CALLS for k, mod in COUNTED.items()}
    n = len(imgs)
    for i, ((img, cs, meta), src) in enumerate(zip(outs, imgs)):
        check(img.device.type == "cuda" and img.dtype == torch.uint16
              and img.shape == src.shape,
              f"{name} frame {i}: {img.dtype} {tuple(img.shape)}")
        check(np.array_equal(img.cpu().numpy(), src),
              f"{name} frame {i} != source image")
        check(int(cs.item()) == host_checksum(src),
              f"{name} frame {i}: checksum mismatch")
    want = {k: 0 for k in COUNTED} | unpacks(kernel, n) | {"checksum": n}
    check(launches == want, f"{name}: launch counts {launches}, expected {want}")
    check(not any(plain.values()), f"{name}: plain calls {plain}")
    emit("main_path", clip=name, frames=n,
         shapes=[list(src.shape) for src in imgs], seconds=secs,
         launches=launches, plain_calls=plain, exact=True)
    return launches


def counts() -> tuple[dict, dict]:
    return ({k: mod.KERNEL_LAUNCHES for k, mod in COUNTED.items()},
            {k: mod.PLAIN_CALLS for k, mod in COUNTED.items()})


def phase_batch_path(name: str, clip: Path, imgs, kernel: str, path: str) -> dict:
    """One batched path of the Decoder over every frame of `clip`: "batch"
    (decode_batch, one run), "iter<k>" (decode_batch_iter, chunk_frames=k)
    or "frame_decoder" (make_frame_decoder). Every frame equals its source
    and its device checksum the host's; the counters show one unpack launch
    of `kernel` per run chunk (per frame for the frame decoder), one
    checksum per frame and no plain call; the frame decoder has one program
    per (codec, geometry)."""
    with mcraw_torch.Decoder(str(clip), device="cuda") as d:
        frames = d.frames
        if path.startswith("iter"):
            chunk = int(path[4:])
            runs = [r for lo in range(0, len(frames), chunk)
                    for r in d._homogeneous_runs(frames[lo : lo + chunk])]
        reset_counters()
        t0 = time.perf_counter()
        outs, programs = [], None
        if path == "frame_decoder":
            fd = d.make_frame_decoder()
            outs = [fd(ts)[0] for ts in frames]
            programs = fd.num_programs
            calls = len(frames)
        else:
            batches = ([d.decode_batch()] if path == "batch"
                       else list(d.decode_batch_iter(chunk_frames=chunk)))
            outs = [img for b, _ in batches for img in b]
            calls = len(batches)
        sums = [C.device_checksum(img) for img in outs]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, plain = counts()
    check(len(outs) == len(imgs), f"{name} {path}: {len(outs)} frames")
    for i, (img, cs, src) in enumerate(zip(outs, sums, imgs)):
        check(img.device.type == "cuda" and img.dtype == torch.uint16
              and img.shape == src.shape, f"{name} {path} frame {i}: {tuple(img.shape)}")
        check(np.array_equal(img.cpu().numpy(), src), f"{name} {path} frame {i} != source")
        check(int(cs.item()) == host_checksum(src), f"{name} {path} frame {i}: checksum")
    want = {k: 0 for k in COUNTED} | unpacks(kernel, calls) | {"checksum": len(imgs)}
    if path.startswith("iter"):
        check(calls == len(runs), f"{name} {path}: {calls} launches for runs {runs}")
    check(launches == want, f"{name} {path}: launch counts {launches}, expected {want}")
    check(not any(plain.values()), f"{name} {path}: plain calls {plain}")
    keys = len({src.shape for src in imgs})
    if programs is not None:
        check(programs == keys, f"{name}: {programs} programs for {keys} geometries")
    emit("main_path", clip=name, path=path, frames=len(imgs), unpack_launches=calls,
         seconds=secs, launches=launches, plain_calls=plain, programs=programs, exact=True)
    return launches


def legacy_scans(imgs, payloads) -> list[str]:
    """Which host scan walks each legacy frame's chain (host only)."""
    return [L.scan_chain(p, L.num_blocks(img.shape[1], img.shape[0]))[1]
            for img, p in zip(imgs, payloads)]


# Matrix pairs of tests/test_preview.py: XYZ->camera at D65 / Standard A and
# the (white-balanced camera)->XYZ(D50) forward matrices.
_CM1 = [0.79, -0.23, -0.07, -0.43, 1.32, 0.05, -0.07, 0.18, 0.54]
_CM2 = [0.92, -0.31, -0.01, -0.50, 1.42, 0.08, -0.04, 0.22, 0.42]
_FM1 = [0.62, 0.22, 0.12, 0.26, 0.72, 0.02, 0.03, 0.12, 0.67]
_FM2 = [0.68, 0.18, 0.10, 0.30, 0.68, 0.02, 0.05, 0.10, 0.67]
# The camera's neutral under Standard A (x, y = 0.4476, 0.4074) by CM2: a
# warm as-shot neutral, so the forward matrix interpolates near FM2.
_XYZ_A = np.array([0.4476 / 0.4074, 1.0, (1 - 0.4476 - 0.4074) / 0.4074])
WARM = (np.reshape(_CM2, (3, 3)) @ _XYZ_A)
WARM = (WARM / WARM[1]).tolist()
DEVELOP_FRAMES = (  # (codec, height, width)
    (7, H, W), (7, H, W), (7, H, W), (6, 3024, 4032),
)
DEVELOP_RUNS = tuple((i, "bilinear") for i in range(len(DEVELOP_FRAMES))) + (
    (0, "malvar"), (3, "malvar"),
)


def make_develop_clip(path: Path):
    """The develop clip of DEVELOP_FRAMES, 12-bit frames in the bench's
    recipe, in a container whose white level (4095) fits them: (source
    images, container JSON)."""
    cm = example_container_metadata(sensor="bggr", black_level=(64, 60, 70, 64),
                                    white_level=4095.0)
    cm.update(colorMatrix1=_CM1, colorMatrix2=_CM2, forwardMatrix1=_FM1,
              forwardMatrix2=_FM2)
    rng = np.random.default_rng(13)
    writer = E.ContainerWriter(cm)
    imgs = []
    for i, (codec, h, w) in enumerate(DEVELOP_FRAMES):
        img = twelve_bit(rng, 3 + i, h, w)
        payload = E.encode_modern(img) if codec == 7 else E.encode_legacy(img)
        fm = example_frame_metadata(w, h, codec)
        fm["asShotNeutral"] = WARM
        writer.add_frame(3000 + 33 * i, payload, fm)
        imgs.append(img)
    path.write_bytes(writer.finish())
    return imgs, cm


class DevelopModel:
    """The f64 model of each develop-clip frame, computed once per (frame,
    demosaic) and kept as (H, W, 3) uint8."""

    def __init__(self, imgs, container: dict):
        cm = ContainerMetadata(container)
        fwd, _, weight = interpolated_matrices(cm, WARM)
        self.args = (cm.black_level, cm.white_level, WARM, fwd, tuple(cm.cfa_pattern))
        self.weight = float(weight)
        self.imgs = imgs
        self.seconds = 0.0
        self._cache = {}

    def __call__(self, i: int, demosaic: str) -> torch.Tensor:
        if (i, demosaic) not in self._cache:
            t0 = time.perf_counter()
            rgb = P.develop_f64(self.imgs[i], *self.args, demosaic=demosaic)
            self._cache[i, demosaic] = torch.from_numpy(rgb.astype(np.uint8))
            self.seconds += time.perf_counter() - t0
        return self._cache[i, demosaic]


def phase_develop_path(clip: Path, model: DevelopModel) -> dict:
    """preview_frame_rgba on the card over DEVELOP_RUNS: every frame within
    1 LSB of the f64 model, one develop launch per call and no plain or
    height <= 2 call; then preview_clip against it by device checksum."""
    with mcraw_torch.Decoder(str(clip), device="cuda") as d:
        check(len(d.frames) == len(DEVELOP_FRAMES), f"{len(d.frames)} develop frames")
        reset_counters()
        P.DEVELOP_CALLS = 0
        t0 = time.perf_counter()
        outs = []
        for i, demosaic in DEVELOP_RUNS:
            rgba = P.preview_frame_rgba(d, d.frames[i], demosaic=demosaic)
            outs.append((rgba, C.device_checksum(rgba)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, plain = counts()
        develop_calls = P.DEVELOP_CALLS
        frames = d.frames
        # The batched playback loop, counted on its own: runs of 2 frames.
        reset_counters()
        t0 = time.perf_counter()
        clip_out = [(ts, C.device_checksum(rgba)) for ts, rgba in
                    P.preview_clip(d, batch_frames=2)]
        torch.cuda.synchronize()
        clip_secs = time.perf_counter() - t0
        clip_launches, clip_plain = counts()
        clip_sums = [(ts, int(cs.item())) for ts, cs in clip_out]
    errs = []
    for (i, demosaic), (rgba, _) in zip(DEVELOP_RUNS, outs):
        h, w = DEVELOP_FRAMES[i][1:]
        what = f"develop frame {i} {demosaic}"
        check(rgba.device.type == "cuda" and rgba.dtype == torch.uint32
              and rgba.shape == (h, w), f"{what}: {rgba.dtype} {tuple(rgba.shape)}")
        err, ndiff = channel_diff(rgba_channels(rgba, what).cpu(), model(i, demosaic))
        check(err <= 1, f"{what}: {err} from the f64 model")
        errs.append({"frame": i, "demosaic": demosaic, "shape": [h, w],
                     "f64_err": err, "channels_differ": ndiff})
    bilinear = {frames[i]: int(cs.item())
                for (i, demosaic), (_, cs) in zip(DEVELOP_RUNS, outs)
                if demosaic == "bilinear"}
    check(dict(clip_sums) == bilinear and [ts for ts, _ in clip_sums] == frames,
          f"preview_clip checksums {clip_sums} != preview_frame_rgba {bilinear}")
    # DEVELOP_FRAMES (7, 7, 7, 6) in chunks of 2: runs (0, 1), (2), (3),
    # each decoded and developed (a row a frame) in one launch.
    want_clip = {"unpack_modern": 2, "unpack_legacy": 1, "checksum": len(frames),
                 "develop": 3, "block_offsets": 2}
    check(clip_launches == want_clip,
          f"preview_clip: launch counts {clip_launches}, expected {want_clip}")
    check(not any(clip_plain.values()), f"preview_clip: plain calls {clip_plain}")
    n_modern = sum(DEVELOP_FRAMES[i][0] == 7 for i, _ in DEVELOP_RUNS)
    want = {"unpack_modern": n_modern, "unpack_legacy": len(DEVELOP_RUNS) - n_modern,
            "checksum": len(DEVELOP_RUNS), "develop": len(DEVELOP_RUNS),
            "block_offsets": n_modern}
    check(launches == want, f"develop path: launch counts {launches}, expected {want}")
    check(not any(plain.values()), f"develop path: plain calls {plain}")
    check(develop_calls == 0, f"develop path: {develop_calls} height <= 2 develop calls")
    emit("main_path", clip=clip.name, path="preview_frame_rgba", seconds=secs,
         launches=launches, plain_calls=plain, develop_calls=develop_calls,
         frames=errs, f64_weight=model.weight)
    emit("main_path", clip=clip.name, path="preview_clip batch_frames=2", seconds=clip_secs,
         launches=clip_launches, plain_calls=clip_plain, equals_preview_frame_rgba=True)
    return {k: launches[k] + clip_launches[k] for k in COUNTED}


@contextlib.contextmanager
def staging_threads():
    """While open, records which threads lay out each Staging: {Staging:
    set of thread ids}."""
    users: dict = {}
    host = Staging.host

    def recording(self, *parts):
        users.setdefault(self, set()).add(threading.get_ident())
        return host(self, *parts)

    Staging.host = recording
    try:
        yield users
    finally:
        Staging.host = host


def phase_export_path(name: str, clip: Path, imgs, kernel: str, work: Path) -> dict:
    """export_clip(Decoder(clip, device="cuda"), prefetch=4, writers=4):
    every frame done, every DNG byte-identical to dng_bytes of its source
    image; one unpack launch of `kernel` per frame and no plain call;
    stage_timing with parse, unpack and emit (emit once a frame); no
    Staging laid out by two threads."""
    out = work / f"{clip.stem}_export"
    with mcraw_torch.Decoder(str(clip), device="cuda") as d:
        cm = d.container_metadata
        metas = [d._reader.frame_payload(ts)[1] for ts in d.frames]
        with staging_threads() as users:
            reset_counters()
            stats = export_clip(d, str(out), prefetch=4, writers=4)
            torch.cuda.synchronize()
            launches, plain = counts()
    n = len(imgs)
    check(stats.frames_done == n and stats.frames_failed == 0,
          f"{name} export: {stats.frames_done} done, {stats.frames_failed} failed "
          f"{stats.errors}")
    for i, (img, meta) in enumerate(zip(imgs, metas)):
        check((out / f"frame_{i:06d}.dng").read_bytes() == dng_bytes(img, meta, cm),
              f"{name} export: frame_{i:06d}.dng != dng_bytes of its source image")
    shutil.rmtree(out)
    want = {k: 0 for k in COUNTED} | unpacks(kernel, n)
    check(launches == want, f"{name} export: launch counts {launches}, expected {want}")
    check(not any(plain.values()), f"{name} export: plain calls {plain}")
    timing = stats.stage_timing
    check({"parse", "unpack", "emit"} <= set(timing) and timing["emit"]["count"] == n,
          f"{name} export: stage_timing {timing}")
    shared = [len(t) for t in users.values() if len(t) > 1]
    check(not shared, f"{name} export: a Staging laid out by {shared} threads")
    emit("main_path", clip=name, path="export_clip prefetch=4 writers=4", frames=n,
         seconds=stats.wall_seconds, fps=stats.fps, launches=launches, plain_calls=plain,
         stage_timing=timing, stagings=len(users),
         threads=len(set().union(*users.values())), identical=True)
    return launches


def make_corrupt_clip(path: Path) -> None:
    """Three 256x16 modern frames, the middle one an 8-byte zero payload."""
    rng = np.random.default_rng(15)
    writer = E.ContainerWriter(example_container_metadata())
    for i in range(3):
        img = rng.integers(0, 4096, size=(16, 256), dtype=np.uint16)
        payload = b"\x00" * 8 if i == 1 else E.encode_modern(img)
        writer.add_frame(1000 + 33 * i, payload, example_frame_metadata(256, 16, 7))
        writer.add_audio(rng.integers(-3000, 3000, size=2048).astype(np.int16), i * 10**6)
    path.write_bytes(writer.finish())


def phase_export_corrupt(clip: Path, work: Path) -> dict:
    """export_clip of the corrupt clip on the card: the good frames written
    byte-identical to ``python -m mcraw decode --pipeline --backend
    numpy``'s, the bad one in errors with the text that command reports."""
    ref = work / "corrupt_ref"
    res = subprocess.run([sys.executable, "-m", "mcraw", "decode", str(clip), "--pipeline",
                          "--backend", "numpy", "--output-dir", str(ref)],
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"mcraw decode --pipeline exited {res.returncode}: {res.stderr}")
    want = [ln for ln in res.stderr.splitlines() if ln.startswith("Error: frame ")]
    out = work / "corrupt_export"
    with mcraw_torch.Decoder(str(clip), device="cuda") as d:
        reset_counters()
        stats = export_clip(d, str(out), prefetch=4, writers=4)
        torch.cuda.synchronize()
        launches, plain = counts()
    got = [f"Error: frame {ts}: {err}" for ts, err in stats.errors]
    check(stats.frames_done == 2 and stats.frames_failed == 1 and got == want,
          f"corrupt export: {stats.frames_done} done, errors {got}, mcraw's {want}")
    for n in ("frame_000000.dng", "frame_000002.dng"):
        check(filecmp.cmp(out / n, ref / n, shallow=False), f"corrupt export: {n} differs")
    want_launches = {k: 0 for k in COUNTED} | unpacks("unpack_modern", 2)
    check(launches == want_launches and not any(plain.values()),
          f"corrupt export: launches {launches}, plain {plain}")
    emit("main_path", clip=clip.name, path="export_clip, a corrupt frame", frames=3,
         frames_failed=stats.frames_failed, errors=got, launches=launches, plain_calls=plain)
    return launches


# -- the mesh phase (after phase 4) ------------------------------------------------

MESH_N = 4  # entries of the repeated mesh: four shards on the one card


def card_mesh() -> PAR.Mesh:
    """(cuda:0,) * MESH_N: four shards, each with its own staging and stream,
    on one card (the port's counterpart of JAX's virtual devices)."""
    return PAR.Mesh((DEV,) * MESH_N)


def check_frames(what: str, frames, srcs) -> None:
    """Each (H, W) uint16 frame on the card equals its source, and its
    device checksum the host's."""
    check(len(frames) == len(srcs), f"{what}: {len(frames)} frames for {len(srcs)} sources")
    sums = [C.device_checksum(f) for f in frames]
    for i, (f, cs, src) in enumerate(zip(frames, sums, srcs)):
        check(f.device.type == "cuda" and f.dtype == torch.uint16 and f.shape == src.shape,
              f"{what} frame {i}: {f.device} {f.dtype} {tuple(f.shape)}")
        check(np.array_equal(f.cpu().numpy(), src), f"{what} frame {i} != source")
        check(int(cs.item()) == host_checksum(src), f"{what} frame {i}: checksum")


def check_sharded(what: str, s, mesh: PAR.Mesh, rows: list[int]) -> None:
    """A Sharded of the mesh: shard d on mesh.devices[d] with rows[d] rows."""
    check(isinstance(s, PAR.Sharded) and s.devices == mesh.devices,
          f"{what}: {type(s).__name__} on {getattr(s, 'devices', None)}")
    check([x.device for x in s.shards] == list(mesh.devices)
          and [x.shape[0] for x in s.shards] == rows,
          f"{what}: shards {[(str(x.device), tuple(x.shape)) for x in s.shards]}")


def mesh_path(what: str, kernel: str, fn, want_unpack: int, checksums: int) -> tuple:
    """Run fn() with the counters set to 0 just before and read just after;
    fails unless `kernel` launched `want_unpack` times (and, modern, the
    block offsets as often), the checksum `checksums` times, nothing else,
    and no plain version ran. (fn's result, the launch counts)."""
    reset_counters()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, plain = counts()
    want = {k: 0 for k in COUNTED} | unpacks(kernel, want_unpack) | {"checksum": checksums}
    check(launches == want, f"{what}: launch counts {launches}, expected {want}")
    check(not any(plain.values()), f"{what}: plain calls {plain}")
    return out, launches, secs


def phase_mesh_batch(name: str, clip: Path, imgs, idx: list[int], kernel: str,
                     mesh: PAR.Mesh, mesh_name: str) -> dict:
    """Decoder.decode_batch(mesh=mesh) over the clip's frames `idx`: one
    unpack launch of the clip's codec per shard, no plain call, shard d on
    mesh.devices[d], every frame equal to its source and its device
    checksum the host's; a batch of 3 raises the "not divisible"
    ValueError where the mesh has more than one entry."""
    srcs = [imgs[i] for i in idx]
    with mcraw_torch.Decoder(str(clip), device="cuda") as d:
        ts = [d.frames[i] for i in idx]

        def run():
            got, metas = d.decode_batch(ts, mesh=mesh)
            check_frames(f"{name} decode_batch mesh={mesh_name}",
                         [f for s in got.shards for f in s], srcs)
            return got

        got, launches, secs = mesh_path(f"{name} decode_batch mesh={mesh_name}", kernel, run,
                                        mesh.size, len(idx))
        check_sharded(f"{name} decode_batch mesh={mesh_name}", got, mesh,
                      [len(idx) // mesh.size] * mesh.size)
        uneven = None
        if mesh.size > 1:
            try:
                d.decode_batch(ts[:3], mesh=mesh)
            except ValueError as e:
                uneven = str(e)
            check(uneven == f"batch of 3 not divisible by {mesh.size} devices",
                  f"{name}: a batch of 3 on {mesh_name} gave {uneven!r}")
    emit("mesh", clip=name, path=f"decode_batch mesh={mesh_name}", mesh=[str(x) for x in
         mesh.devices], frames=len(idx), shards=[list(s.shape) for s in got.shards],
         seconds=secs, launches=launches, plain_calls=0, exact=True, uneven_error=uneven)
    return launches


def phase_mesh_iter(name: str, clip: Path, imgs, mesh: PAR.Mesh) -> dict:
    """decode_batch_iter(chunk_frames=6, mesh) over the modern clip's frames
    repeated to 11: chunks of 8 (sharded, one launch a shard) and 3 (the
    decoder's own device, one launch)."""
    idx = [i % len(imgs) for i in range(11)]
    with mcraw_torch.Decoder(str(clip), device="cuda") as d:
        ts = [d.frames[i] for i in idx]

        def run():
            chunks = list(d.decode_batch_iter(ts, chunk_frames=6, mesh=mesh))
            check([c.shape[0] for c, _ in chunks] == [8, 3],
                  f"{name} decode_batch_iter: chunks {[c.shape for c, _ in chunks]}")
            check_sharded(f"{name} decode_batch_iter chunk 0", chunks[0][0], mesh, [2] * 4)
            check(isinstance(chunks[1][0], torch.Tensor) and chunks[1][0].device == d.device,
                  f"{name} decode_batch_iter: the tail is not on the decoder's device")
            frames = [f for s in chunks[0][0].shards for f in s] + list(chunks[1][0])
            check_frames(f"{name} decode_batch_iter mesh", frames, [imgs[i] for i in idx])
            return chunks

        _, launches, secs = mesh_path(f"{name} decode_batch_iter mesh", "unpack_modern", run,
                                      mesh.size + 1, len(idx))
    emit("mesh", clip=name, path="decode_batch_iter chunk_frames=6 mesh=M", frames=len(idx),
         chunks=[8, 3], seconds=secs, launches=launches, plain_calls=0, exact=True)
    return launches


def phase_mesh_sharded(name: str, clip: Path, imgs, kernel: str, mesh: PAR.Mesh) -> dict:
    """load_frame_sharded(ts, mesh) on every frame of the clip: one band
    launch per mesh entry, shard d the rows of band d on its device, the
    frame equal to its source."""
    with mcraw_torch.Decoder(str(clip), device="cuda") as d:
        def run():
            rows = []
            for ts, src in zip(d.frames, imgs):
                got, meta = d.load_frame_sharded(ts, mesh)
                h = src.shape[0]
                units = PAR.band_rows(-(-h // 4) if kernel == "unpack_modern" else h, mesh.size)
                unit = 4 if kernel == "unpack_modern" else 1
                want_rows = [min(hi * unit, h) - lo * unit for lo, hi in units]
                check_sharded(f"{name} load_frame_sharded {ts}", got, mesh, want_rows)
                whole = got.to(DEV)
                check_frames(f"{name} load_frame_sharded {ts}", [whole], [src])
                rows.append(want_rows)
            return rows

        rows, launches, secs = mesh_path(f"{name} load_frame_sharded", kernel, run,
                                         mesh.size * len(imgs), len(imgs))
    emit("mesh", clip=name, path="load_frame_sharded mesh=M", frames=len(imgs),
         band_rows=rows, shapes=[list(s.shape) for s in imgs], seconds=secs,
         launches=launches, plain_calls=0, exact=True)
    return launches


def make_second_clip(path: Path) -> list:
    """A second modern clip for decode_clips: four 4096x3072 12-bit frames
    in the bench's recipe, another seed."""
    rng = np.random.default_rng(16)
    writer = E.ContainerWriter(example_container_metadata())
    imgs = [twelve_bit(rng, 20 + k) for k in range(4)]
    for i, img in enumerate(imgs):
        writer.add_frame(5000 + 33 * i, E.encode_modern(img), example_frame_metadata(W, H, 7))
    path.write_bytes(writer.finish())
    return imgs


def phase_mesh_clips(clips: list, mesh: PAR.Mesh) -> dict:
    """parallel.decode_clips of two modern clips' first four frames each
    over the mesh: one launch a shard, (2, 4, H, W) gathered on the mesh's
    first device, clip c frame f equal to its source."""
    decoders = [mcraw_torch.Decoder(str(p), device="cuda") for p, _ in clips]
    try:
        def run():
            out, metas = PAR.decode_clips(decoders, mesh=mesh, frames_per_clip=4)
            check(out.shape == (2, 4, H, W) and out.device == mesh.devices[0],
                  f"decode_clips: {tuple(out.shape)} on {out.device}")
            check_frames("decode_clips", [out[c, f] for c in range(2) for f in range(4)],
                         [imgs[f] for _, imgs in clips for f in range(4)])
            return metas

        _, launches, secs = mesh_path("decode_clips", "unpack_modern", run, mesh.size, 8)
    finally:
        for dec in decoders:
            dec.close()
    emit("mesh", path="parallel.decode_clips mesh=M", clips=[p.name for p, _ in clips],
         frames_per_clip=4, seconds=secs, launches=launches, plain_calls=0, exact=True)
    return launches


def phase_mesh_dryrun(clip: Path, model: DevelopModel, mesh: PAR.Mesh) -> dict:
    """The dry run (after __graft_entry__._dryrun_multichip_impl): the
    develop clip's three 4K modern frames repeated to 8, one batched decode
    over the mesh, then on each shard one batched develop launch of its
    (2, H, W) frames, then a cross-shard mean of the RGB. Each RGBA within
    1 LSB of the f64 model of its frame; one unpack and one develop launch
    a shard; the mean within 1 of the models' mean."""
    idx = [i % 3 for i in range(2 * mesh.size)]
    with mcraw_torch.Decoder(str(clip), device="cuda") as d:
        cm = ContainerMetadata(d.container_metadata)
        ts = [d.frames[i] for i in idx]
        fm = FrameMetadata(d._reader.frame_payload(ts[0])[1])
        fwd, _, _ = interpolated_matrices(cm, fm.as_shot_neutral)
        args = (cm.black_level, np.float32(cm.white_level), fm.as_shot_neutral,
                fwd.astype(np.float32))
        reset_counters()
        t0 = time.perf_counter()
        imgs, _ = d.decode_batch(ts, mesh=mesh)
        rgbas = [P.develop_rgba(s, *args, cfa=tuple(cm.cfa_pattern)) for s in imgs.shards]
        sums = [P.rgba_to_rgb(r).to(torch.float64).sum().to(DEV) for r in rgbas]
        mean = float(torch.stack(sums).sum().item()) / (len(idx) * H * W * 3)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, plain = counts()
    want = {k: 0 for k in COUNTED} | unpacks("unpack_modern", mesh.size) | {
        "develop": mesh.size}
    check(launches == want and not any(plain.values()),
          f"dry run: launches {launches} (expected {want}), plain {plain}")
    check([r.device for r in rgbas] == list(mesh.devices), "dry run: develop off its shard")
    errs = []
    frames = [f for r in rgbas for f in r]
    for i, rgba in zip(idx, frames):
        err, ndiff = channel_diff(rgba_channels(rgba, f"dry run frame {i}").cpu(),
                                  model(i, "bilinear"))
        check(err <= 1, f"dry run frame {i}: {err} from the f64 model")
        errs.append(err)
    model_mean = float(np.mean([model(i, "bilinear").to(torch.float64).mean().item()
                                for i in idx]))
    check(abs(mean - model_mean) <= 1.0, f"dry run mean {mean} vs the models' {model_mean}")
    emit("mesh", clip=clip.name, path="dry run: decode_batch + develop per shard + mean",
         frames=len(idx), seconds=secs, launches=launches, plain_calls=0, f64_err=errs,
         rgb_mean=mean, f64_rgb_mean=model_mean)
    return launches


# -- the two-process phase -----------------------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_two_process(clip: Path, imgs, work: Path) -> dict:
    """Two copies of this script in worker mode join a gloo process group on
    localhost, both on cuda:0: decode_batch_global_mesh over the modern
    clip's frames repeated to 8 (four frames a rank, one launch each, the
    cross-rank sum of device checksums equal to the host's), then
    export_clip_distributed of the clip's 5 frames; together the ranks
    write frame_000000..000004.dng, each byte-identical to the
    single-process export_clip's. A worker that fails fails the phase."""
    idx = [i % len(imgs) for i in range(8)]
    spec = work / "two_process.json"
    spec.write_text(json.dumps({"idx": idx, "sums": [host_checksum(imgs[i]) for i in idx]}))
    out = work / "two_process_dng"
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--worker",
                               str(port), str(rank), str(clip), str(out), str(spec)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    results = []
    for rank, (p, text) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"worker {rank} exited {p.returncode}:\n{text[-3000:]}")
        lines = [ln for ln in text.splitlines() if ln.startswith('{"worker"')]
        check(len(lines) == 1, f"worker {rank}: no result line:\n{text[-3000:]}")
        results.append(json.loads(lines[0]))
    ref = work / "two_process_ref"
    with mcraw_torch.Decoder(str(clip), device="cuda") as d:
        stats = export_clip(d, str(ref), prefetch=4, writers=4)
    check(stats.frames_done == len(imgs), f"single-process export: {stats.errors}")
    names = sorted(p.name for p in out.iterdir())
    check(names == [f"frame_{i:06d}.dng" for i in range(len(imgs))],
          f"two-process export wrote {names}")
    for n in names:
        check(filecmp.cmp(out / n, ref / n, shallow=False), f"two-process export: {n} differs")
    shutil.rmtree(out)
    shutil.rmtree(ref)
    launches = {k: sum(r["launches"][k] for r in results) for k in COUNTED}
    emit("two_process", clip=clip.name, backend="gloo", device=str(DEV), seconds=secs,
         ranks=results, launches=launches, identical=True)
    return launches


def worker(port: str, rank: int, clip: str, outdir: str, spec: str) -> int:
    """One rank of the two-process phase; prints one {"worker": ...} line."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    want = json.loads(Path(spec).read_text())
    torch.cuda.set_device(DEV)
    DIST.initialize(f"tcp://localhost:{port}", 2, rank, backend="gloo")
    mesh = DeviceMesh("cuda", [0, 1])
    with mcraw_torch.Decoder(clip, device="cuda") as d:
        ts = [d.frames[i] for i in want["idx"]]
        reset_counters()
        imgs, metas = DIST.decode_batch_global_mesh(d, ts, mesh)
        local = imgs.to_local()
        sums = [C.device_checksum(f) for f in local]
        torch.cuda.synchronize()
        decode_launches, plain = counts()
        check(local.device == DEV and local.shape == (4, H, W) and imgs.shape == (8, H, W),
              f"rank {rank}: local {local.device} {tuple(local.shape)}, global {imgs.shape}")
        mine = [int(s.item()) for s in sums]
        check(mine == want["sums"][4 * rank : 4 * rank + 4], f"rank {rank}: checksums {mine}")
        check(decode_launches == {k: 0 for k in COUNTED} | unpacks("unpack_modern", 1)
              | {"checksum": 4}
              and not any(plain.values()), f"rank {rank}: launches {decode_launches} {plain}")
        # The cross-rank reduction: an all-reduce of the ranks' checksums, an
        # int64 scalar on the CPU over gloo.
        total = torch.tensor(sum(mine), dtype=torch.int64)
        dist.all_reduce(total)
        check(int(total) & 0xFFFFFFFF == sum(want["sums"]) & 0xFFFFFFFF,
              f"rank {rank}: cross-rank checksum {int(total)}")
        reset_counters()
        stats = DIST.export_clip_distributed(d, outdir, prefetch=2, writers=2)
        torch.cuda.synchronize()
        export_launches, plain = counts()
        mine_ts, first = DIST.frame_shard(d.frames)
        check(stats.frames_done == len(mine_ts) and stats.frames_failed == 0,
              f"rank {rank}: export {stats.frames_done} done, {stats.errors}")
        check(export_launches == {k: 0 for k in COUNTED} | unpacks("unpack_modern", len(mine_ts))
              and not any(plain.values()), f"rank {rank}: export launches {export_launches}")
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({"worker": rank, "frames": len(local), "dtensor": list(imgs.shape),
                      "placement": str(imgs.placements[0]), "first_index": first,
                      "exported": stats.frames_done, "cross_rank_checksum": int(total),
                      "launches": {k: decode_launches[k] + export_launches[k]
                                   for k in COUNTED}}), flush=True)
    return 0


# -- the soak phase (after the two-process phase) ------------------------------------

SOAK_SEED = 2026
# (legs, seconds, flags): the decode legs on the checked build.
SOAK_RUNS = {"decode": ("codec,mutation,malformed", 60, ["--checked"]),
             "cli": ("cli", 30, [])}


def phase_soak(work: Path) -> dict:
    """``python -m mcraw_torch.soak`` on the card at a fixed seed: the
    codec, mutation and malformed legs for 60 s each on the checked build
    (each leg's line names it; no fault) and the two CLI legs
    for 30 s each, the five at once (a child process a leg). One line a
    leg; a failure or a crash fails the phase, and so does a decode path
    of a decode leg with no unpack launch, or a plain call on the card.
    The legs count their launches in their own processes; their sums are
    this phase's."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "mcraw_torch.soak", "--device", "cuda", "--seed",
         str(SOAK_SEED), "--legs", legs, "--seconds", str(secs),
         "--failures", str(work / "soak_failures"), *flags],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (legs, secs, flags) in SOAK_RUNS.items()}
    t0 = time.perf_counter()
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=600)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    rows = []
    for name, p in procs.items():
        out, err = outs[name]
        failed = [ln for ln in err.splitlines() if ln.startswith('{"failure"')]
        check(p.returncode == 0 and not failed,
              f"soak {name} exited {p.returncode}:\n" + "\n".join(failed[:10]) + err[-3000:])
        rows += [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith('{"leg"')]
    legs = {r["leg"]: r for r in rows}
    check(sorted(legs) == ["codec", "container", "json", "malformed", "mutation"],
          f"soak legs {sorted(legs)}")
    launches = dict.fromkeys(COUNTED, 0)
    for leg, r in legs.items():
        check(r["iterations"] > 0 and r["failures"] == 0 and r["crashes"] == 0,
              f"soak {leg}: {r}")
        for k, n in r["launches"].items():
            launches[k] += n
        if "paths" in r:
            ran = r["checked"]["launches"]
            check(r["library"].startswith("libmcraw_torch_checked_")
                  and not any(r["checked"]["faults"].values())
                  and ran.get("unpack_modern", 0) + ran.get("unpack_legacy", 0) > 0,
                  f"soak {leg}: not on the checked build, or faults: {r}")
            check(not any(r["plain_calls"].values()), f"soak {leg}: plain calls {r}")
            quiet = [p for p, c in r["paths"].items() if not c.get("unpack_launches")]
            check(not quiet, f"soak {leg}: no unpack launch on {quiet}")
        emit("soak", **{k: v for k, v in r.items() if k != "device"})
    check(launches["unpack_modern"] > 0 and launches["unpack_legacy"] > 0,
          f"soak launches {launches}")
    emit("soak", seed=SOAK_SEED, seconds=time.perf_counter() - t0, launches=launches)
    return launches


# -- the bench phase (after the soak phase) ------------------------------------------


def phase_bench() -> dict:
    """``python -m mcraw_torch.bench --quick`` on the card: exit 0, every
    key of bench.py's line, every leg a positive number, no gate failure,
    no error, each of the four kernels launched and no plain call. The
    bench counts its launches in its own process; they are this phase's."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "mcraw_torch.bench", "--quick"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    lines = res.stdout.splitlines()
    check(res.returncode == 0 and len(lines) == 1,
          f"bench exited {res.returncode}:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    line = json.loads(lines[0])
    missing = [k for k in BENCH.KEYS if k not in line]
    check(not missing, f"bench line lacks {missing}")
    null = [k for k in BENCH.KEYS[1:] if k != "unit"
            and not (isinstance(line[k], float) and line[k] > 0)]
    check(not null, f"bench legs without a number: {null}")
    check(line["gate_failures"] == [] and line["errors"] == [],
          f"bench: {line['gate_failures']} {line['errors']}")
    check(not any(line["plain_calls"].values()), f"bench plain calls {line['plain_calls']}")
    check(all(line["launches"][k] > 0 for k in COUNTED), f"bench launches {line['launches']}")
    emit("bench", phase_s=time.perf_counter() - t0, **line)
    return line["launches"]


# -- phase 5 -------------------------------------------------------------------


def phase_cli(clip: Path, work: Path) -> None:
    """python -m mcraw_torch <clip> -n 5, ... decode <clip> -n 5 and ...
    decode <clip> -n 5 --batch --batch-frames 2 against python -m mcraw
    <clip> -n 5 --backend numpy: identical stdout, byte-identical audio.wav
    and DNGs. The four commands run at once (``run_all``)."""
    cmds = {
        "mcraw": ["mcraw", str(clip), "-n", "5", "--backend", "numpy"],
        "mcraw_torch": ["mcraw_torch", str(clip), "-n", "5"],
        "mcraw_torch decode": ["mcraw_torch", "decode", str(clip), "-n", "5"],
        "mcraw_torch decode --batch": ["mcraw_torch", "decode", str(clip), "-n", "5",
                                       "--batch", "--batch-frames", "2"],
    }
    cwds = {name: work / f"{clip.stem}_{name.replace(' ', '_')}" for name in cmds}
    runs = {}
    for name, (res, secs) in run_all({k: (cmd, cwds[k]) for k, cmd in cmds.items()}).items():
        check(res.returncode == 0,
              f"{' '.join(cmds[name])} exited {res.returncode}: {res.stderr[-2000:]}")
        runs[name] = (cwds[name], res, secs)
    b, rb, tb = runs.pop("mcraw")
    names = sorted(p.name for p in b.iterdir())
    check("audio.wav" in names and sum(n.endswith(".dng") for n in names) == 5,
          f"outputs: {names}")
    for name, (a, ra, ta) in runs.items():
        check(ra.stdout == rb.stdout, f"{name} stdout differs:\n{ra.stdout}\n--\n{rb.stdout}")
        check(names == sorted(p.name for p in a.iterdir()), f"{name}: output file sets differ")
        for n in names:
            check(filecmp.cmp(a / n, b / n, shallow=False), f"{name}: {n} differs")
        emit("cli", clip=clip.name, command=name, files=names, identical=True,
             mcraw_torch_s=ta, mcraw_numpy_s=tb)


KERNEL_NAMES = {6: "unpack_legacy_kernel", 7: "unpack_modern_kernel"}
WRITING = re.compile(r"Writing (\S+?\.dng)")


def run_all(runs: dict) -> dict:
    """Run {name: (argv, cwd)} four at a time: {name: (result, seconds)}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def run(item):
        name, (cmd, cwd) = item
        cwd.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", *cmd], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=600)
        return name, (res, time.perf_counter() - t0)

    with ThreadPoolExecutor(4) as pool:
        return dict(pool.map(run, runs.items()))


def trace_kernels(trace_dir: Path) -> list[str]:
    """Names of the device kernel events of the one Chrome trace in
    `trace_dir`."""
    traces = list(trace_dir.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"{trace_dir}: traces {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "kernel"]


def phase_cli_export(clips: dict, corrupt: Path, work: Path) -> None:
    """The rest of the CLI against ``python -m mcraw ... --backend numpy``
    (mcraw's default for info and encode), each side a separate process:
    info and verify [--quick] on each clip of `clips` ({path: codec}) and
    on the corrupt clip (identical stdout and exit code); encode --codec 7
    and 6 (byte-identical files); and per clip ``decode -n 5 --pipeline``
    (the same Found line, the same multiset of Writing lines, an Exported
    line, byte-identical audio.wav and DNGs) with --verbose (a stage_timing
    event with parse, unpack and emit) and with --trace-dir T (the codec's
    unpack kernel as a device kernel once per frame)."""
    ref, mine = ("mcraw",), ("mcraw_torch",)
    runs = {}
    for clip in [*clips, corrupt]:
        for what, args in (("info", ["info"]), ("verify", ["verify"]),
                           ("verify --quick", ["verify", "--quick"])):
            cwd = work / "cli_export" / clip.stem
            runs[clip.stem, what, "mcraw"] = ([*ref, *args, str(clip)] + (
                ["--backend", "numpy"] if what != "info" else []), cwd)
            runs[clip.stem, what, "mcraw_torch"] = ([*mine, *args, str(clip)], cwd)
    for codec in (7, 6):
        args = ["encode", "out.mcraw", "--codec", str(codec), "--frames", "2", "--width",
                "512", "--height", "64", "--seed", "5"]
        for side in (ref, mine):
            runs[f"codec{codec}", "encode", side[0]] = (
                [*side, *args], work / "cli_export" / f"encode{codec}" / side[0])
    for clip in clips:
        base = ["decode", str(clip), "-n", "5", "--pipeline"]
        pipe = work / "cli_export" / f"{clip.stem}_pipeline"
        runs[clip.stem, "pipeline", "mcraw"] = ([*ref, *base, "--backend", "numpy"], pipe / "ref")
        runs[clip.stem, "pipeline --verbose", "mcraw_torch"] = (
            [*mine, *base, "--verbose"], pipe / "verbose")
        runs[clip.stem, "pipeline --trace-dir", "mcraw_torch"] = (
            [*mine, *base, "--trace-dir", "trace"], pipe / "trace")
    t0 = time.perf_counter()
    done = run_all(runs)
    wall = time.perf_counter() - t0
    for clip in [*clips, corrupt]:
        for what in ("info", "verify", "verify --quick"):
            (a, ta), (b, tb) = done[clip.stem, what, "mcraw_torch"], done[clip.stem, what, "mcraw"]
            check(a.returncode == b.returncode and a.stdout == b.stdout,
                  f"{what} {clip.name}: exit {a.returncode} / {b.returncode}\n{a.stdout}\n--\n"
                  f"{b.stdout}\n{a.stderr[-2000:]}")
            emit("cli", clip=clip.name, command=what, exit=a.returncode, identical=True,
                 mcraw_torch_s=ta, mcraw_numpy_s=tb)
    for codec in (7, 6):
        (a, _), (b, _) = done[f"codec{codec}", "encode", "mcraw_torch"], done[
            f"codec{codec}", "encode", "mcraw"]
        files = [work / "cli_export" / f"encode{codec}" / side / "out.mcraw"
                 for side in ("mcraw_torch", "mcraw")]
        check(a.returncode == b.returncode == 0 and a.stdout == b.stdout
              and filecmp.cmp(*files, shallow=False), f"encode --codec {codec} differs")
        emit("cli", command=f"encode --codec {codec}", bytes=files[0].stat().st_size,
             identical=True)
    for clip, codec in clips.items():
        pipe = work / "cli_export" / f"{clip.stem}_pipeline"
        b, tb = done[clip.stem, "pipeline", "mcraw"]
        check(b.returncode == 0, f"mcraw --pipeline {clip.name}: {b.stderr[-2000:]}")
        names = sorted(p.name for p in (pipe / "ref").iterdir())
        want = b.stdout.splitlines()
        for what, cwd in (("pipeline --verbose", pipe / "verbose"),
                          ("pipeline --trace-dir", pipe / "trace")):
            a, ta = done[clip.stem, what, "mcraw_torch"]
            got = a.stdout.splitlines()
            check(a.returncode == 0, f"{what} {clip.name} exited {a.returncode}: "
                  f"{a.stderr[-2000:]}")
            # mcraw's writer threads print a line and its newline apart, so
            # its lines may run together: compare the written paths.
            check(got[0] == want[0] and len(got) == 7
                  and all(ln.startswith("Writing ") for ln in got[1:-1])
                  and Counter(WRITING.findall(a.stdout)) == Counter(WRITING.findall(b.stdout))
                  and got[-1].startswith("Exported 5 frames in "),
                  f"{what} {clip.name} stdout:\n{a.stdout}\n--\n{b.stdout}")
            check(names == sorted(p.name for p in cwd.iterdir() if p.name != "trace"),
                  f"{what} {clip.name}: output files differ")
            for n in names:
                check(filecmp.cmp(cwd / n, pipe / "ref" / n, shallow=False),
                      f"{what} {clip.name}: {n} differs")
            row = dict(clip=clip.name, command=f"decode -n 5 {what}", files=names,
                       identical=True, writing_order=[ln.split()[-1] for ln in got[1:-1]],
                       mcraw_torch_s=ta, mcraw_numpy_s=tb)
            if what == "pipeline --verbose":
                timing = [json.loads(ln) for ln in a.stderr.splitlines()
                          if ln.startswith('{"event": "stage_timing"')]
                check(len(timing) == 1 and {"parse", "unpack", "emit"} <= set(timing[0])
                      and timing[0]["emit"]["count"] == 5,
                      f"--verbose {clip.name}: stage_timing {timing}\n{a.stderr[-2000:]}")
                row["stage_timing"] = timing[0]
            else:
                kernels = trace_kernels(cwd / "trace")
                found = {c: sum(KERNEL_NAMES[c] in k for k in kernels) for c in KERNEL_NAMES}
                check(found == {c: 5 if c == codec else 0 for c in KERNEL_NAMES},
                      f"--trace-dir {clip.name}: unpack kernels {found} in {Counter(kernels)}")
                row["trace_kernels"] = dict(Counter(kernels))
            emit("cli", **row)
    emit("cli_export", commands=len(runs), wall_s=wall, parallel=4)


def phase_cli_preview(clip: Path, work: Path, model: DevelopModel) -> None:
    """python -m mcraw_torch preview -n 2 --demosaic malvar: each PPM within
    1 of the f64 model (python -m mcraw preview needs JAX, absent here)."""
    cwd = work / "preview"
    cwd.mkdir()
    cmd = [sys.executable, "-m", "mcraw_torch", "preview", str(clip), "-n", "2",
           "--demosaic", "malvar", "--output-dir", "out"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=cwd, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    check(res.returncode == 0, f"mcraw_torch preview exited {res.returncode}: "
          f"{res.stderr[-2000:]}")
    names = [f"preview_{i:06d}.ppm" for i in range(2)]
    check(res.stdout == "".join(f"Writing out/{n}\n" for n in names),
          f"preview stdout: {res.stdout!r}")
    errs = []
    for i, name in enumerate(names):
        h, w = DEVELOP_FRAMES[i][1:]
        data = (cwd / "out" / name).read_bytes()
        header = b"P6\n%d %d\n255\n" % (w, h)
        check(data.startswith(header) and len(data) == len(header) + h * w * 3,
              f"{name}: header {data[:20]!r}, {len(data)} bytes")
        rgb = torch.frombuffer(bytearray(data[len(header):]), dtype=torch.uint8)
        rgb = rgb.reshape(h, w, 3)
        err, ndiff = channel_diff(rgb, model(i, "malvar"))
        check(err <= 1, f"{name}: {err} from the f64 model")
        errs.append({"file": name, "f64_err": err, "channels_differ": ndiff})
    emit("cli", clip=clip.name, command="preview -n 2 --demosaic malvar",
         files=errs, seconds=secs)


# -- phase 6 -------------------------------------------------------------------


def time_cuda(fn, n: int = N_TIMED, spin: int = SPIN_CYCLES) -> float:
    """Median ms of `fn` over n runs by CUDA events, L2 flushed before each.
    A spin of `spin` cycles on the card after the flush (~0.1 ms by
    default) keeps it busy while the host enqueues `fn`, so the events time
    the card's work and not the host's launch path."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    fn()
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_sum_ms(img: torch.Tensor) -> float | None:
    """The checksum's yardstick: one torch call, an int64 sum of the uint16
    plane (the checksum is its low 32 bits); None where torch has no such
    sum for uint16 on the card."""
    try:
        img.sum(dtype=torch.int64)
    except (RuntimeError, NotImplementedError):
        return None
    return time_cuda(lambda: img.sum(dtype=torch.int64))


def bound(nbytes: int, fp32_ops: int = 0) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the float32 operations over the float32 rate
    outside the tensor cores; and which of the two it is. The integer
    kernels count bytes only (the peak table has no int32 rate)."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = fp32_ops / PEAK_FP32_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def medians(split: dict) -> dict:
    """The median of each list of ms, and host_prep_ms: a staging's host
    prep and H2D (stage_ms) less the H2D alone (h2d_ms)."""
    med = {k: statistics.median(v) for k, v in split.items()}
    return med | {"host_prep_ms": med["stage_ms"] - med["h2d_ms"]}


def phase_times(payload: np.ndarray, card: str) -> dict:
    dev = U.stage_modern(Staging(DEV), payload, W, H)  # the batch of one
    offs = U.block_offsets(dev.bits, modern_tables(DEV))
    kw = dict(ty=dev.tiles_y, tx=dev.tiles_x, height=H, width=W)
    args = (dev.words, dev.bases, dev.lengths, dev.bits, dev.refs, offs)
    img = U.decode_modern_batch_device(*args, **kw)[0]
    t = {
        "unpack_ms": time_cuda(lambda: U.decode_modern_batch_device(*args, **kw)),
        "unpack_plain_ms": time_cuda(lambda: U.decode_modern_batch_plain(*args, **kw)),
        "checksum_ms": time_cuda(lambda: C.device_checksum(img)),
        "checksum_plain_ms": time_cuda(lambda: C.checksum_plain(img)),
        "checksum_library_ms": library_sum_ms(img),
        # payload, bits + refs + int64 offsets per block, the uint16 plane
        "unpack_bytes": len(payload) + dev.bits.numel() * (2 + 2 + 8) + 2 * H * W,
        "checksum_bytes": 2 * H * W + 4,
    }
    emit("times_kernels", card=card, frame=f"{W}x{H} 12-bit", n=N_TIMED,
         payload_bytes=len(payload), **t)

    # stage_ms: the host prep into a kept staging and its one H2D; h2d_ms:
    # that H2D again, alone. load_frame_device_ms: the Decoder's
    # single-frame decode (decode_modern_frame, without the container
    # read) through a staging kept as a Decoder keeps its own.
    split = {"stage_ms": [], "h2d_ms": [], "device_prep_ms": [], "kernel_ms": [],
             "load_frame_device_ms": []}
    staging, kept = Staging(DEV), Staging(DEV)
    clock = time.perf_counter
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = clock()
        dv = U.stage_modern(staging, payload, W, H)
        torch.cuda.synchronize()
        t1 = clock()
        staging.upload()
        torch.cuda.synchronize()
        t2 = clock()
        of = U.block_offsets(dv.bits, modern_tables(DEV))
        torch.cuda.synchronize()
        t3 = clock()
        U.decode_modern_batch_device(dv.words, dv.bases, dv.lengths, dv.bits, dv.refs, of,
                                     **kw)
        torch.cuda.synchronize()
        t4 = clock()
        U.decode_modern_frame(payload, W, H, kept)
        torch.cuda.synchronize()
        t5 = clock()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            split[key].append(dt * 1e3)
    emit("times_load_frame_device", card=card, n=10, clock="host, synchronized",
         **medians(split))
    return t


def phase_times_offsets(payloads, card: str) -> dict:
    """CUDA-event medians of the block offsets kernel, its plain version and
    the torch chain it replaced (an int64 cast, a clamp, a gather,
    ``torch.cumsum``, a subtract and an add: one call each) on the bits of
    the modern clip's 4K frames: one frame, and batches of F = 2, 5 and 8
    (the frames repeated); the bytes (bits read, offsets written) and their
    bound."""
    tab = modern_tables(DEV)
    bits = np.stack([U.scan_modern(p, W, H).bits for p in payloads])
    t = {}
    for f in (1, 2, 5, 8):
        x = put(bits[0] if f == 1 else bits[[i % len(payloads) for i in range(f)]])

        def chain(x=x):
            lengths = tab.block_length[x.to(torch.int64).clamp_(max=16)]
            return 16 + torch.cumsum(lengths, -1) - lengths

        ms = time_cuda(lambda: O.block_offsets_device(x))
        plain_ms = time_cuda(lambda: O.block_offsets_plain(x))
        chain_ms = time_cuda(chain)
        moved = x.numel() * (2 + 8)
        bound_ms = bound(moved)[0]
        emit("times_kernels", card=card, frame=f"block offsets, {f} x {W}x{H} 12-bit", n=N_TIMED,
             blocks=x.numel(), kernel_bytes=moved, block_offsets_ms=ms,
             block_offsets_plain_ms=plain_ms, torch_chain_ms=chain_ms, bound_ms=bound_ms,
             share=bound_ms / ms)
        t[f"offsets_{f}"] = (ms, plain_ms, chain_ms, moved)
    return t


def phase_times_legacy(payload: np.ndarray, card: str) -> dict:
    """The legacy kernel and its plain version at a 4K 12-bit frame, and
    the legacy load_frame_device split."""
    nblk = L.num_blocks(W, H)
    dev = L.stage_legacy(Staging(DEV), payload, W, H)  # the batch of one
    kw = dict(height=H, width=W)
    t = {
        "unpack_legacy_ms": time_cuda(lambda: L.decode_legacy_batch_device(*dev, **kw)),
        "unpack_legacy_plain_ms": time_cuda(lambda: L.decode_legacy_batch_plain(*dev, **kw)),
    }
    moved = len(payload) + 2 * H * W + nblk * (4 + 2 + 8)
    t["unpack_legacy_bytes"] = moved
    scan = L.scan_chain(payload, nblk)[1]
    emit("times_kernels", card=card, frame=f"legacy {W}x{H} 12-bit", n=N_TIMED,
         scan=scan, payload_bytes=len(payload), blocks=nblk,
         kernel_bytes=moved, kernel_gbps=moved / t["unpack_legacy_ms"] / 1e6, **t)

    # host_scan_ms: the scan alone, into new arrays; the staging's host prep
    # runs the same scan into its rows. load_frame_device_ms: the Decoder's
    # single-frame decode (decode_legacy, without the container read).
    split = {"host_scan_ms": [], "stage_ms": [], "h2d_ms": [], "kernel_ms": [],
             "load_frame_device_ms": []}
    staging, kept = Staging(DEV), Staging(DEV)
    clock = time.perf_counter
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = clock()
        L.scan_chain(payload, nblk)
        t1 = clock()
        dv = L.stage_legacy(staging, payload, W, H)
        torch.cuda.synchronize()
        t2 = clock()
        staging.upload()
        torch.cuda.synchronize()
        t3 = clock()
        L.decode_legacy_batch_device(*dv, **kw)
        torch.cuda.synchronize()
        t4 = clock()
        L.decode_legacy(payload, W, H, kept)
        torch.cuda.synchronize()
        t5 = clock()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            split[key].append(dt * 1e3)
    emit("times_load_frame_device", card=card, codec="legacy", n=10,
         clock="host, synchronized", scan=scan, **medians(split))
    return t


def phase_times_batch(clip: Path, legacy_clip: Path, card: str) -> dict:
    """decode_batch of the modern clip's five 4K frames and the legacy
    clip's first three: host-clocked wall per frame and its split (host
    prep, H2D, device prep, kernel; for legacy also the scans alone), the
    same decode_batch through a new Staging each turn (cold: its host
    buffer's pages touched for the first time), and load_frame_device of
    the same frames in the same turns; CUDA-event medians of the batched
    launch against F launches of a frame each on the same inputs; and the
    FrameDecoder against load_frame_device, per frame."""
    clock = time.perf_counter
    t = {}
    for codec, path, n in (("modern", clip, 5), ("legacy", legacy_clip, 3)):
        with mcraw_torch.Decoder(str(path), device="cuda") as d:
            ts = d.frames[:n]
            payloads = [np.asarray(d._reader.frame_payload(x)[0]) for x in ts]
            split = {k: [] for k in ("stage_ms", "h2d_ms", "device_prep_ms", "kernel_ms",
                                     "decode_batch_ms", "decode_batch_cold_ms",
                                     "load_frame_device_ms", "host_scans_ms")}
            staging = Staging(DEV)
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = clock()
                if codec == "modern":
                    dv = U.stage_modern_batch(staging, payloads, W, H)
                    torch.cuda.synchronize()
                    t1 = clock()
                    staging.upload()
                    torch.cuda.synchronize()
                    t2 = clock()
                    offs = U.block_offsets(dv.bits, modern_tables(DEV))
                    torch.cuda.synchronize()
                    t3 = clock()
                    batch = (dv.words, dv.bases, dv.lengths, dv.bits, dv.refs, offs)
                    kw = dict(ty=dv.tiles_y, tx=dv.tiles_x, height=H, width=W)
                    U.decode_modern_batch_device(*batch, **kw)
                else:
                    batch = tuple(L.stage_legacy_batch(staging, payloads, W, H))
                    torch.cuda.synchronize()
                    t1 = clock()
                    staging.upload()
                    torch.cuda.synchronize()
                    t2 = t3 = clock()
                    kw = dict(height=H, width=W)
                    L.decode_legacy_batch_device(*batch, **kw)
                torch.cuda.synchronize()
                t4 = clock()
                d.decode_batch(ts)
                torch.cuda.synchronize()
                t5 = clock()
                d._staging = Staging(DEV)
                d.decode_batch(ts)
                torch.cuda.synchronize()
                t6 = clock()
                for x in ts:  # the same frames one at a time, in the same turn
                    d.load_frame_device(x)
                torch.cuda.synchronize()
                t7 = clock()
                for p in payloads:
                    if codec == "modern":
                        U.scan_modern(p, W, H)
                    else:
                        L.scan_chain(p, L.num_blocks(W, H))
                t8 = clock()
                for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4,
                                           t6 - t5, t7 - t6, t8 - t7)):
                    split[key].append(dt * 1e3)
            med = medians(split)
            emit("times_decode_batch", card=card, codec=codec, frames=n,
                 frame=f"{W}x{H}", n=5, clock="host, synchronized",
                 per_frame_ms=med["decode_batch_ms"] / n,
                 cold_per_frame_ms=med["decode_batch_cold_ms"] / n,
                 load_frame_device_per_frame_ms=med["load_frame_device_ms"] / n, **med)

            # The batched launch against F launches of a frame each (its
            # batch of one), same inputs.
            batched = (U.decode_modern_batch_device if codec == "modern"
                       else L.decode_legacy_batch_device)
            frames = [(batch[0], *(a[f : f + 1] for a in batch[1:])) for f in range(n)]
            batch_ms = time_cuda(lambda: batched(*batch, **kw), spin=MULTI_SPIN_CYCLES)
            singles_ms = time_cuda(lambda: [batched(*f, **kw) for f in frames],
                                   spin=MULTI_SPIN_CYCLES)
            moved = (sum(len(p) for p in payloads) + 2 * n * H * W
                     + batch[3].numel() * (batch[3].element_size() + 2 + 8))
            emit("times_kernels", card=card, frame=f"{codec} {n} x {W}x{H} 12-bit",
                 n=N_TIMED, batch_ms=batch_ms, single_calls_ms=singles_ms,
                 ratio=batch_ms / singles_ms, kernel_bytes=moved,
                 bound_ms=bound(moved)[0])
            t[f"{codec}_batch"] = (n, batch_ms, singles_ms, bound(moved)[0])

            # FrameDecoder against load_frame_device, per frame.
            fd = d.make_frame_decoder()
            lat = {"frame_decoder_ms": [], "load_frame_device_ms": []}
            for _ in range(3):
                for x in ts:
                    for key, fn in (("frame_decoder_ms", fd), ("load_frame_device_ms",
                                                               d.load_frame_device)):
                        torch.cuda.synchronize()
                        t0 = clock()
                        fn(x)
                        torch.cuda.synchronize()
                        lat[key].append((clock() - t0) * 1e3)
            emit("times_frame_decoder", card=card, codec=codec, frame=f"{W}x{H}",
                 n=len(lat["frame_decoder_ms"]), clock="host, synchronized",
                 **{k: statistics.median(v) for k, v in lat.items()})
    return t


def phase_times_develop(clip: Path, card: str) -> dict:
    """The develop kernel and its plain version at a 4K 12-bit frame in both
    modes, and the preview_frame_rgba split into decode and develop."""
    x = torch.from_numpy(twelve_bit(np.random.default_rng(14), 0)).to(DEV)
    params = D.pack_develop_params(*BENCH_DEVELOP_ARGS)
    # read uint16, write uint32, the quantizer table
    moved = H * W * (2 + 4) + D.quantizer_table().nbytes
    t = {"develop_bytes": moved, "develop_fp32_ops": DEVELOP_FP32_OPS_PER_PIXEL * H * W}
    for demosaic in MODES:
        kw = dict(cfa=RGGB, demosaic=demosaic)
        ms = time_cuda(lambda: D.develop_rgba_device(x, params, **kw))
        plain_ms = time_cuda(lambda: D.develop_rgba_plain(x, params, **kw))
        emit("times_kernels", card=card, frame=f"develop {W}x{H} 12-bit",
             demosaic=demosaic, n=N_TIMED, kernel_bytes=moved,
             kernel_gbps=moved / ms / 1e6, develop_ms=ms, develop_plain_ms=plain_ms)
        t[f"develop_{demosaic}_ms"], t[f"develop_{demosaic}_plain_ms"] = ms, plain_ms

    split = {"decode_ms": [], "develop_ms": [], "preview_frame_rgba_ms": []}
    clock = time.perf_counter
    with mcraw_torch.Decoder(str(clip), device="cuda") as d:
        cm = ContainerMetadata(d.container_metadata)
        cfa = tuple(cm.cfa_pattern)
        ts = d.frames[0]
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = clock()
            img, meta = d.load_frame_device(ts)
            torch.cuda.synchronize()
            t1 = clock()
            P._frame_rgba(img, FrameMetadata(meta), cm, cfa)
            torch.cuda.synchronize()
            t2 = clock()
            P.preview_frame_rgba(d, ts)
            torch.cuda.synchronize()
            t3 = clock()
            for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
                split[key].append(dt * 1e3)
    med = {k: statistics.median(v) for k, v in split.items()}
    emit("times_preview_frame_rgba", card=card, frame=f"modern {W}x{H} 12-bit",
         demosaic="bilinear", n=10, clock="host, synchronized", **med)
    return t


def device_busy(trace_dir: Path, wall_s: float) -> dict:
    """From the Chrome trace in `trace_dir`: the union of the device's
    kernel, memcpy and memset intervals over `wall_s` (the busy share), and
    the sum of each kind's durations."""
    traces = list(trace_dir.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"{trace_dir}: traces {traces}")
    device = device_events(json.loads(traces[0].read_text())["traceEvents"])
    sums = Counter()
    for e in device:
        sums[e["cat"] + "_ms"] += e["dur"] / 1e3
    check(sums["kernel_ms"] > 0, f"{trace_dir}: no device kernel in the trace")
    busy = busy_us(device)
    return {"busy_ms": busy / 1e3, "wall_ms": wall_s * 1e3,
            "busy_share": busy / 1e6 / wall_s, **sums}


# Frames of the timed exports: 8 frames are in flight (prefetch + writers),
# so a 64-frame export is mostly steady state, not the pipeline's fill and
# drain. The sequential loop has no fill: its first frames give its rate.
EXPORT_FRAMES = 64
SEQUENTIAL_FRAMES = 10


def long_clip(src: Path, dst: Path, frames: int) -> None:
    """A clip of `frames` frames, those of `src` repeated in order (33 ms
    apart), with its container JSON, its frame JSON and no audio."""
    reader = mcraw_torch.ContainerReader(str(src))
    items = [reader.frame_payload(ts) for ts in reader.frames]
    writer = E.ContainerWriter(reader.container_metadata)
    for i in range(frames):
        payload, meta = items[i % len(items)]
        writer.add_frame(1000 + 33 * i, np.asarray(payload).tobytes(), meta)
    reader.close()
    dst.write_bytes(writer.finish())


def phase_times_export(clips: dict, card: str, work: Path) -> None:
    """Per 4K clip, its frames repeated to EXPORT_FRAMES, in 2 turns:
    export_clip (prefetch=4, writers=4) wall and fps, beside the sequential
    decode loop (load_frame and write_dng per frame, what ``decode`` does)
    over the first SEQUENTIAL_FRAMES frames of the same clip; the median
    stage_timing split; the Stagings the export laid out (each one's first
    frame is cold: new host and device buffers); then one export under
    device_trace: its fps and the device busy share."""
    clock = time.perf_counter
    out = work / "times_export"
    for clip in clips:
        long = work / f"{clip.stem}_long.mcraw"
        long_clip(clip, long, EXPORT_FRAMES)
        rows = {"export_s": [], "sequential_s": []}
        with mcraw_torch.Decoder(str(long), device="cuda") as d:
            frames, cm = d.frames, d.container_metadata
            timings, stagings = [], []
            for _ in range(2):
                with staging_threads() as users:
                    torch.cuda.synchronize()
                    t0 = clock()
                    stats = export_clip(d, str(out), prefetch=4, writers=4)
                    t1 = clock()
                check(stats.frames_done == len(frames),
                      f"{long.name} export: {stats.frames_done} done, {stats.errors}")
                shutil.rmtree(out)
                out.mkdir()
                t2 = clock()
                for i, ts in enumerate(frames[:SEQUENTIAL_FRAMES]):
                    img, meta = d.load_frame(ts)
                    write_dng(str(out / f"frame_{i:06d}.dng"), img, meta, cm)
                t3 = clock()
                shutil.rmtree(out)
                rows["export_s"].append(t1 - t0)
                rows["sequential_s"].append(t3 - t2)
                timings.append(stats.stage_timing)
                stagings.append(len(users))
            torch.cuda.synchronize()
            with device_trace(str(work / "busy_trace"), DEV):
                t0 = clock()
                stats = export_clip(d, str(out), prefetch=4, writers=4)
                torch.cuda.synchronize()
                wall = clock() - t0
            shutil.rmtree(out)
        long.unlink()
        n = len(frames)
        med = {k: statistics.median(v) for k, v in rows.items()}
        split = {stage: statistics.median(t[stage]["seconds"] for t in timings) * 1e3 / n
                 for stage in ("parse", "unpack", "emit")}
        emit("times_export", card=card, clip=long.name, frames=n,
             frame=f"{W}x{H}, {clip.name}'s frames repeated", turns=2, clock="host",
             export_s=rows["export_s"], sequential_s=rows["sequential_s"],
             sequential_frames=SEQUENTIAL_FRAMES, export_fps=n / med["export_s"],
             sequential_fps=SEQUENTIAL_FRAMES / med["sequential_s"],
             export_per_frame_ms=med["export_s"] * 1e3 / n,
             sequential_per_frame_ms=med["sequential_s"] * 1e3 / SEQUENTIAL_FRAMES,
             stage_ms_per_frame=split, stage_note="summed over the threads",
             cold_staging_frames=stagings, cold_staging_share=max(stagings) / n)
        emit("times_export_trace", card=card, clip=long.name, frames=n,
             traced_export_fps=n / wall, **device_busy(work / "busy_trace", wall))
        shutil.rmtree(work / "busy_trace")


def band_calls(codec: str, payload: np.ndarray, n: int):
    """A 4K frame's inputs staged on the card once, the batch of one: (one
    launch of the whole frame, [n band launches]) as calls, the bands those
    of parallel.decode_frame_sharded, on one stream."""
    if codec == "modern":
        dv = U.stage_modern(Staging(DEV), payload, W, H)
        args = (*dv[:5], U.block_offsets(dv.bits, modern_tables(DEV)))
        kw = dict(ty=dv.tiles_y, tx=dv.tiles_x, height=H, width=W)
        return (lambda: U.decode_modern_batch_device(*args, **kw)[0],
                [lambda lo=lo, hi=hi: PAR.modern_band(*args, lo, hi, **kw)
                 for lo, hi in PAR.band_rows(-(-H // 4), n)])
    dv = L.stage_legacy(Staging(DEV), payload, W, H)
    return (lambda: L.decode_legacy_batch_device(*dv, height=H, width=W)[0],
            [lambda lo=lo, hi=hi: PAR.legacy_band(*dv, lo, hi, width=W)
             for lo, hi in PAR.band_rows(H, n)])


def phase_times_mesh(clip: Path, legacy_clip: Path, card: str) -> dict:
    """Printed, not asserted, on the repeated mesh M (four shards on one
    card): per 4K frame of each codec, load_frame_sharded against
    load_frame_device (host clock, synchronized, median of 5); for the
    modern clip's frames repeated to 8, decode_batch(mesh=M) against
    decode_batch() per frame (median of 3); and CUDA-event medians of the
    four band launches against one launch of the whole frame on the same
    staged inputs (their outputs held equal)."""
    clock = time.perf_counter
    mesh = card_mesh()
    t = {}

    def wall(fn, turns: int) -> float:
        times = []
        for _ in range(turns):
            torch.cuda.synchronize()
            t0 = clock()
            fn()
            torch.cuda.synchronize()
            times.append((clock() - t0) * 1e3)
        return statistics.median(times)

    for codec, path in (("modern", clip), ("legacy", legacy_clip)):
        with mcraw_torch.Decoder(str(path), device="cuda") as d:
            ts = d.frames[0]
            d.load_frame_sharded(ts, mesh)  # the mesh's stagings laid out once
            lat = {"load_frame_sharded_ms": wall(lambda: d.load_frame_sharded(ts, mesh), 5),
                   "load_frame_device_ms": wall(lambda: d.load_frame_device(ts), 5)}
            emit("times_mesh", card=card, codec=codec, frame=f"{W}x{H}", mesh=f"{DEV} x {MESH_N}",
                 n=5, clock="host, synchronized", **lat)
            single, bands = band_calls(codec, np.asarray(d._reader.frame_payload(ts)[0]), MESH_N)
            whole = torch.cat([b() for b in bands])
            check(torch.equal(whole.to(torch.int32), single().to(torch.int32)),
                  f"{codec}: {MESH_N} bands != one launch of the whole frame")
            k = {"single_ms": time_cuda(single, spin=MULTI_SPIN_CYCLES),
                 "bands_ms": time_cuda(lambda: [b() for b in bands], spin=MULTI_SPIN_CYCLES)}
            emit("times_kernels", card=card, frame=f"{codec} {W}x{H} 12-bit", n=N_TIMED,
                 bands=MESH_N, ratio=k["bands_ms"] / k["single_ms"], **k)
            t[f"{codec}_bands"] = k["bands_ms"]
            if codec == "modern":
                ts8 = [d.frames[i % len(d.frames)] for i in range(8)]
                d.decode_batch(ts8, mesh=mesh)
                d.decode_batch(ts8)
                per = {"decode_batch_mesh_ms": wall(lambda: d.decode_batch(ts8, mesh=mesh), 3) / 8,
                       "decode_batch_ms": wall(lambda: d.decode_batch(ts8), 3) / 8}
                emit("times_mesh", card=card, codec=codec, frame=f"{W}x{H}", frames=8,
                     mesh=f"{DEV} x {MESH_N}", n=3, clock="host, synchronized",
                     per_frame=True, **per)
    return t


# Every TPU kernel of the repo (each function that reaches pl.pallas_call)
# and the CUDA kernel that computes it: (name, TPU kernel, CUDA kernel).
TPU_KERNELS = (
    ("unpack_modern", "mcraw/kernels/pallas_unpack.py:491", "unpack_modern"),
    ("unpack_modern_v4", "mcraw/kernels/pallas_unpack.py:148", "unpack_modern"),
    ("unpack_modern_v2", "mcraw/kernels/pallas_unpack.py:1982", "unpack_modern"),
    ("checksum", "mcraw/kernels/checksum.py:27", "checksum"),
    ("unpack_legacy", "mcraw/kernels/pallas_legacy.py:639", "unpack_legacy"),
    ("unpack_legacy_v5", "mcraw/kernels/pallas_legacy.py:327", "unpack_legacy"),
    ("unpack_legacy_v1", "mcraw/kernels/pallas_legacy.py:68", "unpack_legacy"),
    ("develop", "mcraw/kernels/pallas_develop.py:66, :338", "develop"),
    # _v6_build_meta's offsets: plain jnp, no pallas_call.
    ("block_offsets", "mcraw/kernels/pallas_unpack.py:1711", "block_offsets"),
)


def kernels_line(t: dict, errs: dict, paths: list) -> list:
    """The {"kernels": [...]} entries: launches on the main paths (`paths`,
    one launch-count dict each, the batched launches among them), errors
    of phase 3, times of phase 6, bounds from this run's inputs. A routed
    TPU kernel carries the numbers of the CUDA kernel that computes it; the
    unpack rows also carry the batched launch's time (batch_ms, F frames)
    beside F single launches (single_calls_ms) and its bound."""
    launches = {k: sum(p[k] for p in paths) for k in COUNTED}
    cuda = {
        "unpack_modern": (t["unpack_ms"], t["unpack_plain_ms"], None,
                          bound(t["unpack_bytes"])),
        "unpack_legacy": (t["unpack_legacy_ms"], t["unpack_legacy_plain_ms"], None,
                          bound(t["unpack_legacy_bytes"])),
        "checksum": (t["checksum_ms"], t["checksum_plain_ms"], t["checksum_library_ms"],
                     bound(t["checksum_bytes"])),
        "develop": (t["develop_bilinear_ms"], t["develop_bilinear_plain_ms"], None,
                    bound(t["develop_bytes"], t["develop_fp32_ops"])),
        "block_offsets": (*t["offsets_1"][:3], bound(t["offsets_1"][3])),
    }
    rows = []
    for name, replaces, kernel in TPU_KERNELS:
        ms, plain_ms, library_ms, (bound_ms, bound_by) = cuda[kernel]
        rows.append({
            "name": name, "route": "cuda", "source": f"mcraw_torch/csrc/{kernel}.cu",
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": errs[kernel], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        })
        if kernel == "develop":
            rows[-1]["malvar_ms"] = t["develop_malvar_ms"]
            rows[-1]["malvar_plain_ms"] = t["develop_malvar_plain_ms"]
        if kernel == "block_offsets":
            rows[-1]["batches"] = {f: {"ms": t[f"offsets_{f}"][0], "plain_ms": t[f"offsets_{f}"][1],
                                       "library_ms": t[f"offsets_{f}"][2],
                                       "bound_ms": bound(t[f"offsets_{f}"][3])[0]}
                                   for f in (2, 5, 8)}
        codec = {"unpack_modern": "modern", "unpack_legacy": "legacy"}.get(kernel)
        if codec:
            n, batch_ms, singles_ms, batch_bound_ms = t[f"{codec}_batch"]
            rows[-1].update(batch_frames=n, batch_ms=batch_ms, single_calls_ms=singles_ms,
                            batch_bound_ms=batch_bound_ms, bands=MESH_N,
                            bands_ms=t[f"{codec}_bands"])
    return rows


def main() -> None:
    started = time.perf_counter()
    card = phase_device()
    phase_build()
    rng = np.random.default_rng(2024)
    with recording() as digests:
        errs = phase_kernels(rng)
    work = Path(tempfile.mkdtemp(prefix="mcraw_torch_smoke_"))
    try:
        clip = work / "clip.mcraw"
        imgs, payloads = make_clip(clip)
        emit("clip", clip=clip.name, frames=len(imgs), bytes=clip.stat().st_size,
             payload_bytes=[len(p) for p in payloads])
        legacy = work / "legacy.mcraw"
        t0 = time.perf_counter()
        limgs, lpayloads = make_legacy_clip(legacy)
        emit("clip", clip=legacy.name, frames=len(limgs),
             bytes=legacy.stat().st_size, encode_s=time.perf_counter() - t0,
             payload_bytes=[len(p) for p in lpayloads],
             scans=legacy_scans(limgs, lpayloads), native=native.have_native())
        with recording() as batch_digests:
            batch_errs = phase_kernels_batch(np.random.default_rng(2025), payloads, lpayloads)
        for name, err in batch_errs.items():
            errs[name] = max(errs[name], err)
        phase_checked(work, digests + batch_digests, payloads, lpayloads)
        develop = work / "develop.mcraw"
        t0 = time.perf_counter()
        dimgs, dcm = make_develop_clip(develop)
        emit("clip", clip=develop.name, frames=len(dimgs),
             bytes=develop.stat().st_size, encode_s=time.perf_counter() - t0,
             shapes=[list(img.shape) for img in dimgs])
        paths = [phase_main_path(clip.name, clip, imgs, "unpack_modern"),
                 phase_main_path(legacy.name, legacy, limgs, "unpack_legacy")]
        for name, path, src, kernel, batch_paths in (
            (clip.name, clip, imgs, "unpack_modern", ("batch", "iter2", "frame_decoder")),
            (legacy.name, legacy, limgs, "unpack_legacy", ("iter4", "frame_decoder")),
        ):
            paths += [phase_batch_path(name, path, src, kernel, p) for p in batch_paths]
        model = DevelopModel(dimgs, dcm)
        paths.append(phase_develop_path(develop, model))
        paths += [phase_export_path(clip.name, clip, imgs, "unpack_modern", work),
                  phase_export_path(legacy.name, legacy, limgs, "unpack_legacy", work)]
        corrupt = work / "corrupt.mcraw"
        make_corrupt_clip(corrupt)
        paths.append(phase_export_corrupt(corrupt, work))
        # The mesh phase: the repeated mesh M and every visible card.
        t0 = time.perf_counter()
        mesh = card_mesh()
        for m, m_name in ((mesh, "M"), (PAR.default_mesh(), "default_mesh()")):
            paths += [phase_mesh_batch(clip.name, clip, imgs, [i % 5 for i in range(8)],
                                       "unpack_modern", m, m_name),
                      phase_mesh_batch(legacy.name, legacy, limgs, [0, 1, 2, 4],
                                       "unpack_legacy", m, m_name)]
        paths.append(phase_mesh_iter(clip.name, clip, imgs, mesh))
        paths += [phase_mesh_sharded(clip.name, clip, imgs, "unpack_modern", mesh),
                  phase_mesh_sharded(legacy.name, legacy, limgs, "unpack_legacy", mesh)]
        second = work / "clip2.mcraw"
        paths.append(phase_mesh_clips([(clip, imgs), (second, make_second_clip(second))], mesh))
        paths.append(phase_mesh_dryrun(develop, model, mesh))
        t1 = time.perf_counter()
        paths.append(phase_two_process(clip, imgs, work))
        t2 = time.perf_counter()
        paths.append(phase_soak(work))
        t3 = time.perf_counter()
        paths.append(phase_bench())
        emit("timing", mesh_phase_s=t1 - t0, two_process_phase_s=t2 - t1,
             soak_phase_s=t3 - t2, bench_phase_s=time.perf_counter() - t3)
        phase_cli(clip, work)
        phase_cli(legacy, work)
        phase_cli_export({clip: 7, legacy: 6}, corrupt, work)
        phase_cli_preview(develop, work, model)
        emit("f64_model", calls=len(model._cache), seconds=model.seconds)
        t = (phase_times(payloads[0], card) | phase_times_offsets(payloads, card)
             | phase_times_legacy(lpayloads[0], card)
             | phase_times_develop(develop, card) | phase_times_batch(clip, legacy, card)
             | phase_times_mesh(clip, legacy, card))
        phase_times_export((clip, legacy), card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check("jax" not in sys.modules, "jax was imported")
    emit("timing", total_s=time.perf_counter() - started)
    kernels = kernels_line(t, errs, paths)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(sys.argv[2], int(sys.argv[3]), *sys.argv[4:7]))
    if sys.argv[1:2] == ["--checked-child"]:
        sys.exit(checked_child(sys.argv[2]))
    main()
