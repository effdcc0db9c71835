"""The checked build of the five CUDA kernels, driven on the card.

    python -m mcraw_torch.bounds [--device cuda]

In one process (the checked build cannot share a process with the default
one, ``kernels/build.py::use_checked``):

- clean launches of every entry point (:func:`clean_cases`): each must
  raise no fault, and its output's digest is printed so that a caller can
  hold it against the default library's on the same inputs;
- :data:`NEGATIVE`: for each kernel and each kind of access it makes
  (global load, ``cp.async``, store, shared index; develop's host reads of
  its parameters and tensor map, and the reach of that map, whose TMA
  copies are the develop's ``cp.async``, as the modern unpack's bulk
  copies of its runs' spans are its; the stage arrays of the modern
  unpack's ring; the develop's per-frame launch's loads of each frame's
  row and CFA; the block offsets' memset of
  their status scratch, a store from the host), a clean launch with one
  buffer's checked extent understated (``build.understate``), which must
  fault on that buffer and count a fault of that kind;
- :data:`WINDOWS`: a batch of each codec with one frame's offsets shuffled
  and pointed past its own end, which must read nothing outside its own
  window, and the same batch with every frame's checked window cut short
  by some bytes, whose reads there (the modern unpack's: its bulk copies'
  windows) must be counted as cross-frame reads and not faulted.

One JSON line on stdout; exit 1 if a clean launch faulted, a negative case
did not fire on its buffer and kind, or a window count is off. Every input
is made from a fixed seed, so another process makes the same ones.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from typing import Callable

import numpy as np
import torch

from . import encode as E
from .kernels import build
from .kernels import checksum as C
from .kernels import develop as D
from .kernels import legacy as L
from .kernels import offsets as O
from .kernels import tables as T
from .kernels import unpack as U
from .kernels.staging import Staging, batch_of_one
from .kernels.tables import modern_tables
from .metadata import CFA_PATTERNS

SEED = 2027
MODERN = (64, 1024)  # 16 x 16 tiles: 8 full runs of the unpack kernel
LEGACY = (24, 1000)  # 768 pairs: 24 full runs, runs that cross rows
DEVELOP = (37, 251)  # odd: border tiles, masked stores, unpaired loads (the direct path)
DEVELOP_RING = (37, 256)  # the ring path: its boxes reach past the frame on every side
DEVELOP_PARAMS = (np.array([64, 60, 70, 64], np.float32), 4095.0,
                  np.array([0.61, 1.0, 0.72], np.float32),
                  np.array([[0.86, 0.08, 0.02], [0.04, 0.91, 0.05],
                            [0.01, 0.06, 0.76]], np.float32))
BGGR = tuple(CFA_PATTERNS["bggr"])
OFFSETS_BLOCKS = 2 * O.TILE + 5  # two full tiles and a partial one

# (kernel, kind, buffer, bytes off its checked extent): each fires on a
# clean launch of :func:`_inputs`' frame of that kernel. None: the cut
# :func:`_inputs` computes from the frame (the modern words end where the
# last block's 16-byte chunk starts, so the last run's bulk copy reaches
# past them: past the block data come the metadata streams and the tail,
# which the kernel never reads; the modern ring's stage arrays, s_words to
# s_head, cut by more than their size, fault at every copy into them and
# every read of them; develop's params keep
# 64 bytes, below the 17 floats its entry reads). The checksum's out, cut
# to 3 bytes, fails both its host memset and its kernel's atomic add. The
# block offsets' status scratch, cut by one word, fails the entry's memset
# of it on the host (the entry then does not launch); s_local, cut by one
# word, fails at the last block of a full tile. The develop cases of
# RING_NEGATIVE launch the ring path (DEVELOP_RING), the others the direct
# path: the ring entry holds its tensor map's reach on raw to raw's extent
# on the host (a cp.async fault, no launch) and reads its 128-byte map;
# s_ring, cut by more than its size, faults at every copy into it and
# every read of it. The cases of ROWS_NEGATIVE launch the per-frame
# develop (DEVELOP_ROWS, on the ring): rows cut to end 4 bytes inside the
# last frame's 17 floats, cfas by the last frame's last channel.
NEGATIVE = (
    ("unpack_modern", "load", "bits", 2),
    ("unpack_modern", "cp.async", "words", None),
    ("unpack_modern", "store", "out", 2),
    ("unpack_modern", "shared", "s_desc", 16),
    ("unpack_modern", "shared", "s_words", 1 << 20),
    ("unpack_modern", "shared", "s_off", 1 << 20),
    ("unpack_modern", "shared", "s_cls", 1 << 20),
    ("unpack_modern", "shared", "s_ref", 1 << 20),
    ("unpack_modern", "shared", "s_head", 1 << 20),
    ("unpack_legacy", "load", "bits", 4),
    ("unpack_legacy", "cp.async", "payload", 64),
    ("unpack_legacy", "store", "out", 2),
    ("unpack_legacy", "shared", "s_off", 8),
    ("develop", "load", "raw", 2),
    ("develop", "store", "out", 4),
    ("develop", "shared", "s_q", 4),
    ("develop", "host", "params", None),
    ("develop", "cp.async", "raw", 2),
    ("develop", "shared", "s_ring", 1 << 20),
    ("develop", "host", "map", 8),
    ("develop", "load", "rows", None),
    ("develop", "load", "cfas", 4),
    ("checksum", "load", "x", 2),
    ("checksum", "store", "out", 5),
    ("checksum", "shared", "s_warp", 4),
    ("block_offsets", "load", "bits", 2),
    ("block_offsets", "store", "offsets", 8),
    ("block_offsets", "store", "status", 8),
    ("block_offsets", "shared", "s_local", 4),
)
RING_NEGATIVE = {("develop", "cp.async", "raw"), ("develop", "shared", "s_ring"),
                 ("develop", "host", "map")}
ROWS_NEGATIVE = {("develop", "load", "rows"), ("develop", "load", "cfas")}
DEVELOP_ROWS = (3, 37, 256)  # a batch of frames, each with its own row and CFA
# kernel -> bytes off every batch frame's checked window.
WINDOWS = {"unpack_modern": 512, "unpack_legacy": 64}


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's dtype, shape and bytes."""
    a = t.detach().cpu().contiguous()
    h = hashlib.sha256(f"{a.dtype} {tuple(a.shape)}".encode())
    h.update(a.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def _image(rng, h: int, w: int) -> np.ndarray:
    return rng.integers(0, 4096, size=(h, w), dtype=np.uint16)


def _encoded(encode, rng, h: int, w: int) -> np.ndarray:
    return np.frombuffer(encode(_image(rng, h, w)), np.uint8)


def _modern_synthetic(rng, ty: int, tx: int, dev, past_end: bool):
    """Random bits 0..16 and payload bytes; `past_end`: the offsets
    shuffled and the last three pointed at and past the end of the words."""
    nblk = 4 * ty * tx
    bits = rng.integers(0, 17, size=nblk, dtype=np.uint16)
    refs = rng.integers(0, 1 << 16, size=nblk, dtype=np.uint16)
    size = 16 + int(T.MODERN_BLOCK_LENGTH[bits].sum()) + U.TAIL_BYTES
    size += (-size) % 16
    payload = rng.integers(0, 256, size=size, dtype=np.uint8)
    w, b, r = (torch.from_numpy(a).to(dev) for a in (payload.view("<i4"), bits, refs))
    offs = U.block_offsets(b, modern_tables(dev))
    if past_end:
        offs = offs[torch.from_numpy(rng.permutation(nblk)).to(dev)].contiguous()
        offs[-3:] = torch.tensor([size - 4, size, size + 64], device=dev)
    return w, b, r, offs


def _legacy_synthetic(rng, h: int, w: int, dev, past_end: bool):
    """A synthetic header chain over random bytes; `past_end`: the offsets
    shuffled and the last nine from 4 bytes before to 4 past the end."""
    nblk = L.num_blocks(w, h)
    bits = rng.integers(0, 17, size=nblk).astype(np.int32)
    refs = rng.integers(0, 1 << 16, size=nblk).astype(np.uint16)
    step = 2 + T.LEGACY_BLOCK_LENGTH[bits].astype(np.int64)
    offsets = np.cumsum(step) - step + 2
    payload = rng.integers(0, 256, size=int(step.sum()) + 1 + L.TAIL_BYTES, dtype=np.uint8)
    if past_end:
        offsets = offsets[rng.permutation(nblk)]
        offsets[-9:] = len(payload) + np.arange(-4, 5)
    return [torch.from_numpy(a).to(dev) for a in (payload, bits, refs, offsets)]


def _slots(frames: list, elem: int, dev):
    """The frames' payloads (torch, `elem` bytes an element) one after
    another, each slot padded to 16 bytes: (buffer, bases, lengths) in
    elements, each length the frame's own."""
    parts, bases, lengths, at = [], [], [], 0
    for p in frames:
        a = p.cpu().numpy().view(np.uint8)
        pad = np.zeros((-a.size) % 16, np.uint8)
        parts += [a, pad]
        bases.append(at // elem)
        lengths.append(a.size // elem)
        at += a.size + pad.size
    buf = np.concatenate(parts).view(frames[0].cpu().numpy().dtype)
    put = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)  # noqa: E731
    return torch.from_numpy(buf).to(dev), put(bases), put(lengths)


def _modern_batch(rng, dev, past_end: bool):
    ty, tx = MODERN[0] // 4, MODERN[1] // 64
    frames = [_modern_synthetic(rng, ty, tx, dev, past_end and f == 1) for f in range(3)]
    words, bases, lengths = _slots([f[0] for f in frames], 4, dev)
    rest = [torch.stack([f[k] for f in frames]) for k in (1, 2, 3)]
    return lambda: U.decode_modern_batch_device(
        words, bases, lengths, *rest, ty=ty, tx=tx, height=MODERN[0], width=MODERN[1])


def _legacy_batch(rng, dev, past_end: bool):
    h, w = LEGACY
    frames = [_legacy_synthetic(rng, h, w, dev, past_end and f == 1) for f in range(3)]
    payload, bases, lengths = _slots([f[0] for f in frames], 1, dev)
    rest = [torch.stack([f[k] for f in frames]) for k in (1, 2, 3)]
    return lambda: L.decode_legacy_batch_device(
        payload, bases, lengths, *rest, height=h, width=w)


def _frame_rows(frames: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """(frames, 128) rows and (frames, 4) CFAs on `dev`: DEVELOP_PARAMS with
    each frame's black levels shifted (frame 1's first below 0, so that its
    raw 0 does not normalize to 0) and the four Bayer patterns in turn."""
    black, white, neutral, fwd = DEVELOP_PARAMS
    rows = np.concatenate([D.pack_develop_params(black + (-68 if f == 1 else 2 * f), white,
                                                 neutral, fwd) for f in range(frames)])
    cfas = np.array([D.BAYER_CFAS[f % 4] for f in range(frames)], np.int32)
    return torch.from_numpy(rows).to(dev), torch.from_numpy(cfas).to(dev)


def _inputs(dev) -> tuple[dict, dict]:
    """input -> (kernel, a call that launches it once on a clean frame):
    the negative cases' inputs, one a kernel and "develop ring"; and
    (kernel, buffer) -> the bytes to cut where NEGATIVE leaves them to the
    frame."""
    rng = np.random.default_rng([SEED, 1])
    mh, mw = MODERN
    modern = U.stage_modern(Staging(dev), _encoded(E.encode_modern, rng, mh, mw), mw, mh)
    lh, lw = LEGACY
    legacy = L.stage_legacy(Staging(dev), _encoded(E.encode_legacy, rng, lh, lw), lw, lh)
    raw = torch.from_numpy(_image(rng, *DEVELOP)).to(dev)
    ring = torch.from_numpy(_image(rng, *DEVELOP_RING)).to(dev)
    params = D.pack_develop_params(*DEVELOP_PARAMS)
    batch = torch.from_numpy(_image(rng, DEVELOP_ROWS[0] * DEVELOP_ROWS[1], DEVELOP_ROWS[2])
                             .reshape(DEVELOP_ROWS)).to(dev)
    rows, cfas = _frame_rows(DEVELOP_ROWS[0], dev)
    x = torch.from_numpy(_image(rng, 256, 256)).to(dev)
    bits = torch.from_numpy(rng.integers(0, 1 << 16, size=OFFSETS_BLOCKS, dtype=np.uint16))
    bits = bits.to(dev)
    last = int(U.block_offsets(modern.bits, modern_tables(dev))[0, -1])
    cuts = {("unpack_modern", "words"): 4 * modern.words.numel() - last // 16 * 16,
            ("develop", "params"): params.nbytes - 64,
            ("develop", "rows"): rows.nbytes - 4 * ((len(rows) - 1) * rows.shape[1] + 16)}
    return {
        "unpack_modern": ("unpack_modern", lambda: U.unpack_modern(modern, mw, mh)),
        "unpack_legacy": ("unpack_legacy", lambda: L.unpack_legacy(legacy, lw, lh)),
        "develop": ("develop", lambda: D.develop_rgba_device(raw, params, cfa=BGGR)),
        "develop ring": ("develop", lambda: D.develop_rgba_device(ring, params, cfa=BGGR)),
        "develop rows": ("develop", lambda: D.develop_rgba_device(batch, rows, cfa=cfas)),
        "checksum": ("checksum", lambda: C.device_checksum(x)),
        "block_offsets": ("block_offsets", lambda: O.block_offsets_device(bits)),
    }, cuts


def clean_cases(dev) -> list[tuple[str, str, Callable[[], torch.Tensor]]]:
    """(name, kernel, call) for every entry point on clean inputs, each at
    the edges its kernel handles: unaligned and odd sizes, batches with a
    frame whose offsets point past its own end."""
    rng = np.random.default_rng(SEED)
    cases = [(f"negative-case input: {name}", kernel, fn)
             for name, (kernel, fn) in _inputs(dev)[0].items()]
    mh, mw = MODERN
    payloads = [_encoded(E.encode_modern, rng, mh, mw) for _ in range(3)]
    cases.append(("modern batch, 3 encoded frames", "unpack_modern",
                  lambda: U.decode_modern_batch(payloads, mw, mh, Staging(dev))))
    for past_end in (False, True):
        cases.append((f"modern batch, synthetic{', past its end' * past_end}",
                      "unpack_modern", _modern_batch(rng, dev, past_end)))
    lh, lw = LEGACY
    lpayloads = [_encoded(E.encode_legacy, rng, lh, lw) for _ in range(3)]
    cases.append(("legacy batch, 3 encoded frames", "unpack_legacy",
                  lambda: L.decode_legacy_batch(lpayloads, lw, lh, Staging(dev))))
    for past_end in (False, True):
        cases.append((f"legacy batch, synthetic{', past its end' * past_end}",
                      "unpack_legacy", _legacy_batch(rng, dev, past_end)))
    single = batch_of_one(*_legacy_synthetic(rng, *LEGACY, dev, True))
    cases.append(("legacy frame, past its end", "unpack_legacy",
                  lambda: L.decode_legacy_batch_device(*single, height=lh, width=lw)))
    params = D.pack_develop_params(*DEVELOP_PARAMS)
    frames = torch.from_numpy(_image(rng, 3 * 5, 250).reshape(3, 5, 250)).to(dev)
    ring = torch.from_numpy(_image(rng, 3 * 66, 1024).reshape(3, 66, 1024)).to(dev)
    rows, cfas = _frame_rows(4, dev)
    ragged = torch.from_numpy(_image(rng, 4 * 5, 250).reshape(4, 5, 250)).to(dev)
    boxes = torch.from_numpy(_image(rng, 4 * 66, 1024).reshape(4, 66, 1024)).to(dev)
    for demosaic in D.DEMOSAICS:
        cases.append((f"develop rows (4, 5, 250) {demosaic}", "develop",
                      lambda m=demosaic: D.develop_rgba_device(ragged, rows, cfa=cfas,
                                                               demosaic=m)))
        cases.append((f"develop rows ring (4, 66, 1024) {demosaic}", "develop",
                      lambda m=demosaic: D.develop_rgba_device(boxes, rows, cfa=cfas,
                                                               demosaic=m)))
    for demosaic in D.DEMOSAICS:
        cases.append((f"develop (3, 5, 250) {demosaic}", "develop",
                      lambda m=demosaic: D.develop_rgba_device(frames, params, cfa=BGGR,
                                                               demosaic=m)))
        cases.append((f"develop ring (3, 66, 1024) {demosaic}", "develop",
                      lambda m=demosaic: D.develop_rgba_device(ring, params, cfa=BGGR,
                                                               demosaic=m)))
    words = torch.from_numpy(rng.integers(0, 1 << 16, size=4099, dtype=np.uint16)).to(dev)
    for start, n in ((1, 17), (3, 4096), (0, 4099)):
        cases.append((f"checksum uint16[{start}:{start + n}]", "checksum",
                      lambda s=start, k=n: C.device_checksum(words[s : s + k])))
    for what, shape, hi in (("one block", (1,), 1 << 16), ("a tile less one", (4095,), 17),
                            ("a tile and one, all 0", (4097,), 1),
                            ("(3, 4097), all >= 16", (3, 4097), None),
                            ("(1, 8192)", (1, 8192), 1 << 16),
                            ("(2, 5000)", (2, 5000), 1 << 16)):
        b = (rng.integers(16, 1 << 16, size=shape, dtype=np.uint16) if hi is None
             else rng.integers(0, hi, size=shape, dtype=np.uint16))
        b = torch.from_numpy(b).to(dev)
        cases.append((f"block offsets {what}", "block_offsets",
                      lambda b=b: O.block_offsets_device(b)))
    odd = torch.from_numpy(rng.integers(0, 1 << 16, size=4100, dtype=np.uint16)).to(dev)
    cases.append(("block offsets uint16[1:4100], off 16 bytes", "block_offsets",
                  lambda: O.block_offsets_device(odd[1:])))
    return cases


def negative(dev) -> tuple[list, dict, list]:
    """The :data:`NEGATIVE` cases on the checked build: one row each, the
    kinds that fired by kernel, and what did not fire on its buffer and
    kind."""
    rows, fired, problems = [], {}, []
    inputs, cuts = _inputs(dev)
    for kernel, kind, buf, cut in NEGATIVE:
        cut = cuts[kernel, buf] if cut is None else cut
        row = {"kernel": kernel, "kind": kind, "buffer": buf, "bytes_cut": cut, "fired": False}
        launch = inputs["develop ring" if (kernel, kind, buf) in RING_NEGATIVE else
                        "develop rows" if (kernel, kind, buf) in ROWS_NEGATIVE else kernel][1]
        try:
            with build.understate(kernel, **{buf: cut}):
                launch()
        except build.CheckedFault as e:
            row.update(fired=e.counts[kind] > 0 and e.buffer == buf, named=e.buffer,
                       counts=e.counts, text=str(e))
        rows.append(row)
        if row["fired"]:
            fired.setdefault(kernel, []).append(kind)
        else:
            problems.append(f"{kernel} {kind} on {buf}: did not fire ({row})")
    return rows, fired, problems


def windows(dev) -> tuple[dict, list]:
    """The :data:`WINDOWS` batches on the checked build: by kernel, the
    cross-frame reads of the batch with a frame past its own end (0) and
    of the batch with every window cut short (more than 0); and what is
    off."""
    out, problems = {}, []
    for kernel, cut in WINDOWS.items():
        batch = _modern_batch if kernel == "unpack_modern" else _legacy_batch
        rng = np.random.default_rng([SEED, 2])
        before = build.CHECKED["cross_frame_reads"][kernel]
        batch(rng, dev, True)()
        past_end = build.CHECKED["cross_frame_reads"][kernel] - before
        with build.understate(kernel, window=cut):
            batch(rng, dev, False)()
        trimmed = build.CHECKED["cross_frame_reads"][kernel] - before - past_end
        out[kernel] = {"past_end_cross_frame_reads": past_end, "window_cut": cut,
                       "cut_cross_frame_reads": trimmed}
        if past_end != 0 or trimmed <= 0:
            problems.append(f"{kernel} windows: {out[kernel]}")
    return out, problems


def counts() -> dict:
    """The checked launches, faults and cross-frame reads by kernel so far."""
    return {k: dict(build.CHECKED[k]) for k in ("launches", "faults", "cross_frame_reads")}


def run(dev) -> dict:
    """Everything of this module's docstring in this process, on the
    checked build: its result, and `problems` (empty when all holds)."""
    path = build.use_checked()
    problems = []
    clean = {}
    for name, _kernel, fn in clean_cases(dev):
        try:
            clean[name] = digest(fn())
        except build.CheckedFault as e:
            problems.append(f"{name}: {e}")
    result = {"library": path.name, "clean": clean, **counts()}
    if any(result["faults"].values()):
        problems.append(f"clean launches faulted: {result['faults']}")
    result["negative"], result["fired"], more = negative(dev)
    result["windows"], most = windows(dev)
    return {**result, "problems": problems + more + most}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mcraw_torch.bounds")
    ap.add_argument("--device", default="cuda", help="a CUDA device (the default: cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type != "cuda":
        ap.error("the checked build runs on a card: --device must be a CUDA device")
    result = run(dev)
    print(json.dumps(result), flush=True)
    return 1 if result["problems"] else 0


if __name__ == "__main__":
    sys.exit(main())
