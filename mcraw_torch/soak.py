"""A standing differential soak of every decode path of the port, and a
parity grid on the card.

    python -m mcraw_torch.soak [--device cuda|cpu] [--seconds S] [--seed N]
        [--legs codec,mutation,malformed,container,json] [--iterations N]
        [--failures DIR] [--checked]
    python -m mcraw_torch.soak --grid [--quick] [--device cuda|cpu] [--out FILE]

The legs (each in a child process of its own, all at once):

- ``codec``: canonical encodes at random geometries and contents, the draws
  of the JAX package's differential soak (``tools/soak_differential.py``).
- ``mutation``: format-legal noncanonical payloads (refs below the block
  minimum, wrap-around refs, over-wide bit nibbles 12-15, junk gaps before
  the streams, junk stream tails, over-declared and non-multiple-of-4
  encoded geometry) alternating with phone-firmware coders, the draws of
  ``tools/soak_mutation.py``.
- ``malformed``: the same payloads, then one mutation of each codec's frame:
  a random truncation, 1-5 byte flips, the four header edits of the modern
  codec, an encodedHeight below the height, a declared stream count that is
  not a multiple of 64, bits values above 16 written into the bits stream.
- ``container`` and ``json``: the CLI legs of :mod:`mcraw_torch.soak_cli`,
  byte parity with ``python -m mcraw ... --backend numpy``.

Each iteration writes a clip of both codecs' frames (the case's frame and
1-3 more of its geometry, each its own draw) and drives it through every
decode path on ``--device``: ``decode_modern`` / ``decode_legacy``, one
Decoder's ``load_frame_device``, ``decode_batch``, ``make_frame_decoder()``
and ``load_frame_sharded`` over a mesh of 1-4 repeats of the device, and
every tenth iteration ``decode_batch_iter`` over the whole (mixed) clip. The
oracles are the source image, where the payload is format-legal, and the
port's plain CPU path: ``decode_*(..., device="cpu")`` for the codecs and
the same Decoder path on a CPU Decoder. Every path gives the plain path's
outcome: the same array element for element, or the same exception class
and text. On a card each result's ``device_checksum`` equals the host's
sum, the codec's kernel launched and no plain version ran, and a path that
raises launched nothing. In the malformed leg a known-good frame decodes
exactly on the same Decoder after each malformed case.

A failure writes a reproducer ``.npz`` into ``--failures`` (clip, payloads,
geometry, codec, leg, seed, iteration, path). A child that dies is a CRASH
row with its leg, seed, iteration and path, and its case is kept the same
way. One JSON line per leg; the exit code is 1 on any failure or crash.
``--inject wrong`` (one pixel of every ``load_frame_device`` result
flipped) and ``--inject crash`` (each child kills itself at its first
path) show that the soak reports both.

``--checked`` runs every leg's launches on the checked build of the kernels
(``kernels/build.py::use_checked``: every global and shared access held to
its buffer's extent, each launch waited for, a fault raised as the path's
outcome, so a failure). Each leg's line names the library that ran and,
checked, its launches, faults and batch reads outside a frame's own window
by kernel. It needs a card: ``--checked --device cpu`` exits 2.

``--grid`` runs the parity grid, one child process per case: five
geometries x five contents x both codecs (``tools/hw_parity.py``'s), each
frame through the six paths and ``export_clip`` and checked by device
checksum against its source, and the develop of the small geometries and of
one 4K case in both demosaics within 1 LSB of ``preview.develop_f64``. It
writes one row per case, with the card's name and power limit, to ``--out``
(default ``mcraw_torch/hw_parity_h100.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import struct
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import codecs
from . import encode as E
from . import parallel as PAR
from .container import COMPRESSION_TYPE
from .kernels import build
from .kernels import checksum as C
from .kernels import legacy as L
from .kernels import native
from .kernels import offsets as O
from .kernels.staging import SHARE_GEOMETRY
from .kernels import unpack as U
from .metadata import example_container_metadata, example_frame_metadata
from .pipeline import Decoder, _modern_payload_rows, resolve_device

DECODE_LEGS = ("codec", "mutation", "malformed")
CLI_LEGS = ("container", "json")
LEGS = DECODE_LEGS + CLI_LEGS
PATHS = ("codecs", "load_frame_device", "decode_batch", "frame_decoder",
         "load_frame_sharded", "decode_batch_iter")
COUNTED = {"unpack_modern": U, "unpack_legacy": L, "checksum": C, "block_offsets": O}
UNPACK = {7: "unpack_modern", 6: "unpack_legacy"}
MAX_REPRODUCERS = 20  # a leg keeps the first reproducers, counts the rest

# -- the generators: copies of tools/soak_*.py, same draws in the same order ----


def random_image(rng, h, w):
    """Content engineered to hit every block class: per-region bit depth
    (tools/soak_differential.py:26-58)."""
    kind = rng.integers(0, 5)
    if kind == 0:  # constant (bits=0 blocks + pure reference offsets)
        return np.full((h, w), int(rng.integers(0, 1 << 16)), np.uint16)
    if kind == 1:  # full-range noise (all-16-bit blocks)
        return rng.integers(0, 1 << 16, size=(h, w), dtype=np.uint16)
    if kind == 2:  # low-entropy gradient + noise (small bits classes)
        base = (
            np.linspace(0, int(rng.integers(16, 4096)), w)[None, :]
            + np.linspace(0, int(rng.integers(16, 512)), h)[:, None]
        )
        noise = rng.normal(0, float(rng.uniform(0.1, 30)), size=(h, w))
        return (base + noise).clip(0, 65535).astype(np.uint16)
    if kind == 3:  # per-band bit depth stripes (mixes classes in one frame)
        img = np.zeros((h, w), np.uint16)
        y = 0
        while y < h:
            band = int(rng.integers(4, 33))
            bits = int(rng.integers(0, 17))
            hi = (1 << bits) if bits else 1
            img[y : y + band] = rng.integers(
                0, hi, size=(min(band, h - y), w), dtype=np.uint16
            )
            y += band
        return img
    # kind == 4: sparse impulses over a flat field (tiny bits + big refs)
    img = np.full((h, w), int(rng.integers(0, 60000)), np.uint16)
    n = int(rng.integers(1, 1 + h * w // 64))
    ys = rng.integers(0, h, n)
    xs = rng.integers(0, w, n)
    img[ys, xs] = rng.integers(0, 1 << 16, size=n, dtype=np.uint16)
    return img


def make_coder(rng, *, cap_bits, cap_ref, wrap_ok):
    """Random valid (bits, refs) chooser for encode.py's _coded contract
    (tools/soak_mutation.py:49-74)."""

    def coder(blocks, ref_max):
        n = len(blocks)
        mins = np.minimum(blocks.min(axis=1), cap_ref)
        kind = rng.integers(0, 3, size=n)
        refs = rng.integers(0, mins + 1)  # <= min: no wraparound needed
        refs = np.where(kind == 0, 0, refs)  # stress ref=0
        if wrap_ok:
            # Arbitrary refs under a 16-bit class: resid wraps mod 2^16.
            refs = np.where(
                kind == 2, rng.integers(0, cap_ref + 1, size=n), refs
            )
        resid = (blocks - refs[:, None]) & 0xFFFF
        needed = np.array(
            [int(x).bit_length() for x in resid.max(axis=1)]
        )
        lo = np.where(needed <= 10, needed, 11)
        bits = rng.integers(lo, cap_bits + 1)
        # Anything needing >10 bits (incl. wraparound picks) must use a
        # 16-bit class (nibbles/values 11..cap_bits).
        bits = np.where(needed > 10, np.maximum(bits, 11), bits)
        return bits, refs

    return coder


def bayer_scene(rng, h, w):
    """Phone-sensor-like content (tools/soak_mutation.py:83-124): 2x2
    CFA-periodic channel means, a smooth illumination gradient,
    level-scaled shot noise, deep shadows and saturating highlights."""
    depth = int(rng.choice([10, 12, 14]))
    white = (1 << depth) - 1
    black = int(rng.integers(0, 260))
    # Illumination: product of two smooth 1-D profiles + a tilt.
    gy = np.interp(
        np.arange(h), [0, h - 1], rng.uniform(0.05, 1.0, 2)
    )[:, None]
    gx = np.interp(
        np.arange(w), [0, w - 1], rng.uniform(0.05, 1.0, 2)
    )[None, :]
    lum = gy * gx
    # CFA gains: G sites ~unity, R/B lower.
    gains = np.array(
        [
            [rng.uniform(0.35, 0.7), 1.0],
            [1.0, rng.uniform(0.35, 0.7)],
        ]
    )
    cfa_gain = np.tile(gains, ((h + 1) // 2, (w + 1) // 2))[:h, :w]
    sig = lum * cfa_gain * white * rng.uniform(0.1, 0.9)
    # Shot noise ~ sqrt(signal), plus read noise.
    img = sig + rng.normal(0, 1, (h, w)) * (
        np.sqrt(np.maximum(sig, 0)) * 0.8 + 2.0
    )
    # Specular highlights: a few saturating blobs.
    for _ in range(int(rng.integers(0, 4))):
        cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
        r = int(rng.integers(2, 12))
        yy, xx = np.ogrid[:h, :w]
        img = np.where(
            (yy - cy) ** 2 + (xx - cx) ** 2 < r * r, float(white), img
        )
    return (img + black).clip(0, white).astype(np.uint16)


def make_phone_coder(rng, *, legacy):
    """Conservative encoder heuristics phone firmware plausibly uses
    (tools/soak_mutation.py:127-155): ref = block min, bits rounded up to a
    coarse class set, or one class per row of blocks, or a headroom bit."""
    coarse = np.array([0, 1, 2, 4, 6, 8, 10, 16], dtype=np.int64)
    style = int(rng.integers(0, 3))
    row_blocks = int(rng.choice([8, 16, 32, 64]))

    def coder(blocks, ref_max):
        n = len(blocks)
        refs = np.minimum(blocks.min(axis=1), ref_max)
        resid = (blocks - refs[:, None]) & 0xFFFF
        needed = np.array(
            [int(x).bit_length() for x in resid.max(axis=1)]
        )
        if style == 0:  # round up to a coarse class set
            bits = coarse[np.searchsorted(coarse, needed)]
        elif style == 1:  # one class per row-of-blocks stripe
            bits = needed.copy()
            for s in range(0, n, row_blocks):
                bits[s : s + row_blocks] = bits[s : s + row_blocks].max()
        else:  # fixed headroom bit (never risk the tight class)
            bits = np.where((needed > 0) & (needed < 16), needed + 1, needed)
        bits = np.where(needed > 10, np.maximum(bits, 11), bits)
        cap = 15 if legacy else 16
        return np.minimum(bits, cap), refs

    return coder


def legacy_layout(rng, h: int) -> tuple[bool, int | None]:
    """The legacy chunk table and chunk height (tools/soak_differential.py
    :132-135, tools/soak_mutation.py:256-259)."""
    table = bool(rng.integers(0, 2))
    crows = None if rng.integers(0, 2) else int(rng.integers(1, h + 4))
    return table, crows


@dataclass
class Frame:
    """One frame of a case: `source` is the image its payload decodes to
    exactly (None where the payload is malformed)."""

    codec: int
    payload: bytes
    width: int
    height: int
    source: np.ndarray | None
    what: str = ""

    @property
    def data(self) -> np.ndarray:
        return np.frombuffer(self.payload, np.uint8)


class Case(NamedTuple):
    """An iteration's frame of one codec, and `encode(rng, image)`: an
    image of its geometry encoded with the case's encoded geometry and
    flavour, each coder drawn from `rng` (the extras of its batch)."""

    frame: Frame
    encode: Callable


def codec_case(rng) -> tuple[Case, Case]:
    """One iteration of tools/soak_differential.py:82-89 and :132-141:
    canonical modern and legacy encodes of one random image."""
    h = int(rng.integers(4, 200)) & ~3 or 4
    w = int(rng.integers(16, 700))
    img = random_image(rng, h, w)
    ew = (w + 63) // 64 * 64 + 64 * int(rng.integers(0, 3))
    eh = (h + 3) // 4 * 4 + 4 * int(rng.integers(0, 3))
    modern = E.encode_modern(img, encoded_width=ew, encoded_height=eh)
    table, crows = legacy_layout(rng, h)
    legacy = E.encode_legacy(img, chunk_rows=crows, add_offset_table=table)

    def extra7(aux, x):
        return E.encode_modern(x, encoded_width=ew, encoded_height=eh)

    def extra6(aux, x):
        t, c = legacy_layout(aux, h)
        return E.encode_legacy(x, chunk_rows=c, add_offset_table=t)

    return (Case(Frame(7, modern, w, h, img, "canonical"), extra7),
            Case(Frame(6, legacy, w, h, img, "canonical"), extra6))


def mutation_case(rng, iteration: int) -> tuple[Case, Case]:
    """One iteration of tools/soak_mutation.py:177-266 (1-based
    `iteration`): phone-firmware flavour on even iterations, noncanonical
    payloads on odd ones."""
    h = int(rng.integers(4, 120)) & ~3 or 4
    w = int(rng.integers(16, 500))
    phone = iteration % 2 == 0
    if phone:
        img = bayer_scene(rng, h, w)
        pitch = int(rng.choice([64, 128, 256, 512]))
        ew = -(-w // pitch) * pitch
        rowg = int(rng.choice([4, 8, 16, 32]))
        eh = -(-h // rowg) * rowg
        gaps = (b"", b"")
        meta_tail = None
        main_coder = make_phone_coder(rng, legacy=False)
        meta_coder = None
    else:
        img = random_image(rng, h, w)
        ew = (w + 63) // 64 * 64 + 64 * int(rng.integers(0, 3))
        # encodedHeight: any value >= h, incl. non-multiples of 4.
        eh = h + int(rng.integers(0, 9))
        gaps = (
            rng.bytes(int(rng.integers(0, 64))),
            rng.bytes(int(rng.integers(0, 64))),
        )
        meta_tail = rng.integers(
            0, 1 << 16, size=int(rng.integers(0, 64)), dtype=np.uint16
        )
        main_coder = make_coder(rng, cap_bits=16, cap_ref=0xFFFF, wrap_ok=True)
        meta_coder = make_coder(rng, cap_bits=15, cap_ref=0x0FFF, wrap_ok=True)
    modern = E.encode_modern(img, encoded_width=ew, encoded_height=eh, coder=main_coder,
                             meta_coder=meta_coder, meta_tail=meta_tail, gaps=gaps)
    leg_coder = (make_phone_coder(rng, legacy=True) if phone
                 else make_coder(rng, cap_bits=15, cap_ref=0x0FFF, wrap_ok=True))
    table, crows = legacy_layout(rng, h)
    legacy = E.encode_legacy(img, chunk_rows=crows, add_offset_table=table, coder=leg_coder)
    flavour = "phone" if phone else "noncanonical"

    def extra7(aux, x):
        if phone:
            return E.encode_modern(x, encoded_width=ew, encoded_height=eh,
                                   coder=make_phone_coder(aux, legacy=False))
        return E.encode_modern(
            x, encoded_width=ew, encoded_height=eh,
            coder=make_coder(aux, cap_bits=16, cap_ref=0xFFFF, wrap_ok=True),
            meta_coder=make_coder(aux, cap_bits=15, cap_ref=0x0FFF, wrap_ok=True),
            meta_tail=aux.integers(0, 1 << 16, size=int(aux.integers(0, 64)), dtype=np.uint16),
            gaps=(aux.bytes(int(aux.integers(0, 64))), aux.bytes(int(aux.integers(0, 64)))))

    def extra6(aux, x):
        coder = (make_phone_coder(aux, legacy=True) if phone
                 else make_coder(aux, cap_bits=15, cap_ref=0x0FFF, wrap_ok=True))
        t, c = legacy_layout(aux, h)
        return E.encode_legacy(x, chunk_rows=c, add_offset_table=t, coder=coder)

    return (Case(Frame(7, modern, w, h, img, flavour), extra7),
            Case(Frame(6, legacy, w, h, img, flavour), extra6))


# -- the malformed payloads -----------------------------------------------------

MODERN_MALFORMED = ("truncate", "flip", "bits_off", "refs_off", "enc_w_mod", "enc_w_small",
                    "enc_h_short", "declared_count", "bits_over_16")
LEGACY_MALFORMED = ("truncate", "flip")


def truncate(rng, payload: bytes) -> bytes:
    return payload[: int(rng.integers(0, len(payload)))]


def flip(rng, payload: bytes) -> bytes:
    """1-5 bytes each xor'ed with a nonzero byte."""
    p = bytearray(payload)
    for _ in range(int(rng.integers(1, 6))):
        i = int(rng.integers(0, len(p)))
        p[i] ^= int(rng.integers(1, 256))
    return bytes(p)


def with_header(payload: bytes, **fields) -> bytes:
    """The modern payload with header fields (ew, eh, bits_off, refs_off)
    replaced."""
    head = dict(zip(("ew", "eh", "bits_off", "refs_off"), struct.unpack("<IIII", payload[:16])))
    head.update(fields)
    return struct.pack("<IIII", *head.values()) + payload[16:]


def with_bits_over_16(rng, payload: bytes) -> tuple[bytes, bool]:
    """The modern payload with 1-8 entries of its bits stream (among the
    frame's blocks) set to values 17..65535, the stream re-encoded; and
    whether every entry changed was already of the 16-bit class (so the
    frame still decodes exactly: bits clamp to 16)."""
    data = np.frombuffer(payload, dtype=np.uint8)
    ew, eh, bits_off, refs_off = struct.unpack("<IIII", payload[:16])
    bits, _ = native.decode_metadata_stream(data, bits_off)
    nblk = 4 * ((eh + 3) // 4) * (ew // 64)
    idx = rng.integers(0, min(nblk, len(bits)), size=int(rng.integers(1, 9)))
    exact = bool(np.all(bits[idx] >= 11))
    bits = bits.copy()
    bits[idx] = rng.integers(17, 1 << 16, size=len(idx))
    stream, _, _ = E._encode_value_stream(bits)
    count = payload[bits_off : bits_off + 4]
    head = struct.pack("<IIII", ew, eh, bits_off, bits_off + 4 + len(stream))
    return head + payload[16:bits_off] + count + stream + payload[refs_off:], exact


def malform(rng, frame: Frame, ew: int, eh: int) -> Frame:
    """One malformed variant of a case's frame (see the module docstring);
    its source stays only where the payload still decodes to it exactly."""
    kinds = MODERN_MALFORMED if frame.codec == 7 else LEGACY_MALFORMED
    kind = kinds[int(rng.integers(0, len(kinds)))]
    p, src = frame.payload, None
    if kind == "truncate":
        p = truncate(rng, p)
    elif kind == "flip":
        p = flip(rng, p)
    elif kind in ("bits_off", "refs_off"):
        p = with_header(p, **{kind: len(p) + 1})
    elif kind == "enc_w_mod":
        p = with_header(p, ew=ew + 3)
    elif kind == "enc_w_small":
        p = with_header(p, ew=64)
    elif kind == "enc_h_short":
        p = with_header(p, eh=int(rng.integers(0, frame.height)))
    elif kind == "declared_count":
        # The streams hold ceil(nblk / 64) groups: a count from nblk up to
        # those groups decodes exactly (the tail group is padded and
        # cropped); fewer than nblk, or more groups than the stream has,
        # fail on the host.
        nblk = 4 * ((eh + 3) // 4) * (ew // 64)
        groups = -(-nblk // 64)
        if rng.integers(0, 2):  # one that decodes, where there is one
            count = int(rng.integers(nblk, 64 * groups + 1))
        else:
            count = int(rng.integers(max(nblk - 64, 1), 64 * groups + 64))
        count += count % 64 == 0
        p = E.encode_modern(frame.source, encoded_width=ew, encoded_height=eh,
                            declared_count=count)
        src = frame.source if nblk <= count <= 64 * groups else None
    else:
        p, exact = with_bits_over_16(rng, p)
        src = frame.source if exact else None
    return Frame(frame.codec, p, frame.width, frame.height, src, kind)


def encoded_geometry(frame: Frame) -> tuple[int, int]:
    """(encodedWidth, encodedHeight) of a modern frame's payload."""
    return struct.unpack("<II", frame.payload[:8])


# -- outcomes -----------------------------------------------------------------------


class Outcome(NamedTuple):
    """What a path gave: its frames on the host (a sharded frame as one
    array), or an exception's class and text."""

    arrays: tuple | None
    error: tuple[str, str] | None

    def same(self, other: "Outcome") -> bool:
        if self.error or other.error:
            return self.error == other.error
        return len(self.arrays) == len(other.arrays) and all(
            a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(self.arrays, other.arrays))

    def describe(self) -> str:
        if self.error:
            return f"{self.error[0]}({self.error[1]!r})"
        return "arrays " + ", ".join(f"{a.dtype} {a.shape}" for a in self.arrays)


def caught(fn) -> tuple[object, tuple[str, str] | None]:
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 - an exception is an outcome here
        return None, (type(e).__name__, str(e))


def host_sum(a: np.ndarray) -> int:
    return int(a.astype(np.int64).sum() & 0xFFFFFFFF)


def counts() -> dict:
    return {k: (m.KERNEL_LAUNCHES, m.PLAIN_CALLS) for k, m in COUNTED.items()}


def uncompress_error(codec: int) -> tuple[str, str]:
    """The Decoder's error for a frame its codec rejects."""
    return ("IOException", "Failed to uncompress frame" if codec == COMPRESSION_TYPE
            else "Failed to uncompress legacy frame")


def decoder_expect(frame: Frame, plain: Outcome) -> Outcome:
    """What a Decoder's single-frame path gives for a frame whose codec
    function gave `plain`: its error as the reference's outer text, and a
    modern frame of no encoded rows fails the same way."""
    if plain.error or (frame.codec == 7 and _modern_payload_rows(frame.data) == 0):
        return Outcome(None, uncompress_error(frame.codec))
    return plain


def rows_written(frame: Frame) -> int:
    if frame.codec == 7:
        return min(frame.height, _modern_payload_rows(frame.data))
    return frame.height


def write_clip(frames: list) -> tuple[bytes, list]:
    """A container of `frames` (timestamps 1000, 1001, ...); its
    timestamps."""
    writer = E.ContainerWriter(example_container_metadata())
    stamps = []
    for i, f in enumerate(frames):
        writer.add_frame(1000 + i, f.payload, example_frame_metadata(f.width, f.height, f.codec))
        stamps.append(1000 + i)
    return writer.finish(), stamps


# -- one leg ----------------------------------------------------------------------


def encoded_tiles(frame: Frame) -> tuple[int, int] | None:
    """The (tiles_y, tiles_x) a batch of modern frames must share; None for
    the legacy codec, whose batches need only the same (width, height), and
    for a modern payload too short to hold its encoded geometry (a
    truncation; such a frame raises on its own)."""
    if frame.codec != 7 or len(frame.payload) < 8:
        return None
    ew, eh = encoded_geometry(frame)
    return -(-eh // 4), ew // 64


class Leg:
    """One decode leg on one device: its iterations, checks and tallies."""

    def __init__(self, leg: str, seed: int, device, failures: Path, inject: str | None = None):
        self.leg, self.seed = leg, seed
        self.dev = resolve_device(device)
        self.on_card = self.dev.type == "cuda"
        self.failures_dir = failures
        self.rng = np.random.default_rng(seed)
        self.aux = np.random.default_rng([seed, 1])  # extras, meshes, chunks
        self.iteration = 0
        self.failures = 0
        self.reproducers = 0
        self.launches: Counter = Counter()
        self.plain: Counter = Counter()
        self.paths: dict = {p: Counter() for p in PATHS}
        self.inject = inject
        self.good = self._good_frames() if leg == "malformed" else []
        # The iteration's clip, its frames and their plain outcomes by
        # timestamp, and a CPU Decoder of the clip where one is needed.
        self.clip = b""
        self.frames: dict = {}
        self.outcomes: dict = {}
        self._mirror = None

    def _good_frames(self) -> list:
        """The known-good frames decoded after each malformed case: one of
        each codec at 16 x 192."""
        img = np.random.default_rng([self.seed, 2]).integers(0, 4096, (16, 192), np.uint16)
        return [Frame(7, E.encode_modern(img), 192, 16, img, "good"),
                Frame(6, E.encode_legacy(img), 192, 16, img, "good")]

    # -- the cases

    def cases(self) -> tuple[Case, Case]:
        it = self.iteration
        if self.leg == "codec":
            return codec_case(self.rng)
        if self.leg == "mutation":
            return mutation_case(self.rng, it)
        # Canonical, noncanonical and phone-firmware payloads in turn.
        base = codec_case(self.rng) if it % 3 == 0 else mutation_case(self.rng, it % 3)
        out = []
        for case in base:
            f = case.frame
            ew, eh = encoded_geometry(f) if f.codec == 7 else (0, 0)
            out.append(Case(malform(self.rng, f, ew, eh), case.encode))
        return tuple(out)

    def with_extras(self, case: Case) -> list:
        """The case's frame and 0-3 more of its geometry, each its own
        image and coder draw (so the payload lengths differ)."""
        f = case.frame
        frames = [f]
        for _ in range(int(self.aux.integers(0, 4))):
            x = (bayer_scene(self.aux, f.height, f.width) if f.what == "phone"
                 else random_image(self.aux, f.height, f.width))
            frames.append(Frame(f.codec, case.encode(self.aux, x), f.width, f.height, x, "extra"))
        return frames

    # -- one iteration

    def step(self) -> None:
        self.iteration += 1
        groups = [self.with_extras(c) for c in self.cases()]
        frames = [f for g in groups for f in g] + self.good
        self.clip, stamps = write_clip(frames)
        self._inflight(frames)
        self.frames = dict(zip(stamps, frames))
        self.outcomes = {ts: self._plain(f) for ts, f in self.frames.items()}
        self._mirror = None
        for ts, f in self.frames.items():
            if f.source is not None and not Outcome((f.source,), None).same(self.outcomes[ts]):
                self.fail("plain", [ts], f"plain {self.outcomes[ts].describe()} != source")
        dec = Decoder(self.clip, self.dev)
        good = stamps[len(stamps) - len(self.good):] if self.good else []
        i = 0
        for g in groups:
            self.drive_group(dec, stamps[i : i + len(g)])
            i += len(g)
            for ts in good:  # the context and the kept stagings survived
                self.drive_single(dec, ts)
        if self.iteration % 10 == 1:
            k = int(self.aux.integers(1, 5))
            self.run(dec, "decode_batch_iter", stamps,
                     lambda d: [img for imgs, _ in d.decode_batch_iter(chunk_frames=k)
                                for img in imgs],
                     batches=self.runs(stamps, k), launches_on_error=True)
        dec.close()
        if self._mirror is not None:
            self._mirror.close()

    def drive_single(self, dec: Decoder, ts: int) -> None:
        """One frame through the codec function on the device's kept staging
        and through the Decoder's single-frame path."""
        f = self.frames[ts]
        decode = codecs.decode_modern if f.codec == 7 else codecs.decode_legacy
        self.run(None, "codecs", [ts],
                 lambda _: [torch.from_numpy(decode(f.data, f.width, f.height, device=self.dev))],
                 expect=self.outcomes[ts])
        self.run(dec, "load_frame_device", [ts], lambda d: [self._single(d, ts)])

    def drive_group(self, dec: Decoder, ts: list) -> None:
        """The case's frame through every single-frame path, and with its
        extras through the batch and the frame decoder."""
        t0, f0 = ts[0], self.frames[ts[0]]
        self.drive_single(dec, t0)
        self.run(dec, "decode_batch", ts, lambda d: list(d.decode_batch(ts)[0]), batches=[ts])

        def frame_decoder(d):
            fd = d.make_frame_decoder()
            return [fd(t)[0] for t in ts]

        self.run(dec, "frame_decoder", ts, frame_decoder)
        rows = -(-f0.height // 4) if f0.codec == 7 else f0.height
        n = min(int(self.aux.integers(1, 5)), rows)
        self.run(dec, "load_frame_sharded", [t0],
                 lambda d: list(d.load_frame_sharded(t0, PAR.Mesh((d.device,) * n))[0].shards),
                 sharded=True)

    def _single(self, d: Decoder, ts: int) -> torch.Tensor:
        img = d.load_frame_device(ts)[0]
        if self.inject == "wrong" and img.numel():
            img = img.clone()
            img.view(-1)[0] = int(img.view(-1)[0]) ^ 1
        return img

    @staticmethod
    def _plain(f: Frame) -> Outcome:
        decode = codecs.decode_modern if f.codec == 7 else codecs.decode_legacy
        arr, err = caught(lambda: decode(f.data, f.width, f.height, device="cpu"))
        return Outcome(None if err else (arr,), err)

    def runs(self, stamps: list, chunk: int) -> list:
        """The batches of ``decode_batch_iter(chunk_frames=chunk)``: each
        chunk's runs of one (codec, width, height)."""
        out = []
        for lo in range(0, len(stamps), chunk):
            key = None
            for t in stamps[lo : lo + chunk]:
                f = self.frames[t]
                if (f.codec, f.width, f.height) != key:
                    out.append([])
                    key = (f.codec, f.width, f.height)
                out[-1].append(t)
        return out

    def run(self, dec, path: str, stamps: list, fn, *, expect: Outcome | None = None,
            sharded=False, batches=(), launches_on_error=False) -> None:
        """Drive `fn(decoder)` -> list of tensors on the leg's device and
        hold it against the plain outcome; the checks of the module
        docstring."""
        at(self.iteration, path, self.inject)
        before = counts()
        got, err = caught(lambda: self._host(fn(dec)))
        after = counts()
        out = Outcome(None, err) if err else Outcome(self._join(got[0], sharded), None)
        delta = {k: (after[k][0] - before[k][0], after[k][1] - before[k][1]) for k in COUNTED}
        for k, (n, p) in delta.items():
            self.launches[k] += n
            self.plain[k] += p
        frames = [self.frames[t] for t in stamps]
        self.paths[path]["calls"] += 1
        self.paths[path]["unpack_launches"] += sum(delta[UNPACK[c]][0]
                                                   for c in {f.codec for f in frames})
        notes = []
        if expect is None:
            expect, notes = self._expected(stamps, fn, sharded, batches, out)
        if expect is not None and not out.same(expect):
            notes.append(f"{out.describe()} != plain {expect.describe()}"
                         + (" (arrays differ)" if not (out.error or expect.error) else ""))
        if not err:
            bad = [i for i, (dev_sum, h) in enumerate(got[1]) if dev_sum != h]
            if bad:
                notes.append(f"device_checksum != host sum for results {bad}")
        notes += self._launch_checks(frames, delta, out, launches_on_error)
        if notes:
            self.fail(path, stamps, "; ".join(notes))

    def _expected(self, stamps, fn, sharded: bool, batches, out: Outcome):
        """The outcome a Decoder path must give, and notes on its own: the
        frames' plain arrays where every frame decodes and each of the
        path's `batches` shares its encoded geometry; else, on a card, the
        same path on a CPU Decoder, and on the CPU (where the path is its
        own plain version) an error that one of the frames or a batch's
        geometry gives."""
        wants = [decoder_expect(self.frames[t], self.outcomes[t]) for t in stamps]
        errors = {w.error for w in wants if w.error}
        if any(len({encoded_tiles(self.frames[t]) for t in b}) > 1 for b in batches):
            errors.add(("ValueError", SHARE_GEOMETRY))
        if not errors:
            arrays = tuple(w.arrays[0] for w in wants)
            return Outcome((np.concatenate(arrays),) if sharded else arrays, None), []
        if self.on_card:
            if self._mirror is None:
                self._mirror = Decoder(self.clip, "cpu")
            m, merr = caught(lambda: self._host(fn(self._mirror))[0])
            return Outcome(None, merr) if merr else Outcome(self._join(m, sharded), None), []
        if out.error not in errors:
            return None, [f"CPU path gave {out.describe()}, the frames give {sorted(errors)}"]
        return None, []

    def _host(self, tensors) -> tuple[list, list]:
        """Each result on the host, and (device checksum, host sum) pairs of
        those on a card."""
        arrays, sums = [], []
        for t in tensors:
            cs = C.device_checksum(t) if t.device.type == "cuda" and t.numel() else None
            a = t.cpu().numpy()
            arrays.append(a)
            if cs is not None:
                sums.append((int(cs.item()), host_sum(a)))
        return arrays, sums

    @staticmethod
    def _join(arrays: list, sharded: bool) -> tuple:
        return (np.concatenate(arrays),) if sharded else tuple(arrays)

    def _launch_checks(self, frames, delta, out: Outcome, launches_on_error: bool) -> list:
        notes = []
        unpack = sum(delta[UNPACK[c]][0] for c in (7, 6))
        rows = out.error is None and any(rows_written(f) > 0 for f in frames)
        if self.on_card:
            if any(p for _, p in delta.values()):
                notes.append(f"plain calls on the card: {delta}")
            if rows and unpack == 0:
                notes.append("no unpack launch")
            if out.error is not None and unpack and not launches_on_error:
                notes.append(f"{unpack} unpack launches before the error")
            if len({f.codec for f in frames}) == 1 and delta[UNPACK[13 - frames[0].codec]][0]:
                notes.append("the other codec's kernel launched")
        else:
            if any(n for n, _ in delta.values()):
                notes.append(f"kernel launches on the CPU: {delta}")
            if rows and not sum(delta[UNPACK[c]][1] for c in (7, 6)):
                notes.append("no plain unpack call")
        return notes

    # -- records

    def fail(self, path: str, stamps: list, note: str) -> None:
        self.failures += 1
        frames = [self.frames[t] for t in stamps]
        row = {"leg": self.leg, "seed": self.seed, "iteration": self.iteration, "path": path,
               "codec": frames[0].codec, "width": frames[0].width, "height": frames[0].height,
               "timestamps": stamps, "what": [f.what for f in frames], "note": note[:500]}
        print(json.dumps({"failure": row}), file=sys.stderr, flush=True)
        if self.reproducers < MAX_REPRODUCERS:
            self.reproducers += 1
            name = f"FAIL_{self.leg}_s{self.seed}_i{self.iteration}_{path}_t{stamps[0]}.npz"
            save_reproducer(self.failures_dir / name, self.clip, frames, row)

    def _inflight(self, frames: list) -> None:
        """The case being decoded, kept for a crash report."""
        save_reproducer(inflight_path(self.failures_dir, self.leg), self.clip, frames,
                        {"leg": self.leg, "seed": self.seed, "iteration": self.iteration})

    def summary(self, seconds: float) -> dict:
        return {"leg": self.leg, "seed": self.seed, "device": str(self.dev),
                "iterations": self.iteration, "failures": self.failures, "crashes": 0,
                "launches": {k: self.launches[k] for k in COUNTED},
                "plain_calls": {k: self.plain[k] for k in COUNTED},
                "paths": {p: dict(c) for p, c in self.paths.items()}, "seconds": seconds}


def at(iteration: int, path: str, inject: str | None = None) -> None:
    """Tell the parent which path runs now (a crash report names it); with
    ``inject == "crash"``, then die by a signal."""
    print(json.dumps({"at": [iteration, path]}), flush=True)
    if inject == "crash":
        os.kill(os.getpid(), signal.SIGKILL)


def inflight_path(failures: Path, leg: str) -> Path:
    return failures / f".inflight_{leg}.npz"


def save_reproducer(path: Path, clip: bytes, frames: list, row: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f"payload_{i}": np.frombuffer(f.payload, np.uint8) for i, f in enumerate(frames)}
    arrays.update({f"source_{i}": f.source for i, f in enumerate(frames) if f.source is not None})
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, clip=np.frombuffer(clip, np.uint8),
             codec=np.array([f.codec for f in frames]),
             width=np.array([f.width for f in frames]),
             height=np.array([f.height for f in frames]),
             row=np.array(json.dumps(row)), **arrays)
    os.replace(tmp, path)


def run_leg(leg: str, seed: int, device, seconds: float, iterations: int | None,
            failures: Path, inject: str | None = None) -> dict:
    """One leg in this process until `seconds` or `iterations`: its
    summary row."""
    t0 = time.perf_counter()
    if leg in CLI_LEGS:
        from .soak_cli import CliLeg

        runner = CliLeg(leg, seed, device, failures, inject)
    else:
        runner = Leg(leg, seed, device, failures, inject)
    while time.perf_counter() - t0 < seconds and (iterations is None
                                                  or runner.iteration < iterations):
        runner.step()
    inflight_path(failures, leg).unlink(missing_ok=True)
    row = runner.summary(time.perf_counter() - t0)
    path = build.loaded()
    row["library"] = path.name if path else None
    if build.checked():
        row["checked"] = {k: dict(build.CHECKED[k])
                          for k in ("launches", "faults", "cross_frame_reads")}
    return row


# -- the parent: one child process a leg ----------------------------------------------


def run_child(leg: str, args) -> dict:
    """Run one leg in a child process; its summary row, or a CRASH row
    when the child died before printing one."""
    cmd = [sys.executable, "-m", "mcraw_torch.soak", "--child", leg, "--seed", str(args.seed),
           "--seconds", str(args.seconds), "--device", args.device,
           "--failures", str(args.failures)]
    if args.iterations is not None:
        cmd += ["--iterations", str(args.iterations)]
    if args.inject:
        cmd += ["--inject", args.inject]
    if args.checked:
        cmd.append("--checked")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=child_env())
    row, at = None, None
    limit = (args.seconds if args.iterations is None else 60 * args.iterations) + 600
    killer = threading.Timer(limit, proc.kill)
    killer.start()
    for line in proc.stdout:
        try:
            msg = json.loads(line)
        except ValueError:
            continue
        if "at" in msg:
            at = msg["at"]
        elif "leg" in msg:
            row = msg
    rc = proc.wait()
    killer.cancel()
    if row is not None and rc in (0, 1):
        return row
    crash = {"leg": leg, "seed": args.seed, "device": args.device, "status": "CRASH",
             "returncode": rc, "iteration": at[0] if at else None,
             "path": at[1] if at else None, "iterations": at[0] if at else 0,
             "failures": 0, "crashes": 1, "seconds": time.perf_counter() - t0}
    inflight = inflight_path(args.failures, leg)
    if inflight.exists():
        keep = args.failures / f"CRASH_{leg}_s{args.seed}_i{crash['iteration']}_{crash['path']}.npz"
        os.replace(inflight, keep)
        crash["reproducer"] = str(keep)
    return crash


def child_env() -> dict:
    root = str(Path(__file__).resolve().parents[1])
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=root + (os.pathsep + path if path else ""))


def soak(args) -> int:
    if args.seed is None:
        args.seed = int(time.time()) % (1 << 31)
    print(json.dumps({"soak": {"seed": args.seed, "device": args.device, "legs": args.legs,
                               "seconds": args.seconds, "iterations": args.iterations,
                               "checked": args.checked}}),
          flush=True)
    resolve_device(args.device)  # no card: raise here, not in every child
    if torch.device(args.device).type == "cuda":
        build.build(checked=args.checked)  # build once, before the children load it
    args.failures.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(args.legs)) as pool:
        rows = list(pool.map(lambda leg: run_child(leg, args), args.legs))
    bad = 0
    for row in rows:
        print(json.dumps(row), flush=True)
        bad += row["failures"] + row["crashes"]
    return 1 if bad else 0


# -- the parity grid ----------------------------------------------------------------

GEOMETRIES = {  # (h, w), tools/hw_parity.py:43-49
    "4k": (3072, 4096),
    "phone": (3024, 4032),
    "1080p": (1080, 1920),
    "tiny": (96, 320),
    "ragged": (48, 288),
}
CONTENTS = ("mid12", "full16", "zeros", "lo10", "mix16")
DEVELOP_GEOMETRIES = ("1080p", "tiny", "ragged")
DEVELOP_4K = ("4k", "mid12", 7)
GRID_JOBS = 4  # grid cases at a time, each a child process


def make_img(h: int, w: int, content: str, seed: int = 11) -> np.ndarray:
    """tools/hw_parity.py:89-117."""
    rng = np.random.default_rng(seed)
    if content == "zeros":
        return np.zeros((h, w), np.uint16)
    if content == "full16":
        return rng.integers(0, 1 << 16, size=(h, w), dtype=np.uint16)
    if content == "lo10":
        return rng.integers(0, 1 << 10, size=(h, w), dtype=np.uint16)
    # mid12: smooth 12-bit field + noise (mixed block classes).
    base = (
        np.sin(np.arange(w) / 97)[None, :]
        * np.cos(np.arange(h) / 61)[:, None]
        * 1200
        + 2000
    )
    img = (base + rng.normal(0, 30, size=(h, w))).clip(0, 4095).astype(
        np.uint16
    )
    if content == "mix16":
        # mid12 with a full-range patch: class-16 blocks among the others.
        ph, pw = max(4, h // 4), max(64, w // 4)
        img[:ph, :pw] = rng.integers(0, 1 << 16, size=(ph, pw),
                                     dtype=np.uint16)
    return img


def grid_case(geometry: str, content: str, codec: int, device) -> dict:
    """One grid case in this process: two frames of (geometry, content)
    (seeds 11 and 12) in a clip of `codec`, through the six paths and
    export_clip, each frame's device checksum held to its source's; the
    develop where the grid asks for it."""
    from . import preview as P
    from .clip import export_clip
    from .color import interpolated_matrices
    from .metadata import ContainerMetadata

    t0 = time.perf_counter()
    dev = resolve_device(device)
    h, w = GEOMETRIES[geometry]
    imgs = [make_img(h, w, content, seed) for seed in (11, 12)]
    enc = E.encode_modern if codec == 7 else E.encode_legacy
    payloads = [enc(img) for img in imgs]
    cm = example_container_metadata(sensor="bggr", white_level=4095.0)
    writer = E.ContainerWriter(cm)
    for i, p in enumerate(payloads):
        writer.add_frame(1000 + i, p, example_frame_metadata(w, h, codec))
    clip = writer.finish()
    encode_s = time.perf_counter() - t0
    want = [host_sum(img) for img in imgs]
    paths = {}

    def held(path: str, tensors, sources) -> None:
        got = [int(C.device_checksum(t).item()) for t in tensors]
        shapes = [tuple(t.shape) for t in tensors]
        ok = got == [host_sum(s) for s in sources] and shapes == [s.shape for s in sources]
        paths[path] = "OK" if ok else f"MISMATCH {got} {shapes}"

    decode = codecs.decode_modern if codec == 7 else codecs.decode_legacy
    d = Decoder(clip, dev)
    ts = d.frames
    # The codec function returns the frame on the host.
    host = decode(np.frombuffer(payloads[0], np.uint8), w, h, device=dev)
    paths["codecs"] = "OK" if np.array_equal(host, imgs[0]) else "MISMATCH"
    held("load_frame_device", [d.load_frame_device(ts[0])[0]], imgs[:1])
    held("decode_batch", list(d.decode_batch(ts)[0]), imgs)
    fd = d.make_frame_decoder()
    held("frame_decoder", [fd(t)[0] for t in ts], imgs)
    s = d.load_frame_sharded(ts[1], PAR.Mesh((dev,) * 4))[0]
    paths["load_frame_sharded"] = ("OK" if sum(int(C.device_checksum(x).item()) for x in s.shards)
                                   % (1 << 32) == want[1] else "MISMATCH")
    held("decode_batch_iter", [x for b, _ in d.decode_batch_iter(chunk_frames=1) for x in b], imgs)
    with tempfile.TemporaryDirectory() as out:
        stats = export_clip(d, out, prefetch=2, writers=2)
        from .emit.dng import dng_bytes

        same = stats.frames_done == 2 and all(
            Path(out, f"frame_{i:06d}.dng").read_bytes()
            == dng_bytes(img, d._reader.frame_payload(t)[1], d.container_metadata)
            for i, (img, t) in enumerate(zip(imgs, ts)))
        paths["export_clip"] = "OK" if same else "MISMATCH"
    row = {"geometry": geometry, "h": h, "w": w, "content": content, "codec": codec,
           "paths": paths, "encode_s": encode_s}
    if geometry in DEVELOP_GEOMETRIES or (geometry, content, codec) == DEVELOP_4K:
        meta = d._reader.frame_payload(ts[0])[1]
        tcm = ContainerMetadata(cm)
        fwd, _, _ = interpolated_matrices(tcm, meta["asShotNeutral"])
        args = (tcm.black_level, tcm.white_level, meta["asShotNeutral"], fwd,
                tuple(tcm.cfa_pattern))
        row["develop"] = {}
        for demosaic in ("bilinear", "malvar"):
            rgba = P.preview_frame_rgba(d, ts[0], demosaic=demosaic)
            a = rgba.cpu().numpy().astype(np.int64)
            rgb = np.stack([(a >> sh) & 0xFF for sh in (0, 8, 16)], -1)
            err = int(np.abs(rgb - P.develop_f64(imgs[0], *args, demosaic=demosaic)).max())
            row["develop"][demosaic] = err
            paths[f"develop_{demosaic}"] = "OK" if err <= 1 else f"MISMATCH {err} LSB"
    d.close()
    row["status"] = "OK" if all(v == "OK" for v in paths.values()) else "MISMATCH"
    row["seconds"] = time.perf_counter() - t0
    return row


def card_name(device) -> str | None:
    """The card's name and power limit as nvidia-smi gives them (None on
    the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else None


def grid(args) -> int:
    """The parity grid, one child process per case, GRID_JOBS at a time."""
    resolve_device(args.device)
    if torch.device(args.device).type == "cuda":
        build.lib()
    geoms = ["4k", "1080p"] if args.quick else list(GEOMETRIES)
    contents = ["mid12"] if args.quick else list(CONTENTS)
    cases = [(g, c, k) for g in geoms for c in contents for k in (7, 6)]

    def child(case) -> dict:
        g, c, k = case
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "mcraw_torch.soak", "--grid-case", g, c,
                              str(k), "--device", args.device], capture_output=True, text=True,
                             env=child_env(), timeout=1800)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
        if res.returncode == 0 and lines:
            return json.loads(lines[-1])
        return {"geometry": g, "content": c, "codec": k, "status": "CRASH",
                "returncode": res.returncode, "stderr": res.stderr[-800:],
                "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    with ThreadPoolExecutor(GRID_JOBS) as pool:
        rows = []
        for row in pool.map(child, cases):
            print(json.dumps(row), flush=True)
            rows.append(row)
    card = card_name(args.device)
    result = {"card": card, "device": args.device, "quick": args.quick,
              "cases": len(rows), "ok": sum(r["status"] == "OK" for r in rows),
              "seconds": time.perf_counter() - t0, "rows": rows}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps({k: v for k, v in result.items() if k != "rows"}), flush=True)
    return 0 if result["ok"] == len(rows) else 1


# -- the command line -----------------------------------------------------------------


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m mcraw_torch.soak")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seconds", type=float, default=600.0, help="per leg")
    ap.add_argument("--iterations", type=int, default=None, help="per leg, at most")
    ap.add_argument("--seed", type=int, default=None, help="default: from the time, printed")
    ap.add_argument("--legs", default=",".join(LEGS),
                    help="comma-separated: codec, mutation, malformed, container, json "
                         "(cli: the last two)")
    ap.add_argument("--failures", type=Path, default=Path("soak_failures"))
    ap.add_argument("--checked", action="store_true",
                    help="run the legs on the checked build of the kernels (needs a card)")
    ap.add_argument("--inject", choices=("wrong", "crash"), default=None,
                    help="a wrong decoder or a dying child, to show the soak reports it")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--quick", action="store_true", help="grid: 4k and 1080p, mid12 only")
    ap.add_argument("--out", type=Path,
                    default=Path(__file__).resolve().parent / "hw_parity_h100.json")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--grid-case", nargs=3, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    legs = []
    for leg in args.legs.split(","):
        legs += list(CLI_LEGS) if leg == "cli" else [leg]
    unknown = sorted(set(legs) - set(LEGS))
    if unknown:
        ap.error(f"unknown legs {unknown}")
    args.legs = legs
    if args.checked and (args.grid or torch.device(args.device).type != "cuda"):
        ap.error("--checked needs --device cuda (the checked build runs on the card) "
                 "and no --grid")
    return args


def main(argv=None) -> int:
    args = parse(argv)
    if args.child:
        # One leg a process, small frames: the plain versions' threads
        # would only contend with the other legs'.
        torch.set_num_threads(1)
        if args.checked:
            build.use_checked()
        row = run_leg(args.child, args.seed, args.device, args.seconds, args.iterations,
                      args.failures, args.inject)
        print(json.dumps(row), flush=True)
        return 1 if row["failures"] else 0
    if args.grid_case:
        g, c, k = args.grid_case
        row = grid_case(g, c, int(k), args.device)
        print(json.dumps(row), flush=True)
        return 0
    if args.grid:
        return grid(args)
    return soak(args)


if __name__ == "__main__":
    sys.exit(main())
