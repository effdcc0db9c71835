"""The inputs of a run, drawn from its seed: images, payloads, the order of
the shot or clip, and the grade's parameters. NumPy only (no torch), so
that the set-up's encoding processes start quickly.

The content is the "mix" draw of the program's bench (``bench.make_frames``):
a smooth field ``2000 + 1200 sin(x / (97 + k)) cos(y / (61 + k))`` plus
Gaussian noise of sigma 30, clipped to 12 bits, for distinct frame k. Each
frame draws its noise from ``(seed, k)``, so that the frames encode in
parallel; every seed gives the same field and the same noise level, so the
payload sizes are the same up to the noise's draw. A configuration of
fewer bits keeps the top ones (``>> (12 - bits)``).
"""

from __future__ import annotations

import sys

import numpy as np

from .encode import encode

CONTENTS = ("mix",)


def image(height: int, width: int, k: int, seed: int, content: str, bits: int) -> np.ndarray:
    """Distinct frame k of a run: (height, width) uint16 of `bits` bits."""
    if content not in CONTENTS:
        raise ValueError(f"unknown content {content!r}: {CONTENTS}")
    rng = np.random.default_rng([seed, k])
    base = (np.sin(np.arange(width) / (97 + k))[None, :]
            * np.cos(np.arange(height) / (61 + k))[:, None] * 1200 + 2000)
    img = (base + rng.normal(0, 30, size=(height, width))).clip(0, 4095).astype(np.uint16)
    return img >> (12 - bits)


def payload(args: tuple) -> bytes:
    """The payload of distinct frame k: args = (height, width, k, seed,
    content, bits, codec). One task of the set-up's process pool."""
    height, width, k, seed, content, bits, codec = args
    return encode(image(height, width, k, seed, content, bits), codec)


def order(seed: int, distinct: int, frames: int, salt: int) -> list[int]:
    """`frames` frames that repeat `distinct` ones as evenly as they divide,
    in an order drawn from the seed: every seed plays the same frames as
    often, in another order."""
    frames_of = np.arange(frames) % distinct
    return np.random.default_rng([seed, salt]).permutation(frames_of).tolist()


def grade(config: dict) -> dict:
    """The develop parameters of every shot of a configuration: its
    ``grade`` and its white level. The same for every seed: a grade drawn from the seed
    moved the develop's time by about 1 % from seed to seed."""
    return {**config["grade"], "white": float(config["white_level"])}


def main(argv: list[str]) -> None:
    """A set-up worker: ``python3 -m gpubench.frames H W SEED CONTENT BITS
    CODEC K...`` writes the payload of each distinct frame K to standard
    output, each behind its length (8 bytes, little-endian)."""
    height, width, seed, content, bits, codec, *ks = argv
    out = sys.stdout.buffer
    for k in ks:
        p = payload((int(height), int(width), int(k), int(seed), content, int(bits), codec))
        out.write(len(p).to_bytes(8, "little"))
        out.write(p)
        out.flush()


if __name__ == "__main__":
    main(sys.argv[1:])
