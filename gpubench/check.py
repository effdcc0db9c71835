"""What decides ``correct``: the program's outputs from the timed window,
held to the plain reference (:mod:`gpubench.ref`) after the window.

Each number compared has a limit, and the run is correct when every number
is at most its limit:

- ``plane_mismatch``: elements of the sampled steps' decoded planes that
  differ from the reference decode of the same payloads. The codecs are
  lossless: 0.
- ``checksum_gap``: the window's accumulated checksum of every plane it
  decoded, against the reference planes' sums over the same steps, mod
  2^32 (decode-only cells, where the step sums the planes). 0.
- ``step_checksum_off``: sampled steps whose checksum, the one the window
  added into its accumulator, is not the plain wrap-around sum of the
  32-bit words of the step's own RGBA (the grade cells, where the step
  sums its RGBA: the develop is within 1 LSB of the model, not equal to
  it, so the window's accumulated sum has no exact reference there). 0.
- ``rgba_max_err``: the largest |program - reference| of an sRGB code in
  the sampled steps' developed frames, against the float64 model of the
  reference planes. The limit is the configuration's (1 LSB).
- ``rgba_off_ppm``: of those codes, the ones that differ from the model's
  at all, per million codes. The limit is the configuration's, set
  between the program's readings and the control's.
- ``alpha_off``: developed pixels whose alpha is not 255. 0.

The control puts the reference, one step below the precision the
configuration states, in the program's place: planes one bit short of the
stated depth (the least significant bit cleared) and the develop in
bfloat16 in place of float32 (float16 is read beside it, on the card). It
has to come out not correct.
"""

from __future__ import annotations

import numpy as np
import torch

from .ref import codec as RC
from .ref import develop as RD

MASK = 0xFFFFFFFF
CONTROL_DEVELOP_DTYPE = torch.bfloat16


class Reference:
    """The reference's planes and sums of a run's distinct frames, each
    worked out once, from the payloads the benchmark made."""

    def __init__(self, payloads: list[bytes], config: dict, device):
        self.payloads, self.config, self.device = payloads, config, device
        self._planes: dict[int, torch.Tensor] = {}

    def plane(self, k: int) -> torch.Tensor:
        if k not in self._planes:
            c = self.config
            self._planes[k] = RC.decode(np.frombuffer(self.payloads[k], np.uint8), c["codec"],
                                        c["width"], c["height"], self.device)
        return self._planes[k]

    def plane_sum(self, k: int) -> int:
        return int(self.plane(k).to(torch.int64).sum()) & MASK

    def develop(self, k: int, grade: dict, cfa, demosaic: str, dtype=torch.float64):
        return RD.develop(self.plane(k), grade["black"], grade["white"], grade["neutral"],
                          np.reshape(grade["forward"], (3, 3)), cfa, demosaic, dtype)


class Checks:
    """Numbers compared, each with its limit."""

    def __init__(self):
        self.rows: dict[str, tuple[float, float]] = {}

    def add(self, name: str, value, limit) -> None:
        self.rows[name] = (value, limit)

    @property
    def correct(self) -> bool:
        return bool(self.rows) and all(v <= lim for v, lim in self.rows.values())

    def line(self) -> dict:
        return {k: {"value": v, "limit": lim} for k, (v, lim) in self.rows.items()}


def drop_lsb(plane: torch.Tensor) -> torch.Tensor:
    """The control's plane: one bit short of the stated depth."""
    return plane & ~1


def word_sum(rgba: torch.Tensor) -> int:
    """The wrap-around sum of the 32-bit RGBA words of `rgba`, from its
    bytes (little-endian), mod 2^32."""
    b = rgba.contiguous().view(torch.uint8).reshape(-1, 4).to(torch.int64)
    return int((b[:, 0] + (b[:, 1] << 8) + (b[:, 2] << 16) + (b[:, 3] << 24)).sum()) & MASK


def planes_and_codes(kept, ref: Reference, grade: dict | None, cfa, demosaic: str | None,
                     control: torch.dtype | None):
    """Per kept step: (frames, program planes, program RGBA or None, the
    step's checksum), the control's in place of the program's where
    `control` names the develop's precision."""
    for frames, planes, rgba, summed in kept:
        if control is not None:
            planes = torch.stack([drop_lsb(ref.plane(k)) for k in frames])
            if demosaic is not None:
                rgba = [ref.develop(k, grade, cfa, demosaic, control) for k in frames]
        yield frames, planes, rgba, summed


def resident(checks: Checks, kept, ref: Reference, config: dict, grade: dict | None, cfa,
             demosaic: str | None, acc: int | None, summed: list[int] | None,
             control: torch.dtype | None = None) -> None:
    """The card-paced cells: `kept` is [(distinct frame of each slot, the
    step's (F, H, W) planes, its (F, H, W) uint32 RGBA or None, the step's
    checksum)] from the sampled steps; `acc` the window's accumulated
    checksum where the step sums its planes, `summed` the distinct frame of
    every plane it summed. `control`: the develop's precision of the
    control, which is put in the program's place."""
    mismatch, err, off, codes_n, alpha, sums_off = 0, 0, 0, 0, 0, 0
    for frames, planes, rgba, step_sum in planes_and_codes(kept, ref, grade, cfa, demosaic,
                                                           control):
        for f, k in enumerate(frames):
            got = planes[f].to(torch.int32)
            mismatch += int((got != ref.plane(k)).sum())
            if rgba is None:
                continue
            want = ref.develop(k, grade, cfa, demosaic)
            if control is not None:
                codes = rgba[f]
            else:
                b = rgba[f].view(torch.uint8).reshape(*rgba[f].shape, 4).to(torch.int64)
                codes = b[..., :3]
                alpha += int((b[..., 3] != 255).sum())
            diff = (codes - want).abs()
            err = max(err, int(diff.max()))
            off += int((diff != 0).sum())
            codes_n += diff.numel()
        if rgba is not None and control is None:
            sums_off += int(int(step_sum) != word_sum(rgba))
    checks.add("plane_mismatch", mismatch, 0)
    if demosaic is not None:
        limits = config["limits"]
        checks.add("rgba_max_err", err, limits["rgba_max_err"])
        checks.add("rgba_off_ppm", 1e6 * off / max(codes_n, 1), limits["rgba_off_ppm"])
        checks.add("alpha_off", alpha, 0)
        checks.add("step_checksum_off", sums_off, 0)
    if summed is not None:
        sums = {k: ref.plane_sum(k) for k in set(summed)}
        if control is not None:
            sums_control = {k: int(drop_lsb(ref.plane(k)).to(torch.int64).sum()) & MASK
                            for k in sums}
            acc = sum(sums_control[k] for k in summed) & MASK
        want = sum(sums[k] for k in summed) & MASK
        checks.add("checksum_gap", (acc - want) & MASK, 0)
