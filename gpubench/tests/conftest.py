"""Shared helpers of the benchmark's CPU tests: cells of the manifest cut to
a few small frames, run on the CPU through the program's plain paths."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

WORKLOADS = ("modern-grade", "legacy-grade", "modern-decode")  # the manifest's cells
# (distinct frames, shot frames) of each traffic at the tests' size
SMALL_TRAFFIC = {"grade": (3, 16), "decode": (3, 32)}


def small_cell(workload: str, height: int = 24, width: int = 192):
    """The manifest's cell with a small frame and a short shot."""
    from gpubench import spec

    cell = spec.load(workload)
    distinct, frames = SMALL_TRAFFIC[cell.workload["traffic"]]
    return dataclasses.replace(
        cell, config=dict(cell.config, height=height, width=width),
        traffic=dict(cell.traffic, distinct_frames=distinct, frames=frames, trace_seconds=0.2))


@pytest.fixture
def run_small(monkeypatch, tmp_path):
    """run_small(workload, seed=..., trace=False, seconds=0.3): one run of
    the small cell on the CPU, its traces written under `tmp_path`."""
    import torch

    from gpubench import run

    monkeypatch.setattr(run, "RUNS", tmp_path)

    def go(workload: str, seed: int = 2**31 + 11, trace: bool = False, seconds: float = 0.3):
        return run.run_cell(small_cell(workload), seed, seconds, trace, torch.device("cpu"),
                            workers=1, t_start=0.0)

    return go


@pytest.fixture
def card():
    """Skips a test where there is no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
