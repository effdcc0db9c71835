"""The command as the check runs it: on a card every cell runs and is
correct; without one it exits 2 and prints no result; in a directory that
holds only the benchmark it fails."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT, WORKLOADS


def command(workload: str, seed: int, cwd=ROOT, seconds: str = "2", trace: str = "0"):
    return subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", workload,
                           "--seed", str(seed), "--seconds", seconds, "--trace", trace],
                          cwd=cwd, capture_output=True, text=True, timeout=600)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_is_correct_on_the_card(card, workload):
    out = command(workload, 2**31 + 101)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line


def test_without_a_card_the_command_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("there is a card here")
    out = command("modern-grade", 1)
    assert out.returncode == 2 and out.stdout == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command("modern-grade", 1, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
