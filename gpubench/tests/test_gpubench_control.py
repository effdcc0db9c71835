"""``correct`` has to come out false for the control (the reference one
step below the stated precision in the program's place) and for each fault
the timed path of a cell can have: a step that returns its output
unwritten, half of a batch left out, an answer altered where it is made
(in the decode, the develop or the checksum the window adds up).
Each runs the rest of a run on the CPU at a small size."""

from __future__ import annotations

import pytest
import torch
from conftest import WORKLOADS


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_is_correct_and_control_is_not(run_small, workload):
    run = run_small(workload, trace=workload == "modern-grade")
    assert run["result"]["correct"], run["result"]["checks"]
    control = run["control"]()
    assert not control.correct, control.line()


def unwritten(decode):
    def wrapped(*a, **k):
        return torch.zeros_like(decode(*a, **k))
    return wrapped


def half_batch(decode):
    def wrapped(*a, **k):
        out = decode(*a, **k)
        out[out.shape[0] // 2 :] = 0
        return out
    return wrapped


def altered(decode):
    """One value altered in its low bits: a plane's value, or an RGBA's red
    code by 2 to 6 (more than the develop's 1 LSB)."""
    def wrapped(*a, **k):
        out = decode(*a, **k)
        signed = torch.int16 if out.element_size() == 2 else torch.int32
        out.view(-1).view(signed)[out.numel() // 3] ^= 6
        return out
    return wrapped


FAULTS = {"unwritten": unwritten, "half_batch": half_batch, "altered": altered}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_fault_in_the_decode_is_not_correct(run_small, monkeypatch, workload, fault):
    from mcraw_torch.kernels import legacy, unpack

    for mod, name in ((unpack, "decode_modern_batch_device"),
                      (legacy, "decode_legacy_batch_device")):
        monkeypatch.setattr(mod, name, FAULTS[fault](getattr(mod, name)))
    assert not run_small(workload)["result"]["correct"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_the_develop_is_not_correct(run_small, monkeypatch, fault):
    from mcraw_torch import preview

    develop = preview.develop_rgba

    monkeypatch.setattr(preview, "develop_rgba", FAULTS[fault](develop))
    assert not run_small("modern-grade")["result"]["correct"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_fault_in_the_checksum_is_not_correct(run_small, monkeypatch, workload):
    from mcraw_torch.kernels import checksum

    summed = checksum.device_checksum
    monkeypatch.setattr(checksum, "device_checksum", lambda x: summed(x) + 1)
    checks = run_small(workload)["result"]["checks"]
    name = "checksum_gap" if workload == "modern-decode" else "step_checksum_off"
    assert checks[name]["value"] > checks[name]["limit"], checks
