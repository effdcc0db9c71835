"""mcraw_torch.bench, the port's counterpart of bench.py, on the CPU at
64x256 with --quick: its frames equal bench.make_frames', every leg runs
and prints bench.py's keys, and a wrong output or a leg that raises shows
in the line and in the exit code."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as JB
from mcraw import encode as JE
from mcraw_torch import bench as B
from mcraw_torch.kernels import develop as D
from mcraw_torch.kernels import legacy as L
from mcraw_torch.kernels import unpack as U

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--quick", "--size", "64x256"]
FPS_KEYS = [k for k in B.KEYS if k.endswith("fps") or k == "value"]
LEGACY_LEGS = ["legacy_fps_4k", "legacy_fps_1080p"]
DEVELOP_LEGS = ["decode_develop_fps", "decode_develop_legacy_fps",
                "decode_develop_malvar_fps"]


@pytest.fixture
def one_thread():
    """The plain versions at 64x256 run fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_bench_without_cache(monkeypatch):
    """bench.make_frames with its disk cache cut off: no cache file is
    read or written."""
    def no_load(*args, **kwargs):
        raise OSError("no cache in the tests")

    monkeypatch.setattr(np, "load", no_load)
    monkeypatch.setattr(np, "savez", lambda *args, **kwargs: None)
    monkeypatch.setattr(os, "makedirs", lambda *args, **kwargs: None)
    return JB


def run_main(capsys, argv) -> tuple[int, dict | None, str]:
    rc = B.main(argv)
    out, err = capsys.readouterr()
    out = out.strip()
    return rc, (json.loads(out.splitlines()[-1]) if out else None), err


def test_keys_are_bench_py_keys():
    """KEYS is the dict that bench.py's _run prints (bench.py:956-989), key
    for key and in its order, read from the syntax tree."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    run = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "_run")
    printed = [d for d in ast.walk(run) if isinstance(d, ast.Dict)]
    assert len(printed) == 1
    assert tuple(k.value for k in printed[0].keys) == B.KEYS


@pytest.mark.parametrize("content", ["mix", "worst", "all16"])
def test_frames_equal_bench_make_frames(jax_bench_without_cache, monkeypatch, content):
    monkeypatch.setattr(JB, "FRAMES", 3)
    want_imgs, want_payloads = JB.make_frames(64, 256, content)
    imgs, payloads = B.make_frames(64, 256, content, 3)
    assert len(imgs) == len(payloads) == 3
    for a, b in zip(imgs, want_imgs):
        assert a.dtype == b.dtype == np.uint16 and np.array_equal(a, b)
    for a, b in zip(payloads, want_payloads):
        assert a.dtype == np.uint8 and a.tobytes() == b.tobytes()


def test_legacy_frames_equal_mcraw_encode_legacy(jax_bench_without_cache):
    want_imgs, _ = JB.make_frames(64, 256, "mix")  # bench.FRAMES = 8
    imgs, payloads = B.make_frames(64, 256, "mix", B.LEGACY_FRAMES, codec="legacy")
    assert len(payloads) == 4
    for img, want, payload in zip(imgs, want_imgs[:4], payloads):
        assert np.array_equal(img, want)
        assert payload.tobytes() == JE.encode_legacy(want)


def test_encode_pool_equals_serial(monkeypatch):
    imgs = B.draw_images(16, 128, "mix", 2)
    serial = {c: B.encode_all(imgs, c) for c in ("modern", "legacy")}
    monkeypatch.setattr(B, "POOL_PIXELS", 0)
    with B.encode_pool() as pool:
        for codec, want in serial.items():
            got = B.encode_all(imgs, codec, pool)
            assert [p.tobytes() for p in got] == [p.tobytes() for p in want]


@pytest.fixture(scope="module")
def quick_line():
    """One run of ``python -m mcraw_torch.bench --device cpu --quick --size
    64x256``: (exit code, its JSON line, its stdout)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-m", "mcraw_torch.bench", *SMALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    lines = res.stdout.splitlines()
    return res.returncode, (json.loads(lines[-1]) if lines else None), res


def test_cpu_quick_prints_every_key_and_every_leg(quick_line):
    rc, line, res = quick_line
    assert rc == 0, res.stderr[-3000:]
    assert len(res.stdout.splitlines()) == 1
    for key in (*B.KEYS, "device", "baseline", "latency_ms_single_frame_p90",
                "latency_samples"):
        assert key in line, key
    for key in (*FPS_KEYS, "unpack_gbps", "latency_ms_single_frame",
                "latency_ms_single_frame_p90"):
        assert isinstance(line[key], float) and line[key] > 0, (key, line[key])
    assert line["gate_failures"] == [] and line["errors"] == []
    assert line["unit"] == "frames/sec" and line["device"] == "cpu, plain torch"
    assert "cpu" in line["metric"] and "H100" not in line["metric"]
    assert line["latency_samples"] == B.QUICK.latency_samples
    assert list(line["legs"]) == list(B.LEGS)


def test_cpu_quick_legs_report_their_bursts_and_calls(quick_line):
    _, line, _ = quick_line
    for name, row in line["legs"].items():
        assert row["plain_calls"]["checksum"] > 0, name
        assert not any(row["launches"].values()), name  # the CPU launches no kernel
        if name == "latency_ms_single_frame":
            assert row["ms"] <= row["p90_ms"]
            continue
        assert row["bursts"] == B.QUICK.bursts
        assert row["q1_fps"] <= row["fps"] <= row["q3_fps"] <= row["best_fps"]
        assert row["distinct_frames"] == B.QUICK_FRAMES
    for name in DEVELOP_LEGS:
        row = line["legs"][name]
        assert row["burst_frames"] == 2 * B.QUICK.burst_pairs
        assert row["plain_calls"]["develop"] > 0 and row["develop_max_abs_err"] <= 1
    for name in LEGACY_LEGS:
        assert line["legs"][name]["plain_calls"]["unpack_legacy"] > 0
        assert line["legs"][name]["plain_calls"]["unpack_modern"] == 0
    assert line["legs"]["decode_develop_legacy_fps"]["plain_calls"]["unpack_legacy"] > 0


def test_cpu_legs_have_no_trace(quick_line):
    _, line, _ = quick_line
    for name, row in line["legs"].items():
        assert row.get("trace") is None, name  # no device activity to trace on the CPU


def test_device_split_of_a_trace():
    """Kernels by short name, memcpy and memset by kind, a frame; the busy
    time is the union of the intervals; CPU events are left out."""
    events = [
        {"cat": "kernel", "name": "void at::native::reduce_kernel<512, 1>(at::native::"
         "ReduceOp<long>)", "ts": 0, "dur": 10},
        {"cat": "kernel", "name": "void (anonymous namespace)::unpack_modern_kernel<false>("
         "int const*, long)", "ts": 5, "dur": 10},
        {"cat": "kernel", "name": "void at::native::reduce_kernel<128, 4>(float)", "ts": 20,
         "dur": 4},
        {"cat": "gpu_memset", "name": "Memset (Device)", "ts": 30, "dur": 2},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 40, "dur": 2},
        {"cat": "cpu_op", "name": "aten::add_", "ts": 0, "dur": 100},
        {"cat": "kernel", "name": "no duration", "ts": 0},
    ]
    got = B.device_split(events, frames=2, wall_ms=0.1)
    assert got["device_ms_per_frame"] == pytest.approx(
        {"reduce_kernel": 0.007, "unpack_modern_kernel": 0.005, "gpu_memset": 0.001,
         "gpu_memcpy": 0.001})
    assert list(got["device_ms_per_frame"])[0] == "reduce_kernel"
    assert got["busy_ms_per_frame"] == pytest.approx(0.0115)  # (15 + 4 + 2 + 2) us / 2
    assert got["busy_share"] == pytest.approx(0.23)
    assert got["device_ops_per_frame"] == 2.5


def test_vs_baseline_is_value_over_720(quick_line):
    _, line, _ = quick_line
    assert line["vs_baseline"] == line["value"] / 720
    assert "720" in line["baseline"] and "not in the repository" in line["baseline"]
    payload = line["legs"]["value"]["payload_bytes_mean"]
    assert line["unpack_gbps"] == pytest.approx((payload + 2 * 64 * 256) * line["value"] / 1e9)


def test_legs_run_only_the_named_legs(capsys, one_thread):
    rc, line, err = run_main(capsys, [*SMALL, "--legs", "legacy_fps_4k,value"])
    assert rc == 0
    assert list(line["legs"]) == ["value", "legacy_fps_4k"]  # bench.py's order
    assert line["value"] > 0 and line["legacy_fps_4k"] > 0 and line["unpack_gbps"] > 0
    for key in B.KEYS[5:]:
        if key != "legacy_fps_4k":
            assert key in line and line[key] is None, key
    assert line["latency_ms_single_frame_p90"] is None and line["latency_samples"] is None


def test_unknown_leg_and_bad_size_are_refused():
    with pytest.raises(SystemExit) as e:
        B.main(["--device", "cpu", "--legs", "value,nope"])
    assert e.value.code == 2
    for size in ("64", "0x256", "64xw"):
        with pytest.raises(SystemExit) as e:
            B.main(["--device", "cpu", "--size", size])
        assert e.value.code == 2


def off_by(t: torch.Tensor, n: int) -> torch.Tensor:
    """Each element's low byte moved by n (down where it would wrap)."""
    x = t.to(torch.int64)
    low = x & 0xFF
    return (x - low + torch.where(low < 256 - n, low + n, low - n)).to(t.dtype)


def wrong_unpack(real):
    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        x = out.to(torch.int64)
        x[..., 0, 0] ^= 1
        return x.to(out.dtype)

    return wrapped


def wrong_develop(real):
    def wrapped(*args, **kwargs):
        return off_by(real(*args, **kwargs), 2)

    return wrapped


@pytest.mark.parametrize("family, module, name, wrap, legs, what", [
    ("modern", U, "decode_modern_batch_device", wrong_unpack,
     ["value", "latency_ms_single_frame", "worst_case_fps", "fps_1080p"], "checksum"),
    ("legacy", L, "decode_legacy_batch_device", wrong_unpack, LEGACY_LEGS,
     "frame 0 checksum"),
    ("develop", D, "develop_rgba_device", wrong_develop, DEVELOP_LEGS, "develop_f64"),
])
def test_injected_wrong_output_fails_its_legs(capsys, monkeypatch, one_thread, family, module,
                                              name, wrap, legs, what):
    monkeypatch.setattr(module, name, wrap(getattr(module, name)))
    control = "legacy_fps_4k" if family == "modern" else "value"
    rc, line, err = run_main(capsys, [*SMALL, "--legs", ",".join([*legs, control])])
    assert rc == 1
    assert line[control] > 0 and line["errors"] == []
    failed = [g["leg"] for g in line["gate_failures"]]
    assert sorted(failed) == sorted(legs)
    for g in line["gate_failures"]:
        assert line[g["leg"]] is None and g["want"] != g["got"] and what in g["what"]
        if family == "develop":
            assert g["want"] == 1 and g["got"] >= 2
    assert sorted(line["legs"]) == [control]


def test_a_shared_staging_fails_the_gate(capsys, monkeypatch, one_thread):
    """Frames staged in one Staging overwrite each other's inputs: the
    gate before timing holds every staged frame, not only the last."""
    shared, staging = {}, B.Staging

    def one_staging(device):
        if str(device) not in shared:
            shared[str(device)] = staging(device)
            shared[str(device)].host(((1 << 20,), np.uint8))  # room for every frame
        return shared[str(device)]

    monkeypatch.setattr(B, "Staging", one_staging)
    rc, line, err = run_main(capsys, [*SMALL, "--legs", "value,legacy_fps_4k"])
    assert rc == 1 and line["errors"] == []
    assert [(g["leg"], g["what"]) for g in line["gate_failures"]] == [
        ("value", "frame 0 checksum"), ("legacy_fps_4k", "frame 0 checksum")]
    assert line["value"] is None and line["legacy_fps_4k"] is None


def test_a_leg_that_raises_is_an_error(capsys, monkeypatch, one_thread):
    def boom(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(L, "decode_legacy_batch_device", boom)
    rc, line, err = run_main(capsys, [*SMALL, "--legs", "value,legacy_fps_4k"])
    assert rc == 1
    assert line["errors"] == [{"leg": "legacy_fps_4k", "error": "RuntimeError: boom"}]
    assert line["legacy_fps_4k"] is None and line["value"] > 0
    assert line["gate_failures"] == []
    assert "Traceback" in err and "RuntimeError: boom" in err


def test_no_card_exits_nonzero_and_prints_no_number(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = B.main(["--quick", "--size", "64x256"])
    out, err = capsys.readouterr()
    assert rc == 2 and out == ""
    assert "no CUDA device" in err
