"""The soak's command line and its reports, on the CPU: it runs every leg
and prints a row each; it swallows nothing (an injected wrong decoder is a
failure with a reproducer and a non-zero exit, a child killed by a signal is
a CRASH row with its leg, seed, iteration and path); ``--device cuda``
without a card raises and falls back to nothing; the parity grid's cases
and contents (``tools/hw_parity.py``'s)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcraw_torch import soak as S
from mcraw_torch.errors import MotionCamException

ROOT = Path(__file__).resolve().parents[1]


# -- the soak swallows nothing ----------------------------------------------------------


def _soak(args, timeout=240):
    res = subprocess.run([sys.executable, "-m", "mcraw_torch.soak", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    rows = [json.loads(ln) for ln in res.stdout.splitlines()
            if ln.startswith("{") and '"leg"' in ln and '"at"' not in ln]
    return res, rows


def test_soak_runs_every_leg_on_the_cpu(tmp_path):
    """``python -m mcraw_torch.soak --device cpu``: a row per leg, each
    with iterations and no failure, exit 0; the seed is printed."""
    res, rows = _soak(["--device", "cpu", "--iterations", "1", "--seed", "1",
                       "--failures", str(tmp_path)])
    assert res.returncode == 0, res.stderr[-3000:]
    head = json.loads(res.stdout.splitlines()[0])
    assert head["soak"]["seed"] == 1 and head["soak"]["device"] == "cpu"
    assert sorted(r["leg"] for r in rows) == sorted(S.LEGS)
    for r in rows:
        assert r["iterations"] == 1 and r["failures"] == r["crashes"] == 0, r
        assert not any(r["launches"].values())
    decode = [r for r in rows if r["leg"] in S.DECODE_LEGS]
    for r in decode:
        assert r["paths"]["decode_batch_iter"]["calls"] == 1
        assert all(r["paths"][p]["calls"] >= 2 for p in S.PATHS if p != "decode_batch_iter")


def test_injected_wrong_decoder_is_a_failure(tmp_path):
    res, rows = _soak(["--device", "cpu", "--iterations", "1", "--seed", "3", "--legs",
                       "codec", "--inject", "wrong", "--failures", str(tmp_path)])
    assert res.returncode == 1
    (row,) = rows
    assert row["failures"] >= 2 and row["crashes"] == 0
    failed = [json.loads(ln)["failure"] for ln in res.stderr.splitlines()
              if ln.startswith('{"failure"')]
    assert {f["path"] for f in failed} == {"load_frame_device"}
    assert {f["codec"] for f in failed} == {6, 7}
    repro = sorted(tmp_path.glob("FAIL_codec_s3_i1_load_frame_device_*.npz"))
    assert len(repro) == 2
    z = np.load(repro[0])
    meta = json.loads(str(z["row"]))
    assert (meta["leg"], meta["seed"], meta["iteration"]) == ("codec", 3, 1)
    assert {"clip", "codec", "width", "height", "payload_0", "source_0"} <= set(z.files)
    f0 = S.Frame(int(z["codec"][0]), z["payload_0"].tobytes(), int(z["width"][0]),
                 int(z["height"][0]), z["source_0"])
    assert S.Leg._plain(f0).same(S.Outcome((f0.source,), None))


def test_child_killed_by_a_signal_is_a_crash_row(tmp_path):
    res, rows = _soak(["--device", "cpu", "--iterations", "2", "--seed", "5", "--legs",
                       "malformed,json", "--inject", "crash", "--failures", str(tmp_path)])
    assert res.returncode == 1
    by_leg = {r["leg"]: r for r in rows}
    assert set(by_leg) == {"malformed", "json"}
    for leg, path in (("malformed", "codecs"), ("json", "json")):
        r = by_leg[leg]
        assert r["status"] == "CRASH" and r["crashes"] == 1 and r["returncode"] == -9, r
        assert (r["seed"], r["iteration"], r["path"]) == (5, 1, path)
    kept = by_leg["malformed"]["reproducer"]
    assert Path(kept).name == "CRASH_malformed_s5_i1_codecs.npz" and Path(kept).exists()
    assert json.loads(str(np.load(kept)["row"]))["iteration"] == 1


def test_soak_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(MotionCamException, match="no CUDA device"):
        S.main(["--seconds", "1", "--failures", str(tmp_path)])
    with pytest.raises(MotionCamException, match="no CUDA device"):
        S.main(["--grid", "--quick", "--out", str(tmp_path / "g.json")])
    assert not (tmp_path / "g.json").exists()


def test_grid_case_on_the_cpu():
    """One small grid case of each codec: every path and the develop
    within 1 LSB."""
    for codec in (7, 6):
        row = S.grid_case("ragged", "mix16", codec, "cpu")
        assert row["status"] == "OK", row
        assert set(row["paths"]) == set(S.PATHS) | {"export_clip", "develop_bilinear",
                                                    "develop_malvar"}
        assert max(row["develop"].values()) <= 1


def test_grid_contents_equal_tools():
    from tools import hw_parity as HP

    assert S.GEOMETRIES == HP.GEOMETRIES and S.CONTENTS == HP.CONTENTS
    for content in S.CONTENTS:
        assert np.array_equal(S.make_img(48, 288, content), HP.make_img(48, 288, content))
