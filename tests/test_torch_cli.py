"""python -m mcraw_torch against python -m mcraw --backend numpy: identical
stdout, byte-identical audio.wav and DNGs, the reference's argv edges, and
no JAX in a process that only uses mcraw_torch. The subcommands info,
verify and encode and decode --pipeline / --verbose / --trace-dir against
mcraw's: identical JSON, exit codes and files (tolerance 0)."""

import collections
import contextlib
import io
import json
import logging
import os
import re
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mcraw import cli as ref_cli
from mcraw import encode as E
from mcraw.metadata import example_container_metadata, example_frame_metadata
from mcraw.pipeline import Decoder as JaxDecoder
from mcraw_torch import cli
from mcraw_torch.pipeline import Decoder

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    rng = np.random.default_rng(17)
    writer = E.ContainerWriter(example_container_metadata())
    for i in range(3):
        img = rng.integers(0, 4096, size=(16, 192), dtype=np.uint16)
        writer.add_frame(1000 + i, E.encode_modern(img),
                         example_frame_metadata(192, 16, 7))
        writer.add_audio(rng.integers(-3000, 3000, size=256).astype(np.int16),
                         i * 10**6)
    p = tmp_path_factory.mktemp("cli") / "clip.mcraw"
    p.write_bytes(writer.finish())
    return p


@pytest.fixture(scope="module")
def legacy_clip(tmp_path_factory):
    """Codec 6 at ragged and plain widths, with and without the trailing
    chunk table, and one full-range frame."""
    rng = np.random.default_rng(18)
    writer = E.ContainerWriter(example_container_metadata())
    for i, (w, maxv, table) in enumerate(
        [(200, 4095, True), (200, 65535, True), (200, 4095, False)]
    ):
        img = rng.integers(0, maxv + 1, size=(16, w), dtype=np.uint16)
        writer.add_frame(1000 + i, E.encode_legacy(img, add_offset_table=table),
                         example_frame_metadata(w, 16, 6))
        writer.add_audio(rng.integers(-3000, 3000, size=256).astype(np.int16),
                         i * 10**6)
    p = tmp_path_factory.mktemp("cli") / "legacy.mcraw"
    p.write_bytes(writer.finish())
    return p


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@contextlib.contextmanager
def _captured_stdout():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        yield buf


def _assert_same_outputs(a: Path, b: Path, n_frames: int):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert "audio.wav" in names
    assert sum(n.endswith(".dng") for n in names) == n_frames
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.mark.parametrize("n_arg, n_frames", [("2", 2), ("2x", 2)])
def test_cli_byte_parity_subprocess(clip, tmp_path, n_arg, n_frames):
    _assert_cli_parity(clip, tmp_path, n_arg, n_frames)


@pytest.mark.parametrize("n_arg, n_frames", [("3", 3), ("1", 1)])
def test_legacy_cli_byte_parity_subprocess(legacy_clip, tmp_path, n_arg, n_frames):
    _assert_cli_parity(legacy_clip, tmp_path, n_arg, n_frames)


def _assert_cli_parity(clip, tmp_path, n_arg, n_frames):
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    mine.mkdir()
    ref.mkdir()
    got = _run(["-m", "mcraw_torch", str(clip), "-n", n_arg, "--device", "cpu"],
               mine)
    want = _run(["-m", "mcraw", str(clip), "-n", n_arg, "--backend", "numpy"],
                ref)
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    assert got.stdout == want.stdout
    assert got.stdout.startswith("Found 3 frames\n")
    _assert_same_outputs(mine, ref, n_frames)


@pytest.mark.parametrize(
    "argv, n_frames",
    [
        (["-n"], 3),  # dangling -n is ignored (argc > 3 guard)
        (["-n", "1", "--bogus", "x"], 1),  # unknown extras are ignored
        ([], 3),
        (["-n", "-4"], 3),  # negative: every frame
        (["-n", "0"], 0),
    ],
)
def test_cli_argv_edges(clip, tmp_path, monkeypatch, capsys, argv, n_frames):
    """The reference's argv rules, in-process on both sides (the decoder
    pinned to the CPU / NumPy, since a dangling -n leaves no room for a
    device flag)."""
    monkeypatch.setattr(cli, "Decoder", lambda src, device: Decoder(src, "cpu"))
    monkeypatch.setattr(ref_cli, "Decoder",
                        lambda src, **kw: JaxDecoder(src, backend="numpy"))
    outs = {}
    for name, main in (("mine", cli.main), ("ref", ref_cli.main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        rc = main([str(clip), *argv])
        outs[name] = (rc, capsys.readouterr())
    (rc_a, a), (rc_b, b) = outs["mine"], outs["ref"]
    assert rc_a == rc_b == 0
    assert a.out == b.out and a.err == b.err == ""
    _assert_same_outputs(tmp_path / "mine", tmp_path / "ref", n_frames)


def test_cli_no_args_usage(capsys):
    assert cli.main([]) == ref_cli.main([]) == -1
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == cli.USAGE


def test_cli_missing_file_error_parity(tmp_path, capsys):
    missing = str(tmp_path / "nope.mcraw")
    rc_a = cli.main([missing, "--device", "cpu"])
    a = capsys.readouterr()
    rc_b = ref_cli.main([missing, "--backend", "numpy"])
    b = capsys.readouterr()
    assert rc_a == rc_b == -1
    assert a.out == b.out == ""
    assert a.err == b.err and a.err.startswith("Error: ")


def test_cli_no_card_is_a_clean_error(clip, tmp_path, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert cli.main([str(clip)]) == -1
    err = capsys.readouterr().err
    assert err.startswith("Error: ") and "no CUDA device" in err
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("demosaic", ["bilinear", "malvar"])
def test_preview_cli_parity(clip, legacy_clip, tmp_path, monkeypatch, demosaic):
    """python -m mcraw_torch preview against mcraw.cli preview (the JAX
    package's Pallas develop in interpret mode): the same stdout, PPM
    headers and sizes, pixel bytes within 1 (<= 1 LSB develop contract)."""
    for src in (clip, legacy_clip):
        mine, ref = tmp_path / src.stem / "mine", tmp_path / src.stem / "ref"
        mine.mkdir(parents=True)
        ref.mkdir()
        args = ["preview", str(src), "-n", "2", "--output-dir", "out",
                "--demosaic", demosaic]
        got = _run(["-m", "mcraw_torch", *args, "--device", "cpu"], mine)
        assert got.returncode == 0, got.stderr
        monkeypatch.chdir(ref)
        with _captured_stdout() as out:
            assert ref_cli.main(args) == 0
        assert got.stdout == out.getvalue()
        assert got.stdout == "Writing out/preview_000000.ppm\nWriting out/preview_000001.ppm\n"
        for name in ("preview_000000.ppm", "preview_000001.ppm"):
            a = (mine / "out" / name).read_bytes()
            b = (ref / "out" / name).read_bytes()
            w = 192 if src == clip else 200
            header = b"P6\n%d 16\n255\n" % w
            assert a[: len(header)] == b[: len(header)] == header
            assert len(a) == len(b) == len(header) + 16 * w * 3
            pa = np.frombuffer(a[len(header):], np.uint8).astype(np.int64)
            pb = np.frombuffer(b[len(header):], np.uint8).astype(np.int64)
            assert np.abs(pa - pb).max() <= 1


def test_preview_cli_error(tmp_path, capsys):
    missing = str(tmp_path / "nope.mcraw")
    assert cli.main(["preview", missing, "--device", "cpu"]) == -1
    a = capsys.readouterr()
    assert ref_cli.main(["preview", missing]) == -1
    b = capsys.readouterr()
    assert a.out == b.out == ""
    assert a.err == b.err and a.err.startswith("Error: ")


def test_fresh_interpreter_never_imports_jax(clip, legacy_clip, tmp_path):
    code = (
        "import sys, numpy as np, mcraw_torch\n"
        f"d = mcraw_torch.Decoder({str(clip)!r}, device='cpu')\n"
        "img, _ = d.load_frame(d.frames[0])\n"
        "assert img.shape == (16, 192) and img.dtype == np.uint16\n"
        f"d = mcraw_torch.Decoder({str(legacy_clip)!r}, device='cpu')\n"
        "img, meta = d.load_frame(d.frames[0])\n"
        "assert meta['compressionType'] == 6\n"
        "assert img.shape == (16, 200) and img.dtype == np.uint16\n"
        "from mcraw_torch.preview import preview_frame_rgba\n"
        "rgba = preview_frame_rgba(d, d.frames[0], demosaic='malvar')\n"
        "assert rgba.shape == (16, 200) and str(rgba.dtype) == 'torch.uint32'\n"
        "import mcraw_torch.cli, mcraw_torch.kernels.checksum\n"
        "import contextlib, io, tempfile, mcraw_torch.observe\n"
        "from mcraw_torch.clip import export_clip\n"
        f"s = export_clip(mcraw_torch.Decoder({str(clip)!r}, device='cpu'), tempfile.mkdtemp())\n"
        "assert s.frames_done == 3 and s.frames_failed == 0\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        f"    rc = mcraw_torch.cli.main(['verify', {str(legacy_clip)!r}, '--device', 'cpu'])\n"
        "assert rc == 0\n"
        "print('jax' in sys.modules)\n"
    )
    res = _run(["-c", code], tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"


# -- the decode subcommand and --batch -------------------------------------------


def _in_process(main, argv, cwd, monkeypatch, capsys):
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    rc = main(argv)
    return rc, capsys.readouterr()


@pytest.mark.parametrize("batch", [[], ["--batch"], ["--batch", "--batch-frames", "2"],
                                   ["--batch", "--batch-frames", "1"]])
@pytest.mark.parametrize("which, n", [("modern", "2"), ("modern", "-1"), ("legacy", "3"),
                                      ("legacy", "0")])
def test_decode_subcommand_parity(clip, legacy_clip, tmp_path, monkeypatch, capsys,
                                  which, n, batch):
    """python -m mcraw_torch decode [--batch] against python -m mcraw decode
    --backend numpy, in-process: the same exit code, stdout and stderr, and
    byte-identical audio.wav and DNGs (tolerance 0)."""
    src = str(clip if which == "modern" else legacy_clip)
    rc_a, a = _in_process(cli.main, ["decode", src, "-n", n, "--device", "cpu", *batch],
                          tmp_path / "mine", monkeypatch, capsys)
    rc_b, b = _in_process(ref_cli.main, ["decode", src, "-n", n, "--backend", "numpy"],
                          tmp_path / "ref", monkeypatch, capsys)
    assert rc_a == rc_b == 0
    assert a.out == b.out and a.err == b.err == ""
    _assert_same_outputs(tmp_path / "mine", tmp_path / "ref", 3 if n == "-1" else int(n))


@pytest.mark.parametrize("which", ["modern", "legacy"])
def test_decode_batch_subprocess_parity(clip, legacy_clip, tmp_path, which):
    """The module entry point: python -m mcraw_torch decode --batch against
    python -m mcraw decode --backend numpy, byte for byte."""
    src = str(clip if which == "modern" else legacy_clip)
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    mine.mkdir()
    ref.mkdir()
    got = _run(["-m", "mcraw_torch", "decode", src, "-n", "3", "--batch", "--batch-frames",
                "2", "--device", "cpu", "--output-dir", "out"], mine)
    want = _run(["-m", "mcraw", "decode", src, "-n", "3", "--backend", "numpy",
                 "--output-dir", "out"], ref)
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    assert got.stdout == want.stdout
    assert got.stdout.splitlines()[-1] == "Writing out/frame_000002.dng"
    _assert_same_outputs(mine / "out", ref / "out", 3)


@pytest.mark.parametrize("frames", ["0", "-3"])
def test_batch_frames_must_be_positive(clip, tmp_path, monkeypatch, capsys, frames):
    """The reference's check, after it has written audio.wav."""
    argv = ["decode", str(clip), "--batch", "--batch-frames", frames]
    rc_a, a = _in_process(cli.main, [*argv, "--device", "cpu"], tmp_path / "mine",
                          monkeypatch, capsys)
    rc_b, b = _in_process(ref_cli.main, [*argv, "--backend", "numpy"], tmp_path / "ref",
                          monkeypatch, capsys)
    assert rc_a == rc_b == -1
    assert a.out == b.out == "Found 3 frames\n"
    assert a.err == b.err == "Error: --batch-frames must be positive\n"
    _assert_same_outputs(tmp_path / "mine", tmp_path / "ref", 0)


def test_batch_does_not_skip_under_resume(clip, tmp_path, monkeypatch, capsys):
    """As the reference's batch branch: --resume skips nothing with
    --batch, and every frame is written again."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "frame_000000.dng").write_bytes(b"stale")
    assert cli.main(["decode", str(clip), "-n", "2", "--batch", "--resume",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[1:] == ["Writing frame_000000.dng", "Writing frame_000001.dng"]
    assert (tmp_path / "frame_000000.dng").read_bytes() != b"stale"
    assert cli.main(["decode", str(clip), "-n", "2", "--resume", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == "Found 3 frames\n"


def test_decode_subcommand_parses_strictly(clip, capsys):
    """`decode` takes no unknown arguments (an argparse error, exit 2, as
    mcraw's); `<file> ...` ignores them."""
    for main in (cli.main, ref_cli.main):
        with pytest.raises(SystemExit) as e:
            main(["decode", str(clip), "--bogus"])
        assert e.value.code == 2
    capsys.readouterr()


def test_decode_subcommand_missing_file_parity(tmp_path, capsys):
    missing = str(tmp_path / "nope.mcraw")
    rc_a = cli.main(["decode", missing, "--device", "cpu"])
    a = capsys.readouterr()
    rc_b = ref_cli.main(["decode", missing, "--backend", "numpy"])
    b = capsys.readouterr()
    assert rc_a == rc_b == -1
    assert a.out == b.out == "" and a.err == b.err and a.err.startswith("Error: Failed to open")


# -- info, verify, encode ----------------------------------------------------------


def _frames_clip(rng, frames, audio=True, container=None) -> bytes:
    """A clip of (codec, width, height, payload or None) frames: None encodes
    a 12-bit image of that geometry with mcraw's encoder."""
    writer = E.ContainerWriter(example_container_metadata() if container is None
                               else container)
    for i, (codec, w, h, payload) in enumerate(frames):
        if payload is None:
            img = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
            payload = E.encode_modern(img) if codec == 7 else E.encode_legacy(img)
        writer.add_frame(1 + i, payload, example_frame_metadata(w, h, codec))
    if audio:
        writer.add_audio(np.zeros(32, np.int16), 500)
    return writer.finish()


def _modern_bits_offset_past_end(rng) -> bytes:
    img = rng.integers(0, 1024, size=(8, 64), dtype=np.uint16)
    payload = bytearray(E.encode_modern(img))
    ew, eh, bo, ro = struct.unpack("<IIII", payload[:16])
    payload[:16] = struct.pack("<IIII", ew, eh, len(payload) + 9, ro)
    return bytes(payload)


def _legacy_exact_length(rng) -> bytes:
    from mcraw.kernels import tables as JT

    leg = E.encode_legacy(rng.integers(0, 1024, size=(8, 64), dtype=np.uint16))
    return leg[: 2 + int(JT.LEGACY_BLOCK_LENGTH[min(leg[0] >> 4, 16)])]


def _skipped_audio(rng) -> bytes:
    writer = E.ContainerWriter(example_container_metadata())
    img = rng.integers(0, 1024, size=(8, 64), dtype=np.uint16)
    writer.add_frame(1, E.encode_modern(img), example_frame_metadata(64, 8))
    writer.add_audio(np.zeros(32, np.int16), 500)
    writer._audio_offsets.insert(0, (-128, 0))  # the reference-skip class
    return writer.finish()


# The clips of tests/test_clip_export.py's verify tests, and mixed ones.
VERIFY_CLIPS = {
    "ok": lambda rng: _frames_clip(rng, [(7, 64, 8, None)] * 2),
    "corrupt": lambda rng: _frames_clip(rng, [(7, 64, 8, None), (7, 64, 8, b"\x00" * 8),
                                              (7, 64, 8, None)]),
    "quick_structural": lambda rng: _frames_clip(rng, [
        (7, 64, 8, _modern_bits_offset_past_end(rng)),
        (6, 64, 8, E.encode_legacy(rng.integers(0, 1024, size=(8, 64), dtype=np.uint16))[:3])]),
    "skipped_audio": _skipped_audio,
    "legacy_exact_length": lambda rng: _frames_clip(rng, [(6, 64, 8, _legacy_exact_length(rng))]),
    "mixed": lambda rng: _frames_clip(rng, [(7, 192, 16, None), (6, 200, 16, None),
                                            (7, 128, 8, None), (6, 96, 12, None)]),
    "legacy_corrupt": lambda rng: _frames_clip(rng, [(6, 96, 8, None), (6, 96, 8, b"\x10" * 8)]),
    "bad_codec": lambda rng: _frames_clip(rng, [(7, 64, 8, None), (5, 64, 8, b"\x00" * 64)]),
}
INFO_CLIPS = {
    "modern": lambda rng: _frames_clip(rng, [(7, 192, 16, None)] * 3),
    "legacy": lambda rng: _frames_clip(rng, [(6, 200, 16, None)] * 2),
    "mixed": VERIFY_CLIPS["mixed"],
    "frameless": lambda rng: _frames_clip(rng, []),
    "non_object_json": lambda rng: _frames_clip(rng, [(7, 64, 8, None)], container=b"[1, 2]"),
    "nan_json": lambda rng: _frames_clip(rng, [(7, 64, 8, None)], container=json.dumps(
        example_container_metadata()).replace("1023.0", "NaN").encode()),
    "missing": None,
}


def _clip_file(tmp_path, makers, name) -> str:
    p = tmp_path / f"{name}.mcraw"
    if makers[name] is not None:
        p.write_bytes(makers[name](np.random.default_rng(sorted(makers).index(name))))
    return str(p)


def _both(mine: list[str], ref: list[str], tmp_path, monkeypatch, capsys):
    """Run cli.main(mine) and ref_cli.main(ref) in-process, each in its own
    working directory: ((rc, out, err) of each)."""
    got = _in_process(cli.main, mine, tmp_path / "mine", monkeypatch, capsys)
    want = _in_process(ref_cli.main, ref, tmp_path / "ref", monkeypatch, capsys)
    return (got[0], got[1].out, got[1].err), (want[0], want[1].out, want[1].err)


@pytest.mark.parametrize("name", sorted(INFO_CLIPS))
def test_info_parity(tmp_path, monkeypatch, capsys, name):
    """info: the same JSON (or the same Error line), the same exit code."""
    src = _clip_file(tmp_path, INFO_CLIPS, name)
    got, want = _both(["info", src], ["info", src], tmp_path, monkeypatch, capsys)
    assert got == want
    if name == "non_object_json":
        assert json.loads(got[1])["audio_sample_rate"] is None
    if name in ("nan_json", "missing"):
        assert got[0] == -1 and got[2].startswith("Error: ")


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("name", sorted(VERIFY_CLIPS) + ["missing"])
def test_verify_parity(tmp_path, monkeypatch, capsys, name, quick):
    """verify [--quick] on the CPU against mcraw's verify --backend numpy:
    the same JSON report and exit code."""
    src = _clip_file(tmp_path, VERIFY_CLIPS | {"missing": None}, name)
    mode = ["--quick"] if quick else []
    got, want = _both(["verify", src, "--device", "cpu", *mode],
                      ["verify", src, "--backend", "numpy", *mode], tmp_path, monkeypatch, capsys)
    assert got == want
    report = json.loads(got[1])
    assert got[0] == (0 if report["ok"] else 1)
    # --quick reads only the first legacy header, which legacy_corrupt keeps.
    assert report["ok"] == (name in ("ok", "mixed", "skipped_audio")
                            or (quick and name == "legacy_corrupt"))


def test_verify_no_card_is_a_clean_error(clip, monkeypatch, capsys):
    """A full verify resolves the device before it opens the clip: no card
    is the command's error (exit -1), not a container_error. --quick reads
    only the container and needs no card."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["verify", str(clip)]) == -1
    out = capsys.readouterr()
    assert out.out == "" and out.err.startswith("Error: ") and "no CUDA device" in out.err
    assert cli.main(["verify", str(clip), "--quick"]) == 0
    assert json.loads(capsys.readouterr().out)["ok"]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("codec, width", [(7, 192), (6, 200)])
def test_encode_parity(tmp_path, monkeypatch, capsys, codec, width, seed):
    """encode writes the same bytes and stdout as mcraw's encode."""
    argv = ["encode", "out.mcraw", "--codec", str(codec), "--frames", "2", "--width",
            str(width), "--height", "16", "--seed", str(seed)]
    got, want = _both(argv, argv, tmp_path, monkeypatch, capsys)
    assert got == want == (0, "Wrote out.mcraw\n", "")
    blob = (tmp_path / "mine" / "out.mcraw").read_bytes()
    assert blob == (tmp_path / "ref" / "out.mcraw").read_bytes()
    d = Decoder(blob, device="cpu")
    assert len(d.frames) == 2 and d.load_frame(d.frames[1])[0].shape == (16, width)


# -- decode --pipeline, --verbose, --trace-dir ----------------------------------------


def _assert_pipeline_stdout(out: str, ref: str, frames: int):
    """The same Found line, a clean Writing line per written frame, the same
    written paths as a multiset (the writer threads finish in no fixed
    order, and mcraw's print a line and its newline apart, so its lines may
    run together), then the Exported line."""
    a, b = out.splitlines(), ref.splitlines()
    assert a[0] == b[0] and a[0].startswith("Found ") and len(a) == frames + 2
    assert all(re.fullmatch(r"Writing \S+\.dng", ln) for ln in a[1:-1])
    written = [re.findall(r"Writing (\S+?\.dng)", text) for text in (out, ref)]
    assert sorted(written[0]) == sorted(written[1]) and len(written[0]) == frames
    assert a[-1].startswith(f"Exported {frames} frames in ") and a[-1].endswith(" fps)")


@pytest.mark.parametrize("extra, frames", [([], None), (["-n", "2"], 2),
                                           (["--batch", "--batch-frames", "0"], None)])
@pytest.mark.parametrize("which", ["modern", "legacy", "mixed", "corrupt"])
def test_decode_pipeline_parity(clip, legacy_clip, tmp_path, monkeypatch, capsys, which,
                                extra, frames):
    """decode --pipeline against mcraw's with --backend numpy, in-process:
    exit code 0, stdout as _assert_pipeline_stdout, the same stderr (a
    failed frame's Error line), byte-identical audio.wav and DNGs. The
    pipeline comes before the --batch-frames check, as in the reference."""
    if which in ("modern", "legacy"):
        src = str(clip if which == "modern" else legacy_clip)
    else:
        src = _clip_file(tmp_path, VERIFY_CLIPS, which)
    n_all = len(Decoder(src, device="cpu").frames)
    got, want = _both(["decode", src, "--pipeline", "--device", "cpu", *extra],
                      ["decode", src, "--pipeline", "--backend", "numpy", *extra],
                      tmp_path, monkeypatch, capsys)
    assert got[0] == want[0] == 0
    failed = 1 if which == "corrupt" else 0
    _assert_pipeline_stdout(got[1], want[1], (frames or n_all) - failed)
    assert got[2] == want[2]
    if failed:
        assert got[2] == "Error: frame 2: Failed to uncompress frame\n"
    _assert_same_outputs(tmp_path / "mine", tmp_path / "ref", (frames or n_all) - failed)


def test_decode_pipeline_resume_and_entry_point(clip, tmp_path):
    """python -m mcraw_torch <clip> --pipeline --resume, the reference's
    argv shape: a DNG that exists is skipped, as by mcraw's."""
    outs = {}
    for name, cmd in (("mine", ["-m", "mcraw_torch", str(clip), "--pipeline", "--resume",
                                "--device", "cpu"]),
                      ("ref", ["-m", "mcraw", str(clip), "--pipeline", "--resume",
                               "--backend", "numpy"])):
        cwd = tmp_path / name
        cwd.mkdir()
        (cwd / "frame_000001.dng").write_bytes(b"stale")
        outs[name] = _run(cmd, cwd)
    got, want = outs["mine"], outs["ref"]
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    _assert_pipeline_stdout(got.stdout, want.stdout, 2)
    assert "Writing frame_000001.dng" not in got.stdout
    _assert_same_outputs(tmp_path / "mine", tmp_path / "ref", 3)
    assert (tmp_path / "mine" / "frame_000001.dng").read_bytes() == b"stale"


@pytest.mark.parametrize("pipeline", [True, False])
def test_decode_verbose(clip, tmp_path, pipeline):
    """--verbose: JSON-line events on stderr; with --pipeline a
    stage_timing event with parse, unpack and emit, and the stage timing
    and throughput lines, as mcraw's; without it, nothing (as mcraw's)."""
    flags = ["--pipeline"] if pipeline else []
    res = _run(["-m", "mcraw_torch", "decode", str(clip), "--verbose", "--device", "cpu",
                *flags], tmp_path)
    assert res.returncode == 0, res.stderr
    if not pipeline:
        assert res.stderr == ""
        return
    events = {e["event"]: e for e in map(json.loads, res.stderr.splitlines()[:3])}
    assert set(events) == {"export_clip_start", "stage_timing", "export_clip_done"}
    assert events["export_clip_start"]["backend"] == "cpu"
    timing = events["stage_timing"]
    assert {"parse", "unpack", "emit"} <= set(timing) and timing["emit"]["count"] == 3
    lines = res.stderr.splitlines()[3:]
    assert lines[0].startswith("stage timing: {") and lines[1].startswith("throughput: {")
    assert len(lines) == 2


@pytest.mark.parametrize("pipeline", [True, False])
def test_decode_trace_dir(clip, tmp_path, monkeypatch, capsys, caplog, pipeline):
    """--trace-dir D: a torch.profiler Chrome trace of the decode in D, the
    outputs as without it. The program's spans are on: each frame's H2D
    and unpack, the split of the Decoder's "unpack" stage, are in the
    trace where the thread that started the profiler decodes (without
    --pipeline), and in the spans' record from every thread."""
    monkeypatch.chdir(tmp_path)
    flags = ["--pipeline"] if pipeline else []
    with caplog.at_level(logging.INFO, logger="mcraw_torch"):
        assert cli.main(["decode", str(clip), "--device", "cpu", "--trace-dir", "t",
                         *flags]) == 0
    traces = list((tmp_path / "t").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    if not pipeline:
        spans = collections.Counter(e.get("name") for e in events
                                    if str(e.get("name", "")).startswith("mcraw."))
        assert spans["mcraw.stage.h2d"] == spans["mcraw.unpack.modern"] == 3
        assert spans["mcraw.stage.scan"] == spans["mcraw.offsets"] == 3
    (timing,) = [e for e in map(json.loads, (r.message for r in caplog.records))
                 if e["event"] == "span_timing"]
    assert timing["spans"]["stage.h2d"]["count"] == timing["spans"]["unpack.modern"]["count"] == 3
    assert len(list(tmp_path.glob("frame_*.dng"))) == 3
    assert capsys.readouterr().out.splitlines()[0] == "Found 3 frames"


def test_decode_trace_dir_verbose_logs_span_timing(clip, tmp_path):
    """--trace-dir with --verbose: one span_timing event on stderr, the
    spans' summary and counters."""
    res = _run(["-m", "mcraw_torch", "decode", str(clip), "--verbose", "--device", "cpu",
                "--trace-dir", "t"], tmp_path)
    assert res.returncode == 0, res.stderr
    (event,) = [json.loads(ln) for ln in res.stderr.splitlines() if ln.startswith("{")]
    assert event["event"] == "span_timing"
    assert event["spans"]["unpack.modern"]["count"] == 3
    assert event["spans"]["stage.h2d"]["count"] == 3 and event["counters"]["h2d_bytes"] > 0


def test_decode_trace_dir_no_card_is_a_clean_error(clip, tmp_path, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert cli.main([str(clip), "--trace-dir", "t"]) == -1
    err = capsys.readouterr().err
    assert err.startswith("Error: ") and "no CUDA device" in err
    assert not list(tmp_path.iterdir())
