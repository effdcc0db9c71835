"""python -m mcraw_torch against python -m mcraw --backend numpy: identical
stdout, byte-identical audio.wav and DNGs, the reference's argv edges, and
no JAX in a process that only uses mcraw_torch."""

import contextlib
import io
import os
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


def test_cli_unported_subcommand(capsys):
    assert cli.main(["info", "clip.mcraw"]) == 2
    assert "not yet ported" in capsys.readouterr().err


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


@pytest.mark.parametrize("flag", [["--pipeline"], ["--verbose"], ["--trace-dir", "t"]])
@pytest.mark.parametrize("sub", [True, False])
def test_decode_flags_not_yet_ported(clip, tmp_path, monkeypatch, capsys, flag, sub):
    monkeypatch.chdir(tmp_path)
    argv = (["decode"] if sub else []) + [str(clip), *flag]
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err and flag[0] in err
    assert not list(tmp_path.iterdir())


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
