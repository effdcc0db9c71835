"""mcraw_torch stands alone: it imports nothing of mcraw and nothing of JAX,
and its copies of mcraw's NumPy-only modules equal their originals.

- A fresh interpreter that refuses every import of ``mcraw``, ``mcraw.*``
  and ``jax`` imports every module of the port, writes a small clip with the
  port's own encoder, decodes it (also split over a mesh of repeated CPU
  entries), develops it, exports it under a trace, verifies it and splits
  a clip between processes with ``distributed.frame_shard``, on the CPU.
- No file of the port and not ``chip_smoke.py`` holds an ``import mcraw``
  or ``from mcraw`` statement (read from the syntax tree).
- Each copy against its original, with mcraw as the reference side: the
  codec tables, the numpy_ref helpers, the C++ host scans, the encoder and
  the container writer, the colour interpolation, the metadata fixtures,
  the error classes and the Decoder's error texts.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mcraw import color as JC
from mcraw import encode as JE
from mcraw import errors as JX
from mcraw import metadata as JM
from mcraw import pipeline as JP
from mcraw import util as JU
from mcraw.kernels import native as JN
from mcraw.kernels import numpy_ref as JR
from mcraw.kernels import tables as JT
from mcraw_torch import color as PC
from mcraw_torch import encode as PE
from mcraw_torch import errors as PX
from mcraw_torch import metadata as PM
from mcraw_torch import pipeline as PP
from mcraw_torch import util as PU
from mcraw_torch.kernels import legacy as L
from mcraw_torch.kernels import native as PN
from mcraw_torch.kernels import numpy_ref as PR
from mcraw_torch.kernels import tables as PT

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in (ROOT / "mcraw_torch").rglob("*.py"))

BLOCKED_RUN = r"""
import importlib, importlib.abc, json, pkgutil, sys, tempfile
from pathlib import Path


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name in ("mcraw", "jax") or name.startswith(("mcraw.", "jax.")):
            raise ImportError(f"import of {name} refused")
        return None


sys.meta_path.insert(0, Refuse())

import numpy as np
import mcraw_torch

modules = [m.name for m in pkgutil.walk_packages(mcraw_torch.__path__, "mcraw_torch.")]
for name in modules:
    importlib.import_module(name)

from mcraw_torch import encode as E, preview as P
from mcraw_torch.metadata import example_container_metadata, example_frame_metadata

rng = np.random.default_rng(5)
writer = E.ContainerWriter(example_container_metadata(sensor="bggr", white_level=4095.0))
imgs = []
for i, (codec, w) in enumerate([(7, 192), (6, 200), (7, 130)]):
    img = rng.integers(0, 4096, size=(12, w), dtype=np.uint16)
    payload = E.encode_modern(img) if codec == 7 else E.encode_legacy(img)
    writer.add_frame(100 + i, payload, example_frame_metadata(w, 12, codec))
    writer.add_audio(rng.integers(-99, 99, size=64).astype(np.int16), i * 10**6)
    imgs.append(img)
path = Path(tempfile.mkdtemp()) / "clip.mcraw"
path.write_bytes(writer.finish())

errs = []
with mcraw_torch.Decoder(str(path), device="cpu") as d:
    for ts, img in zip(d.frames, imgs):
        got, meta = d.load_frame(ts)
        assert np.array_equal(got, img), ts
        for demosaic in ("bilinear", "malvar"):
            rgba = P.preview_frame_rgba(d, ts, demosaic=demosaic)
            assert rgba.shape == img.shape and str(rgba.dtype) == "torch.uint32"
            a = rgba.numpy().astype(np.int64)
            rgb = np.stack([(a >> s) & 0xFF for s in (0, 8, 16)], -1)
            cm = d.container_metadata
            fwd, _, _ = P.interpolated_matrices(cm, meta["asShotNeutral"])
            want = P.develop_f64(img, cm["blackLevel"], cm["whiteLevel"],
                                 meta["asShotNeutral"], fwd, (2, 1, 1, 0),
                                 demosaic=demosaic)
            errs.append(int(np.abs(rgb - want).max()))
    audio = d.load_audio()
    # The batch surface: runs of one (codec, geometry), the latency path,
    # the batched preview, the CPU codecs and the CLI's decode --batch.
    runs = [tuple(x.shape) for x, _ in d.decode_batch_iter(chunk_frames=2)]
    fd = d.make_frame_decoder()
    for ts, img in zip(d.frames, imgs):
        assert np.array_equal(fd(ts)[0].numpy(), img), ts
    clip = list(P.preview_clip(d, None, 2))
    assert [ts for ts, _ in clip] == d.frames
    payload, meta = d._reader.frame_payload(d.frames[0])
    assert np.array_equal(mcraw_torch.decode_modern(payload, 192, 12, device="cpu"), imgs[0])
    payload, meta = d._reader.frame_payload(d.frames[1])
    assert np.array_equal(mcraw_torch.decode_legacy(payload, 200, 12, device="cpu"), imgs[1])
    stream = [c for c in d.load_audio_stream()]
from mcraw_torch import cli
rc = cli.main(["decode", str(path), "--batch", "--batch-frames", "2", "--device", "cpu",
               "--output-dir", str(path.parent / "out")])
assert rc == 0 and len(list((path.parent / "out").glob("frame_*.dng"))) == 3
# The export, its observability and the rest of the CLI.
from mcraw_torch.clip import export_clip
from mcraw_torch.observe import device_trace
with mcraw_torch.Decoder(str(path), device="cpu") as d, device_trace(str(path.parent / "t"),
                                                                     "cpu"):
    stats = export_clip(d, str(path.parent / "export"), prefetch=2, writers=2)
# The mesh surface and the multi-process split.
from mcraw_torch import distributed, parallel
with mcraw_torch.Decoder(str(path), device="cpu") as d:
    mesh = parallel.Mesh(("cpu",) * 3)
    sharded = [np.array_equal(d.load_frame_sharded(ts, mesh)[0].numpy(), img)
               for ts, img in zip(d.frames, imgs)]
    batch, _ = d.decode_batch(d.frames[:1], mesh=parallel.Mesh(("cpu",)))
    sharded.append(np.array_equal(batch.numpy()[0], imgs[0]))
shard = distributed.frame_shard(list(range(5)), 1, 2)
same = all((path.parent / "export" / f"frame_{i:06d}.dng").read_bytes()
           == (path.parent / "out" / f"frame_{i:06d}.dng").read_bytes() for i in range(3))
traces = len(list((path.parent / "t").glob("*.pt.trace.json")))
verify = [cli.main(["verify", str(path), *mode]) for mode in (["--device", "cpu"], ["--quick"])]
info = cli.main(["info", str(path)])
leaked = sorted(m for m in sys.modules
                if m in ("mcraw", "jax") or m.startswith(("mcraw.", "jax.")))
print(json.dumps({"modules": len(modules), "frames": len(imgs), "f64_err": max(errs),
                  "audio_chunks": len(audio), "stream_chunks": len(stream), "runs": runs,
                  "programs": fd.num_programs, "exported": stats.frames_done,
                  "stages": sorted(stats.stage_timing), "same_dngs": same, "traces": traces,
                  "verify": verify, "info": info, "sharded": sharded, "frame_shard": shard,
                  "leaked": leaked}))
"""


def test_runs_with_mcraw_and_jax_refused(tmp_path):
    """Every module of the port imports, and a clip written by the port's
    encoder decodes exactly and develops within 1 LSB of the f64 model,
    in a process where importing mcraw or jax raises."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["modules"] == len(PORT_FILES) - 1  # every .py but the package root
    assert out["frames"] == 3 and out["audio_chunks"] == out["stream_chunks"] == 3
    assert out["runs"] == [[1, 12, 192], [1, 12, 200], [1, 12, 130]]
    assert out["programs"] == 3
    assert out["exported"] == 3 and out["same_dngs"] and out["traces"] == 1
    assert out["stages"] == ["emit", "parse", "unpack"]
    assert out["verify"] == [0, 0] and out["info"] == 0
    assert out["sharded"] == [True] * 4 and out["frame_shard"] == [[2, 3, 4], 2]
    assert out["f64_err"] <= 1
    assert out["leaked"] == []


def _imports_of_mcraw(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names
                  if n in ("mcraw", "jax") or n.startswith(("mcraw.", "jax."))]
    return found


@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py"])
def test_no_import_of_mcraw_or_jax(rel):
    assert _imports_of_mcraw(ROOT / rel) == []


def test_ast_check_sees_an_import_of_mcraw(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom mcraw.kernels import tables\ndef f():\n    import jax\n")
    assert _imports_of_mcraw(p) == ["mcraw.kernels", "jax"]


# -- tables and numpy_ref -------------------------------------------------------

TABLE_NAMES = sorted(n for n in vars(JT) if n.isupper())


def test_table_names_all_copied():
    assert TABLE_NAMES and all(hasattr(PT, n) for n in TABLE_NAMES)


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_table_equal(name):
    a, b = getattr(JT, name), getattr(PT, name)
    if isinstance(a, np.ndarray):
        assert b.dtype == a.dtype and np.array_equal(a, b)
    else:
        assert a == b


def test_numpy_ref_helpers_equal():
    assert PR.METADATA_OFFSET == JR.METADATA_OFFSET
    rng = np.random.default_rng(1)
    for _ in range(20):
        hdr = rng.integers(0, 256, size=16 + int(rng.integers(0, 9)), dtype=np.uint8)
        assert PR.read_metadata_header(hdr) == JR.read_metadata_header(hdr)
    for w in range(0, 640, 7):
        assert PR.legacy_padded_width(w) == JR.legacy_padded_width(w)
        for h in (0, 1, 5, 8, 33):
            assert PR.modern_block_geometry(w, h) == JR.modern_block_geometry(w, h)
    with pytest.raises(PX.DecodeError, match="payload too short"):
        PR.read_metadata_header(np.zeros(15, np.uint8))


@pytest.mark.parametrize("table", [True, False])
def test_legacy_chunk_offsets_equal(table):
    img = np.random.default_rng(2).integers(0, 4096, size=(40, 96), dtype=np.uint16)
    data = np.frombuffer(JE.encode_legacy(img, chunk_rows=8, add_offset_table=table),
                         np.uint8)
    got = PR.legacy_chunk_offsets(data)
    assert got == JR.legacy_chunk_offsets(data)
    assert bool(got) == table


# -- the C++ host scans ------------------------------------------------------------


def test_native_builds_without_fallback():
    assert PN.have_native()
    assert PN.build().exists()


@pytest.mark.parametrize("seed", range(4))
def test_metadata_scan_equals_mcraw(seed):
    """Both metadata streams of encoded frames, then a random stream."""
    rng = np.random.default_rng(10 + seed)
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 400))
    img = rng.integers(0, 1 << int(rng.integers(1, 17)), size=(h, w), dtype=np.uint16)
    payload = np.frombuffer(JE.encode_modern(img), np.uint8)
    _, _, bits_off, refs_off = JR.read_metadata_header(payload)
    for off in (bits_off, refs_off):
        got, want = PN.decode_metadata_stream(payload, off), JN.decode_metadata_stream(payload, off)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])
    junk = rng.integers(0, 256, size=2048, dtype=np.uint8)
    junk[:4] = np.frombuffer(np.uint32(int(rng.integers(1, 3000))).tobytes(), np.uint8)
    outcome = []
    for scan in (PN.decode_metadata_stream, JN.decode_metadata_stream):
        try:
            vals, end = scan(junk, 0)
            outcome.append((vals.tolist(), end))
        except Exception as e:  # noqa: BLE001 - compare what each raises
            outcome.append((type(e).__name__, str(e)))
    assert outcome[0] == outcome[1]


def _legacy_payload(seed: int, table: bool):
    rng = np.random.default_rng(20 + seed)
    h, w = 24 + 8 * seed, 64 + 40 * seed
    img = rng.integers(0, 1 << (4 + 4 * seed), size=(h, w), dtype=np.uint16)
    data = np.frombuffer(JE.encode_legacy(img, chunk_rows=4, add_offset_table=table),
                         np.uint8)
    return data, L.num_blocks(w, h)


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("table", [True, False])
def test_legacy_scans_equal_mcraw(seed, table):
    """Serial, chunk-parallel and speculative walks of one header chain."""
    data, nblk = _legacy_payload(seed, table)
    serial = PN.legacy_scan(data, nblk)
    assert _same(serial, JN.legacy_scan(data, nblk))
    starts = JR.legacy_chunk_offsets(data)
    par = PN.legacy_scan_parallel(data, nblk, starts)
    assert _same(par, JN.legacy_scan_parallel(data, nblk, starts))
    assert (par is not None) == table and (par is None or _same(par, serial))
    st_p, st_j = {}, {}
    spec = PN.legacy_scan_speculative(data, nblk, nseg=4, window=64, stats=st_p)
    assert _same(spec, JN.legacy_scan_speculative(data, nblk, nseg=4, window=64, stats=st_j))
    assert st_p == st_j
    assert spec is not None and _same(spec, serial)


def test_legacy_scan_truncated_raises_the_same_text():
    data, nblk = _legacy_payload(0, False)
    cut = data[: len(data) // 2]
    with pytest.raises(PX.DecodeError) as got:
        PN.legacy_scan(cut, nblk)
    with pytest.raises(JX.DecodeError) as want:
        JN.legacy_scan(cut, nblk)
    assert str(got.value) == str(want.value)


# -- encoder, container writer, colour, metadata ------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_encode_modern_bytes_equal(seed):
    rng = np.random.default_rng(30 + seed)
    h, w = int(rng.integers(1, 30)), int(rng.integers(1, 300))
    img = rng.integers(0, 1 << (6 * seed + 4), size=(h, w), dtype=np.uint16)
    assert PE.encode_modern(img) == JE.encode_modern(img)
    enc_w = 64 * (-(-w // 64) + 1)
    assert PE.encode_modern(img, enc_w, h + 3) == JE.encode_modern(img, enc_w, h + 3)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("table", [True, False])
def test_encode_legacy_bytes_equal(seed, table):
    rng = np.random.default_rng(40 + seed)
    h, w = int(rng.integers(1, 30)), int(rng.integers(1, 300))
    img = rng.integers(0, 1 << (6 * seed + 4), size=(h, w), dtype=np.uint16)
    assert (PE.encode_legacy(img, add_offset_table=table)
            == JE.encode_legacy(img, add_offset_table=table))


def test_container_writer_bytes_equal():
    rng = np.random.default_rng(50)
    imgs = [rng.integers(0, 4096, size=(8, 64), dtype=np.uint16) for _ in range(3)]
    blobs = []
    for E, M in ((PE, PM), (JE, JM)):
        writer = E.ContainerWriter(M.example_container_metadata(sensor="grbg"))
        for i, img in enumerate(imgs):
            writer.add_frame(7 + i, E.encode_modern(img), M.example_frame_metadata(64, 8))
            writer.add_audio(np.arange(32, dtype=np.int16) * (i + 1), i * 1000)
        writer.add_audio(np.arange(8, dtype=np.int16))  # no timestamp
        blobs.append(writer.finish())
    assert blobs[0] == blobs[1]


def test_metadata_fixtures_equal():
    assert PM.CFA_PATTERNS == JM.CFA_PATTERNS
    kw = dict(sensor="gbrg", black_level=(1, 2, 3, 4), white_level=999.0)
    assert PM.example_container_metadata(**kw) == JM.example_container_metadata(**kw)
    assert PM.example_frame_metadata(10, 20, 6) == JM.example_frame_metadata(10, 20, 6)


WARM = [0.52, 1.0, 0.71]
NEUTRALS = [[0.5, 1.0, 0.6], WARM, [0.9, 1.0, 0.4], [1.0, 1.0, 1.0]]


@pytest.mark.parametrize("neutral", NEUTRALS)
def test_interpolated_matrices_equal(neutral):
    cm = JM.example_container_metadata()
    cm.update(colorMatrix1=[0.79, -0.23, -0.07, -0.43, 1.32, 0.05, -0.07, 0.18, 0.54],
              colorMatrix2=[0.92, -0.31, -0.01, -0.50, 1.42, 0.08, -0.04, 0.22, 0.42],
              forwardMatrix1=[0.62, 0.22, 0.12, 0.26, 0.72, 0.02, 0.03, 0.12, 0.67],
              forwardMatrix2=[0.68, 0.18, 0.10, 0.30, 0.68, 0.02, 0.05, 0.10, 0.67])
    got = PC.interpolated_matrices(PM.ContainerMetadata(cm), neutral)
    want = JC.interpolated_matrices(JM.ContainerMetadata(cm), neutral)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    one = {k: v for k, v in cm.items() if k != "forwardMatrix2"}
    for a, b in zip(PC.interpolated_matrices(one, neutral), JC.interpolated_matrices(one, neutral)):
        np.testing.assert_array_equal(a, b)


def test_outpath_equal():
    for d, n in (("", "a.dng"), ("out", "frame_000001.dng"), ("x/y/", "audio.wav")):
        assert PU.outpath(d, n) == JU.outpath(d, n)


# -- errors -------------------------------------------------------------------

ERRORS = ["MotionCamException", "IOException", "DecodeError", "MetadataError"]


@pytest.mark.parametrize("name", ERRORS)
def test_error_class_copied(name):
    got, want = getattr(PX, name), getattr(JX, name)
    assert got is not want and got.__name__ == want.__name__
    assert [c.__name__ for c in got.__mro__] == [c.__name__ for c in want.__mro__]


def test_port_exports_its_own_error_classes():
    import mcraw_torch

    for name in ERRORS:
        assert getattr(mcraw_torch, name) is getattr(PX, name)


@pytest.mark.parametrize("modern", [True, False])
def test_uncompress_error_text_equal(modern):
    texts = []
    for mod, X in ((PP, PX), (JP, JX)):
        with pytest.raises(X.IOException) as e:
            with mod._uncompress_error_text(modern):
                raise X.DecodeError("main data truncated")
        assert type(e.value.__cause__) is X.DecodeError
        texts.append((type(e.value).__name__, str(e.value)))
    assert texts[0] == texts[1]


def test_modern_payload_rows_equal():
    rng = np.random.default_rng(60)
    for n in (0, 4, 7, 8, 16, 40):
        payload = rng.integers(0, 256, size=n, dtype=np.uint8)
        assert PP._modern_payload_rows(payload) == JP._modern_payload_rows(payload)
