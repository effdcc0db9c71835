"""The CLI legs of the soak (mcraw_torch.soak_cli) on the CPU, and the port's
counterparts of the JAX package's malformed and adversarial named pins.

- The container author and the JSON mutators give the same bytes as their
  originals in ``tools/`` for the same seeds.
- Each pin is a clip run through both command lines in this process:
  ``mcraw_torch.cli.main([..., "--device", "cpu"])`` against
  ``mcraw.cli.main([..., "--backend", "numpy"])``, for the reference-style
  ``<clip>``, ``decode <clip> --pipeline`` and ``verify <clip>``, compared
  as the soak compares them (``soak_cli.differences``): exit code, stdout,
  stderr and every written file byte for byte (``--pipeline``'s Writing
  lines as a multiset). The pins: the malformed payloads of
  tests/test_malformed_parity.py (and the malformed leg's declared count and
  bits above 16), one case per mutation family of tools/soak_json.py on
  each JSON text, and the container shapes of
  tests/test_container_adversarial.py.
- The CLI legs themselves at fixed seeds report no difference.
"""

import json
import random
import traceback

import numpy as np
import pytest
import torch

from mcraw import cli as ref_cli
from mcraw import encode as JE
from mcraw_torch import cli
from mcraw_torch import container as C
from mcraw_torch import encode as E
from mcraw_torch import soak as S
from mcraw_torch import soak_cli as SC
from mcraw_torch.metadata import example_container_metadata, example_frame_metadata
from tools import soak_container as TC
from tools import soak_json as TJ


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The frames are small: more intra-op threads only contend with the
    other test workers' (the soak's children run with one too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# -- the generators against their originals ------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_author_random_clip_equals_tools(seed, tmp_path):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    n = SC.author_random_clip(a, tmp_path / "a.mcraw")
    assert n == TC.author_random_clip(b, str(tmp_path / "b.mcraw"))
    assert (tmp_path / "a.mcraw").read_bytes() == (tmp_path / "b.mcraw").read_bytes()
    assert a.integers(0, 1 << 30) == b.integers(0, 1 << 30)


@pytest.mark.parametrize("seed", range(12))
def test_mutate_json_equals_tools(seed):
    """tools/soak_json.py draws from numpy and the `random` module; the
    port's copy takes its `random.Random` as an argument."""
    blob = json.dumps(example_container_metadata()).encode()
    a = np.random.default_rng(seed)
    mine = SC.mutate_json(a, random.Random(seed), blob)
    b = np.random.default_rng(seed)
    random.seed(seed)
    assert mine == TJ.mutate_json(b, blob)
    assert a.integers(0, 1 << 30) == b.integers(0, 1 << 30)


@pytest.mark.parametrize("seed", [0, 1])
def test_json_clip_equals_tools_loop(seed):
    """Four iterations of tools/soak_json.py's loop (:335-346): the same
    clip bytes."""
    from mcraw.metadata import example_container_metadata as jcm
    from mcraw.metadata import example_frame_metadata as jfm

    img = np.random.default_rng(3).integers(0, 4096, size=(16, 192), dtype=np.uint16)
    theirs_payloads = {7: bytes(JE.encode_modern(img)), 6: bytes(JE.encode_legacy(img))}
    assert SC.json_payloads() == theirs_payloads
    a, prng = np.random.default_rng(seed), random.Random(seed)
    b = np.random.default_rng(seed)
    random.seed(seed)
    for _ in range(4):
        mine, what = SC.json_clip(a, prng, SC.json_payloads())
        codec = 7 if b.integers(0, 2) == 0 else 6
        cm = json.dumps(jcm()).encode()
        fm = json.dumps(jfm(192, 16, codec)).encode()
        target = "container" if b.integers(0, 2) == 0 else "frame"
        if target == "container":
            cm, names = TJ.mutate_json(b, cm)
        else:
            fm, names = TJ.mutate_json(b, fm)
        w = JE.ContainerWriter(cm)
        w.add_frame(1000, theirs_payloads[codec], fm)
        w.add_audio(np.zeros(256, np.int16), 0)
        assert mine == w.finish()
        assert what == {"codec": codec, "target": target, "mutations": names}


# -- both command lines in this process -------------------------------------------------


def _in_process(main, argv, cwd, monkeypatch, capsys) -> SC.Run:
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    try:
        rc = main(argv)
    except SystemExit as e:  # argparse
        rc = e.code if isinstance(e.code, int) else 1
    except Exception:  # noqa: BLE001 - a traceback is the outcome, as python -m gives
        traceback.print_exc()
        rc = 1
    out = capsys.readouterr()
    return SC.Run(rc, out.out, out.err, cwd)


def _parity(tmp_path, blob: bytes, monkeypatch, capsys) -> dict:
    """The clip through both CLIs, each command in an empty directory; the
    reference's runs by command."""
    clip = tmp_path / "clip.mcraw"
    clip.write_bytes(blob)
    refs = {}
    for cmd in SC.COMMANDS:
        argv = SC.command_argv(cmd, clip)
        ref = _in_process(ref_cli.main, [*argv, "--backend", "numpy"], tmp_path / f"{cmd}_ref",
                          monkeypatch, capsys)
        mine = _in_process(cli.main, [*argv, "--device", "cpu"], tmp_path / f"{cmd}_mine",
                           monkeypatch, capsys)
        assert SC.differences(cmd, ref, mine) == [], cmd
        refs[cmd] = ref
    return refs


def _clip(frames) -> bytes:
    """A container of (payload, frame JSON) pairs and one audio chunk, as
    tests/test_malformed_parity.py:45-51 writes it."""
    writer = E.ContainerWriter(example_container_metadata())
    for i, (payload, fm) in enumerate(frames):
        writer.add_frame(1000 + i, payload, fm)
    writer.add_audio(np.zeros(256, np.int16), 0)
    return writer.finish()


# -- the malformed payloads ------------------------------------------------------------


def _header(payload: bytes, **fields) -> bytes:
    return S.with_header(payload, **fields)


def _modern(rng, h=16, w=192, hi=4096, **kw) -> tuple[np.ndarray, bytes]:
    img = rng.integers(0, hi, size=(h, w), dtype=np.uint16)
    return img, E.encode_modern(img, **kw)


def _bits_over_16(rng, hi) -> bytes:
    _, p = _modern(rng, hi=hi)
    return S.with_bits_over_16(rng, p)[0]


MALFORMED = {
    # tests/test_malformed_parity.py:89-104, one frame each
    "bits_off": lambda rng: [(_header(p, bits_off=len(p) + 1), example_frame_metadata(192, 16, 7))
                             for p in [_modern(rng)[1]]],
    "refs_off": lambda rng: [(_header(p, refs_off=len(p) + 1), example_frame_metadata(192, 16, 7))
                             for p in [_modern(rng)[1]]],
    "enc_w_mod": lambda rng: [(_header(p, ew=192 + 3), example_frame_metadata(192, 16, 7))
                              for p in [_modern(rng)[1]]],
    "enc_w_small": lambda rng: [(_header(p, ew=64), example_frame_metadata(192, 16, 7))
                                for p in [_modern(rng)[1]]],
    # :119-128 good frame 0, corrupt frame 1
    "second_frame_malformed": lambda rng: [
        (_modern(rng)[1], example_frame_metadata(192, 16, 7)),
        (_header(_modern(rng)[1], bits_off=1 << 20), example_frame_metadata(192, 16, 7))],
    # :131-151 zero area
    "zero_width_modern": lambda rng: [(_modern(rng)[1], example_frame_metadata(0, 16, 7))],
    "zero_height_legacy": lambda rng: [
        (E.encode_legacy(rng.integers(0, 4096, (8, 96), np.uint16)),
         example_frame_metadata(96, 0, 6))],
    # :154-170 encodedHeight 8 of 16
    "under_declared_height": lambda rng: [(_header(_modern(rng)[1], eh=8),
                                           example_frame_metadata(192, 16, 7))],
    # :173-194 truncations
    "truncated_modern": lambda rng: [(p[: len(p) - 7], example_frame_metadata(192, 16, 7))
                                     for p in [_modern(rng, hi=1 << 16)[1]]],
    "truncated_legacy": lambda rng: [
        (p[: len(p) // 2], example_frame_metadata(192, 16, 6))
        for p in [E.encode_legacy(rng.integers(0, 1 << 16, (16, 192), np.uint16))]],
    # :197-209 a declared count that is not a multiple of 64 (48 blocks)
    "declared_count_48": lambda rng: [(_modern(rng, declared_count=48)[1],
                                       example_frame_metadata(192, 16, 7))],
    # the malformed leg's bits above 16: on 16-bit blocks (exact) and on
    # blocks of 10 bits or fewer (garbage, the plain path's garbage)
    "bits_over_16_exact": lambda rng: [(_bits_over_16(rng, 1 << 16),
                                        example_frame_metadata(192, 16, 7))],
    "bits_over_16_garbage": lambda rng: [(_bits_over_16(rng, 1 << 10),
                                          example_frame_metadata(192, 16, 7))],
}
FAILS = {"bits_off", "refs_off", "enc_w_mod", "enc_w_small", "second_frame_malformed",
         "zero_width_modern", "zero_height_legacy", "truncated_modern", "truncated_legacy"}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_pin_cli_parity(case, tmp_path, monkeypatch, capsys):
    refs = _parity(tmp_path, _clip(MALFORMED[case](np.random.default_rng(31))),
                   monkeypatch, capsys)
    decode = refs["decode"]
    assert (decode.rc != 0) == (case in FAILS), (decode.rc, decode.err)
    if case in FAILS:
        assert decode.err.startswith("Error: Failed to uncompress")


# -- one case per JSON mutation family ------------------------------------------------

FAMILIES = ("truncate", "flip", "insert", "trailing", "dup_key",
            "drop_key", "retype", "numeric_edge", "array_edit")


def _json_case(family: str, target: str, seed: int) -> bytes:
    """A one-frame clip whose container or frame JSON got one mutation of
    `family` (the soak's mutators, tools/soak_json.py:55-157)."""
    rng, prng = np.random.default_rng(seed), random.Random(seed)
    codec = 7 if seed % 2 else 6
    texts = {"container": json.dumps(example_container_metadata()).encode(),
             "frame": json.dumps(example_frame_metadata(192, 16, codec)).encode()}
    text = dict(SC._text_mutations(rng, prng))
    tree = dict(SC._tree_mutations(rng, prng))
    blob = texts[target]
    if family in text:
        texts[target] = text[family](blob)
    else:
        texts[target] = json.dumps(tree[family](json.loads(blob))).encode()
    assert texts[target] != blob or family in ("array_edit",)
    w = E.ContainerWriter(texts["container"])
    w.add_frame(1000, SC.json_payloads()[codec], texts["frame"])
    w.add_audio(np.zeros(256, np.int16), 0)
    return w.finish()


@pytest.mark.parametrize("target", ["container", "frame"])
@pytest.mark.parametrize("family", FAMILIES)
def test_json_mutation_family_cli_parity(family, target, tmp_path, monkeypatch, capsys):
    _parity(tmp_path, _json_case(family, target, 40 + FAMILIES.index(family)),
            monkeypatch, capsys)


# -- the container shapes of tests/test_container_adversarial.py -----------------------


class DialectWriter:
    """Items and both index tables written by hand, for the dialects
    ContainerWriter never writes (tests/test_container_adversarial.py:46)."""

    def __init__(self, container_metadata=None):
        self.out = bytearray(C.HEADER_FMT.pack(C.CONTAINER_ID, C.CONTAINER_VERSION))
        meta = container_metadata or example_container_metadata()
        self.item(C.ItemType.METADATA, json.dumps(meta).encode())
        self.frame_entries: list[tuple[int, int]] = []
        self.audio_entries: list[tuple[int, int]] = []

    def item(self, t, payload: bytes) -> int:
        off = len(self.out)
        self.out += C.ITEM_FMT.pack(int(t), len(payload)) + payload
        return off

    def add_frame(self, ts: int, img: np.ndarray) -> None:
        h, w = img.shape
        off = self.item(C.ItemType.BUFFER, E.encode_modern(img))
        fm = example_frame_metadata(w, h)
        fm["asShotNeutral"] = [0.5, 1.0, 0.66]
        self.item(C.ItemType.METADATA, json.dumps(fm).encode())
        self.frame_entries.append((off, ts))

    def add_audio(self, raw: bytes, ts_ns=None) -> None:
        off = self.item(C.ItemType.AUDIO_DATA, raw)
        if ts_ns is not None:
            self.item(C.ItemType.AUDIO_DATA_METADATA, C.AUDIO_METADATA_FMT.pack(ts_ns))
        self.audio_entries.append((off, ts_ns or 0))

    def finish(self) -> bytes:
        self.item(C.ItemType.AUDIO_INDEX, C.AUDIO_INDEX_FMT.pack(len(self.audio_entries), 0)
                  + b"".join(C.BUFFER_OFFSET_FMT.pack(o, t) for o, t in self.audio_entries))
        index = b"".join(C.BUFFER_OFFSET_FMT.pack(o, t) for o, t in self.frame_entries)
        index_data_offset = len(self.out) + C.ITEM_FMT.size
        self.item(C.ItemType.BUFFER_INDEX_DATA, index)
        self.out += C.ITEM_FMT.pack(int(C.ItemType.BUFFER_INDEX), C.BUFFER_INDEX_FMT.size)
        self.out += C.BUFFER_INDEX_FMT.pack(C.INDEX_MAGIC_I32, len(self.frame_entries),
                                            index_data_offset)
        return bytes(self.out)


def _img(rng, h=32, w=128):
    return rng.integers(0, 1024, size=(h, w), dtype=np.uint16)


def _duplicate_timestamps(rng):
    w, img = DialectWriter(), _img(rng)
    w.add_frame(1000, img)
    w.add_frame(1000, img)
    w.add_audio(np.zeros(64, "<i2").tobytes(), ts_ns=5)
    return w.finish()


def _out_of_order_index(rng):
    w = DialectWriter()
    for i in range(3):
        w.add_frame(3000 - 1000 * i, _img(rng))
    w.add_audio(np.zeros(64, "<i2").tobytes(), ts_ns=1)
    return w.finish()


def _unknown_tag(rng):
    w = DialectWriter()
    w.add_frame(1000, _img(rng))
    w.add_audio(np.full(128, 7, "<i2").tobytes(), ts_ns=3)
    w.item(99, b"futuristic extension payload")
    return w.finish()


def _odd_audio_mono(rng):
    w = DialectWriter(example_container_metadata(channels=1))
    w.add_frame(1000, _img(rng))
    w.add_audio(bytes([1, 2, 3, 4, 5]), ts_ns=11)
    w.add_audio(bytes([9]), ts_ns=12)
    return w.finish()


def _odd_samples_stereo(rng):
    w = DialectWriter()
    w.add_frame(1000, _img(rng))
    w.add_audio(bytes([1, 2, 3, 4, 5]), ts_ns=11)
    return w.finish()


def _audio_metadata_straddles_eof(rng):
    w = DialectWriter()
    w.add_frame(1000, _img(rng))
    w.audio_entries.append((0, 0))
    blob = bytearray(w.finish())
    idx = blob.find(C.ITEM_FMT.pack(int(C.ItemType.AUDIO_INDEX), C.AUDIO_INDEX_FMT.size + 16))
    entry_at = idx + C.ITEM_FMT.size + C.AUDIO_INDEX_FMT.size
    blob[entry_at : entry_at + 16] = C.BUFFER_OFFSET_FMT.pack(len(blob) - 4, 0)
    return bytes(blob)


def _negative_audio_offset(rng):
    w = DialectWriter()
    w.add_frame(1000, _img(rng))
    w.add_audio(np.full(256, 5, "<i2").tobytes(), ts_ns=1)
    w.audio_entries.insert(0, (-128, 0))
    return w.finish()


def _zero_frame_audio_only(rng):
    w = DialectWriter()
    w.add_audio(np.full(512, 3, "<i2").tobytes(), ts_ns=1)
    return w.finish()


def _zero_size_audio_chunk(rng):
    w = DialectWriter()
    w.add_frame(1000, _img(rng))
    w.add_audio(np.full(64, 3, "<i2").tobytes(), ts_ns=1)
    w.add_audio(b"", ts_ns=2)
    return w.finish()


def _zero_size_frame_metadata(rng):
    w = DialectWriter()
    w.add_frame(1000, _img(rng))
    off = w.item(C.ItemType.BUFFER, E.encode_modern(_img(rng)))
    w.item(C.ItemType.METADATA, b"")
    w.frame_entries.append((off, 2000))
    w.add_audio(np.full(32, 5, "<i2").tobytes(), ts_ns=1)
    return w.finish()


def _zero_size_buffer_payload(rng):
    w = DialectWriter()
    off = w.item(C.ItemType.BUFFER, b"")
    w.item(C.ItemType.METADATA, json.dumps(example_frame_metadata(128, 32)).encode())
    w.frame_entries.append((off, 1000))
    return w.finish()


def _zero_size_container_metadata(rng):
    blob = bytearray(C.HEADER_FMT.pack(C.CONTAINER_ID, C.CONTAINER_VERSION))
    blob += C.ITEM_FMT.pack(int(C.ItemType.METADATA), 0)
    index_data_offset = len(blob) + C.ITEM_FMT.size
    blob += C.ITEM_FMT.pack(int(C.ItemType.BUFFER_INDEX_DATA), 0)
    blob += C.ITEM_FMT.pack(int(C.ItemType.BUFFER_INDEX), C.BUFFER_INDEX_FMT.size)
    blob += C.BUFFER_INDEX_FMT.pack(C.INDEX_MAGIC_I32, 0, index_data_offset)
    return bytes(blob)


SHAPES = {f.__name__[1:]: f for f in (
    _duplicate_timestamps, _out_of_order_index, _unknown_tag, _odd_audio_mono,
    _odd_samples_stereo, _audio_metadata_straddles_eof, _negative_audio_offset,
    _zero_frame_audio_only, _zero_size_audio_chunk, _zero_size_frame_metadata,
    _zero_size_buffer_payload, _zero_size_container_metadata)}
SHAPES_FAIL = {"audio_metadata_straddles_eof", "zero_size_audio_chunk",
               "zero_size_frame_metadata", "zero_size_buffer_payload",
               "zero_size_container_metadata"}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_container_shape_cli_parity(shape, tmp_path, monkeypatch, capsys):
    refs = _parity(tmp_path, SHAPES[shape](np.random.default_rng(32)), monkeypatch, capsys)
    assert (refs["decode"].rc != 0) == (shape in SHAPES_FAIL), refs["decode"].err


# -- the CLI legs -------------------------------------------------------------------------


@pytest.mark.parametrize("leg, seed", [("container", 2), ("json", 3)])
def test_cli_leg_reports_no_difference(leg, seed, tmp_path):
    """Three iterations of the leg (the reference as a subprocess)."""
    runner = SC.CliLeg(leg, seed, "cpu", tmp_path / "failures")
    for _ in range(3):
        runner.step()
    row = runner.summary(0.0)
    assert row["failures"] == 0 and row["iterations"] == 3
    assert row["commands"] == {cmd: 3 for cmd in SC.COMMANDS}
    assert not (tmp_path / "failures").exists()


def test_differences_sees_a_changed_file(tmp_path):
    """The comparison itself: a byte changed in a written file, stdout,
    stderr or the exit code is a difference; --pipeline's Writing lines in
    another order (or run together, as the reference's writer threads can
    print them) are not."""
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    (a / "frame_000000.dng").write_bytes(b"\x01\x02")
    (b / "frame_000000.dng").write_bytes(b"\x01\x03")
    ref_out = ("Found 2 frames\nWriting frame_000001.dngWriting frame_000000.dng\n\n"
               "Exported 2 frames in 0.01s (200.0 fps)\n")
    mine_out = ("Found 2 frames\nWriting frame_000000.dng\nWriting frame_000001.dng\n"
                "Exported 2 frames in 0.02s (100.0 fps)\n")
    ref, mine = SC.Run(0, ref_out, "", a), SC.Run(0, mine_out, "", b)
    assert SC.differences("pipeline", ref, mine) == ["frame_000000.dng differs"]
    (b / "frame_000000.dng").write_bytes(b"\x01\x02")
    assert SC.differences("pipeline", ref, SC.Run(0, mine_out, "", b)) == []
    assert SC.differences("decode", ref, SC.Run(0, mine_out, "", b))  # stdout differs
    assert SC.differences("verify", SC.Run(255, "x", "", a), SC.Run(0, "x", "", b))
    assert SC.differences("verify", SC.Run(0, "x", "e", a), SC.Run(0, "x", "f", b))
