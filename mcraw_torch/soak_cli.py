"""The CLI legs of :mod:`mcraw_torch.soak`: random containers and mutated
JSON metadata through both command lines, byte for byte.

- ``container``: a random .mcraw per iteration (frame count, geometry,
  codec, audio chunk sizes, channels and timestamps), the author of the
  JAX package's container soak (``tools/soak_container.py``).
- ``json``: one frame of each codec's fixed payload in a container whose
  container or frame JSON text is mutated once or twice, at the byte level
  (truncation, a flip, garbage, trailing garbage, a duplicate key) or in the
  parsed tree (a dropped key, a retyped value, numeric edges, short, long or
  wrongly typed arrays): the mutators of ``tools/soak_json.py``.

The reference is ``python -m mcraw ... --backend numpy``, in a process of
its own; the port's CLI runs in this process (``mcraw_torch.cli.main``), on
the leg's device, so one CUDA context sees every clip. For each clip both
run ``<clip>`` (the reference's argv), ``decode <clip> --pipeline`` and
``verify <clip>``, each in an empty directory: the same exit code, stdout
and stderr, and the same files byte for byte. ``--pipeline`` prints its
``Writing`` lines in the order its writer threads finish, so those are
compared as a multiset, its summary line without its time, and its
per-frame errors as a multiset of lines. A traceback on both sides is the
same outcome when its last line (the exception) is the same.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import traceback
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from . import cli
from . import encode as E
from .metadata import example_container_metadata, example_frame_metadata
from .pipeline import resolve_device

ROOT = Path(__file__).resolve().parents[1]
COMMANDS = {"decode": [], "pipeline": ["decode", "--pipeline"], "verify": ["verify"]}
EXPORTED = re.compile(r"^(Exported \d+ frames in )\S+ \(\S+ fps\)$", re.M)
WRITING = re.compile(r"Writing (\S+?\.dng)")

# -- the generators: copies of tools/soak_container.py and tools/soak_json.py -------


def author_random_clip(rng, path):
    """A random .mcraw container at `path` (tools/soak_container.py:30-70);
    its frame count."""
    codec = int(rng.integers(6, 8))
    nframes = int(rng.integers(0, 5))
    h = int(rng.integers(1, 13)) * 4
    w = int(rng.integers(8, 200))
    channels = int(rng.integers(1, 3))
    rate = int(rng.choice([8000, 44100, 48000]))
    cm = example_container_metadata(sample_rate=rate, channels=channels)
    wr = E.ContainerWriter(cm)
    ts = 1000
    for _ in range(nframes):
        img = rng.integers(
            0, 1 << int(rng.integers(1, 17)), size=(h, w), dtype=np.uint16
        )
        payload = (
            E.encode_modern(img) if codec == 7 else E.encode_legacy(img)
        )
        fm = example_frame_metadata(w, h, compression_type=codec)
        wr.add_frame(ts, payload, fm)
        ts += int(rng.integers(1, 50_000_000))
        # Interleave audio randomly; missing timestamps are legal. Sample
        # counts stay a multiple of the channel count (an odd stereo count
        # is undefined in the reference example).
        for _ in range(int(rng.integers(0, 3))):
            n = int(rng.integers(0, 2000)) // channels * channels
            samples = rng.integers(-32768, 32768, size=n).astype(np.int16)
            with_ts = bool(rng.integers(0, 2))
            wr.add_audio(
                samples, timestamp_ns=ts if with_ts else None
            )
    Path(path).write_bytes(wr.finish())
    return nframes


def _text_mutations(rng, prng):
    """Byte-level mutators: (name, fn(bytes) -> bytes)
    (tools/soak_json.py:55-101; `prng` stands for its ``random``)."""

    def truncate(b):
        return b[: rng.integers(0, len(b) + 1)]

    def flip(b):
        if not b:
            return b
        i = int(rng.integers(0, len(b)))
        return b[:i] + bytes([int(rng.integers(32, 127))]) + b[i + 1:]

    def insert(b):
        i = int(rng.integers(0, len(b) + 1))
        tok = prng.choice(
            [b"}", b"{", b"[", b",", b'"', b"\\", b"\x00", b"\xff",
             b"NaN", b"Infinity", b"1e999", b"//c", b"  "]
        )
        return b[:i] + tok + b[i:]

    def trailing(b):
        return b + prng.choice([b"x", b" {}", b"null", b"\x01"])

    def dup_key(b):
        # naive text-level duplicate: replay the first "key": chunk at
        # the end of the object (last one wins in both parsers)
        try:
            obj = json.loads(b)
        except Exception:
            return b
        if not isinstance(obj, dict) or not obj:
            return b
        k = prng.choice(list(obj))
        s = b.decode()
        if not s.rstrip().endswith("}"):
            return b
        val = prng.choice(["1", '"x"', "null", "[1]", "3.5"])
        j = s.rstrip()[:-1] + ', "%s": %s}' % (k, val)
        return j.encode()

    return [
        ("truncate", truncate),
        ("flip", flip),
        ("insert", insert),
        ("trailing", trailing),
        ("dup_key", dup_key),
    ]


def _tree_mutations(rng, prng):
    """Structured mutators over the parsed dict (tools/soak_json.py
    :104-157)."""

    def drop_key(d):
        if d:
            d.pop(prng.choice(list(d)))
        return d

    def retype(d):
        if not d:
            return d
        k = prng.choice(list(d))
        d[k] = prng.choice(
            ["str", None, True, False, [1, 2], {"x": 1}, ""]
        )
        return d

    def numeric_edge(d):
        if not d:
            return d
        k = prng.choice(list(d))
        d[k] = prng.choice(
            [
                (1 << 32) + 5, (1 << 63) - 1, 1 << 63, (1 << 64) - 1,
                1 << 64, (1 << 64) + 192, -(1 << 63), -(1 << 63) - 1,
                10**300, -7, 0, 192.7, 1e308,
            ]
        )
        return d

    def array_edit(d):
        keys = [k for k, v in d.items() if isinstance(v, list)]
        if not keys:
            return d
        k = prng.choice(keys)
        v = list(d[k])
        mode = rng.integers(0, 4)
        if mode == 0 and v:
            v = v[: int(rng.integers(0, len(v)))]  # short
        elif mode == 1:
            v = v + v[:3]  # long (extras ignored by the reference)
        elif mode == 2 and v:
            v[int(rng.integers(0, len(v)))] = "oops"  # element retype
        else:
            v = []
        d[k] = v
        return d

    return [
        ("drop_key", drop_key),
        ("retype", retype),
        ("numeric_edge", numeric_edge),
        ("array_edit", array_edit),
    ]


def mutate_json(rng, prng, blob: bytes) -> tuple[bytes, list[str]]:
    """1-2 mutations of a JSON text (tools/soak_json.py:160-180)."""
    names = []
    n = int(rng.integers(1, 3))
    for _ in range(n):
        if rng.integers(0, 2) == 0:
            name, fn = prng.choice(_text_mutations(rng, prng))
            blob = fn(blob)
        else:
            try:
                obj = json.loads(blob)
            except Exception:
                name, fn = prng.choice(_text_mutations(rng, prng))
                blob = fn(blob)
                names.append(name)
                continue
            if not isinstance(obj, dict):
                continue
            name, fn = prng.choice(_tree_mutations(rng, prng))
            blob = json.dumps(fn(obj)).encode()
        names.append(name)
    return blob, names


def json_payloads() -> dict:
    """The json leg's fixed frame of each codec (tools/soak_json.py
    :324-328)."""
    img = np.random.default_rng(3).integers(0, 4096, size=(16, 192), dtype=np.uint16)
    return {7: bytes(E.encode_modern(img)), 6: bytes(E.encode_legacy(img))}


def json_clip(rng, prng, payloads: dict) -> tuple[bytes, dict]:
    """One iteration of tools/soak_json.py:335-346: a clip whose container
    or frame JSON is mutated; (clip bytes, what was done)."""
    codec = 7 if rng.integers(0, 2) == 0 else 6
    cm = json.dumps(example_container_metadata()).encode()
    fm = json.dumps(example_frame_metadata(192, 16, codec)).encode()
    target = "container" if rng.integers(0, 2) == 0 else "frame"
    if target == "container":
        cm, names = mutate_json(rng, prng, cm)
    else:
        fm, names = mutate_json(rng, prng, fm)
    w = E.ContainerWriter(cm)
    w.add_frame(1000, payloads[codec], fm)
    w.add_audio(np.zeros(256, np.int16), 0)
    return w.finish(), {"codec": codec, "target": target, "mutations": names}


# -- running both command lines -----------------------------------------------------


class Run:
    """One command's exit code (0..255), stdout, stderr and written
    files."""

    def __init__(self, rc: int, out: str, err: str, cwd: Path):
        self.rc, self.out, self.err = rc & 0xFF, out, err
        self.files = {p.name: p.read_bytes() for p in sorted(cwd.iterdir())}


def run_reference(argv: list[str], cwd: Path) -> Run:
    """``python -m mcraw <argv> --backend numpy`` in `cwd`."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-m", "mcraw", *argv, "--backend", "numpy"],
                         cwd=cwd, env=env, capture_output=True, timeout=300)
    return Run(res.returncode, res.stdout.decode("utf-8", "replace"),
               res.stderr.decode("utf-8", "replace"), cwd)


def run_port(argv: list[str], cwd: Path, device: str) -> Run:
    """``mcraw_torch.cli.main(argv + ["--device", device])`` in this
    process, in `cwd`, its output captured; an exception it lets out is a
    traceback and exit code 1, as ``python -m`` gives."""
    out, err = io.StringIO(), io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = cli.main([*argv, "--device", device])
            except Exception:  # noqa: BLE001 - the CLI's own traceback is its outcome
                traceback.print_exc()
                rc = 1
    finally:
        os.chdir(here)
    text = lambda s: s.encode("utf-8", "replace").decode("utf-8")  # noqa: E731
    return Run(rc, text(out.getvalue()), text(err.getvalue()), cwd)


def _pipeline_rest(out: str) -> list[str]:
    """``--pipeline``'s stdout less its Writing lines (its writer threads
    print them in any order, and the reference's can run together) and the
    Exported line's time."""
    return [ln for ln in EXPORTED.sub(r"\1", WRITING.sub("", out)).splitlines() if ln]


def _last_line(s: str) -> str:
    lines = s.strip().splitlines()
    return lines[-1] if lines else ""


def differences(cmd: str, ref: Run, mine: Run) -> list[str]:
    """How the port's run of `cmd` differs from the reference's."""
    if "Traceback" in ref.err or "Traceback" in mine.err:
        same = (ref.rc == mine.rc and "Traceback" in ref.err and "Traceback" in mine.err
                and _last_line(ref.err) == _last_line(mine.err))
        return [] if same else [f"traceback: {_last_line(ref.err)!r} / {_last_line(mine.err)!r}"]
    notes = []
    if ref.rc != mine.rc:
        notes.append(f"exit {ref.rc} / {mine.rc}")
    if cmd == "pipeline":
        if (Counter(WRITING.findall(ref.out)) != Counter(WRITING.findall(mine.out))
                or _pipeline_rest(ref.out) != _pipeline_rest(mine.out)):
            notes.append(f"stdout {ref.out[-300:]!r} / {mine.out[-300:]!r}")
        if Counter(ref.err.splitlines()) != Counter(mine.err.splitlines()):
            notes.append(f"stderr {ref.err[-300:]!r} / {mine.err[-300:]!r}")
    else:
        if ref.out != mine.out:
            notes.append(f"stdout {ref.out[-300:]!r} / {mine.out[-300:]!r}")
        if ref.err != mine.err:
            notes.append(f"stderr {ref.err[-300:]!r} / {mine.err[-300:]!r}")
    if sorted(ref.files) != sorted(mine.files):
        notes.append(f"files {sorted(ref.files)} / {sorted(mine.files)}")
    else:
        notes += [f"{n} differs" for n in ref.files if ref.files[n] != mine.files[n]]
    return notes


def command_argv(cmd: str, clip: Path) -> list[str]:
    """The argv of `cmd` (a key of COMMANDS) on `clip`, without the device
    or backend option."""
    extra = COMMANDS[cmd]
    return [*extra[:1], str(clip), *extra[1:]]


def compare_clip(clip: Path, work: Path, device: str) -> dict:
    """Every command of COMMANDS on `clip` through both CLIs (the
    reference's three processes at once): {command: [differences]}."""
    dirs = {}
    for cmd in COMMANDS:
        for side in ("ref", "mine"):
            dirs[cmd, side] = work / f"{cmd}_{side}"
            dirs[cmd, side].mkdir()
    with ThreadPoolExecutor(len(COMMANDS)) as pool:
        refs = {cmd: pool.submit(run_reference, command_argv(cmd, clip), dirs[cmd, "ref"])
                for cmd in COMMANDS}
        mine = {cmd: run_port(command_argv(cmd, clip), dirs[cmd, "mine"], device)
                for cmd in COMMANDS}
        return {cmd: differences(cmd, refs[cmd].result(), mine[cmd]) for cmd in COMMANDS}


class CliLeg:
    """The container or json leg on one device (mcraw_torch.soak's
    run_leg drives it)."""

    def __init__(self, leg: str, seed: int, device, failures: Path, inject: str | None = None):
        if not (ROOT / "mcraw").is_dir():
            raise RuntimeError(f"the CLI legs need the JAX package's CLI ({ROOT / 'mcraw'})")
        import random

        self.leg, self.seed = leg, seed
        self.device = str(resolve_device(device))
        self.failures_dir = failures
        self.inject = inject
        self.rng = np.random.default_rng(seed)
        self.prng = random.Random(seed)
        self.payloads = json_payloads() if leg == "json" else None
        self.iteration = self.failures = self.reproducers = 0
        self.commands: Counter = Counter()
        self._counts = _launches()

    def step(self) -> None:
        from .soak import MAX_REPRODUCERS, at

        self.iteration += 1
        at(self.iteration, self.leg, self.inject)
        with tempfile.TemporaryDirectory(prefix="mcraw_torch_soak_") as td:
            work = Path(td)
            clip = work / "clip.mcraw"
            if self.leg == "container":
                what = {"frames": author_random_clip(self.rng, clip)}
            else:
                blob, what = json_clip(self.rng, self.prng, self.payloads)
                clip.write_bytes(blob)
            found = compare_clip(clip, work, self.device)
            for cmd, notes in found.items():
                self.commands[cmd] += 1
                if notes:
                    self.failures += 1
                    row = {"leg": self.leg, "seed": self.seed, "iteration": self.iteration,
                           "path": cmd, "what": what, "note": "; ".join(notes)[:800]}
                    print(json.dumps({"failure": row}), file=sys.stderr, flush=True)
                    if self.reproducers < MAX_REPRODUCERS:
                        self.reproducers += 1
                        self.failures_dir.mkdir(parents=True, exist_ok=True)
                        stem = f"FAIL_{self.leg}_s{self.seed}_i{self.iteration}_{cmd}"
                        (self.failures_dir / f"{stem}.mcraw").write_bytes(clip.read_bytes())
                        (self.failures_dir / f"{stem}.json").write_text(json.dumps(row))

    def summary(self, seconds: float) -> dict:
        return {"leg": self.leg, "seed": self.seed, "device": self.device,
                "iterations": self.iteration, "failures": self.failures, "crashes": 0,
                "commands": dict(self.commands),
                "launches": {k: n - self._counts[k] for k, n in _launches().items()},
                "seconds": seconds}


def _launches() -> dict:
    from .soak import COUNTED

    return {k: m.KERNEL_LAUNCHES for k, m in COUNTED.items()}
