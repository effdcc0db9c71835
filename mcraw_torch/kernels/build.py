"""Build the CUDA kernels into one shared library and bind it with ctypes.

The sources are ``mcraw_torch/csrc/*.cu``, each with a plain C entry point.
At first use ``nvcc`` compiles them for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into
``mcraw_torch/build/libmcraw_torch_<digest>.so``; the digest is the sha256
of the sources and the flags, so an edited source rebuilds and an
unchanged one loads the library already there. Nothing is downloaded. A
failed build raises: there is no fallback library.

Every pointer and the stream are ``c_void_p`` and every size ``c_int64``;
each entry returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises when it is not 0. The wrappers call the entries
through :func:`launch`.

The checked build (``csrc/checked.cuh``) is the same sources compiled with
one more define, ``-DMCRAW_CHECKED``, into
``libmcraw_torch_checked_<digest>.so``: every global load and store,
``cp.async``, TMA destination and shared-memory index of the five kernels
is held to the extent of its buffer, as are the reach of the develop
ring's tensor map and the source of each of the modern unpack's bulk
copies (a ``cp.async``), and a batch frame's reads outside its own window are
counted. A process asks for it in code, before its first launch, with
:func:`use_checked` (it needs a card; nothing selects it otherwise, and
there is no fallback). There each :func:`launch` waits for its kernel,
reads the fault record and raises :class:`CheckedFault` on a fault;
:data:`CHECKED` keeps the counts and :func:`understate` takes bytes off an
extent so a test can show that a check fires.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .. import observe

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

CHECKED_DEFINE = "-DMCRAW_CHECKED"

_lock = threading.Lock()
_lib = None
_lib_path: Path | None = None
_checked = False

# Guards the wrappers' KERNEL_LAUNCHES / PLAIN_CALLS increments: export
# workers launch from several threads, and `x += 1` is a read-modify-write.
COUNTER_LOCK = threading.Lock()


def _sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def flags(checked: bool = False) -> tuple[str, ...]:
    """nvcc's flags: :data:`NVCC_FLAGS`, and the define of the checked
    build."""
    return (*NVCC_FLAGS, CHECKED_DEFINE) if checked else NVCC_FLAGS


def _digest(csrc: Path = CSRC, checked: bool = False) -> str:
    h = hashlib.sha256()
    for src in sorted([*_sources(csrc), *csrc.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags(checked)).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the "
            "mcraw_torch CUDA kernels cannot be built"
        )
    return found


def library_path(csrc: Path = CSRC, build_dir: Path = BUILD_DIR, checked: bool = False
                 ) -> Path:
    kind = "checked_" if checked else ""
    return build_dir / f"libmcraw_torch_{kind}{_digest(csrc, checked)}.so"


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR, checked: bool = False) -> Path:
    """Compile the kernels of ``csrc/*.cu`` (with ``-DMCRAW_CHECKED`` when
    `checked`) unless the stamped library exists in `build_dir`; its path.

    The compiler's output (``-Xptxas -v``: registers and shared memory per
    kernel) is kept beside the library as ``<name>.log``. The two builds
    may run at once in one directory."""
    out = library_path(csrc, build_dir, checked)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{'checked.' if checked else ''}{os.getpid()}.tmp"
    sources = _sources(csrc)
    objs = [build_dir / f"{src.stem}.{tag}.o" for src in sources]
    tmp = out.with_suffix(f".{tag}")
    cmds = [
        [nvcc, *flags(checked), "-c", "-o", str(obj), str(src)]
        for src, obj in zip(sources, objs)
    ]
    link = [nvcc, *flags(checked), "-shared", "-o", str(tmp), *map(str, objs)]

    def run(cmd):
        return cmd, subprocess.run(cmd, capture_output=True, text=True)

    try:
        with ThreadPoolExecutor(len(cmds)) as pool:
            results = list(pool.map(run, cmds))
        if all(res.returncode == 0 for _, res in results):
            results.append(run(link))
        text = "".join(
            " ".join(cmd) + "\n" + res.stdout + res.stderr for cmd, res in results
        )
        out.with_suffix(".log").write_text(text)
        failed = [res.returncode for _, res in results if res.returncode != 0]
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed (exit {failed[0]}):\n{text}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def load(path: Path, checked: bool = False) -> ctypes.CDLL:
    """A built kernel library with its entry points bound; a checked
    build's entries take one more pointer, to a :class:`CheckArgs`."""
    cdll = ctypes.CDLL(str(path))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    # The modern unpack's persistent grid is an argument of its entry
    # (python -m mcraw_torch.kernel_ab may load a csrc older than it).
    persistent = hasattr(cdll, "mcraw_unpack_modern_resident")
    if persistent:
        cdll.mcraw_unpack_modern_resident.restype = i64
        cdll.mcraw_unpack_modern_resident.argtypes = []
    entries = {
        "mcraw_unpack_modern_batch": [
            p, i64, p, p, i64, i64, p, p, p, p, p, p, i64, i64, i64, i64, i64,
            *([i64] if persistent else []), p],
        "mcraw_unpack_legacy_batch": [p, i64, p, p, i64, p, p, p, p, i64, i64, i64, p],
        "mcraw_checksum": [p, i64, i32, p, p],
        "mcraw_develop": [p, p, i64, i64, i64, p, p, p, i32, p],
        "mcraw_block_offsets_batch": [p, i64, i64, p, p, i64, p],
        "mcraw_develop_ring": [p, p, i64, i64, i64, p, p, p, i32, p, p],
        "mcraw_develop_rows": [p, p, i64, i64, i64, p, i64, p, i64, p, i32, p],
        "mcraw_develop_rows_ring": [p, p, i64, i64, i64, p, i64, p, i64, p, i32, p, p],
    }
    for name, argtypes in entries.items():
        # An earlier csrc (python -m mcraw_torch.kernel_ab) may not have
        # the block offsets, the develop ring or the per-frame develop.
        if hasattr(cdll, name) or not name.endswith(("_offsets_batch", "_ring", "_rows")):
            fn = getattr(cdll, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [*argtypes, p] if checked else argtypes
    if hasattr(cdll, "mcraw_develop_map"):  # encodes on the host: no checked argument
        cdll.mcraw_develop_map.restype = ctypes.c_int
        cdll.mcraw_develop_map.argtypes = [p, p, p, p, p]
    cdll.mcraw_cuda_error_string.restype = ctypes.c_char_p
    cdll.mcraw_cuda_error_string.argtypes = [ctypes.c_int]
    return cdll


def lib() -> ctypes.CDLL:
    """The loaded kernel library, the default build at first use."""
    global _lib, _lib_path
    with _lock:
        if _lib is None:
            _lib_path = build()
            _lib = load(_lib_path)
        return _lib


def use_checked() -> Path:
    """Make the checked build this process's kernel library (built at the
    first call); its path. Call it before the first launch: it raises when
    the default library is already loaded, and without a card. There is no
    fallback."""
    global _lib, _lib_path, _checked
    import torch

    with _lock:
        if _lib is not None:
            if _checked:
                return _lib_path
            raise RuntimeError(
                f"the default kernel library ({_lib_path.name}) is already loaded in this "
                "process: ask for the checked build before the first launch")
        if not torch.cuda.is_available():
            raise RuntimeError("the checked build needs a CUDA card (torch.cuda.is_available() "
                               "is false); there is no fallback")
        path = build(checked=True)
        _lib, _lib_path, _checked = load(path, checked=True), path, True
        return path


def checked() -> bool:
    """Whether this process runs the checked build."""
    return _checked


def loaded() -> Path | None:
    """The path of the kernel library this process loaded, if any."""
    return _lib_path


def check(err: int, name: str) -> None:
    """Raise when a C entry reports a CUDA error."""
    if err != 0:
        text = lib().mcraw_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {text}")


# -- the checked build ------------------------------------------------------------

# The kernels, their entries and, per kernel, its buffers in the order of
# its csrc file's `enum Buffer` (kBufWords -> "words"): the entry's global
# buffers, then its shared arrays. csrc/checked.cuh's Kernel, Entry, Kind
# and Record enums are in the order of these tuples.
KERNELS = ("unpack_modern", "unpack_legacy", "develop", "checksum", "block_offsets")
ENTRIES = {
    "mcraw_unpack_modern_batch": "unpack_modern",
    "mcraw_unpack_legacy_batch": "unpack_legacy",
    "mcraw_develop": "develop",
    "mcraw_checksum": "checksum",
    "mcraw_block_offsets_batch": "block_offsets",
    "mcraw_develop_ring": "develop",
    "mcraw_develop_rows": "develop",
    "mcraw_develop_rows_ring": "develop",
}
BUFFERS = {
    "unpack_modern": ("words", "bits", "refs", "offsets", "desc", "class_index", "out",
                      "bases", "lengths", "s_desc", "s_words", "s_off", "s_cls", "s_ref",
                      "s_head"),
    "unpack_legacy": ("payload", "bits", "refs", "offsets", "out", "bases", "lengths",
                      "s_span", "s_off", "s_cls", "s_ref"),
    "develop": ("raw", "out", "quantizer", "params", "cfa", "s_tile", "s_q", "map", "s_ring",
                "rows", "cfas"),
    "checksum": ("x", "out", "s_warp"),
    "block_offsets": ("bits", "offsets", "status", "s_local", "s_warp", "s_tile"),
}
KINDS = ("load", "cp.async", "store", "shared", "host")
RECORD = ("faults", "kernel", "entry", "buffer", "kind", "index", "extent", "block_x",
          "block_y", "thread", *(f"by_kind.{k}" for k in KINDS), "cross_frame_reads")
_BY_KIND = RECORD.index("by_kind.load")
_CROSS = RECORD.index("cross_frame_reads")
MAX_BUFFERS = 16

# Per kernel, since the process started: checked launches, faults, and
# batch reads outside a frame's own window.
CHECKED = {"launches": Counter(), "faults": Counter(), "cross_frame_reads": Counter()}


class CheckArgs(ctypes.Structure):
    """csrc/checked.cuh's Args: each global buffer's address and byte
    extent, bytes taken off each extent (a shared array's: off its true
    size) and off each batch frame's window, the device record, and the
    host record of the entry's own accesses."""

    _fields_ = [
        ("addr", ctypes.c_int64 * MAX_BUFFERS),
        ("bytes", ctypes.c_int64 * MAX_BUFFERS),
        ("trim", ctypes.c_int64 * MAX_BUFFERS),
        ("window_trim", ctypes.c_int64),
        ("record", ctypes.c_int64),
        ("host", ctypes.c_int64 * len(RECORD)),
    ]


class CheckedFault(RuntimeError):
    """A checked launch's fault: `record` is its first fault's fields by
    name (RECORD), `counts` its faults by kind."""

    def __init__(self, text: str, record: dict, counts: dict):
        super().__init__(text)
        self.record, self.counts = record, counts

    @property
    def buffer(self) -> str:
        return self.record["buffer"]


_trims = threading.local()


@contextlib.contextmanager
def understate(kernel: str, **trims: int):
    """Within the block, this thread's checked launches of `kernel` hold
    each named buffer (BUFFERS) to its extent less the given bytes, and
    ``window=n`` each batch frame to its window less n bytes: the checks'
    own extents, not the buffers'. Clean inputs then fault where they touch
    the cut-off bytes, which shows that a check fires."""
    unknown = set(trims) - set(BUFFERS[kernel]) - {"window"}
    if unknown:
        raise ValueError(f"{kernel} has no buffers {sorted(unknown)}")
    old = getattr(_trims, "by_kernel", {})
    _trims.by_kernel = {**old, kernel: trims}
    try:
        yield
    finally:
        _trims.by_kernel = old


def _extent(buf) -> tuple[int, int]:
    """(address, bytes) of a tensor, a NumPy array or None."""
    if buf is None:
        return 0, 0
    if hasattr(buf, "data_ptr"):
        return buf.data_ptr(), buf.numel() * buf.element_size()
    return buf.ctypes.data, buf.nbytes


def describe(record: list[int], entry: str) -> tuple[str, dict, dict]:
    """The text of a fault record (RECORD order), its first fault's fields
    and its counts by kind."""
    r = dict(zip(RECORD, record))
    kernel = KERNELS[r["kernel"]]
    fields = {**r, "kernel": kernel, "buffer": BUFFERS[kernel][r["buffer"]],
              "kind": KINDS[r["kind"]]}
    counts = {k: r[f"by_kind.{k}"] for k in KINDS}
    where = ("on the host" if r["block_x"] < 0 else
             f"block ({r['block_x']}, {r['block_y']}), thread {r['thread']}")
    text = (f"{entry}: {r['faults']} out-of-bounds access(es) in the checked {kernel} "
            f"kernel; the first: a {fields['kind']} of {fields['buffer']} at byte "
            f"{r['index']} of its extent {r['extent']}, {where}; by kind: "
            + ", ".join(f"{k} {n}" for k, n in counts.items()))
    return text, fields, counts


def _new_record():
    """A zeroed fault record on the current card."""
    import torch

    return torch.zeros(len(RECORD), dtype=torch.int64, device="cuda")


def launch(entry: str, buffers: tuple, *args) -> None:
    """Call the C entry `entry` with `args` and raise on a CUDA error.

    In a checked process the entry also gets the extents of `buffers` (its
    kernel's global buffers in BUFFERS order, None where it has none), the
    call waits for the launch, and a fault raises :class:`CheckedFault`.
    Call it with the launch's device current. The whole call, the library
    lookup included, is the span ``launch.<entry>``."""
    with observe.span("launch." + entry):
        _launch(entry, buffers, args)


def _launch(entry: str, buffers: tuple, args: tuple) -> None:
    fn = getattr(lib(), entry)
    if not _checked:
        check(fn(*args), entry)
        return
    kernel = ENTRIES[entry]
    names = BUFFERS[kernel]
    ca = CheckArgs()
    for i, buf in enumerate(buffers):
        ca.addr[i], ca.bytes[i] = _extent(buf)
    trims = getattr(_trims, "by_kernel", {}).get(kernel, {})
    for name, n in trims.items():
        if name == "window":
            ca.window_trim = n
        else:
            ca.trim[names.index(name)] = n
    record = _new_record()
    ca.record = record.data_ptr()
    check(fn(*args, ctypes.addressof(ca)), entry)
    device = record.tolist()  # waits for the launch: it is on this stream
    host = list(ca.host)
    faults = device[0] + host[0]
    by_kind = [d + h for d, h in zip(device[_BY_KIND:_CROSS], host[_BY_KIND:_CROSS])]
    with COUNTER_LOCK:
        CHECKED["launches"][kernel] += 1
        CHECKED["faults"][kernel] += faults
        CHECKED["cross_frame_reads"][kernel] += device[_CROSS]
    if faults:
        first = host if host[0] else device
        text, fields, counts = describe(
            [faults, *first[1:_BY_KIND], *by_kind, device[_CROSS]], entry)
        raise CheckedFault(text, fields, counts)
