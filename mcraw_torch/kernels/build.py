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
:func:`check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None

# Guards the wrappers' KERNEL_LAUNCHES / PLAIN_CALLS increments: export
# workers launch from several threads, and `x += 1` is a read-modify-write.
COUNTER_LOCK = threading.Lock()


def _sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def _digest(csrc: Path = CSRC) -> str:
    h = hashlib.sha256()
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
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


def library_path(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    return build_dir / f"libmcraw_torch_{_digest(csrc)}.so"


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernels of ``csrc/*.cu`` unless the stamped library
    exists in `build_dir`; its path.

    The compiler's output (``-Xptxas -v``: registers and shared memory per
    kernel) is kept beside the library as ``<name>.log``."""
    out = library_path(csrc, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    sources = _sources(csrc)
    objs = [build_dir / f"{src.stem}.{tag}.o" for src in sources]
    tmp = out.with_suffix(f".{tag}")
    cmds = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        for src, obj in zip(sources, objs)
    ]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]

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


def load(path: Path) -> ctypes.CDLL:
    """A built kernel library with its entry points bound."""
    cdll = ctypes.CDLL(str(path))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    cdll.mcraw_unpack_modern.restype = ctypes.c_int
    cdll.mcraw_unpack_modern.argtypes = [
        p, i64, p, p, p, p, p, p, i64, i64, i64, i64, p,
    ]
    cdll.mcraw_unpack_legacy.restype = ctypes.c_int
    cdll.mcraw_unpack_legacy.argtypes = [
        p, i64, p, p, p, p, i64, i64, i64, p,
    ]
    # The batch entries; an earlier csrc (python -m mcraw_torch.kernel_ab)
    # may not have them.
    if hasattr(cdll, "mcraw_unpack_modern_batch"):
        cdll.mcraw_unpack_modern_batch.restype = ctypes.c_int
        cdll.mcraw_unpack_modern_batch.argtypes = [
            p, i64, p, p, i64, i64, p, p, p, p, p, p, i64, i64, i64, i64, i64, p,
        ]
    if hasattr(cdll, "mcraw_unpack_legacy_batch"):
        cdll.mcraw_unpack_legacy_batch.restype = ctypes.c_int
        cdll.mcraw_unpack_legacy_batch.argtypes = [
            p, i64, p, p, i64, p, p, p, p, i64, i64, i64, p,
        ]
    cdll.mcraw_checksum.restype = ctypes.c_int
    cdll.mcraw_checksum.argtypes = [p, i64, ctypes.c_int32, p, p]
    cdll.mcraw_develop.restype = ctypes.c_int
    cdll.mcraw_develop.argtypes = [
        p, p, i64, i64, i64, p, p, p, ctypes.c_int32, p,
    ]
    cdll.mcraw_cuda_error_string.restype = ctypes.c_char_p
    cdll.mcraw_cuda_error_string.argtypes = [ctypes.c_int]
    return cdll


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry reports a CUDA error."""
    if err != 0:
        text = lib().mcraw_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {text}")
