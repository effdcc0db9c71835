"""Host-side serial scans in C++ (``mcraw_torch/csrc/mcraw_host.cpp``).

Two format-imposed serial chains run on the host:

- the modern codec's metadata streams (inline 2-byte headers; ~numBlocks/64
  iterations per frame), and
- the legacy codec's whole-block header chain (~W*H/16 iterations per frame).

The port's copy of :mod:`mcraw.kernels.native` and of the functions of
``native/mcraw_host.cpp`` it binds, so that mcraw_torch imports nothing of
mcraw. At first use ``g++`` builds the source into
``mcraw_torch/build/libmcraw_host_<digest>.so`` (the digest is the sha256
of the source and the flags, so an edited source rebuilds). Unlike the JAX
package's module there is no pure-Python fallback: a failed build raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..errors import DecodeError

PKG = Path(__file__).resolve().parents[1]
SOURCE = PKG / "csrc" / "mcraw_host.cpp"
BUILD_DIR = PKG / "build"
# Portable baseline (not -march=native): the library may be built on one
# host and loaded on another.
GXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared", "-Wall", "-Werror")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libmcraw_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the host library unless the stamped one exists; its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"g++ could not run ({e}); the host scans cannot be built") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed (exit {res.returncode}):\n{' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8p, u16p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint16)
            i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
            i64 = ctypes.c_int64
            lib.mcraw_metadata_scan.restype = i64
            lib.mcraw_metadata_scan.argtypes = [u8p, i64, i64, u16p, i64]
            lib.mcraw_legacy_scan.restype = i64
            lib.mcraw_legacy_scan.argtypes = [u8p, i64, i64, i64, i32p, u16p, i64p]
            lib.mcraw_legacy_scan_range.restype = i64
            lib.mcraw_legacy_scan_range.argtypes = [
                u8p, i64, i64, i64, i64, i32p, u16p, i64p, i64p,
            ]
            _lib = lib
        return _lib


def have_native() -> bool:
    """Whether the host library builds and loads here (a query: the scans
    themselves raise when it does not)."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def decode_metadata_stream(data: np.ndarray, offset: int) -> tuple[np.ndarray, int]:
    """Decode one modern metadata stream: (values (numBlocks,) uint16,
    offset past the stream)."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    if offset + 4 > n:
        raise DecodeError("metadata stream header out of bounds")
    num_blocks = int(np.frombuffer(data[offset : offset + 4].tobytes(), "<u4")[0])
    if num_blocks > 64 * max(0, n - offset - 4) // 2:
        raise DecodeError("metadata stream declares impossible block count")
    groups = (num_blocks + 63) // 64
    out = np.zeros(groups * 64, dtype=np.uint16)
    end = lib.mcraw_metadata_scan(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        offset,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        num_blocks,
    )
    if end < 0:
        raise DecodeError("metadata stream truncated")
    return out[:num_blocks], int(end)


def _scan_out(num_blocks: int, out):
    """The (bits, refs, offsets) arrays a scan writes: `out`, three
    contiguous (num_blocks,) int32 / uint16 / int64 arrays, or new ones."""
    if out is None:
        return (np.zeros(num_blocks, dtype=np.int32), np.zeros(num_blocks, dtype=np.uint16),
                np.zeros(num_blocks, dtype=np.int64))
    for a, dtype in zip(out, (np.int32, np.uint16, np.int64)):
        if a.dtype != dtype or a.shape != (num_blocks,) or not a.flags.c_contiguous:
            raise ValueError(f"scan output must be a contiguous ({num_blocks},) {dtype}")
    return out


def legacy_scan(
    data: np.ndarray, num_blocks: int, start_offset: int = 0, out=None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Walk the legacy header chain: (bits, refs, payload offsets just past
    each header), written into `out` (see :func:`_scan_out`) if given."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    bits, refs, offs = _scan_out(num_blocks, out)
    end = lib.mcraw_legacy_scan(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(data),
        start_offset,
        num_blocks,
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        refs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if end < 0:
        raise DecodeError("legacy stream truncated")
    return bits, refs, offs


_SCAN_POOL = None


def _scan_pool():
    """Shared scan thread pool: create/shutdown per call measured ~11 ms,
    more than the 4K serial scan itself. Made once under the lock: export
    workers scan from several threads at once."""
    global _SCAN_POOL
    with _lock:
        if _SCAN_POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            _SCAN_POOL = ThreadPoolExecutor(
                max_workers=min(16, os.cpu_count() or 1),
                thread_name_prefix="mcraw-scan",
            )
        return _SCAN_POOL


def legacy_scan_parallel(
    data: np.ndarray,
    num_blocks: int,
    chunk_starts,
    out=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Chunk-parallel legacy header walk over the trailing offset table.

    The table (RawData_Legacy.cpp:452-469; parsed by
    numpy_ref.legacy_chunk_offsets) names block-aligned payload positions,
    so each [start, next_start) segment scans independently and the ordered
    concatenation equals the serial walk. Each segment is validated to end
    EXACTLY at the next boundary — a bogus table (block straddling a
    boundary, short counts) returns None and callers fall back to the
    serial scan. Threads release the GIL inside the ctypes call. A result
    goes into `out` (see :func:`_scan_out`) if given; a None leaves it
    untouched.
    """
    lib = get_lib()
    n = len(data)
    starts = sorted({int(s) for s in chunk_starts if 0 < s < n})
    if not starts or num_blocks <= 0:
        return None
    bounds = [0] + starts + [n]
    nseg = len(bounds) - 1
    data = np.ascontiguousarray(data, dtype=np.uint8)
    dptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def scan_seg(k):
        s, e = bounds[k], bounds[k + 1]
        limit = e if k < nseg - 1 else n
        cap = min(num_blocks, max(1, (e - s) // 2 + 1))
        bits = np.empty(cap, dtype=np.int32)
        refs = np.empty(cap, dtype=np.uint16)
        offs = np.empty(cap, dtype=np.int64)
        end = ctypes.c_int64(0)
        cnt = lib.mcraw_legacy_scan_range(
            dptr, n, s, limit, cap,
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            refs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.byref(end),
        )
        return int(cnt), int(end.value), bits, refs, offs

    results = list(_scan_pool().map(scan_seg, range(nseg)))

    # Walk segments in order; every segment consumed before num_blocks is
    # reached must be exactly continuous with the next boundary.
    parts = []
    have = 0
    for k, (cnt, end, bits, refs, offs) in enumerate(results):
        take = min(cnt, num_blocks - have)
        parts.append((bits[:take], refs[:take], offs[:take]))
        have += take
        if have == num_blocks:
            break
        # need more blocks from the next segment: this one must have ended
        # exactly at the boundary (and not be the last)
        if k == nseg - 1 or end != bounds[k + 1] or cnt != take:
            return None
    if have < num_blocks:
        return None
    return _concatenate(parts, num_blocks, out)


def _concatenate(parts, num_blocks: int, out):
    """The (bits, refs, offsets) pieces of a parallel scan, in order, in
    the arrays of :func:`_scan_out`."""
    out = _scan_out(num_blocks, out)
    for k, a in enumerate(out):
        np.concatenate([p[k] for p in parts], out=a)
    return out


def legacy_scan_speculative(
    data: np.ndarray,
    num_blocks: int,
    start_offset: int = 0,
    nseg: int | None = None,
    window: int = 4096,
    stats: dict | None = None,
    out=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Parallel legacy header walk WITHOUT the trailing offset table.

    The table (RawData_Legacy.cpp:452-469) is optional, and this path needs
    no alignment oracle: the header chain is self-synchronizing. K threads
    scan speculatively from evenly spaced byte guesses (almost certainly
    MISALIGNED — reading payload bytes as headers); each also overscans
    `window` bytes past the next guess. Because both the true chain and a
    speculative chain advance by the same header-driven steps from any
    position they share, the true chain entering segment k (known once
    segment k-1 is stitched) either lands on a position segment k's
    speculative chain visited — the SPLICE point, after which segment k's
    records are exact — or, for adversarial payloads that never converge,
    the segment is rescanned serially from its true entry (correct, just
    not parallel).

    Every emitted block is therefore on the true chain by induction from
    the true `start_offset`; equality with the serial scan is structural,
    not probabilistic. Returns None when the stitched walk cannot produce
    `num_blocks` blocks (truncation near EOF, tiny payloads) — callers fall
    back to the serial scan for its exact error semantics. `stats`
    (optional dict) gets `spliced`/`rescanned` segment counts and
    `splice_bytes` (serial bytes spent per splice). A result goes into
    `out` (see :func:`_scan_out`) if given; a None leaves it untouched.
    """
    lib = get_lib()
    n = len(data)
    if num_blocks <= 0 or n - start_offset < 4 * window:
        return None
    if nseg is None:
        nseg = min(16, os.cpu_count() or 1)
        # Keep segments big enough that the splice work (~window bytes
        # serial-equivalent) stays negligible.
        nseg = max(1, min(nseg, (n - start_offset) // (64 * window)))
    if nseg < 2:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    dptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    seg = (n - start_offset) // nseg
    # PARITY TRAP: every legacy block is 2 + kLegacyBlockLength[bits]
    # bytes — always EVEN — so any chain's byte-position parity is
    # invariant. A guess with parity opposite to start_offset's can never
    # land on the true chain. Align every guess to the true chain's parity.
    guesses = [
        start_offset + (k * seg - (k * seg & 1)) for k in range(nseg)
    ] + [n]

    def scan_from(s, limit):
        cap = min(num_blocks + 1, max(1, (limit - s) // 2 + 2))
        bits = np.empty(cap, dtype=np.int32)
        refs = np.empty(cap, dtype=np.uint16)
        offs = np.empty(cap, dtype=np.int64)
        end = ctypes.c_int64(0)
        cnt = lib.mcraw_legacy_scan_range(
            dptr, n, s, limit, cap,
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            refs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.byref(end),
        )
        return int(cnt), bits, refs, offs

    def limit_of(k):
        return n if k + 1 >= nseg else min(guesses[k + 1] + window, n)

    recs = list(
        _scan_pool().map(
            lambda k: scan_from(guesses[k], limit_of(k)), range(nseg)
        )
    )

    st = {"spliced": 0, "rescanned": 0, "splice_bytes": 0}
    parts = []
    have = 0
    cnt, bits, refs, offs = recs[0]
    j = 0  # first valid (true-chain) record index in the current arrays
    k = 0  # current segment
    while True:
        next_g = guesses[k + 1]
        h = offs[:cnt] - 2  # header positions of the current records
        upto = int(np.searchsorted(h[j:], next_g)) + j
        take = min(upto - j, num_blocks - have)
        parts.append((bits[j:j + take], refs[j:j + take], offs[j:j + take]))
        have += take
        if have == num_blocks:
            break
        # (take == upto - j here: a num_blocks-bounded take implies
        # have == num_blocks, already broken out above.)
        if k + 1 >= nseg or upto == cnt:
            # Ran out of segments, or this segment's records were
            # exhausted before its boundary (truncation): serial fallback
            # owns the error semantics.
            return None
        # True positions inside segment k+1 known from our overscan.
        ov = h[upto:]
        ncnt, nbits, nrefs, noffs = recs[k + 1]
        hn = noffs[:ncnt] - 2
        pos = np.searchsorted(hn, ov)
        ok = pos < ncnt
        ok[ok] = hn[pos[ok]] == ov[ok]
        m = int(np.argmax(ok)) if ok.any() else -1
        if m >= 0:
            take2 = min(m, num_blocks - have)
            parts.append(
                (
                    bits[upto:upto + take2],
                    refs[upto:upto + take2],
                    offs[upto:upto + take2],
                )
            )
            have += take2
            if have == num_blocks:
                break
            st["spliced"] += 1
            st["splice_bytes"] += int(ov[m] - next_g)
            cnt, bits, refs, offs = recs[k + 1]
            j = int(pos[m])
        else:
            # No convergence in the window: rescan segment k+1 serially
            # from its true entry position.
            st["rescanned"] += 1
            cnt, bits, refs, offs = scan_from(int(ov[0]), limit_of(k + 1))
            j = 0
        k += 1
    if stats is not None:
        stats.update(st)
    if have < num_blocks:
        return None
    return _concatenate(parts, num_blocks, out)
