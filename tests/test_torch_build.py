"""mcraw_torch/kernels/build.py without nvcc or a card: the checked build's
flags, digest and file name beside the default build's, its selection
(only an explicit call, never before or beside the default library, never
without a card), its buffer tables against the CUDA sources, and a fault
record turned into the raised error (the card's part is in
tests/test_torch_gpu.py)."""

import ctypes
import hashlib
import os
import re
from pathlib import Path

import pytest
import torch

from mcraw_torch import bounds
from mcraw_torch import soak as S
from mcraw_torch.kernels import build

CSRC = Path(build.__file__).resolve().parents[1] / "csrc"


@pytest.fixture
def fresh(monkeypatch):
    """build's process state as before any load."""
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_lib_path", None)
    monkeypatch.setattr(build, "_checked", False)


def test_default_flags_unchanged():
    assert build.NVCC_FLAGS == ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                                "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
    assert build.flags() == build.NVCC_FLAGS
    h = hashlib.sha256()
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(build.NVCC_FLAGS).encode())
    assert build.library_path().name == f"libmcraw_torch_{h.hexdigest()[:16]}.so"


def test_checked_flags_digest_and_name_differ():
    assert build.flags(checked=True) == (*build.NVCC_FLAGS, "-DMCRAW_CHECKED")
    assert build._digest(checked=True) != build._digest()
    default, checked = build.library_path(), build.library_path(checked=True)
    assert re.fullmatch(r"libmcraw_torch_checked_[0-9a-f]{16}\.so", checked.name)
    assert checked.parent == default.parent == build.BUILD_DIR
    assert default.name != checked.name


def test_checked_after_default_raises(fresh, monkeypatch):
    monkeypatch.setattr(build, "_lib", object())
    monkeypatch.setattr(build, "_lib_path", Path("libmcraw_torch_0123456789abcdef.so"))
    with pytest.raises(RuntimeError, match="already loaded"):
        build.use_checked()
    assert not build.checked()


def test_checked_without_card_raises(fresh, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "build", lambda *a, **k: pytest.fail("built without a card"))
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        build.use_checked()
    assert (build.checked(), build.loaded()) == (False, None)


class _Recording(dict):
    """os.environ that records every key read."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = []

    def __getitem__(self, k):
        self.read.append(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        self.read.append(k)
        return super().get(k, default)

    def __contains__(self, k):
        self.read.append(k)
        return super().__contains__(k)


def test_no_environment_variable_selects_the_checked_build(fresh, monkeypatch):
    env = _Recording(os.environ)
    monkeypatch.setattr(os, "environ", env)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build.flags(checked=True)
    build.library_path(checked=True)
    with pytest.raises(RuntimeError):
        build.use_checked()
    assert (build.checked(), build.loaded()) == (False, None)
    assert env.read == []


def test_buffer_tables_match_the_sources():
    """BUFFERS is each csrc file's `enum Buffer` (kBufClassIndex ->
    class_index); KERNELS, ENTRIES, KINDS and RECORD are checked.cuh's
    Kernel, Entry, Kind and Record enums."""

    def names(text, enum):
        body = re.search(r"enum " + enum + r" : int \{(.*?)\};", text, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        return [n.split("=")[0].strip() for n in body.split(",") if n.strip()]

    def snake(name, prefix):
        return re.sub(r"(?<!^)(?=[A-Z])", "_", name[len(prefix):]).lower()

    for kernel, bufs in build.BUFFERS.items():
        text = (CSRC / f"{kernel}.cu").read_text()
        got = [snake(n, "kBuf") for n in names(text, "Buffer")]
        assert tuple(got) == bufs, kernel
        assert len(bufs) <= build.MAX_BUFFERS
    cuh = (CSRC / "checked.cuh").read_text()
    assert [snake(n, "k") for n in names(cuh, "Kernel")] == list(build.KERNELS)
    assert [snake(n, "kEntry") for n in names(cuh, "Entry")] == [
        e[len("mcraw_"):] for e in build.ENTRIES]
    kinds = names(cuh, "Kind")
    assert [snake(n, "k") for n in kinds[:-1]] == [k.replace(".", "_") for k in build.KINDS]
    record = names(cuh, "Record")
    assert [snake(n, "k") for n in record[:10]] == list(build.RECORD[:10])
    assert record[10:] == ["kByKind", "kCrossFrame", "kRecordWords"]
    assert build.RECORD[10:] == (*(f"by_kind.{k}" for k in build.KINDS), "cross_frame_reads")
    words = 3 * build.MAX_BUFFERS + 2 + len(build.RECORD)
    assert ctypes.sizeof(build.CheckArgs) == 8 * words


@pytest.mark.parametrize("kernel, entry", [("unpack_modern", "mcraw_unpack_modern_batch"),
                                           ("unpack_legacy", "mcraw_unpack_legacy_batch"),
                                           ("block_offsets", "mcraw_block_offsets_batch")])
def test_one_entry_a_decode_kernel(kernel, entry):
    """Each decode kernel has one C entry, its batch entry (a frame is the
    batch of one): no single-frame entry is left in ENTRIES or in the
    sources, and no kernel is a template on the batch."""
    assert [e for e, k in build.ENTRIES.items() if k == kernel] == [entry]
    assert len(build.ENTRIES) == 8
    single = entry.removesuffix("_batch")
    assert single not in build.ENTRIES
    text = (CSRC / f"{kernel}.cu").read_text()
    assert f"int {entry}(" in text and f"int {single}(" not in text
    assert "kBatch" not in text and f"{kernel}_kernel<true>" not in text


def _fake_record(entry, buffer, kind, index, extent, faults=3, cross=0, block=(5, 1, 37)):
    kernel = build.ENTRIES[entry]
    rec = [0] * len(build.RECORD)
    rec[:10] = [faults, build.KERNELS.index(kernel), list(build.ENTRIES).index(entry),
                build.BUFFERS[kernel].index(buffer), build.KINDS.index(kind), index, extent,
                *block]
    rec[10 + build.KINDS.index(kind)] = faults
    rec[-1] = cross
    return rec


def test_fault_record_is_parsed_into_the_text():
    rec = _fake_record("mcraw_unpack_modern_batch", "words", "cp.async", 15053680, 15053672)
    text, fields, counts = build.describe(rec, "mcraw_unpack_modern_batch")
    assert fields["buffer"] == "words" and fields["kind"] == "cp.async"
    assert counts == {"load": 0, "cp.async": 3, "store": 0, "shared": 0, "host": 0}
    for part in ("mcraw_unpack_modern_batch", "3 out-of-bounds", "unpack_modern",
                 "cp.async of words", "byte 15053680", "extent 15053672",
                 "block (5, 1), thread 37"):
        assert part in text
    host = _fake_record("mcraw_develop", "params", "host", 67, 64, faults=1,
                        block=(-1, -1, -1))
    assert "on the host" in build.describe(host, "mcraw_develop")[0]


class _FakeEntry:
    """A checked C entry on the CPU: records its arguments and writes
    `device` into the device record and `host` into the host record."""

    def __init__(self, device=None, host=None, err=0):
        self.device, self.host, self.err, self.args = device, host, err, None

    def __call__(self, *args):
        ca = build.CheckArgs.from_address(args[-1])
        self.args = args[:-1]
        self.extents = [(ca.addr[i], ca.bytes[i], ca.trim[i]) for i in range(4)]
        self.window_trim = ca.window_trim
        if self.device:
            ctypes.memmove(ca.record, (ctypes.c_int64 * len(self.device))(*self.device),
                           8 * len(self.device))
        if self.host:
            for i, v in enumerate(self.host):
                ca.host[i] = v
        return self.err


@pytest.fixture
def fake_checked(fresh, monkeypatch):
    """A checked process on the CPU: each launch goes to a _FakeEntry, the
    record is a CPU tensor."""
    class Lib:
        pass

    lib = Lib()
    monkeypatch.setattr(build, "_lib", lib)
    monkeypatch.setattr(build, "_checked", True)
    monkeypatch.setattr(build, "_new_record", lambda: torch.zeros(len(build.RECORD),
                                                                  dtype=torch.int64))
    monkeypatch.setattr(build, "CHECKED", {
        "launches": build.Counter(), "faults": build.Counter(),
        "cross_frame_reads": build.Counter()})
    return lib


def test_checked_launch_passes_extents_and_counts(fake_checked):
    x, out = torch.zeros(10, dtype=torch.uint16), torch.zeros((), dtype=torch.int64)
    fake_checked.mcraw_checksum = entry = _FakeEntry(device=[0] * 15 + [7])
    build.launch("mcraw_checksum", (x, out), 1, 2, 3)
    assert entry.args == (1, 2, 3)
    assert entry.extents[:3] == [(x.data_ptr(), 20, 0), (out.data_ptr(), 8, 0), (0, 0, 0)]
    assert build.CHECKED["launches"]["checksum"] == 1
    assert build.CHECKED["cross_frame_reads"]["checksum"] == 7
    assert build.CHECKED["faults"]["checksum"] == 0
    with build.understate("checksum", x=2, s_warp=4, window=16):
        build.launch("mcraw_checksum", (x, out), 1, 2, 3)
    assert [e[2] for e in entry.extents[:3]] == [2, 0, 4] and entry.window_trim == 16
    build.launch("mcraw_checksum", (x, out), 1, 2, 3)
    assert [e[2] for e in entry.extents[:3]] == [0, 0, 0] and entry.window_trim == 0
    with pytest.raises(ValueError, match="no buffers"):
        with build.understate("checksum", words=2):
            pass


@pytest.mark.parametrize("where", ["device", "host"])
def test_checked_launch_raises_on_a_fault(fake_checked, where):
    x, out = torch.zeros(10, dtype=torch.uint16), torch.zeros((), dtype=torch.int64)
    rec = _fake_record("mcraw_checksum", "x", "load", 18, 16, faults=2)
    fake_checked.mcraw_checksum = _FakeEntry(**{where: rec})
    with pytest.raises(build.CheckedFault) as e:
        build.launch("mcraw_checksum", (x, out), 1, 2, 3)
    assert isinstance(e.value, RuntimeError)
    assert e.value.buffer == "x" and e.value.counts["load"] == 2
    assert "a load of x at byte 18 of its extent 16" in str(e.value)
    assert build.CHECKED["faults"]["checksum"] == 2


def test_checked_launch_reports_a_cuda_error(fake_checked, monkeypatch):
    fake_checked.mcraw_checksum = _FakeEntry(err=1)
    fake_checked.mcraw_cuda_error_string = lambda err: b"invalid argument"
    with pytest.raises(RuntimeError, match="CUDA error 1: invalid argument"):
        build.launch("mcraw_checksum", (None, None), 1)


def test_negative_cases_cover_every_kind_of_every_kernel():
    """Each kernel's access kinds (develop's cp.async are its ring's TMA
    copies, their reach held to raw on the host; its host reads of the
    parameters and the tensor map are the host kind; the checksum and the
    block offsets are cp.async-free, their memsets stores) each have a
    negative case, on a buffer of that kernel; the develop's ring cases
    name buffers of the ring entry."""
    kinds = {k: set() for k in build.KERNELS}
    for kernel, kind, buf, _ in bounds.NEGATIVE:
        assert buf in build.BUFFERS[kernel] and kind in build.KINDS
        kinds[kernel].add(kind)
    assert kinds == {"unpack_modern": {"load", "cp.async", "store", "shared"},
                     "unpack_legacy": {"load", "cp.async", "store", "shared"},
                     "develop": {"load", "cp.async", "store", "shared", "host"},
                     "checksum": {"load", "store", "shared"},
                     "block_offsets": {"load", "store", "shared"}}
    assert bounds.RING_NEGATIVE <= {(k, kind, buf) for k, kind, buf, _ in bounds.NEGATIVE}
    assert {buf for _, _, buf in bounds.RING_NEGATIVE} == {"raw", "s_ring", "map"}


def test_bounds_without_a_card_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        bounds.main(["--device", "cpu"])
    assert e.value.code == 2


@pytest.mark.parametrize("argv", [["--device", "cpu"], ["--grid"]])
def test_soak_checked_on_cpu_exits_2(argv, capsys):
    with pytest.raises(SystemExit) as e:
        S.main(["--checked", *argv])
    assert e.value.code == 2
    assert "--checked needs --device cuda" in capsys.readouterr().err


def test_kernel_ab_sass_functions_strip_the_namespace_hash(monkeypatch):
    """kernel_ab's SASS comparison: a function is known by its name
    without the anonymous-namespace hash (which follows the file's bytes),
    its instructions without their addresses and encodings."""
    import subprocess

    from mcraw_torch import kernel_ab

    dump = """
\t\tFunction : _ZN44_GLOBAL__N__9fa5aef0_11_checksum_cu_02bd7603kernelEv
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                              /* 0x000e220000000800 */
        /*10a0*/                   EXIT ;                     /* 0x000000000000794d */
\t\tFunction : _ZN43_GLOBAL__N__db43d740_10_develop_cu_37cf5901kernelEv
        /*0000*/                   BRA 0x0 ;                  /* 0x0 */
"""
    monkeypatch.setattr(build, "_nvcc", lambda: "/cuda/bin/nvcc")
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, dump, "")

    monkeypatch.setattr(kernel_ab.subprocess, "run", run)
    got = kernel_ab.sass_functions(Path("lib.so"))
    assert calls[0][:2] == ["/cuda/bin/cuobjdump", "-sass"]
    assert got == {
        "_ZN44_GLOBAL__N__11_checksum_cu_02bd7603kernelEv": ["LDC R1, c[0x0][0x28]", "EXIT"],
        "_ZN43_GLOBAL__N__10_develop_cu_37cf5901kernelEv": ["BRA 0x0"],
    }


def test_kernel_ab_plans_the_device_prep(monkeypatch):
    """kernel_ab times the device prep (block_offsets) like the other
    kernels: old, new, variants in turns, one frame and the grade step's
    batch of 8, against the bytes bound of its bits in and offsets out; a
    build without the prep entry (older sources) sits out its turns."""
    from types import SimpleNamespace

    import torch

    from mcraw_torch import kernel_ab

    assert kernel_ab.KERNELS[-1] == "block_offsets" and kernel_ab.OFFSETS_FRAMES == (1, 8)
    before = SimpleNamespace(mcraw_checksum=None)  # sources older than the prep kernel
    variant = SimpleNamespace(mcraw_checksum=None, mcraw_block_offsets_batch=None)
    libs = {"old": before, "v1": variant}
    have = kernel_ab.with_entry(libs, "mcraw_block_offsets_batch")
    assert have == {"v1": variant}
    assert list(kernel_ab.in_turns(have, str.upper, "wrapper").items()) == [
        ("new", "wrapper"), ("v1", "V1")]
    assert list(kernel_ab.in_turns(libs, str.upper, "wrapper")) == ["old", "new", "v1"]
    # 196,608 blocks a 4096x3072 frame: 10 bytes each, 0.000587 ms at 3.35 TB/s
    for frames, bound_ms in ((1, 0.000587), (8, 0.00470)):
        moved = kernel_ab.offsets_bytes(frames, 196_608)
        assert moved / kernel_ab.PEAK_BYTES_PER_S * 1e3 == pytest.approx(bound_ms, rel=2e-3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        kernel_ab.main(["old_csrc", "--kernels", "block_offsets"])
    with pytest.raises(SystemExit) as e:
        kernel_ab.main(["old_csrc", "--kernels", "prep"])
    assert e.value.code == 2


def test_kernel_ab_plans_the_develop_at_the_grade_shape(monkeypatch):
    """kernel_ab times the develop at a 4096x3072 frame and at the grade
    step's batch of 8 3840x2160 frames, against the bytes bound of the
    uint16 plane in and the uint32 RGBA out; a build without the ring entry
    (the parent's sources) is called on its direct entry."""
    from types import SimpleNamespace

    from mcraw_torch import kernel_ab

    assert kernel_ab.DEVELOP_SHAPES == ((1, 3072, 4096), (8, 2160, 3840))
    # 0.0225 ms a 4096x3072 frame, 0.01486 ms a 3840x2160 one, at 3.35 TB/s
    for (frames, h, w), bound_ms in zip(kernel_ab.DEVELOP_SHAPES, (0.02254, 8 * 0.014856)):
        moved = kernel_ab.develop_bytes(frames, h, w)
        assert moved / kernel_ab.PEAK_BYTES_PER_S * 1e3 == pytest.approx(bound_ms, rel=1e-3)
    parent = SimpleNamespace(mcraw_develop=None)
    ring = SimpleNamespace(mcraw_develop=None, mcraw_develop_ring=None)
    assert kernel_ab.with_entry({"parent": parent, "v": ring}, "mcraw_develop_ring") == {"v": ring}


def test_kernel_ab_gives_each_build_the_quantizer_table_of_its_sources(tmp_path):
    """kernel_ab hands each build the table its develop.cu reads: today's
    sources a word a bucket (develop.quantizer_table), sources of the
    8-byte layout the bucket's (next threshold's bits, base) pair."""
    import numpy as np

    from mcraw_torch import kernel_ab
    from mcraw_torch.kernels import develop as D

    words = kernel_ab.quantizer_for(build.CSRC, "cpu")
    assert words.dtype == torch.int32 and words.shape == (D.SRGB_ENTRIES,)
    assert np.array_equal(words.numpy(), D.quantizer_table())
    (tmp_path / "develop.cu").write_text(
        "constexpr int64_t kQuantizerBytes = sizeof(uint2) * kQuantizer;\n")
    pairs = kernel_ab.quantizer_for(tmp_path, "cpu").numpy()
    next_thr, base = D.srgb_quantizer()
    assert pairs.dtype == np.int32 and pairs.shape == (D.SRGB_ENTRIES, 2)
    assert np.array_equal(pairs[:, 0].view(np.float32), next_thr)
    assert np.array_equal(pairs[:, 1], base)
