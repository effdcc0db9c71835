"""The rooflines' byte counts from shapes, and the reduction of a trace to
busy time, idle gaps and each step's device time."""

from __future__ import annotations

import pytest

from gpubench import reduce, roofline, trace


@pytest.mark.parametrize("width, height, modern, legacy", [
    (4096, 3072, 196_608, 786_432),
    (3840, 2160, 129_600, 518_400),  # the configurations' UHD raster
])
def test_block_counts_of_a_4k_frame(width, height, modern, legacy):
    assert roofline.modern_blocks(width, height) == modern
    assert roofline.legacy_blocks(width, height) == legacy


def test_decode_and_develop_bytes_from_shapes():
    plane = 2 * 4096 * 3072
    assert roofline.decode_bytes("modern", 15_053_672, 4096, 3072) == \
        15_053_672 + 196_608 * 4 + plane
    assert roofline.decode_bytes("legacy", 10_000_000, 4096, 3072) == \
        10_000_000 + 786_432 * 14 + plane
    assert roofline.develop_bytes(4096, 3072) == 6 * 4096 * 3072
    with pytest.raises(ValueError):
        roofline.decode_bytes("jpeg", 1, 1, 1)


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def synthetic():
    """A window of 100 us from ts 1000: a memset and the prep, the unpack,
    a gap, the checksum's memset and kernel, each inside its span's mirror
    on the card; then a develop kernel known only by its name, and a
    memset with no kernel after it."""
    t0_ns = 5_000_000
    offset = 1000 * 1000 - t0_ns  # trace ns - host ns

    def host(ts_us):
        return int(ts_us * 1000 - offset)

    events = [
        ev("user_annotation", trace.WINDOW, 1000, 100),
        ev("gpu_memset", "Memset (Device)", 1010, 2, correlation=1, stream=7),
        ev("kernel", "void (anonymous namespace)::block_offsets_kernel<1>(int)", 1012, 8,
           correlation=2, stream=7),
        ev("kernel", "void unpack_modern_kernel<true>(int const*)", 1020, 20, correlation=3,
           stream=7),
        ev("gpu_memset", "Memset (Device)", 1060, 5, stream=7),
        ev("kernel", "checksum_kernel<unsigned short>", 1065, 10, stream=7),
        ev("kernel", "develop_kernel<3>", 1080, 5, stream=7),
        ev("gpu_memset", "Memset (Device)", 1090, 1, stream=7),
        ev("gpu_user_annotation", "gb.offsets", 1009, 11.5),
        ev("gpu_user_annotation", "gb.decode", 1020, 20),
        ev("gpu_user_annotation", "gb.checksum", 1059, 17),
    ]
    spans = [("offsets", host(1000.5), host(1003)), ("decode", host(1003.5), host(1006)),
             ("checksum", host(1040), host(1042))]
    return events, spans, t0_ns


def test_summary_of_a_synthetic_trace():
    events, spans, t0_ns = synthetic()
    s = trace.summarize(events, spans, t0_ns)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((40 - 10 + 75 - 60 + 5 + 1) * 1e-6)
    assert s.device_ops["unpack_modern_kernel"] == pytest.approx(20e-6)
    assert s.device_ops["block_offsets_kernel"] == pytest.approx(8e-6)
    # by the mirrors: the memset and the prep to "offsets", the unpack to
    # "decode", the checksum's memset and kernel; by name: the develop.
    assert s.step_s["offsets"] == pytest.approx(10e-6)
    assert s.step_s["decode"] == pytest.approx(20e-6)
    assert s.step_s["checksum"] == pytest.approx(15e-6)
    assert s.step_s["develop"] == pytest.approx(5e-6)
    assert s.step_s["other"] == pytest.approx(1e-6)
    assert s.attributed == {"annotation": 5, "name": 1, "none": 1}
    gaps = [(name, round(sec * 1e6)) for name, sec in s.idle_gaps]
    assert gaps == [("checksum", 20), ("host", 10), ("host", 9), ("host", 5), ("host", 5)]


def test_roofline_and_idle_from_a_record():
    events, spans, t0_ns = synthetic()
    s = trace.summarize(events, spans, t0_ns)
    rec = reduce.Record("NVIDIA H100 80GB HBM3", {"enqueue": (0.5, 1000)}, s,
                        {"decode": 67_000_000})
    want = 100 * 67_000_000 / 3.35e12 / 30e-6
    assert reduce.roofline_pct(rec, "decode") == pytest.approx(want)
    assert reduce.roofline_pct(rec, "develop") is None
    assert reduce.idle_pct(rec) == pytest.approx(49.0)
    assert reduce.span_ms(rec, "enqueue") == pytest.approx(0.5)
    assert reduce.roofline_pct(reduce.Record("other card", {}, s, {"decode": 1}), "decode") is None


def test_kernel_names_lose_signature_and_namespaces():
    assert trace.kernel_name("void (anonymous namespace)::develop_kernel<3>(float*)") == \
        "develop_kernel"
    assert trace.kernel_name("at::native::vectorized_elementwise_kernel<4, F>(int)") == \
        "vectorized_elementwise_kernel"
