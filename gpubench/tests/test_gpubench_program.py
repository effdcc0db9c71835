"""The numbers read from the program's own spans (``gpubench.program``):
per step from a fixture record, nothing from nothing, the trace's
summary untouched by the program's annotations, the idle gaps named by
the program's innermost span; and one small cell measured on the CPU."""

from __future__ import annotations

import pytest
from conftest import small_cell
from test_gpubench_roofline import ev, synthetic

from gpubench import program, trace


def row(name, start_us, end_us, id, parent=None, thread=1):
    return (name, int(start_us * 1000), int(end_us * 1000), thread, id, parent)


def two_steps():
    """Two grade steps of the program (us): each the offsets, the unpack,
    the develop's parameters and kernel, the checksum, each wrapper around
    its launch; a collection inside the second step's develop."""
    rows, i = [], 0
    for t in (0, 100):
        for name, a, b, entry in (("offsets", 0, 10, "mcraw_block_offsets_batch"),
                                  ("unpack.modern", 10, 30, "mcraw_unpack_modern_batch"),
                                  ("develop", 35, 60, "mcraw_develop"),
                                  ("checksum", 60, 70, "mcraw_checksum")):
            i += 1
            rows.append(row(name, t + a, t + b, i))
            rows.append(row("launch." + entry, t + a + 2, t + a + 5, i + 100, i))
        i += 1
        rows.append(row("develop.params", t + 30, t + 35, i))
    rows.append(row("gc", 140, 144, 99, 8))  # the second develop's id is 8
    return rows


def summary(rows) -> dict:
    """The spans of the program's summary of a record of `rows`."""
    from mcraw_torch import observe

    record = observe.Trace()
    record.rows = [observe.Row(*r) for r in rows]
    return record.summary()["spans"]


def test_per_step_readings_of_a_record():
    window = summary(two_steps())
    staging = summary([row("stage.scan", 0, 3e6, 1), row("stage.layout", 3e6, 4e6, 2),
                       row("stage.h2d", 4e6, 4.5e6, 3), row("stage.scan", 5e6, 6e6, 4)])
    got = program.readings(window, staging)
    assert program.steps(window) == 2
    assert got["launch_ms"] == pytest.approx(4 * 3e-3)  # four launches of 3 us a step
    # wrappers 10 + 20 + 25 + 10 + params 5 = 70 us a step, less 12 us of
    # launches, less the second step's 4 us collection
    assert got["wrap_ms"] == pytest.approx((2 * 58 - 4) / 2 * 1e-3)
    assert got["gc_ms"] == pytest.approx(2e-3)
    assert got["stage_scan_s"] == pytest.approx(5.0)
    assert got["stage_h2d_s"] == pytest.approx(0.5)
    assert program.gc_ms(summary(r for r in two_steps() if r[0] != "gc")) == 0.0


def test_nothing_is_read_from_nothing():
    assert program.readings({}, {}) == dict.fromkeys(program.READINGS)
    assert program.coverage([], []) is None


def test_coverage_of_the_harness_spans():
    harness = [("offsets", 0, 10_000), ("decode", 10_000, 40_000), ("enqueue", 0, 10**9)]
    rows = [row("offsets", 1, 9, 1), row("unpack.modern", 10, 30, 2),
            row("launch.x", 12, 14, 3, 2)]
    assert program.coverage(harness, rows) == pytest.approx((8 + 20) / 40)
    assert program.coverage(harness, rows, ("decode",)) == pytest.approx(20 / 30)
    straddle = [row("gc", 8, 12, 1), row("offsets", 0.5, 1, 2), row("checksum", 39, 45, 3)]
    assert program.coverage(harness, straddle) == pytest.approx((0.5 + 2 + 2 + 1) / 40)


def with_program_spans():
    """The synthetic trace with the program's events (operator events, as
    the program's annotations are) inside the harness's spans, and the rows
    behind them, whose host times sit 0.3 us late on the trace's clock (the
    error of the window's shift); one collection, a row alone."""
    events, spans, t0_ns = synthetic()
    offset = 1000 * 1000 - t0_ns

    def host(ts_us):
        return int((ts_us + 0.3) * 1000 - offset)

    extra = [ev("cpu_op", "mcraw.offsets", 1000.6, 2),
             ev("cpu_op", "mcraw.checksum", 1040, 1.9),
             ev("cpu_op", "mcraw.launch.mcraw_checksum", 1040, 1.8)]
    rows = [("offsets", host(1000.6), host(1002.6), 1, 1, None),
            ("checksum", host(1040), host(1041.9), 1, 2, None),
            ("launch.mcraw_checksum", host(1040), host(1041.8), 1, 3, 2),
            ("gc", host(1074.5), host(1075.5), 1, 4, None)]
    return events, extra, spans, rows, t0_ns


def test_the_programs_annotations_leave_the_summary_as_it_was():
    events, extra, spans, rows, t0_ns = with_program_spans()
    plain = trace.summarize(events, spans, t0_ns)
    both = trace.summarize(events + extra, spans, t0_ns)
    assert both == plain
    assert both.step_s["checksum"] == pytest.approx(15e-6)


def test_idle_gaps_are_named_by_the_programs_innermost_span():
    events, extra, spans, rows, t0_ns = with_program_spans()
    gaps = [(name, round(sec * 1e6)) for name, sec in
            program.idle_gaps(events + extra, spans, rows, t0_ns)]
    # as trace.summarize finds them, with the launch's event open inside
    # the harness's checksum when the 20 us gap began (its row, shifted,
    # is not yet), and a collection open when the first 5 us gap began
    assert gaps == [("checksum/launch.mcraw_checksum", 20), ("host", 10), ("host", 9),
                    ("host/gc", 5), ("host", 5)]
    # a trace without the program's events: its rows name the gaps
    by_rows = program.idle_gaps(events, spans, rows, t0_ns)
    assert by_rows[0][0] == "checksum" and by_rows[3][0] == "host/gc"
    plain = trace.summarize(events, spans, t0_ns).idle_gaps
    assert [round(s * 1e6) for _, s in plain] == [s for _, s in gaps]


def test_a_small_cell_is_measured_on_the_cpu(monkeypatch, tmp_path):
    import torch

    from gpubench import run

    monkeypatch.setattr(run, "RUNS", tmp_path)
    cell = small_cell("modern-grade")
    out = program.measure(cell, 2**31 + 17, 0.2, torch.device("cpu"), workers=1)
    m = out["metrics"]
    assert set(m) == {"launch_ms.grade", "wrap_ms.grade", "gc_ms.grade", "stage_scan_s",
                      "stage_h2d_s"}
    assert m["launch_ms.grade"] == 0.0  # the CPU launches nothing
    assert m["wrap_ms.grade"] > 0 and m["gc_ms.grade"] >= 0
    assert m["stage_scan_s"] > 0 and m["stage_h2d_s"] > 0
    assert out["steps"] > 0 and 0 < out["coverage"] <= 1
    spans = out["program"]["window"]["spans"]
    assert spans["unpack.modern"]["count"] == spans["checksum"]["count"] == out["steps"]
    assert out["program"]["staging"]["counters"]["h2d_bytes"] > 0
    assert len(out["cost"]["windows"]["off"]) == len(out["cost"]["windows"]["on"]) == 2
    assert all(w["wrap_ms"] > 0 for w in out["cost"]["windows"]["on"])
    assert set(out["cost"]["traced"]) == {"off", "on"}
    assert (tmp_path / f"modern-grade.{2**31 + 17}.program.json").is_file()
