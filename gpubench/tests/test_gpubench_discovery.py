"""The manifest's cells, configurations, traffic mixes and metrics are
found by name, as files of their own."""

from __future__ import annotations

import json
import re

import pytest
from conftest import ROOT, WORKLOADS

from gpubench import reduce, spec

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_manifest_names_its_cells_in_order():
    assert [w["name"] for w in MANIFEST["workloads"]] == list(WORKLOADS)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_loads_its_files(workload):
    cell = spec.load(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert (spec.HERE / f"{cell.traffic['mode']}.py").is_file()
    assert cell.traffic["rate_metric"] in {m["name"] for m in cell.end_to_end}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    moved = {m["name"] for m in cell.end_to_end}
    assert all(m["moves"] in moved for m in cell.per_layer)


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.load("no-such-cell")


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_each_metric_has_a_reader_that_reads_nothing_from_nothing(metric):
    read = spec.reader(metric)
    assert read(reduce.Record("cpu", {})) is None


def test_configuration_files_hold_their_names_and_sources():
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["file"].startswith("gpubench/configs/")


def test_names_and_units_keep_the_contract():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MANIFEST[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    assert all(0.01 <= m["bound"] <= 0.25 for m in MANIFEST["end_to_end"])
    for m in MANIFEST["per_layer"]:
        assert all(w in WORKLOADS for w in m["workloads"])
