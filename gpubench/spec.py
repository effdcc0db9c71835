"""A cell of ``BENCHMARK.json``, found by name: its workload entry, its
configuration file, its traffic file and the metrics it reports.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own: ``configs/<config>.json`` (the
``file`` the manifest names), ``traffic/<traffic>.json`` and
``metrics/<metric>.py``. A later cell, mix or metric is added as files and
manifest entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclass(frozen=True)
class Cell:
    workload: dict  # the manifest's entry
    config: dict  # configs/<name>.json
    traffic: dict  # traffic/<name>.json
    end_to_end: tuple[dict, ...]  # the manifest's metrics this cell reports
    per_layer: tuple[dict, ...]

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, manifest: Path = MANIFEST) -> Cell:
    """The cell named `workload`, with the manifest's metrics that it
    reports; KeyError when the manifest has none."""
    m = json.loads(manifest.read_text())
    entries = {w["name"]: w for w in m["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in {manifest.name}: {sorted(entries)}")
    entry = entries[workload]
    configs = {c["name"]: c for c in m["configs"]}
    config = json.loads((ROOT / configs[entry["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    e2e = tuple(x for x in m["end_to_end"] if _reports(x, workload))
    moved = {x["name"] for x in e2e}
    # A per-layer metric without a workloads list belongs to every cell that
    # reports the end-to-end metric it moves.
    layer = tuple(x for x in m["per_layer"]
                  if ("workloads" in x and workload in x["workloads"])
                  or ("workloads" not in x and x["moves"] in moved))
    return Cell(entry, config, traffic, e2e, layer)


def reader(metric: str):
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
