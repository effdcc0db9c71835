"""Nothing the benchmark runs loads JAX or the JAX package, compared by
the whole top-level name of each module (``mcraw_torch`` is the program,
not ``mcraw``); the reference loads nothing of the program either."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ["jax", "jaxlib", "flax", "mcraw"]

ALL = """
import json, pkgutil, sys, importlib
import gpubench
from gpubench import spec
for m in pkgutil.walk_packages(gpubench.__path__, "gpubench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
for p in sorted((spec.HERE / "metrics").glob("*.py")):
    spec.reader(p.stem)
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""

REF = """
import json, sys
import gpubench.ref.codec, gpubench.ref.develop, gpubench.check
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def top_level_names(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    names = top_level_names(ALL)
    assert "gpubench" in names and "torch" in names
    assert names.isdisjoint(FORBIDDEN), names & set(FORBIDDEN)


def test_the_reference_and_the_check_load_nothing_of_the_program():
    names = top_level_names(REF)
    assert names.isdisjoint(FORBIDDEN + ["mcraw_torch"]), names
