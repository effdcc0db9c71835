# A copy of mcraw/util.py, kept in the port so that mcraw_torch imports nothing of
# mcraw; tests/test_torch_standalone.py holds the two equal.
"""Small shared helpers with no heavy imports."""

from __future__ import annotations

import os


def outpath(outdir: str, name: str) -> str:
    """Output path as the reference example prints it: the bare filename
    when writing to the cwd (example.cpp:190 snprintf's "frame_%06d.dng"
    with no directory), joined otherwise. Keeps stdout byte-identical to
    the C++ example under the reference-style invocation."""
    return name if outdir in (".", "") else os.path.join(outdir, name)
