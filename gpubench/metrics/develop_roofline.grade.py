"""The develop's bytes (the uint16 plane in, the uint32 RGBA out) at the
card's published bandwidth over the develop kernel's device time, in %
(layer: kernels: develop; the grade cells)."""

from gpubench.reduce import roofline_pct


def read(run):
    return roofline_pct(run, "develop")
