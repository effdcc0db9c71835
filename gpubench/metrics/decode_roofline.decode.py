"""The decode step's bytes (payload, bits and refs in, the plane out) at the
card's published bandwidth over the device time of every kernel and memset
the trace gives the step: the device prep and the unpack, in % (layer:
kernels: offsets + unpack; the decode cells)."""

from gpubench.reduce import roofline_pct


def read(run):
    return roofline_pct(run, "decode")
