"""The share of the traced window, in %, in which the card ran no operation
(layer: device; the grade cells)."""

from gpubench.reduce import idle_pct


def read(run):
    return idle_pct(run)
