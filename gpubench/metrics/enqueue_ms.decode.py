"""The host's time to enqueue one step, before any wait, by the host clock,
mean over the window's steps, in ms (layer: host side of the launches; the
decode cells)."""

from gpubench.reduce import span_ms


def read(run):
    return span_ms(run, "enqueue")
