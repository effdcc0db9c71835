"""The host's time to take one tick's develop rows and CFAs out of the
shot's, which set-up made from every frame's clip and frame metadata (the
program's ``frame_develop_rows``), by the host clock, mean over the
window's steps, in ms (layer: host: frame metadata -> develop rows; the
multiview cells)."""

from gpubench.reduce import span_ms


def read(run):
    return span_ms(run, "params")
