"""Host milliseconds a served frame spends inside the program's
``gs.frame`` span (the closure of ``viewer.make_render_fn``): the
enqueue of the frame's work, which the harness's wait for the device
then follows. Layer: the host path. Should move ``frames_per_s``."""

from benchmark import spans

SPAN = "gs.frame"


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["units"]:
        return None
    t = spans.host_s(ctx["trace"], SPAN)
    return None if t is None else t * 1e3 / ctx["units"]
