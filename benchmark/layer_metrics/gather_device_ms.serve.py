"""Device milliseconds a served frame of the program's ``gs.gather`` span
(``ops.rasterize``: the per-gaussian features in depth order and their
gather to the sorted pair list that K1 reads), divided by the frames.
Layer: the plain stages. Should move ``frames_per_s``."""

from benchmark import spans

SPAN = "gs.gather"


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["units"]:
        return None
    t = spans.device_s(ctx["trace"], SPAN)
    return None if t is None else t * 1e3 / ctx["units"]
