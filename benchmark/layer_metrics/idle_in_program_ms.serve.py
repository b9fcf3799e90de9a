"""Device idle milliseconds a served frame inside the program's
``gs.frame`` span: the device waiting on the program's host path (its
launches and Python between them), not on the harness. Layer: the host
path. Should move ``frames_per_s``."""

from benchmark import spans

SPAN = "gs.frame"


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["units"]:
        return None
    t = spans.idle_s(ctx["trace"], SPAN)
    return None if t is None else t * 1e3 / ctx["units"]
