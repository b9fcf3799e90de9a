"""Device milliseconds a trained view of the program's ``gs.pair_grads``
span (``ops.rasterize``: the backward's keys of the composited blocks
and the keyed reduction of K2's pair gradients to the gaussians),
divided by the views. Layer: the plain stages. Should move
``train_views_per_s``."""

from benchmark import spans

SPAN = "gs.pair_grads"


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    t = spans.device_s(ctx["trace"], SPAN)
    return None if t is None else t * 1e3 / ctx["units"]
