"""Device milliseconds a served frame of the program's ``gs.bin`` span
(``ops.binning.bin_gaussians``: footprints, the expansion into (gaussian,
tile) pairs, the sort, the alignment to blocks), merged over each frame
and divided by the frames. Layer: the plain stages. Should move
``frames_per_s``."""

from benchmark import spans

SPAN = "gs.bin"


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["units"]:
        return None
    t = spans.device_s(ctx["trace"], SPAN)
    return None if t is None else t * 1e3 / ctx["units"]
