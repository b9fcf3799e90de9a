"""K1's share of its roofline in served frames (%): the least time the
traced frames' forward compositing needs on one H100 (``counts.k1_work``
of the reference's counts: 26 operations per composited (pair, pixel) at
67 TFLOP/s against the pairs' features read and the pixels' planes
written at 3.35 TB/s, whichever is longer) over K1's device time in the
trace (``ops.raster_cuda`` -> ``raster_fwd.cu``: the tile order and the
compositor). ``bound`` says which of the two binds. Should move
``frames_per_s``."""

from benchmark import counts

K1 = ("raster_fwd_kernel", "tile_order_kernel")


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    t = ctx["trace"].kernel_time(lambda n: any(p in n for p in K1))
    if t <= 0:
        return None  # K1 is not on the path
    sol, bound = counts.sol(*counts.k1_work(ctx["counts"]))
    return {"value": 100.0 * sol / t, "bound": bound}
