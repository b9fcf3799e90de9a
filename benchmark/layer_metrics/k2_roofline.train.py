"""K2's share of its roofline in training steps (%): the least time the
traced views' backward compositing needs on one H100 (``counts.k2_work``
of the reference's counts: 79 operations per composited (pair, pixel)
against the features, planes and gradients read and written) over K2's
device time in the trace (``ops.raster_cuda`` -> ``raster_bwd.cu``,
compact mode included). ``bound`` says which binds. Should move
``train_views_per_s``."""

from benchmark import counts

K2 = ("raster_bwd_kernel",)


def read(ctx):
    if ctx["kind"] != "train":
        return None
    t = ctx["trace"].kernel_time(lambda n: any(p in n for p in K2))
    if t <= 0:
        return None  # K2 is not on the path
    sol, bound = counts.sol(*counts.k2_work(ctx["counts"]))
    return {"value": 100.0 * sol / t, "bound": bound}
