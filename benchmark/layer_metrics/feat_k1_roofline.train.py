"""F1's share of its roofline in Feature 3DGS training steps (%): the
least time the traced views' feature maps need on one H100
(``counts.feat3dgs.f1_work`` of the reference's counts: 2 C operations
per composited (pair, pixel) against the contributing pairs' features
read and the map written) over F1's device time in the trace
(``ops.raster_feat`` -> ``raster_feat.cu::feat_fwd_kernel``). ``bound``
says which binds. Should move ``train_views_per_s``."""

from benchmark import counts
from benchmark.counts import feat3dgs

F1 = ("feat_fwd_kernel",)


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"] \
            or "channels" not in ctx["counts"]:
        return None
    t = ctx["trace"].kernel_time(lambda n: any(p in n for p in F1))
    if t <= 0:
        return None  # F1 is not on the path
    sol, bound = counts.sol(*feat3dgs.f1_work(ctx["counts"], ctx["units"]))
    return {"value": 100.0 * sol / t, "bound": bound}
