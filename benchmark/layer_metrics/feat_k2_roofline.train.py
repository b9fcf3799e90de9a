"""F2's share of its roofline in Feature 3DGS training steps (%): the
least time the traced views' feature backward needs on one H100
(``counts.feat3dgs.f2_work``: 4 C operations per composited (pair,
pixel) against the contributing pairs' features read and gradients
written, the map and its cotangent read) over F2's device time in the
trace (``raster_feat.cu::feat_bwd_kernel``). ``bound`` says which binds.
Should move ``train_views_per_s``."""

from benchmark import counts
from benchmark.counts import feat3dgs

F2 = ("feat_bwd_kernel",)


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"] \
            or "channels" not in ctx["counts"]:
        return None
    t = ctx["trace"].kernel_time(lambda n: any(p in n for p in F2))
    if t <= 0:
        return None  # F2 is not on the path
    sol, bound = counts.sol(*feat3dgs.f2_work(ctx["counts"], ctx["units"]))
    return {"value": 100.0 * sol / t, "bound": bound}
