"""S2's share of its roofline in 2D Gaussian Splatting training steps
(%): the least time the traced views' surfel backward needs on one H100
(``counts.gs2d.s2_work``: 163 operations a composited (pair, pixel)
against the live pairs' geometry and the contributing pairs' rgb and
normal read and 18 gradients written, S1's planes and their cotangents
read) over S2's device time in the trace
(``ops.raster_surfel`` -> ``raster_surfel.cu::surfel_bwd_kernel``).
``bound`` says which binds. Should move ``train_views_per_s``."""

from benchmark import counts
from benchmark.counts import gs2d

S2 = ("surfel_bwd_kernel",)


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"] \
            or "surfel_units" not in ctx["counts"]:
        return None
    t = ctx["trace"].kernel_time(lambda n: any(p in n for p in S2))
    if t <= 0:
        return None  # S2 is not on the path
    sol, bound = counts.sol(*gs2d.s2_work(ctx["counts"]))
    return {"value": 100.0 * sol / t, "bound": bound}
