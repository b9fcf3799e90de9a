"""S1's share of its roofline in 2D Gaussian Splatting training steps
(%): the least time the traced views' surfel frames need on one H100
(``counts.gs2d.s1_work``: 77 operations a composited (pair, pixel)
against the live pairs' geometry and the contributing pairs' rgb and
normal read, 12 floats a pixel written) over S1's device time in the trace
(``ops.raster_surfel`` -> ``raster_surfel.cu::surfel_fwd_kernel``).
``bound`` says which binds. Should move ``train_views_per_s``."""

from benchmark import counts
from benchmark.counts import gs2d

S1 = ("surfel_fwd_kernel",)


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"] \
            or "surfel_units" not in ctx["counts"]:
        return None
    t = ctx["trace"].kernel_time(lambda n: any(p in n for p in S1))
    if t <= 0:
        return None  # S1 is not on the path
    sol, bound = counts.sol(*gs2d.s1_work(ctx["counts"]))
    return {"value": 100.0 * sol / t, "bound": bound}
