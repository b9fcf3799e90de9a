"""The whole 2D Gaussian Splatting training step's share of the H100's
peak (%), per view: the least time the traced views' steps need
(``counts.gs2d.step_work_2d``: the surfel transform and SH colour forward
and backward, S1, S2, the photometric and geometric loss terms, Adam over
58 floats a slot) over the same views' time in the run's untraced window.
Should move ``train_views_per_s``."""

from benchmark import counts
from benchmark.counts import gs2d


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"] \
            or "surfel_units" not in ctx["counts"]:
        return None
    sol, bound = counts.sol(*gs2d.step_work_2d(ctx["counts"]))
    return {"value": 100.0 * sol / (ctx["units"] * ctx["unit_s"]),
            "bound": bound}
