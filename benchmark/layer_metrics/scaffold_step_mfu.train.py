"""The whole Scaffold-GS training step's share of the H100's peak (%), per
view: the least time the traced views' steps need
(``counts.scaffold.step_work_scaffold``: D1, D2, the neural gaussians'
covariance and projection forward and backward, K1, K2, the photometric
loss and the scaling term, Adam over the anchors and the MLPs) over the
same views' time in the run's untraced window. Should move
``train_views_per_s``."""

from benchmark import counts
from benchmark.counts import scaffold


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"] \
            or "scaffold_units" not in ctx["counts"]:
        return None
    sol, bound = counts.sol(*scaffold.step_work_scaffold(ctx["counts"]))
    return {"value": 100.0 * sol / (ctx["units"] * ctx["unit_s"]),
            "bound": bound}
