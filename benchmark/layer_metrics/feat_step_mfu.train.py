"""The whole Feature 3DGS training step's share of the H100's peak (%),
per view: the least time the traced views' steps need
(``counts.feat3dgs.step_work_feat``: 3DGS's step, the feature map and its
backward, the decoder forward and backward, Adam over 187 floats a slot
and the decoder) over the same views' time in the run's untraced window.
Should move ``train_views_per_s``."""

from benchmark import counts
from benchmark.counts import feat3dgs


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"] \
            or "channels" not in ctx["counts"]:
        return None
    sol, bound = counts.sol(*feat3dgs.step_work_feat(ctx["counts"],
                                                     ctx["units"]))
    return {"value": 100.0 * sol / (ctx["units"] * ctx["unit_s"]),
            "bound": bound}
