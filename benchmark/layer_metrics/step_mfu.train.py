"""The whole training step's share of the H100's peak (%), per view: the
least time the traced views' steps need (``counts.step_work``: the
frame, the loss, the backward compositing and per-gaussian stages, Adam
over every parameter) over the same views' time in the run's untraced
window. Should move ``train_views_per_s``."""

from benchmark import counts


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    sol, bound = counts.sol(*counts.step_work(ctx["counts"]))
    return {"value": 100.0 * sol / (ctx["units"] * ctx["unit_s"]),
            "bound": bound}
