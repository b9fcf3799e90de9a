"""D1's share of its roofline in Scaffold-GS training steps (%): the least
time the traced views' decodes need on one H100
(``counts.scaffold.d1_work``: 13,760 operations a visible anchor and the
activations, against the anchor's 71 floats read, its slots' 14 floats
and mask written and the weights read once) over D1's device time in the
trace (``ops.scaffold`` -> ``scaffold.cu::scaffold_d1_kernel``).
``bound`` says which binds. Should move ``train_views_per_s``."""

from benchmark import counts
from benchmark.counts import scaffold

D1 = ("scaffold_d1_kernel",)


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"] \
            or "scaffold_units" not in ctx["counts"]:
        return None
    t = ctx["trace"].kernel_time(lambda n: any(p in n for p in D1))
    if t <= 0:
        return None  # D1 is not on the path
    sol, bound = counts.sol(*scaffold.d1_work(ctx["counts"]))
    return {"value": 100.0 * sol / t, "bound": bound}
