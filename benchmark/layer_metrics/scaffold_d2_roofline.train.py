"""D2's share of its roofline in Scaffold-GS training steps (%): the least
time the traced views' decode backward needs on one H100
(``counts.scaffold.d2_work``: the input- and weight-gradient products,
2 x 13,760 operations a visible anchor, against the kept slots' 14
gradient floats read, the anchor's 71 floats read and 68 gradients
written, the weights read and their gradients written once) over D2's
device time in the trace (``ops.scaffold`` -> ``scaffold.cu``: its
partial sums and their reduction). ``bound`` says which binds. Should
move ``train_views_per_s``."""

from benchmark import counts
from benchmark.counts import scaffold

D2 = ("scaffold_d2_kernel", "scaffold_reduce_kernel")


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"] \
            or "scaffold_units" not in ctx["counts"]:
        return None
    t = ctx["trace"].kernel_time(lambda n: any(p in n for p in D2))
    if t <= 0:
        return None  # D2 is not on the path
    sol, bound = counts.sol(*scaffold.d2_work(ctx["counts"]))
    return {"value": 100.0 * sol / t, "bound": bound}
