"""Device idle milliseconds a trained view inside the program's
``gs.step`` span (``train.trainer.make_train_step``'s step, batch 1):
the device waiting on the step's host path, not on the harness. Layer:
the host path. Should move ``train_views_per_s``."""

from benchmark import spans

SPAN = "gs.step"


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    t = spans.idle_s(ctx["trace"], SPAN)
    return None if t is None else t * 1e3 / ctx["units"]
