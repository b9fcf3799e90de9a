"""Device milliseconds a trained view of the program's ``gs.update`` span
(``train.trainer.apply_update``: the position clip, dead slots zeroed,
Adam and the NaN guard), divided by the views. Layer: the plain stages.
Should move ``train_views_per_s``."""

from benchmark import spans

SPAN = "gs.update"


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    t = spans.device_s(ctx["trace"], SPAN)
    return None if t is None else t * 1e3 / ctx["units"]
