"""Share of the traced training stretch in which no kernel, copy or fill
ran on the device (%). Should move ``train_views_per_s``."""

from benchmark import stats


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "train" or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * stats.idle_share(tr.busy_s, tr.window_s)
