"""Share of the traced serving stretch in which no kernel, copy or fill
ran on the device (%). Should move ``frames_per_s``: a host-bound frame
leaves the device idle."""

from benchmark import stats


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "serve" or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * stats.idle_share(tr.busy_s, tr.window_s)
