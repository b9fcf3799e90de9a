"""Kernel launches a trained view: the kernel records of the traced
stretch over its views (batch 1: one view a step). Layer: the host path
(``train.trainer.make_train_step`` -> ``render.render_from_params``, the
loss, autograd and Adam). Should move ``train_views_per_s``."""


def read(ctx):
    n = len(ctx["trace"].kernels)
    if ctx["kind"] != "train" or not ctx["units"] or not n:
        return None
    return n / ctx["units"]
