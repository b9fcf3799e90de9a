"""Device milliseconds a trained view of every kernel but K1's and K2's:
the plain stages and their autograd, ``ops.losses`` and Adam, merged over
the traced stretch and divided by its views. Should move
``train_views_per_s``."""

KERNELS = ("raster_fwd_kernel", "tile_order_kernel", "raster_bwd_kernel")


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    t = ctx["trace"].kernel_time(
        lambda n: not any(p in n for p in KERNELS))
    return t * 1e3 / ctx["units"] if t > 0 else None
