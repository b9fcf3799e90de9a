"""Device milliseconds a served frame of every kernel but K1's: the plain
stages (``ops.gaussian``, ``ops.sh``, ``ops.projection``,
``ops.binning``, the gather of ``ops.rasterize``), merged over the traced
stretch and divided by its frames. Should move ``frames_per_s``."""

K1 = ("raster_fwd_kernel", "tile_order_kernel")


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["units"]:
        return None
    t = ctx["trace"].kernel_time(lambda n: not any(p in n for p in K1))
    return t * 1e3 / ctx["units"] if t > 0 else None
