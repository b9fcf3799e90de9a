"""Device milliseconds a trained Feature 3DGS view of every kernel but K1,
K2, F1 and F2: the plain stages and their autograd, ``ops.losses`` with
the feature term's resize, decoder and L1, the keyed reduction and Adam,
merged over the traced stretch and divided by its views
(``stages_device_ms.train`` with F1 and F2 left out too). Should move
``train_views_per_s``."""

KERNELS = ("raster_fwd_kernel", "tile_order_kernel", "raster_bwd_kernel",
           "feat_fwd_kernel", "feat_bwd_kernel")


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    trace = ctx["trace"]
    if trace.kernel_time(lambda n: "feat_fwd_kernel" in n) <= 0:
        return None  # no feature map on the path
    t = trace.kernel_time(lambda n: not any(p in n for p in KERNELS))
    return t * 1e3 / ctx["units"] if t > 0 else None
