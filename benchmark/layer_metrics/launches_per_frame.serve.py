"""Kernel launches a served frame: the kernel records of the traced
stretch over its frames. Layer: the host path (``viewer.make_render_fn``
-> ``render.render_from_params``), whose enqueue of each launch sets the
pace where the device waits. Should move ``frames_per_s``."""


def read(ctx):
    n = len(ctx["trace"].kernels)
    if ctx["kind"] != "serve" or not ctx["units"] or not n:
        return None
    return n / ctx["units"]
