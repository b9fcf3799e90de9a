"""The whole served frame's share of the H100's peak (%): the least time
the traced frames need (``counts.frame_work``: every parameter read
once, the image written once, the per-gaussian stages over the gaussians
in view and 26 operations per composited (pair, pixel), at 67 TFLOP/s
f32 or 3.35 TB/s, whichever is longer) over the same frames' time in the
run's untraced window. It bounds every kernel's share: a change that
takes a kernel off the path still shows here. Should move
``frames_per_s``."""

from benchmark import counts


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["units"]:
        return None
    sol, bound = counts.sol(*counts.frame_work(ctx["counts"]))
    return {"value": 100.0 * sol / (ctx["units"] * ctx["unit_s"]),
            "bound": bound}
