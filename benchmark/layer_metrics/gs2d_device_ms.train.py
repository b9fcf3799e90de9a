"""Device milliseconds a trained view of the program's three surfel
spans: ``gs.s1`` (S1, the surfel frame), ``gs.geo_loss`` (the expected
depth's normals and the distortion and normal terms, with their autograd
kernels where autograd's thread credits them to it) and ``gs.s2`` (S2),
divided by the views. Layer: the plain stages. Should move
``train_views_per_s``."""

from benchmark import spans

SPANS = ("gs.s1", "gs.geo_loss", "gs.s2")
KEYS = ("s1_ms", "geo_loss_ms", "s2_ms")  # each span's own share


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    got = [spans.device_s(ctx["trace"], name) for name in SPANS]
    if any(t is None for t in got):
        return None
    return {"value": sum(got) * 1e3 / ctx["units"],
            **{key: t * 1e3 / ctx["units"] for key, t in zip(KEYS, got)}}
