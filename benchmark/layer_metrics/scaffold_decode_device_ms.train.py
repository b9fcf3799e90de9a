"""Device milliseconds a trained view of the program's two decode spans:
``gs.decode`` (the anchor cull and D1, the neural gaussians) and
``gs.decode_bwd`` (D2, into the anchors and the MLPs, on autograd's
thread inside ``gs.backward``), divided by the views, with each one's own
share. Layer: the plain stages. Should move ``train_views_per_s``."""

from benchmark import spans

SPANS = ("gs.decode", "gs.decode_bwd")
KEYS = ("decode_ms", "decode_bwd_ms")  # each span's own share


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    got = [spans.device_s(ctx["trace"], name) for name in SPANS]
    if any(t is None for t in got):
        return None
    return {"value": sum(got) * 1e3 / ctx["units"],
            **{key: t * 1e3 / ctx["units"] for key, t in zip(KEYS, got)}}
