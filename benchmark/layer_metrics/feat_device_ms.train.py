"""Device milliseconds a trained view of the program's three feature
spans: ``gs.feat_k1`` (F1, the feature map), ``gs.feat_loss`` (the
resize, the decoder and the feature L1, with their autograd kernels
where autograd's thread credits them to it) and ``gs.feat_k2`` (F2),
divided by the views. Layer: the plain stages. Should move
``train_views_per_s``."""

from benchmark import spans

SPANS = ("gs.feat_k1", "gs.feat_loss", "gs.feat_k2")
KEYS = ("f1_ms", "loss_ms", "f2_ms")  # each span's own share


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    got = [spans.device_s(ctx["trace"], name) for name in SPANS]
    if any(t is None for t in got):
        return None
    return {"value": sum(got) * 1e3 / ctx["units"],
            **{key: t * 1e3 / ctx["units"] for key, t in zip(KEYS, got)}}
