"""Port parity: quality evaluation (``gsplat_tpu_torch/evaluation.py``).

The same seeded numpy scene and views go through the JAX package's
``evaluate_views`` and the port's, on the CPU.

What is held, and how closely:

* ``psnr`` against JAX's on random images: within 1e-4 dB;
* ``evaluate_views`` against JAX's on the same params and views, with
  ``backend="xla"`` in both (the JAX package's own choice off a TPU) and
  with the port's default compositor against JAX's Pallas kernel in
  interpret mode: per-view PSNR within 1e-3 dB, SSIM and L1 within 1e-5,
  the demand and the capacity used equal, the keys JAX's;
* the twin of tests/test_viewer_utils.py::
  test_evaluate_views_render_batch_matches_per_view on the port:
  ``render_batch=2`` against per-view (PSNR 1e-3 dB, L1 1e-6), a starved
  ``max_pairs`` grown by ``auto_size`` to reproduce the sized metrics, and
  the starved ``auto_size=False`` case differing;
* ``mesh=`` raising.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu import evaluation as jeval
from gsplat_tpu_torch import evaluation as teval

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)


def _scene_and_views(n=48, seed=5):
    """tests/test_viewer_utils.py's evaluation scene and 3 views, as numpy."""
    rng = np.random.default_rng(seed)
    params = {
        "pos": np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                         rng.uniform(2, 5, n)], axis=-1).astype(np.float32),
        "scale_raw": (rng.normal(0, 0.3, (n, 3)) - 1.8).astype(np.float32),
        "q_raw": (rng.normal(0, 1, (n, 4))
                  + np.array([0, 0, 0, 2.0])).astype(np.float32),
        "opacity_raw": rng.normal(0.5, 1, n).astype(np.float32),
        "f_dc": rng.normal(0, 0.8, (n, 3)).astype(np.float32),
        "f_rest": rng.normal(0, 0.05, (n, 45)).astype(np.float32),
    }
    views = []
    for i in range(3):  # 3 views, batch 2 -> padded last chunk
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = 0.2 * i - 0.2
        views.append({
            "image": rng.uniform(0, 1, (32, 48, 3)).astype(np.float32),
            "c2w": c2w, "fx": 40.0, "fy": 40.0, "cx": 24.0, "cy": 16.0,
        })
    return params, views


CFG = dict(height=32, width=48, max_pairs=1024, max_per_tile=64)


def test_psnr_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (16, 24, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    got = float(teval.psnr(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jeval.psnr(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= 1e-4
    z = torch.zeros(8, 8, 3)
    assert float(teval.psnr(z, z)) > 100.0  # JAX's test_psnr
    assert float(teval.psnr(z + 0.1, z)) == pytest.approx(20.0, abs=1e-3)


@pytest.mark.parametrize("backend,jbackend", [("xla", "xla"),
                                              ("auto", "pallas")])
def test_evaluate_views_matches_jax(backend, jbackend):
    params, views = _scene_and_views()
    rj = jeval.evaluate_views({k: jnp.asarray(v) for k, v in params.items()},
                              views, gj.RenderConfig(**CFG,
                                                     backend=jbackend))
    rt = teval.evaluate_views({k: torch.from_numpy(v)
                               for k, v in params.items()}, views,
                              gt.RenderConfig(**CFG, backend=backend))
    assert set(rt) == set(rj)
    assert rt["num_views"] == rj["num_views"] == 3
    assert rt["max_pair_demand"] == rj["max_pair_demand"]
    assert rt["eval_max_pairs"] == rj["eval_max_pairs"]
    for a, b in zip(rt["per_view"], rj["per_view"]):
        assert set(a) == set(b)
        assert a["psnr"] == pytest.approx(b["psnr"], abs=1e-3)
        assert a["ssim"] == pytest.approx(b["ssim"], abs=1e-5)
        assert a["l1"] == pytest.approx(b["l1"], abs=1e-5)
    for k in ("psnr", "ssim", "l1"):
        assert rt[k] == pytest.approx(float(np.mean(
            [v[k] for v in rt["per_view"]])), abs=1e-9)


def test_evaluate_views_render_batch_matches_per_view():
    """The twin of the JAX gate (tests/test_viewer_utils.py:288), on the
    port with backend="xla" as there."""
    params, views = _scene_and_views()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    cfg = gt.RenderConfig(**CFG, backend="xla")
    r1 = teval.evaluate_views(tp, views, cfg)
    r2 = teval.evaluate_views(tp, views, cfg, render_batch=2)
    assert r1["num_views"] == r2["num_views"] == 3
    for a, b in zip(r1["per_view"], r2["per_view"]):
        assert a["psnr"] == pytest.approx(b["psnr"], abs=1e-3)
        assert a["l1"] == pytest.approx(b["l1"], abs=1e-6)

    # A starved max_pairs is grown to reproduce the sized metrics.
    r3 = teval.evaluate_views(tp, views, cfg.with_(max_pairs=64))
    assert r3["max_pair_demand"] > 64
    assert r3["eval_max_pairs"] >= r3["max_pair_demand"]
    for a, b in zip(r1["per_view"], r3["per_view"]):
        assert a["psnr"] == pytest.approx(b["psnr"], abs=1e-3)
    r4 = teval.evaluate_views(tp, views, cfg.with_(max_pairs=64),
                              auto_size=False)
    assert r4["eval_max_pairs"] == 64 and r4["max_pair_demand"] == 0
    assert r4["per_view"][0]["psnr"] != pytest.approx(
        r1["per_view"][0]["psnr"], abs=1e-3
    ), "starved eval should differ when auto_size is off"


def test_evaluate_views_grows_trunc_pairs_and_takes_tensor_views():
    """With ``tile_rank_cap`` a starved ``trunc_pairs`` grows as JAX grows
    it; views given as tensors give the numpy views' figures."""
    params, views = _scene_and_views()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    kw = dict(CFG, pair_block=32, tile_rank_cap=32, trunc_pairs=32)
    rj = jeval.evaluate_views({k: jnp.asarray(v) for k, v in params.items()},
                              views, gj.RenderConfig(**kw, backend="xla"))
    rt = teval.evaluate_views(tp, views, gt.RenderConfig(**kw))
    tviews = [{k: torch.as_tensor(v) for k, v in view.items()}
              for view in views]
    rtt = teval.evaluate_views(tp, tviews, gt.RenderConfig(**kw),
                               render_batch=2)
    assert rt["eval_max_pairs"] == rj["eval_max_pairs"]
    for a, b, c in zip(rt["per_view"], rj["per_view"], rtt["per_view"]):
        assert a["psnr"] == pytest.approx(b["psnr"], abs=1e-3)
        assert a["psnr"] == pytest.approx(c["psnr"], abs=1e-3)


def test_evaluate_views_mesh_raises():
    """``mesh=`` is ported (test_torch_sharding.py holds a 4-rank grid to
    JAX's): on a one-rank grid the scores equal the unsharded ones, per
    view and through the sharded batch render."""
    from gsplat_tpu_torch.parallel import make_mesh

    params, views = _scene_and_views()
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "tile": 1}
    for rb in (1, 2):
        got = teval.evaluate_views(p, views, gt.RenderConfig(**CFG),
                                   render_batch=rb, mesh=mesh)
        want = teval.evaluate_views(p, views, gt.RenderConfig(**CFG),
                                    render_batch=rb)
        assert got == want
