"""Port parity: the XLA compositor (``backend="xla"``) and the dense oracle.

``rasterize_binned_xla`` composites each tile's first ``max_per_tile``
pairs as a dense ``[C, K, P]`` cumulative product, ``tile_chunk`` tiles at
a time (the JAX package's ``lax.map`` + einsum path). The same seeded
numpy inputs go through the JAX package and through gsplat_tpu_torch on
the CPU.

What is held, and how closely:

* the compositor fed one projection (JAX's, as numpy) in both packages, at
  tiles 8, 16 and 32 with tiles above ``max_per_tile``: image and alpha
  within 2e-5 abs, depth within 2e-5 of its largest value, every aux field
  equal (``per_tile_capacity = max_per_tile``, no ``bwd_demand``);
* ``render_from_params`` end to end: gradients of all six leaves within
  5e-4 of each leaf's max against ``jax.grad`` (the kernel gate's bound,
  tests/test_pallas_kernel.py);
* ``render_batch_from_params`` (``view_tile_rows``) against per-view
  renders on the port, with the JAX twin's tolerances
  (tests/test_batched_render.py::test_batch_matches_per_view_xla), and
  against JAX's batch within 2e-5;
* the port's plain compositor with ``tile_rank_cap=K`` against the port's
  ``"xla"`` with ``max_per_tile=K`` (the JAX gate
  ``test_rank_truncation_matches_xla_per_tile_cap`` at a smaller scene):
  images within 2e-5, gradients within 5e-4;
* ``rasterize_dense`` against JAX's within 2e-5; the backend resolution and
  a train step whose render reports no backward demand.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_scene

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.ops import gaussian as jgau
from gsplat_tpu.ops import projection as jproj
from gsplat_tpu.ops import sh as jsh
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
from gsplat_tpu_torch.ops import rasterize as tras
from gsplat_tpu_torch.ops.projection import ProjectedGaussians
from test_batched_render import CFG as JBATCH_CFG
from test_batched_render import _pool, _views

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

jras = importlib.import_module("gsplat_tpu.ops.rasterize")
jtrainer = importlib.import_module("gsplat_tpu.train.trainer")

CAM = dict(fx=60.0, fy=58.0, cx=32.5, cy=31.5)
IMG_TOL = 2e-5
GRAD_TOL = 5e-4


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _np_params(scene):
    return {k: np.array(scene[k]) for k in PARAM_KEYS}


def _dense_scene(n, seed=11):
    """tests/test_pallas_kernel.py::_dense_scene's recipe (dim, overlapping
    splats whose tiles exceed a small rank cap) at n gaussians."""
    rng = np.random.default_rng(seed)
    return {
        "pos": np.stack([rng.uniform(-0.4, 0.4, n),
                         rng.uniform(-0.4, 0.4, n),
                         rng.uniform(3, 8, n)], -1).astype(np.float32),
        "scale_raw": (rng.normal(0, 0.3, (n, 3)) - 1.4).astype(np.float32),
        "q_raw": (rng.normal(0, 1, (n, 4))
                  + np.array([0, 0, 0, 2])).astype(np.float32),
        "opacity_raw": rng.normal(-1.5, 0.8, n).astype(np.float32),
        "f_dc": rng.normal(0, 0.8, (n, 3)).astype(np.float32),
        "f_rest": rng.normal(0, 0.05, (n, 45)).astype(np.float32),
    }


def _jax_projection(params, c2w, cfg):
    """JAX's projection and SH colours of a numpy scene, as numpy."""
    p = {k: jnp.asarray(v) for k, v in params.items()}
    c2w = jnp.asarray(c2w)
    cov = jgau.build_cov3d_packed(p["scale_raw"], p["q_raw"])
    colors = jsh.evaluate_sh(p["f_dc"], p["f_rest"], p["pos"], c2w)
    proj = jproj.project_gaussians(p["pos"], cov, p["opacity_raw"], c2w,
                                   CAM["fx"], CAM["fy"], CAM["cx"],
                                   CAM["cy"], cfg)
    return ({f: np.asarray(getattr(proj, f)) for f in proj._fields},
            np.asarray(colors))


def _to_torch_proj(proj):
    return ProjectedGaussians(**{f: torch.from_numpy(np.array(v))
                                 for f, v in proj.items()})


def _check_aux(aux_t, aux_j):
    for f in ("num_pairs", "max_tile_count", "num_rows", "num_pairs_kept",
              "trunc_demand", "screen_radius"):
        np.testing.assert_array_equal(np.asarray(getattr(aux_t, f)),
                                      np.asarray(getattr(aux_j, f)), err_msg=f)
    for f in ("pair_capacity", "per_tile_capacity", "row_capacity",
              "trunc_capacity", "bwd_capacity"):
        assert getattr(aux_t, f) == getattr(aux_j, f), f
    assert aux_t.bwd_demand is None and aux_j.bwd_demand is None


# --- the compositor on one projection, tiles 8 / 16 / 32 ---------------------

@pytest.mark.parametrize("tile,K,trunc", [(8, 16, 0), (16, 32, 0),
                                          (32, 64, 0), (16, 32, 64)])
def test_xla_compositor_matches_jax(tile, K, trunc):
    """Both packages' ``rasterize`` with ``backend="xla"`` on JAX's
    projection: tiles holding more than ``max_per_tile`` pairs composite
    only their first K in both (and, with ``tile_rank_cap``, on the
    truncated list)."""
    scene = make_scene(None, n=320, seed_offset=2)
    kw = dict(height=64, width=64, tile=tile, max_pairs=8192,
              max_per_tile=K, tile_chunk=3, backend="xla",
              tile_rank_cap=trunc, pair_block=32)
    aux_j, _ = _compare_xla(scene, kw)
    assert int(aux_j.max_tile_count) > K, "no tile exceeds max_per_tile"


def test_xla_compositor_short_and_empty_tiles_match_jax():
    """Tiles whose padded run is shorter than ``max_per_tile``, and empty
    tiles, whose ``tile_start`` points at the next tile's run: their slots
    past the tile's count stay masked."""
    scene = make_scene(None, n=24, seed_offset=5)
    kw = dict(height=64, width=96, max_pairs=8192, max_per_tile=256,
              tile_chunk=5, backend="xla", pair_block=32)
    _, proj_j = _compare_xla(scene, kw)
    counts = np.asarray(jax.jit(lambda pr: jras.bin_gaussians(
        pr, gj.RenderConfig(**kw)).tile_count)(proj_j))
    assert (counts == 0).any() and ((counts > 0) & (counts < 32)).any()


def _compare_xla(scene, kw):
    """``rasterize`` with ``kw`` in both packages on JAX's projection:
    image and alpha within 2e-5, depth within 2e-5 of its largest value,
    every aux field equal. Returns (JAX's aux, JAX's projection)."""
    jcfg = gj.RenderConfig(**kw)
    proj, colors = _jax_projection(_np_params(scene), scene["c2w"], jcfg)
    img_j, aux_j = jax.jit(lambda pr, col: jras.rasterize(pr, col, jcfg))(
        jproj.ProjectedGaussians(**{f: jnp.asarray(v)
                                    for f, v in proj.items()}),
        jnp.asarray(colors))
    img_t, aux_t = tras.rasterize(_to_torch_proj(proj),
                                  torch.from_numpy(np.array(colors)),
                                  gt.RenderConfig(**kw))
    assert float(np.asarray(img_j).max()) > 0.1
    assert np.abs(img_t.numpy() - np.asarray(img_j)).max() <= IMG_TOL
    assert np.abs(aux_t.alpha.numpy() - np.asarray(aux_j.alpha)).max() \
        <= IMG_TOL
    depth_j = np.asarray(aux_j.depth)
    assert np.abs(aux_t.depth.numpy() - depth_j).max() \
        <= IMG_TOL * max(1.0, float(np.abs(depth_j).max()))
    _check_aux(aux_t, aux_j)
    return aux_j, jproj.ProjectedGaussians(
        **{f: jnp.asarray(v) for f, v in proj.items()})


def test_xla_caps_a_tile_where_the_kernel_path_does_not():
    """The capped tiles are where the two compositors part: the XLA image
    differs from the plain (K1-semantics) compositor's at max_per_tile
    below the largest tile, and equals it (2e-5) at or above."""
    scene = make_scene(None, n=320, seed_offset=2)
    params = {k: torch.from_numpy(v) for k, v in _np_params(scene).items()}
    c2w = torch.from_numpy(scene["c2w"])
    base = gt.RenderConfig(height=64, width=64, max_pairs=8192,
                           pair_block=32)

    def render(cfg):
        with torch.no_grad():
            return gt.render_from_params(params, c2w, CAM["fx"], CAM["fy"],
                                         CAM["cx"], CAM["cy"], cfg)

    img_k, aux_k = render(base)
    big = int(aux_k.max_tile_count)
    img_x, aux_x = render(base.with_(backend="xla", max_per_tile=big))
    img_c, _ = render(base.with_(backend="xla", max_per_tile=big // 4))
    assert float((img_x - img_k).abs().max()) <= IMG_TOL
    assert float((aux_x.alpha - aux_k.alpha).abs().max()) <= IMG_TOL
    assert float((img_c - img_k).abs().max()) > 1e-3
    assert aux_x.per_tile_capacity == big
    assert aux_k.per_tile_capacity == base.padded_pairs


# --- gradients of all six leaves ---------------------------------------------

@pytest.mark.parametrize("tile", [8, 16])
def test_xla_gradients_match_jax(tile):
    """d(mean|img - tgt| + mean(img^2)) / d params through ``backend="xla"``
    with capped tiles, against ``jax.grad`` of the same loss: each leaf
    within 5e-4 of its max."""
    scene = make_scene(None, n=192, seed_offset=tile)
    params = _np_params(scene)
    kw = dict(height=48, width=64, tile=tile, max_pairs=8192,
              max_per_tile=24, tile_chunk=5, backend="xla")
    tgt = np.random.default_rng(2).uniform(0, 1, (48, 64, 3)).astype(
        np.float32)
    jcfg = gj.RenderConfig(**kw)

    def jloss(p):
        img, aux = gj.render_from_params(p, jnp.asarray(scene["c2w"]),
                                         CAM["fx"], CAM["fy"], CAM["cx"],
                                         CAM["cy"], jcfg)
        return jnp.mean(jnp.abs(img - tgt)) + jnp.mean(img * img), aux

    (_, aux_j), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    img, aux_t = gt.render_from_params(
        tp, torch.from_numpy(scene["c2w"]), CAM["fx"], CAM["fy"], CAM["cx"],
        CAM["cy"], gt.RenderConfig(**kw))
    loss = torch.mean(torch.abs(img - torch.from_numpy(tgt))) \
        + torch.mean(img * img)
    loss.backward()
    assert int(aux_t.max_tile_count) > kw["max_per_tile"]
    assert int(aux_t.num_pairs) == int(aux_j.num_pairs)
    for k in PARAM_KEYS:
        assert _rel(tp[k].grad.numpy(), np.asarray(g_j[k])) <= GRAD_TOL, k


# --- batched views: view_tile_rows --------------------------------------------

def test_xla_batch_matches_per_view():
    """The port's twin of test_batched_render.py::
    test_batch_matches_per_view_xla (same pool, views and config), and the
    batch against JAX's ``render_batch_from_params`` within 2e-5."""
    jpool = _pool()
    views = _views(b=3)
    cfg = gt.RenderConfig(**{f: getattr(JBATCH_CFG, f) for f in (
        "height", "width", "max_pairs", "max_per_tile", "tile_chunk",
        "backend")})
    assert cfg.backend == "xla"
    params = {k: torch.from_numpy(np.array(v))
              for k, v in jpool.params.items()}
    alive = torch.from_numpy(np.array(jpool.alive))
    tv = {k: torch.from_numpy(np.array(v)) for k, v in views.items()}
    with torch.no_grad():
        imgs, aux = gt.render_batch_from_params(
            params, tv["c2w"], tv["fx"], tv["fy"], tv["cx"], tv["cy"], cfg,
            alive=alive)
        singles = [gt.render_from_params(
            params, tv["c2w"][i], tv["fx"][i], tv["fy"][i], tv["cx"][i],
            tv["cy"][i], cfg, alive=alive) for i in range(3)]
    assert imgs.shape == (3, cfg.height, cfg.width, 3)
    total = 0
    for i, (img, aux1) in enumerate(singles):
        np.testing.assert_allclose(imgs[i].numpy(), img.numpy(), atol=1e-5)
        np.testing.assert_allclose(aux.depth[i].numpy(), aux1.depth.numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(aux.alpha[i].numpy(), aux1.alpha.numpy(),
                                   atol=1e-5)
        np.testing.assert_array_equal(aux.screen_radius[i].numpy(),
                                      aux1.screen_radius.numpy())
        total += int(aux1.num_pairs)
    assert int(aux.num_pairs) == total
    assert aux.pair_capacity == 3 * cfg.max_pairs
    imgs_j, aux_j = jax.jit(lambda p, a, v: gj.render_batch_from_params(
        p, v["c2w"], v["fx"], v["fy"], v["cx"], v["cy"], JBATCH_CFG,
        alive=a))(jpool.params, jpool.alive, views)
    assert np.abs(imgs.numpy() - np.asarray(imgs_j)).max() <= IMG_TOL
    assert int(aux.num_pairs) == int(aux_j.num_pairs)


# --- the rank cap of the kernel path against the per-tile cap ----------------

def test_truncated_plain_compositor_matches_xla_cap():
    """``tile_rank_cap=K`` on the port's plain compositor (the kernel's
    semantics) against ``backend="xla"`` with ``max_per_tile=K``: the same
    kept pairs, so images within 2e-5 and gradients within 5e-4 (the JAX
    gate, tests/test_pallas_kernel.py:183-216, at 600 gaussians)."""
    params = _dense_scene(600)
    c2w = torch.eye(4)
    K = 32
    base = gt.RenderConfig(height=64, width=64, max_pairs=2**14,
                           max_per_tile=4096, tile_chunk=4, pair_block=32)
    cfg_p = base.with_(tile_rank_cap=K)
    cfg_x = base.with_(backend="xla", max_per_tile=K)
    tgt = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (64, 64, 3)).astype(np.float32))

    def run(cfg):
        p = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in params.items()}
        img, aux = gt.render_from_params(p, c2w, CAM["fx"], CAM["fy"],
                                         CAM["cx"], CAM["cy"], cfg)
        (torch.mean(torch.abs(img - tgt)) + torch.mean(img * img)).backward()
        return img.detach(), aux, {k: v.grad for k, v in p.items()}

    img_p, aux_p, g_p = run(cfg_p)
    img_x, _, g_x = run(cfg_x)
    assert int(aux_p.num_pairs_kept) < int(aux_p.num_pairs)
    assert int(aux_p.trunc_demand) <= aux_p.trunc_capacity
    assert float((img_p - img_x).abs().max()) < IMG_TOL
    for k in params:
        assert _rel(g_p[k].numpy(), g_x[k].numpy()) < GRAD_TOL, k


# --- the dense oracle --------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_rasterize_dense_matches_jax(seed):
    scene = make_scene(None, n=160, seed_offset=seed)
    kw = dict(height=40, width=56, max_pairs=8192)
    jcfg = gj.RenderConfig(**kw)
    proj, colors = _jax_projection(_np_params(scene), scene["c2w"], jcfg)
    img_j = jras.rasterize_dense(
        jproj.ProjectedGaussians(**{f: jnp.asarray(v)
                                    for f, v in proj.items()}),
        jnp.asarray(colors), jcfg)
    img_t = tras.rasterize_dense(_to_torch_proj(proj),
                                 torch.from_numpy(np.array(colors)),
                                 gt.RenderConfig(**kw))
    assert float(np.asarray(img_j).max()) > 0.1
    assert np.abs(img_t.numpy() - np.asarray(img_j)).max() <= IMG_TOL


# --- the backend switch and its readers ---------------------------------------

def test_resolve_backend():
    cfg = gt.RenderConfig(height=16, width=16)
    assert tras.resolve_backend(cfg) == "pallas"
    assert tras.resolve_backend(cfg.with_(backend="pallas")) == "pallas"
    assert tras.resolve_backend(cfg.with_(backend="xla")) == "xla"
    with pytest.raises(ValueError):
        tras.resolve_backend(cfg.with_(backend="mosaic"))


@pytest.mark.parametrize("batched", [False, True])
def test_train_step_tolerates_no_backward_demand(batched):
    """With ``backend="xla"`` and ``bwd_pairs`` set, the render reports no
    backward demand: the per-view step's metric is -1 and the batched step
    has none, as in JAX's ``batch_loss_fn``; the step runs."""
    jpool = _pool()
    views = _views(b=2)
    cfg_kw = dict(height=64, width=48, max_pairs=4096, max_per_tile=128,
                  tile_chunk=8, backend="xla", bwd_pairs=512)
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 1, (2, 64, 48, 3)).astype(np.float32)
    jbatch = dict({k: v[:2] for k, v in views.items()},
                  image=jnp.asarray(image))
    jcfg, jtcfg = gj.RenderConfig(**cfg_kw), gj.TrainConfig(
        batched_render=batched)
    _, m_j = jax.jit(lambda p, a, b: jtrainer.batch_loss_fn(
        p, a, b, jcfg, jtcfg))(jpool.params, jpool.alive, jbatch)
    tpool = gt.pool_from_numpy({k: np.asarray(v) for k, v in
                                jpool.params.items()},
                               np.asarray(jpool.alive), device="cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    tcfg = gt.TrainConfig(batched_render=batched, capacity=tpool.capacity,
                          batch_size=2)
    state = gt.init_train_state(tpool, tcfg)
    state, m_t = gt.make_train_step(gt.RenderConfig(**cfg_kw), tcfg)(
        state, tbatch)
    assert ("bwd_demand" in m_t) == ("bwd_demand" in m_j) == (not batched)
    if not batched:
        assert int(m_t["bwd_demand"]) == int(m_j["bwd_demand"]) == -1
    assert np.isfinite(float(m_t["total"]))
