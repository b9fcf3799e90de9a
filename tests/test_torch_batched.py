"""Port parity: batched views through one binning (``view_tile_rows``).

``render_batch_from_params`` stacks B views into one image of ``B *
padded_height`` rows (view v's tile rows offset by ``v * tiles_y``, its uv
view-local) and bins and composites them once; the compositor wraps each
tile row to ``row % view_tile_rows`` before it becomes a pixel row (the
JAX package's ``rows_mod``, ``raster_pallas.py::_pixel_grid``). The same
seeded numpy inputs go through the JAX package (its Pallas kernels in
interpret mode, as tests/test_pallas_kernel.py runs them) and through
gsplat_tpu_torch on the CPU.

What is held, and how closely:

* the stacked projections, their binning (every integer) and the
  compositor at ``view_tile_rows > 0`` against JAX's: projections and
  integers exactly, rows 0-4 within 2e-5 (the compositor's tolerance, T
  built in another order), row 5 exactly; the per-warp cull's plain test
  drops no (pair, warp) with a non-zero alpha under the wrap;
* ``render_batch_from_params`` against JAX's: images within 2e-5,
  gradients within 5e-4 of each leaf's max, the batch's counts equal;
* the batch against per-view renders on the port (the JAX package's own
  gates, tests/test_batched_render.py): bit for bit when fed the stacked
  per-view projections, and through ``render_batch_from_params`` within
  its tolerances (images 1e-5, gradients 1e-4 + 1e-4 x max); the
  batched train step against the scan step in both ADC modes (loss 1e-5,
  parameters 2e-5; ``visible`` and ``max_radius`` exact, ``uv_grad_sum``
  within 1e-6 + 1e-4 x max); overflow reported;
* ``fit()`` with ``batched_render`` growing ``bwd_pairs`` as the JAX
  ``fit()`` logs it; ``make_batch_render_fn`` and ``render_trained
  --render_batch`` against per-pose rendering; the batched memory estimate
  against JAX's, exactly.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import gsplat_tpu as gj
import gsplat_tpu.config as jconfig
import gsplat_tpu_torch as gt
import gsplat_tpu_torch.config as tconfig
import gsplat_tpu_torch.viewer as tviewer
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.ops import gaussian as jgau
from gsplat_tpu.ops import projection as jproj
from gsplat_tpu.ops import raster_pallas as jras
from gsplat_tpu.ops import sh as jsh
from gsplat_tpu_torch import render_trained
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
from gsplat_tpu_torch.ops import raster_cuda as tras
from gsplat_tpu_torch.ops.binning import bin_gaussians
from gsplat_tpu_torch.ops.projection import ProjectedGaussians
from gsplat_tpu_torch.ops.rasterize import rasterize
from gsplat_tpu_torch.render import stack_view_projections
from test_batched_render import CAM, _pool, _views
from test_torch_binning import FIELDS
from test_torch_render import CKPT

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

jfit = importlib.import_module("gsplat_tpu.train.fit")
jrz = importlib.import_module("gsplat_tpu.ops.rasterize")
jrender = importlib.import_module("gsplat_tpu.render")
tfit = importlib.import_module("gsplat_tpu_torch.train.fit")

# tests/test_batched_render.py's configuration, on the port's compositor.
CFG = dict(height=64, width=48, max_pairs=4096)
IMG_TOL = 2e-5
GRAD_TOL = 5e-4


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _torch_pool(jpool):
    return gt.pool_from_numpy({k: np.asarray(v) for k, v in
                               jpool.params.items()},
                              np.asarray(jpool.alive), device="cpu")


def _torch_views(views):
    return {k: torch.from_numpy(np.array(v)) for k, v in views.items()}


def _batch_render(params, alive, views, cfg, uv_taps=None):
    return gt.render_batch_from_params(
        params, views["c2w"], views["fx"], views["fy"], views["cx"],
        views["cy"], cfg, alive=alive, uv_taps=uv_taps)


def _view_render(params, alive, views, i, cfg):
    return gt.render_from_params(
        params, views["c2w"][i], views["fx"][i], views["fy"][i],
        views["cx"][i], views["cy"][i], cfg, alive=alive)


def _batch_with_gt(pool, views):
    """tests/test_batched_render.py's batch, its ground truth (f_dc + 0.5)
    rendered by the port."""
    target = dict(pool.params, f_dc=pool.params["f_dc"] + 0.5)
    with torch.no_grad():
        image = torch.stack([
            _view_render(target, pool.alive, views, i,
                         gt.RenderConfig(**CFG))[0]
            for i in range(views["c2w"].shape[0])])
    return dict(views, image=image)


# --- the stacked binning and the compositor at view_tile_rows > 0 ------------

# Three views of 32x48 (tiles 3 x 2 each), pair_block 32: the stacked
# image has 6 tile rows, which view_tile_rows = 2 wraps.
SMALL = dict(height=32, width=48, max_pairs=1024, pair_block=32)


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_stacked(p, alive, cfg):
    views = _views(b=3)
    cov = jgau.build_cov3d_packed(p["scale_raw"], p["q_raw"])
    proj_b = jax.vmap(lambda c: jproj.project_gaussians(
        p["pos"], cov, p["opacity_raw"], c, CAM["fx"], CAM["fy"], 24.0,
        16.0, cfg, extra_valid=alive))(views["c2w"])
    colors = jax.vmap(lambda c: jsh.evaluate_sh(
        p["f_dc"], p["f_rest"], p["pos"], c))(views["c2w"])
    stacked, bcfg = jrender.stack_view_projections(proj_b, cfg)
    b = jbin.bin_gaussians(stacked, bcfg)
    feat10 = jrz._pair_features(stacked, colors.reshape(-1, 3),
                                jnp.float32)[b.depth_order]
    pf = jrz.gather_pair_features(bcfg.max_pairs, False, 0, feat10,
                                  b.pair_slot, b.gauss_offsets)
    pf16 = jnp.concatenate([pf, jnp.zeros((6, pf.shape[1]))], axis=0)
    return proj_b, stacked, b, pf, jras.composite_pairs(pf16, b.block_meta,
                                                        bcfg)


def test_stacked_binning_and_wrapped_compositor_match_jax():
    jpool = _pool()
    jcfg = jconfig.RenderConfig(**SMALL)
    proj_b, stacked_j, b_j, pf_j, out_j = jax.tree_util.tree_map(
        np.asarray, _jax_stacked(jpool.params, jpool.alive, jcfg))
    tcfg = tconfig.RenderConfig(**SMALL)
    stacked, bcfg = stack_view_projections(
        ProjectedGaussians(*(torch.from_numpy(np.array(a)) for a in proj_b)),
        tcfg)
    jb = jrender.stack_view_projections(
        jproj.ProjectedGaussians(*(jnp.asarray(a) for a in proj_b)), jcfg)[1]
    assert bcfg == tconfig.RenderConfig(**{
        f: getattr(jb, f) for f in tconfig.RenderConfig.__dataclass_fields__})
    assert bcfg.view_tile_rows == 2 and bcfg.tiles_y == 6
    for got, want in zip(stacked, stacked_j):
        np.testing.assert_array_equal(got.numpy(), want)
    b = bin_gaussians(stacked, bcfg)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      getattr(b_j, f), err_msg=f)
    pf = torch.from_numpy(np.array(pf_j))
    out = tras.composite_pairs(pf, b.tile_start, b.tile_count, bcfg)
    occ = b.tile_count.numpy() > 0
    assert occ[:6].any() and occ[12:].any()  # the first and last views
    assert np.abs(out.numpy()[occ, 0:5] - out_j[occ, 0:5]).max() <= IMG_TOL
    np.testing.assert_array_equal(out.numpy()[occ, 5], out_j[occ, 5])
    unwrapped = tras.composite_pairs(pf, b.tile_start, b.tile_count,
                                     bcfg.with_(view_tile_rows=0))
    assert not torch.equal(unwrapped[occ], out[occ])  # the wrap matters
    blk, tile, _ = tras.active_blocks(b.tile_start,
                                      tras.tile_block_offsets(out), bcfg)
    n = tras.cull_audit(pf, blk, tile, bcfg)
    assert n["unsafe"] == 0 and n["skipped"] > 0


# --- render_batch_from_params against JAX ------------------------------------

def test_batch_render_and_gradients_match_jax():
    """tests/test_batched_render.py:124's 32x32 Pallas batch, with a
    weighted loss on the images."""
    cfg_kw = dict(height=32, width=32, max_pairs=1024)
    jpool = _pool(n=24, capacity=32)
    views = {k: v[:2] for k, v in _views(b=2).items()}
    views["cx"] = jnp.full((2,), 16.0, jnp.float32)
    views["cy"] = jnp.full((2,), 16.0, jnp.float32)
    w = np.cos(0.37 * np.arange(2 * 32 * 32 * 3)).reshape(
        2, 32, 32, 3).astype(np.float32)
    jcfg = gj.RenderConfig(**cfg_kw, backend="pallas")

    def loss(p):
        imgs, aux = gj.render_batch_from_params(
            p, views["c2w"], views["fx"], views["fy"], views["cx"],
            views["cy"], jcfg, alive=jpool.alive)
        return jnp.sum(imgs * w), (imgs, aux)

    (_, (img_j, aux_j)), g_j = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jpool.params)
    pool = _torch_pool(jpool)
    imgs, aux = _batch_render(pool.params, pool.alive, _torch_views(views),
                              gt.RenderConfig(**cfg_kw))
    torch.sum(imgs * torch.from_numpy(w)).backward()
    assert tuple(imgs.shape) == (2, 32, 32, 3)
    assert int(aux.num_pairs) == int(aux_j.num_pairs)
    assert aux.pair_capacity == aux_j.pair_capacity == 2 * 1024
    assert int(aux.bwd_demand) == int(aux_j.bwd_demand)
    np.testing.assert_array_equal(aux.screen_radius.numpy(),
                                  np.asarray(aux_j.screen_radius))
    assert float(np.abs(imgs.detach().numpy() - np.asarray(img_j)).max()) \
        <= IMG_TOL
    for f in ("depth", "alpha"):
        got, want = getattr(aux, f).detach().numpy(), np.asarray(
            getattr(aux_j, f))
        assert got.shape == (2, 32, 32)
        assert float(np.abs(got - want).max()) <= IMG_TOL * max(
            1.0, float(np.abs(want).max())), f
    for k in PARAM_KEYS:
        got = pool.params[k].grad.numpy()
        assert np.isfinite(got).all(), k
        assert _rel(got, np.asarray(g_j[k])) <= GRAD_TOL, k


# --- the batch against per-view renders, on the port -------------------------

def test_batch_matches_per_view():
    """Fed the stacked per-view projections, the batch composites each
    view bit for bit; through render_batch_from_params, within JAX's
    tolerances (tests/test_batched_render.py:98)."""
    pool = _torch_pool(_pool())
    views = _torch_views(_views(b=3))
    cfg = gt.RenderConfig(**CFG)
    with torch.no_grad():
        singles = [_view_render(pool.params, pool.alive, views, i, cfg)
                   for i in range(3)]
        # The per-view pipeline's own projections and colours, stacked.
        from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
        from gsplat_tpu_torch.ops.projection import project_gaussians
        from gsplat_tpu_torch.ops.sh import evaluate_sh

        p = pool.params
        cov = build_cov3d_packed(p["scale_raw"], p["q_raw"])
        projs = [project_gaussians(
            p["pos"], cov, p["opacity_raw"], views["c2w"][i],
            views["fx"][i], views["fy"][i], views["cx"][i], views["cy"][i],
            cfg, extra_valid=pool.alive) for i in range(3)]
        colors = torch.cat([evaluate_sh(p["f_dc"], p["f_rest"], p["pos"],
                                        views["c2w"][i]) for i in range(3)])
        stacked, bcfg = stack_view_projections(
            ProjectedGaussians(*(torch.stack(f) for f in zip(*projs))), cfg)
        img, _ = rasterize(stacked, colors, bcfg)
        img = img.reshape(3, cfg.padded_height, cfg.width, 3)[:, :cfg.height]
        imgs, aux = _batch_render(pool.params, pool.alive, views, cfg)
    assert tuple(imgs.shape) == (3, cfg.height, cfg.width, 3)
    for i, (img1, aux1) in enumerate(singles):
        assert torch.equal(img[i], img1), i
        assert float((imgs[i] - img1).abs().max()) <= 1e-5, i
        assert float((aux.depth[i] - aux1.depth).abs().max()) <= 1e-4
        assert float((aux.alpha[i] - aux1.alpha).abs().max()) <= 1e-5
        assert torch.equal(aux.screen_radius[i], aux1.screen_radius)
    assert int(aux.num_pairs) == sum(int(a.num_pairs) for _, a in singles)
    assert aux.pair_capacity == 3 * cfg.max_pairs


def test_batch_gradients_match_per_view():
    pool = _torch_pool(_pool())
    views = _torch_views(_views(b=2))
    cfg = gt.RenderConfig(**CFG)
    grads = []
    for batched in (True, False):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in pool.params.items()}
        if batched:
            imgs, _ = _batch_render(p, pool.alive, views, cfg)
            loss = torch.sum(imgs * imgs)
        else:
            loss = sum(torch.sum(img * img) for img, _ in (
                _view_render(p, pool.alive, views, i, cfg) for i in range(2)))
        loss.backward()
        grads.append({k: v.grad.numpy() for k, v in p.items()})
    for k in PARAM_KEYS:
        a, b = grads[0][k], grads[1][k]
        assert float(np.abs(a - b).max()) <= 1e-4 + 1e-4 * float(
            np.abs(b).max()), k


def _step(tcfg, jpool, batch):
    return gt.make_train_step(gt.RenderConfig(**CFG), tcfg)(
        gt.init_train_state(_torch_pool(jpool), tcfg), batch)


def test_train_step_batched_matches_scan():
    jpool = _pool()
    batch = _batch_with_gt(_torch_pool(jpool), _torch_views(_views(b=3)))
    s1, m1 = _step(gt.TrainConfig(capacity=256, batch_size=3), jpool, batch)
    s2, m2 = _step(gt.TrainConfig(capacity=256, batch_size=3,
                                  batched_render=True), jpool, batch)
    assert abs(float(m1["total"]) - float(m2["total"])) <= 1e-5
    assert int(m2["pair_demand"]) > int(m1["pair_demand"])  # the batch's
    assert m2["pair_capacity"] == 3 * CFG["max_pairs"]
    for k in PARAM_KEYS:
        a = s1.pool.params[k].detach().numpy()
        b = s2.pool.params[k].detach().numpy()
        assert float(np.abs(a - b).max()) <= 2e-5, k


def test_train_step_batched_paper_stats_match_scan():
    jpool = _pool()
    batch = _batch_with_gt(_torch_pool(jpool), _torch_views(_views(b=2)))
    _, m1 = _step(gt.TrainConfig(capacity=256, batch_size=2,
                                 adc_mode="paper"), jpool, batch)
    _, m2 = _step(gt.TrainConfig(capacity=256, batch_size=2,
                                 adc_mode="paper", batched_render=True),
                  jpool, batch)
    assert torch.equal(m1["visible"], m2["visible"])
    assert torch.equal(m1["max_radius"], m2["max_radius"])
    a, b = m1["uv_grad_sum"].numpy(), m2["uv_grad_sum"].numpy()
    assert a.max() > 0
    assert float(np.abs(a - b).max()) <= 1e-6 + 1e-4 * float(np.abs(a).max())


def test_batch_overflow_reported_never_silent():
    pool = _torch_pool(_pool())
    with torch.no_grad():
        imgs, aux = _batch_render(pool.params, pool.alive,
                                  _torch_views(_views(b=2)),
                                  gt.RenderConfig(**dict(CFG, max_pairs=64)))
    assert int(aux.num_pairs) > aux.pair_capacity == 128
    assert torch.isfinite(imgs).all()


# --- fit(), the serving entry points, the memory estimate --------------------

def test_fit_batched_grows_bwd_pairs_like_jax():
    """With batched_render the demand is the batch's: the JAX fit()'s
    growth line, on the port."""
    from test_torch_fit import H, W, _iterate, _scene

    pts, batches = _scene()
    logs = {"jax": [], "torch": []}
    kw = dict(height=H, width=W, max_pairs=2048, pair_block=32,
              bwd_pairs=64)
    tkw = dict(iterations=2, batch_size=2, capacity=64, batched_render=True,
               densification_interval=10_000, opacity_reset_interval=10_000,
               checkpoint_interval=10_000)
    jfit.fit(_iterate(batches), gj.RenderConfig(**kw, backend="pallas"),
             gj.TrainConfig(**tkw), initial_points=pts, log_every=2,
             log_fn=logs["jax"].append)
    _, report = tfit.fit(_iterate(batches), gt.RenderConfig(**kw),
                         gt.TrainConfig(**tkw), initial_points=pts,
                         log_every=2, log_fn=logs["torch"].append,
                         device="cpu")
    grow = [[m for m in logs[k] if "bwd_pairs" in m] for k in logs]
    assert grow[0] and grow[0] == grow[1], logs
    assert report.overflow_events == 1 and np.isfinite(report.final_loss)


def test_batch_render_fn_and_render_trained_match_per_pose(tmp_path,
                                                           monkeypatch):
    pool = _torch_pool(_pool())
    views = _views(b=3)
    cfg = gt.RenderConfig(**CFG)
    cam = (CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"])
    fn = tviewer.make_batch_render_fn(pool.params, cfg, *cam,
                                      alive=pool.alive, batch=3,
                                      report_demand=True)
    poses = np.array(views["c2w"])
    imgs, probe = fn(poses)
    one = tviewer.make_render_fn(pool.params, cfg, *cam, alive=pool.alive)
    for i in range(3):
        assert torch.equal(imgs[i], one(poses[i]))
    assert abs(float(probe[0]) - float(imgs.mean())) < 1e-6
    # Three poses in batches of two: the last batch padded, its copy cut.
    f2, s2 = tviewer.render_trajectory(fn, poses, batch_size=2,
                                       pair_capacity=2 * cfg.max_pairs)
    f1, _ = tviewer.render_trajectory(one, poses)
    assert len(f2) == 3 and s2["batch_size"] == 2 and s2["frames"] == 3
    for a, b in zip(f1, f2):
        np.testing.assert_array_equal(a, b)

    # The CLI on the checkpoint's first 8,192 slots (the whole pool takes
    # seconds a view on one CPU thread).
    import gsplat_tpu_torch.train.trainer as ttrainer

    restore = ttrainer.restore_pool

    def first_slots(path, device):
        full = restore(path, device=device)
        return gt.pool_from_numpy(
            {k: v.detach().numpy()[:8192] for k, v in full.params.items()},
            full.alive.numpy()[:8192], device=device)

    monkeypatch.setattr(ttrainer, "restore_pool", first_slots)
    frames = {}
    for b in (1, 2):
        d = tmp_path / f"b{b}"
        d.mkdir()
        monkeypatch.chdir(d)
        stats = render_trained.main([
            "--checkpoint", CKPT, "--num_frames", "2", "--height", "36",
            "--width", "64", "--max_pairs", "262144", "--orbit_scale", "4.4",
            "--device", "cpu", "--render_batch", str(b)])
        frames[b] = np.stack([np.asarray(Image.open(f)) for f in sorted(
            (d / "renders" / "orbit_frames").glob("frame_*.png"))])
        assert stats["frames"] == 2 and stats["pair_overflow_frames"] == 0
        assert stats["pair_capacity"] == b * 262144
    assert stats["batch_size"] == 2 and len(stats["frame_pairs"]) == 1
    np.testing.assert_array_equal(frames[2], frames[1])


def test_batched_memory_estimate_matches_jax():
    from gsplat_tpu.utils.memory import estimate_train_memory as jtrain
    from gsplat_tpu_torch.utils.memory import estimate_train_memory

    kw = dict(height=540, width=960, max_pairs=2**21)
    tkw = dict(capacity=131072, batch_size=4, batched_render=True)
    got = estimate_train_memory(gt.RenderConfig(**kw), gt.TrainConfig(**tkw))
    want = jtrain(gj.RenderConfig(**kw), gj.TrainConfig(**tkw))
    # JAX's keys at JAX's values; total_mb is the port's own footprint.
    keys = set(want) - {"total_mb"}
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    one = estimate_train_memory(gt.RenderConfig(**kw), gt.TrainConfig(
        **dict(tkw, batched_render=False)))
    assert got["backward_dfeat_mb"] == 4 * one["backward_dfeat_mb"]
