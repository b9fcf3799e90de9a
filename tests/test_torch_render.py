"""Port parity: the serving slice end to end (render_from_params and up).

The same numpy scene goes through the JAX package (its Pallas compositor
in interpret mode, ``backend="pallas"``, as tests/test_pallas_kernel.py
runs it) and through gsplat_tpu_torch on the CPU.

Tolerance for images and the alpha plane: 1e-4 abs, with ``num_pairs``
equal. It is wider than the compositor's 2e-5 because here each side
projects on its own: a projection float one ulp apart can move one
(pair, pixel) across the ``alpha_cutoff`` test. Do not loosen it without
writing down the pixel and the pair. The depth plane sums w * z with z up
to ~10, so it is held to 1e-4 of its largest value.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from conftest import make_scene

import gsplat_tpu as gj
import gsplat_tpu.viewer as jviewer
import gsplat_tpu_torch as gt
import gsplat_tpu_torch.viewer as tviewer
from gsplat_tpu.ops.gaussian import build_sigma_from_params
from gsplat_tpu.train.trainer import restore_pool as jax_restore_pool
from gsplat_tpu_torch import render_trained
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "bench_assets", "trained_ckpt.npz")
CFG = dict(height=64, width=64, max_pairs=4096, pair_block=32)
CAM = dict(fx=60.0, fy=58.0, cx=32.5, cy=31.5)
IMG_TOL = 1e-4


def _np_params(scene):
    return {k: np.array(scene[k]) for k in PARAM_KEYS}


def _jax_render(params, c2w, cfg_kw, cam, alive=None):
    cfg = gj.RenderConfig(**cfg_kw, backend="pallas")
    # Intrinsics stay Python floats (closed over), as the port receives them.
    fn = jax.jit(lambda p, c, a: gj.render_from_params(
        p, c, cam["fx"], cam["fy"], cam["cx"], cam["cy"], cfg, alive=a))
    return fn({k: jnp.asarray(v) for k, v in params.items()},
              jnp.asarray(c2w), None if alive is None else jnp.asarray(alive))


def _torch_render(params, c2w, cfg_kw, cam, alive=None):
    return gt.render_from_params(
        {k: torch.from_numpy(v) for k, v in params.items()}, c2w,
        cam["fx"], cam["fy"], cam["cx"], cam["cy"], gt.RenderConfig(**cfg_kw),
        alive=None if alive is None else torch.from_numpy(alive))


def _check(params, c2w, cfg_kw, cam, alive=None):
    img_j, aux_j = _jax_render(params, c2w, cfg_kw, cam, alive)
    img_t, aux_t = _torch_render(params, c2w, cfg_kw, cam, alive)
    assert int(aux_t.num_pairs) == int(aux_j.num_pairs)
    assert int(aux_t.max_tile_count) == int(aux_j.max_tile_count)
    assert int(aux_t.bwd_demand) == int(aux_j.bwd_demand)
    assert tuple(img_t.shape) == (cfg_kw["height"], cfg_kw["width"], 3)
    err = float(np.abs(img_t.numpy() - np.asarray(img_j)).max())
    assert err <= IMG_TOL, f"image max abs {err}"
    err_a = float(np.abs(aux_t.alpha.numpy() - np.asarray(aux_j.alpha)).max())
    assert err_a <= IMG_TOL, f"alpha max abs {err_a}"
    dj = np.asarray(aux_j.depth)
    err_d = float(np.abs(aux_t.depth.numpy() - dj).max())
    assert err_d <= IMG_TOL * max(1.0, float(np.abs(dj).max()))
    np.testing.assert_array_equal(aux_t.screen_radius.numpy(),
                                  np.asarray(aux_j.screen_radius))
    return img_t, aux_t


def _scene(kind):
    if kind == "saturated":
        s = make_scene(None, n=256, seed_offset=2)
        s["opacity_raw"] = s["opacity_raw"] + 6.0
        s["scale_raw"] = s["scale_raw"] + 1.0
    elif kind == "empty":
        s = make_scene(None, n=64, seed_offset=4)
        s["opacity_raw"] = s["opacity_raw"] - 50.0
    else:
        s = make_scene(None, n=192, seed_offset=int(kind[-1]))
    return s


@pytest.mark.parametrize("kind", ["seed0", "seed3", "saturated", "empty"])
def test_render_from_params_matches_jax(kind):
    s = _scene(kind)
    img, aux = _check(_np_params(s), s["c2w"], CFG, CAM)
    if kind == "empty":
        assert float(img.abs().max()) == 0.0 and int(aux.num_pairs) == 0
    else:
        assert float(img.mean()) > 0.0


def _trained_subset():
    """4,096 slots of the trained checkpoint: alive ones plus dead ones
    (whatever the dead slots hold, extra_valid must cull them)."""
    with np.load(CKPT) as d:
        alive = d["__alive__"]
        idx = np.concatenate([np.flatnonzero(alive)[:3900],
                              np.flatnonzero(~alive)[:196]])
        params = {k: np.ascontiguousarray(d[f"param_{k}"][idx])
                  for k in PARAM_KEYS}
    alive_sub = alive[idx]
    center, radius = tviewer.estimate_scene_center_radius(
        positions=params["pos"][alive_sub])
    cam = center + np.array([0.0, -0.6 * radius, -4.4 * radius])
    return params, alive_sub, tviewer.look_at(cam, center)


def test_trained_checkpoint_subset_matches_jax():
    params, alive, c2w = _trained_subset()
    H, W = 96, 160
    cam = dict(fx=0.85 * W, fy=0.85 * W, cx=W / 2.0, cy=H / 2.0)
    cfg_kw = dict(height=H, width=W, max_pairs=2**14)
    img, aux = _check(params, c2w, cfg_kw, cam, alive=alive)
    assert 0 < int(aux.num_pairs) <= cfg_kw["max_pairs"]
    assert float(img.mean()) > 0.0


def test_background_and_reference_signature_match_jax():
    s = _scene("seed0")
    cfg_kw = dict(CFG, background=(1.0, 1.0, 1.0))
    _check(_np_params(s), s["c2w"], cfg_kw, CAM)
    # render(): reference signature, full [N, 3, 3] covariances.
    sigma = np.array(build_sigma_from_params(jnp.asarray(s["scale_raw"]),
                                             jnp.asarray(s["q_raw"])))
    color = 1.0 / (1.0 + np.exp(-s["f_dc"]))
    args = (s["pos"], color.astype(np.float32), s["opacity_raw"], sigma,
            s["c2w"], 64, 64, 60.0, 58.0, 32.5, 31.5)
    want = gj.render(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                       for a in args),
                     cfg=gj.RenderConfig(**CFG, backend="pallas"))
    got = gt.render(*(torch.from_numpy(np.array(a))
                      if isinstance(a, np.ndarray) else a for a in args),
                    cfg=gt.RenderConfig(**CFG))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= IMG_TOL


def test_pair_demand_matches_jax():
    s = _scene("seed3")
    params = _np_params(s)
    kw = dict(CFG, max_pairs=64)  # demand above capacity: still reported
    want = jax.jit(lambda p, c: gj.pair_demand(
        p, c, *CAM.values(), gj.RenderConfig(**kw)))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(s["c2w"]))
    got = gt.pair_demand({k: torch.from_numpy(v) for k, v in params.items()},
                         s["c2w"], *CAM.values(), gt.RenderConfig(**kw))
    assert [int(x) for x in got] == [int(x) for x in want]
    assert int(got[0]) > 64


@pytest.mark.parametrize("kw,match", [
    # backend="xla" (the max_per_tile compositor) is ported
    # (test_torch_xla.py): its case now holds the render to JAX's XLA one.
    pytest.param(dict(backend="xla"), None, id="kw0-xla"),
    # bwd_pairs (the compacted backward) is ported (test_torch_satbwd.py):
    # its two cases now hold the forward, and its reported capacity, to
    # JAX's; what the levers still meet unported raises.
    pytest.param(dict(bwd_pairs=256), None, id="kw1-bwd_pairs"),
    pytest.param(dict(transmittance_math="log", bwd_pairs=256), None,
                 id="kw2-log"),
    # The ellipse cull is ported (test_torch_ellipse.py), with and without
    # truncation: its two cases now hold the render to JAX's.
    (dict(cull_mode="ellipse"), "ellipse"),
    pytest.param(dict(tile_rank_cap=64, cull_mode="ellipse"), "ellipse",
                 id="kw4-tile_rank_cap"),
])
def test_unported_options_raise(kw, match):
    s = _scene("seed0")
    if kw.get("backend") == "xla":  # ported: JAX's XLA render, its aux
        cfg = dict(CFG, **kw)
        img_j, aux_j = jax.jit(lambda p, c: gj.render_from_params(
            p, c, CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"],
            gj.RenderConfig(**cfg)))(
                {k: jnp.asarray(v) for k, v in _np_params(s).items()},
                jnp.asarray(s["c2w"]))
        img_t, aux_t = _torch_render(_np_params(s), s["c2w"], cfg, CAM)
        assert int(aux_t.num_pairs) == int(aux_j.num_pairs)
        assert float(np.abs(img_t.numpy() - np.asarray(img_j)).max()) \
            <= IMG_TOL
        assert aux_t.per_tile_capacity == aux_j.per_tile_capacity == 1024
        assert aux_t.bwd_demand is None and aux_j.bwd_demand is None
        return
    if match is None:  # ported: the JAX render's image and capacities
        _check(_np_params(s), s["c2w"], dict(CFG, **kw), CAM)
        _, aux_j = _jax_render(_np_params(s), s["c2w"], dict(CFG, **kw), CAM)
        _, aux_t = _torch_render(_np_params(s), s["c2w"], dict(CFG, **kw),
                                 CAM)
        assert aux_t.bwd_capacity == int(aux_j.bwd_capacity) == 256
        return
    # ported: the JAX ellipse render's image, demands and row capacity
    _, aux_t = _check(_np_params(s), s["c2w"], dict(CFG, **kw), CAM)
    _, aux_j = _jax_render(_np_params(s), s["c2w"], dict(CFG, **kw), CAM)
    assert int(aux_t.num_rows) == int(aux_j.num_rows) > 0
    assert int(aux_t.trunc_demand) == int(aux_j.trunc_demand)
    assert aux_t.row_capacity == aux_j.row_capacity == CFG["max_pairs"] // 2


# --- pool, checkpoint, device -----------------------------------------------

def test_pool_and_checkpoint_round_trip():
    pool = gt.restore_pool(CKPT, device="cpu")
    ref = jax_restore_pool(CKPT)
    assert isinstance(pool, torch.nn.Module)
    assert sorted(n for n, _ in pool.named_parameters()) == sorted(PARAM_KEYS)
    assert [n for n, _ in pool.named_buffers()] == ["alive"]
    np.testing.assert_array_equal(pool.alive.numpy(), np.asarray(ref.alive))
    for k in PARAM_KEYS:
        p = pool.params[k]
        assert p.dtype == torch.float32 and p.is_contiguous()
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(ref.params[k]))
    again = gt.pool_from_numpy(
        {k: v.detach().numpy() for k, v in pool.params.items()},
        pool.alive.numpy(), device="cpu")
    for k in PARAM_KEYS:
        assert torch.equal(again.params[k], pool.params[k])
    assert pool.capacity == 131072 and int(pool.num_alive()) == 119981
    with pytest.raises(ValueError, match="rows"):
        gt.pool_from_numpy({k: v.detach().numpy()[:10] for k, v in
                            pool.params.items()}, pool.alive.numpy(), "cpu")


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        gt.restore_pool(CKPT)  # device defaults to "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        gt.pool_from_numpy({k: np.zeros((2, 3), np.float32)
                            for k in PARAM_KEYS}, np.ones(2, bool))
    with pytest.raises(RuntimeError, match="is_available"):
        render_trained.main(["--checkpoint", CKPT, "--num_frames", "1"])


def test_import_needs_no_cuda_and_no_jax():
    code = ("import sys, gsplat_tpu_torch, gsplat_tpu_torch.render_trained, "
            "gsplat_tpu_torch.viewer, gsplat_tpu_torch.ops._build; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gsplat_tpu', 'triton')]; "
            "assert not bad, bad")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)


# --- viewer / serving loop ---------------------------------------------------

def test_viewer_camera_helpers_match_jax():
    center = np.array([0.3, -0.2, 1.5], np.float32)
    np.testing.assert_array_equal(
        tviewer.look_at([1.0, 2.0, -3.0], center),
        jviewer.look_at([1.0, 2.0, -3.0], center))
    np.testing.assert_array_equal(
        tviewer.create_orbit_trajectory(center, 4.0, 7, 20.0),
        jviewer.create_orbit_trajectory(center, 4.0, 7, 20.0))
    pts = make_scene(None, n=500, seed_offset=7)["pos"]
    for kw in (dict(positions=pts), dict(c2w_matrices=np.stack(
            [jviewer.look_at([3, 1, z], center) for z in (-2, 0, 2)])), {}):
        c_t, r_t = tviewer.estimate_scene_center_radius(**kw)
        c_j, r_j = jviewer.estimate_scene_center_radius(**kw)
        np.testing.assert_array_equal(c_t, c_j)
        assert r_t == r_j


def test_serving_loop_on_cpu_reports_demand_and_overflow():
    s = _scene("seed0")
    params = {k: torch.from_numpy(v) for k, v in _np_params(s).items()}
    traj = np.stack([s["c2w"], s["c2w"], s["c2w"]])
    for cap, overflow in ((4096, 0), (64, 3)):
        cfg = gt.RenderConfig(**dict(CFG, max_pairs=cap))
        fn = tviewer.make_render_fn(params, cfg, **CAM, report_demand=True)
        frames, stats = tviewer.render_trajectory(fn, traj,
                                                  pair_capacity=cap)
        assert len(frames) == 3 and frames[0].shape == (64, 64, 3)
        assert frames[0].dtype == np.uint8
        img, aux = gt.render_from_params(params, s["c2w"], **CAM, cfg=cfg)
        assert stats["frame_pairs"] == [int(aux.num_pairs)] * 3
        assert abs(stats["frame_mean"][0] - float(img.mean())) < 1e-6
        assert stats["pair_overflow_frames"] == overflow
        assert len(stats["frame_ms"]) == 3
    _, stats = tviewer.render_trajectory(fn, traj, keep_frames=False,
                                         pair_capacity=64)
    assert "pipelined_ms" in stats
    rgb, depth, alpha = tviewer.make_render_fn(
        params, cfg, **CAM, with_depth=True)(s["c2w"])
    assert depth.shape == alpha.shape == (64, 64)


def test_render_trained_cli_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    stats = render_trained.main([
        "--checkpoint", CKPT, "--num_frames", "2", "--height", "48",
        "--width", "80", "--max_pairs", "262144", "--orbit_scale", "4.4",
        "--device", "cpu"])
    assert stats["frames"] == 2 and stats["pair_overflow_frames"] == 0
    frames = np.stack([np.asarray(Image.open(f)) for f in sorted(
        (tmp_path / "renders" / "orbit_frames").glob("frame_*.png"))])
    assert frames.shape == (2, 48, 80, 3) and frames.max() > 0
