"""Surfels (2D Gaussian Splatting) on the port, held on the CPU to the
benchmark's plain reference (``benchmark/reference/gs2d.py``, plain
PyTorch that imports nothing of the program) on seeded random surfels at
64x48: the five maps through ``render_from_params``, the loss with the
distortion and normal terms and every leaf's gradient, three steps of
``make_train_step``; a surfel seen edge-on (the low-pass filter), the
per-warp cull's exactness, the refusals, the ADC's tangent-plane split,
growth, compaction, export and checkpoints of the two-column leaf and
``fit()``; and a three-column pool running the 3DGS code unchanged.

Tolerances. The port's plain path and the reference compute the same
float32 formulas in other orders (sequential running sums against
cumulative sums and einsums, a keyed reduction against autograd's
scatter): 1e-5 absolute on the rgb frame and the alpha map, 1e-5 of each
other map's largest value, 1e-5 relative on the loss, 2e-4 of each
leaf's norm on the gradients (measured 1e-7 to 1e-5). After three steps,
``compare.train_numbers`` within a tenth of the benchmark cell's limits.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as gt
from benchmark.reference import compare
from benchmark.reference import gs2d as ref2d
from benchmark.reference import render as rref
from gsplat_tpu_torch.config import (RenderConfig, SurfelConfig, TrainConfig,
                                     is_surfel_pool)
from gsplat_tpu_torch.models import adc
from gsplat_tpu_torch.models.gaussians import (GaussianPool, compact_pool,
                                               export_params)
from gsplat_tpu_torch.ops import losses
from gsplat_tpu_torch.ops import raster_cuda as rc
from gsplat_tpu_torch.ops import raster_surfel as rs
from gsplat_tpu_torch.ops import rasterize as trast
from gsplat_tpu_torch.ops import surfel as tsurf
from gsplat_tpu_torch.ops.binning import bin_gaussians
from gsplat_tpu_torch.ops.preprocess import preprocess
from gsplat_tpu_torch.render import render_from_params
from gsplat_tpu_torch.train import trainer as ttr
from gsplat_tpu_torch.viewer import make_render_fn

H, W = 48, 64
CAM = dict(fx=55.0, fy=55.0, cx=32.0, cy=24.0)
CFG = RenderConfig(height=H, width=W, max_pairs=2**15)
SC = SurfelConfig()
RATES = {"lambda_l1": 0.8, "lambda_ssim": 0.2}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _scene(n=400, seed=0, scales=2):
    """Seeded surfels (or gaussians with ``scales=3``) in front of the
    origin camera."""
    r = np.random.default_rng(2468 + seed)
    p = {"pos": np.stack([r.uniform(-2, 2, n), r.uniform(-1.5, 1.5, n),
                          r.uniform(3, 8, n)], -1),
         "scale_raw": r.normal(0, 0.3, (n, scales)) - 1.8,
         "q_raw": r.normal(0, 1, (n, 4)) + np.array([0, 0, 0, 1.5]),
         "opacity_raw": r.normal(0.5, 1, n),
         "f_dc": r.normal(0, 0.8, (n, 3)),
         "f_rest": r.normal(0, 0.05, (n, 45))}
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()}


def _pose(seed=0):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1 * seed, -0.05 * seed, 0.0]
    return c2w


def _rcam(c2w):
    return rref.Camera(c2w, CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"], H, W)


def _target(p, c2w):
    return ref2d.render(p, None, _rcam(c2w), rref.Renderer(),
                        ref2d.Surfels())[0]["rgb"]


def _perturbed(p, seed=0):
    g = torch.Generator().manual_seed(99 + seed)
    out = dict(p)
    for k in ("f_dc", "opacity_raw"):
        out[k] = p[k] + 0.1 * torch.randn(p[k].shape, generator=g)
    return out


def _batch(target, c2w):
    return {"image": target[None], "c2w": torch.from_numpy(c2w)[None],
            **{k: torch.tensor([v]) for k, v in CAM.items()}}


def _state(p, cap=None):
    n = p["pos"].shape[0]
    leaves = {k: v.clone() for k, v in p.items()}
    if cap:
        leaves = {k: torch.cat([v, v.new_zeros((cap - n,) + v.shape[1:])])
                  for k, v in leaves.items()}
        leaves["opacity_raw"][n:] = -10.0
        leaves["scale_raw"][n:] = -10.0
        leaves["q_raw"][n:, 3] = 1.0
    pool = GaussianPool(leaves, torch.arange(cap or n) < n)
    tcfg = TrainConfig(capacity=pool.capacity)
    return ttr.init_train_state(pool, tcfg, surfel=SC), tcfg


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


MAPS = (("depth", "depth"), ("alpha", "alpha"), ("normal", "normal"),
        ("distortion", "dist"))


@pytest.mark.parametrize("seed", [0, 1])
def test_the_five_maps_match_the_reference(seed):
    p = _scene(seed=seed)
    c2w = _pose(seed)
    with torch.no_grad():
        img, aux = render_from_params(p, c2w, *CAM.values(), CFG)
    maps = ref2d.render(p, None, _rcam(c2w), rref.Renderer(),
                        ref2d.Surfels())[0]
    assert float((img - maps["rgb"]).abs().max()) <= 1e-5
    for mine, theirs in MAPS:
        a, b = getattr(aux, mine), maps[theirs]
        assert a.shape == b.shape, mine
        top = float(b.abs().max())
        assert top > 0, mine
        assert float((a - b).abs().max()) <= 1e-5 * max(top, 1.0), mine
    assert float(aux.alpha.max()) > 0.9 and float(aux.distortion.max()) > 0


def test_the_loss_and_every_gradient_match_the_reference():
    p = _scene(seed=3)
    c2w = _pose(3)
    target = _target(p, c2w)
    start = _perturbed(p, 3)
    st, tcfg = _state(start)
    loss, metrics, grads = ttr.value_and_grads(st, _batch(target, c2w), CFG,
                                               tcfg)
    ref_loss, ref_g, _ = ref2d.render_grad(start, None, _rcam(c2w),
                                           rref.Renderer(), ref2d.Surfels(),
                                           target, RATES)
    assert set(grads) == set(ref_g) == set(start)
    assert abs(float(loss) - ref_loss) <= 1e-5 * ref_loss
    assert float(metrics["dist"]) > 0 and float(metrics["normal"]) > 0
    for k in ref_g:
        assert float(torch.linalg.vector_norm(ref_g[k])) > 0, k
        assert _rel(grads[k], ref_g[k]) <= 2e-4, k


def test_three_train_steps_match_the_reference():
    p = _scene(seed=5)
    views = [_pose(5), _pose(6), _pose(7)]
    targets = [_target(p, v) for v in views]
    start = _perturbed(p, 5)
    st, tcfg = _state(start)
    step = ttr.make_train_step(CFG, tcfg)
    losses_, g1 = [], None
    for i, v in enumerate(views):
        st, m = step(st, _batch(targets[i], v))
        losses_.append(float(m["total"]))
        if i == 0:
            g1 = {g["name"]: st.opt_state.state[g["params"][0]]["exp_avg"]
                  / 0.1 for g in st.opt_state.param_groups}
    t = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    opt = rref.Adam(start, t)
    cur, ref_losses, ref_g1 = start, [], None
    for i, v in enumerate(views):
        loss, g, _ = ref2d.render_grad(cur, None, _rcam(v), rref.Renderer(),
                                       ref2d.Surfels(), targets[i], t)
        g = opt.prepare(g, None)
        if i == 0:
            ref_g1 = g
        ref_losses.append(loss)
        cur = opt.step(cur, g)
    prog = st.pool.params
    nums = compare.train_numbers(
        losses_, ref_losses, {k: v.detach() for k, v in g1.items()}, ref_g1,
        {k: prog[k].detach() - start[k] for k in start},
        {k: cur[k] - start[k] for k in start})
    for k, lim in {"loss_rel_gap": 0.01, "grad_norm_gap": 0.01,
                   "delta_norm_gap": 0.02}.items():
        assert nums[k] <= lim / 10, nums
    for k in start:  # every leaf moved
        assert float((prog[k].detach() - start[k]).abs().max()) > 0, k


def test_a_surfel_seen_edge_on_shows_through_the_low_pass_filter():
    """A surfel whose plane holds the view ray through its centre: the
    ray-splat intersection misses it (rho3 is huge), so the low-pass
    term exp(-F |x - c|^2 / 2) alone draws it, at the centre's depth, as in
    the reference."""
    p = _scene(n=1)
    s2 = 0.5 ** 0.5
    with torch.no_grad():
        p["pos"][0] = torch.tensor([0.0, 0.0, 4.0])
        # a quarter turn about y: the normal along x, the view ray (z)
        # in the plane
        p["q_raw"][0] = torch.tensor([0.0, s2, 0.0, s2])
        p["scale_raw"][0] = torch.tensor([-1.0, -1.0])
        p["opacity_raw"][0] = 3.0
    c2w = _pose(0)
    with torch.no_grad():
        img, aux = render_from_params(p, c2w, *CAM.values(), CFG)
    maps = ref2d.render(p, None, _rcam(c2w), rref.Renderer(),
                        ref2d.Surfels())[0]
    # one pixel right of the centre: its ray meets the plane only at the
    # camera, far outside the disc
    cy, cx = int(CAM["cy"]), int(CAM["cx"]) + 1
    want = 0.9526 * float(np.exp(-0.5 * SC.filter_inv_square))
    assert float(aux.alpha[cy, cx]) == pytest.approx(want, rel=1e-3)
    assert float(aux.depth[cy, cx] / aux.alpha[cy, cx]) == pytest.approx(
        4.0, rel=1e-4)
    assert float((aux.alpha - maps["alpha"]).abs().max()) <= 1e-5
    assert float((img - maps["rgb"]).abs().max()) <= 1e-5
    # Without the filter (F huge) it would vanish.
    with torch.no_grad():
        _, aux0 = render_from_params(p, c2w, *CAM.values(), CFG,
                                     surfel=SurfelConfig(
                                         filter_inv_square=1e8))
    assert float(aux0.alpha[cy, cx]) < 1e-3


def _adversarial(seed):
    """Surfels near the camera, large, edge-on, faint, and tilted."""
    p = _scene(n=300, seed=seed)
    r = np.random.default_rng(seed)
    with torch.no_grad():
        p["pos"][:60, 2] = torch.tensor(r.uniform(0.3, 1.0, 60))
        p["scale_raw"][60:120] = torch.tensor(r.uniform(-0.5, 0.5, (60, 2)))
        p["q_raw"][120:180] = torch.tensor(
            np.stack([r.normal(0, 1, 60), r.normal(0, 1, 60),
                      r.normal(0, 0.02, 60), r.normal(0, 0.02, 60)], -1))
        p["opacity_raw"][180:240] = torch.tensor(r.uniform(-5.2, -4.6, 60))
        p["scale_raw"][240:] = torch.tensor(
            np.stack([r.uniform(-3, -1, 60), r.uniform(-6, -4, 60)], -1))
    return p


@pytest.mark.parametrize("seed", [0, 1])
def test_the_per_warp_cull_drops_only_what_has_alpha_zero(seed):
    """Every (pair, warp) that ``surfel_warp_reach`` drops has alpha exactly
    0 at the warp's 32 pixels (so skipping it changes no bit), on random
    surfels and on adversarial ones; and it drops most (pair, warp)."""
    dropped = total = 0
    for p in (_scene(seed=seed), _adversarial(seed)):
        with torch.no_grad():
            proj, rows = tsurf.surfel_transform(
                p, torch.from_numpy(_pose(seed)), *CAM.values(), CFG, SC)
            bn = bin_gaussians(proj, CFG)
            tab = rs.table(rows[bn.depth_order.long()])
            k = rs._consts(CFG, SC)
            wp = rc.warp_pixels(CFG)  # [8, 32]
            for idx, pcol, _ in rs._blocks(bn.tile_start, bn.tile_count,
                                           bn.pair_slot.shape[0], CFG,
                                           torch.arange(CFG.num_tiles)):
                r = rs._pair_rows(tab, bn.pair_slot, pcol)
                px, py = rc._tile_pixels(idx, CFG)
                alpha = rs._hit(r, px, py, CFG, k)["alpha"]  # [m, G, P]
                reach = rs.surfel_warp_reach(r, idx, CFG, SC)  # [m, G, 8]
                by_warp = alpha[..., wp.reshape(-1)].reshape(
                    *alpha.shape[:2], 8, 32)
                live = (r[..., 11] > 0)[..., None]
                drop = ~reach & live
                assert not bool((by_warp[drop] != 0).any())
                dropped += int(drop.sum())
                total += int(live.expand_as(drop).sum())
    assert dropped > total // 2


def test_paths_surfels_do_not_take_refuse_them():
    p = _scene(n=100, seed=13)
    c2w = _pose(13)
    for bad in (dict(tile=32), dict(transmittance_math="log"),
                dict(bwd_pairs=4096), dict(backend="xla"),
                dict(cull_mode="ellipse"), dict(tile_rank_cap=256),
                dict(aa_mode="mip")):
        with pytest.raises(ValueError, match="surfel"):
            render_from_params(p, c2w, *CAM.values(), CFG.with_(**bad))
    with pytest.raises(ValueError, match="batched"):
        gt.render_batch_from_params(p, torch.from_numpy(c2w)[None],
                                    *CAM.values(), CFG)
    with pytest.raises(ValueError, match="f_sem"):
        render_from_params(dict(p, f_sem=torch.zeros(100, 32)), c2w,
                           *CAM.values(), CFG)
    pool = GaussianPool({k: v.clone() for k, v in p.items()},
                        torch.ones(100, dtype=torch.bool))
    with pytest.raises(ValueError, match="f_sem"):
        ttr.init_train_state(GaussianPool(dict(pool.params,
                                               f_sem=torch.zeros(100, 32)),
                                          pool.alive), TrainConfig())
    three = GaussianPool(_scene(n=100, seed=13, scales=3),
                         torch.ones(100, dtype=torch.bool))
    with pytest.raises(ValueError, match="surfel"):
        ttr.init_train_state(three, TrainConfig(), surfel=SC)
    st, tcfg = _state(p)
    with pytest.raises(ValueError, match="one view"):
        ttr.make_train_step(CFG, dataclasses.replace(
            tcfg, batched_render=True))(st, _batch(_target(p, c2w), c2w))
    from gsplat_tpu_torch.parallel import sharding
    with pytest.raises(ValueError, match="surfels"):
        sharding._refuse_features(st)
    with pytest.raises(ValueError, match="surfel"):  # never P1's
        preprocess(p, torch.eye(4), *CAM.values(), CFG)


def test_the_adc_splits_a_surfel_in_its_tangent_plane():
    p = _scene(n=200, seed=21)
    st, _ = _state(p, cap=512)
    pool = st.pool
    with torch.no_grad():
        pool.scale_raw[:40] = 0.0  # large: both forms split them
    stat = torch.zeros(512)
    stat[:40] = 1.0
    rot = adc.quat_to_rotmat(pool.q_raw[:40].detach()
                             / pool.q_raw[:40].detach().norm(dim=1,
                                                             keepdim=True))
    normal = rot[:, :, 2]
    before = pool.pos[:40].detach().clone()
    alive0 = pool.alive.clone()
    st, res = ttr.adc_step_paper(st, stat, torch.zeros(512, dtype=torch.int32),
                                 torch.Generator().manual_seed(1),
                                 TrainConfig(capacity=512))
    assert int(res.num_split) == 40
    kids = torch.nonzero(pool.alive & ~alive0).squeeze(1)
    for pos in (pool.pos[:40].detach(), pool.pos[kids].detach()):
        off = pos - before
        assert float(off.norm(dim=1).min()) > 0
        # in the tangent plane: no component along the normal
        assert float((off * normal).sum(dim=1).abs().max()) <= 1e-6
    assert pool.scale_raw.shape == (512, 2)
    # the reference form's split, likewise
    st2, _ = _state(p, cap=512)
    with torch.no_grad():
        st2.pool.scale_raw[:40] = 0.0
    grad = torch.zeros(512, 3)
    grad[:40] = 1.0
    alive0 = st2.pool.alive.clone()
    st2, res = ttr.adc_step(st2, grad, torch.Generator().manual_seed(0),
                            (0.0, 0.5, 0.01))
    kids = torch.nonzero(st2.pool.alive & ~alive0).squeeze(1)
    assert kids.numel() == 40
    off = st2.pool.pos[kids].detach() - before
    assert float((off * normal).sum(dim=1).abs().max()) <= 1e-6
    assert float(off.norm(dim=1).min()) > 0


def test_growth_compaction_export_and_checkpoints_keep_two_scales(tmp_path):
    p = _scene(n=300, seed=8)
    c2w = _pose(8)
    st, tcfg = _state(_perturbed(p, 8), cap=400)
    st, _ = ttr.make_train_step(CFG, tcfg)(st, _batch(_target(p, c2w), c2w))
    grown = ttr.grow_state_capacity(st, 800)
    assert grown.pool.scale_raw.shape == (800, 2) and grown.surfel == SC
    assert torch.equal(grown.pool.scale_raw[:400], st.pool.scale_raw)
    a = st.opt_state.state[st.pool.scale_raw]["exp_avg"]
    b = grown.opt_state.state[grown.pool.scale_raw]["exp_avg"]
    assert torch.equal(b[:400], a) and b.shape == (800, 2)
    assert compact_pool(grown.pool).scale_raw.shape == (800, 2)
    assert export_params(grown.pool)["scale_raw"].shape == (300, 2)
    path = tmp_path / "ck.npz"
    ttr.save_checkpoint(path, st)
    back = ttr.load_checkpoint(path, _state(_scene(n=10, seed=9))[0])
    assert is_surfel_pool(back.pool.params) and back.surfel == SC
    for k, v in st.pool.params.items():
        assert torch.equal(v, back.pool.params[k]), k
        for f in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st.opt_state.state[v][f],
                               back.opt_state.state[back.pool.params[k]][f])
    three = GaussianPool(_scene(n=10, seed=9, scales=3),
                         torch.ones(10, dtype=torch.bool))
    with pytest.raises(ValueError, match="surfels"):
        ttr.load_checkpoint(path, ttr.init_train_state(three, TrainConfig()))


@pytest.mark.parametrize("adc_mode", ["reference", "paper"])
def test_fit_trains_a_surfel_pool(tmp_path, adc_mode):
    p = _scene(n=600, seed=11)
    views = [_pose(11), _pose(12)]
    targets = [_target(p, v) for v in views]

    def batches():
        i = 0
        while True:
            yield {k: v.numpy() for k, v in
                   _batch(targets[i % 2], views[i % 2]).items()}
            i += 1

    tcfg = TrainConfig(iterations=4, capacity=1024, adc_mode=adc_mode,
                       densification_interval=2, densify_until_iter=4,
                       max_grad=1e-9, densify_grad_threshold=1e-12,
                       checkpoint_interval=1000)
    st, rep = gt.fit(batches(), CFG, tcfg,
                     initial_points=p["pos"].numpy()[:500],
                     output_dir=str(tmp_path), device="cpu", log_every=2,
                     log_fn=lambda s: None, surfel=SC)
    assert is_surfel_pool(st.pool.params) and st.surfel == SC
    assert np.isfinite(rep.final_loss) and rep.nonfinite_steps == 0
    assert int(st.pool.num_alive()) > 500  # the ADC spawned
    back = ttr.load_checkpoint(rep.checkpoints[-1], st)
    assert torch.equal(back.pool.scale_raw, st.pool.scale_raw)


def test_the_render_fn_serves_a_surfel_pool():
    p = _scene(seed=14)
    fn = make_render_fn(p, CFG, *CAM.values(), report_demand=True)
    img, probe = fn(_pose(14))
    img2, aux = render_from_params(p, _pose(14), *CAM.values(), CFG)
    assert torch.equal(img, img2) and img.shape == (H, W, 3)
    assert float(probe[1]) == float(aux.num_pairs) > 0


def test_a_three_column_pool_runs_the_3dgs_code(monkeypatch):
    """No surfel function runs for a pool with three scales, and its frame,
    gradients and train step equal those of the 3DGS chain called
    directly (``preprocess`` then ``rasterize``, the entry point's body
    before surfels), bit for bit."""
    p = _scene(seed=12, scales=3)
    c2w = _pose(12)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    ct = torch.from_numpy(c2w)
    proj, colors, _ = preprocess(leaves, ct, *CAM.values(), CFG)
    img_d, aux_d = trast.rasterize(proj, colors, CFG)
    (img_d.square().sum() + aux_d.depth.sum()).backward()
    want = {k: v.grad.clone() for k, v in leaves.items()}

    render_mod = sys.modules["gsplat_tpu_torch.render"]

    def banned(*a, **k):
        raise AssertionError("a surfel function ran for a 3DGS pool")
    for mod, name in ((rs, "composite_surfels"),
                      (rs, "composite_surfels_bwd"),
                      (render_mod, "check_surfel_config"),
                      (render_mod, "surfel_transform"),
                      (render_mod, "rasterize_surfels"),
                      (losses, "geometry_loss"), (ttr, "geometry_loss")):
        monkeypatch.setattr(mod, name, banned)
    monkeypatch.setattr(trast._CompositeSurfels, "apply", banned)
    leaves2 = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    img, aux = render_from_params(leaves2, c2w, *CAM.values(), CFG)
    assert aux.normal is None and aux.distortion is None
    assert torch.equal(img, img_d) and torch.equal(aux.depth, aux_d.depth)
    (img.square().sum() + aux.depth.sum()).backward()
    for k in want:
        assert torch.equal(leaves2[k].grad, want[k]), k
    pool = GaussianPool({k: v.clone() for k, v in p.items()},
                        torch.ones(400, dtype=torch.bool))
    st = ttr.init_train_state(pool, TrainConfig(capacity=400))
    assert st.surfel is None
    batch = _batch(img_d.detach().clamp(0, 1) * 0.9, c2w)
    _, m = ttr.make_train_step(CFG, TrainConfig(capacity=400))(st, batch)
    assert "dist" not in m and int(m["nonfinite_skipped"]) == 0
