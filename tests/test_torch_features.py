"""Per-gaussian features (Feature 3DGS) on the port, held on the CPU to the
benchmark's plain reference (``benchmark/reference/feat3dgs.py``, plain
PyTorch that imports nothing of the program) on seeded random scenes at
64x48 with 128 feature channels: the frame and the feature map, the loss
and every leaf's gradient (the geometry leaves' feature term and the
decoder's included), three Adam steps; the ADC carrying ``f_sem``,
growth, checkpoints and ``fit()``; and a pool without ``f_sem`` running
today's code. The ``gpu`` tests (they skip without a card) hold F1 and F2
to their plain versions at the benchmark cell's size and count their
launches.

Tolerances. The port's plain path and the reference compute the same
float32 formulas in other orders (sequential sums against einsums, a
keyed reduction against autograd's scatter), so values agree to float32
rounding over sums of a few hundred terms: 1e-5 absolute on the rgb frame
(values in [0, 1]); 1e-5 of the map's largest value on the feature map;
1e-5 relative on the loss; 2e-4 of each leaf's norm on the gradients
(each is a long chain of such sums; measured 1e-6 to 3e-5). After three
Adam steps, ``compare.train_numbers`` (the benchmark's own comparison,
which leaves out the elements whose reference gradient is exactly zero,
where Adam's eps of 1e-15 turns rounding into a whole step) within a
tenth of the benchmark cell's limits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as gt
from benchmark.reference import compare
from benchmark.reference import feat3dgs as fref
from benchmark.reference import render as rref
from gsplat_tpu_torch.config import FeatureConfig, RenderConfig, TrainConfig
from gsplat_tpu_torch.models.gaussians import (PARAM_KEYS, GaussianPool,
                                               init_decoder)
from gsplat_tpu_torch.ops import raster_cuda as rc
from gsplat_tpu_torch.ops import raster_feat as rf
from gsplat_tpu_torch.ops import rasterize as trast
from gsplat_tpu_torch.render import render_from_params
from gsplat_tpu_torch.train import trainer as ttr
from gsplat_tpu_torch.viewer import make_render_fn

H, W, C, D = 48, 64, 128, 32
CAM = dict(fx=55.0, fy=55.0, cx=32.0, cy=24.0)
CFG = RenderConfig(height=H, width=W, max_pairs=2**15)
RATES = {"lambda_l1": 0.8, "lambda_ssim": 0.2, "semantic_loss_weight": 1.0,
         "semantic_feature_lr": 1e-3, "decoder_lr": 1e-4}


def _scene(n=3000, seed=0):
    """Seeded leaves (3DGS's six, ``f_sem`` [n, C]) and the decoder."""
    r = np.random.default_rng(4321 + seed)
    p = {"pos": np.stack([r.uniform(-2, 2, n), r.uniform(-1.5, 1.5, n),
                          r.uniform(3, 8, n)], -1),
         "scale_raw": r.normal(0, 0.3, (n, 3)) - 2.2,
         "q_raw": r.normal(0, 1, (n, 4)) + np.array([0, 0, 0, 2]),
         "opacity_raw": r.normal(0.5, 1, n),
         "f_dc": r.normal(0, 0.8, (n, 3)),
         "f_rest": r.normal(0, 0.05, (n, 45)),
         "f_sem": r.normal(0, 1, (n, C))}
    p = {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()}
    p.update(init_decoder(C, D, seed=seed, device="cpu"))
    return p


def _pose(seed=0):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1 * seed, -0.05 * seed, 0.0]
    return c2w


def _rcam(c2w):
    return rref.Camera(c2w, CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"], H, W)


def _gauss(p):
    return {k: v for k, v in p.items() if k not in ("dec_w", "dec_b")}


def _decoder(p):
    return {k: p[k] for k in ("dec_w", "dec_b")}


def _target(p, c2w):
    """The reference's (rgb, decoded map at half size) of scene ``p``."""
    rgb, fmap, _ = fref.render(p, None, _rcam(c2w), rref.Renderer())
    return rgb, fref.decode(fmap, (H // 2, W // 2), p["dec_w"], p["dec_b"])


def _perturbed(p, seed=0):
    g = torch.Generator().manual_seed(99 + seed)
    out = dict(p)
    for k in ("f_dc", "opacity_raw", "f_sem"):
        out[k] = p[k] + 0.1 * torch.randn(p[k].shape, generator=g)
    return out


def _batch(target, c2w):
    rgb, teacher = target
    return {"image": rgb[None], "teacher": teacher[None],
            "c2w": torch.from_numpy(c2w)[None],
            **{k: torch.tensor([v]) for k, v in CAM.items()}}


def _state(p, rates=RATES):
    pool = GaussianPool({k: v.clone() for k, v in _gauss(p).items()},
                        torch.ones(p["pos"].shape[0], dtype=torch.bool))
    fcfg = FeatureConfig(semantic_feature_lr=rates["semantic_feature_lr"],
                         decoder_lr=rates["decoder_lr"],
                         semantic_loss_weight=rates["semantic_loss_weight"])
    tcfg = TrainConfig(capacity=pool.capacity)
    st = ttr.init_train_state(pool, tcfg, fcfg, decoder={
        k: v.clone() for k, v in _decoder(p).items()})
    return st, tcfg


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_and_feature_map_match_the_reference(seed):
    p = _scene(seed=seed)
    c2w = _pose(seed)
    with torch.no_grad():
        img, aux = render_from_params(_gauss(p), c2w, *CAM.values(), CFG)
    rgb, fmap, _ = fref.render(p, None, _rcam(c2w), rref.Renderer())
    assert aux.features.shape == (C, H, W)
    assert float((img - rgb).abs().max()) <= 1e-5
    assert float((aux.features - fmap).abs().max()) <= \
        1e-5 * float(fmap.abs().max())
    assert float(fmap.abs().max()) > 0.5  # the map is not empty


def test_feature_map_is_the_compositor_of_its_channels():
    """F1's plain version against K1's plain version fed four feature
    channels as its colour rows (6-9): the same weights, the same
    sequential sums, bit for bit."""
    p = _scene(seed=2)
    c2w = torch.from_numpy(_pose(2))
    with torch.no_grad():
        img, aux = render_from_params(_gauss(p), c2w, *CAM.values(), CFG)
        from gsplat_tpu_torch.ops.binning import bin_gaussians
        from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
        from gsplat_tpu_torch.ops.projection import project_gaussians
        from gsplat_tpu_torch.ops.sh import evaluate_sh
        cov = build_cov3d_packed(p["scale_raw"], p["q_raw"])
        colors = evaluate_sh(p["f_dc"], p["f_rest"], p["pos"], c2w)
        proj = project_gaussians(p["pos"], cov, p["opacity_raw"], c2w,
                                 *CAM.values(), CFG)
        bn = bin_gaussians(proj, CFG)
        feat10 = trast._pair_features(proj, colors, torch.float32)[
            bn.depth_order.long()]
        pf = trast._gather(feat10, bn.pair_slot)
        out = rc.composite_pairs_plain(pf, bn.tile_start, bn.tile_count,
                                       CFG)
        for c0 in (0, 60, 124):
            pf4 = pf.clone()
            pf4[6:10] = rf._pair_rows(p["f_sem"][:, c0:c0 + 4],
                                      bn.depth_order, bn.pair_slot)[0].T
            out4 = rc.composite_pairs_plain(pf4, bn.tile_start,
                                            bn.tile_count, CFG)
            want = rf._image_planes(out4[:, 0:4], CFG)
            assert torch.equal(aux.features[c0:c0 + 4], want), c0
            assert torch.equal(out4[:, 4:6], out[:, 4:6])


def test_loss_and_every_gradient_match_the_reference():
    p = _scene(seed=3)
    c2w = _pose(3)
    target = _target(p, c2w)
    start = _perturbed(p, 3)
    st, tcfg = _state(start)
    loss, metrics, grads = ttr.value_and_grads(st, _batch(target, c2w), CFG,
                                               tcfg)
    ref_loss, ref_g = fref.render_grad(start, None, _rcam(c2w),
                                       rref.Renderer(), target, RATES)
    assert set(grads) == set(ref_g) == set(start)
    assert abs(float(loss) - ref_loss) <= 1e-5 * ref_loss
    assert float(metrics["feat_l1"]) > 0
    for k in ref_g:
        assert float(torch.linalg.vector_norm(ref_g[k])) > 0, k
        assert _rel(grads[k], ref_g[k]) <= 2e-4, k


def test_the_feature_term_reaches_the_geometry_leaves():
    """With the feature weight 0 the geometry gradients are 3DGS's alone;
    with 1 they differ from them by the reference's feature term."""
    p = _scene(seed=4)
    c2w = _pose(4)
    target = _target(p, c2w)
    start = _perturbed(p, 4)
    out = {}
    for wgt in (0.0, 1.0):
        rates = dict(RATES, semantic_loss_weight=wgt)
        st, tcfg = _state(start, rates)
        out[wgt] = ttr.value_and_grads(st, _batch(target, c2w), CFG,
                                       tcfg)[2]
        ref = fref.render_grad(start, None, _rcam(c2w), rref.Renderer(),
                               target, rates)[1]
        for k in ("pos", "scale_raw", "q_raw", "opacity_raw"):
            assert _rel(out[wgt][k], ref[k]) <= 2e-4, (wgt, k)
    for k in ("pos", "scale_raw", "q_raw", "opacity_raw"):
        assert _rel(out[1.0][k], out[0.0][k]) > 1e-3, k
    assert float(out[0.0]["f_sem"].abs().max()) == 0.0


def test_three_adam_steps_match_the_reference():
    p = _scene(seed=5)
    views = [_pose(5), _pose(6), _pose(7)]
    targets = [_target(p, v) for v in views]
    start = _perturbed(p, 5)
    st, tcfg = _state(start)
    step = ttr.make_train_step(CFG, tcfg)
    losses, g1 = [], None
    for i, v in enumerate(views):
        st, m = step(st, _batch(targets[i], v))
        losses.append(float(m["total"]))
        if i == 0:
            g1 = {g["name"]: st.opt_state.state[g["params"][0]]["exp_avg"]
                  / 0.1 for g in st.opt_state.param_groups}
    t = {"position_lr_init": tcfg.position_lr_init,
         "position_lr_final": tcfg.position_lr_final,
         "position_lr_delay_mult": tcfg.position_lr_delay_mult,
         "position_lr_max_steps": tcfg.position_lr_max_steps,
         "feature_lr": tcfg.feature_lr, "opacity_lr": tcfg.opacity_lr,
         "scaling_lr": tcfg.scaling_lr, "rotation_lr": tcfg.rotation_lr,
         "adam_eps": tcfg.adam_eps, "grad_clip_pos": tcfg.grad_clip_pos,
         **RATES}
    opt = fref.Adam(start, t)
    cur, ref_losses, ref_g1 = start, [], None
    for i, v in enumerate(views):
        loss, g = fref.render_grad(cur, None, _rcam(v), rref.Renderer(),
                                   targets[i], t)
        g = opt.prepare(g, None)
        if i == 0:
            ref_g1 = g
        ref_losses.append(loss)
        cur = opt.step(cur, g)
    prog = {**st.pool.params, **st.decoder}
    nums = compare.train_numbers(
        losses, ref_losses, {k: v.detach() for k, v in g1.items()}, ref_g1,
        {k: prog[k].detach() - start[k] for k in start},
        {k: cur[k] - start[k] for k in start})
    limits = {"loss_rel_gap": 0.01, "grad_norm_gap": 0.01,
              "delta_norm_gap": 0.02}
    for k, lim in limits.items():
        assert nums[k] <= lim / 10, nums
    for k in start:  # every leaf moved
        assert float((prog[k].detach() - start[k]).abs().max()) > 0, k


def _adc_state(seed=6):
    p = _scene(n=400, seed=seed)
    n = 400
    cap = 1024
    leaves = {k: torch.cat([v, v.new_zeros((cap - n,) + v.shape[1:])])
              for k, v in _gauss(p).items()}
    leaves["opacity_raw"][n:] = -10.0
    leaves["q_raw"][n:, 3] = 1.0
    pool = GaussianPool(leaves, torch.arange(cap) < n)
    st = ttr.init_train_state(pool, TrainConfig(capacity=cap),
                              decoder=_decoder(p))
    return st


def test_adc_children_copy_their_parents_features():
    st = _adc_state()
    pool = st.pool
    with torch.no_grad():  # moments to see the reset
        st.opt_state.state[pool.f_sem]["exp_avg"].fill_(1.0)
    before = pool.f_sem.detach().clone()
    alive0 = pool.alive.clone()
    grad = torch.zeros(pool.capacity, 3)
    grad[:100] = 1.0  # 100 spawners: the first 50 clone, the rest split
    with torch.no_grad():
        pool.scale_raw[:50] = -6.0  # small: clone
        pool.scale_raw[50:100] = 0.0  # large: split
    st, res = ttr.adc_step(st, grad, torch.Generator().manual_seed(0),
                           (0.0, 0.5, 0.01))
    assert int(res.num_cloned) == 50 and int(res.num_split) == 50
    kids = torch.nonzero(pool.alive & ~alive0).squeeze(1)
    assert kids.numel() == 100
    # the i-th spawner took the i-th free slot (allocate_slots)
    assert torch.equal(pool.f_sem[kids].detach(), before[:100])
    assert torch.equal(pool.f_sem[:400].detach(), before[:400])
    # the new slots' moments were reset, f_sem's too
    m = st.opt_state.state[pool.f_sem]["exp_avg"]
    assert float(m[kids].abs().max()) == 0.0 and float(m[0, 0]) == 1.0
    # prune: the slot dies, the survivors' features stay
    with torch.no_grad():
        pool.opacity_raw[100:110] = -8.0
    kept = pool.f_sem.detach().clone()
    st, res = ttr.adc_step(st, torch.zeros(pool.capacity, 3),
                           torch.Generator().manual_seed(1),
                           (0.01, 0.5, 0.01))
    assert int(res.num_pruned) >= 10
    assert not bool(pool.alive[100:110].any())
    assert torch.equal(pool.f_sem.detach(), kept)


def test_paper_adc_split_replaces_the_parent_and_copies_features():
    st = _adc_state(7)
    pool = st.pool
    before = pool.f_sem.detach().clone()
    cap = pool.capacity
    stat = torch.zeros(cap)
    stat[:20] = 1.0
    with torch.no_grad():
        pool.scale_raw[:20] = 0.5  # large: split
    st, res = ttr.adc_step_paper(st, stat, torch.zeros(cap, dtype=torch.int32),
                                 torch.Generator().manual_seed(1),
                                 TrainConfig(capacity=cap))
    assert int(res.num_split) == 20
    kids = torch.nonzero(pool.alive & (torch.arange(cap) >= 400)).squeeze(1)
    assert kids.numel() == 20
    assert torch.equal(pool.f_sem[kids].detach(), before[:20])
    assert torch.equal(pool.f_sem[:20].detach(), before[:20])


def test_growth_keeps_features_decoder_and_moments():
    p = _scene(seed=8)
    c2w = _pose(8)
    st, tcfg = _state(_perturbed(p, 8))
    st, _ = ttr.make_train_step(CFG, tcfg)(st, _batch(_target(p, c2w),
                                                            c2w))
    n = st.pool.capacity
    grown = ttr.grow_state_capacity(st, 2 * n)
    assert grown.pool.f_sem.shape == (2 * n, C)
    assert torch.equal(grown.pool.f_sem[:n], st.pool.f_sem)
    assert float(grown.pool.f_sem[n:].detach().abs().max()) == 0.0
    assert grown.decoder is st.decoder
    for k, p_old in {**st.pool.params, **st.decoder}.items():
        p_new = grown.pool.params[k] if k in grown.pool.params \
            else grown.decoder[k]
        a, b = st.opt_state.state[p_old], grown.opt_state.state[p_new]
        assert float(a["step"]) == float(b["step"]) == 1.0, k
        assert torch.equal(b["exp_avg"][:a["exp_avg"].shape[0]],
                           a["exp_avg"]), k
    names = [g["name"] for g in grown.opt_state.param_groups]
    assert names == list(PARAM_KEYS) + ["f_sem", "dec_w", "dec_b"]
    lrs = {g["name"]: g["lr"] for g in grown.opt_state.param_groups}
    assert lrs["f_sem"] == 1e-3 and lrs["dec_w"] == lrs["dec_b"] == 1e-4


def test_checkpoint_round_trip_with_features(tmp_path):
    p = _scene(seed=9)
    c2w = _pose(9)
    st, tcfg = _state(_perturbed(p, 9))
    st, _ = ttr.make_train_step(CFG, tcfg)(st, _batch(_target(p, c2w),
                                                            c2w))
    path = tmp_path / "ck.npz"
    ttr.save_checkpoint(path, st)
    fresh, _ = _state(_scene(seed=10))
    back = ttr.load_checkpoint(path, fresh)
    assert int(back.step) == 1
    for k, v in {**st.pool.params, **st.decoder}.items():
        w = {**back.pool.params, **back.decoder}[k]
        assert torch.equal(v, w), k
        a, b = st.opt_state.state[v], back.opt_state.state[w]
        for f in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a[f], b[f]), (k, f)
        assert float(a["step"]) == float(b["step"]), k
    # the JAX layout's keys stay as they were; a plain state refuses it
    with np.load(path) as d:
        assert int(d["__num_opt_leaves__"]) == len(ttr.OPT_LEAVES)
        assert {"param_f_sem", "decoder_dec_w", "optx_f_sem_exp_avg"} <= \
            set(d.files)
    plain = ttr.init_train_state(
        GaussianPool(_gauss({k: v for k, v in p.items() if k != "f_sem"}),
                     torch.ones(p["pos"].shape[0], dtype=torch.bool)),
        TrainConfig())
    with pytest.raises(ValueError, match="features"):
        ttr.load_checkpoint(path, plain)


def test_fit_with_features_and_adc(tmp_path):
    p = _scene(n=2000, seed=11)
    views = [_pose(11), _pose(12)]
    targets = [_target(p, v) for v in views]

    def batches():
        i = 0
        while True:
            yield {k: v.numpy() for k, v in
                   _batch(targets[i % 2], views[i % 2]).items()}
            i += 1

    pts = p["pos"].numpy()[:1500]
    tcfg = TrainConfig(iterations=6, capacity=2048,
                       densification_interval=2, densify_until_iter=6,
                       max_grad=1e-9, checkpoint_interval=1000)
    st, rep = gt.fit(batches(), CFG, tcfg, initial_points=pts,
                     output_dir=str(tmp_path), device="cpu", log_every=2,
                     log_fn=lambda s: None,
                     features=FeatureConfig(), feature_dims=(C, D))
    assert st.pool.f_sem.shape[1] == C and st.decoder is not None
    assert np.isfinite(rep.final_loss) and rep.nonfinite_steps == 0
    assert int(st.pool.num_alive()) > 1500  # the ADC spawned
    assert float(st.pool.f_sem.abs().max()) > 0  # the features trained
    back = ttr.load_checkpoint(rep.checkpoints[-1], st)
    assert torch.equal(back.pool.f_sem, st.pool.f_sem)


def test_a_pool_without_features_runs_todays_code(monkeypatch):
    """No feature kernel, function or leaf where the pool has no ``f_sem``;
    the frame equals the frame of the same pool with features, and the
    gradients of the six leaves equal those of a pool with features whose
    loss leaves them out, bit for bit."""
    p = _scene(seed=12)
    c2w = _pose(12)
    target = _target(p, c2w)
    start = _perturbed(p, 12)
    st_f, tcfg = _state(start, dict(RATES, semantic_loss_weight=0.0))
    _, _, g_f = ttr.value_and_grads(st_f, _batch(target, c2w), CFG, tcfg)
    with torch.no_grad():
        img_f, aux_f = render_from_params(_gauss(start), c2w, *CAM.values(),
                                          CFG)

    def banned(*a, **k):
        raise AssertionError("a feature function ran for a plain pool")
    for name in ("composite_features", "composite_features_bwd",
                 "check_config"):
        monkeypatch.setattr(rf, name, banned)
    monkeypatch.setattr(trast._CompositeGatheredFeatures, "apply", banned)
    plain = {k: v for k, v in _gauss(start).items() if k != "f_sem"}
    with torch.no_grad():
        img, aux = render_from_params(plain, c2w, *CAM.values(), CFG)
    assert aux.features is None and torch.equal(img, img_f)
    pool = GaussianPool({k: v.clone() for k, v in plain.items()},
                        torch.ones(plain["pos"].shape[0], dtype=torch.bool))
    st = ttr.init_train_state(pool, TrainConfig(capacity=pool.capacity))
    assert st.decoder is None and list(pool.params) == list(
        PARAM_KEYS)
    assert [g["name"] for g in st.opt_state.param_groups] == list(
        PARAM_KEYS)
    batch = _batch(target, c2w)
    del batch["teacher"]
    _, metrics, g = ttr.value_and_grads(st, batch, CFG, tcfg)
    assert "feat_l1" not in metrics and set(g) == set(PARAM_KEYS)
    for k in g:
        assert torch.equal(g[k], g_f[k]), k


def test_feature_paths_refuse_what_they_do_not_take():
    p = _scene(n=500, seed=13)
    c2w = _pose(13)
    for bad in (dict(tile=32), dict(pair_block=512),
                dict(transmittance_math="log"), dict(bwd_pairs=4096),
                dict(backend="xla")):
        with pytest.raises(ValueError):
            render_from_params(_gauss(p), c2w, *CAM.values(),
                               CFG.with_(**bad))
    with pytest.raises(ValueError, match="multiple of 32"):
        render_from_params(dict(_gauss(p), f_sem=p["f_sem"][:, :40]), c2w,
                           *CAM.values(), CFG)
    with pytest.raises(ValueError, match="batched"):
        gt.render_batch_from_params(_gauss(p), torch.from_numpy(c2w)[None],
                                    *CAM.values(), CFG)
    pool = GaussianPool(_gauss(p), torch.ones(500, dtype=torch.bool))
    with pytest.raises(ValueError, match="decoder"):
        ttr.init_train_state(pool, TrainConfig())
    with pytest.raises(ValueError, match="decoder must be"):
        ttr.init_train_state(pool, TrainConfig(), decoder=init_decoder(
            C // 2, D, device="cpu"))
    plain = GaussianPool({k: v for k, v in _gauss(p).items()
                          if k != "f_sem"}, torch.ones(500, dtype=torch.bool))
    with pytest.raises(ValueError, match="f_sem"):
        ttr.init_train_state(plain, TrainConfig(), decoder=_decoder(p))
    st, tcfg = _state(p)
    with pytest.raises(ValueError, match="one view"):
        ttr.make_train_step(CFG, dataclasses.replace(
            tcfg, batched_render=True))(st, _batch(_target(p, c2w), c2w))


def test_render_fn_returns_the_feature_map():
    p = _scene(seed=14)
    fn = make_render_fn(_gauss(p), CFG, *CAM.values(), report_demand=True)
    (img, fmap), probe = fn(_pose(14))
    img2, aux = render_from_params(_gauss(p), _pose(14), *CAM.values(), CFG)
    assert torch.equal(img, img2) and torch.equal(fmap, aux.features)
    assert float(probe[1]) == float(aux.num_pairs)


# --- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return gt.resolve_device("cuda")


def _card_inputs(dev, n=200_000, height=840, width=1297):
    """A scene at the benchmark cell's image size, its K1 frame and state."""
    r = np.random.default_rng(5)
    p = {"pos": np.stack([r.uniform(-4, 4, n), r.uniform(-2.5, 2.5, n),
                          r.uniform(3, 12, n)], -1),
         "scale_raw": r.normal(0, 0.3, (n, 3)) - 3.0,
         "q_raw": r.normal(0, 1, (n, 4)) + np.array([0, 0, 0, 2]),
         "opacity_raw": r.normal(0.5, 1, n),
         "f_dc": r.normal(0, 0.8, (n, 3)),
         "f_rest": r.normal(0, 0.05, (n, 45)),
         "f_sem": r.normal(0, 1, (n, C))}
    p = {k: torch.tensor(v, dtype=torch.float32, device=dev)
         for k, v in p.items()}
    cfg = RenderConfig(height=height, width=width, max_pairs=2**23)
    from gsplat_tpu_torch.ops.binning import bin_gaussians
    from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
    from gsplat_tpu_torch.ops.projection import project_gaussians
    from gsplat_tpu_torch.ops.sh import evaluate_sh
    c2w = torch.eye(4, device=dev)
    cam = [torch.tensor(v, device=dev) for v in
           (0.85 * width, 0.85 * width, width / 2, height / 2)]
    with torch.no_grad():
        cov = build_cov3d_packed(p["scale_raw"], p["q_raw"])
        colors = evaluate_sh(p["f_dc"], p["f_rest"], p["pos"], c2w)
        proj = project_gaussians(p["pos"], cov, p["opacity_raw"], c2w, *cam,
                                 cfg)
        bn = bin_gaussians(proj, cfg)
        feat10 = trast._pair_features(proj, colors, torch.float32)[
            bn.depth_order.long()]
        pf = trast._gather(feat10, bn.pair_slot)
        out, state = rc._composite_fwd(pf, bn.tile_start, bn.tile_count, cfg,
                                       with_state=True)
    assert int(bn.num_pairs) <= cfg.max_pairs
    return p, cfg, bn, pf, out, state


@pytest.mark.gpu
def test_f1_equals_its_plain_version_on_the_card(cuda):
    p, cfg, bn, pf, out, _ = _card_inputs(cuda)
    with torch.no_grad():
        n0 = rf.composite_features.launches
        got = rf.composite_features(pf, bn.pair_slot, bn.depth_order,
                                    p["f_sem"], bn.tile_start, out, cfg)
        assert rf.composite_features.launches == n0 + 1
        want = rf.composite_features_plain(pf, bn.pair_slot, bn.depth_order,
                                           p["f_sem"], bn.tile_start, out,
                                           cfg)
    assert torch.equal(got, want)
    assert float(want.abs().max()) > 0.5


@pytest.mark.gpu
def test_f2_matches_its_plain_version_on_the_card(cuda):
    """F2 adds with float atomics in no fixed order; against the plain
    version's sums it agrees to 1e-5 of each output's largest value
    (measured 2e-6 at the benchmark cell's size)."""
    p, cfg, bn, pf, out, state = _card_inputs(cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    with torch.no_grad():
        fmap = rf.composite_features(pf, bn.pair_slot, bn.depth_order,
                                     p["f_sem"], bn.tile_start, out, cfg)
        gF = torch.randn(fmap.shape, generator=g, device=cuda) * 1e-6
        gout = torch.randn(out.shape, generator=g, device=cuda) * 1e-6
        d0 = rc.composite_pairs_bwd(pf, bn.tile_start, bn.tile_count, out,
                                    state, gout, cfg)
        dk, dp = d0.clone(), d0.clone()
        n0 = rf.composite_features.bwd_launches
        gk = rf.composite_features_bwd(pf, bn.pair_slot, bn.depth_order,
                                       p["f_sem"], bn.tile_start, out, fmap,
                                       gF, dk, cfg)
        assert rf.composite_features.bwd_launches == n0 + 1
        gp = rf.composite_features_bwd_plain(
            pf, bn.pair_slot, bn.depth_order, p["f_sem"], bn.tile_start, out,
            fmap, gF, dp, cfg)
    assert float((gk - gp).abs().max()) <= 1e-5 * float(gp.abs().max())
    for r in range(6):
        add_k, add_p = dk[r] - d0[r], dp[r] - d0[r]
        assert float(add_p.abs().max()) > 0, r
        assert float((add_k - add_p).abs().max()) <= \
            1e-5 * float(add_p.abs().max()), r
    assert torch.equal(dk[6:], d0[6:])


@pytest.mark.gpu
def test_a_feature_train_step_launches_f1_and_f2_once(cuda):
    p = {k: v.to(cuda) for k, v in _scene(seed=15).items()}
    c2w = _pose(15)
    rgb, fmap, _ = fref.render(p, None, _rcam(c2w), rref.Renderer())
    target = (rgb, fref.decode(fmap, (H // 2, W // 2), p["dec_w"],
                               p["dec_b"]))
    pool = GaussianPool({k: v.clone() for k, v in _gauss(p).items()},
                        torch.ones(p["pos"].shape[0], dtype=torch.bool,
                                   device=cuda))
    tcfg = TrainConfig(capacity=pool.capacity)
    st = ttr.init_train_state(pool, tcfg, decoder=_decoder(p))
    batch = {k: v.to(cuda) for k, v in _batch(target, c2w).items()}
    step = ttr.make_train_step(CFG, tcfg)
    counts = (rf.composite_features.launches,
              rf.composite_features.bwd_launches,
              rc.composite_pairs.launches, rc.composite_pairs.bwd_launches)
    st, m = step(st, batch)
    torch.cuda.synchronize()
    now = (rf.composite_features.launches, rf.composite_features.bwd_launches,
           rc.composite_pairs.launches, rc.composite_pairs.bwd_launches)
    assert [b - a for a, b in zip(counts, now)] == [1, 1, 1, 1]
    assert int(m["nonfinite_skipped"]) == 0
    res = rf.feat_resources(cuda, 128)
    assert res["F1"]["local_bytes"] == 0 and res["F2"]["local_bytes"] == 0


@pytest.mark.gpu
def test_k1_and_k2_are_unchanged_beside_features(cuda):
    """The frame and the six leaves' gradients of a pool with features whose
    loss leaves them out equal those of the pool without, bit for bit, on
    the card (K1 and K2 untouched; F2 adds exact zeros)."""
    p = {k: v.to(cuda) for k, v in _scene(seed=16).items()}
    c2w = _pose(16)
    pool_f = GaussianPool({k: v.clone() for k, v in _gauss(p).items()},
                          torch.ones(p["pos"].shape[0], dtype=torch.bool,
                                     device=cuda))
    plain = {k: v.clone() for k, v in _gauss(p).items() if k != "f_sem"}
    imgs, grads = [], []
    for params in (pool_f.params, plain):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        img, aux = render_from_params(leaves, c2w, *CAM.values(), CFG)
        loss = img.square().sum() + (0.0 * aux.features.sum()
                                     if aux.features is not None else 0.0)
        loss.backward()
        imgs.append(img.detach())
        grads.append({k: v.grad for k, v in leaves.items() if k != "f_sem"})
    assert torch.equal(imgs[0], imgs[1])
    for k in grads[1]:
        assert torch.equal(grads[0][k], grads[1][k]), k
