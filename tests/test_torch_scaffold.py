"""Scaffold-GS on the port, held on the CPU to the benchmark's plain
reference (``benchmark/reference/scaffold.py``, plain PyTorch that imports
nothing of the program) on seeded random anchors (a few hundred, ten
slots each) at 64x48: the anchor cull, the decoded fields and mask, the
frame through ``render_from_params``, the loss with the scaling term and
every leaf's and MLP's gradient, the rates' schedules and a scheduled
Adam step through ``make_train_step``, the viewer, checkpoints, the
refusals, the update without a position leaf; and a 3DGS pool through the
refactored covariance and projection entry, bit for bit.

Tolerances. The port's plain path and the reference compute the same
float32 formulas in other orders (a norm through ``vector_norm`` against
a square root of a sum, sequential running sums against cumulative sums
and einsums, a keyed reduction against autograd's scatter): the anchor
cull and the kept mask exactly (the same comparisons on values that
agree to the last bit or nearly: a slot within 1e-6 of opacity 0 may
flip, none does here); 1e-6 of each decoded field's largest magnitude;
1e-5 absolute on the rgb frame; 1e-5 relative on the loss; 2e-4 of each
leaf's norm on the gradients (as the surfel tests; measured well under);
after one step the change within a thousandth of the rate and the
parameter's own float32 rounding (2^-21 of its leaf's largest magnitude)
at every element whose
reference gradient is a hundredth of its leaf's largest or more (Adam's
first step is the rate times the gradient's sign: an element whose
gradient is at the rounding level of the two orders of summation can
take either sign).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import render as rref
from benchmark.reference import scaffold as refsc
from gsplat_tpu_torch.config import (MLP_KEYS, RenderConfig, ScaffoldConfig,
                                     TrainConfig)
from gsplat_tpu_torch.models.gaussians import GaussianPool, init_anchor_mlps
from gsplat_tpu_torch.ops import gaussian as tgauss
from gsplat_tpu_torch.ops import projection as tproj
from gsplat_tpu_torch.ops import scaffold as sf
from gsplat_tpu_torch.ops.preprocess import preprocess
from gsplat_tpu_torch.ops.update import adam_update
from gsplat_tpu_torch.parallel import sharding
from gsplat_tpu_torch.render import (pair_demand, render_batch_from_params,
                                     render_from_params)
from gsplat_tpu_torch.train import trainer as ttr
from gsplat_tpu_torch.viewer import make_render_fn

H, W = 48, 64
CAM = dict(fx=55.0, fy=55.0, cx=32.0, cy=24.0)
CFG = RenderConfig(height=H, width=W, max_pairs=2**15)
SC = refsc.Scaffold()
T = {"lambda_l1": 0.8, "lambda_ssim": 0.2, "adam_eps": 1e-15,
     "scaling_reg": 0.01, "feature_lr": 0.0075, "scaling_lr": 0.007,
     "offset_lr_init": 0.01, "offset_lr_final": 0.0001,
     "mlp_opacity_lr_init": 0.002, "mlp_opacity_lr_final": 2e-05,
     "mlp_cov_lr_init": 0.004, "mlp_cov_lr_final": 0.004,
     "mlp_color_lr_init": 0.008, "mlp_color_lr_final": 5e-05,
     "lr_delay_mult": 0.01, "lr_max_steps": 30000}
TRAINED = ("offset", "anchor_feat", "scale_raw") + MLP_KEYS


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _scene(n=300, seed=0):
    """Seeded anchors in front of the origin camera (some out of its
    view) and their MLPs."""
    r = np.random.default_rng(1357 + seed)
    p = {"pos": np.stack([r.uniform(-4.5, 4.5, n), r.uniform(-3, 3, n),
                          r.uniform(2, 8, n)], -1),
         "offset": r.normal(0, 1, (n, 30)),
         "anchor_feat": r.normal(0, 1, (n, 32)),
         "scale_raw": np.repeat(r.normal(0, 0.3, (n, 1)) - 2.3, 6, 1)}
    p = {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()}
    return {**p, **init_anchor_mlps(seed=seed, device="cpu")}


def _pose(seed=0):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1 * seed, -0.05 * seed, 0.0]
    return c2w


def _rcam(c2w):
    return rref.Camera(c2w, CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"], H, W)


def _target(p, c2w):
    return refsc.render(p, None, _rcam(c2w), rref.Renderer(), SC)[0]


def _perturbed(p, seed=0):
    g = torch.Generator().manual_seed(77 + seed)
    return dict(p, anchor_feat=p["anchor_feat"]
                + 0.1 * torch.randn(p["anchor_feat"].shape, generator=g))


def _batch(target, c2w):
    return {"image": target[None], "c2w": torch.from_numpy(c2w)[None],
            **{k: torch.tensor([v]) for k, v in CAM.items()}}


def _state(p):
    leaves = {k: p[k].clone() for k in ("pos", "offset", "anchor_feat",
                                         "scale_raw")}
    pool = GaussianPool(leaves, torch.ones(p["pos"].shape[0],
                                           dtype=torch.bool))
    tcfg = TrainConfig(capacity=pool.capacity, lambda_l1=0.8,
                       lambda_ssim=0.2)
    state = ttr.init_train_state(pool, tcfg,
                                 decoder={k: p[k] for k in MLP_KEYS},
                                 scaffold=ScaffoldConfig())
    return state, tcfg


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


@pytest.mark.parametrize("seed", [0, 1])
def test_the_cull_and_the_decode_match_the_reference(seed):
    p = _scene(seed=seed)
    c2w = _pose(seed)
    vis = sf.anchor_visible(p, torch.from_numpy(c2w), *CAM.values(), CFG)
    rvis = refsc.visible(p, None, _rcam(c2w), rref.Renderer(),
                         torch.float32)
    assert torch.equal(vis, rvis)
    assert 50 < int(vis.sum()) < vis.numel()
    with torch.no_grad():
        got = sf.decode_plain(p, vis, torch.from_numpy(c2w[:3, 3]))
    want = refsc.decode(p, rvis, _rcam(c2w), SC, torch.float32)
    assert torch.equal(got[5], want["keep"])
    assert 0 < int(got[5].sum()) < got[5].numel()
    for name, a in zip(refsc.FIELDS, got[:5]):
        b = want[name]
        assert a.shape == b.shape, name
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()), \
            name


@pytest.mark.parametrize("seed", [0, 1])
def test_the_frame_matches_the_reference(seed):
    p = _scene(seed=seed + 2)
    c2w = _pose(seed)
    with torch.no_grad():
        img, aux = render_from_params(p, c2w, *CAM.values(), CFG)
    want, c = refsc.render(p, None, _rcam(c2w), rref.Renderer(), SC,
                           count_work=True)
    assert float((img - want).abs().max()) <= 1e-5
    assert float(img.max()) > 0.2
    assert int(aux.neural_keep.sum()) == c["kept_slots"]
    assert int(aux.num_pairs) == c["pairs"]
    dem = pair_demand(p, c2w, *CAM.values(), CFG)[0]
    assert int(dem) == c["pairs"]


@pytest.fixture(scope="module")
def first_grads():
    p = _scene(seed=3)
    c2w = _pose(3)
    target = _target(p, c2w)
    start = _perturbed(p, 3)
    st, tcfg = _state(start)
    loss, metrics, grads = ttr.value_and_grads(st, _batch(target, c2w), CFG,
                                               tcfg)
    ref_loss, ref_g, _ = refsc.render_grad(start, None, _rcam(c2w),
                                           rref.Renderer(), SC, target, T)
    return loss, metrics, grads, ref_loss, ref_g


def test_the_loss_with_the_scaling_term_matches_the_reference(first_grads):
    loss, metrics, grads, ref_loss, ref_g = first_grads
    assert set(grads) == set(ref_g) == set(TRAINED)
    assert abs(float(loss) - ref_loss) <= 1e-5 * ref_loss
    assert 0 < float(metrics["scaling"]) and 0.01 * float(
        metrics["scaling"]) < float(loss)


@pytest.mark.parametrize("leaf", TRAINED)
def test_every_gradient_matches_the_reference(first_grads, leaf):
    _, _, grads, _, ref_g = first_grads
    assert float(torch.linalg.vector_norm(ref_g[leaf])) > 0, leaf
    assert _rel(grads[leaf], ref_g[leaf]) <= 2e-4, leaf


@pytest.mark.parametrize("leaf", ("offset",) + MLP_KEYS)
def test_the_schedules_match_the_reference(leaf):
    sc = ScaffoldConfig()
    init, final = sc.schedules()[leaf]
    for step in (0, 1, 299, 300, 301, 15000, 29999, 30000, 40000):
        got = float(ttr.scheduled_lr(torch.tensor(step), init, final,
                                     sc.lr_delay_mult, sc.lr_max_steps))
        want = refsc.leaf_lrs(T, step)[leaf]
        assert got == pytest.approx(want, rel=1e-6), (leaf, step)


def test_one_scheduled_adam_step_matches_the_reference():
    p = _scene(seed=5)
    c2w = _pose(5)
    target = _target(p, c2w)
    start = _perturbed(p, 5)
    st, tcfg = _state(start)
    st, m = ttr.make_train_step(CFG, tcfg)(st, _batch(target, c2w))
    assert int(st.step) == 1 and int(m["nonfinite_skipped"]) == 0
    assert m["pos_grad"] is None
    opt = refsc.ScaffoldAdam(start, T)
    _, g, _ = refsc.render_grad(start, None, _rcam(c2w), rref.Renderer(),
                                SC, target, T)
    g = opt.prepare(g, None)
    cur = opt.step(start, g)
    prog = {**st.pool.params, **st.decoder}
    assert torch.equal(prog["pos"].detach(), start["pos"])
    lrs = refsc.leaf_lrs(T, 0)
    for k in TRAINED:
        moved = g[k].abs() > 1e-2 * float(g[k].abs().max())
        d_prog = (prog[k].detach() - start[k])[moved]
        d_ref = (cur[k] - start[k])[moved]
        assert int(moved.sum()) > 0, k
        # The parameter's own float32 rounding bounds the change's.
        tol = 1e-3 * lrs[k] + 2.0**-21 * float(start[k].abs().max())
        assert float((d_prog - d_ref).abs().max()) <= tol, k


def test_the_render_fn_serves_an_anchor_pool():
    p = _scene(seed=6)
    c2w = _pose(1)
    fn = make_render_fn(p, CFG, *CAM.values(), report_demand=True)
    img, probe = fn(c2w)
    with torch.no_grad():
        want, _ = render_from_params(p, c2w, *CAM.values(), CFG)
    assert torch.equal(img, want)
    assert int(probe[1]) > 0


def test_a_checkpoint_round_trips_the_anchors_and_the_mlps(tmp_path):
    p = _scene(seed=7)
    c2w = _pose(2)
    st, tcfg = _state(_perturbed(p, 7))
    st, _ = ttr.make_train_step(CFG, tcfg)(st, _batch(_target(p, c2w), c2w))
    path = tmp_path / "anchors.npz"
    ttr.save_checkpoint(path, st)
    fresh, _ = _state(_scene(seed=8))
    got = ttr.load_checkpoint(path, fresh)
    assert int(got.step) == 1
    for k, v in {**st.pool.params, **st.decoder}.items():
        w = {**got.pool.params, **got.decoder}[k]
        assert torch.equal(v.detach(), w.detach()), k
    assert torch.equal(got.pool.alive, st.pool.alive)
    assert not got.pool.pos.requires_grad
    for k, leaf in ttr._leaves(st).items():
        a = st.opt_state.state[leaf]
        b = got.opt_state.state[ttr._leaves(got)[k]]
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[f], b[f]), (k, f)
    lr = {g["name"]: g["lr"] for g in got.opt_state.param_groups}
    assert set(lr) == set(TRAINED)
    # A 3DGS state does not take the file, nor an anchor state a 3DGS one.
    gp = GaussianPool({k: torch.zeros(4, w) for k, w in (
        ("pos", 3), ("f_dc", 3), ("f_rest", 45), ("scale_raw", 3),
        ("q_raw", 4))} | {"opacity_raw": torch.zeros(4)},
        torch.ones(4, dtype=torch.bool))
    plain = ttr.init_train_state(gp, TrainConfig(capacity=4))
    with pytest.raises(ValueError, match="anchors"):
        ttr.load_checkpoint(path, plain)
    ttr.save_checkpoint(tmp_path / "plain.npz", plain)
    with pytest.raises(ValueError, match="anchors"):
        ttr.load_checkpoint(tmp_path / "plain.npz", fresh)


def _refusal(case, p, tmp_path):
    c2w = torch.from_numpy(_pose(0))
    st, tcfg = _state(p)
    if case == "batched":
        render_batch_from_params(p, c2w[None], *CAM.values(), CFG)
    elif case in ("xla", "log", "tile32", "bwd_pairs"):
        cfg = {"xla": CFG.with_(backend="xla"),
               "log": CFG.with_(transmittance_math="log"),
               "tile32": CFG.with_(tile=32),
               "bwd_pairs": CFG.with_(bwd_pairs=4096)}[case]
        render_from_params(p, c2w, *CAM.values(), cfg)
    elif case == "sharded":
        sharding._refuse_features(st)
    elif case == "adc_reference":
        ttr.adc_step(st, torch.zeros(300, 3), None, (0.01, 0.01, 0.01))
    elif case == "adc_paper":
        ttr.adc_step_paper(st, torch.zeros(300), torch.zeros(300), None,
                           tcfg)
    elif case == "opacity_reset":
        ttr.opacity_raise_step(st)
    elif case == "growth":
        ttr.grow_state_capacity(st, 600)
    elif case == "paper_statistics":
        ttr.value_and_grads(st, _batch(torch.zeros(H, W, 3), _pose(0)), CFG,
                            TrainConfig(capacity=300, adc_mode="paper"))
    elif case == "dcp":
        ttr.save_checkpoint_dcp(tmp_path / "dcp", st)
    elif case == "f_sem":
        GaussianPool({**{k: p[k] for k in ("pos", "offset", "anchor_feat",
                                           "scale_raw")},
                      "f_sem": torch.zeros(300, 32)},
                     torch.ones(300, dtype=torch.bool))
    elif case == "surfel_scales":
        GaussianPool({**{k: p[k] for k in ("pos", "offset", "anchor_feat")},
                      "scale_raw": p["scale_raw"][:, :2]},
                     torch.ones(300, dtype=torch.bool))
    elif case == "preprocess":
        preprocess(p, c2w, *CAM.values(), CFG)
    elif case == "uv_tap":
        render_from_params(p, c2w, *CAM.values(), CFG,
                           uv_tap=torch.zeros(3000, 2))
    elif case == "no_mlps":
        render_from_params({k: p[k] for k in ("pos", "offset",
                                              "anchor_feat", "scale_raw")},
                           c2w, *CAM.values(), CFG)
    elif case == "no_decoder":
        ttr.init_train_state(st.pool, tcfg)


REFUSALS = ("batched", "xla", "log", "tile32", "bwd_pairs", "sharded",
            "adc_reference", "adc_paper", "opacity_reset", "growth",
            "paper_statistics", "dcp", "f_sem", "surfel_scales",
            "preprocess", "uv_tap", "no_mlps", "no_decoder")


@pytest.mark.parametrize("case", REFUSALS)
def test_an_anchor_pool_is_refused_where_it_does_not_run(case, tmp_path):
    with pytest.raises(ValueError):
        _refusal(case, _scene(), tmp_path)


@pytest.mark.parametrize("nonfinite", [False, True])
def test_the_update_without_a_position_leaf_clips_nothing(nonfinite):
    """An anchor pool's optimizer has no ``pos``: the update returns no
    position gradient and applies Adam unclipped, and the guard still
    skips a non-finite step."""
    p = _scene(seed=9)
    st, tcfg = _state(p)
    big = {k: torch.full_like(v, 1e3) for k, v in ttr._leaves(st).items()}
    if nonfinite:
        big["offset"][3, 0] = float("nan")
    before = {k: v.detach().clone() for k, v in ttr._leaves(st).items()}
    skipped, pos_grad = adam_update(st.opt_state, big, st.pool.alive,
                                    torch.tensor(1.0), 1.0)
    assert pos_grad is None and int(skipped) == int(nonfinite)
    for k, v in ttr._leaves(st).items():
        moved = v.detach() - before[k]
        if nonfinite:
            assert torch.equal(moved, torch.zeros_like(moved)), k
        else:  # Adam's first step: the rate times the gradient's sign
            lr = {g["name"]: g["lr"] for g in st.opt_state.param_groups}[k]
            tol = 2.0**-21 * float(before[k].abs().max())
            assert torch.allclose(moved, torch.full_like(moved, -float(lr)),
                                  rtol=1e-5, atol=tol), k


# The parent's covariance, as it stood before ``cov3d_from_activated``
# became its core (frozen here, so that the refactor is held to it).
def _parent_cov3d(scale_raw, q_raw):
    q = tgauss.normalize_quat(q_raw)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx_, yy_, zz_ = x * x, y * y, z * z
    xy_, xz_, yz_ = x * y, x * z, y * z
    xw_, yw_, zw_ = x * w, y * w, z * w
    r = [[1 - 2 * (yy_ + zz_), 2 * (xy_ - zw_), 2 * (xz_ + yw_)],
         [2 * (xy_ + zw_), 1 - 2 * (xx_ + zz_), 2 * (yz_ - xw_)],
         [2 * (xz_ - yw_), 2 * (yz_ + xw_), 1 - 2 * (xx_ + yy_)]]
    s2 = tgauss.exp_scale(scale_raw) ** 2
    s0, s1, s2_ = s2[..., 0], s2[..., 1], s2[..., 2]

    def sig(a, b):
        return s0 * a[0] * b[0] + s1 * a[1] * b[1] + s2_ * a[2] * b[2]

    return torch.stack([sig(r[0], r[0]), sig(r[0], r[1]), sig(r[0], r[2]),
                        sig(r[1], r[1]), sig(r[1], r[2]), sig(r[2], r[2])],
                       dim=-1)


@pytest.mark.parametrize("aa_mode", ["none", "dilate", "mip"])
def test_a_3dgs_pool_through_the_activated_entry_is_bit_for_bit(aa_mode):
    """``build_cov3d_packed`` against the parent's frozen covariance, and
    ``project_gaussians`` against ``project_activated`` of the sigmoid,
    values and every gradient, bit for bit (NaN-holding dead slots
    included)."""
    r = np.random.default_rng(11)
    n = 800
    raw = {"pos": np.stack([r.uniform(-3, 3, n), r.uniform(-2, 2, n),
                            r.uniform(0.5, 9, n)], -1),
           "scale_raw": r.normal(0, 0.5, (n, 3)) - 2.5,
           "q_raw": r.normal(0, 1, (n, 4)),
           "opacity_raw": r.normal(0, 1.5, n)}
    raw["pos"][7] = np.nan
    cfg = CFG.with_(aa_mode=aa_mode)
    alive = torch.arange(n) % 7 != 0
    c2w = torch.from_numpy(_pose(1))
    outs = []
    for variant in ("parent", "refactor"):
        t = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
             for k, v in raw.items()}
        if variant == "parent":
            cov = _parent_cov3d(t["scale_raw"], t["q_raw"])
            proj = tproj.project_activated(
                t["pos"], cov, torch.sigmoid(t["opacity_raw"]), c2w,
                *CAM.values(), cfg, extra_valid=alive)
        else:
            cov = tgauss.build_cov3d_packed(t["scale_raw"], t["q_raw"])
            proj = tproj.project_gaussians(t["pos"], cov, t["opacity_raw"],
                                           c2w, *CAM.values(), cfg,
                                           extra_valid=alive)
        loss = (torch.where(proj.valid[:, None], proj.uv, 0.0).sum()
                + torch.where(proj.valid[:, None], proj.conic, 0.0).sum()
                + proj.opacity.sum() + torch.where(proj.valid, proj.depth,
                                                   0.0).sum())
        loss.backward()
        outs.append([cov, *proj] + [t[k].grad for k in raw])
    for a, b in zip(*outs):
        a = a.detach()
        b = b.detach()
        if a.is_floating_point():
            a, b = torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0)
        assert torch.equal(a, b)
    assert 100 < int(outs[1][8].sum()) < n
