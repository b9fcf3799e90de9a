"""Port parity: gradients of the training slice against ``jax.grad``.

The same seeded numpy inputs go through the JAX package and through
gsplat_tpu_torch on the CPU (PyTorch autograd for the plain stages, the
port's autograd Functions for the pair-feature gather and the
compositor; the JAX compositor's Pallas kernels run in interpret mode).

Tolerances, each relative to the largest magnitude of the JAX gradient
of that leaf:
* the gather backward (sort + cumsum + segment difference): 1e-6;
* covariance, SH and projection gradients: 1e-5 (elementwise f32 chains
  evaluated in the same order, a few ulp apart through exp/sqrt/divide);
* ``render_from_params``: 5e-4, the JAX package's own kernel-vs-XLA
  gradient tolerance (tests/test_pallas_kernel.py:80).
Lanes that are culled, behind the camera or NaN must get finite, zero
gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_scene

import gsplat_tpu as gj
import gsplat_tpu.config as jconfig
import gsplat_tpu_torch as gt
from gsplat_tpu.ops import gaussian as jgau
from gsplat_tpu.ops import projection as jproj
from gsplat_tpu.ops import sh as jsh
from gsplat_tpu.ops.rasterize import gather_pair_features as jgather
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
from gsplat_tpu_torch.ops import clamps
from gsplat_tpu_torch.ops import gaussian as tgau
from gsplat_tpu_torch.ops import projection as tproj
from gsplat_tpu_torch.ops import rasterize as trast
from gsplat_tpu_torch.ops import sh as tsh
from test_torch_raster import CFG, _jax_pairs
from test_torch_render import _trained_subset

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

CAM = dict(fx=60.0, fy=58.0, cx=32.5, cy=31.5)
TARGET_SEED = 0


def _rel_err(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    return float(np.abs(np.asarray(got) - want).max()) / max(scale, 1e-30)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# --- the JAX tie rule --------------------------------------------------------

def test_clamp_helpers_split_the_tie_gradient_like_jax():
    x = np.array([0.0, 0.5, 1.0, -1.0, 2.0], np.float32)
    for jf, tf in (
        (lambda v: jnp.clip(v, 0.0, 1.0), lambda v: clamps.clip(v, 0.0, 1.0)),
        (lambda v: jnp.maximum(v, 0.0), lambda v: clamps.maximum(v, 0.0)),
        (lambda v: jnp.minimum(v, 1.0), lambda v: clamps.minimum(v, 1.0)),
    ):
        want = jax.vmap(jax.grad(jf))(jnp.asarray(x))
        xt = _t(x, True)
        out = tf(xt)
        out.sum().backward()
        np.testing.assert_array_equal(out.detach().numpy(),
                                      np.asarray(jax.vmap(jf)(x)))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    assert float(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0))(0.0)) == 0.5


# --- the pair-feature gather -------------------------------------------------

def test_gather_backward_matches_jax_vjp():
    s = make_scene(None, n=192, seed_offset=3)
    _, b = _jax_pairs(*(jnp.asarray(s[k]) for k in
                        ("pos", "scale_raw", "q_raw", "opacity_raw", "f_dc",
                         "f_rest", "c2w")))
    r = np.random.default_rng(7)
    feat10 = r.normal(0, 1, (192, 10)).astype(np.float32)
    g = r.normal(0, 1, (10, b.pair_slot.shape[0])).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda f: jgather(CFG["max_pairs"], False, 0, f, b.pair_slot,
                          b.gauss_offsets),
        jnp.asarray(feat10))
    (want,) = vjp(jnp.asarray(g))
    f_t = _t(feat10, True)
    slot, offs = _t(b.pair_slot), _t(b.gauss_offsets)
    out = trast.gather_pair_features(f_t, slot, offs)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    out.backward(_t(g))
    assert _rel_err(f_t.grad.numpy(), want) <= 1e-6
    # Padding slots (-1) carry nothing back; the forward zeroes them.
    assert (out.detach().numpy()[:, np.asarray(b.pair_slot) < 0] == 0).all()
    # The truncated form finds its group bounds from the sorted keys; on
    # this list they are the offsets, and JAX's truncated VJP agrees.
    _, vjp_t = jax.vjp(
        lambda f: jgather(CFG["max_pairs"], True, 0, f, b.pair_slot,
                          b.gauss_offsets),
        jnp.asarray(feat10))
    (want_t,) = vjp_t(jnp.asarray(g))
    f_tt = _t(feat10, True)
    trast.gather_pair_features(f_tt, slot, offs, truncated=True).backward(
        _t(g))
    assert _rel_err(f_tt.grad.numpy(), want_t) <= 1e-6
    # bwd_cap (the block-compacted backward) is ported
    # (test_torch_satbwd.py): here it keeps the first 2 of the 36 nonzero
    # 128-pair blocks (the real pairs span more), as JAX's VJP does.
    _, vjp_c = jax.vjp(
        lambda f: jgather(CFG["max_pairs"], False, 256, f, b.pair_slot,
                          b.gauss_offsets),
        jnp.asarray(feat10))
    (want_c,) = vjp_c(jnp.asarray(g))
    f_tc = _t(feat10, True)
    trast.gather_pair_features(f_tc, slot, offs, bwd_cap=256).backward(
        _t(g))
    assert _rel_err(f_tc.grad.numpy(), want_c) <= 1e-6
    assert _rel_err(f_tc.grad.numpy(), want) > 1e-3  # blocks were dropped


# --- plain stages: covariance, SH, projection --------------------------------

def test_build_cov3d_packed_gradients_match_jax():
    s = make_scene(None, n=128, seed_offset=11)
    s["scale_raw"][:4] = -20.0  # exp() below the 1e-6 floor: zero gradient
    w = np.random.default_rng(1).normal(0, 1, (128, 6)).astype(np.float32)
    want = jax.grad(
        lambda a, q: jnp.sum(jgau.build_cov3d_packed(a, q) * w),
        argnums=(0, 1))(jnp.asarray(s["scale_raw"]), jnp.asarray(s["q_raw"]))
    a, q = _t(s["scale_raw"], True), _t(s["q_raw"], True)
    torch.sum(tgau.build_cov3d_packed(a, q) * _t(w)).backward()
    for got, ref in ((a.grad, want[0]), (q.grad, want[1])):
        assert _rel_err(got.numpy(), ref) <= 1e-5
    assert (a.grad[:4] == 0).all()


@pytest.mark.parametrize("n_rest", [0, 9, 45])
def test_evaluate_sh_gradients_match_jax(n_rest):
    s = make_scene(None, n=96, seed_offset=12)
    f_rest = s["f_rest"][:, :n_rest]
    pos = s["pos"].copy()
    pos[0] = s["c2w"][:3, 3]  # a point exactly at the camera: norm guard
    w = np.random.default_rng(2).normal(0, 1, (96, 3)).astype(np.float32)
    want = jax.grad(
        lambda d, r, p: jnp.sum(jsh.evaluate_sh(d, r, p, s["c2w"]) * w),
        argnums=(0, 1, 2))(jnp.asarray(s["f_dc"]), jnp.asarray(f_rest),
                           jnp.asarray(pos))
    leaves = [_t(s["f_dc"], True), _t(f_rest, True), _t(pos, True)]
    torch.sum(tsh.evaluate_sh(*leaves, _t(s["c2w"])) * _t(w)).backward()
    for leaf, ref in zip(leaves, want):
        if leaf.numel():
            assert np.isfinite(leaf.grad.numpy()).all()
            assert _rel_err(leaf.grad.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("aa_mode", ["none", "mip"])
def test_project_gaussians_gradients_match_jax(aa_mode):
    s = make_scene(None, n=128, seed_offset=13)
    pos = s["pos"].copy()
    pos[0, 2] = -4.0  # behind the camera
    pos[1] = np.nan  # NaN position
    pos[2, 0] = 60.0  # far off screen
    opacity_raw = s["opacity_raw"].copy()
    opacity_raw[3] = -12.0  # below the opacity cutoff
    cov = np.asarray(jgau.build_cov3d_packed(jnp.asarray(s["scale_raw"]),
                                             jnp.asarray(s["q_raw"])))
    alive = np.ones(128, bool)
    alive[4] = False
    cfg_kw = dict(CFG, aa_mode=aa_mode)
    r = np.random.default_rng(3)
    w_uv, w_con = (r.normal(0, 1, (128, k)).astype(np.float32) for k in (2, 3))
    w_d, w_op = (r.normal(0, 1, 128).astype(np.float32) for _ in range(2))

    def jloss(p, c, o):
        pr = jproj.project_gaussians(p, c, o, s["c2w"], *CAM.values(),
                                     jconfig.RenderConfig(**cfg_kw),
                                     extra_valid=alive)
        v = pr.valid
        return (jnp.sum(jnp.where(v[:, None], pr.uv * w_uv, 0.0))
                + jnp.sum(jnp.where(v[:, None], pr.conic * w_con, 0.0))
                + jnp.sum(jnp.where(v, pr.depth * w_d + pr.opacity * w_op,
                                    0.0))), v

    want, valid = jax.grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(pos), jnp.asarray(cov), jnp.asarray(opacity_raw))
    leaves = [_t(pos, True), _t(cov, True), _t(opacity_raw, True)]
    pr = tproj.project_gaussians(*leaves, _t(s["c2w"]), *CAM.values(),
                                 gt.RenderConfig(**cfg_kw),
                                 extra_valid=_t(alive))
    v = pr.valid
    np.testing.assert_array_equal(v.numpy(), np.asarray(valid))
    assert not v[:5].any() and v[5:].sum() > 50
    loss = (torch.where(v[:, None], pr.uv * _t(w_uv), 0.0).sum()
            + torch.where(v[:, None], pr.conic * _t(w_con), 0.0).sum()
            + torch.where(v, pr.depth * _t(w_d) + pr.opacity * _t(w_op),
                          0.0).sum())
    loss.backward()
    for leaf, ref in zip(leaves, want):
        g = leaf.grad.numpy()
        assert np.isfinite(g).all()
        assert (g[:5] == 0).all()
        ref = np.asarray(ref)
        ok = np.isfinite(ref).all(axis=tuple(range(1, ref.ndim)))
        assert _rel_err(g[ok], ref[ok]) <= 1e-5


# --- the whole render --------------------------------------------------------

def _render_grads(params, c2w, cfg_kw, cam, alive, tgt):
    """Gradients of mean|img - tgt| + mean(img^2) (the loss of
    tests/test_pallas_kernel.py:62-82) on both sides."""
    jcfg = gj.RenderConfig(**cfg_kw, backend="pallas")

    def jloss(p):
        img, _ = gj.render_from_params(p, c2w, cam["fx"], cam["fy"],
                                       cam["cx"], cam["cy"], jcfg,
                                       alive=jnp.asarray(alive))
        return jnp.mean(jnp.abs(img - tgt)) + jnp.mean(img * img)

    want = jax.jit(jax.grad(jloss))({k: jnp.asarray(v)
                                     for k, v in params.items()})
    tp = {k: _t(v, True) for k, v in params.items()}
    img, _ = gt.render_from_params(tp, c2w, cam["fx"], cam["fy"], cam["cx"],
                                   cam["cy"], gt.RenderConfig(**cfg_kw),
                                   alive=_t(alive))
    t_tgt = _t(tgt)
    (torch.mean(torch.abs(img - t_tgt)) + torch.mean(img * img)).backward()
    return {k: tp[k].grad.numpy() for k in tp}, {k: np.asarray(v)
                                                 for k, v in want.items()}


def _check_grads(got, want, alive):
    for k in PARAM_KEYS:
        assert np.isfinite(got[k]).all(), k
        assert (got[k][~alive] == 0).all(), f"dead slots of {k}"
        err = _rel_err(got[k], want[k])
        assert err < 5e-4, f"grad[{k}] rel err {err:.2e}"
        assert np.abs(want[k]).max() > 0, k


@pytest.mark.parametrize("seed", [0, 3])
def test_render_from_params_gradients_match_jax(seed):
    s = make_scene(None, n=192, seed_offset=seed)
    params = {k: s[k] for k in PARAM_KEYS}
    alive = np.random.default_rng(seed).uniform(0, 1, 192) > 0.15
    tgt = np.random.default_rng(TARGET_SEED).uniform(
        0, 1, (64, 64, 3)).astype(np.float32)
    got, want = _render_grads(params, s["c2w"], CFG, CAM, alive, tgt)
    _check_grads(got, want, alive)


def test_trained_checkpoint_subset_gradients_match_jax():
    params, alive, c2w = _trained_subset()
    H, W = 96, 160
    cam = dict(fx=0.85 * W, fy=0.85 * W, cx=W / 2.0, cy=H / 2.0)
    tgt = np.random.default_rng(TARGET_SEED).uniform(
        0, 1, (H, W, 3)).astype(np.float32)
    got, want = _render_grads(params, c2w,
                              dict(height=H, width=W, max_pairs=2**14),
                              cam, alive, tgt)
    _check_grads(got, want, alive)
