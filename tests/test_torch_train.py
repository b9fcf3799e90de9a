"""Port parity: losses, TrainConfig, the LR schedule and the train step.

The same seeded numpy inputs go through the JAX package and through
gsplat_tpu_torch on the CPU. The JAX renders use ``backend="pallas"``
(interpret mode), the compositor the port holds itself to.

Tolerances:
* losses and their gradients: 1e-5 (relative to the largest magnitude);
* ``position_lr``: 1e-6 relative;
* the first train step: gradients 5e-4 relative to each leaf's largest
  (the render's own tolerance, tests/test_torch_grads.py). Adam's first
  update is ``lr g / (|g| + eps)``, about ``lr sign(g)``, so the updates
  are compared elementwise (1e-4 relative) only where
  ``|g_jax| > 1e-3 max|g_jax|`` of that leaf; elsewhere ``|delta| <= lr``
  (plus one ulp of the parameter: delta is read back from f32 storage).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_scene

import gsplat_tpu as gj
import gsplat_tpu.ops.losses as jlosses
import gsplat_tpu.train.trainer as jtrainer
import gsplat_tpu_torch as gt
import gsplat_tpu_torch.ops.losses as tlosses
import gsplat_tpu_torch.train.trainer as ttrainer
from gsplat_tpu.models import init_pool_from_points
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
from test_train import CFG as JCFG
from test_train import _make_batch, _make_pool

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

RCFG = dict(height=64, width=64, max_pairs=4096)


def _rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _torch_pool(jpool):
    return gt.pool_from_numpy({k: np.asarray(v) for k, v in
                               jpool.params.items()},
                              np.asarray(jpool.alive), device="cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# --- losses --------------------------------------------------------------------

def test_losses_and_gradients_match_jax():
    r = np.random.default_rng(4)
    pred = r.uniform(0, 1, (2, 40, 48, 3)).astype(np.float32)
    tgt = np.clip(pred + r.normal(0, 0.1, pred.shape), 0, 1).astype(
        np.float32)
    np.testing.assert_array_equal(tlosses.gaussian_window(7, 1.2).numpy(),
                                  np.asarray(jlosses.gaussian_window(7, 1.2)))
    for name in ("l1_loss", "ssim", "ssim_loss"):
        jf, tf = getattr(jlosses, name), getattr(tlosses, name)
        want, g_want = jax.value_and_grad(jf)(jnp.asarray(pred),
                                              jnp.asarray(tgt))
        p = torch.from_numpy(pred).requires_grad_(True)
        got = tf(p, torch.from_numpy(tgt))
        got.backward()
        assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(
            float(want)), name
        assert _rel_err(p.grad.numpy(), g_want) <= 1e-5, name
    # Unbatched [H, W, C] and the combined loss with its components.
    want, comps_j = jlosses.compute_loss(jnp.asarray(pred[0]),
                                         jnp.asarray(tgt[0]), 0.7, 0.3)
    got, comps_t = tlosses.compute_loss(torch.from_numpy(pred[0]),
                                        torch.from_numpy(tgt[0]), 0.7, 0.3)
    for k in ("l1", "ssim", "total"):
        assert abs(float(comps_t[k]) - float(comps_j[k])) <= 1e-5
    assert float(got) == float(comps_t["total"])


# --- config and schedule --------------------------------------------------------

def test_train_config_matches_jax():
    jf = dataclasses.fields(gj.TrainConfig)
    tf = dataclasses.fields(gt.TrainConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [f.default for f in tf] == [f.default for f in jf]
    assert gt.TrainConfig(capacity=64) == gt.TrainConfig(capacity=64)


def test_position_lr_matches_jax():
    cfg = gt.TrainConfig()
    mid = cfg.position_lr_max_steps // 2
    steps = [0, 1, 299, 300, 301, mid, cfg.position_lr_max_steps, 10**6]
    for s in steps:
        want = float(jtrainer.position_lr(s, gj.TrainConfig()))
        got = ttrainer.position_lr(s, cfg)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= 1e-6 * want, s
    assert float(gt.position_lr(0, cfg)) == pytest.approx(
        cfg.position_lr_init * 0.01, rel=1e-6)
    assert float(gt.position_lr(10**6, cfg)) == pytest.approx(
        cfg.position_lr_final, rel=1e-6)


# --- the train step ---------------------------------------------------------------

def _lrs(tcfg):
    return dict(ttrainer._fixed_lrs(tcfg),
                pos=float(ttrainer.position_lr(0, tcfg)))


def test_first_step_update_matches_jax():
    jpool = _make_pool()
    batch = _make_batch(jpool)
    jcfg = JCFG.with_(backend="pallas")
    tcfg_j = gj.TrainConfig(capacity=512, batch_size=2)
    tcfg = gt.TrainConfig(capacity=512, batch_size=2)

    def jgrads(params):
        g = jax.grad(lambda p: jtrainer.batch_loss_fn(
            p, jpool.alive, batch, jcfg, tcfg_j)[0])(params)
        g = jtrainer._clip_pos_grad(g, tcfg_j.grad_clip_pos)
        return jax.tree.map(lambda x: jnp.where(
            jpool.alive.reshape((-1,) + (1,) * (x.ndim - 1)), x, 0.0), g)

    g_j = jax.jit(jgrads)(jpool.params)
    pool = _torch_pool(jpool)
    alive = np.asarray(jpool.alive)
    old = {k: np.array(v) for k, v in jpool.params.items()}
    state_j = jtrainer.init_train_state(jpool, tcfg_j)
    new_j, m_j = jtrainer.make_train_step(jcfg, tcfg_j)(state_j, batch)  # donates

    state = gt.init_train_state(pool, tcfg)
    new_t, m_t = gt.make_train_step(gt.RenderConfig(**RCFG), tcfg)(
        state, _torch_batch(batch))
    assert abs(float(m_t["total"]) - float(m_j["total"])) <= 1e-5
    assert int(m_t["pair_demand"]) == int(m_j["pair_demand"])
    assert int(m_t["nonfinite_skipped"]) == int(m_j["nonfinite_skipped"]) == 0
    assert int(new_t.step) == 1
    lrs = _lrs(tcfg)
    for k in PARAM_KEYS:
        gj_k = np.asarray(g_j[k])
        gt_k = pool.params[k].grad.numpy()
        assert _rel_err(gt_k, gj_k) <= 5e-4, k
        d_j = np.asarray(new_j.pool.params[k]) - old[k]
        d_t = pool.params[k].detach().numpy() - old[k]
        big = np.abs(gj_k) > 1e-3 * np.abs(gj_k).max()
        assert big.any(), k
        np.testing.assert_allclose(d_t[big], d_j[big], rtol=1e-4, atol=0,
                                   err_msg=k)
        # |delta| <= lr, up to the f32 rounding of the stored parameter.
        assert (np.abs(d_t) <= lrs[k] * (1 + 1e-6)
                + np.spacing(np.abs(old[k]))).all(), k
        assert (d_t[~alive] == 0).all(), k
    np.testing.assert_allclose(m_t["pos_grad"].numpy(),
                               np.asarray(m_j["pos_grad"]), rtol=0,
                               atol=5e-4 * np.abs(np.asarray(
                                   m_j["pos_grad"])).max())


def test_train_step_decreases_loss():
    jpool = _make_pool()
    batch = _torch_batch(_make_batch(jpool))
    pool = _torch_pool(jpool)
    tcfg = gt.TrainConfig(capacity=512, batch_size=2)
    state = gt.init_train_state(pool, tcfg)
    step = gt.make_train_step(gt.RenderConfig(**RCFG), tcfg)
    losses = []
    for _ in range(21):
        state, m = step(state, batch)
        losses.append(float(m["total"]))
        assert int(m["nonfinite_skipped"]) == 0
    assert losses[-1] < losses[0] * 0.9, losses
    assert int(state.step) == 21
    adam = state.opt_state
    assert float(adam.state[pool.pos]["step"]) == 21.0
    dead = ~pool.alive.numpy()
    assert np.all(pool.pos.detach().numpy()[dead] == 0.0)


def test_nan_guard_skips_poisoned_step():
    """A non-finite batch leaves parameters, Adam moments and Adam step
    counts untouched and is reported; a clean batch then updates."""
    scene = make_scene(None, n=64, seed_offset=41)
    cfg = gt.RenderConfig(height=64, width=64, max_pairs=2048)
    tcfg = gt.TrainConfig(capacity=128, batch_size=1, nan_guard=True)
    pts = np.concatenate([scene["pos"], scene["f_dc"]], axis=-1)
    pool = _torch_pool(init_pool_from_points(pts, capacity=128))
    state = gt.init_train_state(pool, tcfg)
    step = gt.make_train_step(cfg, tcfg)
    with torch.no_grad():
        img, _ = gt.render_from_params(
            {k: torch.from_numpy(scene[k]) for k in PARAM_KEYS},
            scene["c2w"], 60.0, 58.0, 32.5, 31.5, cfg)
    good = {"image": (img + 0.1)[None], "c2w": torch.from_numpy(
        scene["c2w"])[None]}
    good.update({k: torch.tensor([v]) for k, v in
                 (("fx", 60.0), ("fy", 58.0), ("cx", 32.5), ("cy", 31.5))})
    bad = dict(good)
    bad["image"] = good["image"].clone()
    bad["image"][0, 0, 0, 0] = float("nan")

    before = [t.clone() for t in ttrainer._optimizer_tensors(state.opt_state)]
    state, m = step(state, bad)
    assert int(m["nonfinite_skipped"]) == 1
    after = ttrainer._optimizer_tensors(state.opt_state)
    for b, a in zip(before, after):
        assert torch.equal(b, a)
    state, m = step(state, good)
    assert int(m["nonfinite_skipped"]) == 0
    assert not torch.equal(pool.pos, before[0])
    assert float(state.opt_state.state[pool.pos]["step"]) == 1.0


def test_sh_warmup_mask_matches_jax():
    cfg = gt.TrainConfig(capacity=64, sh_warmup_interval=100)
    jcfg = gj.TrainConfig(capacity=64, sh_warmup_interval=100)
    assert ttrainer.sh_warmup_mask(0, gt.TrainConfig(capacity=64)) is None
    for s in (0, 99, 100, 250, 10_000):
        np.testing.assert_array_equal(
            ttrainer.sh_warmup_mask(torch.tensor(s, dtype=torch.int32),
                                    cfg).numpy(),
            np.asarray(jtrainer.sh_warmup_mask(jnp.int32(s), jcfg)))


def test_sh_warmup_freezes_f_rest_until_activation():
    """With warmup on, f_rest does not move at step 0 while f_dc trains;
    without warmup both move."""
    jpool = _make_pool()
    batch = _torch_batch(_make_batch(jpool))
    f_rest0 = np.asarray(jpool.params["f_rest"])
    f_dc0 = np.asarray(jpool.params["f_dc"])
    rcfg = gt.RenderConfig(**RCFG)
    for interval, frozen in ((1000, True), (0, False)):
        pool = _torch_pool(jpool)
        tcfg = gt.TrainConfig(capacity=512, batch_size=2,
                              sh_warmup_interval=interval)
        gt.make_train_step(rcfg, tcfg)(gt.init_train_state(pool, tcfg), batch)
        moved = np.abs(pool.f_rest.detach().numpy() - f_rest0).max() > 0
        assert moved != frozen
        assert np.abs(pool.f_dc.detach().numpy() - f_dc0).max() > 0


def test_unported_training_options_raise(tmp_path):
    rcfg = gt.RenderConfig(**RCFG)
    # batched_render is ported (test_torch_batched.py): one step of it
    # gives the scan step's loss.
    jpool = _make_pool()
    batch = _torch_batch(_make_batch(jpool))
    losses = []
    for batched in (False, True):
        tcfg = gt.TrainConfig(capacity=512, batch_size=2,
                              batched_render=batched)
        _, m = gt.make_train_step(rcfg, tcfg)(
            gt.init_train_state(_torch_pool(jpool), tcfg), batch)
        losses.append(float(m["total"]))
    assert abs(losses[0] - losses[1]) <= 1e-5 * max(abs(losses[0]), 1.0)
    # mesh and the gaussian-sharded step are ported
    # (test_torch_sharding.py); without a mesh gauss_sharded is ignored,
    # as in JAX: the same fit, bit for bit.
    fits = []
    for sharded in (False, True):
        tcfg = gt.TrainConfig(capacity=512, batch_size=2, iterations=2)
        st, _ = gt.fit(iter([batch] * 2), rcfg, tcfg,
                       initial_points=np.asarray(jpool.params["pos"])[:64],
                       gauss_sharded=sharded, log_fn=lambda s: None,
                       device="cpu")
        fits.append(st.pool.pos.detach().numpy())
    np.testing.assert_array_equal(fits[0], fits[1])

    # A dataset's point cloud is read (the data layer is ported): the pool
    # starts from its points, through the outlier filter.
    from gsplat_tpu_torch.data.pointcloud import filter_outliers

    pts = np.random.default_rng(0).normal(0, 1, (40, 6)).astype(np.float32)
    np.save(tmp_path / "pointcloud.npy", pts)

    class WithPointCloud:
        def pointcloud_path(self):
            return str(tmp_path / "pointcloud.npy")

        def batches(self, batch_size, seed=0):
            return iter(())

    logs = []
    state, _ = gt.fit(WithPointCloud(), rcfg,
                      gt.TrainConfig(capacity=64, iterations=0),
                      device="cpu", log_fn=logs.append)
    n = len(filter_outliers(pts))  # the farthest 0.5 % go
    assert 0 < n < 40
    assert any(m.startswith("init from") and f"{n} points" in m
               for m in logs)
    assert int(state.pool.num_alive()) == n
