"""Port parity: ``fit()``, the training loop.

Both packages' ``fit()`` run on one iterator of batches at 48x48 (the JAX
side with Pallas in interpret mode, as the other port tests run it) with a
clone-only ADC (``scale_threshold`` 1e3, ``max_grad`` 1e-9: every
gaussian with a gradient clones, exact copies, so no random draw enters),
on a pool that must grow. Port-only twins: the paper-mode fit trains
(tests/test_train.py:277), and ``max_pairs`` and the pool capacity grow
(tests/test_fit_e2e.py:299, 325, with an iterator in place of the
dataset); a run resumed from its checkpoint ends where the uninterrupted
run ends.

Tolerances: each densification's counts, the growth log lines and the
final alive count exact; logged losses within 1 % of JAX's (the render's
per-step differences accumulate over 12 steps); a resumed run bit for bit
with the uninterrupted one (same arithmetic on the same device).
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu.train.trainer as jtrainer
import gsplat_tpu_torch as gt
from conftest import make_scene
from gsplat_tpu_torch import make_bench_asset
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS, pool_from_dense
from gsplat_tpu_torch.viewer import look_at

# The modules (each package's train/__init__ exports the function `fit`,
# which hides the module of the same name from attribute access).
jfit = importlib.import_module("gsplat_tpu.train.fit")
tfit = importlib.import_module("gsplat_tpu_torch.train.fit")

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

H = W = 48
FX = 45.0


def _scene(n=48, seed=11):
    """A known scene, its initial cloud (positions + colors) and four
    ground-truth views (two batches of two), rendered by the port."""
    r = np.random.default_rng(seed)
    pos = np.stack([r.uniform(-1, 1, n), r.uniform(-1, 1, n),
                    r.uniform(3, 5, n)], -1).astype(np.float32)
    colors = r.uniform(0.2, 0.9, (n, 3)).astype(np.float32)
    params = {
        "pos": pos,
        "scale_raw": (r.normal(0, 0.2, (n, 3)) - 1.6).astype(np.float32),
        "q_raw": (r.normal(0, 0.5, (n, 4)) + [0, 0, 0, 1.5]).astype(
            np.float32),
        "opacity_raw": r.normal(1.5, 0.5, n).astype(np.float32),
        "f_dc": colors,
        "f_rest": np.zeros((n, 45), np.float32),
    }
    cfg = gt.RenderConfig(height=H, width=W, max_pairs=2048, pair_block=32)
    views = []
    for i in range(4):
        th = 0.15 * (i - 2)
        c2w = look_at(
            np.array([3.5 * np.sin(th), 0.2, 4.0 - 3.5 * np.cos(th)]),
            np.array([0.0, 0.0, 4.0])).astype(np.float32)
        with torch.no_grad():
            img, _ = gt.render_from_params(
                {k: torch.from_numpy(v) for k, v in params.items()}, c2w,
                FX, FX, W / 2, H / 2, cfg)
        views.append((img.numpy(), c2w))
    batches = []
    for b in (views[:2], views[2:]):
        batches.append({
            "image": np.stack([v[0] for v in b]),
            "c2w": np.stack([v[1] for v in b]),
            **{k: np.full(2, v, np.float32) for k, v in
               (("fx", FX), ("fy", FX), ("cx", W / 2), ("cy", H / 2))},
        })
    return np.concatenate([pos, colors], -1), batches


def _iterate(batches):
    i = 0
    while True:
        yield {k: np.array(v) for k, v in batches[i % len(batches)].items()}
        i += 1


def _record_adc(monkeypatch, module):
    """Wrap ``module.adc_step`` so each densification's counts are kept."""
    seen = []
    inner = module.adc_step

    def wrapped(*args, **kw):
        state, res = inner(*args, **kw)
        seen.append(tuple(int(getattr(res, f)) for f in (
            "num_pruned", "num_split", "num_cloned", "num_overflowed")))
        return state, res

    monkeypatch.setattr(module, "adc_step", wrapped)
    return seen


TRAIN = dict(iterations=12, batch_size=2, capacity=64,
             densification_interval=4, densify_until_iter=12,
             max_grad=1e-9, scale_threshold=1e3,
             opacity_reset_interval=10_000, checkpoint_interval=10_000)


def test_fit_matches_jax(monkeypatch, tmp_path):
    pts, batches = _scene()
    logs_j, logs_t = [], []
    adc_j = _record_adc(monkeypatch, jfit)
    adc_t = _record_adc(monkeypatch, tfit)
    state_j, rep_j = jfit.fit(
        _iterate(batches),
        gj.RenderConfig(height=H, width=W, max_pairs=4096, pair_block=32,
                        backend="pallas"),
        gj.TrainConfig(**TRAIN), initial_points=pts, log_every=2,
        log_fn=logs_j.append)
    out = str(tmp_path / "port")
    state, rep = tfit.fit(
        _iterate(batches),
        gt.RenderConfig(height=H, width=W, max_pairs=4096, pair_block=32),
        gt.TrainConfig(**TRAIN), initial_points=pts, log_every=2,
        log_fn=logs_t.append, output_dir=out, device="cpu")
    # 48 clones into 16 free slots: 32 dropped, the pool grows 64 -> 128;
    # then the 64 alive clone into 64 free slots.
    assert adc_t == adc_j == [(0, 0, 16, 32), (0, 0, 64, 0)]
    grow = [m for m in logs_t if "growing pool capacity" in m]
    assert grow == [m for m in logs_j if "growing pool capacity" in m]
    assert len(grow) == 1
    assert rep.overflow_events == rep_j.overflow_events == 1
    assert state.pool.capacity == state_j.pool.capacity == 128
    assert rep.num_gaussians == rep_j.num_gaussians == 128
    assert [it for it, _ in rep.losses] == [it for it, _ in rep_j.losses]
    for (it, got), (_, want) in zip(rep.losses, rep_j.losses):
        assert abs(got - want) <= 0.01 * want, (it, got, want)
    assert rep.nonfinite_steps == rep_j.nonfinite_steps == 0
    # The port's files: the final checkpoint (which JAX reads), the log.
    assert rep.checkpoints == [os.path.join(out, "checkpoint_final.npz")]
    jpool = jtrainer.restore_pool(rep.checkpoints[0])
    assert int(jpool.num_alive()) == 128
    with open(os.path.join(out, "train_log.json")) as f:
        log = json.load(f)
    assert log["iterations"] == 12 and log["overflow_events"] == 1
    assert [tuple(x) for x in log["losses"]] == rep.losses
    assert os.path.exists(os.path.join(out, "train_metrics.jsonl"))


def test_fit_paper_adc_mode_trains():
    """fit() with adc_mode='paper' runs the uv-tap step, accumulates
    view-space statistics, densifies, and reduces the loss."""
    scene = make_scene(None, n=96, seed_offset=31)
    params = {k: torch.from_numpy(scene[k]) for k in PARAM_KEYS}
    cfg = gt.RenderConfig(height=64, width=64, max_pairs=4096)
    target = dict(params)
    target["f_dc"] = target["f_dc"] + 0.4
    with torch.no_grad():
        img, _ = gt.render_from_params(target, scene["c2w"], 60.0, 58.0,
                                       32.5, 31.5, cfg)
    batch = {"image": img.numpy()[None], "c2w": scene["c2w"][None],
             "fx": np.asarray([60.0], np.float32),
             "fy": np.asarray([58.0], np.float32),
             "cx": np.asarray([32.5], np.float32),
             "cy": np.asarray([31.5], np.float32)}
    tcfg = gt.TrainConfig(
        iterations=24, batch_size=1, capacity=256,
        adc_mode="paper", densification_interval=6, densify_until_iter=8,
        densify_grad_threshold=1e-5,  # low bar so spawns happen
        opacity_reset_interval=10_000, checkpoint_interval=10_000,
    )
    pts = np.concatenate([scene["pos"], scene["f_dc"]], -1)
    state, report = tfit.fit(_iterate([batch]), cfg, tcfg,
                             initial_points=pts, log_every=5,
                             log_fn=lambda s: None, device="cpu")
    assert np.isfinite(report.final_loss)
    post_adc = [v for it, v in report.losses if it >= 10]
    assert report.final_loss <= min(post_adc[0], 2.0 * report.losses[0][1])
    assert int(state.pool.num_alive()) != 96  # paper ADC changed the pool


def test_fit_auto_grows_pair_capacity():
    """A tiny max_pairs is grown from the observed demand (overflow
    reported, run completes)."""
    pts, batches = _scene()
    logs = []
    tcfg = gt.TrainConfig(iterations=6, batch_size=2, capacity=128,
                          densification_interval=10_000,
                          opacity_reset_interval=10_000,
                          checkpoint_interval=10_000)
    _, report = tfit.fit(
        _iterate(batches),
        gt.RenderConfig(height=H, width=W, max_pairs=128, pair_block=32),
        tcfg, initial_points=pts, log_every=2, log_fn=logs.append,
        device="cpu")
    assert report.overflow_events >= 1
    assert any("growing max_pairs" in m for m in logs), logs
    assert np.isfinite(report.final_loss)


def test_fit_auto_grows_pool_capacity():
    """ADC spawn overflow grows the pool, and densification lands
    gaussians past the original capacity."""
    pts, batches = _scene()
    logs = []
    cap0 = 64  # the 48-point cloud nearly fills it
    tcfg = gt.TrainConfig(iterations=30, batch_size=2, capacity=cap0,
                          densification_interval=10, densify_until_iter=30,
                          max_grad=1e-9, opacity_reset_interval=10_000,
                          checkpoint_interval=10_000)
    state, _ = tfit.fit(
        _iterate(batches),
        gt.RenderConfig(height=H, width=W, max_pairs=4096, pair_block=32),
        tcfg, initial_points=pts, log_every=10, log_fn=logs.append,
        device="cpu")
    assert state.pool.capacity > cap0, "pool capacity never grew"
    assert any("growing pool capacity" in m for m in logs)
    assert int(state.pool.num_alive()) > cap0


def test_resumed_fit_ends_where_the_run_ends(tmp_path):
    """8 iterations in one run, and 4 + a resume from the iteration-4
    checkpoint for 4 more on the same batches: the same final state."""
    pts, batches = _scene()
    cfg = gt.RenderConfig(height=H, width=W, max_pairs=4096, pair_block=32)
    tcfg = gt.TrainConfig(iterations=8, batch_size=2, capacity=64,
                          densification_interval=10_000,
                          opacity_reset_interval=6, checkpoint_interval=4)
    out = str(tmp_path / "a")
    full, rep = tfit.fit(_iterate(batches), cfg, tcfg, output_dir=out,
                         initial_points=pts, log_every=4,
                         log_fn=lambda s: None, device="cpu")
    ckpt4 = os.path.join(out, "checkpoint_000004.npz")
    assert rep.checkpoints == [ckpt4, os.path.join(out, "checkpoint_000008.npz"),
                               os.path.join(out, "checkpoint_final.npz")]
    it = _iterate(batches)
    for _ in range(4):
        next(it)
    logs = []
    resumed, _ = tfit.fit(it, cfg, tcfg, initial_points=pts[:5],
                          resume_from=ckpt4, log_every=4, log_fn=logs.append,
                          device="cpu")
    assert any("resumed from" in m and "at step 4" in m for m in logs)
    assert int(resumed.step) == int(full.step) == 8
    for k in PARAM_KEYS:
        assert torch.equal(getattr(resumed.pool, k), getattr(full.pool, k)), k
        a = resumed.opt_state.state[getattr(resumed.pool, k)]
        b = full.opt_state.state[getattr(full.pool, k)]
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[f], b[f]), (k, f)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    pts, batches = _scene(n=8)
    cfg = gt.RenderConfig(height=H, width=W, max_pairs=1024)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfit.fit(_iterate(batches), cfg, gt.TrainConfig(capacity=16),
                 initial_points=pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gt.init_pool_from_points(pts, 16)
    dense = {k: np.zeros((2,) + s, np.float32) for k, s in (
        ("pos", (3,)), ("opacity_raw", ()), ("f_dc", (3,)),
        ("f_rest", (45,)), ("scale_raw", (3,)), ("q_raw", (4,)))}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pool_from_dense(dense, 4)
    # The bench asset's recipe: before it makes its workdir.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_bench_asset.main([str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("max_pairs", [2**20, 2**22])
def test_memory_estimates_match_jax(max_pairs):
    """The estimate fit() logs when it grows max_pairs keeps the JAX
    package's keys at the JAX package's values (one view per render),
    exactly; its ``total_mb`` is the port's own footprint
    (tests/test_torch_memory.py), not JAX's."""
    from gsplat_tpu.utils.memory import (estimate_render_memory as jrender,
                                         estimate_train_memory as jtrain)
    from gsplat_tpu_torch.utils.memory import (estimate_render_memory,
                                               estimate_train_memory)

    kw = dict(height=540, width=960, max_pairs=max_pairs)
    tkw = dict(capacity=131072, batch_size=4)
    want = jrender(gj.RenderConfig(**kw), 119981)
    got = estimate_render_memory(gt.RenderConfig(**kw), 119981)
    keys = set(want) - {"total_mb"}
    assert len(keys) == 4
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    want = jtrain(gj.RenderConfig(**kw),
                  gj.TrainConfig(**tkw, batched_render=False))
    got = estimate_train_memory(gt.RenderConfig(**kw), gt.TrainConfig(**tkw))
    keys = set(want) - {"total_mb"}
    assert len(keys) == 7
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
