"""Cases and rules shared by the card tests (``tests/test_torch_gpu*.py``)
and their CPU rehearsals (``tests/test_torch_card_cases.py``).

The bench checkpoint at its bench pose, the training workload built from it
(the bench pose and three orbit poses, ground truth rendered from the
checkpoint, the start perturbed), ``fit()``'s four runs with their record of
each step and density control, and the density control's outcome written
from its rules rather than from ``models/adc.py``. The card tests call them
at full size; the CPU rehearsals on a slice of the checkpoint at a small
size, where the launch counters and the memory model are not read.

Imports neither JAX nor the suite's conftest.
"""

import dataclasses
import functools
import importlib
import os

import numpy as np
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
from gsplat_tpu_torch.ops import raster_cuda
from gsplat_tpu_torch.profile_stages import bench_pose
from gsplat_tpu_torch.viewer import create_orbit_trajectory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "bench_assets", "trained_ckpt.npz")
# K2 against its plain version, rows 0-9, relative to each row's max abs.
BWD_TOL = 1e-5
# The memory model (utils.memory) against a run's own peak.
MEMORY_TOL = 0.25
# The training workload: the reference's training resolution, batch 4.
TRAIN_H, TRAIN_W = 540, 960
TRAIN_PAIRS = 2**21
TRAIN_BATCH = 4
FIT_ITERS = 12


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def camera(width, height):
    """(fx, fy, cx, cy) of the bench's camera at this size."""
    f = 0.85 * width
    return f, f, width / 2.0, height / 2.0


def checkpoint(dev, slots=None):
    """The bench checkpoint on ``dev`` (its first ``slots`` slots, dead
    ones among them), its bench pose and the orbit around it: (pool, c2w,
    center, radius)."""
    pool = gt.restore_pool(CKPT, device=dev)
    if slots is not None:
        pool = gt.GaussianPool({k: v.detach()[:slots].clone()
                                for k, v in pool.params.items()},
                               pool.alive[:slots].clone())
    c2w, center, radius = bench_pose(pool)
    return pool, c2w, center, radius


def orbit(c2w, center, radius, frames=8, scale=4.4):
    """The bench pose and an orbit of ``frames`` poses at 15 degrees."""
    return np.concatenate([c2w[None], create_orbit_trajectory(
        center, scale * radius, num_frames=frames, elevation_deg=15.0)])


def train_views(pool, bench_c2w, center, radius, height=TRAIN_H,
                width=TRAIN_W, max_pairs=TRAIN_PAIRS, views=TRAIN_BATCH):
    """The training workload: (cfg, a batch of the bench pose and
    ``views - 1`` orbit poses with ground truth rendered from the
    unperturbed pool, the pool's parameters as numpy with f_dc and
    opacity_raw + N(0, 0.1))."""
    dev = pool.pos.device
    cfg = gt.RenderConfig(height=height, width=width, max_pairs=max_pairs)
    fx, fy, cx, cy = camera(width, height)
    poses = bench_c2w[None].astype(np.float32)
    if views > 1:
        poses = np.concatenate([poses, create_orbit_trajectory(
            center, 4.4 * radius, num_frames=views - 1,
            elevation_deg=15.0)]).astype(np.float32)
    with torch.no_grad():
        images = torch.stack([gt.render_from_params(
            pool.params, p, fx, fy, cx, cy, cfg, alive=pool.alive)[0]
            for p in poses])
    batch = {"image": images, "c2w": torch.from_numpy(poses).to(dev)}
    for k, v in (("fx", fx), ("fy", fy), ("cx", cx), ("cy", cy)):
        batch[k] = torch.full((views,), v, device=dev)
    rng = np.random.default_rng(0)
    start = {k: v.detach().cpu().numpy() for k, v in pool.params.items()}
    for k in ("f_dc", "opacity_raw"):
        start[k] = start[k] + rng.normal(0, 0.1, start[k].shape).astype(
            np.float32)
    return cfg, batch, start


def tensor_bytes(*ts) -> int:
    """Bytes of the tensors (dicts and lists of them too)."""
    n = 0
    for t in ts:
        if isinstance(t, dict):
            n += tensor_bytes(*t.values())
        elif isinstance(t, (list, tuple)):
            n += tensor_bytes(*t)
        elif torch.is_tensor(t):
            n += t.numel() * t.element_size()
    return n


def memory_ratio(other, est, dev=None) -> float:
    """The memory model's estimate ``est`` (a dict of ``utils.memory``)
    over a run's own peak: ``torch.cuda.max_memory_allocated`` since the
    last reset, less ``other``, what the device held that the run does
    not own."""
    return est["total_mb"] * 1e6 / (torch.cuda.max_memory_allocated(dev)
                                    - other)


def counts():
    """K1's and K2's launch counts ("cumprod" forms; K1 reading the
    gathered pair list, as a recorded render does; a frame that autograd
    does not record counts in ``indexed_launches``)."""
    cp = raster_cuda.composite_pairs
    return cp.launches, cp.bwd_launches


def zero_counts():
    cp = raster_cuda.composite_pairs
    for k in ("launches", "bwd_launches", "log_launches", "bwd_log_launches",
              "bwd_compact_launches", "indexed_launches"):
        setattr(cp, k, 0)


# --- fit() and its record ----------------------------------------------------

def state_snapshot(state) -> dict:
    """Clones of everything a checkpoint holds: step, alive, the six
    parameters, and each leaf's Adam step count and moments."""
    snap = {"step": state.step.clone(), "alive": state.pool.alive.clone()}
    for k, p in state.pool.params.items():
        st = state.opt_state.state[p]
        snap[k] = p.detach().clone()
        for f in ("step", "exp_avg", "exp_avg_sq"):
            snap[f"{k}.{f}"] = st[f].clone()
    return snap


class FitRecord:
    """Inside, ``fit()``'s names (make_train_step, adc_step,
    adc_step_paper) are wrapped to record: the max_pairs of each step fit()
    builds, each step's (iteration, pair demand, pair capacity), the last
    step's metrics, the state after step ``snapshot_at``, and each density
    control's (iteration, capacity before it, result)."""

    def __init__(self, snapshot_at=None):
        self.fit = importlib.import_module("gsplat_tpu_torch.train.fit")
        self.snapshot_at = snapshot_at
        self.max_pairs, self.demand, self.adc = [], [], []
        self.steps = 0
        self.last_metrics = self.snapshot = None

    def __enter__(self):
        mod = self.fit
        self.real = (mod.make_train_step, mod.adc_step, mod.adc_step_paper)

        def make(render_cfg, train_cfg):
            self.max_pairs.append(render_cfg.max_pairs)
            step = self.real[0](render_cfg, train_cfg)

            def recorded(state, batch):
                state, m = step(state, batch)
                self.steps += 1
                self.demand.append((self.steps, int(m["pair_demand"]),
                                    int(m["pair_capacity"])))
                self.last_metrics = m
                if self.steps == self.snapshot_at:
                    self.snapshot = state_snapshot(state)
                return state, m
            return recorded

        def adc(fn):
            def recorded(state, *args, **kw):
                cap = state.pool.capacity
                state, res = fn(state, *args, **kw)
                self.adc.append((self.steps, cap, res))
                return state, res
            return recorded

        mod.make_train_step = make
        mod.adc_step, mod.adc_step_paper = adc(self.real[1]), adc(self.real[2])
        return self

    def __exit__(self, *exc):
        (self.fit.make_train_step, self.fit.adc_step,
         self.fit.adc_step_paper) = self.real
        return False


def repeat(batch):
    while True:
        yield batch


def fit_configs(capacity, radius, iters=FIT_ITERS, batch=TRAIN_BATCH):
    """The four runs' TrainConfigs: (a) the reference ADC at the JAX
    defaults; (b) as (a) with max_grad 1e-9, so that the pool must grow;
    (c) the paper ADC; (d) as (a), run from a max_pairs below a view's
    demand, so that max_pairs must grow."""
    common = dict(iterations=iters, batch_size=batch, capacity=capacity,
                  checkpoint_interval=6)
    ref = dict(common, densification_interval=4, densify_until_iter=12,
               opacity_reset_interval=8)
    return {
        "a": gt.TrainConfig(**ref),
        "b": gt.TrainConfig(**ref, max_grad=1e-9),
        "c": gt.TrainConfig(**common, adc_mode="paper",
                            densify_grad_threshold=2e-4,
                            scene_extent=float(radius), max_screen_size=0,
                            densification_interval=6, densify_until_iter=12,
                            opacity_reset_interval=10**9),
        "d": gt.TrainConfig(**ref),
    }


def fit_run(name, tcfg, cfg, batch, points, start_ckpt, out_dir):
    """One fit() run from ``start_ckpt`` on ``batch`` repeated, with the
    launch counts set to 0 just before it and, on a card, the peak memory
    stats reset. Returns {state, report, rec, lines, k1, k2, other (what
    the device held that the run does not own), cfg (at the final
    max_pairs), iters, views (a batch's)}."""
    dev = batch["image"].device
    card = dev.type == "cuda"
    lines = []
    sync(dev)
    other = 0
    if card:
        other = torch.cuda.memory_allocated(dev) - tensor_bytes(batch)
        torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    with FitRecord(snapshot_at=6 if name == "a" else None) as rec:
        state, report = rec.fit.fit(
            repeat(batch), cfg, tcfg, output_dir=out_dir,
            initial_points=points, resume_from=start_ckpt, log_every=2,
            log_fn=lines.append, device=dev)
    k1, k2 = counts()
    sync(dev)
    return dict(state=state, report=report, rec=rec, lines=lines, k1=k1,
                k2=k2, other=other, cfg=cfg.with_(max_pairs=rec.max_pairs[-1]),
                iters=tcfg.iterations, views=batch["c2w"].shape[0])


def check_fit_run(name, res, cfg, cap0):
    """The checks of runs (a)-(d): finite losses, no skipped step, every
    iteration run; on a card K1 and K2 launched views x iterations times;
    (a), (c): the final loss below the first logged after the last
    densification; (b): the pool grew past its capacity; (d): max_pairs
    grew and the last step's demand fits it; (b), (d): wherever a logged
    iteration's pair demand exceeded its capacity, fit() logged the
    overflow and grew max_pairs."""
    state, report, rec, lines = (res["state"], res["report"], res["rec"],
                                 res["lines"])
    losses = [v for _, v in report.losses]
    assert all(np.isfinite(losses)), (name, report.losses)
    assert report.nonfinite_steps == 0, name
    assert len(rec.demand) == res["iters"], name
    if state.pool.pos.device.type == "cuda":
        views = res["iters"] * res["views"]
        assert res["k1"] == res["k2"] == views, (name, res["k1"], res["k2"])
    if name in ("a", "c"):
        last = max(it for it, _, _ in rec.adc)
        after = [v for it, v in report.losses if it > last][0]
        assert report.final_loss < after, (name, report.losses, last)
    if name == "b":
        assert report.overflow_events >= 1, name
        assert any("growing pool capacity" in m for m in lines), lines
        assert state.pool.capacity > cap0 and report.num_gaussians > cap0
    if name == "d":
        assert rec.max_pairs[-1] > cfg.max_pairs, rec.max_pairs
        assert rec.demand[-1][1] <= rec.demand[-1][2], rec.demand
    if name in ("b", "d"):
        logged = {it for it, _ in report.losses}
        for it, d, c in rec.demand:
            if it in logged and d > c:
                assert any(m.startswith(f"iter {it}: pair overflow")
                           and "growing max_pairs" in m for m in lines), it


# --- the density control's outcome, from its rules --------------------------

def expected_spawns(before, prune, split, clone, child, parent=None):
    """What an ADC call must write, from its masks and child rows as the
    rule defines them: the r-th spawner in slot order takes the r-th slot
    that is free after pruning, spawners past the free slots are dropped.
    Returns (parents, children, overflowed, reset mask, {param: (slots,
    rows)}): each child slot holds its parent's child row; with ``parent``
    (the paper split's child A), each fitting split's own slot holds that
    row."""
    alive = before["alive"] & ~prune
    spawners = torch.nonzero(split | clone)[:, 0]
    free = torch.nonzero(~alive)[:, 0]
    k = min(len(spawners), len(free))
    parents, children = spawners[:k], free[:k]
    reset = prune.clone()
    reset[children] = True
    rows = {key: (children, child[key][parents]) for key in child}
    if parent is not None:
        rep = parents[split[parents]]
        reset[rep] = True
        for key, v in parent.items():
            rows[key] = (torch.cat([children, rep]),
                         torch.cat([rows[key][1], v[rep]]))
    return parents, children, len(spawners) - k, reset, rows


def reference_spawns(before, grad, noise, tcfg):
    """The reference form's masks and child rows (reference
    train.py:89-195): prune below the opacity threshold; among the
    survivors with a gradient norm above max_grad, split the large (one
    child at pos + noise * scale * 0.1, scale_raw - 0.5) and clone the
    small (an exact copy)."""
    g = grad if grad.dim() == 1 else torch.sqrt(
        grad[:, 0] * grad[:, 0] + grad[:, 1] * grad[:, 1]
        + grad[:, 2] * grad[:, 2])
    prune = before["alive"] & (
        torch.sigmoid(before["opacity_raw"]) < tcfg.prune_opacity_threshold)
    alive = before["alive"] & ~prune
    scales = torch.exp(before["scale_raw"])
    big = torch.amax(scales, dim=-1) > tcfg.scale_threshold
    high = g > tcfg.max_grad
    split, clone = alive & big & high, alive & ~big & high
    child = {k: before[k] for k in PARAM_KEYS}
    child["pos"] = before["pos"] + torch.where(
        split[:, None], noise * scales * 0.1, 0.0)
    child["scale_raw"] = before["scale_raw"] - torch.where(
        split[:, None], 0.5, 0.0)
    return expected_spawns(before, prune, split, clone, child)


def paper_spawns(before, avg_uv, rad, noise, tcfg):
    """The paper form's masks and child rows (Kerbl et al. 2023, 5.2): a
    split writes pos + R (eps_b * scales) to a free slot and pos + R
    (eps_a * scales) over its parent, both with the scales / 1.6; a clone
    writes a copy."""
    from gsplat_tpu_torch.ops.gaussian import quat_to_rotmat

    scales = torch.exp(before["scale_raw"])
    max_scale = torch.amax(scales, dim=-1)
    alive0 = before["alive"]
    prune = alive0 & (torch.sigmoid(before["opacity_raw"]) < tcfg.min_opacity)
    if tcfg.max_screen_size > 0:
        prune |= alive0 & (rad > tcfg.max_screen_size)
        prune |= alive0 & (max_scale > 0.1 * tcfg.scene_extent)
    alive = alive0 & ~prune
    big = max_scale > tcfg.percent_dense * tcfg.scene_extent
    high = avg_uv >= tcfg.densify_grad_threshold
    split, clone = alive & big & high, alive & ~big & high
    q = before["q_raw"]
    R = quat_to_rotmat(q / (torch.linalg.vector_norm(q, dim=-1,
                                                     keepdim=True) + 1e-12))
    pos = before["pos"]
    scale_raw = before["scale_raw"] - torch.log(torch.tensor(
        1.6, dtype=torch.float32, device=pos.device))
    child = {k: before[k] for k in PARAM_KEYS}
    child["pos"] = torch.where(split[:, None], pos + (
        R * (noise[1] * scales)[:, None, :]).sum(-1), pos)
    child["scale_raw"] = torch.where(split[:, None], scale_raw,
                                     before["scale_raw"])
    parent = {"pos": pos + (R * (noise[0] * scales)[:, None, :]).sum(-1),
              "scale_raw": scale_raw}
    return expected_spawns(before, prune, split, clone, child, parent)


def check_adc_identities(state, call, expect):
    """One direct ADC call on ``state`` against ``expect(before)``
    (reference_spawns or paper_spawns on the state before the call, with
    the call's noise): it must spawn; its counts, new_slot_mask and every
    written row are what the rule gives (positions within 1e-6 of their
    largest value, since the paper form's rotation is summed in another
    order; the rest exact); alive after = before - pruned + split +
    cloned; exp_avg and exp_avg_sq exactly 0 on new_slot_mask and
    unchanged elsewhere, step counts unchanged; every parameter row
    outside new_slot_mask unchanged."""
    before = state_snapshot(state)
    parents, children, overflow, reset, rows = expect(before)
    state, res = call()
    pool = state.pool
    n0, n1 = int(before["alive"].sum()), int(pool.alive.sum())
    pruned, split, cloned, overflowed = (int(getattr(res, f)) for f in (
        "num_pruned", "num_split", "num_cloned", "num_overflowed"))
    mask = res.new_slot_mask
    kept = ~mask
    spawned = split + cloned
    assert n1 == n0 - pruned + spawned
    assert spawned > 0 and spawned == len(children)
    assert overflowed == overflow
    assert torch.equal(mask, reset)
    for k, p in pool.params.items():
        st = state.opt_state.state[p]
        for f in ("exp_avg", "exp_avg_sq"):
            assert bool((st[f][mask] == 0).all()), (k, f)
            assert torch.equal(st[f][kept], before[f"{k}.{f}"][kept]), (k, f)
        assert torch.equal(st["step"], before[f"{k}.step"]), k
        assert torch.equal(p.detach()[kept], before[k][kept]), k
        slots, want = rows[k]
        got = p.detach()[slots]
        if k == "pos":
            assert float((got - want).abs().max()) <= 1e-6 * max(
                1.0, float(want.abs().max()))
        else:
            assert torch.equal(got, want), k


def uv_statistics(state, batch, cfg, tcfg, plain=False):
    """(uv_grad_sum, visible, max_radius) of one paper-mode step on
    ``state`` without its update; with ``plain`` the backward compositor
    is its plain version in place of K2."""
    from gsplat_tpu_torch.train.trainer import value_and_grads

    real = raster_cuda.composite_pairs_bwd
    if plain:
        raster_cuda.composite_pairs_bwd = functools.partial(
            raster_cuda.composite_pairs_bwd_plain, block_chunk=256)
    try:
        _, m, _ = value_and_grads(state, batch, cfg, tcfg)
    finally:
        raster_cuda.composite_pairs_bwd = real
    sync(batch["image"].device)
    return m["uv_grad_sum"], m["visible"], m["max_radius"]


def check_fit_runs(pool, batch, start, cfg, radius, tmp, d_pairs,
                   memory=None):
    """fit() four times from one checkpoint that save_checkpoint wrote (the
    perturbed pool, a fresh optimizer state), FIT_ITERS iterations on
    ``batch`` repeated: :func:`fit_configs`' runs (a)-(d), (d) from
    ``d_pairs`` max_pairs, each held by :func:`check_fit_run`; then (a)'s
    iteration-6 checkpoint loaded into a fresh state equal to the state
    after step 6 bit for bit; one adc_step_paper and one adc_step (at (b)'s
    max_grad, so that it spawns) on the state (a) returned, held to their
    rules by :func:`check_adc_identities`; and one paper step's
    uv_grad_sum on (c)'s state through K2 within BWD_TOL of its largest
    value of the plain backward compositor's, visible and max_radius
    equal. ``memory(run, cfg, tcfg)`` is called after run (a)."""
    from gsplat_tpu_torch.train import trainer

    dev = pool.pos.device
    views = batch["c2w"].shape[0]
    runs = fit_configs(pool.capacity, radius, batch=views)
    points = pool.pos.detach()[pool.alive].cpu().numpy()
    start_ckpt = os.path.join(tmp, "start.npz")
    trainer.save_checkpoint(start_ckpt, gt.init_train_state(
        gt.pool_from_numpy(start, pool.alive.cpu().numpy(), device=dev),
        runs["a"]))
    paper = None
    for name, tcfg in runs.items():
        rcfg = cfg.with_(max_pairs=d_pairs) if name == "d" else cfg
        res = fit_run(name, tcfg, rcfg, batch, points, start_ckpt,
                      os.path.join(tmp, name))
        if name == "a" and memory is not None:
            memory(res, rcfg, tcfg)
        check_fit_run(name, res, rcfg, pool.capacity)
        if name == "a":
            check_fit_a(res, runs, batch, dev)
        if name == "c":
            paper = res
        del res

    uv_k, vis_k, rad_k = uv_statistics(paper["state"], batch, paper["cfg"],
                                       runs["c"])
    uv_p, vis_p, rad_p = uv_statistics(paper["state"], batch, paper["cfg"],
                                       runs["c"], plain=True)
    scale = float(uv_p.abs().max())
    assert scale > 0
    assert float((uv_k - uv_p).abs().max()) <= BWD_TOL * scale
    assert torch.equal(vis_k, vis_p) and torch.equal(rad_k, rad_p)


def check_fit_a(res, runs, batch, dev):
    """Run (a)'s iteration-6 checkpoint equals the state after step 6; the
    direct density controls on the state it returned follow their rules."""
    from gsplat_tpu_torch.train import trainer

    state, report, rec = res["state"], res["report"], res["rec"]
    path = next(c for c in report.checkpoints if c.endswith("000006.npz"))
    fresh = gt.init_train_state(gt.init_pool_from_points(
        np.zeros((4, 3), np.float32), 8, device=dev), runs["a"])
    loaded = state_snapshot(trainer.load_checkpoint(path, fresh))
    assert loaded.keys() == rec.snapshot.keys()
    for k, v in rec.snapshot.items():
        assert torch.equal(loaded[k], v), k
    # The paper call first, on (a)'s state as it came back; then the
    # reference call with (b)'s max_grad, so that it spawns (at (a)'s
    # max_grad it only prunes).
    gen = torch.Generator(device=dev).manual_seed(1)
    uv, vis, rad = uv_statistics(state, batch, res["cfg"], runs["c"])
    avg = uv / torch.clamp(vis, min=1).to(torch.float32)
    eps = tuple(torch.randn(state.pool.pos.shape, generator=gen, device=dev)
                for _ in range(2))
    check_adc_identities(
        state, lambda: trainer.adc_step_paper(state, avg, rad, None,
                                              runs["c"], noise=eps),
        lambda b: paper_spawns(b, avg, rad, eps, runs["c"]))
    tcfg = runs["b"]
    grad = rec.last_metrics["pos_grad"]
    noise = torch.randn(state.pool.pos.shape, generator=gen, device=dev)
    check_adc_identities(
        state, lambda: trainer.adc_step(
            state, grad, None, (tcfg.prune_opacity_threshold, tcfg.max_grad,
                                tcfg.scale_threshold), noise=noise),
        lambda b: reference_spawns(b, grad, noise, tcfg))


def grown_bwd_pairs(demand):
    """bwd_pairs as fit() grows it from an observed demand: 1.25 x the
    demand, rounded up to 1,024."""
    return -(-int(demand * 1.25) // 1024) * 1024


def rup(x):
    """--auto_pairs' sizing (render_trained.py): the demand + 20 %, rounded
    up to 4,096."""
    return max(4096, -(-int(x * 1.2) // 4096) * 4096)


def image_from_tiles(out, tile_count, cfg):
    """[num_tiles, 8, P] compositor output -> [H, W, 3] image, as
    rasterize_binned assembles it."""
    t = cfg.tile
    occ = (tile_count > 0)[:, None, None]
    rgb = torch.where(occ, out[:, 0:3], 0.0)
    img = rgb.reshape(cfg.tiles_y, cfg.tiles_x, 3, t, t).permute(
        0, 3, 1, 4, 2).reshape(cfg.padded_height, cfg.padded_width, 3)
    return torch.clamp(img[: cfg.height, : cfg.width], 0.0, 1.0)


def memory_est(cfg, tcfg, capacity=None):
    from gsplat_tpu_torch.utils.memory import estimate_train_memory

    if capacity is not None:
        tcfg = dataclasses.replace(tcfg, capacity=capacity)
    return estimate_train_memory(cfg, tcfg)
