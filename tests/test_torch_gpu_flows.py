"""The port's entry points on a CUDA card at full size.

The bench checkpoint (131,072 slots) served at 1920x1080 from its bench
pose and an 8-pose orbit, with the serving levers; trained at 960x540 in
batches of 4 (``make_train_step``, ``fit()`` with both density controls and
every growth), evaluated, traced and measured; the dataset flow through
the CLIs a user runs; the (data, tile) grid and the gaussian-sharded step
of four gloo ranks sharing the card; the bench asset's recipe in full; the
bench. Each run's launches are counted from 0 just before it, and where a
run's peak is gated the memory model (``utils.memory``) must lie within 25
% of it.

Needs a card; every test here skips without one. It imports neither JAX
nor the suite's conftest (the GPU machine has no JAX), so run it with

    python -m pytest --noconftest tests/test_torch_gpu_flows.py -m gpu

Tolerances: a served frame against the plain compositor's image 2e-5;
K2 against its plain version 1e-5 of each row's largest value; the xla
compositor against K1 2e-5 (depth: of its largest value; alpha where K1's
final T stays above ``transmittance_min``), its gradients 5e-4 of each
leaf's largest; the ellipse cull against rect JAX's own bounds
(tests/test_binning_ellipse.py: image and alpha 2e-6, depth 2e-5,
gradients 5e-5 of each leaf's largest). The four-rank grids: see
``GRID_*`` below.
"""

import importlib
import os
import shutil
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as gt
import torch_card_cases as C
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
from gsplat_tpu_torch.ops import raster_cuda as tras
from gsplat_tpu_torch.profile_stages import (bench_pose, record_backward,
                                             serving_path)
from gsplat_tpu_torch.viewer import (create_orbit_trajectory,
                                     make_batch_render_fn, make_render_fn,
                                     render_trajectory)

pytestmark = pytest.mark.gpu

H, W = 1080, 1920
MAX_PAIRS = 2**22
TOL = 2e-5
TRAIN_STEPS = 6
LEVER_CAP = 1024  # tile_rank_cap of the serving levers (the README's K)
LEVER_CHUNKS = 64  # their cull_chunks (the JAX default)
CLOSE_PAIRS = 2**24  # --max_pairs of the bucketed close-in orbit
ELL_IMG_TOL, ELL_DEPTH_TOL, ELL_GRAD_TOL = 2e-6, 2e-5, 5e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return gt.resolve_device("cuda")


@pytest.fixture(scope="module")
def bench(cuda):
    """The checkpoint at 1080p: its bench pose, the orbit, the camera."""
    pool, c2w, center, radius = C.checkpoint(cuda)
    return SimpleNamespace(
        pool=pool, c2w=c2w, center=center, radius=radius,
        traj=C.orbit(c2w, center, radius), cam=C.camera(W, H),
        cfg=gt.RenderConfig(height=H, width=W, max_pairs=MAX_PAIRS))


@pytest.fixture(scope="module")
def train(bench):
    """The training workload at 960x540, batch 4."""
    cfg, batch, start = C.train_views(bench.pool, bench.c2w, bench.center,
                                      bench.radius)
    return SimpleNamespace(cfg=cfg, batch=batch, start=start)


@pytest.fixture(scope="module")
def lever(bench):
    """The rank truncation at the bench pose (tile_rank_cap LEVER_CAP,
    LEVER_CHUNKS depth chunks): its config, the pair demand with the
    occlusion cull, the truncated demand, the pairs it keeps."""
    pool = bench.pool
    cfg_t = bench.cfg.with_(tile_rank_cap=LEVER_CAP, cull_chunks=LEVER_CHUNKS)
    demand = _demand(bench, bench.c2w, cfg_t)
    cfg_b = cfg_t.with_(trunc_pairs=C.rup(demand[2]))
    with torch.no_grad():
        aux = gt.render_from_params(pool.params, bench.c2w, *bench.cam,
                                    cfg_b, alive=pool.alive)[1]
    return SimpleNamespace(cfg=cfg_t, demand=demand[0], trunc=demand[2],
                           kept=int(aux.num_pairs_kept))


def _demand(bench, c2w, cfg):
    from gsplat_tpu_torch.render import pair_demand

    with torch.no_grad():
        return tuple(int(x) for x in pair_demand(
            bench.pool.params, c2w, *bench.cam, cfg, alive=bench.pool.alive))


def _gate_memory(other, est, dev=None):
    ratio = C.memory_ratio(other, est, dev)
    assert abs(ratio - 1.0) <= C.MEMORY_TOL, ratio


class BinCalls:
    """Counts ``bin_gaussians`` calls on the serving and training paths
    (``render`` and ``ops.rasterize`` look it up by name) and the binning
    kernels' launches while inside: each kernel must launch once a call
    (the emission once a rect call)."""

    def __enter__(self):
        from gsplat_tpu_torch.ops import binning

        self.mods = [importlib.import_module(f"gsplat_tpu_torch.{m}")
                     for m in ("render", "ops.rasterize")]
        self.real = binning.bin_gaussians
        self.calls = self.rect = 0

        def counted(proj, cfg):
            self.calls += 1
            self.rect += cfg.cull_mode == "rect"
            return self.real(proj, cfg)

        for mod in self.mods:
            mod.bin_gaussians = counted
        for f in (binning.emit_pairs, binning.sort_pairs, binning.align_pairs):
            f.launches = 0
        return self

    def __exit__(self, *exc):
        from gsplat_tpu_torch.ops import binning

        for mod in self.mods:
            mod.bin_gaussians = self.real
        self.launches = [binning.emit_pairs.launches,
                         binning.sort_pairs.launches,
                         binning.align_pairs.launches]
        return False

    def check(self):
        assert self.calls > 0
        assert self.launches == [self.rect, self.calls, self.calls], (
            self.launches, self.rect, self.calls)


def _fwd_bwd(pool, c2w, cam, cfg, reps):
    """``reps`` fwd+bwd of render_from_params (loss mean(im) + mean(im^2))
    after a warm-up: one K1 and one K2 launch a call, finite gradients,
    the dead slots' 0. Returns (the leaves with their gradients, what
    autograd handed K2 on the last call and what K2 returned)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in pool.params.items()}
    seen = {}
    real = tras.composite_pairs_bwd

    def seen_bwd(*args, **kw):
        seen["args"] = tuple(a.detach() if isinstance(a, torch.Tensor)
                             else a for a in args)
        seen["d"] = real(*args, **kw)
        return seen["d"]

    def call():
        for p in params.values():
            p.grad = None
        img, _ = gt.render_from_params(params, c2w, *cam, cfg,
                                       alive=pool.alive)
        (torch.mean(img) + torch.mean(img * img)).backward()

    tras.composite_pairs_bwd = seen_bwd
    try:
        call()
        torch.cuda.synchronize()
        k = C.counts()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    finally:
        tras.composite_pairs_bwd = real
    n1, n2 = (b - a for a, b in zip(k, C.counts()))
    assert n1 == n2 == reps
    dead = ~pool.alive
    for name, p in params.items():
        assert torch.isfinite(p.grad).all(), name
        assert bool((p.grad[dead] == 0).all()), name
    return params, seen


def _rel_err(d_k, d_p):
    """Max over rows 0-9 of |kernel - plain| / the row's max |plain|."""
    rel = []
    for r in range(10):
        scale = float(d_p[r].abs().max())
        err = float((d_k[r] - d_p[r]).abs().max())
        rel.append(err / scale if scale > 0 else (0.0 if err == 0 else 1.0))
    return max(rel)


# --- serving ------------------------------------------------------------------

def test_serving_the_bench_orbit_at_1080p(bench):
    """restore_pool -> make_render_fn -> render_trajectory over the bench
    pose and the orbit: one K1 launch a rendered frame, each binning
    kernel once a binned frame; the served bench-pose frame within 2e-5 of
    the plain compositor's image; the memory model within 25 % of the
    run's own peak (the pool counted as the run's)."""
    from gsplat_tpu_torch.utils.memory import estimate_render_memory

    pool, cfg, cam = bench.pool, bench.cfg, bench.cam
    sp = serving_path(pool.params, bench.c2w, *cam, cfg, alive=pool.alive)
    b = sp["bin"]
    plain = C.image_from_tiles(tras.composite_pairs_plain(
        sp["pair_feat"], b.tile_start, b.tile_count, cfg, tile_chunk=1024),
        b.tile_count, cfg)
    del sp, b
    render_fn = make_render_fn(pool.params, cfg, *cam, alive=pool.alive,
                               report_demand=True)
    calls, served = [0], {}

    def counted(pose):
        calls[0] += 1
        img, probe = render_fn(pose)
        served.setdefault("first", img)  # the warm-up frame: bench pose
        return img, probe

    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - C.tensor_bytes(pool.params,
                                                           pool.alive)
    torch.cuda.reset_peak_memory_stats()
    C.zero_counts()
    with BinCalls() as bins:
        _, stats = render_trajectory(counted, bench.traj, keep_frames=False,
                                     pair_capacity=cfg.max_pairs)
    cp = tras.composite_pairs
    launches = cp.indexed_launches
    _gate_memory(other, estimate_render_memory(cfg, pool.capacity))
    assert launches == calls[0] >= len(bench.traj)
    assert cp.launches == 0  # no pair list is gathered
    bins.check()
    assert bins.calls >= calls[0]
    img = served["first"]
    assert tuple(img.shape) == (H, W, 3) and torch.isfinite(img).all()
    assert float((img - plain).abs().max()) <= TOL
    assert 0.0 < float(img.mean()) < 1.0


def test_log_transmittance_on_the_main_path(bench):
    """transmittance_math="log" served over the bench pose and the orbit
    and one fwd+bwd: K1-log reading the table twice a served pose (the
    warm-up and the pipelined pass) and once for the trajectory's warm-up,
    the fwd+bwd's K1-log reading the pair list, K2-log once, finite
    gradients, no overflow."""
    pool, cam = bench.pool, bench.cam
    cfg_l = bench.cfg.with_(transmittance_math="log")
    C.zero_counts()
    render_fn = make_render_fn(pool.params, cfg_l, *cam, alive=pool.alive,
                               report_demand=True)
    _, stats = render_trajectory(render_fn, bench.traj, keep_frames=False,
                                 pair_capacity=cfg_l.max_pairs)
    leaves, _ = record_backward(pool.params, bench.c2w, *cam, cfg_l,
                                pool.alive)
    torch.cuda.synchronize()
    assert all(torch.isfinite(p.grad).all() for p in leaves.values())
    assert tras.composite_pairs.indexed_launches == 2 * len(bench.traj) + 1
    assert tras.composite_pairs.log_launches == 1
    assert tras.composite_pairs.bwd_log_launches == 1
    assert stats["pair_overflow_frames"] == 0


def test_truncation_at_the_bench_pose(bench, lever):
    """The rank truncation (tile_rank_cap 1024, 64 depth chunks): the
    occlusion cull lowers the demand and leaves the image bit for bit with
    the pairs kept equal; served over the orbit with capacities sized as
    --auto_pairs sizes them and one fwd+bwd: K1 once a frame (reading the
    table) and once in the fwd+bwd (the pair list), K2 once, finite
    gradients, no overflow."""
    pool, cam, cfg = bench.pool, bench.cam, bench.cfg
    nocull = _demand(bench, bench.c2w, lever.cfg.with_(occlusion_cull=False))
    assert lever.demand < nocull[0]
    cfg_b = lever.cfg.with_(trunc_pairs=C.rup(lever.trunc))
    with torch.no_grad():
        img_on, aux_on = gt.render_from_params(pool.params, bench.c2w, *cam,
                                               cfg_b, alive=pool.alive)
        img_off, aux_off = gt.render_from_params(
            pool.params, bench.c2w, *cam, cfg_b.with_(occlusion_cull=False),
            alive=pool.alive)
    assert torch.equal(img_on, img_off)
    assert int(aux_on.num_pairs_kept) == int(aux_off.num_pairs_kept)
    assert int(aux_on.num_pairs) < int(aux_off.num_pairs)
    dem = [_demand(bench, c, lever.cfg) for c in bench.traj]
    cfg_auto = lever.cfg.with_(
        max_pairs=min(C.rup(max(d[0] for d in dem)), cfg.max_pairs),
        trunc_pairs=C.rup(max(d[2] for d in dem)))
    lever_fn = make_render_fn(pool.params, cfg_auto, *cam, alive=pool.alive,
                              report_demand=True)
    C.zero_counts()
    runs = [render_trajectory(lever_fn, bench.traj, keep_frames=False,
                              pair_capacity=cfg.max_pairs)[1]
            for _ in range(2)]
    leaves, _ = record_backward(pool.params, bench.c2w, *cam, cfg_b,
                                pool.alive)
    torch.cuda.synchronize()
    k1, k2 = C.counts()
    served = tras.composite_pairs.indexed_launches
    assert all(torch.isfinite(p.grad).all() for p in leaves.values())
    assert served == 2 * (2 * len(bench.traj) + 1), served
    assert k1 == 1 and k2 == 1, (k1, k2)
    assert all(r["pair_overflow_frames"] == 0 for r in runs)


def test_bucketed_close_in_orbit(bench):
    """render_trained --orbit_scale 1.0 --num_frames 8 --tile_rank_cap 1024
    --bucket_pairs 4 --max_pairs 2**24: eight frames, K1 at least once a
    frame; at every pose the served frame finite and an exact render sized
    to the pose's demand within its capacity."""
    from gsplat_tpu_torch import render_trained

    pool, cam, cfg = bench.pool, bench.cam, bench.cfg
    C.zero_counts()
    stats = render_trained.main([
        "--checkpoint", C.CKPT, "--num_frames", "8", "--orbit_scale", "1.0",
        "--tile_rank_cap", str(LEVER_CAP), "--cull_chunks",
        str(LEVER_CHUNKS), "--bucket_pairs", "4", "--max_pairs",
        str(CLOSE_PAIRS), "--benchmark_only"])
    assert tras.composite_pairs.indexed_launches >= 8
    assert stats["frames"] == 8
    traj = create_orbit_trajectory(bench.center, bench.radius * 1.0,
                                   num_frames=8, elevation_deg=15.0)
    for i in np.argsort(stats["frame_demand"])[::-1]:
        cfg_r = stats["rung_cfgs"][stats["rung_of_frame"][i]]
        exact = _demand(bench, traj[i], cfg)[0]
        cfg_x = cfg.with_(max_pairs=C.rup(exact))
        with torch.no_grad():
            img_t, _ = gt.render_from_params(pool.params, traj[i], *cam,
                                             cfg_r, alive=pool.alive)
            _, aux_x = gt.render_from_params(pool.params, traj[i], *cam,
                                             cfg_x, alive=pool.alive)
        assert torch.isfinite(img_t).all(), i
        assert int(aux_x.num_pairs) <= cfg_x.max_pairs, i


def test_batched_serving_at_1080p(bench):
    """make_batch_render_fn, 4 poses a launch, over the bench pose and the
    orbit (the last batch padded): its bench-pose frame within 1e-5 of
    make_render_fn's, one K1 launch a batch (and the warm-up's); and
    render_trained --render_batch 4 over the orbit: 8 frames, 3 launches;
    no overflow."""
    from gsplat_tpu_torch import render_trained

    pool, cam, cfg, traj = bench.pool, bench.cam, bench.cfg, bench.traj
    B = 4
    with torch.no_grad():
        first = make_render_fn(pool.params, cfg, *cam,
                               alive=pool.alive)(bench.c2w)
    fn = make_batch_render_fn(pool.params, cfg, *cam, alive=pool.alive,
                              batch=B, report_demand=True)
    assert float((fn(traj[:B])[0][0] - first).abs().max()) <= 1e-5
    C.zero_counts()
    _, st = render_trajectory(fn, traj, batch_size=B, keep_frames=False,
                              pair_capacity=B * cfg.max_pairs)
    assert tras.composite_pairs.indexed_launches == -(-len(traj) // B) + 1
    assert st["pair_overflow_frames"] == 0
    C.zero_counts()
    cli = render_trained.main([
        "--checkpoint", C.CKPT, "--num_frames", "8", "--orbit_scale", "4.4",
        "--render_batch", str(B), "--max_pairs", str(cfg.max_pairs),
        "--benchmark_only"])
    assert tras.composite_pairs.indexed_launches == 8 // B + 1
    assert cli["pair_overflow_frames"] == 0 and cli["frames"] == 8


@pytest.mark.parametrize("flags", [["--auto_pairs"], ["--bucket_pairs", "4"]],
                         ids=["auto_pairs", "bucket_pairs"])
def test_render_trained_with_the_ellipse_cull(bench, flags):
    """render_trained --cull_mode ellipse over the 8-frame orbit, sized by
    the demand and bucketed: K1 at least once a frame, rows seen, no
    overflow."""
    from gsplat_tpu_torch import render_trained

    C.zero_counts()
    st = render_trained.main([
        "--checkpoint", C.CKPT, "--benchmark_only", "--num_frames", "8",
        "--orbit_scale", "4.4", "--max_pairs", str(MAX_PAIRS),
        "--cull_mode", "ellipse"] + flags)
    assert tras.composite_pairs.indexed_launches >= 8
    assert st["pair_overflow_frames"] == 0 and st["max_rows_seen"] > 0


# --- fwd+bwd -------------------------------------------------------------------

def test_fwd_bwd_at_1080p(bench):
    """Five fwd+bwd of render_from_params at the bench pose: one K1 and one
    K2 launch a call, finite gradients, the dead slots' 0."""
    _fwd_bwd(bench.pool, bench.c2w, bench.cam, bench.cfg, reps=5)


def test_ellipse_against_rect_at_1080p(bench):
    """cull_mode="ellipse" at the bench pose against rect: the image
    within 2e-6, depth within 2e-5, alpha within 2e-6 where rect's final
    T stays above transmittance_min (elsewhere K1 stops the tile at a
    block boundary, which the shorter list moves: there the ellipse's
    alpha must be saturated); a fwd+bwd each way, every leaf's gradient
    within 5e-5 of its largest of rect's, and K2 on what autograd handed
    it on the ellipse list within 1e-5 of its plain version."""
    pool, cam, cfg = bench.pool, bench.cam, bench.cfg
    ecfg = cfg.with_(cull_mode="ellipse")
    with torch.no_grad():
        img_r, aux_r = gt.render_from_params(pool.params, bench.c2w, *cam,
                                             cfg, alive=pool.alive)
        img_e, aux_e = gt.render_from_params(pool.params, bench.c2w, *cam,
                                             ecfg, alive=pool.alive)
    assert float((img_e - img_r).abs().max()) <= ELL_IMG_TOL
    assert float((aux_e.depth - aux_r.depth).abs().max()) <= ELL_DEPTH_TOL
    live = aux_r.alpha < 1.0 - cfg.transmittance_min
    assert float((aux_e.alpha - aux_r.alpha)[live].abs().max()) \
        <= ELL_IMG_TOL
    assert float(aux_e.alpha[~live].min()) \
        >= 1.0 - cfg.transmittance_min - ELL_IMG_TOL
    assert aux_e.row_capacity == ecfg.row_capacity
    grads = {}
    for m, c in (("rect", cfg), ("ellipse", ecfg)):
        params, seen = _fwd_bwd(pool, bench.c2w, cam, c, reps=2)
        grads[m] = {k: p.grad for k, p in params.items()}
    d_p = tras.composite_pairs_bwd_plain(*seen["args"], block_chunk=256)
    assert _rel_err(seen["d"], d_p) <= C.BWD_TOL
    for k in PARAM_KEYS:
        err = float((grads["ellipse"][k] - grads["rect"][k]).abs().max())
        assert err <= ELL_GRAD_TOL * max(
            float(grads["rect"][k].abs().max()), 1e-30), k


# --- training -------------------------------------------------------------------

def _batch_bwd_pairs(bench, train):
    """bwd_pairs grown from the training batch's demand, batched, on the
    checkpoint (as fit() grows it)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in bench.pool.params.items()}
    b = train.batch
    img, aux = gt.render_batch_from_params(
        params, b["c2w"], b["fx"], b["fy"], b["cx"], b["cy"], train.cfg,
        alive=bench.pool.alive)
    (torch.mean(img) + torch.mean(img * img)).backward()
    return C.grown_bwd_pairs(int(aux.bwd_demand))


@pytest.mark.parametrize("form", ["per_view", "batched", "batched_bwd_pairs"])
def test_train_steps_at_960x540(bench, train, form):
    """Six train steps from the perturbed checkpoint, batch 4 at 960x540,
    with the launch counts set to 0 first: the loss falls, no step is
    skipped, no overflow, the memory model within 25 % of the steps' own
    peak. One view at a time: K1 and K2 once a view, each binning kernel
    once a binned view, U1 and U2 once each a step, the dead slots
    unmoved. Batched (``batched_render``), without and with the compacted
    backward (bwd_pairs grown from the batch's demand): one K1 launch a
    step, and one K2 launch a step in the form the step asks for."""
    from gsplat_tpu_torch.ops.update import adam_update

    pool, batch = bench.pool, train.batch
    batched = form != "per_view"
    rcfg = train.cfg
    if form == "batched_bwd_pairs":
        rcfg = rcfg.with_(bwd_pairs=_batch_bwd_pairs(bench, train))
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - C.tensor_bytes(batch)
    tpool = gt.pool_from_numpy(train.start, pool.alive.cpu().numpy(),
                               device=pool.pos.device)
    tcfg = gt.TrainConfig(capacity=tpool.capacity, batch_size=C.TRAIN_BATCH,
                          densification_interval=10**9,
                          opacity_reset_interval=10**9,
                          batched_render=batched)
    state = gt.init_train_state(tpool, tcfg)
    step = gt.make_train_step(rcfg, tcfg)
    dead = ~tpool.alive
    dead_before = {k: v.detach()[dead].clone()
                   for k, v in tpool.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    C.zero_counts()
    adam_update.launches = 0
    metrics = []
    with BinCalls() as bins:
        for _ in range(TRAIN_STEPS):
            state, m = step(state, batch)
            metrics.append(m)
    torch.cuda.synchronize()
    cp = tras.composite_pairs
    n = {c: getattr(cp, c) for c in ("launches", "bwd_launches",
                                     "bwd_compact_launches")}
    _gate_memory(other, C.memory_est(rcfg, tcfg))
    losses = [float(m["total"]) for m in metrics]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert [int(m["nonfinite_skipped"]) for m in metrics] == [0] * TRAIN_STEPS
    for m in metrics:
        assert int(m["pair_demand"]) <= int(m["pair_capacity"])
        if batched:
            assert int(m.get("bwd_demand", 0)) \
                <= int(m.get("bwd_capacity", 0))
    if not batched:
        views = C.TRAIN_BATCH * TRAIN_STEPS
        assert n["launches"] == n["bwd_launches"] == views, n
        assert bins.calls >= views
        bins.check()
        assert adam_update.launches == 2 * TRAIN_STEPS
        for k, v in tpool.params.items():
            assert torch.equal(v.detach()[dead], dead_before[k]), k
    else:
        compact = rcfg.bwd_pairs > 0
        assert n == dict(launches=TRAIN_STEPS,
                         bwd_launches=0 if compact else TRAIN_STEPS,
                         bwd_compact_launches=TRAIN_STEPS if compact else 0)


def test_fit_runs_at_960x540(bench, train, tmp_path):
    """fit() at full width, four runs of 12 iterations on the training
    batch from the perturbed checkpoint (``torch_card_cases.
    check_fit_runs``): the reference and paper density controls, the pool
    grown past its capacity, max_pairs grown from 2**20 (below a view's
    1.2 M pairs); the iteration-6 checkpoint, the density control's rules
    on (a)'s state, uv_grad_sum through K2 against the plain backward;
    the memory model within 25 % of run (a)'s own peak (the test's
    step-6 snapshot counted as held by others)."""
    def memory(res, rcfg, tcfg):
        _gate_memory(res["other"] + C.tensor_bytes(res["rec"].snapshot),
                     C.memory_est(res["cfg"], tcfg,
                                  res["state"].pool.capacity))

    C.check_fit_runs(bench.pool, train.batch, train.start, train.cfg,
                     bench.radius, str(tmp_path), C.TRAIN_PAIRS // 2,
                     memory=memory)


@pytest.mark.parametrize("grown", ["bwd_pairs", "max_rows"])
def test_fit_grows_a_starved_capacity(bench, train, grown, tmp_path):
    """fit() of 12 iterations from the perturbed checkpoint with one
    capacity far below the batch's demand: batched with bwd_pairs 1,024
    and the reference density control (one K1 and one compact K2 launch
    an iteration), or with the ellipse cull from max_rows 4,096 (K1 and K2
    once a view, max_rows grown once). The overflow is logged and grows
    the capacity, the last step's demand fits, the losses stay finite, no
    step is skipped."""
    from gsplat_tpu_torch.train import trainer

    pool, batch, B = bench.pool, train.batch, C.TRAIN_BATCH
    iters = C.FIT_ITERS
    if grown == "bwd_pairs":
        tcfg = gt.TrainConfig(iterations=iters, batch_size=B,
                              capacity=pool.capacity,
                              checkpoint_interval=10**9,
                              densification_interval=4, densify_until_iter=12,
                              opacity_reset_interval=8, batched_render=True)
        rcfg = train.cfg.with_(bwd_pairs=1024)
    else:
        tcfg = gt.TrainConfig(iterations=iters, batch_size=B,
                              capacity=pool.capacity,
                              checkpoint_interval=10**9,
                              densification_interval=10**9,
                              opacity_reset_interval=10**9)
        rcfg = train.cfg.with_(cull_mode="ellipse", max_rows=4096)
    ckpt = str(tmp_path / "start.npz")
    trainer.save_checkpoint(ckpt, gt.init_train_state(gt.pool_from_numpy(
        train.start, pool.alive.cpu().numpy(), device=pool.pos.device),
        tcfg))
    lines = []
    C.zero_counts()
    with C.FitRecord() as rec:
        state, report = rec.fit.fit(
            C.repeat(batch), rcfg, tcfg,
            initial_points=pool.pos.detach()[pool.alive].cpu().numpy(),
            resume_from=ckpt, log_every=2, log_fn=lines.append,
            device=pool.pos.device)
    cp = tras.composite_pairs
    n = {c: getattr(cp, c) for c in ("launches", "bwd_launches",
                                     "bwd_compact_launches")}
    m = rec.last_metrics
    assert all(np.isfinite([v for _, v in report.losses]))
    assert report.nonfinite_steps == 0
    if grown == "bwd_pairs":
        assert [x for x in lines if "growing bwd_pairs" in x], lines
        assert n == dict(launches=iters, bwd_launches=0,
                         bwd_compact_launches=iters), n
        assert int(m["bwd_demand"]) <= int(m["bwd_capacity"])
    else:
        assert len([x for x in lines if "growing max_rows" in x]) == 1, lines
        assert n["launches"] == n["bwd_launches"] == B * iters, n
        assert int(m["row_demand"]) <= int(m["row_capacity"])


# --- the training levers ---------------------------------------------------------

def _grads(pool, cfg, c2w, fx, fy, cx, cy, batched=False):
    """One fwd+bwd (loss mean(im) + mean(im^2)) of render_from_params, or
    batched of render_batch_from_params over the poses: (aux, {leaf:
    gradient})."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in pool.params.items()}
    render = gt.render_batch_from_params if batched else gt.render_from_params
    img, aux = render(params, c2w, fx, fy, cx, cy, cfg, alive=pool.alive)
    (torch.mean(img) + torch.mean(img * img)).backward()
    return aux, {k: p.grad for k, p in params.items()}


def test_compacted_backward_at_the_bench_pose(bench, train):
    """K2 in compact mode on what autograd handed K2 at the 1080p bench
    pose, bwd_pairs grown from the demand as fit() grows it: within 1e-5
    of its plain version, zeros past the kept blocks, two launches bit for
    bit, the kept columns equal to K2's, as many blocks kept as
    composited; the gradients with that bwd_pairs equal to bwd_pairs = 0's
    bit for bit (the bench pose, and the training batch batched); at half
    the demand the overflow reported and the gradients finite."""
    pool, cam, cfg = bench.pool, bench.cam, bench.cfg
    _, seen = _fwd_bwd(pool, bench.c2w, cam, cfg, reps=1)
    bargs = seen["args"]
    G = cfg.pair_block
    nb = bargs[0].shape[1] // G
    out, ts = bargs[3], bargs[1]
    demand = int(torch.where(bargs[2] > 0, out[:, 5, 0], 0.0).sum()) * G
    bp = C.grown_bwd_pairs(demand)
    kb = min(-(-bp // G), nb)
    d_full = tras.composite_pairs_bwd(*bargs)
    d_k = tras.composite_pairs_bwd(*bargs, kb=kb)
    d_k2 = tras.composite_pairs_bwd(*bargs, kb=kb)
    d_p = tras.composite_pairs_bwd_plain(*bargs, block_chunk=256, kb=kb)
    blk, _, _, valid = tras.composited_blocks(ts, tras.tile_block_offsets(out),
                                              kb, cfg)
    kept = int(valid.sum())
    cols = (blk[valid, None] * G + torch.arange(G, device=blk.device)
            ).reshape(-1)
    torch.cuda.synchronize()
    assert _rel_err(d_k, d_p) <= C.BWD_TOL
    assert bool((d_k[:, kept * G:] == 0).all())
    assert torch.equal(d_k, d_k2)
    assert torch.equal(d_k[:, :kept * G], d_full[:, cols])
    assert kept == demand // G
    del seen, bargs, d_full, d_k, d_k2, d_p
    _, g0 = _grads(pool, cfg, bench.c2w, *cam)
    aux_s, gs = _grads(pool, cfg.with_(bwd_pairs=bp), bench.c2w, *cam)
    assert int(aux_s.bwd_demand) <= aux_s.bwd_capacity
    for k in g0:
        assert torch.equal(g0[k], gs[k]), k
    aux_h, g_h = _grads(pool, cfg.with_(bwd_pairs=demand // 2), bench.c2w,
                        *cam)
    assert int(aux_h.bwd_demand) > aux_h.bwd_capacity
    assert all(torch.isfinite(v).all() for v in g_h.values())
    b = train.batch
    args = (b["c2w"], b["fx"], b["fy"], b["cx"], b["cy"])
    aux_b0, gb0 = _grads(pool, train.cfg, *args, batched=True)
    _, gbs = _grads(pool, train.cfg.with_(bwd_pairs=C.grown_bwd_pairs(
        int(aux_b0.bwd_demand))), *args, batched=True)
    for k in gb0:
        assert torch.equal(gb0[k], gbs[k]), k


def test_training_batch_as_one_list(bench, train):
    """The training batch's four views stacked into one list
    (view_tile_rows = a view's tile rows): K1's image of each view equal
    bit for bit to one K1 launch on that view's own list from the same
    projections, and render_batch_from_params within 1e-5 of the per-view
    renders, within its pair capacity."""
    from gsplat_tpu_torch.ops.binning import bin_gaussians
    from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
    from gsplat_tpu_torch.ops.projection import (ProjectedGaussians,
                                                 project_gaussians)
    from gsplat_tpu_torch.ops.rasterize import _gather, _pair_features
    from gsplat_tpu_torch.ops.sh import evaluate_sh
    from gsplat_tpu_torch.render import stack_view_projections

    pool, batch, cfg = bench.pool, train.batch, train.cfg
    p, B = pool.params, batch["c2w"].shape[0]

    def binned(proj, colors, c):
        b = bin_gaussians(proj, c)
        feat10 = _pair_features(proj, colors, torch.float32)[
            b.depth_order.long()]
        pf = _gather(feat10, b.pair_slot)
        return C.image_from_tiles(tras.composite_pairs(
            pf, b.tile_start, b.tile_count, c), b.tile_count, c)

    with torch.no_grad():
        cov = build_cov3d_packed(p["scale_raw"], p["q_raw"])
        projs = [project_gaussians(
            p["pos"], cov, p["opacity_raw"], batch["c2w"][v], batch["fx"][v],
            batch["fy"][v], batch["cx"][v], batch["cy"][v], cfg,
            extra_valid=pool.alive) for v in range(B)]
        colors = [evaluate_sh(p["f_dc"], p["f_rest"], p["pos"],
                              batch["c2w"][v]) for v in range(B)]
        stacked, bcfg = stack_view_projections(
            ProjectedGaussians(*(torch.stack(f) for f in zip(*projs))), cfg)
        img_b = binned(stacked, torch.cat(colors), bcfg).reshape(
            B, cfg.padded_height, cfg.width, 3)[:, :cfg.height]
        for v in range(B):
            assert torch.equal(binned(projs[v], colors[v], cfg), img_b[v]), v
        imgs, aux = gt.render_batch_from_params(
            p, batch["c2w"], batch["fx"], batch["fy"], batch["cx"],
            batch["cy"], cfg, alive=pool.alive)
        for v in range(B):
            one = gt.render_from_params(
                p, batch["c2w"][v], batch["fx"][v], batch["fy"][v],
                batch["cx"][v], batch["cy"][v], cfg, alive=pool.alive)[0]
            assert float((imgs[v] - one).abs().max()) <= 1e-5, v
    assert int(aux.num_pairs) <= aux.pair_capacity


# --- the xla compositor, evaluation, traces and the measuring tools ---------------

def test_xla_compositor_at_full_size(bench):
    """backend="xla" (plain PyTorch on the card) at the 1080p bench pose
    with max_per_tile at its largest tile against K1's frame (itself equal
    to make_render_fn's): image within 2e-5, depth within 2e-5 of its
    largest value, alpha within 2e-5 where K1's final T stays above
    transmittance_min and saturated elsewhere; K1 with tile_rank_cap 1024
    against "xla" with max_per_tile 1024 within 2e-5 at the bench pose and
    at the close-in orbit's pose of highest demand; a fwd+bwd through
    "xla" against one through K1 and K2 at 960x540, each leaf within 5e-4
    of its largest."""
    pool, cam, cfg = bench.pool, bench.cam, bench.cfg
    with torch.no_grad():
        img_k, aux_k = gt.render_from_params(pool.params, bench.c2w, *cam,
                                             cfg, alive=pool.alive)
        served = make_render_fn(pool.params, cfg, *cam,
                                alive=pool.alive)(bench.c2w)
        K = int(aux_k.max_tile_count)
        img_x, aux_x = gt.render_from_params(
            pool.params, bench.c2w, *cam,
            cfg.with_(backend="xla", max_per_tile=K), alive=pool.alive)
    assert torch.equal(img_k, served)
    assert float((img_x - img_k).abs().max()) <= TOL
    live = aux_k.alpha < 1.0 - cfg.transmittance_min
    assert float((aux_x.alpha - aux_k.alpha)[live].abs().max()) <= TOL
    assert float(aux_x.alpha[~live].min()) \
        >= 1.0 - cfg.transmittance_min - TOL
    assert float((aux_x.depth - aux_k.depth).abs().max()) \
        <= TOL * max(1.0, float(aux_k.depth.abs().max()))
    assert aux_x.bwd_demand is None and aux_x.per_tile_capacity == K
    del img_k, aux_k, img_x, aux_x, served

    cfg_t = cfg.with_(tile_rank_cap=LEVER_CAP, cull_chunks=LEVER_CHUNKS)
    close = create_orbit_trajectory(bench.center, bench.radius * 1.0,
                                    num_frames=8, elevation_deg=15.0)
    top = close[int(np.argmax([_demand(bench, c, cfg_t)[0] for c in close]))]
    for pose, exact in ((bench.c2w, None),
                        (top, _demand(bench, top, cfg)[0])):
        pd, _, td = _demand(bench, pose, cfg_t)
        k_cfg = cfg_t.with_(max_pairs=max(cfg.max_pairs, C.rup(pd)),
                            trunc_pairs=C.rup(td))
        x_cfg = cfg.with_(backend="xla", max_per_tile=LEVER_CAP)
        if exact is not None:
            x_cfg = x_cfg.with_(max_pairs=C.rup(exact))
        with torch.no_grad():
            img_t, aux_t = gt.render_from_params(pool.params, pose, *cam,
                                                 k_cfg, alive=pool.alive)
            img_c, aux_c = gt.render_from_params(pool.params, pose, *cam,
                                                 x_cfg, alive=pool.alive)
        assert float((img_t - img_c).abs().max()) <= TOL
        assert int(aux_c.num_pairs) <= x_cfg.max_pairs
        assert int(aux_t.trunc_demand) <= aux_t.trunc_capacity
        del img_t, img_c, aux_t, aux_c

    th, tw = C.TRAIN_H, C.TRAIN_W
    tcfg = gt.RenderConfig(height=th, width=tw, max_pairs=C.TRAIN_PAIRS)
    gen = torch.Generator(device=pool.pos.device).manual_seed(2)
    tgt = torch.rand(th, tw, 3, generator=gen, device=pool.pos.device)
    grads, kg = {}, 0
    for name in ("kernels", "xla"):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in pool.params.items()}
        # xla composites as many pairs a tile as K1's largest tile holds.
        c = tcfg if name == "kernels" else tcfg.with_(backend="xla",
                                                      max_per_tile=kg)
        img, aux = gt.render_from_params(p, bench.c2w, *C.camera(tw, th), c,
                                         alive=pool.alive)
        (torch.mean(torch.abs(img - tgt)) + torch.mean(img * img)).backward()
        grads[name] = {k: v.grad for k, v in p.items()}
        kg = kg or int(aux.max_tile_count)
    for k in PARAM_KEYS:
        scale = float(grads["xla"][k].abs().max()) + 1e-12
        assert float((grads["kernels"][k] - grads["xla"][k]).abs().max()) \
            <= 5e-4 * scale, k


def test_evaluation_of_the_training_views(bench, train):
    """evaluate_views on the training batch's views (ground truth the
    unperturbed checkpoint): the perturbed pool scores higher after six
    train steps; the checkpoint against its own renders above 100 dB;
    render_batch=4 against per view within 1e-3 dB and L1 1e-6; from
    max_pairs 2**18 auto_size grows to the demand and reproduces the
    sized PSNR within 1e-3 dB."""
    from gsplat_tpu_torch.evaluation import evaluate_views

    pool, batch, cfg = bench.pool, train.batch, train.cfg
    alive = pool.alive
    views = [{"image": batch["image"][i], "c2w": batch["c2w"][i],
              **{k: float(batch[k][i]) for k in ("fx", "fy", "cx", "cy")}}
             for i in range(batch["c2w"].shape[0])]
    tpool = gt.pool_from_numpy(train.start, alive.cpu().numpy(),
                               device=alive.device)
    r_before = evaluate_views(tpool.params, views, cfg, alive=alive)
    tcfg = gt.TrainConfig(capacity=tpool.capacity, batch_size=C.TRAIN_BATCH,
                          densification_interval=10**9,
                          opacity_reset_interval=10**9)
    state = gt.init_train_state(tpool, tcfg)
    step = gt.make_train_step(cfg, tcfg)
    for _ in range(TRAIN_STEPS):
        state, _ = step(state, batch)
    trained = {k: v.detach() for k, v in tpool.params.items()}
    r_after = evaluate_views(trained, views, cfg, alive=alive)
    r_self = evaluate_views(pool.params, views, cfg, alive=alive)
    r_b4 = evaluate_views(trained, views, cfg, alive=alive, render_batch=4)
    r_auto = evaluate_views(trained, views, cfg.with_(max_pairs=2**18),
                            alive=alive)
    assert r_after["psnr"] > r_before["psnr"]
    assert min(v["psnr"] for v in r_self["per_view"]) > 100.0
    for a, b, c in zip(r_after["per_view"], r_b4["per_view"],
                       r_auto["per_view"]):
        assert abs(a["psnr"] - b["psnr"]) <= 1e-3
        assert abs(a["l1"] - b["l1"]) <= 1e-6
        assert abs(a["psnr"] - c["psnr"]) <= 1e-3
    assert r_auto["eval_max_pairs"] >= r_auto["max_pair_demand"] > 2**18


def _kernel_events(summary, name):
    return sum(c for k, (c, _) in summary["by_kernel"].items() if name in k)


def test_traces_hold_the_counted_kernels(bench, tmp_path):
    """One served frame and one fwd+bwd at the 1080p bench pose, each
    traced (utils.profiling.trace) after a warm-up: the trace holds kernel
    events, as many K1 and K2 events as their counts (one K1 each); then
    one frame traced under the program's spans (profile_trace.
    trace_stages): every launch of a leaf span has its device record in
    the trace, and K1 two; the stages run as P1 (two events, the served
    frame's one launch in ``gs.project``), with no ``gs.cov_sh``."""
    from gsplat_tpu_torch.profile_trace import STAGES, trace_stages
    from gsplat_tpu_torch.utils.profiling import summarize_trace, trace

    pool, cam, cfg = bench.pool, bench.cam, bench.cfg
    render_fn = make_render_fn(pool.params, cfg, *cam, alive=pool.alive)

    def fwd_bwd():
        p = {k: v.detach().requires_grad_(True)
             for k, v in pool.params.items()}
        img, _ = gt.render_from_params(p, bench.c2w, *cam, cfg,
                                       alive=pool.alive)
        (torch.mean(img) + torch.mean(img * img)).backward()

    cp = tras.composite_pairs

    def counts():  # K1 reading the table (served) or the list, and K2
        return cp.indexed_launches + cp.launches, cp.bwd_launches

    for fn in (lambda: render_fn(bench.c2w), fwd_bwd):
        fn()  # warm-up, outside the trace
        torch.cuda.synchronize()
        before = counts()
        with trace(str(tmp_path)) as prof:
            fn()
            torch.cuda.synchronize()
        n1, n2 = (b - a for a, b in zip(before, counts()))
        s = summarize_trace(prof.chrome_trace_path)
        assert s["kernels"] > 0 and n1 == 1
        assert _kernel_events(s, "raster_fwd_kernel") == n1
        assert _kernel_events(s, "raster_bwd_kernel") == n2
    st = trace_stages(pool.params, bench.c2w, *cam, cfg, pool.alive,
                      str(tmp_path))
    assert "gs.cov_sh" not in st["ranges"]
    ranges = [st["ranges"][k] for k in STAGES if k != "gs.cov_sh"]
    launched = sum(r["launches"] for r in ranges)
    assert sum(r["kernels"] for r in ranges) == launched > 0
    assert _kernel_events(st, "raster_fwd_kernel") == 2
    assert _kernel_events(st, "preprocess_kernel") == 2
    assert st["ranges"]["gs.project"]["launches"] == 1


def test_measuring_clis_at_the_bench_pose(bench, lever):
    """The measuring CLIs through their mains: profile_stages exact and
    with the lever (tile_rank_cap 1024, --auto_pairs), profile_binning,
    cull_sweep (at 64 chunks the bench pose's demand and kept pairs those
    of the serving path with the lever), and the truncation ladder at 4
    close-in poses with K in {1024, 4096}, each pose's full-frame exact
    render within its capacity."""
    from gsplat_tpu_torch import (cull_sweep, profile_binning,
                                  profile_stages, trunc_error_ladder)

    pool, cam, cfg = bench.pool, bench.cam, bench.cfg
    for extra in ([], ["--tile_rank_cap", str(LEVER_CAP), "--auto_pairs"]):
        profile_stages.main(["--checkpoint", C.CKPT] + extra)
    profile_binning.main(["--checkpoint", C.CKPT])
    at64 = cull_sweep.main(["--checkpoint", C.CKPT])["bench(4.4x)"]
    assert at64["chunks"][LEVER_CHUNKS]["demand"] == lever.demand
    assert at64["kept"] == lever.kept
    lad = trunc_error_ladder.main(["--checkpoint", C.CKPT, "--caps", "1024",
                                   "4096"])
    for i, pose in enumerate(lad["poses"]):
        cfg_x = cfg.with_(max_pairs=C.rup(lad["exact_demand"][i]))
        with torch.no_grad():
            _, aux = gt.render_from_params(pool.params, pose, *cam, cfg_x,
                                           alive=pool.alive)
        assert int(aux.num_pairs) <= cfg_x.max_pairs, i


# --- the dataset flow through the CLIs --------------------------------------------

SCENE_VIEWS = 24
SCENE_PAIRS = 2**21  # the train CLI's max_pairs
SCENE_ITERS, SCENE_INTERVAL = 60, 20
RANGE_ITERS = 4


@pytest.fixture(scope="module")
def prepared(bench, tmp_path_factory):
    """A Mip-NeRF-360-layout raw scene: 24 views of the checkpoint at
    1920x1080 around the bench orbit (elevations 10 and 20 degrees) as
    PNG, poses_bounds.npy and sparse/0/points3D.bin holding the alive
    means and their DC colours; prepare_dataset mipnerf on it. Returns the
    directory of the runs and the prepared scene's."""
    from gsplat_tpu_torch import prepare_dataset
    from gsplat_tpu_torch.data.images import save_image

    pool, cfg = bench.pool, bench.cfg
    root = str(tmp_path_factory.mktemp("scene"))
    raw = os.path.join(root, "raw")
    os.makedirs(os.path.join(raw, "images"))
    os.makedirs(os.path.join(raw, "sparse", "0"))
    f = bench.cam[0]
    poses = np.concatenate([create_orbit_trajectory(
        bench.center, 4.4 * bench.radius, num_frames=SCENE_VIEWS // 2,
        elevation_deg=e) for e in (10.0, 20.0)]).astype(np.float32)
    render = make_render_fn(pool.params, cfg, *bench.cam, alive=pool.alive)
    for i, c2w in enumerate(poses):
        save_image(os.path.join(raw, "images", f"{i:03d}.png"),
                   render(c2w).cpu().numpy())
    # OpenCV (right, down, forward) -> LLFF (down, right, back) columns.
    llff = np.stack([poses[:, :3, 1], poses[:, :3, 0], -poses[:, :3, 2],
                     poses[:, :3, 3], np.tile([H, W, f], (len(poses), 1))],
                    axis=2)
    np.save(os.path.join(raw, "poses_bounds.npy"), np.concatenate(
        [llff.reshape(len(poses), 15), np.tile([0.1, 100.0],
                                               (len(poses), 1))], 1))
    alive = pool.alive.cpu().numpy()
    xyz = pool.pos.detach().cpu().numpy()[alive].astype(np.float64)
    rgb = 1.0 / (1.0 + np.exp(-pool.f_dc.detach().cpu().numpy()[alive]
                              * 0.28209479177387814))
    rec = np.zeros(xyz.shape[0], np.dtype([
        ("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
        ("track", "<u8")]))
    rec["id"] = np.arange(xyz.shape[0])
    rec["xyz"] = xyz
    rec["rgb"] = np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)
    with open(os.path.join(raw, "sparse", "0", "points3D.bin"), "wb") as fh:
        fh.write(np.uint64(xyz.shape[0]).tobytes())
        fh.write(rec.tobytes())
    prep = os.path.join(root, "prepared")
    info = prepare_dataset.main(["mipnerf", "--input_dir", raw,
                                 "--output_dir", prep, "--downsample", "1"])
    assert info["num_images"] == SCENE_VIEWS
    assert info["num_points"] == int(pool.alive.sum())
    return SimpleNamespace(root=root, prep=prep)


def _check_dataset_fit(state, report, rec, k1, k2, iters, interval):
    """A dataset run's checks: finite losses, no skipped step, every
    iteration run, K1 and K2 launched views x iterations times, a density
    control ran, and the last logged loss below the first logged after the
    last density control before the end (when there is one)."""
    losses = [v for _, v in report.losses]
    assert all(np.isfinite(losses)) and report.nonfinite_steps == 0
    assert k1 == k2 == C.TRAIN_BATCH * iters, (k1, k2)
    assert rec.steps == iters and len(rec.adc) >= 1
    last = max(range(interval, iters, interval), default=None)
    if last is not None:
        after = [v for it, v in report.losses if it > last][0]
        assert losses[-1] < after, (report.losses, last)


def test_train_cli_and_the_tools_on_a_prepared_scene(bench, prepared):
    """python -m gsplat_tpu_torch.train (its main) from the prepared point
    cloud with the device image cache (21 views after holdout 8),
    capacity 131,072, max_pairs 2**21, 60 iterations at 960x540, batch 4,
    the paper's density control every 20; the final checkpoint read by
    restore_pool equal to the pool; then evaluate and
    eval_checkpoint over the 3 held-out views, inference --trajectory (4
    frames), render_trained --render_training_views --export_ply
    --export_splat, the PLY read back equal to the pool."""
    import contextlib
    import io

    from gsplat_tpu_torch import (eval_checkpoint, evaluate, inference,
                                  render_trained)
    from gsplat_tpu_torch.data import GaussianDataset
    from gsplat_tpu_torch.data.gsply import import_gaussians_ply
    from gsplat_tpu_torch.train.__main__ import main as train_main

    prep, root = prepared.prep, prepared.root
    out = io.StringIO()
    C.zero_counts()
    with C.FitRecord() as rec, contextlib.redirect_stdout(out):
        state, report = train_main([
            "--data_dir", prep, "--output_dir", os.path.join(root, "out_b"),
            "--scale_factor", "0.5", "--batch_size", str(C.TRAIN_BATCH),
            "--capacity", "131072", "--max_pairs", str(SCENE_PAIRS),
            "--holdout_every", "8", "--densification_interval",
            str(SCENE_INTERVAL), "--adc_mode", "paper", "--iterations",
            str(SCENE_ITERS), "--log_every", "5", "--checkpoint_interval",
            str(10**9), "--device", "cuda"])
    k1, k2 = C.counts()
    lines = out.getvalue().splitlines()
    views_train = SCENE_VIEWS - -(-SCENE_VIEWS // 8)
    assert [m for m in lines if m.startswith("init from")], lines
    assert [m for m in lines if m.startswith(
        f"device-caching {views_train} views")], lines
    _check_dataset_fit(state, report, rec, k1, k2, SCENE_ITERS,
                       SCENE_INTERVAL)
    ckpt = report.checkpoints[-1]
    back = gt.restore_pool(ckpt, device="cuda")
    assert torch.equal(back.alive, state.pool.alive)
    for k in PARAM_KEYS:
        assert torch.equal(getattr(back, k), getattr(state.pool, k).detach())

    C.zero_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        ev = evaluate.main([
            "--checkpoint", ckpt, "--data_dir", prep, "--scale_factor",
            "0.5", "--holdout_every", "8", "--max_pairs", str(SCENE_PAIRS),
            "--device", "cuda"])
        ec = eval_checkpoint.main([
            "--checkpoint", ckpt, "--scene_dir", prep, "--holdout_every",
            "8", "--device", "cuda"])
        traj = os.path.join(root, "trajectory.npy")
        ds = GaussianDataset(prep, scale_factor=0.5, holdout_every=8,
                             split="train")
        np.save(traj, ds.c2w[:4])
        frames = inference.main([
            "--checkpoint", ckpt, "--trajectory", traj, "--data_dir", prep,
            "--output_dir", os.path.join(root, "novel"), "--max_pairs",
            str(SCENE_PAIRS), "--device", "cuda"])
        ply = os.path.join(root, "export.ply")
        render_trained.main([
            "--checkpoint", ckpt, "--data_dir", prep, "--scale_factor", "0.5",
            "--output_dir", os.path.join(root, "renders"), "--num_frames",
            "2", "--benchmark_only", "--render_training_views",
            "--export_ply", ply, "--export_splat",
            os.path.join(root, "export.splat"), "--device", "cuda"])
    assert tras.composite_pairs.indexed_launches > 0
    test_views = -(-SCENE_VIEWS // 8)
    assert ev["num_views"] == test_views == ec["num_views"]
    assert np.isfinite(ev["psnr"]) and np.isfinite(ec["psnr"])
    assert len(frames) == len(os.listdir(os.path.join(root, "novel"))) == 4
    imported = import_gaussians_ply(ply)
    alive = state.pool.alive
    want = {k: getattr(state.pool, k).detach()[alive].cpu().numpy()
            for k in PARAM_KEYS}
    for k in ("pos", "f_dc", "f_rest", "opacity_raw", "scale_raw"):
        assert np.array_equal(imported[k], want[k]), k
    q = want["q_raw"] / (np.linalg.norm(want["q_raw"], axis=1,
                                        keepdims=True) + 1e-12)
    assert float(np.abs(imported["q_raw"] - q).max()) <= 1e-6


@pytest.mark.parametrize("form", ["t32_G512", "t16_G512", "t32_G128",
                                  "t32_G256", "log", "compact"])
def test_fit_on_the_prepared_scene_at_each_range(prepared, form):
    """fit() on the prepared scene's GaussianDataset at 960x540, batch 4:
    at tile 32 and pair_block 512 the train CLI's run (60 iterations, the
    paper's density control every 20, each density control's loss below
    the first logged after it); at (16, 512), (32, 128), (32, 256), and at
    (32, 256) in the log form and with the compacted backward, 4
    iterations. K1 and K2 once a view in the form the run asks for, finite
    losses, no skipped step."""
    from gsplat_tpu_torch.data import GaussianDataset

    ds = GaussianDataset(prepared.prep, scale_factor=0.5, holdout_every=8,
                         split="train")
    kw = {}
    if form.startswith("t"):
        tile, G = (int(x[1:]) for x in form.split("_"))
    else:
        tile, G = 32, 256
        kw = (dict(transmittance_math="log") if form == "log"
              else dict(bwd_pairs=2**20))
    if form == "t32_G512":
        rcfg = gt.RenderConfig(height=ds.height, width=ds.width,
                               max_pairs=SCENE_PAIRS, tile=32, pair_block=512)
        tcfg = gt.TrainConfig(iterations=SCENE_ITERS,
                              batch_size=C.TRAIN_BATCH, capacity=131072,
                              position_lr_max_steps=SCENE_ITERS,
                              densification_interval=SCENE_INTERVAL,
                              adc_mode="paper", checkpoint_interval=10**9)
    else:
        rcfg = gt.RenderConfig(height=ds.height, width=ds.width,
                               max_pairs=2 * SCENE_PAIRS, tile=tile,
                               pair_block=G, **kw)
        tcfg = gt.TrainConfig(iterations=RANGE_ITERS,
                              batch_size=C.TRAIN_BATCH, capacity=131072,
                              densification_interval=10**9,
                              checkpoint_interval=10**9)
    C.zero_counts()
    with C.FitRecord() as rec:
        state, report = rec.fit.fit(
            ds, rcfg, tcfg, log_every=5 if form == "t32_G512" else RANGE_ITERS,
            output_dir=(os.path.join(prepared.root, form)
                        if form == "t32_G512" else None),
            log_fn=lambda m: None, device="cuda")
    cp = tras.composite_pairs
    if form == "t32_G512":
        _check_dataset_fit(state, report, rec, cp.launches, cp.bwd_launches,
                           SCENE_ITERS, SCENE_INTERVAL)
        return
    k1, k2 = {"log": (cp.log_launches, cp.bwd_log_launches),
              "compact": (cp.launches, cp.bwd_compact_launches)}.get(
        form, (cp.launches, cp.bwd_launches))
    assert k1 == k2 == C.TRAIN_BATCH * RANGE_ITERS, (k1, k2)
    assert report.nonfinite_steps == 0 and np.isfinite(report.final_loss)


@pytest.mark.parametrize("extra", [[], ["--gauss_sharded"],
                                   ["--gauss_sharded", "--ring"]],
                         ids=["replicated", "gauss_sharded", "ring"])
def test_train_cli_over_a_grid_of_gloo_ranks(prepared, extra):
    """python -m gsplat_tpu_torch.train --mesh_data 2 --mesh_tile 2
    --dist_backend gloo (four ranks sharing the card), 20 iterations on
    the prepared scene, replicated, gaussian-sharded and with the ring:
    every iteration run, finite losses, no skipped step, the final
    checkpoint written."""
    from gsplat_tpu_torch.train.__main__ import main as train_main

    out = os.path.join(prepared.root, "grid_" + "_".join(extra or ["rep"]))
    _, report = train_main([
        "--data_dir", prepared.prep, "--output_dir", out, "--scale_factor",
        "0.5", "--batch_size", str(C.TRAIN_BATCH), "--capacity", "131072",
        "--max_pairs", str(SCENE_PAIRS), "--holdout_every", "8",
        "--iterations", str(GRID_CLI_ITERS), "--log_every", "5",
        "--checkpoint_interval", str(10**9), "--mesh_data", str(GRID_DATA),
        "--mesh_tile", str(GRID_TILE), "--dist_backend", "gloo"] + extra)
    assert report.iterations == GRID_CLI_ITERS
    assert all(np.isfinite([v for _, v in report.losses]))
    assert report.nonfinite_steps == 0
    assert os.path.exists(os.path.join(out, "checkpoint_final.npz"))


# --- four gloo ranks sharing the card -------------------------------------------------

# JAX's bounds for sharded against single-device results
# (tests/test_sharding.py: images 1e-6, :90; pos 1e-6 and the other leaves
# 2e-5 after a step, :109, :502) hold at its 64x64 scene, and
# tests/test_torch_sharding.py holds the port to them there. At 1080p they
# cannot: a band shifts the principal point (cy - band * band_px), so uv
# rounds otherwise in float32 and a pair can cross the edge of its support
# (q at min(chi2_clip, 2 ln(op / cutoff))) at a pixel. So the grid is held
# bit for bit to one process rendering the same bands, and to the
# full-frame single-rank render within such crossings: max abs at most the
# largest alpha a pair has at that edge, alpha_max * exp(-chi2_clip / 2),
# and at most GRID_FLIP_SHARE of the values beyond GRID_IMG_TOL. The step
# likewise: its gradients within GRID_GRAD_TOL of each leaf's largest of
# one process's gradients of the same banded loss (only the order of the
# sums differs), the paper statistics against that process's; against the
# full-frame single-rank step, the loss within 1e-5 and Adam's first
# update compared as tests/test_torch_train.py does.
GRID_DATA, GRID_TILE = 2, 2
GRID_IMG_TOL, GRID_FLIP_SHARE, GRID_GRAD_TOL = 1e-6, 1e-3, 1e-5
GRID_STEPS = {
    "scan_ref": {},
    "scan_paper": {"adc_mode": "paper"},
    "batched_ref": {"batched_render": True},
    "batched_paper": {"adc_mode": "paper", "batched_render": True},
}
GRID_FIT_ITERS = 12
GRID_CLI_ITERS = 20
# The gaussian-sharded step: the ring's buffers GAUSS_RING_MARGIN x the
# largest band's gaussian demand; a starved ring of GAUSS_STARVED rows
# must report its overflow; fit() with either exchange within
# GAUSS_FIT_TOL of the single-rank fit(); the ring against the all-gather
# exchange's updated pos and f_dc within JAX's 5e-6
# (tests/test_sharding.py:330-339).
GAUSS_TILE4 = 4
GAUSS_RING_MARGIN = 1.25
GAUSS_STARVED = 1024
GAUSS_FIT_TOL = 0.01
RING_TOL = 5e-6


def _state_digest(state) -> str:
    """sha256 over a train state's parameters, Adam moments and counts."""
    import hashlib

    h = hashlib.sha256()
    for k in PARAM_KEYS:
        p = state.pool.params[k]
        st = state.opt_state.state[p]
        for t in (p, st["exp_avg"], st["exp_avg_sq"], st["step"]):
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _max_diff(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


def _clip_pos_grad(grads: dict, max_norm: float) -> dict:
    """The step's clip_grad_norm_ on the position leaf only (train.py:536),
    written out with PyTorch operations for the banded references."""
    g = grads["pos"]
    norm = torch.sqrt(torch.sum(g * g))
    out = dict(grads)
    out["pos"] = g * torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return out


def _masked(grads, alive):
    return {k: torch.where(alive.reshape((-1,) + (1,) * (g.dim() - 1)), g,
                           0.0) for k, g in grads.items()}


def _banded_grads(pool, start, batch, rcfg, tcfg):
    """What the grid's step computes, in one process: each view's
    GRID_TILE bands rendered one after another (render_from_params, or
    batched render_batch_from_params), stacked, cropped, the batch's loss
    and its gradients, clipped and masked as the step does. Returns
    (loss, grads, paper statistics or None)."""
    from gsplat_tpu_torch.ops.losses import compute_loss
    from gsplat_tpu_torch.parallel import band_config
    from gsplat_tpu_torch.train.trainer import tap_norm_sum

    dev = pool.pos.device
    params = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
              for k, v in start.items()}
    bcfg, band_px = band_config(rcfg, GRID_TILE)
    B, Hh = batch["c2w"].shape[0], rcfg.height
    paper = tcfg.adc_mode == "paper"
    taps = torch.zeros((B, pool.capacity, 2), device=dev,
                       requires_grad=True) if paper else None
    cams = [batch[k] for k in ("fx", "fy", "cx")]
    radii = []
    if tcfg.batched_render:
        bands = []
        for b in range(GRID_TILE):
            img, aux = gt.render_batch_from_params(
                params, batch["c2w"], *cams, batch["cy"] - b * band_px,
                bcfg, alive=pool.alive, uv_taps=taps)
            bands.append(img)
            radii.append(aux.screen_radius.detach())
        loss = compute_loss(torch.cat(bands, dim=1)[:, :Hh], batch["image"],
                            tcfg.lambda_l1, tcfg.lambda_ssim)[0]
    else:
        totals = []
        for i in range(B):
            bands, rad = [], []
            for b in range(GRID_TILE):
                img, aux = gt.render_from_params(
                    params, batch["c2w"][i], *(c[i] for c in cams),
                    batch["cy"][i] - b * band_px, bcfg, alive=pool.alive,
                    uv_tap=None if taps is None else taps[i])
                bands.append(img)
                rad.append(aux.screen_radius.detach())
            radii.append(torch.stack(rad, dim=1))  # [N, bands]
            totals.append(compute_loss(torch.cat(bands)[:Hh],
                                       batch["image"][i], tcfg.lambda_l1,
                                       tcfg.lambda_ssim)[0])
        loss = torch.mean(torch.stack(totals))
    loss.backward()
    with torch.no_grad():
        grads = _masked(_clip_pos_grad({k: p.grad for k, p in params.items()},
                                       tcfg.grad_clip_pos), pool.alive)
        stats = None
        if paper:
            if tcfg.batched_render:  # [B, N] per band -> max over bands
                rmax = torch.amax(torch.stack(radii), dim=0)
            else:
                rmax = torch.amax(torch.stack(radii), dim=-1)  # [B, N]
            stats = {"uv_grad_sum": tap_norm_sum(taps.grad, rcfg),
                     "visible": torch.sum((rmax > 0).to(torch.int32), dim=0,
                                          dtype=torch.int32),
                     "max_radius": torch.amax(rmax, dim=0)}
    return loss.detach(), grads, stats


def _first_update(new, ref, start, tcfg, dev, ref_grads=None):
    """Adam's first update of ``new`` (parameters) against ``ref``'s (a
    state, or parameters with ``ref_grads``), as tests/test_torch_train.py
    compares them across paths: (max relative difference where ref's
    gradient is large, per leaf; every update within its lr)."""
    lrs = {"pos": tcfg.position_lr_init * 0.01,
           "opacity_raw": tcfg.opacity_lr, "f_dc": tcfg.feature_lr,
           "f_rest": tcfg.feature_lr / 20.0, "scale_raw": tcfg.scaling_lr,
           "q_raw": tcfg.rotation_lr}
    uerr, lr_ok = {}, True
    for k in PARAM_KEYS:
        if ref_grads is None:
            g1, p1 = ref.pool.params[k].grad, ref.pool.params[k].detach()
        else:
            g1, p1 = ref_grads[k], ref[k]
        s0 = torch.from_numpy(start[k]).to(dev)
        d, d1 = new[k] - s0, p1 - s0
        big = g1.abs() > 1e-3 * float(g1.abs().max())
        uerr[k] = float(((d - d1).abs() / d1.abs().clamp(min=1e-30))[big]
                        .max()) if bool(big.any()) else 0.0
        lr_ok = lr_ok and bool((d.abs() <= lrs[k] * (1 + 1e-6)
                                + s0.abs() * 2**-23).all())
    return uerr, lr_ok


def _counted(n, fn):
    """fn() with the launch counts set to 0 just before it, its K1 and K2
    launches added to ``n``."""
    torch.cuda.synchronize()
    C.zero_counts()
    out = fn()
    torch.cuda.synchronize()
    k1, k2 = C.counts()
    n[0] += k1
    n[1] += k2
    return out


def _grid_rank():
    """One rank of the data 2 x tile 2 grid: the band render at the bench
    pose (rect and ellipse) and the batch render of 4 poses at 1080p; the
    train step at 960x540, batch 4, in four forms (scan and batched,
    reference and paper ADC); fit(mesh=) with the paper ADC;
    evaluate_views(mesh=). Rank 0 computes the one-process references and
    returns {"checks": [(ok, what)], "counts": every rank's (K1, K2)}."""
    import torch.distributed as dist

    from gsplat_tpu_torch.evaluation import evaluate_views
    from gsplat_tpu_torch.parallel import (band_config, local_batch,
                                           make_mesh,
                                           make_sharded_batch_render,
                                           make_sharded_render,
                                           make_sharded_train_step)
    from gsplat_tpu_torch.train import trainer

    mesh = make_mesh(data=GRID_DATA, tile=GRID_TILE)
    main = mesh.rank == 0
    dev = mesh.device
    pool, c2w, center, radius = C.checkpoint(dev)
    alive_np = pool.alive.cpu().numpy()
    cfg = gt.RenderConfig(height=H, width=W, max_pairs=MAX_PAIRS)
    fx, fy, cx, cy = C.camera(W, H)
    n, checks = [0, 0], []

    def image_check(what, img, poses, c):
        """Bit for bit against one process rendering the same bands; within
        the crossings against the full-frame single-rank render."""
        bcfg, band_px = band_config(c, GRID_TILE)
        with torch.no_grad():
            full = torch.stack([gt.render_from_params(
                pool.params, p, fx, fy, cx, cy, c, alive=pool.alive)[0]
                for p in poses])
            bands = torch.cat([gt.render_batch_from_params(
                pool.params, poses, fx, fy, cx, cy - b * band_px, bcfg,
                alive=pool.alive)[0] for b in range(GRID_TILE)], dim=1)[:, :H]
        d = (img - full).abs()
        e, share = float(d.max()), float((d > GRID_IMG_TOL).float().mean())
        edge = c.alpha_max * float(np.exp(-c.chi2_clip / 2))
        checks.append((torch.equal(img, bands) and e <= edge
                       and share <= GRID_FLIP_SHARE,
                       f"{what}: max abs {e:.3e} (edge {edge:.4e}), share "
                       f"{share:.2e}, bands equal {torch.equal(img, bands)}"))

    for cull in ("rect", "ellipse"):
        ccfg = cfg.with_(cull_mode=cull)
        fn = make_sharded_render(ccfg, mesh)
        img = _counted(n, lambda: fn(pool.params, pool.alive, c2w, fx, fy,
                                     cx, cy))
        if main:
            image_check(f"band render ({cull})", img[None], c2w[None], ccfg)
    poses = C.orbit(c2w, center, radius, frames=3)
    bfn = make_sharded_batch_render(cfg, mesh)
    imgs = _counted(n, lambda: bfn(pool.params, pool.alive, poses, fx, fy,
                                   cx, cy))
    if main:
        image_check("batch render of 4 poses", imgs, poses, cfg)
    del imgs
    dist.barrier()

    tcfg0, batch, start = C.train_views(pool, c2w, center, radius)
    lb = local_batch(batch, mesh)
    for name, tkw in GRID_STEPS.items():
        tcfg = gt.TrainConfig(capacity=pool.capacity,
                              batch_size=C.TRAIN_BATCH,
                              densification_interval=10**9,
                              opacity_reset_interval=10**9, **tkw)
        state = gt.init_train_state(
            gt.pool_from_numpy(start, alive_np, device=dev), tcfg)
        step = make_sharded_train_step(tcfg0, tcfg, mesh)
        state, m = _counted(n, lambda: step(state, lb))
        digests = [None] * mesh.size
        dist.all_gather_object(digests, _state_digest(state))
        if main:
            ref = gt.init_train_state(
                gt.pool_from_numpy(start, alive_np, device=dev), tcfg)
            ref, m1 = gt.make_train_step(tcfg0, tcfg)(ref, batch)
            bl, bg, bstats = _banded_grads(pool, start, batch, tcfg0, tcfg)
            gerr = {k: _max_diff(state.pool.params[k].grad, bg[k]) / max(
                float(bg[k].abs().max()), 1e-30) for k in PARAM_KEYS}
            uerr, lr_ok = _first_update(
                {k: p.detach() for k, p in state.pool.params.items()}, ref,
                start, tcfg, dev)
            ok = (len(set(digests)) == 1
                  and max(gerr.values()) <= GRID_GRAD_TOL
                  and abs(float(m["total"]) - float(bl)) <= 1e-5
                  and max(uerr.values()) <= 1e-4 and lr_ok
                  and abs(float(m["total"]) - float(m1["total"])) <= 1e-5
                  and int(m["nonfinite_skipped"]) == 0
                  and int(m["max_band_pairs"]) <= int(
                      m["band_pair_capacity"]))
            if "uv_grad_sum" in m:
                a = bstats["uv_grad_sum"]
                ok = ok and _max_diff(a, m["uv_grad_sum"]) \
                    <= 1e-6 + 1e-4 * float(a.abs().max()) \
                    and torch.equal(m["visible"], bstats["visible"]) \
                    and torch.equal(m["max_radius"], bstats["max_radius"])
            checks.append((ok, f"step {name}: digests {len(set(digests))}, "
                               f"gradients {gerr}, loss {float(m['total'])} "
                               f"banded {float(bl)} single "
                               f"{float(m1['total'])}, updates {uerr} "
                               f"within lr {lr_ok}"))
            del ref, bg
        dist.barrier()
        del state

    tcfg = gt.TrainConfig(iterations=GRID_FIT_ITERS, batch_size=C.TRAIN_BATCH,
                          capacity=pool.capacity, checkpoint_interval=10**9,
                          adc_mode="paper", densification_interval=4,
                          densify_until_iter=12, opacity_reset_interval=8)
    tmp = tempfile.mkdtemp(prefix=f"gsplat_grid{mesh.rank}_")
    fit_lines = []
    try:
        ckpt = os.path.join(tmp, "start.npz")
        trainer.save_checkpoint(ckpt, gt.init_train_state(
            gt.pool_from_numpy(start, alive_np, device=dev), tcfg))
        state, report = _counted(n, lambda: gt.fit(
            C.repeat(batch), tcfg0, tcfg,
            initial_points=pool.pos.detach()[pool.alive].cpu().numpy(),
            resume_from=ckpt, mesh=mesh, log_every=4,
            log_fn=fit_lines.append))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    digests = [None] * mesh.size
    dist.all_gather_object(digests, _state_digest(state))
    if main:
        losses = [v for _, v in report.losses]
        checks.append((len(set(digests)) == 1 and all(np.isfinite(losses))
                       and report.nonfinite_steps == 0 and len(fit_lines) > 0,
                       f"fit(mesh=): losses {report.losses}, digests "
                       f"{len(set(digests))}"))
    del state

    views = [{"image": batch["image"][i], "c2w": batch["c2w"][i],
              **{k: float(batch[k][i]) for k in ("fx", "fy", "cx", "cy")}}
             for i in range(C.TRAIN_BATCH)]
    perturbed = gt.pool_from_numpy(start, alive_np, device=dev)
    ev = _counted(n, lambda: evaluate_views(perturbed.params, views, tcfg0,
                                            alive=perturbed.alive, mesh=mesh))
    if main:
        ev1 = evaluate_views(perturbed.params, views, tcfg0,
                             alive=perturbed.alive)
        checks.append((abs(ev["psnr"] - ev1["psnr"]) <= 1e-4 * abs(
            ev1["psnr"]) and abs(ev["ssim"] - ev1["ssim"]) <= 1e-4 * abs(
            ev1["ssim"]), f"evaluate_views(mesh=): {ev} vs {ev1}"))
    counts = [None] * mesh.size
    dist.all_gather_object(counts, tuple(n))
    return {"checks": checks, "counts": counts} if main else None


def test_data_and_tile_grid_of_four_gloo_ranks(cuda):
    """One spawn of four gloo ranks on the card, data 2 x tile 2: the band
    renders (rect and ellipse) and the batch render of 4 poses at 1080p
    bit for bit against one process rendering the same bands, and within
    the crossings of the full-frame single-rank renders; the train step at
    960x540, batch 4 (scan and batched, reference and paper ADC): every
    rank's parameters and moments bit-identical, its gradients within
    1e-5 of each leaf's largest of one process's banded loss, uv_grad_sum,
    visible and max_radius against that process's, the loss within 1e-5
    and Adam's first update against the full-frame single-rank step; a
    12-iteration fit(mesh=) with the paper ADC; evaluate_views(mesh=)
    within 1e-4 relative of one rank's; every rank launched K1 and K2."""
    from gsplat_tpu_torch.parallel import launch

    res = launch(_grid_rank, GRID_DATA * GRID_TILE, backend="gloo")
    for ok, what in res["checks"]:
        assert ok, what
    assert sum(c[0] for c in res["counts"]) > 0
    assert sum(c[1] for c in res["counts"]) > 0


def _banded_gauss(pool, start, batch, rcfg, tcfg, n_tile):
    """What the gaussian-sharded grid computes, in one process: each
    view's full-frame projection of the whole pool, localized to each of
    ``n_tile`` bands (``band_localize``), each band binned and composited
    (batched: the views' localized projections of a band stacked into one
    list), the bands stacked and cropped, the loss and its gradients,
    clipped and masked as the step does. Returns (images [B, H, W, 3],
    loss, gradients, paper statistics or None)."""
    from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
    from gsplat_tpu_torch.ops.losses import compute_loss
    from gsplat_tpu_torch.ops.rasterize import rasterize_binned
    from gsplat_tpu_torch.ops.sh import evaluate_sh
    from gsplat_tpu_torch.parallel import band_config, band_localize
    from gsplat_tpu_torch.render import stack_view_projections
    from gsplat_tpu_torch.train.trainer import tap_norm_sum

    dev = pool.pos.device
    params = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
              for k, v in start.items()}
    bcfg, band_px = band_config(rcfg, n_tile)
    rows = band_px // rcfg.tile
    B, Hh = batch["c2w"].shape[0], rcfg.height
    paper = tcfg.adc_mode == "paper"
    taps = torch.zeros((B, pool.capacity, 2), device=dev,
                       requires_grad=True) if paper else None

    def project(v, cov3d):
        c2w = batch["c2w"][v]
        colors = evaluate_sh(params["f_dc"], params["f_rest"], params["pos"],
                             c2w)
        proj = gt.project_gaussians(
            params["pos"], cov3d, params["opacity_raw"], c2w, batch["fx"][v],
            batch["fy"][v], batch["cx"][v], batch["cy"][v], rcfg,
            extra_valid=pool.alive, uv_tap=None if taps is None else taps[v])
        return proj, colors

    if tcfg.batched_render:
        cov3d = build_cov3d_packed(params["scale_raw"], params["q_raw"])
        pcs = [project(v, cov3d) for v in range(B)]
        proj_b = gt.ProjectedGaussians(*(torch.stack(f) for f in zip(
            *[p for p, _ in pcs])))
        cols = torch.cat([c for _, c in pcs])
        bands = []
        for b in range(n_tile):
            st, scfg = stack_view_projections(
                band_localize(proj_b, b * rows, rows, rcfg.tile), bcfg)
            img, _ = rasterize_binned(st, cols, gt.bin_gaussians(st, scfg),
                                      scfg)
            bands.append(img.reshape(B, bcfg.padded_height, rcfg.width,
                                     3)[:, :band_px])
        imgs = torch.cat(bands, dim=1)[:, :Hh]
        loss = compute_loss(imgs, batch["image"], tcfg.lambda_l1,
                            tcfg.lambda_ssim)[0]
        radii = proj_b.radius
    else:
        ims, totals, radii = [], [], []
        for v in range(B):
            proj, col = project(v, build_cov3d_packed(params["scale_raw"],
                                                      params["q_raw"]))
            bands = []
            for b in range(n_tile):
                band = band_localize(proj, b * rows, rows, rcfg.tile)
                bands.append(rasterize_binned(
                    band, col, gt.bin_gaussians(band, bcfg), bcfg)[0])
            im = torch.cat(bands)[:Hh]
            ims.append(im)
            totals.append(compute_loss(im, batch["image"][v], tcfg.lambda_l1,
                                       tcfg.lambda_ssim)[0])
            radii.append(proj.radius)
        imgs = torch.stack(ims)
        loss = torch.mean(torch.stack(totals))
        radii = torch.stack(radii)
    loss.backward()
    with torch.no_grad():
        grads = _masked(_clip_pos_grad({k: p.grad for k, p in params.items()},
                                       tcfg.grad_clip_pos), pool.alive)
        stats = None
        if paper:
            stats = {"uv_grad_sum": tap_norm_sum(taps.grad, rcfg),
                     "visible": torch.sum((radii > 0).to(torch.int32), dim=0,
                                          dtype=torch.int32),
                     "max_radius": torch.amax(radii, dim=0)}
    return imgs.detach(), loss.detach(), grads, stats


def _band_gauss_demand(pool, batch, rcfg, n_tile):
    """The largest number of gaussians one band of one view holds (the
    ring's buffer demand), from the whole pool's full-frame projections."""
    from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
    from gsplat_tpu_torch.parallel import band_config, band_localize

    rows = band_config(rcfg, n_tile)[1] // rcfg.tile
    demand = 0
    with torch.no_grad():
        cov3d = build_cov3d_packed(pool.scale_raw, pool.q_raw)
        for v in range(batch["c2w"].shape[0]):
            proj = gt.project_gaussians(
                pool.pos, cov3d, pool.opacity_raw, batch["c2w"][v],
                batch["fx"][v], batch["fy"][v], batch["cx"][v],
                batch["cy"][v], rcfg, extra_valid=pool.alive)
            for b in range(n_tile):
                band = band_localize(proj, b * rows, rows, rcfg.tile)
                demand = max(demand, int(band.valid.sum()))
    return demand


def _gauss_rank(dcp_dir):
    """One rank of the gaussian-sharded grid: (a) the step over data 2 x
    tile 2 in the four forms, (b) the ring over data 1 x tile 4 of the
    same processes, (c) fit() with either exchange and the DCP checkpoint
    written to ``dcp_dir``. Rank 0 computes the one-process references and
    returns {"checks": [(ok, what)] (every rank's own too), "counts":
    every rank's (K1, K2), "digest": the gathered fit state's}."""
    import torch.distributed as dist

    from gsplat_tpu_torch.parallel import (gather_train_state, local_batch,
                                           make_gauss_sharded_render,
                                           make_gauss_sharded_train_step,
                                           make_mesh, shard_train_state)
    from gsplat_tpu_torch.parallel.sharding import _all_gather
    from gsplat_tpu_torch.train import trainer

    mesh = make_mesh(data=GRID_DATA, tile=GRID_TILE)
    mesh4 = make_mesh(data=1, tile=GAUSS_TILE4)
    main = mesh.rank == 0
    dev = mesh.device
    pool, c2w, center, radius = C.checkpoint(dev)
    alive_np = pool.alive.cpu().numpy()
    rcfg, batch, start = C.train_views(pool, c2w, center, radius)
    lb = local_batch(batch, mesh)
    n, checks, own = [0, 0], [], []

    def fresh(tcfg):
        return gt.init_train_state(
            gt.pool_from_numpy(start, alive_np, device=dev), tcfg)

    def tcfg_of(**kw):
        return gt.TrainConfig(capacity=pool.capacity,
                              batch_size=C.TRAIN_BATCH,
                              densification_interval=10**9,
                              opacity_reset_interval=10**9, **kw)

    # (a) the gaussian-sharded step, four forms, data 2 x tile 2.
    seen = {}
    real_bwd = tras.composite_pairs_bwd
    for name, tkw in GRID_STEPS.items():
        tcfg = tcfg_of(**tkw)
        state = shard_train_state(fresh(tcfg), mesh)
        opt = state.opt_state
        rows = {"alive": state.pool.alive.shape[0]}
        for k, p in state.pool.params.items():
            rows[k] = p.shape[0]
            rows[k + ".m"] = opt.state[p]["exp_avg"].shape[0]
            rows[k + ".v"] = opt.state[p]["exp_avg_sq"].shape[0]
        with torch.no_grad():  # the images the step's loss reads
            imgs = make_gauss_sharded_render(
                rcfg, mesh, batched=tcfg.batched_render)(
                    state.pool.params, state.pool.alive, lb)[0]
        imgs = _all_gather(imgs, mesh.data_group, GRID_DATA, 0)
        step = make_gauss_sharded_train_step(rcfg, tcfg, mesh)
        if name == "scan_ref":  # what autograd hands K2 on this band
            def seen_bwd(*args, **kw):
                seen["args"] = tuple(a.detach() if isinstance(
                    a, torch.Tensor) else a for a in args)
                seen["d"] = real_bwd(*args, **kw)
                return seen["d"]
            tras.composite_pairs_bwd = seen_bwd
        try:
            state, m = _counted(n, lambda: step(state, lb))
        finally:
            tras.composite_pairs_bwd = real_bwd
        if name == "scan_ref":  # K1 and K2 against their plain versions
            pf, ts, tc, out = seen["args"][:4]
            with torch.no_grad():
                out_p = tras.composite_pairs_plain(pf, ts, tc,
                                                   seen["args"][6],
                                                   tile_chunk=1024)
            d_p = tras.composite_pairs_bwd_plain(*seen["args"],
                                                 block_chunk=256)
            rel = _rel_err(seen["d"], d_p)
            own.append((torch.equal(out[:, :6], out_p[:, :6])
                        and bool(torch.isfinite(out).all())
                        and rel <= C.BWD_TOL,
                        f"rank {mesh.rank}: K1 on its band list bit for bit "
                        f"with its plain version, K2 relative {rel:.3e}"))
            del seen["args"], seen["d"], d_p, out_p
        digests = [None] * mesh.size
        dist.all_gather_object(digests, _state_digest(state))
        grads = {k: _all_gather(p.grad, mesh.tile_group, GRID_TILE, 0)
                 for k, p in state.pool.params.items()}
        whole = gather_train_state(state, mesh)
        paper = {k: _all_gather(m[k], mesh.tile_group, GRID_TILE, 0)
                 for k in ("uv_grad_sum", "visible", "max_radius") if k in m}
        if main:
            bimgs, bl, bg, bstats = _banded_gauss(pool, start, batch, rcfg,
                                                  tcfg, GRID_TILE)
            same_img = torch.equal(imgs, bimgs)
            del bimgs
            ref, m1 = gt.make_train_step(rcfg, tcfg)(fresh(tcfg), batch)
            gerr = {k: _max_diff(grads[k], bg[k]) / max(
                float(bg[k].abs().max()), 1e-30) for k in PARAM_KEYS}
            uerr, lr_ok = _first_update(
                {k: v.detach() for k, v in whole.pool.params.items()}, ref,
                start, tcfg, dev)
            replicas = all(digests[t] == digests[GRID_TILE + t]
                           for t in range(GRID_TILE))
            ok = (same_img and replicas
                  and set(rows.values()) == {pool.capacity // GRID_TILE}
                  and max(gerr.values()) <= GRID_GRAD_TOL
                  and abs(float(m["total"]) - float(bl)) <= 1e-5
                  and abs(float(m["total"]) - float(m1["total"])) <= 1e-5
                  and max(uerr.values()) <= 1e-4 and lr_ok
                  and int(m["nonfinite_skipped"]) == 0
                  and int(m["ring_overflow"]) == 0
                  and int(m["max_band_pairs"]) <= int(
                      m["band_pair_capacity"]))
            if paper:
                a = bstats["uv_grad_sum"]
                ok = ok and _max_diff(a, paper["uv_grad_sum"]) \
                    <= 1e-6 + 1e-4 * float(a.abs().max()) \
                    and torch.equal(paper["visible"], bstats["visible"]) \
                    and torch.equal(paper["max_radius"],
                                    bstats["max_radius"])
            checks.append((ok, f"gauss step {name}: rows {set(rows.values())}"
                               f", images equal {same_img}, replicas "
                               f"{replicas}, gradients {gerr}, loss "
                               f"{float(m['total'])} banded {float(bl)} "
                               f"single {float(m1['total'])}, updates {uerr} "
                               f"within lr {lr_ok}"))
            del bg, ref
        del state, whole, grads, imgs
        dist.barrier()

    # (b) the ring over data 1 x tile 4.
    demand = _band_gauss_demand(pool, batch, rcfg, GAUSS_TILE4)
    cap = -(-int(demand * GAUSS_RING_MARGIN) // 1024) * 1024
    tcfg = tcfg_of()
    outs = {}
    b4 = local_batch(batch, mesh4)
    for tag, ring, rc in (("all-gather", False, None), ("ring", True, cap),
                          ("starved", True, GAUSS_STARVED)):
        state = shard_train_state(fresh(tcfg), mesh4)
        with torch.no_grad():
            imgs = make_gauss_sharded_render(rcfg, mesh4, ring=ring,
                                             ring_capacity=rc)(
                state.pool.params, state.pool.alive, b4)[0]
        step = make_gauss_sharded_train_step(rcfg, tcfg, mesh4, ring=ring,
                                             ring_capacity=rc)
        state, m = _counted(n, lambda: step(state, b4))
        grads = {k: _all_gather(p.grad, mesh4.tile_group, GAUSS_TILE4, 0)
                 for k, p in state.pool.params.items()}
        whole = gather_train_state(state, mesh4)
        outs[tag] = ({k: v.detach() for k, v in whole.pool.params.items()},
                     float(m["total"]), int(m["ring_overflow"]), grads, imgs)
        del state, whole
    if main:
        (pa, la, _, ga, ia), (pr, lr_, ovf, gr, ir) = (outs["all-gather"],
                                                       outs["ring"])
        diffs = {k: _max_diff(pr[k], pa[k]) for k in PARAM_KEYS}
        gerr = {k: _max_diff(gr[k], ga[k]) / max(float(ga[k].abs().max()),
                                                 1e-30) for k in PARAM_KEYS}
        uerr, lr_ok = _first_update(pr, pa, start, tcfg, dev, ref_grads=ga)
        checks.append((
            ovf == 0 and outs["starved"][2] > 0 and cap < pool.capacity
            and torch.equal(ir, ia) and abs(lr_ - la) <= 1e-5
            and max(gerr.values()) <= GRID_GRAD_TOL
            and max(uerr.values()) <= 1e-4 and lr_ok
            and max(diffs["pos"], diffs["f_dc"]) <= RING_TOL,
            f"ring (demand {demand}, capacity {cap}): overflow {ovf}, "
            f"starved {outs['starved'][2]}, images equal "
            f"{torch.equal(ir, ia)}, loss {lr_} vs {la}, gradients {gerr}, "
            f"updates {uerr} within lr {lr_ok}, parameters {diffs}"))
    del outs
    dist.barrier()

    # (c) fit(mesh=, gauss_sharded=True | "ring") from the perturbed
    # checkpoint with the reference ADC, then the DCP pair.
    tcfg = gt.TrainConfig(iterations=GRID_FIT_ITERS, batch_size=C.TRAIN_BATCH,
                          capacity=pool.capacity, checkpoint_interval=10**9,
                          densification_interval=4, densify_until_iter=12,
                          opacity_reset_interval=8)
    points = pool.pos.detach()[pool.alive].cpu().numpy()
    tmp = tempfile.mkdtemp(prefix=f"gsplat_gauss{mesh.rank}_")
    fits = {}
    try:
        ckpt = os.path.join(tmp, "start.npz")
        trainer.save_checkpoint(ckpt, fresh(tcfg))

        def fit(how, logs):
            return gt.fit(C.repeat(batch), rcfg, tcfg, initial_points=points,
                          resume_from=ckpt, mesh=mesh if how else None,
                          gauss_sharded=how, log_every=4,
                          log_fn=logs.append, device=dev)

        for how in (True, "ring"):
            logs = []
            fits[how] = _counted(n, lambda: fit(how, logs)) + (logs,)
        if main:  # the single-rank reference (not counted)
            fits[False] = fit(False, []) + ([],)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    st = fits[True][0]
    dist.barrier()
    trainer.save_checkpoint_dcp(dcp_dir, shard_train_state(st, mesh), mesh)
    digest = _state_digest(st) + str(int(st.pool.num_alive()))
    if main:
        s1, r1, _ = fits[False]
        n1 = int(s1.pool.num_alive())
        for how, tag in ((True, "all-gather"), ("ring", "ring")):
            s, r, logs = fits[how]
            na = int(s.pool.num_alive())
            lerr = max(abs(a - b) / b for (_, a), (_, b) in zip(r.losses,
                                                                r1.losses))
            checks.append((
                abs(na - n1) <= GAUSS_FIT_TOL * n1 and lerr <= GAUSS_FIT_TOL
                and r.nonfinite_steps == 0
                and [i for i, _ in r.losses] == [i for i, _ in r1.losses]
                and not any("ring-stream" in x for x in logs),
                f"fit(mesh=, gauss_sharded={how!r}): {na} alive against "
                f"{n1}, losses {r.losses} against {r1.losses}"))
    del fits
    every = [None] * mesh.size
    dist.all_gather_object(every, (tuple(n), own))
    return {"checks": checks + [c for _, o in every for c in o],
            "counts": [c for c, _ in every], "digest": digest} \
        if main else None


def test_gaussian_sharded_grid_of_four_gloo_ranks(cuda, tmp_path):
    """One spawn of four gloo ranks on the card: (a) the gaussian-sharded
    step over data 2 x tile 2 from the perturbed checkpoint at 960x540,
    batch 4, in four forms: every rank holds 65,536 rows of every capacity
    leaf; the gathered images bit for bit and the gradients within 1e-5
    of each leaf's largest of one process computing the same banded
    render; against the full-frame single-rank step the loss within 1e-5
    and Adam's first update; the data replicas' shards bit-identical; the
    paper statistics against the banded process; K1 and K2 against their
    plain versions on each rank's band inputs. (b) Over data 1 x tile 4,
    the ring (buffers 1.25 x the largest band's demand) against the
    all-gather step, and a starved ring reporting its overflow. (c) fit()
    with either exchange within 1 % of the single-rank fit(); its state
    saved with save_checkpoint_dcp by the grid and loaded here bit for
    bit."""
    from gsplat_tpu_torch.parallel import launch
    from gsplat_tpu_torch.train import trainer

    dcp = str(tmp_path / "dcp")
    res = launch(_gauss_rank, GRID_DATA * GRID_TILE, backend="gloo",
                 args=(dcp,))
    for ok, what in res["checks"]:
        assert ok, what
    assert all(k1 > 0 and k2 > 0 for k1, k2 in res["counts"])
    pool = gt.restore_pool(C.CKPT, device=cuda)
    state = trainer.load_checkpoint_dcp(dcp, gt.init_train_state(
        pool, gt.TrainConfig(capacity=pool.capacity)))
    assert _state_digest(state) + str(int(state.pool.num_alive())) \
        == res["digest"]


# --- the bench asset's recipe, and the bench --------------------------------------

# The port's asset may score at most this many dB below the JAX asset on the
# recipe's ground-truth views; scored again after the strip it must give
# the recipe's own PSNR.
ASSET_PSNR_SLACK = 0.5
ASSET_RESCORE_TOL = 1e-4


def test_bench_asset_recipe_against_the_jax_asset(bench, tmp_path):
    """python -m gsplat_tpu_torch.make_bench_asset with the recipe unchanged
    (800 iterations, capacity 131,072, 120,000 GT gaussians in 400
    clusters, 960x540, 16 views, max_pairs 2**21): a finite final loss,
    every iteration run, K2 once a step and K1 once a step and twice a GT
    view (its render and its evaluation); the memory model within 25 % of
    the run's own peak; the asset's keys, shapes and dtypes those of
    bench_assets/trained_ckpt.npz, __step__ 800, no optimizer leaves,
    restore_pool on the card equal to fit()'s final pool; on the recipe's
    16 GT views the port's asset at most 0.5 dB below the JAX asset and
    scored again equal to the recipe's own PSNR; the JAX asset's pair
    demand at its 1080p bench pose the checkpoint's."""
    from gsplat_tpu_torch import make_bench_asset, train_synthetic
    from gsplat_tpu_torch.evaluation import evaluate_views
    from gsplat_tpu_torch.make_bench_asset import RECIPE_FLAGS

    def flag(name):
        return int(RECIPE_FLAGS[RECIPE_FLAGS.index(f"--{name}") + 1])

    iters, n_views = flag("iterations"), flag("views")
    fit_mod = importlib.import_module("gsplat_tpu_torch.train.fit")
    got = {}
    real_fit, real_views = fit_mod.fit, train_synthetic.gt_views

    def fit(dataset, cfg, tcfg, **kw):
        got["tcfg"] = tcfg
        got["state"], got["report"] = real_fit(dataset, cfg, tcfg, **kw)
        return got["state"], got["report"]

    def views_of(gt_params, n, cfg):
        got["gt_params"], got["cfg"] = gt_params, cfg
        got["views"] = real_views(gt_params, n, cfg)
        return got["views"]

    out = str(tmp_path / "trained_ckpt_torch.npz")
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    C.zero_counts()
    fit_mod.fit, train_synthetic.gt_views = fit, views_of
    try:
        with C.FitRecord() as rec:
            res = make_bench_asset.main([str(tmp_path / "run"), "--out",
                                         out])
    finally:
        fit_mod.fit, train_synthetic.gt_views = real_fit, real_views
    torch.cuda.synchronize()
    k1, k2 = C.counts()
    state, report, tcfg = got["state"], got["report"], got["tcfg"]
    vcfg, views = got["cfg"], got["views"]
    _gate_memory(other, C.memory_est(vcfg.with_(max_pairs=rec.max_pairs[-1]),
                                     tcfg, state.pool.capacity))
    assert np.isfinite(report.final_loss) and report.iterations == iters
    served = tras.composite_pairs.indexed_launches
    assert k2 == k1 == iters and served == 2 * n_views, (k1, k2, served)

    with np.load(C.CKPT) as j, np.load(out) as f:
        assert {k: (f[k].shape, str(f[k].dtype)) for k in f.files} \
            == {k: (j[k].shape, str(j[k].dtype)) for k in j.files}
        assert int(f["__step__"]) == iters
        assert int(f["__num_opt_leaves__"]) == 0
    port = gt.restore_pool(out, device="cuda")
    assert torch.equal(port.alive, state.pool.alive)
    for k in PARAM_KEYS:
        assert torch.equal(port.params[k], state.pool.params[k]), k
    del got, state

    ev = {name: evaluate_views(p.params, views, vcfg, alive=p.alive)
          for name, p in (("port", port), ("jax", bench.pool))}
    assert ev["port"]["psnr"] - ev["jax"]["psnr"] >= -ASSET_PSNR_SLACK, ev
    assert abs(ev["port"]["psnr"] - res["psnr"]) <= ASSET_RESCORE_TOL

    cfg = bench.cfg
    jax_c2w = bench_pose(bench.pool)[0]
    pairs = int(serving_path(bench.pool.params, jax_c2w, *bench.cam, cfg,
                             alive=bench.pool.alive)["bin"].num_pairs)
    assert pairs == int(serving_path(bench.pool.params, bench.c2w,
                                     *bench.cam, cfg,
                                     alive=bench.pool.alive)["bin"].num_pairs)


def _bench_keys(ellipse_ab: bool) -> set:
    """The keys bench.py prints on the same flags (BENCH_r05.json's), less
    the original reference's pixel_grad_* (not ported), plus the ellipse
    A/B's three with ``ellipse_ab``."""
    import json

    with open(os.path.join(C.ROOT, "BENCH_r05.json")) as f:
        keys = {k for k in json.load(f)["parsed"]
                if not k.startswith("pixel_grad_")}
    if ellipse_ab:
        keys |= {"fps_trained_ckpt_ellipse", "trained_ckpt_pairs_ellipse",
                 "trained_ckpt_ellipse_img_err"}
    return keys


def test_bench_in_process(bench, lever):
    """bench.main(["--ellipse-ab"]) in process at full width (1080p, 2**17
    synthetic gaussians, 20 iterations, the checkpoint's 131,072 slots):
    its last line one JSON object with bench.py's metric and keys, no
    *_error key, no NaN; the checkpoint's pair demand that of its serving
    path at the bench pose and within its capacity, its culled demand and
    kept pairs the truncation's at the bench pose, its ellipse demand the
    ellipse cull's there with image error 0, the truncated image within
    2e-5 of the exact one; K1, K2 and K2 in compact mode launched."""
    import contextlib
    import io
    import json
    import math

    from gsplat_tpu_torch import bench as bench_mod

    pool, cam, cfg = bench.pool, bench.cam, bench.cfg
    pairs = {m: int(serving_path(pool.params, bench.c2w, *cam,
                                 cfg.with_(cull_mode=m),
                                 alive=pool.alive)["bin"].num_pairs)
             for m in ("rect", "ellipse")}
    C.zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_mod.main(["--ellipse-ab"])
    cp = tras.composite_pairs
    k1, k2, kc = cp.launches, cp.bwd_launches, cp.bwd_compact_launches
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert isinstance(line, dict)
    assert line.get("metric") == "render_fps_1080p_trained"
    assert set(line) == _bench_keys(True)
    assert not [k for k in line if k.endswith("_error")]
    assert not [k for k, v in line.items()
                if isinstance(v, float) and math.isnan(v)]
    assert line["trained_ckpt_pairs"] == pairs["rect"]
    assert line["trained_ckpt_pairs"] <= line["trained_ckpt_pair_capacity"]
    assert line["trained_ckpt_demand_culled"] == lever.demand
    assert line["trained_ckpt_pairs_kept"] == lever.kept
    assert line["trained_ckpt_pairs_ellipse"] == pairs["ellipse"]
    assert line["trained_ckpt_ellipse_img_err"] == 0
    assert line["trained_ckpt_trunc_img_err"] <= 2e-5
    assert k1 > 0 and k2 > 0 and kc > 0
