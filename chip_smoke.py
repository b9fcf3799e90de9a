#!/usr/bin/env python
"""GPU smoke test of the PyTorch/CUDA port (gsplat_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):
  1. card check: torch.cuda.is_available(); the card's name and power limit;
  2. build every kernel of the serving and training paths from
     ``gsplat_tpu_torch/ops/csrc`` (raster_fwd = K1, raster_bwd = K2; one
     nvcc per source, all started together), with ptxas registers/spills;
  3. K1, then K2 on a seeded cotangent, against their plain PyTorch versions
     on a seeded synthetic scene at 1920x1080 (K2 also: exact zeros outside
     the composited blocks, finite, a second call bit-identical);
  4. the same on ``bench_assets/trained_ckpt.npz`` at 1920x1080 from the
     bench pose (camera at center + (0, -0.6R, -4.4R));
  5. serving: restore_pool -> make_render_fn -> render_trajectory over the
     bench pose plus an 8-frame orbit at orbit_scale 4.4, with the kernel's
     launch count read around the run, and the served bench-pose frame held
     against the image assembled from the plain compositor's output;
  6. timing of K1 alone (CUDA events) beside its plain version and its
     bound, and the device time of each stage of one frame;
  7. fwd+bwd at 1080p at the bench pose (render_from_params, loss
     mean(im) + mean(im^2), .backward()): one K1 and one K2 launch per call,
     finite gradients, dead slots' gradients 0, ms per call, and the device
     time of the backward's parts;
  8. training: init_train_state -> make_train_step -> 6 steps of batch 4 at
     960x540 on the checkpoint with f_dc and opacity perturbed, ground truth
     rendered from the unperturbed checkpoint: the loss falls, no step is
     skipped, dead slots do not move, K1 and K2 launch views x steps times,
     no pair overflow; step ms, per-view ms, peak device memory;
  9. timing of K2 alone (CUDA events) at the bench pose, on the inputs the
     fwd+bwd of phase 7 gave it, beside its plain version and its bound;
 10. one JSON line {"kernels": [...]}, the card line, and the final line
     {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "bench_assets", "trained_ckpt.npz")
H, W = 1080, 1920
MAX_PAIRS = 2**22
TOL = 2e-5  # kernel vs plain, rows 0-4 abs (both round alike: -fmad=false)
# K2 vs plain, rows 0-9, relative to each row's max abs: the per-(pair,
# pixel) terms round alike; only the order of the pixel sums differs.
BWD_TOL = 1e-5
# Arithmetic operations per active (pair, pixel) in the compositor: du, dv
# (2), q (9), -q/2 (1), exp (1), op*g (1), min (1), alpha*T (1), four sums
# (8), T*(1-alpha) (2). Compares/selects are not counted.
OPS_PER_PAIR_PIXEL = 26
# The same for K2 (raster_bwd.cu): du, dv (2), q (9), -q/2 (1), exp (1),
# op*g (1), min (1), w = alpha*T (1), gdotc (7), gP += gdotc*w (2),
# gS (1), 1-alpha and its floor (2), dalpha (4: gdotc*T, gS+gTT, divide,
# subtract), dq (3), the u and v partials (6 each), the three conic
# partials (2, 3, 2), the opacity partial (1), the four colour partials
# (4), the four prefix sums (8), T*(1-alpha) (2), and one add per partial
# for the pixel sum (10).
OPS_BWD_PER_PAIR_PIXEL = 79
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
FEAT_ROWS = 10
TRAIN_H, TRAIN_W = 540, 960  # the reference's training resolution
TRAIN_PAIRS = 2**21
TRAIN_BATCH = 4
TRAIN_STEPS = 6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def make_scene(n, seed):
    """Random gaussians in front of a camera at the origin looking down +z
    (the recipe of the test suite's make_scene)."""
    r = np.random.default_rng(1234 + seed)
    params = {"pos": np.stack(
        [r.uniform(-2.0, 2.0, n), r.uniform(-2.0, 2.0, n),
         r.uniform(3.0, 8.0, n)], axis=-1).astype(np.float32)}
    params["scale_raw"] = (r.normal(0, 0.3, (n, 3)) - 2.0).astype(np.float32)
    params["q_raw"] = r.normal(0, 1.0, (n, 4)).astype(np.float32)
    params["q_raw"][:, 3] += 2.0
    params["opacity_raw"] = r.normal(0.5, 1.0, n).astype(np.float32)
    params["f_dc"] = r.normal(0, 0.8, (n, 3)).astype(np.float32)
    params["f_rest"] = r.normal(0, 0.05, (n, 45)).astype(np.float32)
    th = 0.08
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]], np.float32)
    c2w[:3, 3] = [0.1, -0.05, 0.2]
    return params, c2w


def serving_path(params, c2w, fx, fy, cx, cy, cfg, alive=None):
    """The serving path up to the compositor, stage by stage, with the same
    calls as render_from_params: {"cov", "colors", "proj", "bin",
    "pair_feat" [10, pairs]}."""
    from gsplat_tpu_torch.ops.binning import bin_gaussians
    from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
    from gsplat_tpu_torch.ops.projection import project_gaussians
    from gsplat_tpu_torch.ops.rasterize import (_pair_features,
                                                gather_pair_features)
    from gsplat_tpu_torch.ops.sh import evaluate_sh

    pos = params["pos"]
    s = {"c2w": torch.as_tensor(c2w, dtype=torch.float32, device=pos.device)}
    with torch.no_grad():
        s["cov"] = build_cov3d_packed(params["scale_raw"], params["q_raw"])
        s["colors"] = evaluate_sh(params["f_dc"], params["f_rest"], pos,
                                  s["c2w"])
        s["proj"] = project_gaussians(pos, s["cov"], params["opacity_raw"],
                                      s["c2w"], fx, fy, cx, cy, cfg,
                                      extra_valid=alive)
        s["bin"] = bin_gaussians(s["proj"], cfg)
        feat10 = _pair_features(s["proj"], s["colors"], torch.float32)[
            s["bin"].depth_order.long()]
        s["pair_feat"] = gather_pair_features(feat10, s["bin"].pair_slot,
                                              s["bin"].gauss_offsets)
    return s


def compare(name, out_k, out_p, tile_count):
    """Kernel vs plain on every tile: rows 0-4 within TOL, row 5 exact."""
    occ = tile_count > 0
    err = float((out_k[:, 0:5] - out_p[:, 0:5]).abs().max())
    err_occ = float((out_k[occ, 0:5] - out_p[occ, 0:5]).abs().max()) \
        if bool(occ.any()) else 0.0
    cnt_ok = bool(torch.equal(out_k[:, 5], out_p[:, 5]))
    finite = bool(torch.isfinite(out_k).all())
    print(f"[{name}] kernel vs plain: max abs err rows 0-4 {err:.3e} "
          f"(occupied tiles {err_occ:.3e}, tol {TOL}), row 5 exact: "
          f"{cnt_ok}, finite: {finite}, occupied tiles {int(occ.sum())}",
          flush=True)
    if not (err <= TOL and cnt_ok and finite):
        raise SystemExit(f"FAIL: {name}: kernel disagrees with plain version")
    return err


def active_slots(binning, out, cfg):
    """[padded_pairs] bool: slots of the blocks the forward composited (each
    tile's first out[:, 5] blocks; dead blocks never)."""
    G = cfg.pair_block
    meta = binning.block_meta.long()
    tile = meta >> 2
    rank = torch.arange(meta.shape[0], device=meta.device) \
        - binning.tile_start.long()[tile] // G
    active = ((meta & 2) == 0) & (rank >= 0) & (rank < out[tile, 5, 0].long())
    return active.repeat_interleave(G)


def check_bwd(name, pf, binning, out, cfg, seed):
    """K2 vs its plain version on a seeded cotangent: rows 0-9 within
    BWD_TOL of each row's max abs, exact zeros outside the composited
    blocks, finite, and a second launch bit-identical. Returns the max abs
    error."""
    from gsplat_tpu_torch.ops.raster_cuda import (composite_pairs_bwd,
                                                  composite_pairs_bwd_plain)

    gen = torch.Generator(device=pf.device).manual_seed(seed)
    gout = torch.randn(cfg.num_tiles, 8, cfg.tile**2, generator=gen,
                       device=pf.device)
    args = (pf, binning.tile_start, binning.tile_count, out, gout, cfg)
    d_k = composite_pairs_bwd(*args)
    d_k2 = composite_pairs_bwd(*args)
    d_p = composite_pairs_bwd_plain(*args, tile_chunk=512)
    torch.cuda.synchronize()
    rel = []
    for r in range(FEAT_ROWS):
        scale = float(d_p[r].abs().max())
        err = float((d_k[r] - d_p[r]).abs().max())
        rel.append(err / scale if scale > 0 else (0.0 if err == 0 else 1.0))
    off = ~active_slots(binning, out, cfg)
    zeros = bool((d_k[:, off] == 0).all())
    finite = bool(torch.isfinite(d_k).all())
    same = bool(torch.equal(d_k, d_k2))
    err = float((d_k - d_p).abs().max())
    print(f"[{name}] K2 vs plain: max abs err {err:.3e}, max per-row "
          f"relative {max(rel):.3e} (tol {BWD_TOL}), zeros outside the "
          f"{int((~off).sum() // cfg.pair_block)} composited blocks: "
          f"{zeros}, finite: {finite}, two launches bit-identical: {same}",
          flush=True)
    if not (max(rel) <= BWD_TOL and zeros and finite and same):
        raise SystemExit(f"FAIL: {name}: K2 disagrees with its plain version")
    return err


def fwd_bwd_phase(pool, c2w, fx, fy, cx, cy, cfg, card, reps=5):
    """fwd+bwd of render_from_params at the bench pose (the port's
    counterpart of bench.py:202-222). Returns the inputs K2 was given on
    the last call (for its timing) and the gradient it returned."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops import raster_cuda

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in pool.params.items()}
    seen = {}
    plain_bwd = raster_cuda.composite_pairs_bwd

    def seen_bwd(*args):  # records what autograd hands K2
        seen["args"] = args
        seen["d"] = plain_bwd(*args)
        return seen["d"]

    def call():
        for p in params.values():
            p.grad = None
        img, _ = gt.render_from_params(params, c2w, fx, fy, cx, cy, cfg,
                                       alive=pool.alive)
        (torch.mean(img) + torch.mean(img * img)).backward()

    raster_cuda.composite_pairs_bwd = seen_bwd
    try:
        call()  # warm-up
        torch.cuda.synchronize()
        k1, k2 = (raster_cuda.composite_pairs.launches,
                  raster_cuda.composite_pairs.bwd_launches)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        raster_cuda.composite_pairs_bwd = plain_bwd
    n1 = raster_cuda.composite_pairs.launches - k1
    n2 = raster_cuda.composite_pairs.bwd_launches - k2
    dead = ~pool.alive
    finite = all(bool(torch.isfinite(p.grad).all()) for p in params.values())
    dead_zero = all(bool((p.grad[dead] == 0).all()) for p in params.values())
    print(f"[{card}] fwd+bwd 1080p bench pose: {float(np.median(times)):.3f} "
          f"ms median of {reps} (host clock to synchronize; "
          + ", ".join(f"{t:.3f}" for t in times) + f"), K1 launches {n1}, "
          f"K2 launches {n2} for {reps} calls; grads finite {finite}, dead "
          f"slots' grads 0: {dead_zero}", flush=True)
    if not (n1 == n2 == reps and finite and dead_zero):
        raise SystemExit("FAIL: fwd+bwd at 1080p")
    return params, seen


def bwd_parts_ms(params, c2w, fx, fy, cx, cy, cfg, alive, seen, reps=5):
    """Device time (CUDA events, median of reps) of each part of the
    backward, on the cotangents the fwd+bwd produced: K2, the pair-feature
    gather's backward, and autograd through projection, SH and covariance
    (down from the per-gaussian features to the six parameters)."""
    from gsplat_tpu_torch.ops.binning import bin_gaussians
    from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
    from gsplat_tpu_torch.ops.projection import project_gaussians
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs_bwd
    from gsplat_tpu_torch.ops.rasterize import (_pair_features,
                                                gather_pair_features)
    from gsplat_tpu_torch.ops.sh import evaluate_sh

    c2w_t = torch.as_tensor(c2w, dtype=torch.float32, device=alive.device)
    leaves = list(params.values())
    cov = build_cov3d_packed(params["scale_raw"], params["q_raw"])
    colors = evaluate_sh(params["f_dc"], params["f_rest"], params["pos"],
                         c2w_t)
    proj = project_gaussians(params["pos"], cov, params["opacity_raw"], c2w_t,
                             fx, fy, cx, cy, cfg, extra_valid=alive)
    b = bin_gaussians(proj, cfg)
    feat10 = _pair_features(proj, colors, torch.float32)[
        b.depth_order.long()]
    f10 = feat10.detach().requires_grad_(True)
    pf = gather_pair_features(f10, b.pair_slot, b.gauss_offsets)
    d_pf = seen["d"]
    g_f10 = torch.autograd.grad(pf, f10, d_pf, retain_graph=True)[0]
    parts = {
        "K2": lambda: composite_pairs_bwd(*seen["args"]),
        "gather_bwd": lambda: torch.autograd.grad(pf, f10, d_pf,
                                                  retain_graph=True),
        "proj+sh+cov_bwd": lambda: torch.autograd.grad(
            feat10, leaves, g_f10, retain_graph=True),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        out[name] = float(np.median([cuda_ms(fn, 1) for _ in range(reps)]))
    return out


def train_phase(pool, bench_c2w, center, radius, card):
    """TRAIN_STEPS steps of the port's train step at 960x540, batch 4.
    Returns (K1 launches, K2 launches) of the steps."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs
    from gsplat_tpu_torch.viewer import create_orbit_trajectory

    dev = pool.pos.device
    cfg = gt.RenderConfig(height=TRAIN_H, width=TRAIN_W,
                          max_pairs=TRAIN_PAIRS)
    f = 0.85 * TRAIN_W
    poses = np.concatenate([bench_c2w[None], create_orbit_trajectory(
        center, 4.4 * radius, num_frames=TRAIN_BATCH - 1,
        elevation_deg=15.0)]).astype(np.float32)
    with torch.no_grad():  # ground truth: the unperturbed checkpoint
        images = torch.stack([gt.render_from_params(
            pool.params, p, f, f, TRAIN_W / 2.0, TRAIN_H / 2.0, cfg,
            alive=pool.alive)[0] for p in poses])
    batch = {"image": images, "c2w": torch.from_numpy(poses).to(dev)}
    for k, v in (("fx", f), ("fy", f), ("cx", TRAIN_W / 2.0),
                 ("cy", TRAIN_H / 2.0)):
        batch[k] = torch.full((TRAIN_BATCH,), v, device=dev)
    rng = np.random.default_rng(0)
    start = {k: v.detach().cpu().numpy() for k, v in pool.params.items()}
    for k in ("f_dc", "opacity_raw"):
        start[k] = start[k] + rng.normal(0, 0.1, start[k].shape).astype(
            np.float32)
    tpool = gt.pool_from_numpy(start, pool.alive.cpu().numpy(), device=dev)
    tcfg = gt.TrainConfig(capacity=tpool.capacity, batch_size=TRAIN_BATCH,
                          densification_interval=10**9,
                          opacity_reset_interval=10**9)
    state = gt.init_train_state(tpool, tcfg)
    step = gt.make_train_step(cfg, tcfg)
    dead = ~tpool.alive
    dead_before = {k: v.detach()[dead].clone() for k, v in
                   tpool.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite_pairs.launches = 0
    composite_pairs.bwd_launches = 0
    ms, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    k1, k2 = composite_pairs.launches, composite_pairs.bwd_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["total"]) for m in metrics]
    skipped = [int(m["nonfinite_skipped"]) for m in metrics]
    demand = [int(m["pair_demand"]) for m in metrics]
    dead_same = all(torch.equal(v.detach()[dead], dead_before[k])
                    for k, v in tpool.params.items())
    step_ms = float(np.median(ms[1:]))
    print(f"[{card}] train {TRAIN_STEPS} steps, batch {TRAIN_BATCH} at "
          f"{TRAIN_W}x{TRAIN_H}, {int(tpool.num_alive())} alive of "
          f"{tpool.capacity}: losses " + ", ".join(f"{v:.6f}" for v in losses)
          + f"; skipped {skipped}; pair demand {demand} of {cfg.max_pairs}; "
          f"K1 launches {k1}, K2 launches {k2}; dead slots unchanged: "
          f"{dead_same}", flush=True)
    print(f"[{card}] train step ms (host clock to synchronize): "
          + ", ".join(f"{t:.3f}" for t in ms) + f"; median of steps 2-"
          f"{TRAIN_STEPS} {step_ms:.3f} ms, per view "
          f"{step_ms / TRAIN_BATCH:.3f} ms; peak device memory "
          f"{peak_gib:.2f} GiB", flush=True)
    views = TRAIN_BATCH * TRAIN_STEPS
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and skipped == [0] * TRAIN_STEPS and dead_same
            and k1 == k2 == views and max(demand) <= cfg.max_pairs):
        raise SystemExit("FAIL: training phase")
    parts = train_parts_ms(state, batch, cfg, tcfg)
    print(f"[{card}] train step parts (CUDA events, median of 3, after the "
          f"checked steps): " + ", ".join(f"{k} {v:.3f} ms"
                                         for k, v in parts.items()),
          flush=True)
    return k1, k2


def train_parts_ms(state, batch, cfg, tcfg, reps=3):
    """Device time of a train step and of its parts: the forward of the
    batch (renders + losses), its backward, Adam's update alone, and what
    is left of the step (gradient clip and mask, the non-finite guard)."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.train.trainer import apply_sh_warmup, batch_loss_fn

    params, alive = state.pool.params, state.pool.alive
    step = gt.make_train_step(cfg, tcfg)
    holder = [state]

    def forward():
        return batch_loss_fn(apply_sh_warmup(params, holder[0].step, tcfg),
                             alive, batch, cfg, tcfg)[0]

    def forward_backward():
        for p in params.values():
            p.grad = None
        forward().backward()

    def full_step():
        holder[0] = step(holder[0], batch)[0]

    t = {}
    for name, fn in (("fwd", forward), ("fwd+bwd", forward_backward),
                     ("adam", state.opt_state.step), ("step", full_step)):
        fn()
        t[name] = float(np.median([cuda_ms(fn, 1) for _ in range(reps)]))
    return {"step": t["step"], "forward (4 views + loss)": t["fwd"],
            "backward": t["fwd+bwd"] - t["fwd"], "Adam": t["adam"],
            "clip + mask + guard": t["step"] - t["fwd+bwd"] - t["adam"]}


def image_from_tiles(out, tile_count, cfg):
    """[num_tiles, 8, P] compositor output -> [H, W, 3] image, as
    rasterize_binned assembles it."""
    t = cfg.tile
    occ = (tile_count > 0)[:, None, None]
    rgb = torch.where(occ, out[:, 0:3], 0.0)
    img = rgb.reshape(cfg.tiles_y, cfg.tiles_x, 3, t, t).permute(
        0, 3, 1, 4, 2).reshape(cfg.padded_height, cfg.padded_width, 3)
    return torch.clamp(img[: cfg.height, : cfg.width], 0.0, 1.0)


def cuda_ms(fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stage_ms(params, c2w, fx, fy, cx, cy, cfg, alive, reps=5):
    """Device time of each stage of render_from_params, one at a time on
    the same inputs (CUDA events; median of `reps`). `rasterize_binned`
    holds the pair-feature gather, the kernel and the plane assembly."""
    from gsplat_tpu_torch.ops.binning import bin_gaussians
    from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
    from gsplat_tpu_torch.ops.projection import project_gaussians
    from gsplat_tpu_torch.ops.rasterize import (_pair_features,
                                                gather_pair_features,
                                                rasterize_binned)
    from gsplat_tpu_torch.ops.sh import evaluate_sh

    pos = params["pos"]
    s = serving_path(params, c2w, fx, fy, cx, cy, cfg, alive)
    steps = {
        "cov3d+sh": lambda: (
            build_cov3d_packed(params["scale_raw"], params["q_raw"]),
            evaluate_sh(params["f_dc"], params["f_rest"], pos, s["c2w"])),
        "project": lambda: project_gaussians(
            pos, s["cov"], params["opacity_raw"], s["c2w"], fx, fy, cx, cy,
            cfg, extra_valid=alive),
        "bin": lambda: bin_gaussians(s["proj"], cfg),
        "gather": lambda: gather_pair_features(
            _pair_features(s["proj"], s["colors"], torch.float32)[
                s["bin"].depth_order.long()], s["bin"].pair_slot,
            s["bin"].gauss_offsets),
        "rasterize_binned": lambda: rasterize_binned(
            s["proj"], s["colors"], s["bin"], cfg),
    }
    out = {}
    with torch.no_grad():
        for name, fn in steps.items():
            fn()
            out[name] = float(np.median([cuda_ms(fn, 1) for _ in range(reps)]))
    return out


def bench_pose(pool):
    from gsplat_tpu_torch.viewer import estimate_scene_center_radius, look_at

    pos = pool.pos.detach().cpu().numpy()[pool.alive.cpu().numpy()]
    center, radius = estimate_scene_center_radius(positions=pos)
    cam = center + np.array([0.0, -0.6 * radius, -4.4 * radius])
    return look_at(cam, center), center, radius


def main():
    # --- 1. card ---
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this smoke test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops import _build
    from gsplat_tpu_torch.ops.raster_cuda import (composite_pairs,
                                                  composite_pairs_bwd,
                                                  composite_pairs_bwd_plain,
                                                  composite_pairs_plain)
    from gsplat_tpu_torch.viewer import (create_orbit_trajectory,
                                         make_render_fn, render_trajectory)

    dev = gt.resolve_device("cuda")

    # --- 2. build from the checkout's sources ---
    shutil.rmtree(_build.BUILD_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[{card}] built {sorted(built)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, info in built.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name} ptxas: {line.strip()}")
    print("  raster_bwd dynamic shared memory: (10 + 8 x 10) x G x 4 B per "
          "CTA = 46080 B at pair_block 128")
    errs, bwd_errs = [], []

    # --- 3. kernel vs plain, synthetic scene ---
    cfg = gt.RenderConfig(height=H, width=W, max_pairs=MAX_PAIRS)
    fx = fy = 0.85 * W
    cx, cy = W / 2.0, H / 2.0
    scene, sc2w = make_scene(32768, seed=0)
    sparams = {k: torch.from_numpy(v).to(dev) for k, v in scene.items()}
    sp = serving_path(sparams, sc2w, fx, fy, cx, cy, cfg)
    pf, binning = sp["pair_feat"], sp["bin"]
    out_k = composite_pairs(pf, binning.tile_start, binning.tile_count, cfg)
    out_p = composite_pairs_plain(pf, binning.tile_start, binning.tile_count,
                                  cfg, tile_chunk=1024)
    torch.cuda.synchronize()
    print(f"synthetic: 32768 gaussians, {int(binning.num_pairs)} pairs")
    errs.append(compare("synthetic 1080p", out_k, out_p, binning.tile_count))
    bwd_errs.append(check_bwd("synthetic 1080p", pf, binning, out_k, cfg,
                              seed=1))

    # --- 4. kernel vs plain, trained checkpoint at the bench pose ---
    pool = gt.restore_pool(CKPT, device="cuda")
    c2w, center, radius = bench_pose(pool)
    sp = serving_path(pool.params, c2w, fx, fy, cx, cy, cfg,
                      alive=pool.alive)
    pf, binning = sp["pair_feat"], sp["bin"]
    out_k = composite_pairs(pf, binning.tile_start, binning.tile_count, cfg)
    out_p = composite_pairs_plain(pf, binning.tile_start, binning.tile_count,
                                  cfg, tile_chunk=1024)
    torch.cuda.synchronize()
    n_pairs = int(binning.num_pairs)
    print(f"trained: {int(pool.alive.sum())} alive of {pool.capacity}, "
          f"{n_pairs} pairs of capacity {cfg.max_pairs}")
    errs.append(compare("trained 1080p bench pose", out_k, out_p,
                        binning.tile_count))
    bwd_errs.append(check_bwd("trained 1080p bench pose", pf, binning, out_k,
                              cfg, seed=2))
    plain_img = image_from_tiles(out_p, binning.tile_count, cfg)

    # --- 5. serving through the port's entry points ---
    traj = np.concatenate([
        c2w[None],
        create_orbit_trajectory(center, radius * 4.4, num_frames=8,
                                elevation_deg=15.0),
    ])
    render_fn = make_render_fn(pool.params, cfg, fx, fy, cx, cy,
                               alive=pool.alive, report_demand=True)
    calls = [0]
    served = {}

    def counted(pose):
        calls[0] += 1
        img, probe = render_fn(pose)
        served.setdefault("first", img)  # the warm-up frame: bench pose
        return img, probe

    torch.cuda.reset_peak_memory_stats()
    composite_pairs.launches = 0
    t0 = time.perf_counter()
    _, stats = render_trajectory(counted, traj, keep_frames=False,
                                 pair_capacity=cfg.max_pairs)
    serve_s = time.perf_counter() - t0
    launches = composite_pairs.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] served {len(traj)} poses (+1 warm-up, +{len(traj)} "
          f"pipelined) in {serve_s:.2f} s; render_fn calls {calls[0]}, "
          f"kernel launches {launches}; peak device memory {peak_gib:.2f} "
          f"GiB")
    for i, (ms, npairs, mean) in enumerate(zip(
            stats["frame_ms"], stats["frame_pairs"], stats["frame_mean"])):
        print(f"  [{card}] frame {i}: {ms:.3f} ms (host clock to "
              f"synchronize), pairs {npairs} of {cfg.max_pairs}, overflow "
              f"{npairs > cfg.max_pairs}, image mean {mean:.6f}")
    print(f"  [{card}] mean {stats['mean_ms']:.3f} ms, median "
          f"{stats['median_ms']:.3f} ms, pipelined "
          f"{stats['pipelined_ms']:.3f} ms/frame, overflow frames "
          f"{stats['pair_overflow_frames']}", flush=True)
    if launches != calls[0] or launches < len(traj):
        raise SystemExit(f"FAIL: {launches} kernel launches for {calls[0]} "
                         f"rendered frames")
    img = served["first"]
    if tuple(img.shape) != (H, W, 3) or not bool(torch.isfinite(img).all()):
        raise SystemExit(f"FAIL: served frame {tuple(img.shape)} not finite")
    img_err = float((img - plain_img).abs().max())
    print(f"served bench-pose frame vs plain-compositor image: max abs "
          f"{img_err:.3e}, mean {float(img.mean()):.6f}")
    if img_err > TOL or not 0.0 < float(img.mean()) < 1.0:
        raise SystemExit("FAIL: served frame disagrees with the plain image")

    # --- 6. timing at the bench pose (launches here are not counted) ---
    tc, ts = binning.tile_count, binning.tile_start
    for _ in range(3):
        composite_pairs(pf, ts, tc, cfg)
    torch.cuda.synchronize()
    kernel_ms = cuda_ms(lambda: composite_pairs(pf, ts, tc, cfg), 20)
    composite_pairs_plain(pf, ts, tc, cfg, tile_chunk=1024)
    plain_ms = cuda_ms(
        lambda: composite_pairs_plain(pf, ts, tc, cfg, tile_chunk=1024), 2)
    G, P = cfg.pair_block, cfg.tile * cfg.tile
    blocks = int(torch.where(tc > 0, out_k[:, 5, 0], 0.0).sum())
    ops = blocks * G * P * OPS_PER_PAIR_PIXEL
    nbytes = blocks * FEAT_ROWS * G * 4 + cfg.num_tiles * 8 * P * 4 \
        + 2 * cfg.num_tiles * 4
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    per_frame = launches / calls[0]
    print(f"[{card}] raster_fwd at the bench pose: {kernel_ms:.4f} ms "
          f"(CUDA events, 20 launches), plain {plain_ms:.3f} ms, "
          f"{per_frame:.0f} launch/frame; {blocks} active blocks of "
          f"{cfg.num_pair_blocks}; bound {bound_ms:.4f} ms by {bound_by} "
          f"({ops:.3e} ops, {nbytes:.3e} bytes)", flush=True)
    stages = stage_ms(pool.params, c2w, fx, fy, cx, cy, cfg, pool.alive)
    print(f"[{card}] stages of one bench-pose frame (CUDA events, median "
          f"of 5): " + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()),
          flush=True)

    # --- 7. fwd+bwd at 1080p at the bench pose ---
    gparams, seen = fwd_bwd_phase(pool, c2w, fx, fy, cx, cy, cfg, card)
    parts = bwd_parts_ms(gparams, c2w, fx, fy, cx, cy, cfg, pool.alive, seen)
    print(f"[{card}] backward parts at the bench pose (CUDA events, median "
          f"of 5): " + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items()),
          flush=True)
    del gparams

    # --- 8. training through the port's entry points ---
    train_k1, train_k2 = train_phase(pool, c2w, center, radius, card)

    # --- 9. K2 timing at the bench pose (launches here are not counted) ---
    bargs = seen["args"]  # (pair_feat, tile_start, tile_count, out, gout, cfg)
    for _ in range(3):
        composite_pairs_bwd(*bargs)
    torch.cuda.synchronize()
    bwd_ms = cuda_ms(lambda: composite_pairs_bwd(*bargs), 20)
    composite_pairs_bwd_plain(*bargs, tile_chunk=512)
    bwd_plain_ms = cuda_ms(
        lambda: composite_pairs_bwd_plain(*bargs, tile_chunk=512), 2)
    bblocks = int(torch.where(bargs[2] > 0, bargs[3][:, 5, 0], 0.0).sum())
    bops = bblocks * G * P * OPS_BWD_PER_PAIR_PIXEL
    bbytes = bblocks * 2 * FEAT_ROWS * G * 4 + cfg.num_tiles * 2 * 8 * P * 4
    bt_ops = bops / PEAK_F32_FLOPS * 1e3
    bt_bytes = bbytes / PEAK_BYTES * 1e3
    bwd_bound_ms = max(bt_ops, bt_bytes)
    bwd_bound_by = "operations" if bt_ops >= bt_bytes else "bytes"
    print(f"[{card}] raster_bwd at the bench pose: {bwd_ms:.4f} ms (CUDA "
          f"events, 20 launches), plain {bwd_plain_ms:.3f} ms, "
          f"{train_k2 // (TRAIN_BATCH * TRAIN_STEPS)} launch/view in "
          f"training (K1 {train_k1}, K2 {train_k2} over {TRAIN_STEPS} steps "
          f"of {TRAIN_BATCH} views); {bblocks} active blocks; bound "
          f"{bwd_bound_ms:.4f} ms by {bwd_bound_by} ({bops:.3e} ops, "
          f"{bbytes:.3e} bytes)", flush=True)

    # --- 10. result lines ---
    kernels = [{
        "name": "raster_fwd",
        "route": "cuda",
        "source": "gsplat_tpu_torch/ops/csrc/raster_fwd.cu",
        "replaces": "gsplat_tpu/ops/raster_pallas.py:192",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "raster_bwd",
        "route": "cuda",
        "source": "gsplat_tpu_torch/ops/csrc/raster_bwd.cu",
        "replaces": "gsplat_tpu/ops/raster_pallas.py:243",
        "launches": train_k2,
        "max_abs_err": max(bwd_errs),
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
