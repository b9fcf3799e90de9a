#!/usr/bin/env python
"""GPU smoke test of the PyTorch/CUDA port (gsplat_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):
  1. card check: torch.cuda.is_available(); the card's name and power limit;
  2. build every kernel of the serving, training and profiling paths from
     ``gsplat_tpu_torch/ops/csrc`` (raster_fwd = K1, raster_bwd = K2,
     raster_ablate = K3's eight bodies in two templates; one nvcc per
     source, all started together), with ptxas registers/spills (a spill
     fails the run) and K1's registers, shared memory and CTAs per SM;
  3. K1, then K2 on a seeded cotangent, against their plain PyTorch versions
     on a seeded synthetic scene at 1920x1080 (K1 rows 0-5 bit-identical to
     the plain version; K1 writing its block-start state: output
     bit-identical to K1 without it, state bit-identical to the plain
     forward's; K1's per-warp pair cull: the share of (pair, warp) the
     plain test ``pair_warp_reach`` skips in the composited blocks, none
     with a non-zero alpha, and the kernel's own count beside it; K2, given
     K1's state: within BWD_TOL, exact zeros outside the composited blocks,
     finite, a second call bit-identical);
  4. the same on ``bench_assets/trained_ckpt.npz`` at 1920x1080 from the
     bench pose (camera at center + (0, -0.6R, -4.4R));
  5. serving: restore_pool -> make_render_fn -> render_trajectory over the
     bench pose plus an 8-frame orbit at orbit_scale 4.4, with the kernel's
     launch count read around the run, and the served bench-pose frame held
     against the image assembled from the plain compositor's output;
  6. timing of K1 alone (CUDA events), without and with state writing,
     beside its plain version, its bound (the (pair, pixel) its cull
     reaches and the cull's own operations, against the bytes) and the
     TPU kernel's work (every (pair, pixel) of a composited block), and the
     device time of each stage of one frame;
  7. fwd+bwd at 1080p at the bench pose (render_from_params, loss
     mean(im) + mean(im^2), .backward()): one K1 and one K2 launch per call,
     finite gradients, dead slots' gradients 0, ms per call, and the device
     time of the backward's parts;
  8. training: init_train_state -> make_train_step -> 6 steps of batch 4 at
     960x540 on the checkpoint with f_dc and opacity perturbed, ground truth
     rendered from the unperturbed checkpoint: the loss falls, no step is
     skipped, dead slots do not move, K1 and K2 launch views x steps times,
     no pair overflow; step ms, per-view ms, peak device memory;
 8b. fit(): four runs of 12 iterations on the batch of phase 8, each
     resumed from the perturbed checkpoint that the port's save_checkpoint
     wrote: (a) reference ADC at the JAX defaults, (b) as (a) with
     max_grad 1e-9, which must grow the pool past 131,072 slots (and
     max_pairs where a logged pair demand exceeds it), (c) paper ADC, (d)
     as (a) from max_pairs 2**20, which must grow max_pairs. Each:
     finite losses, no skipped step, K1 and K2 launched views x iterations
     times; (a), (c) the final loss below the first logged after the last
     densification. Then (a)'s iteration-6 checkpoint reloaded bit for bit,
     direct adc_step_paper and adc_step calls on (a)'s state, the latter at
     (b)'s max_grad, each of which must spawn (alive count; counts, reset
     mask and every child row as the rule gives them; moments zeroed on
     the reset slots and unchanged elsewhere, rows outside them
     unchanged), and (c)'s uv_grad_sum through K2 within
     BWD_TOL of the plain backward compositor. ADC counts, capacities,
     max_pairs, step ms, ADC ms and peak memory per run;
  9. timing of K2 alone (CUDA events) at the bench pose, on the inputs the
     fwd+bwd of phase 7 gave it, with its registers, CTAs launched and
     active and the state's bytes, beside its plain version and its bound;
 10. the compositor-ablation profiler (K3): K1 and the eight K3 kernels
     (raster_ablate.cu: cumprod, pg-roll, pg-log, no-transc, no-mxu,
     no-compute, no-input, empty) against their plain versions on the
     profiler's 1080p workload (K1 rows 0-5 bit for bit, and its cull as in
     phase 3), and cumprod and pg-* also against K1's plain version (they
     compute K1's function), the plain versions' times, then
     ``profile_kernel.main(["--iters", "20"])`` with the launch counts set to
     0 just before it: ms, ns/block and share of bound of each variant, each
     launch count, the tile-0 digests against the plain versions', and K1's
     time minus each variant's;
 11. one JSON line {"kernels": [...]}, the card line, and the final line
     {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.
"""

import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# One definition of the card's peak rates, K1's bound and the device timer
# (CUDA events behind a busy stream), shared with the profiler.
from gsplat_tpu_torch.profile_kernel import (PEAK_BYTES, PEAK_F32_FLOPS,
                                             bound_ms, device_ms)
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "bench_assets", "trained_ckpt.npz")
H, W = 1080, 1920
MAX_PAIRS = 2**22
# K3 kernels vs plain, rows 0-4 abs (both round alike: -fmad=false); K1
# must equal its plain version bit for bit.
TOL = 2e-5
# K2 vs plain, rows 0-9, relative to each row's max abs: alpha, T and w
# round alike; the pixel sums' order, fused multiply-adds in the ten
# partials and the division's fast path (raster_bwd.cu) differ.
BWD_TOL = 1e-5
# Arithmetic operations per active (pair, pixel) in K2 (raster_bwd.cu),
# counted as K1's are in profile_kernel.OPS_PER_PAIR_PIXEL: du, dv (2),
# q (9), -q/2 (1), exp (1), op*g (1), min (1), w = alpha*T (1), gdotc (7),
# gP += gdotc*w (2), gS (1), 1-alpha and its floor (2), dalpha (4:
# gdotc*T, gS+gTT, divide, subtract), dq (3), the u and v partials (6
# each), the three conic partials (2, 3, 2), the opacity partial (1), the
# four colour partials (4), the four prefix sums (8), T*(1-alpha) (2), and
# one add per partial for the pixel sum (10).
OPS_BWD_PER_PAIR_PIXEL = 79
# The TPU body each ablation kernel replaces (scripts/profile_kernel.py).
ABLATION_REPLACES = {
    "empty": "scripts/profile_kernel.py:222",
    "no-compute": "scripts/profile_kernel.py:173",
    "no-transc": "scripts/profile_kernel.py:50",
    "no-mxu": "scripts/profile_kernel.py:145",
    "no-input": "scripts/profile_kernel.py:184",
    "cumprod": "scripts/profile_kernel.py:90",
    "pg-roll": "scripts/profile_kernel.py:231 (roll)",
    "pg-log": "scripts/profile_kernel.py:231 (log)",
}
FEAT_ROWS = 10
TRAIN_H, TRAIN_W = 540, 960  # the reference's training resolution
TRAIN_PAIRS = 2**21
TRAIN_BATCH = 4
TRAIN_STEPS = 6
FIT_ITERS = 12  # iterations of each fit() run of phase 8b


def k1_resources(ptxas: str):
    """(registers, static shared bytes) of K1's compositor from its ptxas
    report (the library also holds the one-CTA tile-order kernel)."""
    kernel = ptxas.split("raster_fwd_kernel", 1)[1]
    m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", kernel)
    return int(m.group(1)), int(m.group(2))


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
    """K1 vs plain on every tile: rows 0-5 bit for bit."""
    occ = tile_count > 0
    err = float((out_k[:, 0:5] - out_p[:, 0:5]).abs().max())
    same = bool(torch.equal(out_k[:, 0:6], out_p[:, 0:6]))
    finite = bool(torch.isfinite(out_k).all())
    print(f"[{name}] K1 vs plain: rows 0-5 bit-identical: {same} (max abs "
          f"err rows 0-4 {err:.3e}), finite: {finite}, occupied tiles "
          f"{int(occ.sum())}", flush=True)
    if not (same and finite):
        raise SystemExit(f"FAIL: {name}: K1 disagrees with its plain version")
    return err


def check_cull(name, pf, ts, tc, out_p, cfg):
    """K1's per-warp pair cull on the blocks the plain forward composited:
    the share of (pair, warp) the plain test ``pair_warp_reach`` skips,
    none of them with a non-zero alpha at any of the warp's 32 pixels, and
    the count K1 reports for the same inputs (printed beside it; they
    should be equal). Returns ``raster_cuda.cull_audit``'s counts."""
    from gsplat_tpu_torch.ops.raster_cuda import (_launch_fwd, active_blocks,
                                                  cull_audit,
                                                  tile_block_offsets)

    blk, tile, _ = active_blocks(ts, tile_block_offsets(out_p), cfg)
    n = cull_audit(pf, blk, tile, cfg)
    counter = torch.zeros(1, dtype=torch.int64, device=pf.device)
    _launch_fwd(pf, ts, tc, cfg, skipped=counter)
    kernel = int(counter.item())
    total = max(n["total"], 1)
    print(f"[{name}] K1 cull: plain test skips {n['skipped']} of "
          f"{n['total']} (pair, warp) = {n['skipped'] / total:.4f} in "
          f"{blk.shape[0]} composited blocks ({n['zero'] / total:.4f} have "
          f"alpha == 0 at all 32 pixels), {n['unsafe']} with a non-zero "
          f"alpha; the kernel reports {kernel} skipped (difference "
          f"{kernel - n['skipped']})", flush=True)
    if n["unsafe"]:
        raise SystemExit(f"FAIL: {name}: the cull skips a pair with a "
                         f"non-zero alpha")
    return n


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


def check_bwd(name, pf, binning, out, state_p, cfg, seed):
    """K1 writing its block-start state: output bit-identical to `out` (K1
    without state), state bit-identical to the plain forward's `state_p`
    at the composited blocks. Then K2, given K1's state, vs its plain
    version on a seeded cotangent: rows 0-9 within BWD_TOL of each row's
    max abs, exact zeros outside the composited blocks, finite, and a
    second launch bit-identical. Returns the max abs error."""
    from gsplat_tpu_torch.ops.raster_cuda import (_composite_fwd,
                                                  composite_pairs_bwd,
                                                  composite_pairs_bwd_plain)

    ts, tc = binning.tile_start, binning.tile_count
    out_s, state = _composite_fwd(pf, ts, tc, cfg, with_state=True)
    torch.cuda.synchronize()
    act = active_slots(binning, out, cfg)[::cfg.pair_block]
    same_out = bool(torch.equal(out_s, out))
    same_state = bool(torch.equal(state[act], state_p[act]))
    print(f"[{name}] K1 with state writing: output bit-identical to K1 "
          f"without: {same_out}; state of the {int(act.sum())} composited "
          f"blocks bit-identical to the plain forward's: {same_state}",
          flush=True)
    if not (same_out and same_state):
        raise SystemExit(f"FAIL: {name}: K1's state disagrees")
    gen = torch.Generator(device=pf.device).manual_seed(seed)
    gout = torch.randn(cfg.num_tiles, 8, cfg.tile**2, generator=gen,
                       device=pf.device)
    args = (pf, ts, tc, out, state, gout, cfg)
    d_p = composite_pairs_bwd_plain(*args, block_chunk=256)
    off = ~active_slots(binning, out, cfg)
    d_k = composite_pairs_bwd(*args)
    d_k2 = composite_pairs_bwd(*args)
    torch.cuda.synchronize()
    rel = []
    for r in range(FEAT_ROWS):
        scale = float(d_p[r].abs().max())
        err = float((d_k[r] - d_p[r]).abs().max())
        rel.append(err / scale if scale > 0 else (0.0 if err == 0 else 1.0))
    zeros = bool((d_k[:, off] == 0).all())
    finite = bool(torch.isfinite(d_k).all())
    same = bool(torch.equal(d_k, d_k2))
    err = float((d_k - d_p).abs().max())
    print(f"[{name}] K2 vs plain: max abs err {err:.3e}, max per-row "
          f"relative {max(rel):.3e} (tol {BWD_TOL}), zeros outside the "
          f"{int((~off).sum()) // cfg.pair_block} composited blocks: "
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
        out[name] = float(np.median([device_ms(fn, 1) for _ in range(reps)]))
    return out


def train_views(pool, bench_c2w, center, radius):
    """The training workload at 960x540: (cfg, batch of the bench pose and
    3 orbit poses with ground truth rendered from the unperturbed
    checkpoint, the checkpoint's parameters as numpy with f_dc and
    opacity_raw + N(0, 0.1))."""
    import gsplat_tpu_torch as gt
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
    return cfg, batch, start


def train_phase(pool, bench_c2w, center, radius, card):
    """TRAIN_STEPS steps of the port's train step at 960x540, batch 4.
    Returns (K1 launches, K2 launches) of the steps."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs

    dev = pool.pos.device
    cfg, batch, start = train_views(pool, bench_c2w, center, radius)
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
        t[name] = float(np.median([device_ms(fn, 1) for _ in range(reps)]))
    return {"step": t["step"], "forward (4 views + loss)": t["fwd"],
            "backward": t["fwd+bwd"] - t["fwd"], "Adam": t["adam"],
            "clip + mask + guard": t["step"] - t["fwd+bwd"] - t["adam"]}


def _state_snapshot(state) -> dict:
    """Clones of everything a checkpoint holds: step, alive, the six
    parameters, and each leaf's Adam step count and moments."""
    snap = {"step": state.step.clone(), "alive": state.pool.alive.clone()}
    for k, p in state.pool.params.items():
        st = state.opt_state.state[p]
        snap[k] = p.detach().clone()
        for f in ("step", "exp_avg", "exp_avg_sq"):
            snap[f"{k}.{f}"] = st[f].clone()
    return snap


def _instrument_fit(fit_mod, rec):
    """Wrap the names fit() calls (make_train_step, adc_step,
    adc_step_paper) to record, per run: each step's host ms (to
    synchronize()) and pair demand, the max_pairs of each step it builds,
    the state after step ``rec["snapshot_at"]``, and each ADC call's
    result, capacity before it and CUDA events around it. Returns the
    originals, for :func:`_restore_fit`."""
    real = (fit_mod.make_train_step, fit_mod.adc_step, fit_mod.adc_step_paper)

    def make(render_cfg, train_cfg):
        rec["max_pairs"].append(render_cfg.max_pairs)
        step = real[0](render_cfg, train_cfg)

        def timed(state, batch):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["steps"] += 1
            rec["demand"].append((rec["steps"], int(m["pair_demand"]),
                                  int(m["pair_capacity"])))
            rec["last_metrics"] = m
            if rec["steps"] == rec["snapshot_at"]:
                rec["snapshot"] = _state_snapshot(state)
            return state, m
        return timed

    def adc(fn):
        def timed(state, *args, **kw):
            cap = state.pool.capacity
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, res = fn(state, *args, **kw)
            ev[1].record()
            rec["adc"].append((rec["steps"], cap, ev, res))
            return state, res
        return timed

    fit_mod.make_train_step = make
    fit_mod.adc_step = adc(real[1])
    fit_mod.adc_step_paper = adc(real[2])
    return real


def _restore_fit(fit_mod, real):
    fit_mod.make_train_step, fit_mod.adc_step, fit_mod.adc_step_paper = real


def expected_spawns(before, prune, split, clone, child, parent=None):
    """What an ADC call must write, from its masks and child rows as the
    rule defines them (not from models/adc.py): the r-th spawner in slot
    order takes the r-th slot that is free after pruning, spawners past
    the free slots are dropped. Returns (parents, children, overflowed,
    reset mask, {param: (slots, rows)}): each child slot holds its
    parent's child row; with ``parent`` (the paper split's child A), each
    fitting split's own slot holds that row."""
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


def check_adc_identities(name, state, call, expect, card):
    """One direct ADC call on ``state``, timed (profile_kernel.device_ms;
    the call waits for the device where it indexes by a mask, so that
    wait is inside the time), against ``expect(before)`` (reference_spawns
    or paper_spawns on the state before the call, with the call's noise):
    it must spawn; its counts, new_slot_mask and every written row are
    what the rule gives (positions within 1e-6 of their largest value,
    since the paper form's rotation is summed in another order; the rest
    exact); alive after = before - pruned + split + cloned; exp_avg and
    exp_avg_sq exactly 0 on new_slot_mask and unchanged elsewhere, step
    counts unchanged; every parameter row outside new_slot_mask
    unchanged, the dead slots that received no spawn among them. Returns
    the ms."""
    before = _state_snapshot(state)
    parents, children, overflow, reset, rows = expect(before)
    out = {}
    ms = device_ms(lambda: out.setdefault("r", call()), 1)
    state, res = out["r"]
    pool = state.pool
    n0, n1 = int(before["alive"].sum()), int(pool.alive.sum())
    counts = [int(getattr(res, f)) for f in (
        "num_pruned", "num_split", "num_cloned", "num_overflowed")]
    mask = res.new_slot_mask
    kept = ~mask
    spawned = counts[1] + counts[2]
    ok_alive = n1 == n0 - counts[0] + spawned
    ok_spawn = (spawned > 0 and spawned == len(children)
                and counts[3] == overflow and torch.equal(mask, reset))
    ok_moments = ok_rows = True
    for k, p in pool.params.items():
        st = state.opt_state.state[p]
        for f in ("exp_avg", "exp_avg_sq"):
            ok_moments &= bool((st[f][mask] == 0).all()) and bool(
                torch.equal(st[f][kept], before[f"{k}.{f}"][kept]))
        ok_moments &= bool(torch.equal(st["step"], before[f"{k}.step"]))
        ok_rows &= bool(torch.equal(p.detach()[kept], before[k][kept]))
        slots, want = rows[k]
        got = p.detach()[slots]
        if k == "pos":
            ok_spawn &= bool((got - want).abs().max() <= 1e-6 * max(
                1.0, float(want.abs().max())))
        else:
            ok_spawn &= bool(torch.equal(got, want))
    print(f"[{card}] {name} on the state run (a) returned: {ms:.3f} ms "
          f"(CUDA events); pruned {counts[0]}, split {counts[1]}, cloned "
          f"{counts[2]}, overflowed {counts[3]}; alive {n0} -> {n1} "
          f"(= before - pruned + split + cloned: {ok_alive}); spawned, and "
          f"counts, reset mask and the {len(children)} child slots (each "
          f"holding its parent's row, split offset applied) as the rule "
          f"gives: {ok_spawn}; moments 0 on the {int(mask.sum())} reset "
          f"slots and unchanged elsewhere, counts unchanged: {ok_moments}; "
          f"rows outside the reset slots unchanged (among them "
          f"{int((~before['alive'] & kept).sum())} dead slots that received "
          f"no spawn): {ok_rows}", flush=True)
    if not (ok_alive and ok_spawn and ok_moments and ok_rows):
        raise SystemExit(f"FAIL: {name} identities")
    return ms


def uv_statistics(state, batch, cfg, tcfg, plain=False):
    """(uv_grad_sum, visible, max_radius) of one paper-mode step on
    ``state`` without its update; with ``plain`` the backward compositor
    is its plain version (composite_pairs_bwd_plain) in place of K2."""
    from gsplat_tpu_torch.ops import raster_cuda
    from gsplat_tpu_torch.train.trainer import value_and_grads

    real = raster_cuda.composite_pairs_bwd
    if plain:
        raster_cuda.composite_pairs_bwd = functools.partial(
            raster_cuda.composite_pairs_bwd_plain, block_chunk=256)
    try:
        _, m, _ = value_and_grads(state, batch, cfg, tcfg)
    finally:
        raster_cuda.composite_pairs_bwd = real
    torch.cuda.synchronize()
    return m["uv_grad_sum"], m["visible"], m["max_radius"]


def fit_checks_a(res, runs, batch, dev, card):
    """Run (a)'s iteration-6 checkpoint, loaded into a fresh state, equals
    the state after step 6 bit for bit; then one direct adc_step_paper and
    one adc_step (at (b)'s max_grad) on the state (a) returned, each
    spawning, with their identities and child rows.
    Returns the two calls' ms."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.train import trainer

    state, report, rec = res["state"], res["report"], res["rec"]
    path = next(c for c in report.checkpoints if c.endswith("000006.npz"))
    fresh = gt.init_train_state(gt.init_pool_from_points(
        np.zeros((4, 3), np.float32), 8, device=dev), runs["a"])
    loaded = _state_snapshot(trainer.load_checkpoint(path, fresh))
    saved = rec["snapshot"]
    same = loaded.keys() == saved.keys() and all(
        torch.equal(loaded[k], saved[k]) for k in saved)
    print(f"[{card}] fit (a): the iteration-6 checkpoint loaded into a fresh "
          f"state equals the state after step 6 bit for bit (step, alive, "
          f"params, moments, counts; {len(saved)} tensors): {same}",
          flush=True)
    if not same:
        raise SystemExit("FAIL: checkpoint reload")
    # The paper call first, on (a)'s state as it came back; then the
    # reference call with (b)'s max_grad, so that it spawns (at (a)'s
    # max_grad it only prunes) and runs out of free slots.
    gen = torch.Generator(device=dev).manual_seed(1)
    uv, vis, rad = uv_statistics(state, batch, res["cfg"], runs["c"])
    avg = uv / torch.clamp(vis, min=1).to(torch.float32)
    eps = tuple(torch.randn(state.pool.pos.shape, generator=gen, device=dev)
                for _ in range(2))
    paper_ms = check_adc_identities(
        "adc_step_paper", state, lambda: trainer.adc_step_paper(
            state, avg, rad, None, runs["c"], noise=eps),
        lambda b: paper_spawns(b, avg, rad, eps, runs["c"]), card)
    tcfg = runs["b"]
    grad = rec["last_metrics"]["pos_grad"]
    noise = torch.randn(state.pool.pos.shape, generator=gen, device=dev)
    adc_ms = check_adc_identities(
        "adc_step", state, lambda: trainer.adc_step(
            state, grad, None, (tcfg.prune_opacity_threshold, tcfg.max_grad,
                                tcfg.scale_threshold), noise=noise),
        lambda b: reference_spawns(b, grad, noise, tcfg), card)
    return adc_ms, paper_ms


def fit_run(fit_mod, name, tcfg, cfg, batch, points, start_ckpt, out_dir,
            card):
    """One fit() run with the launch counts set to 0 just before it and
    read just after, its record (_instrument_fit) and its checks: finite
    losses, no skipped step, K1 and K2 launched views x iterations times;
    (a), (c): the final loss below the first logged after the last
    densification; (b): the pool grew past its capacity; (d): max_pairs
    grew and the last step's demand fits it; (b), (d): "growing max_pairs"
    was logged wherever a logged pair demand exceeded the capacity.
    Returns a dict of what the later checks read."""
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs

    rec = {"max_pairs": [], "ms": [], "demand": [], "adc": [], "steps": 0,
           "snapshot_at": 6 if name == "a" else None}
    lines = []

    def log(msg):
        lines.append(msg)
        print(f"  [fit {name}] {msg}", flush=True)

    def batches():
        while True:
            yield batch

    cap0 = tcfg.capacity
    real = _instrument_fit(fit_mod, rec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite_pairs.launches = 0
    composite_pairs.bwd_launches = 0
    try:
        state, report = fit_mod.fit(
            batches(), cfg, tcfg, output_dir=out_dir, initial_points=points,
            resume_from=start_ckpt, log_every=2, log_fn=log,
            device=batch["image"].device)
    finally:
        _restore_fit(fit_mod, real)
    k1, k2 = composite_pairs.launches, composite_pairs.bwd_launches
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    views = TRAIN_BATCH * FIT_ITERS
    adc = [(it, capb, ev[0].elapsed_time(ev[1]), [int(getattr(r, f)) for f in (
        "num_pruned", "num_split", "num_cloned", "num_overflowed")])
        for it, capb, ev, r in rec["adc"]]
    print(f"[{card}] fit ({name}) {tcfg.adc_mode} ADC, {FIT_ITERS} "
          f"iterations of batch {TRAIN_BATCH} at {TRAIN_W}x{TRAIN_H}: logged "
          f"losses " + ", ".join(f"{it}: {v:.6f}" for it, v in report.losses)
          + f"; nonfinite steps {report.nonfinite_steps}; overflow events "
          f"{report.overflow_events}; K1 launches {k1}, K2 launches {k2} "
          f"(views x iterations = {views})", flush=True)
    for it, capb, ms, c in adc:
        print(f"  [{card}] fit ({name}) densification at iteration {it}: "
              f"pruned {c[0]}, split {c[1]}, cloned {c[2]}, overflowed "
              f"{c[3]} (capacity {capb}); {ms:.3f} ms (CUDA events around "
              f"the ADC call)", flush=True)
    print(f"  [{card}] fit ({name}): capacity {cap0} -> "
          f"{state.pool.capacity}, {report.num_gaussians} alive at the end; "
          f"max_pairs {rec['max_pairs'][0]} -> {rec['max_pairs'][-1]}; pair "
          f"demand per step " + ", ".join(
              f"{it}: {d}/{c}" for it, d, c in rec["demand"])
          + f"; step ms (host clock to synchronize) median "
          f"{float(np.median(rec['ms'])):.3f} (" + ", ".join(
              f"{t:.1f}" for t in rec["ms"]) + f"); peak device memory "
          f"{peak_gib:.2f} GiB; wall {report.wall_time_s:.2f} s", flush=True)
    losses = [v for _, v in report.losses]
    ok = (all(np.isfinite(losses)) and report.nonfinite_steps == 0
          and k1 == k2 == views and len(rec["ms"]) == FIT_ITERS)
    if name in ("a", "c"):
        last = max(it for it, *_ in adc)
        after = [v for it, v in report.losses if it > last][0]
        ok &= report.final_loss < after
        print(f"  [{card}] fit ({name}): final loss {report.final_loss:.6f} "
              f"below the first logged after the last densification "
              f"({after:.6f}): {report.final_loss < after}", flush=True)
    if name == "b":
        grew = any("growing pool capacity" in m for m in lines)
        ok &= (report.overflow_events >= 1 and grew
               and state.pool.capacity > cap0 and report.num_gaussians > cap0)
    if name == "d":
        ok &= (rec["max_pairs"][-1] > cfg.max_pairs
               and rec["demand"][-1][1] <= rec["demand"][-1][2])
    if name in ("b", "d"):
        logged = {it for it, _ in report.losses}
        for it, d, c in rec["demand"]:
            if it in logged and d > c:
                ok &= any(m.startswith(f"iter {it}: pair overflow")
                          and "growing max_pairs" in m for m in lines)
    if not ok:
        raise SystemExit(f"FAIL: fit run ({name})")
    return dict(state=state, report=report, rec=rec, k1=k1, k2=k2,
                cfg=cfg.with_(max_pairs=rec["max_pairs"][-1]))


def fit_phase(pool, bench_c2w, center, radius, card):
    """Phase 8b: fit() at full width from the perturbed checkpoint, four
    runs of FIT_ITERS iterations on the batch of phase 8, each resumed from
    one file the port's save_checkpoint wrote (the perturbed pool, a fresh
    optimizer state): (a) reference ADC at the JAX defaults; (b) as (a)
    with max_grad 1e-9, so that the pool must grow; (c) paper ADC; (d) as
    (a) from max_pairs 2**20, so that max_pairs must grow. Then the
    iteration-6 checkpoint of (a) against the state after step 6, direct
    adc_step and adc_step_paper calls on (a)'s state, and (c)'s
    uv_grad_sum through K2 against the plain backward compositor.
    Returns (K1 launches, K2 launches) of the runs."""
    import importlib
    import tempfile

    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.train import trainer

    fit_mod = importlib.import_module("gsplat_tpu_torch.train.fit")
    dev = pool.pos.device
    cfg, batch, start = train_views(pool, bench_c2w, center, radius)
    points = pool.pos.detach()[pool.alive].cpu().numpy()
    common = dict(iterations=FIT_ITERS, batch_size=TRAIN_BATCH,
                  capacity=pool.capacity, checkpoint_interval=6)
    ref = dict(common, densification_interval=4, densify_until_iter=12,
               opacity_reset_interval=8)
    runs = {
        "a": gt.TrainConfig(**ref),
        "b": gt.TrainConfig(**ref, max_grad=1e-9),
        "c": gt.TrainConfig(**common, adc_mode="paper",
                            densify_grad_threshold=2e-4,
                            scene_extent=float(radius), max_screen_size=0,
                            densification_interval=6, densify_until_iter=12,
                            opacity_reset_interval=10**9),
        # (d) starts at max_pairs TRAIN_PAIRS / 2 = 2**20, below the 1.22 M
        # pairs a view needs.
        "d": gt.TrainConfig(**ref),
    }
    k1 = k2 = 0
    tmp = tempfile.mkdtemp(prefix="gsplat_fit_")
    try:
        start_ckpt = os.path.join(tmp, "start.npz")
        trainer.save_checkpoint(start_ckpt, gt.init_train_state(
            gt.pool_from_numpy(start, pool.alive.cpu().numpy(), device=dev),
            runs["a"]))
        for name, tcfg in runs.items():
            rcfg = cfg.with_(max_pairs=TRAIN_PAIRS // 2) if name == "d" \
                else cfg
            res = fit_run(fit_mod, name, tcfg, rcfg, batch, points,
                          start_ckpt, os.path.join(tmp, name), card)
            k1 += res["k1"]
            k2 += res["k2"]
            if name == "a":
                fit_checks_a(res, runs, batch, dev, card)
            if name == "c":
                paper = res
            shutil.rmtree(os.path.join(tmp, name), ignore_errors=True)
            del res

        # (c): uv_grad_sum through K2 against the plain backward compositor.
        uv_k, vis_k, rad_k = uv_statistics(paper["state"], batch,
                                           paper["cfg"], runs["c"])
        uv_p, vis_p, rad_p = uv_statistics(paper["state"], batch,
                                           paper["cfg"], runs["c"],
                                           plain=True)
        scale = float(uv_p.abs().max())
        err = float((uv_k - uv_p).abs().max())
        same = bool(torch.equal(vis_k, vis_p) and torch.equal(rad_k, rad_p))
        print(f"[{card}] fit (c): one paper step's uv_grad_sum through K2 vs "
              f"the plain backward compositor: max abs {err:.3e} of max "
              f"{scale:.3e} (relative {err / max(scale, 1e-30):.3e}, tol "
              f"{BWD_TOL}); {int((vis_k > 0).sum())} gaussians visible; "
              f"visible and max_radius exact: {same}", flush=True)
        if not (scale > 0 and err <= BWD_TOL * scale and same):
            raise SystemExit("FAIL: uv_grad_sum through K2 disagrees with "
                             "the plain backward compositor")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return k1, k2


def ablation_phase(card, dev):
    """Phase 10: K1 and the eight K3 kernels against their plain versions
    on the profiler's 1080p workload (K1 rows 0-5 bit for bit and its cull
    checked; the K3 kernels rows 0-4 within TOL, row 5 exact; rows 6-7
    zero, finite), cumprod and pg-* also against K1's plain
    version (rows 0-4 within TOL, row 5 exact), each plain version's time,
    then the profiler through its entry point with every launch count set
    to 0 just before.
    Returns ({variant: max abs error}, {variant: plain ms}, {variant: the
    profiler's result}, {variant: launches in the profiler's run}, the
    share of (pair, warp) K1's cull skips)."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch import profile_kernel
    from gsplat_tpu_torch.ops.raster_ablate import (K1_FUNCTION, ablate,
                                                    ablate_plain)
    from gsplat_tpu_torch.ops.raster_cuda import (composite_pairs,
                                                  composite_pairs_plain)

    cfg = gt.RenderConfig(height=H, width=W, max_pairs=2**18)
    pf, ts, tc = (t.to(dev) for t in profile_kernel.make_workload(cfg, 4))
    pairs = {"full": (composite_pairs, composite_pairs_plain)}
    pairs.update({v: (functools.partial(ablate, v),
                      functools.partial(ablate_plain, v))
                  for v in profile_kernel.VARIANTS if v != "full"})
    errs, plain_ms, digests = {}, {}, {}
    for name, (kernel, plain) in pairs.items():
        plain_fn = functools.partial(plain, pf, ts, tc, cfg, tile_chunk=512)
        out_k = kernel(pf, ts, tc, cfg)
        out_p = plain_fn()
        torch.cuda.synchronize()
        errs[name] = float((out_k[:, 0:5] - out_p[:, 0:5]).abs().max())
        # K1 must equal its plain version bit for bit, rows 0-5.
        tol, first, exact = (0.0, 0, "rows 0-5") if name == "full" else \
            (TOL, 5, "row 5")
        same5 = bool(torch.equal(out_k[:, first:6], out_p[:, first:6]))
        zero67 = bool((out_k[:, 6:] == 0).all())
        finite = bool(torch.isfinite(out_k).all())
        digests[name] = float(out_p[0, 0:5].sum())
        print(f"[profile workload 1080p] {name} vs plain: max abs err rows "
              f"0-4 {errs[name]:.3e} (tol {tol}), {exact} exact: {same5}, "
              f"rows 6-7 zero: {zero67}, finite: {finite}, blocks composited "
              f"{int(out_k[:, 5, 0].sum())}", flush=True)
        if not (errs[name] <= tol and same5 and zero67 and finite):
            raise SystemExit(f"FAIL: {name} disagrees with its plain version")
        if name == "full":
            k1_plain = out_p
            n = check_cull("profile workload 1080p", pf, ts, tc, out_p, cfg)
            cull = n["skipped"] / n["total"]
        else:
            plain_ms[name] = device_ms(plain_fn, 1)
        if name in K1_FUNCTION:
            err_k1 = float((out_k[:, 0:5] - k1_plain[:, 0:5]).abs().max())
            same5_k1 = bool(torch.equal(out_k[:, 5], k1_plain[:, 5]))
            print(f"[profile workload 1080p] {name} vs K1's plain version: "
                  f"max abs err rows 0-4 {err_k1:.3e} (tol {TOL}), row 5 "
                  f"exact: {same5_k1}", flush=True)
            if not (err_k1 <= TOL and same5_k1):
                raise SystemExit(f"FAIL: {name} disagrees with K1's plain "
                                 f"version")
        del out_k, out_p
    del k1_plain

    # The slice's main path: the profiler, as a user runs it.
    composite_pairs.launches = 0
    for v in ablate.launches:
        ablate.launches[v] = 0
    res = {r["name"]: r for r in profile_kernel.main(
        ["--iters", "20", "--device", str(dev)])}
    counts = {name: profile_kernel.launch_count(name) for name in pairs}
    print(f"[{card}] profiler launches (counts set to 0 before it): "
          + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
    # K1 has its per-warp cull and the K3 bodies keep its older skeleton, so
    # each difference mixes the redesign with the class the variant removes.
    print(f"[{card}] K1 minus each variant (CUDA events, one call; K1's "
          f"redesign and the removed class together): "
          + ", ".join(f"{v} {res['full']['ms'] - res[v]['ms']:+.4f} ms"
                      for v in pairs if v != "full"), flush=True)
    for name in pairs:
        r = res[name]
        if counts[name] == 0 or r["launches"] != counts[name] \
                or not r["ms"] > 0 or abs(r["digest"] - digests[name]) > 1e-3:
            raise SystemExit(f"FAIL: profiler variant {name}: {r}, plain "
                             f"digest {digests[name]}, {counts[name]} "
                             f"launches")
    return errs, plain_ms, res, counts, cull


def image_from_tiles(out, tile_count, cfg):
    """[num_tiles, 8, P] compositor output -> [H, W, 3] image, as
    rasterize_binned assembles it."""
    t = cfg.tile
    occ = (tile_count > 0)[:, None, None]
    rgb = torch.where(occ, out[:, 0:3], 0.0)
    img = rgb.reshape(cfg.tiles_y, cfg.tiles_x, 3, t, t).permute(
        0, 3, 1, 4, 2).reshape(cfg.padded_height, cfg.padded_width, 3)
    return torch.clamp(img[: cfg.height, : cfg.width], 0.0, 1.0)


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
            out[name] = float(np.median([device_ms(fn, 1)
                                         for _ in range(reps)]))
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
    from gsplat_tpu_torch.ops.raster_cuda import (_composite_fwd,
                                                  composite_pairs,
                                                  composite_pairs_bwd,
                                                  composite_pairs_bwd_plain,
                                                  composite_pairs_plain,
                                                  fwd_ctas_per_sm)
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
            if any(w in line for w in ("registers", "spill", "smem",
                                       "properties")):
                print(f"  {name} ptxas: {line.strip()}")
            spills = re.search(r"(\d+) bytes spill stores", line)
            if spills and int(spills.group(1)) > 0:
                raise SystemExit(f"FAIL: {name} spills registers: {line}")
    print("  raster_bwd dynamic shared memory: (10 + 2 warps x 10) x G x 4 B "
          "per CTA = 15360 B at pair_block 128")
    regs, smem = k1_resources(built["raster_fwd"]["ptxas"])
    print(f"[{card}] raster_fwd (K1) design: 8x4-pixel warps, per-warp pair "
          f"cull, heavy tiles first; {regs} registers, {smem} B shared, "
          f"{fwd_ctas_per_sm(dev)} CTAs of 256 threads per SM (occupancy "
          f"API)", flush=True)
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
    out_p, state_p = composite_pairs_plain(
        pf, binning.tile_start, binning.tile_count, cfg, tile_chunk=1024,
        with_state=True)
    torch.cuda.synchronize()
    print(f"synthetic: 32768 gaussians, {int(binning.num_pairs)} pairs")
    errs.append(compare("synthetic 1080p", out_k, out_p, binning.tile_count))
    check_cull("synthetic 1080p", pf, binning.tile_start, binning.tile_count,
               out_p, cfg)
    bwd_errs.append(check_bwd("synthetic 1080p", pf, binning, out_k, state_p,
                              cfg, seed=1))
    del state_p

    # --- 4. kernel vs plain, trained checkpoint at the bench pose ---
    pool = gt.restore_pool(CKPT, device="cuda")
    c2w, center, radius = bench_pose(pool)
    sp = serving_path(pool.params, c2w, fx, fy, cx, cy, cfg,
                      alive=pool.alive)
    pf, binning = sp["pair_feat"], sp["bin"]
    out_k = composite_pairs(pf, binning.tile_start, binning.tile_count, cfg)
    out_p, state_p = composite_pairs_plain(
        pf, binning.tile_start, binning.tile_count, cfg, tile_chunk=1024,
        with_state=True)
    torch.cuda.synchronize()
    n_pairs = int(binning.num_pairs)
    print(f"trained: {int(pool.alive.sum())} alive of {pool.capacity}, "
          f"{n_pairs} pairs of capacity {cfg.max_pairs}")
    errs.append(compare("trained 1080p bench pose", out_k, out_p,
                        binning.tile_count))
    bench_cull = check_cull("trained 1080p bench pose", pf,
                            binning.tile_start, binning.tile_count, out_p,
                            cfg)
    bench_reached = bench_cull["total"] - bench_cull["skipped"]
    bwd_errs.append(check_bwd("trained 1080p bench pose", pf, binning, out_k,
                              state_p, cfg, seed=2))
    del state_p
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
    kernel_ms = device_ms(lambda: composite_pairs(pf, ts, tc, cfg), 20)
    state_ms = device_ms(
        lambda: _composite_fwd(pf, ts, tc, cfg, with_state=True), 20)
    kernel_ms2 = device_ms(lambda: composite_pairs(pf, ts, tc, cfg), 20)
    composite_pairs_plain(pf, ts, tc, cfg, tile_chunk=1024)
    plain_ms = device_ms(
        lambda: composite_pairs_plain(pf, ts, tc, cfg, tile_chunk=1024), 2)
    G, P = cfg.pair_block, cfg.tile * cfg.tile
    blocks = int(torch.where(tc > 0, out_k[:, 5, 0], 0.0).sum())
    # The reached (pair, pixel) and the cull's own operations, against the
    # bytes; the TPU kernel's work (every (pair, pixel) of a composited
    # block) beside it, which the bound counted before K1 had its cull.
    k1_bound_ms, k1_bound_by = bound_ms("full", blocks, cfg, bench_reached)
    tpu_bound_ms, tpu_bound_by = bound_ms("full", blocks, cfg)
    per_frame = launches / calls[0]
    print(f"[{card}] raster_fwd at the bench pose: {kernel_ms:.4f} ms "
          f"(CUDA events, 20 launches; again after the state timing "
          f"{kernel_ms2:.4f} ms; writing the block-start state, as autograd "
          f"asks, {state_ms:.4f} ms), plain {plain_ms:.3f} ms, "
          f"{per_frame:.0f} launch/frame; {blocks} active blocks of "
          f"{cfg.num_pair_blocks}; bound {k1_bound_ms:.4f} ms by "
          f"{k1_bound_by} ({bench_reached} of {bench_cull['total']} (pair, "
          f"warp) reached; share of bound {k1_bound_ms / kernel_ms:.3f}); "
          f"TPU work (every (pair, pixel)) {tpu_bound_ms:.4f} ms by "
          f"{tpu_bound_by}", flush=True)
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

    # --- 8b. fit(): density control, checkpoints, growth ---
    fit_k1, fit_k2 = fit_phase(pool, c2w, center, radius, card)

    # --- 9. K2 timing at the bench pose (launches here are not counted) ---
    # (pair_feat, tile_start, tile_count, out, state, gout, cfg)
    bargs = seen["args"]
    for _ in range(3):
        composite_pairs_bwd(*bargs)
    torch.cuda.synchronize()
    bwd_ms = device_ms(lambda: composite_pairs_bwd(*bargs), 20)
    ctas = composite_pairs.bwd_ctas
    regs = re.search(r"Used (\d+) registers", built["raster_bwd"]["ptxas"])
    composite_pairs_bwd_plain(*bargs, block_chunk=256)
    bwd_plain_ms = device_ms(
        lambda: composite_pairs_bwd_plain(*bargs, block_chunk=256), 2)
    bblocks = int(torch.where(bargs[2] > 0, bargs[3][:, 5, 0], 0.0).sum())
    bops = bblocks * G * P * OPS_BWD_PER_PAIR_PIXEL
    # Read once: the tile ranges and each tile's block count (row 5), the
    # active blocks' feature rows and block-start state, rows 0-4 of the
    # forward output and of the cotangent of the tiles with active blocks;
    # written once: the whole [10, pairs] gradient, zeros included.
    btiles = int(((bargs[2] > 0) & (bargs[3][:, 5, 0] > 0)).sum())
    bbytes = cfg.num_tiles * 3 * 4 + bblocks * (FEAT_ROWS * G + 5 * P) * 4 \
        + btiles * 2 * 5 * P * 4 + FEAT_ROWS * bargs[0].shape[1] * 4
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
    n_blocks = bargs[0].shape[1] // G
    state = bargs[4]
    print(f"[{card}] raster_bwd design: 4 pixels per thread (64 threads "
          f"per CTA), {regs.group(1) if regs else '?'} registers, a "
          f"persistent grid of {ctas} CTAs over the {bblocks} composited "
          f"blocks of {n_blocks}; block-start state {state.numel() * 4} B "
          f"allocated, {bblocks * 5 * P * 4} B written by K1; share of bound "
          f"{bwd_bound_ms / bwd_ms:.3f}", flush=True)

    # --- 10. the compositor-ablation profiler (K3) ---
    abl_errs, abl_plain_ms, prof, prof_counts, prof_cull = ablation_phase(
        card, dev)
    print(f"[{card}] K1's cull skips "
          f"{bench_cull['skipped'] / bench_cull['total']:.4f} of the (pair, "
          f"warp) of the composited blocks at the bench pose, "
          f"{prof_cull:.4f} on the profiler workload", flush=True)
    errs.append(abl_errs["full"])

    # --- 11. result lines ---
    kernels = [{
        "name": "raster_fwd",
        "route": "cuda",
        "source": "gsplat_tpu_torch/ops/csrc/raster_fwd.cu",
        "replaces": "gsplat_tpu/ops/raster_pallas.py:192",
        "launches": launches + fit_k1,
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound_ms,
        "bound_by": k1_bound_by,
        "library_ms": None,
    }, {
        "name": "raster_bwd",
        "route": "cuda",
        "source": "gsplat_tpu_torch/ops/csrc/raster_bwd.cu",
        "replaces": "gsplat_tpu/ops/raster_pallas.py:243",
        "launches": train_k2 + fit_k2,
        "max_abs_err": max(bwd_errs),
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "library_ms": None,
    }]
    kernels += [{
        "name": f"raster_ablate[{v}]",
        "route": "cuda",
        "source": "gsplat_tpu_torch/ops/csrc/raster_ablate.cu",
        "replaces": ABLATION_REPLACES[v],
        "launches": prof_counts[v],
        "max_abs_err": abl_errs[v],
        "ms": prof[v]["ms"],
        "plain_ms": abl_plain_ms[v],
        "bound_ms": prof[v]["bound_ms"],
        "bound_by": prof[v]["bound_by"],
        "library_ms": None,
    } for v in ABLATION_REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
