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
     time of the backward's parts (K2, the reduction to per-gaussian
     gradients, autograd through projection, SH and covariance);
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
 11. the serving levers on the checkpoint at 1920x1080: the SASS
     instructions of expf and log1pf (probe kernels, cuobjdump), which the
     log kernels' bounds count;
     (a) transmittance_math="log" at the bench pose: K1-log against its
         plain version (rows 0-5 and state bit for bit, its cull's count
         beside the plain test's), K2-log given K1-log's state (BWD_TOL,
         zeros off the composited blocks, two launches bit-identical), the
         log image against the cumprod one; the bench pose and the orbit
         served and one fwd+bwd, with both log counts set to 0 before;
         times, plain times and bounds of both;
     (b) truncation at the bench pose (tile_rank_cap 1024, cull_chunks 64,
         trunc_pairs sized from pair_demand as --auto_pairs does): the
         demand with and without the occlusion cull, K1 on the truncated
         list bit for bit with its plain version and K2 on it as in phase
         4, the cull on against off bit-identical with equal kept pairs,
         the image against the exact one, frame times with and without
         the lever (capacities sized over the trajectory) and the lever's
         stage times, one fwd+bwd;
     (c) overflow (trunc_pairs at half the demand): reported, finite, the
         image equal to the plain compositor's on the same list, no block
         read past the list's end;
     (d) render_trained --orbit_scale 1.0 --num_frames 8 --tile_rank_cap
         1024 --bucket_pairs 4 --max_pairs 2**24: each pose's demand and
         rung, overflow frames, and at every pose (the one of highest
         demand first) the PSNR of the served truncated frame against an
         exact render sized to its demand;
 12. the training levers on the checkpoint:
     (a) the batch of phase 8 (4 views at 960x540) stacked into one list
         (view_tile_rows = the view's tile rows): K1 with rows_mod bit for
         bit with its plain version and its cull's count beside the plain
         test's; the batch image bit for bit against the 4 per-view K1
         images fed the same projections; render_batch_from_params within
         1e-5 of the per-view renders; K1's time over the batch and over
         the 4 views;
     (b) K2 with rows_mod on that list, as in phase 4;
     (c) K2 in compact mode at the 1080p bench pose on phase 7's inputs,
         bwd_pairs grown from the demand as fit() grows it (1.25 x,
         rounded to 1,024): against its plain version (BWD_TOL, zeros past
         the kept blocks, two launches bit-identical, the kept columns
         equal to K2's), its time beside K2's and its bound, the
         reduction's time at both sizes; the gradients with bwd_pairs
         against bwd_pairs = 0 bit for bit (the bench pose, and the batch
         batched), and at half the demand the overflow reported and the
         gradients finite;
     (d) 6 batched train steps (batched_render), without and with the
         compacted backward, each with the counts set to 0 before: the loss
         falls, no step skipped, one K1 and one K2 launch per step; step
         ms beside phase 8's, peak memory, the batched step's parts;
     (e) one fit() of 12 iterations, batched, from bwd_pairs 1,024, which
         must grow;
     (f) batched serving at 1080p, 4 poses a launch: phase 5's poses
         through make_batch_render_fn (the bench-pose frame within 1e-5 of
         phase 5's) and render_trained --render_batch 4 over the orbit;
         frame ms beside phase 5's;
 13. one JSON line {"kernels": [...]} (thirteen kernels), the card line,
     and the final line {"ok": true, "device": {...}}.

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
                                             bound_ms, device_ms,
                                             transcendental_instructions)
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
LEVER_CAP = 1024  # tile_rank_cap of phase 11 (the README's K)
LEVER_CHUNKS = 64  # cull_chunks of phase 11 (the JAX default)
CLOSE_PAIRS = 2**24  # --max_pairs of phase 11d's bucketed close-in orbit


def kernel_resources(ptxas: str, kernel: str, log: bool = False):
    """(registers, static shared bytes) of one instantiation of a
    compositor (``raster_fwd_kernel`` or ``raster_bwd_kernel``, the "cumprod"
    form or, with ``log``, the "log" one) from its library's ptxas report."""
    part = ptxas.split(f"{kernel}ILb{int(log)}E", 1)[1]
    m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?",
                  part.split("Compiling entry", 1)[0])
    return int(m.group(1)), int(m.group(2) or 0)


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


def detached(args):
    """The arguments autograd hands K2, tensors detached (its saved forward
    output is the graph's), so the checks that reuse them record nothing."""
    return tuple(a.detach() if isinstance(a, torch.Tensor) else a
                 for a in args)


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

    def seen_bwd(*args, **kw):  # records what autograd hands K2
        seen["args"] = detached(args)
        seen["d"] = plain_bwd(*args, **kw)
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
    backward, on the cotangents the fwd+bwd produced: K2, the reduction of
    its pair gradients to per-gaussian ones (keys of the composited
    blocks, stable sort, segmented sum), and autograd through projection,
    SH and covariance (down from the per-gaussian features to the six
    parameters)."""
    from gsplat_tpu_torch.ops.binning import bin_gaussians
    from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
    from gsplat_tpu_torch.ops.projection import project_gaussians
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs_bwd
    from gsplat_tpu_torch.ops.rasterize import (_pair_features,
                                                _reduce_pair_grads,
                                                composited_pair_keys)
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
    n = feat10.shape[0]

    def reduction():
        return _reduce_pair_grads(composited_pair_keys(
            b.pair_slot, b.tile_start, seen["args"][3], n, 0, cfg),
            seen["d"], n)

    g_f10 = reduction()
    parts = {
        "K2": lambda: composite_pairs_bwd(*seen["args"]),
        "reduction": reduction,
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
    return k1, k2, step_ms


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


def rup(x):
    """--auto_pairs' sizing (render_trained.py): the demand + 20 %, rounded
    up to 4,096."""
    return max(4096, -(-int(x * 1.2) // 4096) * 4096)


def bwd_bound(bargs, cfg, ops_per_pair_pixel, out_cols=None):
    """K2's bound on the inputs autograd handed it (pair_feat, tile_start,
    tile_count, out, state, gout, cfg): (ms, "bytes" or "operations",
    operations, bytes, composited blocks). Read once: the tile ranges and
    each tile's block count (row 5), the active blocks' feature rows and
    block-start state, rows 0-4 of the forward output and of the cotangent
    of the tiles with active blocks; written once: the whole [10, pairs]
    gradient, zeros included, or in compact mode its [10, out_cols]."""
    G, P = cfg.pair_block, cfg.tile * cfg.tile
    bblocks = int(torch.where(bargs[2] > 0, bargs[3][:, 5, 0], 0.0).sum())
    bops = bblocks * G * P * ops_per_pair_pixel
    btiles = int(((bargs[2] > 0) & (bargs[3][:, 5, 0] > 0)).sum())
    bbytes = cfg.num_tiles * 3 * 4 + bblocks * (FEAT_ROWS * G + 5 * P) * 4 \
        + btiles * 2 * 5 * P * 4 \
        + FEAT_ROWS * (out_cols or bargs[0].shape[1]) * 4
    bt_ops = bops / PEAK_F32_FLOPS * 1e3
    bt_bytes = bbytes / PEAK_BYTES * 1e3
    return (max(bt_ops, bt_bytes), "operations" if bt_ops >= bt_bytes
            else "bytes", bops, bbytes, bblocks)


def grads_of(pool, c2w, fx, fy, cx, cy, cfg):
    """One fwd+bwd of render_from_params (loss mean(im) + mean(im^2)):
    (the inputs autograd handed K2, whether every gradient is finite)."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops import raster_cuda

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in pool.params.items()}
    seen = {}
    plain_bwd = raster_cuda.composite_pairs_bwd

    def seen_bwd(*args, **kw):
        seen["args"] = detached(args)
        return plain_bwd(*args, **kw)

    raster_cuda.composite_pairs_bwd = seen_bwd
    try:
        img, _ = gt.render_from_params(params, c2w, fx, fy, cx, cy, cfg,
                                       alive=pool.alive)
        (torch.mean(img) + torch.mean(img * img)).backward()
        torch.cuda.synchronize()
    finally:
        raster_cuda.composite_pairs_bwd = plain_bwd
    finite = all(bool(torch.isfinite(p.grad).all()) for p in params.values())
    return seen["args"], finite


def log_phase(pool, c2w, traj, fx, fy, cx, cy, cfg, pf, binning, plain_img,
              card, instr):
    """Phase 11a: transmittance_math="log" at the bench pose. K1-log
    against its plain version (rows 0-5 and state bit for bit, the cull's
    count), K2-log given K1-log's state (BWD_TOL, zeros, two launches
    equal), the log image against the cumprod one; then the main path with
    both counts set to 0: the bench pose and the orbit served through
    make_render_fn, and one fwd+bwd of render_from_params. Times and bounds
    of both kernels. Returns the two kernels' entries of the kernels line.
    """
    from gsplat_tpu_torch.ops.raster_cuda import (_composite_fwd,
                                                  composite_pairs,
                                                  composite_pairs_bwd,
                                                  composite_pairs_bwd_plain,
                                                  composite_pairs_plain)
    from gsplat_tpu_torch.profile_kernel import log_ops_per_pair_pixel
    from gsplat_tpu_torch.viewer import make_render_fn, render_trajectory

    cfg_l = cfg.with_(transmittance_math="log")
    ts, tc = binning.tile_start, binning.tile_count
    name = "log, trained 1080p bench pose"
    out_k = composite_pairs(pf, ts, tc, cfg_l)
    out_p, state_p = composite_pairs_plain(pf, ts, tc, cfg_l,
                                           tile_chunk=1024, with_state=True)
    torch.cuda.synchronize()
    err = compare(name, out_k, out_p, tc)
    cull = check_cull(name, pf, ts, tc, out_p, cfg_l)
    bwd_err = check_bwd(name, pf, binning, out_k, state_p, cfg_l, seed=3)
    del state_p
    d_img = float((image_from_tiles(out_p, tc, cfg_l) - plain_img).abs()
                  .max())
    print(f"[{name}] log image vs cumprod image (plain compositors, same "
          f"pairs): max abs {d_img:.3e} (the JAX package's gate on its "
          f"64x64 scene: 2e-6)", flush=True)

    # The main path: serving, then one fwd+bwd, in the log form.
    composite_pairs.log_launches = 0
    composite_pairs.bwd_log_launches = 0
    render_fn = make_render_fn(pool.params, cfg_l, fx, fy, cx, cy,
                               alive=pool.alive, report_demand=True)
    _, stats = render_trajectory(render_fn, traj, keep_frames=False,
                                 pair_capacity=cfg.max_pairs)
    bargs, finite = grads_of(pool, c2w, fx, fy, cx, cy, cfg_l)
    k1n = composite_pairs.log_launches
    k2n = composite_pairs.bwd_log_launches
    print(f"[{card}] log served {len(traj)} poses: mean "
          f"{stats['mean_ms']:.3f} ms, median {stats['median_ms']:.3f} ms, "
          f"pipelined {stats['pipelined_ms']:.3f} ms/frame (host clock), "
          f"overflow frames {stats['pair_overflow_frames']}; one fwd+bwd, "
          f"grads finite {finite}; K1-log launches {k1n}, K2-log launches "
          f"{k2n} (counts set to 0 before)", flush=True)
    if not (finite and k1n == 2 * len(traj) + 2 and k2n == 1
            and stats["pair_overflow_frames"] == 0):
        raise SystemExit("FAIL: the log path's launches or gradients")

    G = cfg.pair_block
    blocks = int(torch.where(tc > 0, out_k[:, 5, 0], 0.0).sum())
    fwd_ms = device_ms(lambda: composite_pairs(pf, ts, tc, cfg_l), 20)
    fwd_plain_ms = device_ms(lambda: composite_pairs_plain(
        pf, ts, tc, cfg_l, tile_chunk=1024), 2)
    ops1 = log_ops_per_pair_pixel(26, instr)
    f_bound, f_by = bound_ms("full", blocks, cfg_l,
                             cull["total"] - cull["skipped"], ops1)
    bwd_ms = device_ms(lambda: composite_pairs_bwd(*bargs), 20)
    bwd_plain_ms = device_ms(lambda: composite_pairs_bwd_plain(
        *bargs, block_chunk=256), 2)
    ops2 = log_ops_per_pair_pixel(OPS_BWD_PER_PAIR_PIXEL, instr)
    b_bound, b_by, bops, bbytes, bblocks = bwd_bound(bargs, cfg_l, ops2)
    state_ms = device_ms(lambda: _composite_fwd(pf, ts, tc, cfg_l,
                                                with_state=True), 20)
    print(f"[{card}] raster_fwd[log] at the bench pose: {fwd_ms:.4f} ms "
          f"(CUDA events, 20 launches; writing the state {state_ms:.4f} "
          f"ms), plain {fwd_plain_ms:.3f} ms; {blocks} active blocks; "
          f"bound {f_bound:.4f} ms by {f_by} ({ops1} operations per reached "
          f"(pair, pixel): log1pf {instr['log1pf']} and expf "
          f"{instr['expf']} SASS instructions; share {f_bound / fwd_ms:.3f})"
          f"; raster_bwd[log]: {bwd_ms:.4f} ms (20 launches), plain "
          f"{bwd_plain_ms:.3f} ms; {bblocks} active blocks; bound "
          f"{b_bound:.4f} ms by {b_by} ({ops2} per (pair, pixel), "
          f"{bops:.3e} ops, {bbytes:.3e} bytes; share "
          f"{b_bound / bwd_ms:.3f})", flush=True)
    entry = dict(route="cuda", library_ms=None)
    return [dict(entry, name="raster_fwd[log]",
                 source="gsplat_tpu_torch/ops/csrc/raster_fwd.cu",
                 replaces="gsplat_tpu/ops/raster_pallas.py:192 (log)",
                 launches=k1n, max_abs_err=err, ms=fwd_ms,
                 plain_ms=fwd_plain_ms, bound_ms=f_bound, bound_by=f_by),
            dict(entry, name="raster_bwd[log]",
                 source="gsplat_tpu_torch/ops/csrc/raster_bwd.cu",
                 replaces="gsplat_tpu/ops/raster_pallas.py:243 (log)",
                 launches=k2n, max_abs_err=bwd_err, ms=bwd_ms,
                 plain_ms=bwd_plain_ms, bound_ms=b_bound, bound_by=b_by)]


def trunc_phase(pool, c2w, traj, fx, fy, cx, cy, cfg, exact_img, card):
    """Phases 11b and 11c: per-tile rank truncation at the bench pose
    (tile_rank_cap LEVER_CAP, LEVER_CHUNKS depth chunks, trunc_pairs sized
    as --auto_pairs does): K1 on the truncated list bit for bit with its
    plain version, K2 on it as in phase 4; the cull on against off
    bit-identical with equal kept pairs and a lower demand; the image
    against the exact one; frame times with and without the lever over the
    served trajectory (exact, lever, lever, exact; the counts set to 0
    around the lever's runs); one fwd+bwd. Then overflow, trunc_pairs at
    half the demand: reported, finite, equal to the plain version on the
    same list, no block read past the list's end. Returns (K1, K2)
    launches of the lever's main-path runs."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops.raster_cuda import (composite_pairs,
                                                  composite_pairs_plain)
    from gsplat_tpu_torch.render import pair_demand
    from gsplat_tpu_torch.viewer import make_render_fn, render_trajectory

    cfg_t = cfg.with_(tile_rank_cap=LEVER_CAP, cull_chunks=LEVER_CHUNKS)

    def demand(c, k):
        with torch.no_grad():
            return tuple(int(x) for x in pair_demand(
                pool.params, c, fx, fy, cx, cy, k, alive=pool.alive))

    dem = [demand(c, cfg_t) for c in traj]  # traj[0] is the bench pose
    pk, _, tk = dem[0]
    nocull = demand(c2w, cfg_t.with_(occlusion_cull=False))[0]
    print(f"[{card}] truncation K={LEVER_CAP} at the bench pose: pair "
          f"demand {pk} with the occlusion cull ({LEVER_CHUNKS} chunks), "
          f"{nocull} without ({pk / nocull - 1:+.1%}); truncated demand "
          f"{tk} slots; orbit poses (pairs, truncated): "
          + ", ".join(f"({d[0]}, {d[2]})" for d in dem[1:]), flush=True)
    if not pk < nocull:
        raise SystemExit("FAIL: the occlusion cull removed no pair")

    cfg_b = cfg_t.with_(trunc_pairs=rup(tk))
    name = f"truncated K={LEVER_CAP}, bench pose"
    sp = serving_path(pool.params, c2w, fx, fy, cx, cy, cfg_b,
                      alive=pool.alive)
    pf, b = sp["pair_feat"], sp["bin"]
    out_k = composite_pairs(pf, b.tile_start, b.tile_count, cfg_b)
    out_p, state_p = composite_pairs_plain(pf, b.tile_start, b.tile_count,
                                           cfg_b, tile_chunk=1024,
                                           with_state=True)
    torch.cuda.synchronize()
    print(f"[{name}] list of {pf.shape[1]} slots (trunc_pairs "
          f"{cfg_b.trunc_pairs}), {int(b.num_pairs_kept)} pairs kept of "
          f"{int(b.num_pairs)}", flush=True)
    compare(name, out_k, out_p, b.tile_count)
    check_cull(name, pf, b.tile_start, b.tile_count, out_p, cfg_b)
    check_bwd(name, pf, b, out_k, state_p, cfg_b, seed=4)
    del state_p, out_p

    with torch.no_grad():
        img_on, aux_on = gt.render_from_params(
            pool.params, c2w, fx, fy, cx, cy, cfg_b, alive=pool.alive)
        img_off, aux_off = gt.render_from_params(
            pool.params, c2w, fx, fy, cx, cy,
            cfg_b.with_(occlusion_cull=False), alive=pool.alive)
    same = bool(torch.equal(img_on, img_off))
    kept = (int(aux_on.num_pairs_kept), int(aux_off.num_pairs_kept))
    d_exact = float((img_on - exact_img).abs().max())
    print(f"[{name}] cull on vs off: image bit-identical {same}, pairs kept "
          f"{kept[0]} / {kept[1]}, pair demand {int(aux_on.num_pairs)} / "
          f"{int(aux_off.num_pairs)}; truncated image vs the exact served "
          f"frame: max abs {d_exact:.3e}", flush=True)
    if not (same and kept[0] == kept[1]
            and int(aux_on.num_pairs) < int(aux_off.num_pairs)):
        raise SystemExit("FAIL: the occlusion cull changed the image")

    # Frame time with and without the lever, capacities as --auto_pairs
    # sizes them over the trajectory.
    cfg_auto = cfg_t.with_(
        max_pairs=min(rup(max(d[0] for d in dem)), cfg.max_pairs),
        trunc_pairs=rup(max(d[2] for d in dem)))
    exact_fn = make_render_fn(pool.params, cfg, fx, fy, cx, cy,
                              alive=pool.alive, report_demand=True)
    lever_fn = make_render_fn(pool.params, cfg_auto, fx, fy, cx, cy,
                              alive=pool.alive, report_demand=True)
    runs = []
    for i, fn in enumerate((exact_fn, lever_fn, lever_fn, exact_fn)):
        if i == 1:
            composite_pairs.launches = 0
            composite_pairs.bwd_launches = 0
        runs.append(render_trajectory(fn, traj, keep_frames=False,
                                      pair_capacity=cfg.max_pairs)[1])
        if i == 2:
            bargs, finite = grads_of(pool, c2w, fx, fy, cx, cy, cfg_b)
            k1, k2 = composite_pairs.launches, composite_pairs.bwd_launches
    print(f"[{card}] served {len(traj)} poses, exact (max_pairs "
          f"{cfg.max_pairs}) / with the lever (max_pairs "
          f"{cfg_auto.max_pairs}, trunc_pairs {cfg_auto.trunc_pairs}), host "
          f"clock: median " + " / ".join(f"{r['median_ms']:.3f}"
                                         for r in runs)
          + " ms; mean " + " / ".join(f"{r['mean_ms']:.3f}" for r in runs)
          + " ms; pipelined " + " / ".join(f"{r['pipelined_ms']:.3f}"
                                           for r in runs)
          + f" ms/frame (runs exact, lever, lever, exact); one truncated "
          f"fwd+bwd: grads finite {finite}; K1 launches {k1}, K2 launches "
          f"{k2} in the lever's runs", flush=True)
    G = cfg.pair_block
    if not (finite and k1 == 2 * (2 * len(traj) + 1) + 1 and k2 == 1
            and all(r["pair_overflow_frames"] == 0 for r in runs)):
        raise SystemExit("FAIL: the truncated path's launches or gradients")
    del bargs
    stages = stage_ms(pool.params, c2w, fx, fy, cx, cy, cfg_auto, pool.alive)
    print(f"[{card}] stages of one bench-pose frame with the lever (CUDA "
          f"events, median of 5): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in stages.items()), flush=True)

    # --- 11c. overflow: trunc_pairs at half the demand ---
    cfg_c = cfg_t.with_(trunc_pairs=tk // 2)
    name = f"truncated K={LEVER_CAP}, trunc_pairs {tk // 2}"
    sp = serving_path(pool.params, c2w, fx, fy, cx, cy, cfg_c,
                      alive=pool.alive)
    pf, b = sp["pair_feat"], sp["bin"]
    out_k = composite_pairs(pf, b.tile_start, b.tile_count, cfg_c)
    out_p = composite_pairs_plain(pf, b.tile_start, b.tile_count, cfg_c,
                                  tile_chunk=1024)
    with torch.no_grad():
        img_c, aux_c = gt.render_from_params(
            pool.params, c2w, fx, fy, cx, cy, cfg_c, alive=pool.alive)
    torch.cuda.synchronize()
    compare(name, out_k, out_p, b.tile_count)
    n = pf.shape[1]
    ts = b.tile_start.long()
    walked = ts + out_k[:, 5, 0].long() * G
    nblk = (b.tile_count.long() + G - 1) // G
    cut = int(((ts + nblk * G > n) & (nblk > 0)).sum())
    inside = bool((walked <= n).all())
    d_plain = float((img_c - image_from_tiles(out_p, b.tile_count, cfg_c))
                    .abs().max())
    reported = int(aux_c.trunc_demand) > aux_c.trunc_capacity
    finite = bool(torch.isfinite(img_c).all())
    print(f"[{name}] overflow reported: {reported} (trunc_demand "
          f"{int(aux_c.trunc_demand)} > capacity {aux_c.trunc_capacity}); "
          f"image finite {finite}, vs the plain compositor on the same list "
          f"max abs {d_plain:.3e}; every walk inside the list's {n} slots: "
          f"{inside} ({cut} tiles cut at the end); vs the exact frame max "
          f"abs {float((img_c - exact_img).abs().max()):.3e}", flush=True)
    if not (reported and finite and d_plain == 0.0 and inside):
        raise SystemExit("FAIL: truncated-list overflow")
    return k1, k2


def bucket_phase(pool, fx, fy, cx, cy, cfg, center, radius, card):
    """Phase 11d: a bucketed close-in orbit through the CLI, as a user runs
    it (render_trained --orbit_scale 1.0 --num_frames 8 --tile_rank_cap
    LEVER_CAP --bucket_pairs 4 --max_pairs CLOSE_PAIRS), with the K1 count
    set to 0 before: each pose's demand and rung, the overflow frames, and
    at every pose, the one of highest demand first, the PSNR of the served
    (truncated) frame against an exact render sized to the pose's demand.
    Returns the K1 launches."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch import render_trained
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs
    from gsplat_tpu_torch.render import pair_demand
    from gsplat_tpu_torch.viewer import create_orbit_trajectory

    argv = ["--checkpoint", CKPT, "--num_frames", "8", "--orbit_scale", "1.0",
            "--tile_rank_cap", str(LEVER_CAP), "--cull_chunks",
            str(LEVER_CHUNKS), "--bucket_pairs", "4", "--max_pairs",
            str(CLOSE_PAIRS), "--benchmark_only"]
    print(f"[{card}] python -m gsplat_tpu_torch.render_trained "
          + " ".join(argv), flush=True)
    composite_pairs.launches = 0
    stats = render_trained.main(argv)
    k1 = composite_pairs.launches
    print(f"[{card}] bucketed close-in orbit: rungs {stats['rungs']}; per "
          f"pose (pairs, truncated slots, rung): " + ", ".join(
              f"({d}, {t}, {stats['rungs'][r]})" for d, t, r in zip(
                  stats["frame_demand"], stats["frame_trunc_demand"],
                  stats["rung_of_frame"]))
          + f"; overflow frames {stats['pair_overflow_frames']} (demand "
          f"above {CLOSE_PAIRS}); median {stats['median_ms']:.3f} ms, mean "
          f"{stats['mean_ms']:.3f} ms, pipelined "
          f"{stats['pipelined_ms']:.3f} ms/frame; K1 launches {k1}",
          flush=True)
    if k1 < 8 or stats["frames"] != 8:
        raise SystemExit("FAIL: the bucketed orbit")

    # Every pose: the served (truncated) frame against an exact render
    # sized to the pose's demand; the pose of highest demand printed first.
    traj = create_orbit_trajectory(center, radius * 1.0, num_frames=8,
                                   elevation_deg=15.0)
    order = np.argsort(stats["frame_demand"])[::-1]
    psnrs = {}
    for i in order:
        cfg_r = stats["rung_cfgs"][stats["rung_of_frame"][i]]
        with torch.no_grad():
            exact_demand = int(pair_demand(pool.params, traj[i], fx, fy, cx,
                                           cy, cfg, alive=pool.alive)[0])
            cfg_x = cfg.with_(max_pairs=rup(exact_demand))
            img_t, aux_t = gt.render_from_params(
                pool.params, traj[i], fx, fy, cx, cy, cfg_r,
                alive=pool.alive)
            img_x, aux_x = gt.render_from_params(
                pool.params, traj[i], fx, fy, cx, cy, cfg_x,
                alive=pool.alive)
            tc = serving_path(pool.params, traj[i], fx, fy, cx, cy, cfg_x,
                              alive=pool.alive)["bin"].tile_count.float()
        mse = float(torch.mean((img_t - img_x) ** 2))
        psnrs[int(i)] = float("inf") if mse == 0 \
            else 10.0 * np.log10(1.0 / mse)
        print(f"[{card}] close-in pose {i}: exact demand {exact_demand} "
              f"pairs (max_pairs {cfg_x.max_pairs}; pairs per tile: median "
              f"{float(torch.median(tc)):.0f}, largest "
              f"{int(aux_x.max_tile_count)}), served truncated at rung "
              f"{cfg_r.max_pairs} (trunc_pairs {cfg_r.trunc_pairs}, demand "
              f"{int(aux_t.num_pairs)}, truncated {int(aux_t.trunc_demand)}"
              f"): PSNR {psnrs[int(i)]:.2f} dB against the exact render, "
              f"max abs {float((img_t - img_x).abs().max()):.3e}",
              flush=True)
        if not (bool(torch.isfinite(img_t).all())
                and int(aux_x.num_pairs) <= cfg_x.max_pairs):
            raise SystemExit("FAIL: the close-in comparison")
        del img_x, aux_x, tc
    print(f"[{card}] close-in orbit, K={LEVER_CAP}: PSNR at the pose of "
          f"highest demand ({int(order[0])}) {psnrs[int(order[0])]:.2f} dB, "
          f"worst over the 8 poses {min(psnrs.values()):.2f} dB", flush=True)
    return k1


def stacked_views(pool, batch, cfg):
    """The batch's per-view projections and colours, made with the calls
    render_batch_from_params makes, and their stacking: (stacked
    projections, their colours [B*N, 3], the stacked config, per-view
    projections, per-view colours)."""
    from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
    from gsplat_tpu_torch.ops.projection import (ProjectedGaussians,
                                                 project_gaussians)
    from gsplat_tpu_torch.ops.sh import evaluate_sh
    from gsplat_tpu_torch.render import stack_view_projections

    p = pool.params
    views = range(batch["c2w"].shape[0])
    with torch.no_grad():
        cov = build_cov3d_packed(p["scale_raw"], p["q_raw"])
        projs = [project_gaussians(
            p["pos"], cov, p["opacity_raw"], batch["c2w"][v], batch["fx"][v],
            batch["fy"][v], batch["cx"][v], batch["cy"][v], cfg,
            extra_valid=pool.alive) for v in views]
        colors = [evaluate_sh(p["f_dc"], p["f_rest"], p["pos"],
                              batch["c2w"][v]) for v in views]
        stacked, bcfg = stack_view_projections(
            ProjectedGaussians(*(torch.stack(f) for f in zip(*projs))), cfg)
    return stacked, torch.cat(colors), bcfg, projs, colors


def binned(proj, colors, cfg):
    """(pair features [10, pairs], binning) of a projection, as
    rasterize_binned gathers them."""
    from gsplat_tpu_torch.ops.binning import bin_gaussians
    from gsplat_tpu_torch.ops.rasterize import _gather, _pair_features

    with torch.no_grad():
        b = bin_gaussians(proj, cfg)
        feat10 = _pair_features(proj, colors, torch.float32)[
            b.depth_order.long()]
        return _gather(feat10, b.pair_slot), b


def param_grads(pool, cfg, c2w, fx, fy, cx, cy, batched=False):
    """One fwd+bwd (loss mean(im) + mean(im^2)) of render_from_params, or
    with ``batched`` of render_batch_from_params over the poses ``c2w``
    [B, 4, 4]: (aux, {leaf: gradient})."""
    import gsplat_tpu_torch as gt

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in pool.params.items()}
    render = gt.render_batch_from_params if batched else gt.render_from_params
    img, aux = render(params, c2w, fx, fy, cx, cy, cfg, alive=pool.alive)
    (torch.mean(img) + torch.mean(img * img)).backward()
    return aux, {k: p.grad for k, p in params.items()}


def grown_bwd_pairs(demand):
    """bwd_pairs as fit() grows it from an observed demand: 1.25 x the
    demand, rounded up to 1,024."""
    return -(-int(demand * 1.25) // 1024) * 1024


def levers_batch_phase(pool, batch, cfg, card):
    """Phase 12a-b: the training batch of phase 8 (B views at 960x540) as
    one stacked list: K1 with rows_mod against its plain version (rows 0-5
    bit for bit, its cull's count beside the plain test's), K2 with
    rows_mod from K1's state as in phase 4, the batch image against the B
    per-view K1 images fed the same projections (bit for bit), and
    render_batch_from_params against per-view renders (within 1e-5). K1
    times, batched and per view. Returns (K1 max abs err, K2 max abs err).
    """
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops.raster_cuda import (composite_pairs,
                                                  composite_pairs_plain)

    B = batch["c2w"].shape[0]
    stacked, colors, bcfg, projs, vcolors = stacked_views(pool, batch, cfg)
    pf, b = binned(stacked, colors, bcfg)
    ts, tc = b.tile_start, b.tile_count
    name = f"batch of {B} at {TRAIN_W}x{TRAIN_H}, view_tile_rows " \
           f"{bcfg.view_tile_rows}"
    out_k = composite_pairs(pf, ts, tc, bcfg)
    out_p, state_p = composite_pairs_plain(pf, ts, tc, bcfg, tile_chunk=1024,
                                           with_state=True)
    torch.cuda.synchronize()
    print(f"[{name}] one list of {pf.shape[1]} slots for {int(b.num_pairs)} "
          f"pairs ({bcfg.num_tiles} tiles, max_pairs {bcfg.max_pairs})",
          flush=True)
    err = compare(name, out_k, out_p, tc)
    cull = check_cull(name, pf, ts, tc, out_p, bcfg)
    bwd_err = check_bwd(name, pf, b, out_k, state_p, bcfg, seed=6)
    del state_p, out_p
    img_b = image_from_tiles(out_k, tc, bcfg).reshape(
        B, cfg.padded_height, cfg.width, 3)[:, :cfg.height]
    views, same = [], []
    for v in range(B):
        pf_v, b_v = binned(projs[v], vcolors[v], cfg)
        out_v = composite_pairs(pf_v, b_v.tile_start, b_v.tile_count, cfg)
        same.append(bool(torch.equal(
            image_from_tiles(out_v, b_v.tile_count, cfg), img_b[v])))
        views.append((pf_v, b_v.tile_start, b_v.tile_count))
    with torch.no_grad():
        imgs, aux = gt.render_batch_from_params(
            pool.params, batch["c2w"], batch["fx"], batch["fy"], batch["cx"],
            batch["cy"], cfg, alive=pool.alive)
        d_rb = max(float((imgs[v] - gt.render_from_params(
            pool.params, batch["c2w"][v], batch["fx"][v], batch["fy"][v],
            batch["cx"][v], batch["cy"][v], cfg, alive=pool.alive)[0])
            .abs().max()) for v in range(B))
    blocks = int(torch.where(tc > 0, out_k[:, 5, 0], 0.0).sum())
    k1_ms = device_ms(lambda: composite_pairs(pf, ts, tc, bcfg), 20)
    k1_views_ms = device_ms(lambda: [composite_pairs(*a, cfg) for a in views],
                            20)
    bound, by = bound_ms("full", blocks, bcfg,
                         cull["total"] - cull["skipped"])
    print(f"[{name}] batch image vs the {B} per-view K1 images on the same "
          f"projections: bit-identical {same}; render_batch_from_params vs "
          f"per-view render_from_params: max abs {d_rb:.3e} (tol 1e-5); "
          f"batch pair demand {int(aux.num_pairs)} of {aux.pair_capacity}; "
          f"K1 over the batch {k1_ms:.4f} ms (CUDA events, 20 launches; "
          f"{blocks} composited blocks; bound {bound:.4f} ms by {by}) vs "
          f"{B} per-view launches {k1_views_ms:.4f} ms", flush=True)
    if not (all(same) and d_rb <= 1e-5
            and int(aux.num_pairs) <= aux.pair_capacity):
        raise SystemExit("FAIL: the batch disagrees with its views")
    return err, bwd_err


def levers_compact_phase(pool, c2w, fx, fy, cx, cy, cfg, batch, train_cfg,
                         bargs, slot, card):
    """Phase 12c: K2 in compact mode at the 1080p bench pose, on the inputs
    the fwd+bwd of phase 7 handed K2 (``bargs``; ``slot`` the bench pose's
    pair_slot; ``batch`` and ``train_cfg`` phase 8's): bwd_pairs sized
    from the demand as fit() grows it, K2 compact against its plain
    version (BWD_TOL, zeros past the kept blocks, two launches
    bit-identical, the kept columns equal to K2's),
    times beside K2's and the reduction's at both sizes; the gradients
    sized against bwd_pairs = 0 bit for bit, at the bench pose and for the
    training batch; overflow at half the demand reported and finite.
    Returns a dict of the numbers the kernels line and phase 12d read."""
    from gsplat_tpu_torch.ops import raster_cuda as rc
    from gsplat_tpu_torch.ops.rasterize import (_reduce_pair_grads,
                                                composited_pair_keys)

    G = cfg.pair_block
    nb = bargs[0].shape[1] // G
    out, ts = bargs[3], bargs[1]
    if not (slot.shape[0] == nb * G and torch.equal(ts, bargs[1])):
        raise SystemExit("FAIL: the bench pose's binning changed")
    demand = int(torch.where(bargs[2] > 0, out[:, 5, 0], 0.0).sum()) * G
    bp = grown_bwd_pairs(demand)
    kb = min(-(-bp // G), nb)
    name = f"K2 compact, bench pose, bwd_pairs {bp}"
    d_full = rc.composite_pairs_bwd(*bargs)
    d_k = rc.composite_pairs_bwd(*bargs, kb=kb)
    d_k2 = rc.composite_pairs_bwd(*bargs, kb=kb)
    d_p = rc.composite_pairs_bwd_plain(*bargs, block_chunk=256, kb=kb)
    off = rc.tile_block_offsets(out)
    blk, _, _, valid = rc.composited_blocks(ts, off, kb, cfg)
    kept = int(valid.sum())
    cols = (blk[valid, None] * G + torch.arange(G, device=blk.device)
            ).reshape(-1)
    torch.cuda.synchronize()
    rel = []
    for r in range(FEAT_ROWS):
        scale = float(d_p[r].abs().max())
        e = float((d_k[r] - d_p[r]).abs().max())
        rel.append(e / scale if scale > 0 else (0.0 if e == 0 else 1.0))
    err = float((d_k - d_p).abs().max())
    zeros = bool((d_k[:, kept * G:] == 0).all())
    same = bool(torch.equal(d_k, d_k2))
    as_k2 = bool(torch.equal(d_k[:, :kept * G], d_full[:, cols]))
    print(f"[{name}] demand {demand} pair slots ({demand // G} blocks) of "
          f"{nb * G}; kb {kb}, {kept} blocks kept; K2 compact vs plain: max "
          f"abs {err:.3e}, max per-row relative {max(rel):.3e} (tol "
          f"{BWD_TOL}); zeros past the kept blocks: {zeros}; two launches "
          f"bit-identical: {same}; kept columns equal to K2's: {as_k2}",
          flush=True)
    if not (max(rel) <= BWD_TOL and zeros and same and as_k2
            and kept == demand // G):
        raise SystemExit("FAIL: K2 compact disagrees with its plain version")
    k2_ms = device_ms(lambda: rc.composite_pairs_bwd(*bargs), 20)
    k2c_ms = device_ms(lambda: rc.composite_pairs_bwd(*bargs, kb=kb), 20)
    plain_ms = device_ms(lambda: rc.composite_pairs_bwd_plain(
        *bargs, block_chunk=256, kb=kb), 2)
    bound, by, bops, bbytes, _ = bwd_bound(bargs, cfg, OPS_BWD_PER_PAIR_PIXEL,
                                           out_cols=kb * G)
    n = pool.capacity

    def reduce(k, d):
        return lambda: _reduce_pair_grads(
            composited_pair_keys(slot, ts, out, n, k, cfg), d, n)

    red_full = device_ms(reduce(0, d_full), 5)
    red_comp = device_ms(reduce(kb, d_k), 5)
    del d_full, d_k, d_k2, d_p
    print(f"[{card}] raster_bwd[compact] at the bench pose: {k2c_ms:.4f} ms "
          f"(CUDA events, 20 launches) against raster_bwd {k2_ms:.4f} ms on "
          f"the same inputs; plain {plain_ms:.3f} ms; bound {bound:.4f} ms "
          f"by {by} ({bops:.3e} ops, {bbytes:.3e} bytes; share "
          f"{bound / k2c_ms:.3f}); the reduction (keys, stable sort of "
          f"{nb * G} / {kb * G} slots, segmented sum) {red_full:.3f} / "
          f"{red_comp:.3f} ms (whole list / compact, CUDA events, median "
          f"of 5)", flush=True)

    # Gradients: sized against bwd_pairs = 0, bit for bit; half: reported.
    fwdbwd = {}
    for label, c in (("0", cfg), ("sized", cfg.with_(bwd_pairs=bp))):
        param_grads(pool, c, c2w, fx, fy, cx, cy)
        torch.cuda.synchronize()
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            aux, g = param_grads(pool, c, c2w, fx, fy, cx, cy)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        fwdbwd[label] = (aux, g, float(np.median(ms)))
    g0, gs = fwdbwd["0"][1], fwdbwd["sized"][1]
    bit = all(torch.equal(g0[k], gs[k]) for k in g0)
    aux_h, g_h = param_grads(pool, cfg.with_(bwd_pairs=demand // 2), c2w, fx,
                             fy, cx, cy)
    reported = int(aux_h.bwd_demand) > aux_h.bwd_capacity
    finite = all(bool(torch.isfinite(v).all()) for v in g_h.values())
    # The training batch, batched, sized from its own demand.
    args = (batch["c2w"], batch["fx"], batch["fy"], batch["cx"], batch["cy"])
    aux_b0, gb0 = param_grads(pool, train_cfg, *args, batched=True)
    bdemand = int(aux_b0.bwd_demand)
    bbp = grown_bwd_pairs(bdemand)
    aux_bs, gbs = param_grads(pool, train_cfg.with_(bwd_pairs=bbp), *args,
                              batched=True)
    bit_b = all(torch.equal(gb0[k], gbs[k]) for k in gb0)
    print(f"[{card}] bench-pose fwd+bwd with bwd_pairs {bp} vs 0: gradients "
          f"bit-identical {bit} (demand {int(fwdbwd['sized'][0].bwd_demand)} "
          f"of capacity {fwdbwd['sized'][0].bwd_capacity}); host clock to "
          f"synchronize, median of 5: {fwdbwd['sized'][2]:.3f} ms vs "
          f"{fwdbwd['0'][2]:.3f} ms; at half the demand (bwd_pairs "
          f"{demand // 2}): overflow reported {reported}, gradients finite "
          f"{finite}; the training batch ({batch['c2w'].shape[0]} views "
          f"batched, demand {bdemand}, bwd_pairs {bbp}, capacity "
          f"{aux_bs.bwd_capacity}): gradients bit-identical to bwd_pairs 0: "
          f"{bit_b}", flush=True)
    if not (bit and reported and finite and bit_b
            and int(fwdbwd["sized"][0].bwd_demand)
            <= fwdbwd["sized"][0].bwd_capacity):
        raise SystemExit("FAIL: the compacted backward's gradients")
    return dict(err=err, ms=k2c_ms, plain_ms=plain_ms, bound=bound, by=by,
                batch_bwd_pairs=bbp, k2_ms=k2_ms)


def levers_train_phase(pool, batch, start, cfg, bwd_pairs, train_ms, card):
    """Phase 12d: TRAIN_STEPS steps with batched_render, without and with
    the compacted backward (bwd_pairs from phase 12c), each with the launch
    counts set to 0 just before it: the loss falls, no step is skipped,
    one K1 and one K2 launch per step (compact with bwd_pairs), no
    overflow; step ms beside phase 8's per-view step, peak memory, and the
    parts of the batched step. Returns the launches {counter: n}."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs

    B = batch["c2w"].shape[0]
    tcfg = gt.TrainConfig(capacity=pool.capacity, batch_size=B,
                          densification_interval=10**9,
                          opacity_reset_interval=10**9, batched_render=True)
    counters = ("launches", "bwd_launches", "bwd_compact_launches")
    total = dict.fromkeys(counters, 0)
    for label, rcfg in (("batched", cfg),
                        (f"batched, bwd_pairs {bwd_pairs}",
                         cfg.with_(bwd_pairs=bwd_pairs))):
        tpool = gt.pool_from_numpy(start, pool.alive.cpu().numpy(),
                                   device=pool.pos.device)
        state = gt.init_train_state(tpool, tcfg)
        step = gt.make_train_step(rcfg, tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            setattr(composite_pairs, c, 0)
        ms, metrics = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append(m)
        n = {c: getattr(composite_pairs, c) for c in counters}
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(m["total"]) for m in metrics]
        skipped = [int(m["nonfinite_skipped"]) for m in metrics]
        over = [int(m["pair_demand"]) > int(m["pair_capacity"])
                or int(m.get("bwd_demand", 0)) > int(m.get("bwd_capacity", 0))
                for m in metrics]
        med = float(np.median(ms[1:]))
        compact = rcfg.bwd_pairs > 0
        print(f"[{card}] train {TRAIN_STEPS} steps, {label}, batch {B} at "
              f"{TRAIN_W}x{TRAIN_H}: losses " + ", ".join(
                  f"{v:.6f}" for v in losses) + f"; skipped {skipped}; pair "
              f"demand {[int(m['pair_demand']) for m in metrics]} of "
              f"{metrics[0]['pair_capacity']}"
              + (f"; bwd demand {[int(m['bwd_demand']) for m in metrics]} of "
                 f"{metrics[0]['bwd_capacity']}" if compact else "")
              + f"; launches {n}; step ms (host clock to synchronize) "
              + ", ".join(f"{t:.3f}" for t in ms) + f"; median of steps 2-"
              f"{TRAIN_STEPS} {med:.3f} ms against {train_ms:.3f} ms per "
              f"view-by-view step (phase 8); peak device memory {peak:.2f} "
              f"GiB", flush=True)
        want = dict(launches=TRAIN_STEPS,
                    bwd_launches=0 if compact else TRAIN_STEPS,
                    bwd_compact_launches=TRAIN_STEPS if compact else 0)
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
                and skipped == [0] * TRAIN_STEPS and not any(over)
                and n == want):
            raise SystemExit(f"FAIL: batched training ({label})")
        for c in counters:
            total[c] += n[c]
    parts = train_parts_ms(state, batch, rcfg, tcfg)
    print(f"[{card}] batched step parts ({label}; CUDA events, median of 3): "
          + ", ".join(f"{k.replace('4 views', f'{B} views batched')} "
                      f"{v:.3f} ms" for k, v in parts.items()), flush=True)
    return total


def levers_fit_phase(pool, batch, start, cfg, card):
    """Phase 12e: one fit() of FIT_ITERS iterations with batched_render,
    the reference ADC of phase 8b (a) and bwd_pairs 1,024, far below the
    batch's demand, with the launch counts set to 0 just before it: the
    overflow is logged and grows bwd_pairs, the losses stay finite, no
    step is skipped, one K1 and one compact K2 launch per iteration, and
    the last step's demand fits. Returns the launches {counter: n}."""
    import importlib
    import tempfile

    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs
    from gsplat_tpu_torch.train import trainer

    fit_mod = importlib.import_module("gsplat_tpu_torch.train.fit")
    B = batch["c2w"].shape[0]
    tcfg = gt.TrainConfig(iterations=FIT_ITERS, batch_size=B,
                          capacity=pool.capacity, checkpoint_interval=10**9,
                          densification_interval=4, densify_until_iter=12,
                          opacity_reset_interval=8, batched_render=True)
    rcfg = cfg.with_(bwd_pairs=1024)
    rec = {"max_pairs": [], "ms": [], "demand": [], "adc": [], "steps": 0,
           "snapshot_at": None}
    lines = []

    def log(msg):
        lines.append(msg)
        print(f"  [fit e] {msg}", flush=True)

    def batches():
        while True:
            yield batch

    counters = ("launches", "bwd_launches", "bwd_compact_launches")
    tmp = tempfile.mkdtemp(prefix="gsplat_fit_")
    try:
        ckpt = os.path.join(tmp, "start.npz")
        trainer.save_checkpoint(ckpt, gt.init_train_state(
            gt.pool_from_numpy(start, pool.alive.cpu().numpy(),
                               device=pool.pos.device), tcfg))
        points = pool.pos.detach()[pool.alive].cpu().numpy()
        real = _instrument_fit(fit_mod, rec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            setattr(composite_pairs, c, 0)
        try:
            state, report = fit_mod.fit(
                batches(), rcfg, tcfg, initial_points=points,
                resume_from=ckpt, log_every=2, log_fn=log,
                device=pool.pos.device)
        finally:
            _restore_fit(fit_mod, real)
        n = {c: getattr(composite_pairs, c) for c in counters}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    m = rec["last_metrics"]
    grew = [x for x in lines if "growing bwd_pairs" in x]
    losses = [v for _, v in report.losses]
    print(f"[{card}] fit (e) batched, bwd_pairs from 1024: logged losses "
          + ", ".join(f"{it}: {v:.6f}" for it, v in report.losses)
          + f"; overflow events {report.overflow_events}; growth lines "
          f"{len(grew)}; last step's bwd demand {int(m['bwd_demand'])} of "
          f"{int(m['bwd_capacity'])}; launches {n}; step ms median "
          f"{float(np.median(rec['ms'])):.3f} (" + ", ".join(
              f"{t:.1f}" for t in rec["ms"]) + f"); peak device memory "
          f"{peak:.2f} GiB; {report.num_gaussians} alive", flush=True)
    if not (grew and all(np.isfinite(losses)) and report.nonfinite_steps == 0
            and n == dict(launches=FIT_ITERS, bwd_launches=0,
                          bwd_compact_launches=FIT_ITERS)
            and int(m["bwd_demand"]) <= int(m["bwd_capacity"])):
        raise SystemExit("FAIL: fit (e), batched with bwd_pairs growth")
    return n


def levers_serve_phase(pool, traj, fx, fy, cx, cy, cfg, served_first,
                       serve_stats, card):
    """Phase 12f: batched serving at 1080p, 4 poses per launch, with the K1
    count set to 0 just before each run: make_batch_render_fn over phase
    5's poses (bench pose + 8-frame orbit; the last batch padded), its
    bench-pose frame against phase 5's served frame (within 1e-5), and
    ``render_trained --render_batch 4`` over the 8-frame orbit. Frame ms
    beside phase 5's. Returns the K1 launches."""
    from gsplat_tpu_torch import render_trained
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs
    from gsplat_tpu_torch.viewer import (make_batch_render_fn,
                                         render_trajectory)

    B = 4
    fn = make_batch_render_fn(pool.params, cfg, fx, fy, cx, cy,
                              alive=pool.alive, batch=B, report_demand=True)
    d_first = float((fn(traj[:B])[0][0] - served_first).abs().max())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite_pairs.launches = 0
    _, st = render_trajectory(fn, traj, batch_size=B, keep_frames=False,
                              pair_capacity=B * cfg.max_pairs)
    k1 = composite_pairs.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    argv = ["--checkpoint", CKPT, "--num_frames", "8", "--orbit_scale", "4.4",
            "--render_batch", str(B), "--max_pairs", str(cfg.max_pairs),
            "--benchmark_only"]
    composite_pairs.launches = 0
    cli = render_trained.main(argv)
    k1_cli = composite_pairs.launches
    print(f"[{card}] batched serving, {B} poses per launch over phase 5's "
          f"{len(traj)} poses: per frame mean {st['mean_ms']:.3f} ms, median "
          f"{st['median_ms']:.3f} ms (host clock to synchronize over a batch, "
          f"/ {B}) against phase 5's per-pose mean "
          f"{serve_stats['mean_ms']:.3f}, median "
          f"{serve_stats['median_ms']:.3f}, pipelined "
          f"{serve_stats['pipelined_ms']:.3f} ms; batch demands "
          f"{st['frame_pairs']} of {B * cfg.max_pairs}, overflow batches "
          f"{st['pair_overflow_frames']}; K1 launches {k1}; peak device "
          f"memory {peak:.2f} GiB; bench-pose frame vs phase 5's: max abs "
          f"{d_first:.3e}", flush=True)
    print(f"[{card}] python -m gsplat_tpu_torch.render_trained "
          + " ".join(argv) + f": per frame mean {cli['mean_ms']:.3f} ms, "
          f"median {cli['median_ms']:.3f} ms, overflow batches "
          f"{cli['pair_overflow_frames']}; K1 launches {k1_cli}", flush=True)
    n_batches = -(-len(traj) // B)
    if not (d_first <= 1e-5 and k1 == n_batches + 1
            and st["pair_overflow_frames"] == 0 and k1_cli == 8 // B + 1
            and cli["pair_overflow_frames"] == 0 and cli["frames"] == 8):
        raise SystemExit("FAIL: batched serving")
    return k1 + k1_cli


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
    regs, smem = kernel_resources(built["raster_fwd"]["ptxas"],
                                  "raster_fwd_kernel")
    print(f"[{card}] raster_fwd (K1) design: 8x4-pixel warps, per-warp pair "
          f"cull, heavy tiles first; {regs} registers, {smem} B shared, "
          f"{fwd_ctas_per_sm(dev)} CTAs of 256 threads per SM (occupancy "
          f"API)", flush=True)
    regs, smem = kernel_resources(built["raster_fwd"]["ptxas"],
                                  "raster_fwd_kernel", log=True)
    bregs = [kernel_resources(built["raster_bwd"]["ptxas"],
                              "raster_bwd_kernel", log)[0]
             for log in (False, True)]
    print(f"[{card}] the log transmittance: raster_fwd[log] {regs} "
          f"registers, {smem} B shared, {fwd_ctas_per_sm(dev, log=True)} "
          f"CTAs per SM; raster_bwd {bregs[0]} registers, raster_bwd[log] "
          f"{bregs[1]}", flush=True)
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
    train_k1, train_k2, train_ms = train_phase(pool, c2w, center, radius,
                                               card)

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
    composite_pairs_bwd_plain(*bargs, block_chunk=256)
    bwd_plain_ms = device_ms(
        lambda: composite_pairs_bwd_plain(*bargs, block_chunk=256), 2)
    bwd_bound_ms, bwd_bound_by, bops, bbytes, bblocks = bwd_bound(
        bargs, cfg, OPS_BWD_PER_PAIR_PIXEL)
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
          f"per CTA), {bregs[0]} registers, a "
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

    # --- 11. the serving levers ---
    instr = transcendental_instructions()
    print(f"[{card}] SASS instructions with the kernels' flags (cuobjdump of "
          f"probe kernels): expf {instr['expf']}, log1pf {instr['log1pf']}",
          flush=True)
    log_entries = log_phase(pool, c2w, traj, fx, fy, cx, cy, cfg, pf,
                            binning, plain_img, card, instr)
    trunc_k1, trunc_k2 = trunc_phase(pool, c2w, traj, fx, fy, cx, cy, cfg,
                                     served["first"], card)
    bucket_k1 = bucket_phase(pool, fx, fy, cx, cy, cfg, center, radius,
                             card)

    # --- 12. the training levers ---
    train_cfg, tbatch, tstart = train_views(pool, c2w, center, radius)
    b_err, b_bwd_err = levers_batch_phase(pool, tbatch, train_cfg, card)
    errs.append(b_err)
    bwd_errs.append(b_bwd_err)
    comp = levers_compact_phase(pool, c2w, fx, fy, cx, cy, cfg, tbatch,
                                train_cfg, bargs, binning.pair_slot, card)
    lever_n = levers_train_phase(pool, tbatch, tstart, train_cfg,
                                 comp["batch_bwd_pairs"], train_ms, card)
    fit_n = levers_fit_phase(pool, tbatch, tstart, train_cfg, card)
    serve_k1 = levers_serve_phase(pool, traj, fx, fy, cx, cy, cfg,
                                  served["first"], stats, card)

    # --- 13. result lines ---
    kernels = [{
        "name": "raster_fwd",
        "route": "cuda",
        "source": "gsplat_tpu_torch/ops/csrc/raster_fwd.cu",
        "replaces": "gsplat_tpu/ops/raster_pallas.py:192",
        "launches": launches + fit_k1 + trunc_k1 + bucket_k1
        + lever_n["launches"] + fit_n["launches"] + serve_k1,
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
        "launches": train_k2 + fit_k2 + trunc_k2 + lever_n["bwd_launches"],
        "max_abs_err": max(bwd_errs),
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "library_ms": None,
    }, {
        "name": "raster_bwd[compact]",
        "route": "cuda",
        "source": "gsplat_tpu_torch/ops/csrc/raster_bwd.cu",
        "replaces": "gsplat_tpu/ops/raster_pallas.py:243 (over the "
                    "compacted block list of rasterize.py:331)",
        "launches": lever_n["bwd_compact_launches"]
        + fit_n["bwd_compact_launches"],
        "max_abs_err": comp["err"],
        "ms": comp["ms"],
        "plain_ms": comp["plain_ms"],
        "bound_ms": comp["bound"],
        "bound_by": comp["by"],
        "library_ms": None,
    }] + log_entries
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
