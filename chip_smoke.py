#!/usr/bin/env python
"""GPU smoke test of the PyTorch/CUDA port (gsplat_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):
  1. card check: torch.cuda.is_available(); the card's name and power limit;
  2. build every kernel of the serving path from ``gsplat_tpu_torch/ops/csrc``
     (one nvcc per source, all started together), with ptxas registers/spills;
  3. the forward compositor kernel against its plain PyTorch version on a
     seeded synthetic scene at 1920x1080;
  4. the same on ``bench_assets/trained_ckpt.npz`` at 1920x1080 from the
     bench pose (camera at center + (0, -0.6R, -4.4R));
  5. serving: restore_pool -> make_render_fn -> render_trajectory over the
     bench pose plus an 8-frame orbit at orbit_scale 4.4, with the kernel's
     launch count read around the run, and the served bench-pose frame held
     against the image assembled from the plain compositor's output;
  6. timing of the kernel alone (CUDA events) beside its plain version and
     its bound, and the device time of each stage of one frame;
  7. one JSON line {"kernels": [...]}, the card line, and the final line
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
# Arithmetic operations per active (pair, pixel) in the compositor: du, dv
# (2), q (9), -q/2 (1), exp (1), op*g (1), min (1), alpha*T (1), four sums
# (8), T*(1-alpha) (2). Compares/selects are not counted.
OPS_PER_PAIR_PIXEL = 26
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
FEAT_ROWS = 10


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
        s["pair_feat"] = gather_pair_features(feat10, s["bin"].pair_slot)
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
                s["bin"].depth_order.long()], s["bin"].pair_slot),
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
    errs = []

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

    # --- 7. result lines ---
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
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
