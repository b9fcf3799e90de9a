"""Stage-level timing of the render pipeline, forward and backward.

Counterpart of ``scripts/profile_stages.py``, with its flags and a
``--device``. Run on the card as

    python -m gsplat_tpu_torch.profile_stages \\
        --checkpoint bench_assets/trained_ckpt.npz [--tile_rank_cap 1024 \\
        --auto_pairs] [--bwd_pairs -1]

It renders the bench pose of the checkpoint (camera at ``center + (0,
-0.6R, -4.4R)``), or ``scene.make_scene(2**17)`` from the origin, and
prints:

* the forward stages of one frame (:func:`stage_ms`: covariance + SH,
  projection, binning, the pair-feature gather a recorded render makes,
  ``rasterize_binned`` as a served frame runs it);
* the parts of the backward of one fwd+bwd (:func:`bwd_parts_ms`: K2, the
  reduction of its pair gradients to per-gaussian ones, autograd through
  projection, SH and covariance);
* the whole forward and fwd+bwd (``utils.profiling.benchmark_fn``, host
  clock to completion).

Stage times are device times on a card (CUDA events behind a busy stream,
``profile_kernel.device_ms``) and host-clock times on the CPU, labelled
so. ``--cull_mode ellipse`` (with ``--max_rows``) profiles the ellipse
cull's binning. :func:`serving_path`, :func:`record_backward` and
:func:`bench_pose` are also the card tests' (``tests/test_torch_gpu*.py``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .profile_kernel import device_ms


def time_ms(fn, iters: int, device: torch.device) -> float:
    """ms per call of ``fn`` on ``device``: device time on a card
    (``device_ms``), else the host clock (CPU operations are complete on
    return)."""
    if device.type == "cuda":
        return device_ms(fn, iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def clock_name(device: torch.device) -> str:
    return ("CUDA events" if device.type == "cuda"
            else "host clock on the CPU")


def bench_pose(pool):
    """The bench camera of a pool: (c2w, center, radius) with the camera
    at ``center + (0, -0.6R, -4.4R)`` looking at the centre (bench.py)."""
    from .viewer import estimate_scene_center_radius, look_at

    pos = pool.pos.detach().cpu().numpy()[pool.alive.cpu().numpy()]
    center, radius = estimate_scene_center_radius(positions=pos)
    cam = center + np.array([0.0, -0.6 * radius, -4.4 * radius])
    return look_at(cam, center), center, radius


def serving_path(params, c2w, fx, fy, cx, cy, cfg, alive=None):
    """The serving path up to the compositor, stage by stage, with the same
    calls as render_from_params: {"cov", "colors", "proj", "bin",
    "pair_feat" [10, pairs]}."""
    from .ops.binning import bin_gaussians
    from .ops.gaussian import build_cov3d_packed
    from .ops.projection import project_gaussians
    from .ops.rasterize import _pair_features, gather_pair_features
    from .ops.sh import evaluate_sh

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


def stage_ms(params, c2w, fx, fy, cx, cy, cfg, alive, reps=5):
    """Device time of each stage of render_from_params, one at a time on
    the same inputs (CUDA events; median of `reps`; the host clock on the
    CPU). "gather" is the pair list a recorded render gathers;
    `rasterize_binned`, run without autograd as a served frame, holds the
    depth-ordered table K1 reads by slot, the compositor and the plane
    assembly."""
    from .ops.binning import bin_gaussians
    from .ops.gaussian import build_cov3d_packed
    from .ops.projection import project_gaussians
    from .ops.rasterize import (_pair_features, gather_pair_features,
                                rasterize_binned)
    from .ops.sh import evaluate_sh

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
            out[name] = float(np.median([time_ms(fn, 1, pos.device)
                                         for _ in range(reps)]))
    return out


def record_backward(params, c2w, fx, fy, cx, cy, cfg, alive):
    """One fwd+bwd of render_from_params (loss mean(im) + mean(im^2)) on
    leaves cloned from ``params``: (the leaves with their gradients,
    ``seen``: the arguments autograd handed the backward compositor as
    ``seen["args"]`` (detached) and ``seen["kw"]``, and what it returned
    as ``seen["d"]``)."""
    from .ops import raster_cuda
    from .render import render_from_params

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    seen = {}
    real = raster_cuda.composite_pairs_bwd

    def seen_bwd(*args, **kw):
        seen["args"] = tuple(a.detach() if isinstance(a, torch.Tensor)
                             else a for a in args)
        seen["kw"] = kw
        seen["d"] = real(*args, **kw)
        return seen["d"]

    raster_cuda.composite_pairs_bwd = seen_bwd
    try:
        img, _ = render_from_params(leaves, c2w, fx, fy, cx, cy, cfg,
                                    alive=alive)
        (torch.mean(img) + torch.mean(img * img)).backward()
    finally:
        raster_cuda.composite_pairs_bwd = real
    return leaves, seen


def bwd_parts_ms(params, c2w, fx, fy, cx, cy, cfg, alive, seen, reps=5):
    """Device time (CUDA events, median of reps; the host clock on the
    CPU) of each part of the backward, on the cotangents the fwd+bwd
    produced: K2 (in compact mode when it ran so, ``seen["kw"]``), the
    reduction of its pair gradients to per-gaussian ones (keys of the
    composited blocks, stable sort, segmented sum), and autograd through
    projection, SH and covariance (down from the per-gaussian features to
    the six parameters)."""
    from .ops.binning import bin_gaussians
    from .ops.gaussian import build_cov3d_packed
    from .ops.projection import project_gaussians
    from .ops.raster_cuda import composite_pairs_bwd
    from .ops.rasterize import (_pair_features, _reduce_pair_grads,
                                composited_pair_keys)
    from .ops.sh import evaluate_sh

    kw = seen.get("kw", {})
    c2w_t = torch.as_tensor(c2w, dtype=torch.float32,
                            device=params["pos"].device)
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
            b.pair_slot, b.tile_start, seen["args"][3], n, kw.get("kb", 0),
            cfg), seen["d"], n)

    g_f10 = reduction()
    parts = {
        "K2": lambda: composite_pairs_bwd(*seen["args"], **kw),
        "reduction": reduction,
        "proj+sh+cov_bwd": lambda: torch.autograd.grad(
            feat10, leaves, g_f10, retain_graph=True),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        out[name] = float(np.median([time_ms(fn, 1, c2w_t.device)
                                     for _ in range(reps)]))
    return out


def _rup(x) -> int:
    """Demand + 20 %, rounded up to 4,096 (the serving CLI's sizing)."""
    return max(4096, -(-int(x * 1.2) // 4096) * 4096)


def main(argv=None) -> dict:
    """Parse ``argv``, print the timings and return them: {"cfg", "stages",
    "bwd_parts", "fwd", "fwd_bwd" (``benchmark_fn`` stats), "num_pairs",
    "max_tile_count", "device"}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cull_mode", default="rect",
                    choices=("rect", "ellipse"))
    ap.add_argument("--max_pairs", type=int, default=5 * 2**19)
    ap.add_argument("--max_rows", type=int, default=0)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--checkpoint", default=None,
                    help="profile a trained .npz pool instead of the "
                         "synthetic scene")
    ap.add_argument("--tile_rank_cap", type=int, default=0,
                    help="per-tile rank truncation; trunc_pairs is "
                         "demand-sized from one probe binning run")
    ap.add_argument("--auto_pairs", action="store_true",
                    help="size max_pairs to 1.2x the probe's (post-cull) "
                         "pair demand, like the serving CLI")
    ap.add_argument("--bwd_pairs", type=int, default=0,
                    help="compacted-backward capacity (-1 = size from the "
                         "probe render's bwd_demand)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed calls per stage (the median is printed)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from .config import RenderConfig
    from .device import resolve_device
    from .render import pair_demand, render_from_params
    from .scene import make_scene
    from .train.trainer import restore_pool
    from .utils.profiling import benchmark_fn

    dev = resolve_device(args.device)
    cfg = RenderConfig(height=args.height, width=args.width,
                       max_pairs=args.max_pairs, max_per_tile=2048,
                       tile_chunk=32, tile_rank_cap=args.tile_rank_cap,
                       cull_mode=args.cull_mode, max_rows=args.max_rows)
    alive = None
    if args.checkpoint:
        pool = restore_pool(args.checkpoint, device=dev)
        params, alive = pool.params, pool.alive
        c2w = bench_pose(pool)[0]
    else:
        params = make_scene(2**17, device=dev)
        c2w = np.eye(4, dtype=np.float32)
    fx = fy = 0.85 * args.width
    cx, cy = args.width / 2.0, args.height / 2.0

    if args.tile_rank_cap or args.auto_pairs:
        # Demand-size the static capacities from one probe binning run
        # (what --auto_pairs does in the serving CLI).
        with torch.no_grad():
            pd, _, td = (int(x) for x in pair_demand(
                params, c2w, fx, fy, cx, cy, cfg, alive=alive))
        if args.tile_rank_cap:
            cfg = cfg.with_(trunc_pairs=_rup(td))
            print(f"trunc slot demand {td} -> trunc_pairs "
                  f"{cfg.trunc_pairs}")
        if args.auto_pairs:
            cfg = cfg.with_(max_pairs=_rup(pd))
            print(f"pair demand {pd} -> max_pairs {cfg.max_pairs}")
    if args.bwd_pairs == -1:
        with torch.no_grad():
            _, paux = render_from_params(params, c2w, fx, fy, cx, cy, cfg,
                                         alive=alive)
        bd = int(paux.bwd_demand)
        cfg = cfg.with_(bwd_pairs=_rup(bd))
        print(f"bwd demand {bd} -> bwd_pairs {cfg.bwd_pairs}")
    elif args.bwd_pairs:
        cfg = cfg.with_(bwd_pairs=args.bwd_pairs)

    clock = clock_name(dev)
    stages = stage_ms(params, c2w, fx, fy, cx, cy, cfg, alive,
                      reps=args.reps)
    leaves, seen = record_backward(params, c2w, fx, fy, cx, cy, cfg, alive)
    parts = bwd_parts_ms(leaves, c2w, fx, fy, cx, cy, cfg, alive, seen,
                         reps=args.reps)
    del leaves, seen

    def fwd():
        with torch.no_grad():
            return render_from_params(params, c2w, fx, fy, cx, cy, cfg,
                                      alive=alive)

    def fwd_bwd():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        img, _ = render_from_params(p, c2w, fx, fy, cx, cy, cfg, alive=alive)
        (torch.mean(img) + torch.mean(img * img)).backward()
        return [v.grad for v in p.values()]

    npix = args.height * args.width
    t_fwd = benchmark_fn(fwd, iters=args.reps, warmup=1, pixels=npix)
    t_fb = benchmark_fn(fwd_bwd, iters=args.reps, warmup=1, pixels=npix)
    img, aux = fwd()

    print(f"--- forward stages ({clock}, median of {args.reps}) ---")
    for k, v in stages.items():
        print(f"{k + ':':18s}{v:9.3f} ms")
    total = sum(stages[k] for k in ("cov3d+sh", "project", "bin",
                                    "rasterize_binned"))
    print(f"{'total:':18s}{total:9.3f} ms  (cov3d+sh + project + bin + "
          f"rasterize_binned)")
    print(f"pairs={int(aux.num_pairs)} max_tile={int(aux.max_tile_count)} "
          f"image mean {float(img.mean()):.4f}")
    print(f"--- backward parts ({clock}, median of {args.reps}) ---")
    for k, v in parts.items():
        print(f"{k + ':':18s}{v:9.3f} ms")
    print(f"--- whole calls (host clock to completion, median of "
          f"{args.reps}) ---")
    print(f"{'fwd full:':18s}{t_fwd['median_ms']:9.3f} ms")
    print(f"{'fwd+bwd full:':18s}{t_fb['median_ms']:9.3f} ms")
    return {"cfg": cfg, "stages": stages, "bwd_parts": parts, "fwd": t_fwd,
            "fwd_bwd": t_fb, "num_pairs": int(aux.num_pairs),
            "max_tile_count": int(aux.max_tile_count), "device": str(dev)}


if __name__ == "__main__":
    main()
