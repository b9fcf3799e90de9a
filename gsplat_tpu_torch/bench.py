"""The system's end-to-end benchmark: one JSON line of frame rates, step
times and pair demands, on the synthetic garden-scale scene and on the
trained checkpoint.

Counterpart of ``bench.py`` at the repository root, function by function,
with its flags, its measurements in its order and its keys, each computed
by its formula. Run on the card as

    python -m gsplat_tpu_torch.bench [--ellipse-ab]

and on the CPU (plain PyTorch compositor) with ``--device cpu`` at a small
``--height``/``--width``/``--gaussians``. The last line of standard output
is ``{"metric": "render_fps_1080p_trained", "value", "unit",
"vs_baseline", ...}``: the headline is the served 1080p frame of the
trained checkpoint (``bench_assets/trained_ckpt.npz`` when present, else
the synthetic scene's frame as ``render_fps_1080p``). Its numbers are this
process's device's (``"device"``: the card's name and power limit as
``nvidia-smi`` prints them, or ``cpu``).

Times are host-clock times of whole loops, from a
``torch.cuda.synchronize()`` before the loop to one after it (on the CPU
the operations are complete on return), divided by the loop's calls.
Unlike ``bench.py`` a part that fails raises: no ``*_error`` key is
written and the process exits non-zero. ``--no-parity`` is accepted; the
gradient parity against the original PyTorch reference (``bench.py``'s
``pixel_grad_*`` keys) is not ported, and no such key is written.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .config import RenderConfig, TrainConfig
from .device import resolve_device
from .models.gaussians import GaussianPool
from .profile_kernel import PEAK_BYTES
from .profile_stages import bench_pose
from .render import pair_demand, render_from_params
from .scene import make_scene
from .train.trainer import init_train_state, make_train_step, restore_pool

DEFAULT_CKPT = "bench_assets/trained_ckpt.npz"
# The configurations of bench.py, as constants so that a test on the CPU
# can shrink the capacities and the train bench's sizes.
SYNTH_PAIRS = 5 * 2**19  # the synthetic scene's max_pairs (:572-578)
CKPT_PAIRS = 2**22  # the checkpoint's max_pairs and max_per_tile (:196)
CKPT_PER_TILE = 4096
ELLIPSE_PAIRS = 3 * 2**20  # the ellipse A/B's max_pairs, max_rows (:333)
ELLIPSE_ROWS = 2**20
TRUNC_CAP = 1024  # the truncation A/B's tile_rank_cap (:366)
TRAIN_WIDTH, TRAIN_HEIGHT = 960, 540  # the train bench (:452-458) and
TRAIN_BATCH = 4  # the half-resolution forward (:626-640)
TRAIN_PAIRS = 2**20


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _loop_s(fn, n: int, dev: torch.device):
    """One untimed call of ``fn``, then (seconds per call over ``n`` calls,
    from a sync before the loop to one after it; the last call's result)."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    _sync(dev)
    return (time.perf_counter() - t0) / n, out


def _sized(demand, headroom: float = 1.2) -> int:
    """``demand`` x ``headroom``, rounded up to 4,096 (bench.py's sizing)."""
    return max(4096, -(-int(demand * headroom) // 4096) * 4096)


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, or ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def roofline_forward(cfg: RenderConfig, n_gaussians: int,
                     measured_s: float) -> dict:
    """bench.py's forward roofline (:151-176): the same traffic model over
    the H100's HBM3 rate (``profile_kernel.PEAK_BYTES``).

    Traffic (f32, padded pair capacity C): the sort's ~4 merge passes over
    (key, payload) read and written, 4*2*2*4*C; the pair-feature gather,
    26*4*C; the tile planes written and read, 2*32*P_img; the per-gaussian
    stages, 80*4*N. The fraction is speed-of-light time over ``measured_s``.
    """
    C = cfg.padded_pairs
    img_px = cfg.num_tiles * 8 * cfg.tile * cfg.tile
    bytes_moved = (4 * 2 * 2 * 4 * C + 26 * 4 * C + 2 * 4 * img_px
                   + 80 * 4 * n_gaussians)
    sol_s = bytes_moved / PEAK_BYTES
    return {
        "roofline_fwd_gbytes": round(bytes_moved / 1e9, 3),
        "roofline_fwd_sol_ms": round(sol_s * 1e3, 3),
        "roofline_fwd_fraction": round(sol_s / measured_s, 3),
    }


def _trained_scene_setup(path, height, width, dev):
    """The checkpoint and its bench pose (camera at ``center + (0, -0.6R,
    -4.4R)``), deterministic from the file, so the isolated child renders
    the same workload (bench.py:179-199)."""
    pool = restore_pool(path, device=dev)
    c2w = bench_pose(pool)[0]
    cfg = RenderConfig(height=height, width=width, max_pairs=CKPT_PAIRS,
                       max_per_tile=CKPT_PER_TILE)
    fx = fy = 0.85 * width
    return pool, c2w, fx, fy, cfg


def _served(pool, c2w, fx, fy, cfg):
    """The served forward of the checkpoint (no autograd, as
    ``viewer.make_render_fn`` serves)."""
    def fwd():
        with torch.no_grad():
            return render_from_params(pool.params, c2w, fx, fy,
                                      cfg.width / 2, cfg.height / 2, cfg,
                                      alive=pool.alive)
    return fwd


def _trained_fwd_bwd_fps(pool, c2w, fx, fy, cfg, iters):
    """fwd+bwd calls per second of the loss mean(im) + mean(im^2) with
    respect to the six parameters: one warm-up, then max(iters // 2, 3)
    timed calls (bench.py:202-222; its host fetches were a TPU runtime's
    sync, ``torch.cuda.synchronize()`` is this one)."""
    leaves = list(pool.params.values())

    def vg():
        im, _ = render_from_params(pool.params, c2w, fx, fy, cfg.width / 2,
                                   cfg.height / 2, cfg, alive=pool.alive)
        return torch.autograd.grad(torch.mean(im) + torch.mean(im * im),
                                   leaves)

    dt, _ = _loop_s(vg, max(iters // 2, 3), pool.pos.device)
    return round(1.0 / dt, 3)


def bench_fwd_bwd_isolated(path, height, width, iters, device="cuda"):
    """``--only fwd_bwd_trained``: the checkpoint's full-capacity fwd+bwd in
    this (fresh) process; prints and returns its one-key line."""
    dev = resolve_device(device)
    pool, c2w, fx, fy, cfg = _trained_scene_setup(path, height, width, dev)
    line = {"fwd_bwd_fps_trained_ckpt": _trained_fwd_bwd_fps(
        pool, c2w, fx, fy, cfg, iters)}
    print(json.dumps(line), flush=True)
    return line


def bench_checkpoint(path, height, width, iters, ellipse_ab=False,
                     device="cuda") -> dict:
    """Frame rates on the trained checkpoint at its bench pose
    (bench.py:239-436): the served forward (``fps_trained_ckpt``, the
    headline), its fwd+bwd, the fwd+bwd with the compacted backward sized
    from the forward's ``bwd_demand``, the ellipse A/B (with
    ``ellipse_ab``), the truncation A/B at ``TRUNC_CAP`` with capacities
    sized from ``pair_demand``, and the demand-sized capacity."""
    dev = resolve_device(device)
    pool, c2w, fx, fy, cfg = _trained_scene_setup(path, height, width, dev)
    dt, (img, aux) = _loop_s(_served(pool, c2w, fx, fy, cfg), iters, dev)
    out = {
        "fps_trained_ckpt": round(1.0 / dt, 3),
        "trained_ckpt_gaussians": int(pool.alive.sum()),
        "trained_ckpt_pairs": int(aux.num_pairs),
        "trained_ckpt_pair_capacity": cfg.max_pairs,
    }
    inbench = _trained_fwd_bwd_fps(pool, c2w, fx, fy, cfg, iters)
    out["fwd_bwd_fps_trained_ckpt_inbench"] = inbench
    # Provisional: main() re-measures in a fresh process at the end.
    out["fwd_bwd_fps_trained_ckpt"] = inbench
    # The compacted backward, sized from the forward's composited slots.
    bdemand = int(aux.bwd_demand)
    out["trained_ckpt_bwd_demand"] = bdemand
    out["fwd_bwd_fps_trained_ckpt_satbwd"] = _trained_fwd_bwd_fps(
        pool, c2w, fx, fy, cfg.with_(bwd_pairs=_sized(bdemand)), iters)
    if ellipse_ab:
        ecfg = cfg.with_(cull_mode="ellipse", max_pairs=ELLIPSE_PAIRS,
                         max_rows=ELLIPSE_ROWS)
        edt, (eimg, eaux) = _loop_s(_served(pool, c2w, fx, fy, ecfg), iters,
                                    dev)
        out.update({
            "fps_trained_ckpt_ellipse": round(1.0 / edt, 3),
            "trained_ckpt_pairs_ellipse": int(eaux.num_pairs),
            "trained_ckpt_ellipse_img_err": round(
                float((eimg - img).abs().max()), 8),
        })
    # Truncation: max_pairs sized to the post-cull demand and trunc_pairs
    # to the truncated demand, as --auto_pairs sizes them.
    tcfg0 = cfg.with_(tile_rank_cap=TRUNC_CAP)
    with torch.no_grad():
        pdemand, _, tdemand = (int(x) for x in pair_demand(
            pool.params, c2w, fx, fy, width / 2, height / 2, tcfg0,
            alive=pool.alive))
    tcfg = tcfg0.with_(max_pairs=_sized(pdemand),
                       trunc_pairs=_sized(tdemand))
    out["trained_ckpt_demand_culled"] = pdemand
    tdt, (timg, taux) = _loop_s(_served(pool, c2w, fx, fy, tcfg), iters,
                                dev)
    out.update({
        "fps_trained_ckpt_trunc": round(1.0 / tdt, 3),
        "trained_ckpt_pairs_kept": int(taux.num_pairs_kept),
        "trained_ckpt_trunc_capacity": tcfg.trunc_padded_pairs,
        "trained_ckpt_trunc_img_err": round(
            float((timg - img).abs().max()), 8),
    })
    out["fwd_bwd_fps_trained_ckpt_trunc"] = _trained_fwd_bwd_fps(
        pool, c2w, fx, fy, tcfg, iters)
    # The deployed capacity: max_pairs sized to the demand (--auto_pairs).
    scfg = cfg.with_(max_pairs=_sized(int(aux.num_pairs)))
    sdt, _ = _loop_s(_served(pool, c2w, fx, fy, scfg), iters, dev)
    out.update({
        "fps_trained_ckpt_sized": round(1.0 / sdt, 3),
        "trained_ckpt_sized_capacity": scfg.max_pairs,
    })
    return out


def train_cameras(B: int) -> np.ndarray:
    """The train bench's B cameras (bench.py:459-467): view i shifted by
    (0.1 i, 0, -0.05 i) and turned 0.05 i rad about y."""
    c2ws = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for i in range(B):
        th = 0.05 * i
        c2ws[i, :3, 3] = [0.1 * i, 0.0, -0.05 * i]
        c2ws[i, 0, 0] = c2ws[i, 2, 2] = np.cos(th)
        c2ws[i, 0, 2] = np.sin(th)
        c2ws[i, 2, 0] = -np.sin(th)
    return c2ws


def bench_train_step(params: dict, iters: int) -> dict:
    """Train-step ms per view at TRAIN_WIDTH x TRAIN_HEIGHT, batch
    TRAIN_BATCH, ground truth rendered from ``params`` on the device
    (bench.py:439-524): the per-view step (``scan``), the batched-view step
    (``batched``) and the batched step with the compacted backward sized
    from the largest view's ``bwd_demand`` x 1.3 (``batched_satbwd``). Each
    variant trains its own copy of the pool for max(iters // 4, 3) timed
    steps after one untimed step."""
    B, W, H = TRAIN_BATCH, TRAIN_WIDTH, TRAIN_HEIGHT
    dev = params["pos"].device
    cfg = RenderConfig(height=H, width=W, max_pairs=TRAIN_PAIRS,
                       max_per_tile=2048)
    n = params["pos"].shape[0]
    fx = fy = 0.85 * W
    cx, cy = W / 2.0, H / 2.0
    c2ws = torch.from_numpy(train_cameras(B)).to(dev)
    with torch.no_grad():
        views = [render_from_params(params, c2ws[i], fx, fy, cx, cy, cfg)
                 for i in range(B)]
    batch = {
        "c2w": c2ws, "image": torch.stack([im for im, _ in views]),
        **{k: torch.full((B,), v, dtype=torch.float32, device=dev)
           for k, v in (("fx", fx), ("fy", fy), ("cx", cx), ("cy", cy))},
    }
    bd = max(int(aux.bwd_demand) for _, aux in views)
    del views
    out = {"train_bwd_demand": bd}
    bcfg = cfg.with_(bwd_pairs=_sized(bd, 1.3))
    for label, batched, rcfg in (("scan", False, cfg), ("batched", True, cfg),
                                 ("batched_satbwd", True, bcfg)):
        tcfg = TrainConfig(capacity=n, batch_size=B, batched_render=batched,
                           densification_interval=10**9,
                           opacity_reset_interval=10**9)
        step = make_train_step(rcfg, tcfg)
        # Training updates the pool in place: each variant its own copy.
        pool = GaussianPool({k: v.detach().clone() for k, v in params.items()},
                            torch.ones(n, dtype=torch.bool, device=dev))
        state, _ = step(init_train_state(pool, tcfg), batch)
        it = max(iters // 4, 3)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(it):
            state, _ = step(state, batch)
        _sync(dev)
        ms_view = (time.perf_counter() - t0) / it / B * 1e3
        out[f"train_step_ms_per_view_{label}"] = round(ms_view, 2)
        del state, pool
    return out


def isolated_fwd_bwd_fps(ckpt, height, width, iters, device) -> float:
    """The checkpoint's fwd+bwd re-measured in a fresh ``python -m
    gsplat_tpu_torch.bench --only fwd_bwd_trained`` process; raises when
    the child fails."""
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=pkg_parent + (
        os.pathsep + path if path else ""))
    r = subprocess.run(
        [sys.executable, "-m", "gsplat_tpu_torch.bench",
         "--only", "fwd_bwd_trained", "--checkpoint", ckpt,
         "--height", str(height), "--width", str(width),
         "--iters", str(iters), "--device", str(device)],
        env=env, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"the isolated fwd+bwd exited {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    return float(json.loads(r.stdout.strip().splitlines()[-1])
                 ["fwd_bwd_fps_trained_ckpt"])


def main(argv=None) -> dict:
    """Parse ``argv``, run the bench, print its one JSON line last and
    return it as a dict."""
    from .utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()  # the kernel builds' directory
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--gaussians", type=int, default=2**17)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--no-backward", dest="backward", action="store_false",
                   help="skip the synthetic scene's fwd+bwd")
    p.add_argument("--no-parity", dest="parity", action="store_false",
                   help="accepted for bench.py's command lines; the "
                        "gradient parity against the original PyTorch "
                        "reference is not ported")
    p.add_argument("--no-train-bench", dest="train_bench",
                   action="store_false",
                   help="skip the train-step (scan vs batched) benchmark")
    p.add_argument("--checkpoint", default=None,
                   help="trained .npz checkpoint to benchmark "
                        f"(default: {DEFAULT_CKPT} when present)")
    p.add_argument("--only", default=None, choices=("fwd_bwd_trained",),
                   help="measure the checkpoint's fwd+bwd in this process "
                        "and print a one-key JSON line (the parent's "
                        "isolated re-measure)")
    p.add_argument("--ellipse-ab", dest="ellipse_ab", action="store_true",
                   help="add the ellipse-cull A/B on the checkpoint")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.only == "fwd_bwd_trained":
        ckpt = args.checkpoint or DEFAULT_CKPT
        if not os.path.exists(ckpt):
            raise FileNotFoundError(f"no checkpoint at {ckpt}")
        return bench_fwd_bwd_isolated(ckpt, args.height, args.width,
                                      args.iters, device=dev)

    H, W = args.height, args.width
    cfg = RenderConfig(height=H, width=W, max_pairs=SYNTH_PAIRS,
                       max_per_tile=2048, tile_chunk=32)
    params = make_scene(args.gaussians, device=dev)
    c2w = np.eye(4, dtype=np.float32)
    fx = fy = 0.85 * W

    def fwd():
        with torch.no_grad():
            return render_from_params(params, c2w, fx, fy, W / 2, H / 2, cfg)

    dt_fwd, (img, aux) = _loop_s(fwd, args.iters, dev)
    fps = 1.0 / dt_fwd
    extras = {
        "gaussians": args.gaussians,
        **roofline_forward(cfg, args.gaussians, dt_fwd),
        "pairs": int(aux.num_pairs),
        "max_tile_count": int(aux.max_tile_count),
        "rays_per_s_fwd": H * W / dt_fwd,
        "resolution": f"{W}x{H}",
        "device": device_label(dev),
        "image_mean": float(img.mean()),
    }
    del img, aux

    if args.backward:
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}

        def grad_fn():
            im, _ = render_from_params(leaves, c2w, fx, fy, W / 2, H / 2, cfg)
            return torch.autograd.grad(im.sum(), list(leaves.values()))

        dt_step, _ = _loop_s(grad_fn, max(args.iters // 2, 1), dev)
        extras["fwd_bwd_fps"] = 1.0 / dt_step
        extras["rays_per_s_fwd_bwd"] = H * W / dt_step
        del leaves

    # The half resolution the reference trains at (bench.py keeps the
    # full width's focal length here).
    cfg_half = RenderConfig(height=TRAIN_HEIGHT, width=TRAIN_WIDTH,
                            max_pairs=TRAIN_PAIRS, max_per_tile=2048)

    def fwd_half():
        with torch.no_grad():
            return render_from_params(params, c2w, fx, fy, TRAIN_WIDTH / 2,
                                      TRAIN_HEIGHT / 2, cfg_half)[0]

    dt_half, _ = _loop_s(fwd_half, args.iters, dev)
    extras["fps_960x540"] = round(1.0 / dt_half, 3)

    ckpt = args.checkpoint or (
        DEFAULT_CKPT if os.path.exists(DEFAULT_CKPT) else None)
    if ckpt:
        extras.update(bench_checkpoint(ckpt, H, W, args.iters,
                                       ellipse_ab=args.ellipse_ab,
                                       device=dev))
    if args.train_bench:
        extras.update(bench_train_step(params, args.iters))

    if ckpt:
        # The re-measure in a fresh process comes last, after this process
        # frees what it holds. bench.py then waits 10 s for a TPU runtime
        # to release device memory; a CUDA process's memory is the
        # caching allocator's, which empty_cache() hands back at once.
        del params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # bench.py's rule (:696-705): both readings time the same work on
        # the same inputs, and contention only slows it, so the line keeps
        # the faster and their ratio keeps the disagreement visible.
        inb = extras["fwd_bwd_fps_trained_ckpt_inbench"]
        iso = isolated_fwd_bwd_fps(ckpt, H, W, args.iters, dev)
        extras["fwd_bwd_fps_trained_ckpt_isolated"] = iso
        extras["fwd_bwd_fps_trained_ckpt"] = max(inb, iso)
        extras["fwd_bwd_inbench_vs_isolated_agreement"] = round(
            min(inb, iso) / max(inb, iso, 1e-9), 3)

    extras["fps_synthetic_1080p"] = round(fps, 3)
    if "fps_trained_ckpt" in extras:
        metric, value = "render_fps_1080p_trained", extras["fps_trained_ckpt"]
    else:
        metric, value = "render_fps_1080p", round(fps, 3)
    line = {"metric": metric, "value": value, "unit": "frames/s",
            "vs_baseline": round(value / 1.0, 3), **extras}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
