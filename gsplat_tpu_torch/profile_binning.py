"""Sub-stage attribution of the port's binning at the served shapes, and
the check of its kernels against the plain steps.

Counterpart of ``scripts/profile_binning.py``, with its flags and a
``--device``. Run on the card as

    python -m gsplat_tpu_torch.profile_binning

It projects ``--checkpoint`` at its bench pose (1920x1080, ``max_pairs``
2**22) and times, each on its own (``profile_kernel.device_ms``: CUDA
events, median of 3 runs of ``--iters`` calls; the host clock on the
CPU), the steps of ``ops/binning.py::bin_gaussians`` (its module
functions, called on the tensors that frame gives them):

  project     covariance + SH + projection (the front end before binning)
  bin-full    bin_gaussians end to end
  bin-trunc   bin_gaussians with tile_rank_cap 1024 (trunc_pairs 2**20)
  argsortN    ``_footprints``: the depth argsort and the footprint gathers
  drop        ``_capacity_drop``: the capacity drop and the offsets
  emit        ``emit_pairs``: each gaussian's pairs at its offsets
  sort        ``sort_pairs``: the stable sort of the pairs by tile
  runs        ``_tile_runs``: the per-tile counts and starts
  align       ``align_pairs``: the block-aligned pair_slot scatter
  meta        ``_block_meta``: the per-block metadata
  corners     ``_cover_counts``: the exact cover counts
  cull        ``_occlusion_cull`` (tile_rank_cap 1024, cull_chunks 64)
  compact     ``_compact_blocks``: the rank truncation's block compaction
  gather      gather_pair_features forward at the truncated size

On the card ``emit``, ``sort`` and ``align`` are the kernels of
``ops/csrc/binning.cu`` (:func:`step_times`; with ``plain=True`` their
plain versions). The sort may overwrite its inputs, so each timed call
first copies the emitted pairs into the buffers it sorts; ``sort`` is
reported less that copy's own time.

:func:`kernel_cases` and :func:`compare_kernels` hold the kernels to the
plain steps on a card: ``bin_gaussians`` once as it runs, once under
:func:`plain_steps`, every ``TileBinning`` field bit for bit, each
kernel's launch counter risen. The scenes are the port's own: the
trained checkpoint (about 120k gaussians) on a 4.4-radius orbit, and
``scene.make_scene`` at Kerbl et al.'s Mip-NeRF 360 average count
(:data:`GARDEN_GAUSSIANS`) from poses near the origin camera, each
sized to its demand with 1.2x headroom. The card tests
(``tests/test_torch_gpu_binning.py``) run them.

The JAX labels are kept where the operation has a counterpart (``sort``,
``corners``, ``argsortN``, ``bin-full``, ``bin-trunc``, ``gather``,
``project``, ``cull``). The TPU-only forms have no twin: the
payload-free packed int32 ``lax.sort``, the int8 MXU cover-count matmuls
(``cover-mm``, ``cover-i8``), the ``[3, cap]`` cumsum and scatter
variants of the TPU expansion (``cumsum3``, ``scatter3``, ``cs-2lvl``,
``scat3x1``) and the gather-splitting experiment (``g16x1``): the port's
binning computes the same outputs with none of them.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

DEFAULT_CKPT = "bench_assets/trained_ckpt.npz"
GARDEN_GAUSSIANS = 2_959_677  # Kerbl et al. 2023, Mip-NeRF 360 average
# Camera positions (x, y, z) and yaws near the origin camera that the
# garden scene is seen from: ~52 M pairs at 1080p.
GARDEN_POSES = ((0.0, 0.0, 0.0, 0.0), (0.4, 0.05, 0.3, 0.2),
                (-0.4, -0.08, -0.3, -0.15))
# The cases kernel_cases builds.
CHECK_CASES = ("ckpt120k-orbit", "garden3m-drift", "overflow", "batched",
               "ellipse", "truncated")
STEPS = ("argsortN", "drop", "emit", "sort", "runs", "align", "meta")


def _steps():
    from .ops import binning

    return binning


@contextlib.contextmanager
def plain_steps():
    """``bin_gaussians`` with the emission, sort and alignment swapped for
    their plain versions (PyTorch on any device) while inside."""
    B = _steps()
    saved = (B.emit_pairs, B.sort_pairs, B.align_pairs)
    B.emit_pairs, B.sort_pairs, B.align_pairs = (
        B.emit_pairs_plain, B.sort_pairs_plain, B.align_pairs_plain)
    try:
        yield
    finally:
        B.emit_pairs, B.sort_pairs, B.align_pairs = saved


def launch_counts() -> list:
    """[binning_emit, binning_sort, binning_align] launches so far."""
    B = _steps()
    return [B.emit_pairs.launches, B.sort_pairs.launches,
            B.align_pairs.launches]


def compare_kernels(proj, cfg) -> dict:
    """``bin_gaussians(proj, cfg)`` as it runs against the same call under
    :func:`plain_steps`: {"bad": [fields that differ], "max_abs_err": the
    largest integer difference over every field, "launches": each
    kernel's launches in the first call, "num_pairs": the demand}."""
    B = _steps()
    c0 = launch_counts()
    got = B.bin_gaussians(proj, cfg)
    rose = [b - a for a, b in zip(c0, launch_counts())]
    with plain_steps():
        want = B.bin_gaussians(proj, cfg)
    bad, err = [], 0
    for f in B.TileBinning._fields:
        g, w = getattr(got, f), getattr(want, f)
        if g.shape != w.shape or g.dtype != w.dtype:
            bad.append(f)
            continue
        if not torch.equal(g, w):
            bad.append(f)
            err = max(err, int((g.long() - w.long()).abs().max()))
    return {"bad": bad, "max_abs_err": err, "launches": rose,
            "num_pairs": int(got.num_pairs)}


def _sized(demand: int) -> int:
    """``demand`` x 1.2 rounded up to 4,096 (``--auto_pairs``' sizing)."""
    return max(4096, -(-int(demand * 1.2) // 4096) * 4096)


def _origin_pose(x, y, z, yaw):
    """c2w of a camera at (x, y, z) turned by ``yaw`` about +y from the
    origin camera (which looks down +z)."""
    c2w = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    c2w[0, 0] = c2w[2, 2] = c
    c2w[0, 2] = s
    c2w[2, 0] = -s
    c2w[:3, 3] = [x, y, z]
    return c2w


def _scene(name: str, dev, seed: int, checkpoint: str):
    """(params, alive, poses, cfg sized to the poses' largest demand) of
    the checkpoint's orbit or the garden scene's origin poses."""
    from .config import RenderConfig
    from .render import pair_demand

    cfg = RenderConfig(height=1080, width=1920, max_pairs=4096)
    f, cx, cy = 0.85 * cfg.width, cfg.width / 2, cfg.height / 2
    if name == "ckpt120k":
        from .train.trainer import restore_pool
        from .viewer import (create_orbit_trajectory,
                             estimate_scene_center_radius)

        pool = restore_pool(checkpoint, device=dev)
        params, alive = pool.params, pool.alive
        center, radius = estimate_scene_center_radius(
            positions=params["pos"][alive].cpu().numpy())
        path = create_orbit_trajectory(center, 4.4 * radius, num_frames=120,
                                       elevation_deg=15.0)
        probe = path[::10]
    else:
        from .scene import make_scene

        params, alive = make_scene(GARDEN_GAUSSIANS, seed, dev), None
        path = probe = np.stack([_origin_pose(*p) for p in GARDEN_POSES])
    demand = max(int(pair_demand(params, c, f, f, cx, cy, cfg,
                                 alive=alive)[0]) for c in probe)
    return params, alive, path, cfg.with_(max_pairs=_sized(demand))


def _project(params, alive, c2w, cfg):
    from .ops.gaussian import build_cov3d_packed
    from .ops.projection import project_gaussians

    f = 0.85 * cfg.width
    c2w = torch.as_tensor(c2w, dtype=torch.float32,
                          device=params["pos"].device)
    cov = build_cov3d_packed(params["scale_raw"], params["q_raw"])
    return project_gaussians(params["pos"], cov, params["opacity_raw"], c2w,
                             f, f, cfg.width / 2, cfg.height / 2, cfg,
                             extra_valid=alive)


def kernel_cases(case: str, device="cuda", seed: int = 0,
                 checkpoint: str = DEFAULT_CKPT):
    """Yield (label, proj, cfg, binning_emit launches a call makes) for one
    of :data:`CHECK_CASES`: ``ckpt120k-orbit`` the checkpoint at four orbit
    poses; ``garden3m-drift`` the garden scene at :data:`GARDEN_POSES`;
    ``overflow`` the garden at a third of its capacity (whole gaussians
    dropped); ``batched`` three orbit views stacked (``view_tile_rows``,
    15-bit keys); ``ellipse`` the ellipse cull's pairs through the sort
    and the scatter (no emission); ``truncated`` the rank truncation with
    the occlusion cull. Call under ``torch.no_grad()``."""
    from .device import resolve_device
    from .render import stack_view_projections

    if case not in CHECK_CASES:
        raise ValueError(f"unknown case {case!r}; one of {CHECK_CASES}")
    dev = resolve_device(device)
    garden = case in ("garden3m-drift", "overflow")
    params, alive, path, cfg = _scene("garden3m" if garden else "ckpt120k",
                                      dev, seed, checkpoint)
    if case in ("ckpt120k-orbit", "garden3m-drift"):
        for i in (range(len(path)) if garden else (0, 30, 60, 90)):
            yield (f"{case} pose {i}", _project(params, alive, path[i], cfg),
                   cfg, 1)
    elif case == "overflow":
        small = cfg.with_(max_pairs=cfg.max_pairs // 3)
        yield (f"{case} (capacity / 3)",
               _project(params, alive, path[0], small), small, 1)
    elif case == "batched":
        views = [_project(params, alive, path[i], cfg) for i in (5, 45, 85)]
        stacked, bcfg = stack_view_projections(
            type(views[0])(*(torch.stack(f) for f in zip(*views))), cfg)
        yield f"{case} (orbit poses 5, 45, 85)", stacked, bcfg, 1
    elif case == "ellipse":
        ecfg = cfg.with_(cull_mode="ellipse")
        yield (f"{case} (orbit pose 0)",
               _project(params, alive, path[0], ecfg), ecfg, 0)
    else:
        tcfg = cfg.with_(tile_rank_cap=1024, trunc_pairs=2**21)
        yield (f"{case} (orbit pose 0, tile_rank_cap 1024)",
               _project(params, alive, path[0], tcfg), tcfg, 1)


def step_times(proj, cfg, iters: int, plain: bool = False,
               log=None) -> dict:
    """ms of each of :data:`STEPS` on this frame's tensors (median of 3
    runs of ``iters`` calls; ``sort`` less the copy of its inputs), with
    the kernels, or with ``plain`` their plain versions. ``log(label, ms,
    reps)`` is called after each."""
    from .profile_stages import time_ms

    B = _steps()
    dev = proj.depth.device
    times = {}

    def bench(label, fn):
        fn()
        reps = [time_ms(fn, iters, dev) for _ in range(3)]
        times[label] = sorted(reps)[1]
        if log is not None:
            log(label, times[label], reps)

    ctx = plain_steps() if plain else contextlib.nullcontext()
    with ctx, torch.no_grad():
        T = cfg.num_tiles
        bench("argsortN", lambda: B._footprints(proj))
        _, tile_min, n_u, _, counts = B._footprints(proj)
        bench("drop", lambda: B._capacity_drop(counts, cfg))
        _, offsets = B._capacity_drop(counts, cfg)
        bench("emit", lambda: B.emit_pairs(offsets, tile_min, n_u, cfg))
        tile_id, slot = B.emit_pairs(offsets, tile_min, n_u, cfg)
        keys, vals = tile_id.clone(), slot.clone()

        def copy():  # sort_pairs may sort in its inputs' storage
            keys.copy_(tile_id)
            vals.copy_(slot)

        bench("copy", copy)
        bench("sort", lambda: (copy(), B.sort_pairs(keys, vals, T)))
        copy()
        sorted_tile, sorted_slot = (t.clone() for t in B.sort_pairs(
            keys, vals, T))
        bench("runs", lambda: B._tile_runs(sorted_tile, cfg))
        _, _, real_start, padded_start = B._tile_runs(sorted_tile, cfg)
        bench("align", lambda: B.align_pairs(sorted_tile, sorted_slot,
                                             padded_start, real_start, cfg))
        bench("meta", lambda: B._block_meta(padded_start, cfg))
    times["sort"] -= times.pop("copy")
    return times


def main(argv=None) -> dict:
    """Parse ``argv``, print each operation's ms and return {label: ms}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", default=DEFAULT_CKPT)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--max_pairs", type=int, default=2**22)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from .config import RenderConfig
    from .device import resolve_device
    from .ops import binning as B
    from .ops.gaussian import build_cov3d_packed
    from .ops.projection import project_gaussians
    from .ops.rasterize import gather_pair_features
    from .ops.sh import evaluate_sh
    from .profile_stages import bench_pose, clock_name, time_ms
    from .train.trainer import restore_pool

    dev = resolve_device(args.device)
    pool = restore_pool(args.checkpoint, device=dev)
    c2w = torch.as_tensor(bench_pose(pool)[0], dtype=torch.float32,
                          device=dev)
    H, W = args.height, args.width
    cfg = RenderConfig(height=H, width=W, max_pairs=args.max_pairs)
    tcfg = cfg.with_(tile_rank_cap=1024, trunc_pairs=2**20)
    fx = fy = 0.85 * W
    cx, cy = W / 2.0, H / 2.0
    params, alive = pool.params, pool.alive
    n = params["pos"].shape[0]
    print(f"device={dev} n={n} cap={cfg.max_pairs} tiles={cfg.num_tiles} "
          f"({clock_name(dev)}, ms per call, median of 3 runs of "
          f"{args.iters})", flush=True)
    times = {}

    def log(label, ms, reps):
        print(f"{label:12s} {ms:8.3f} ms  (reps "
              f"{' '.join(f'{r:.3f}' for r in reps)})", flush=True)

    def bench(label, fn):
        fn()
        reps = [time_ms(fn, args.iters, dev) for _ in range(3)]
        times[label] = sorted(reps)[1]
        log(label, times[label], reps)

    def front():
        cov3d = build_cov3d_packed(params["scale_raw"], params["q_raw"])
        colors = evaluate_sh(params["f_dc"], params["f_rest"],
                             params["pos"], c2w)
        proj = project_gaussians(params["pos"], cov3d, params["opacity_raw"],
                                 c2w, fx, fy, cx, cy, cfg, extra_valid=alive)
        return proj, colors

    with torch.no_grad():
        proj, _ = front()
        bench("project", front)
        bench("bin-full", lambda: B.bin_gaussians(proj, cfg))
        bench("bin-trunc", lambda: B.bin_gaussians(proj, tcfg))
        times.update(step_times(proj, cfg, args.iters, log=log))

        # --- the truncation's steps and the gather ---
        _, tile_min, n_u, n_v, counts = B._footprints(proj)
        y0, x0 = tile_min[:, 1], tile_min[:, 0]
        bench("corners", lambda: B._cover_counts(
            y0, y0 + n_v, x0, x0 + n_u, counts > 0, cfg.tiles_y,
            cfg.tiles_x))
        bench("cull", lambda: B._occlusion_cull(tile_min, n_u, n_v, counts,
                                                tcfg))
        full = B.bin_gaussians(proj, cfg)
        padded_count = full.tile_count + (-full.tile_count) % cfg.pair_block
        padded_start = torch.cat([padded_count.new_zeros(1),
                                  torch.cumsum(padded_count.long(), 0)])
        bench("compact", lambda: B._compact_blocks(
            full.pair_slot, padded_count.long(), padded_start, tcfg))
        tb = B.bin_gaussians(proj, tcfg)
        rng = np.random.default_rng(0)
        feat10 = torch.from_numpy(rng.normal(size=(n, 10)).astype(
            np.float32)).to(dev)
        bench("gather", lambda: gather_pair_features(
            feat10, tb.pair_slot, tb.gauss_offsets, truncated=True))
    print(f"sort alone (less the copy) {times['sort']:.3f} ms; bin-full "
          f"{times['bin-full']:.3f} ms against its parts' sum "
          f"{sum(times[k] for k in STEPS):.3f} ms ({' + '.join(STEPS)}); "
          f"bin-trunc adds {times['bin-trunc'] - times['bin-full']:.3f} ms "
          f"(cull {times['cull']:.3f}, second cover count "
          f"{times['corners']:.3f}, compact {times['compact']:.3f})",
          flush=True)
    return times


if __name__ == "__main__":
    main()
