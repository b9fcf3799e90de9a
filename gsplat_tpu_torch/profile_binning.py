"""Sub-stage attribution of the port's binning at the served shapes.

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
  expand      ``_expand``: the capacity drop and the searchsorted expansion
  count       ``_tile_counts``: the per-tile pair counts (scatter-add)
  sort        ``_sort_keys``: the int64 (tile, depth slot) key sort
  decode      ``_align``: key decode and the block-aligned pair_slot scatter
  meta        ``_block_meta``: the per-block metadata
  corners     ``_cover_counts``: the exact cover counts
  cull        ``_occlusion_cull`` (tile_rank_cap 1024, cull_chunks 64)
  compact     ``_compact_blocks``: the rank truncation's block compaction
  gather      gather_pair_features forward at the truncated size

The JAX labels are kept where the operation has a counterpart (``sort``,
``decode``, ``corners``, ``argsortN``, ``bin-full``, ``bin-trunc``,
``gather``, ``project``, ``cull``). The TPU-only forms have no twin: the
payload-free packed int32 ``lax.sort``, the int8 MXU cover-count matmuls
(``cover-mm``, ``cover-i8``), the ``[3, cap]`` cumsum and scatter
variants of the TPU expansion (``cumsum3``, ``scatter3``, ``cs-2lvl``,
``scat3x1``) and the gather-splitting experiment (``g16x1``): the port's
binning computes the same outputs with none of them.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> dict:
    """Parse ``argv``, print each operation's ms and return {label: ms}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", default="bench_assets/trained_ckpt.npz")
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

    def bench(label, fn):
        fn()
        reps = [time_ms(fn, args.iters, dev) for _ in range(3)]
        times[label] = sorted(reps)[1]
        print(f"{label:12s} {times[label]:8.3f} ms  (reps "
              f"{' '.join(f'{r:.3f}' for r in reps)})", flush=True)

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

        # --- bin_gaussians' steps on this frame's tensors ---
        T = cfg.num_tiles
        bench("argsortN", lambda: B._footprints(proj))
        _, tile_min, n_u, n_v, counts = B._footprints(proj)
        bench("expand", lambda: B._expand(counts, tile_min, n_u, cfg))
        _, _, slot, pair_ok, tile_id = B._expand(counts, tile_min, n_u, cfg)
        bench("count", lambda: B._tile_counts(tile_id, T))
        tile_count = B._tile_counts(tile_id, T)
        bench("sort", lambda: B._sort_keys(tile_id, slot, pair_ok, n, T))
        sorted_key = B._sort_keys(tile_id, slot, pair_ok, n, T)
        bench("decode", lambda: B._align(sorted_key, tile_count, n, cfg))
        pair_slot, padded_count, padded_start = B._align(
            sorted_key, tile_count, n, cfg)
        bench("meta", lambda: B._block_meta(padded_start, cfg))
        y0, x0 = tile_min[:, 1], tile_min[:, 0]
        bench("corners", lambda: B._cover_counts(
            y0, y0 + n_v, x0, x0 + n_u, counts > 0, cfg.tiles_y,
            cfg.tiles_x))
        bench("cull", lambda: B._occlusion_cull(tile_min, n_u, n_v, counts,
                                                tcfg))
        bench("compact", lambda: B._compact_blocks(
            pair_slot, padded_count, padded_start, tcfg))
        tb = B.bin_gaussians(proj, tcfg)
        rng = np.random.default_rng(0)
        feat10 = torch.from_numpy(rng.normal(size=(n, 10)).astype(
            np.float32)).to(dev)
        bench("gather", lambda: gather_pair_features(
            feat10, tb.pair_slot, tb.gauss_offsets, truncated=True))
    parts = ("argsortN", "expand", "count", "sort", "decode", "meta")
    print(f"bin-full {times['bin-full']:.3f} ms against its parts' sum "
          f"{sum(times[k] for k in parts):.3f} ms ({' + '.join(parts)}); "
          f"bin-trunc adds {times['bin-trunc'] - times['bin-full']:.3f} ms "
          f"(cull {times['cull']:.3f}, second cover count "
          f"{times['corners']:.3f}, compact {times['compact']:.3f})",
          flush=True)
    return times


if __name__ == "__main__":
    main()
