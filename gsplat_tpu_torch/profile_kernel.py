"""Instruction-class breakdown of one compositor launch on the card.

Counterpart of ``scripts/profile_kernel.py``: it times the bare forward
compositor (K1, ``raster_cuda.composite_pairs``) on a synthetic
block-aligned pair list (no binning, no gather, no saturation skip at the
default opacity) beside three other designs of it and five ablations that
each take one class of work out of it (``ops/raster_ablate.py``):

  full        K1 (ops/csrc/raster_fwd.cu)
  cumprod     K1's function, T a two-level product (groups of 8 pairs)
  pg-roll     K1's function on tensor cores (pixels x pairs), T a product
              scanned over each lane quad
  pg-log      the same, T from log1p(-alpha) summed by a triangular-mask
              product
  no-transc   exp replaced by 1/(1+q/2), the T product by 1 + a sum
  no-mxu      no per-pair T chain: w = alpha T_in, T_out from a log sum
  no-compute  the feature rows staged and row 0 summed, nothing else
  no-input    K1's arithmetic on iota features with log-space T, no read
  empty       the tile's output written, nothing read (launch floor)

The five ablations and cumprod are K1's own kernel with another body
(``ops/csrc/raster_fwd_kernel.cuh``): K1 as serving runs it, minus one
class of work, so ``full`` minus each reads off that class (the table
printed last, :data:`ISOLATES`). pg-roll and pg-log are K1's function in
the TPU body's matrix form (pixels on the rows of ``mma.sync`` products,
pairs on their reduction axis, every (pair, pixel) computed), their own
kernel; their lines also print the time per (pair, pixel) computed, and
K1's its time per (pair, pixel) its cull reaches. A body that walks only
the (pair, warp) its cull reaches (full, cumprod, no-mxu: K1's cull;
no-transc: the cull for its own alpha) is bound by that reached work plus
the cull's operations, as is K1's function by other designs (pg-*: K1's
reach); each such line also prints the TPU kernel's work, every (pair,
pixel) of a composited block. Each line prints the time per launch, per
block of the workload, the tile-0 digest (the sum of out[0, 0:5], which
agrees with the JAX script's) and, on the card, the variant's bound and
its share of it.

    python -m gsplat_tpu_torch.profile_kernel [--blocks-per-tile 4]
        [--height 1080] [--width 1920] [--iters 20] [--only full,empty]
        [--device cuda]

On the card, times are CUDA events around ``--iters`` launches after one
warm-up launch, enqueued while the stream is held busy so that the host's
time between launches is not timed. ``--device cpu`` runs the plain
PyTorch versions and times them with the host clock.
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from .config import RenderConfig
from .device import resolve_device
from .ops.raster_ablate import K1_FUNCTION, PG_VARIANTS, ablate
from .ops.raster_cuda import (FEAT_ROWS, FEAT_WIDTH, active_blocks,
                              composite_pairs, cull_audit, kernel_warps,
                              tile_block_offsets)

# The JAX script's VARIANTS, in its order.
VARIANTS = {"full": composite_pairs}
VARIANTS.update((name, functools.partial(ablate, name)) for name in (
    "cumprod", "pg-roll", "pg-log", "no-transc", "no-mxu", "no-compute",
    "no-input", "empty"))

PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# f32 operations per composited (pair, pixel), counted from each kernel's
# body; compares, selects, sign flips and the once-per-block T update are
# not counted. A variant that computes K1's function (K1_FUNCTION: cumprod,
# pg-roll, pg-log) is held to K1's count and, where the reached (pair, warp)
# are known, to K1's bound (bound_ms), the least that function needs; what
# its design adds on top is its cost, not its bound.
OPS_PER_PAIR_PIXEL = {
    # du, dv (2), q (9), -q/2 (1), exp (1), op*g (1), min (1), alpha*T (1),
    # four sums (8), T*(1-alpha) (2)
    "full": 26,
    # du, dv (2), q (9), q/2 (1), 1+ (1), divide (1), op*g (1), min (1),
    # run + s (1), run - s (1), 1+ (1), *T (1), alpha*T_excl (1), four
    # sums (8)
    "no-transc": 29,
    # du, dv (2), q (9), -q/2 (1), exp (1), op*g (1), min (1), alpha*T (1),
    # four sums (8), log1p (1), run + log1p (1)
    "no-mxu": 26,
    # K1's alpha (15), log1p (1), run + s (1), run - s (1), exp (1), *T (1),
    # alpha*T_excl (1), four sums (8). The iota features are a function of
    # the pair alone (11 operations per pair, not per pixel): not counted.
    "no-input": 29,
}
OPS_PER_PAIR_PIXEL.update((name, OPS_PER_PAIR_PIXEL["full"])
                          for name in K1_FUNCTION)
# K1's per-warp pair cull (ops/csrc/raster_fwd.cu), which the function's
# least work includes: per (pair, warp) of a composited block, lo and hi (2)
# and for each of the 4 pixel rows dv (2), m dv (1), the clamp (2) and q
# (9); per staged pair its threshold: a c, det (3), kappa (1), -b/a (1),
# op/cutoff (1), log (1), 2x (1), min (1), the margin (4), t + (1).
OPS_CULL_PER_PAIR_WARP = 58
OPS_CULL_PER_PAIR = 14  # no-transc's threshold: 2 (op / cutoff - 1), as many
# Bound by reached work: the bodies that walk only what their cull reaches
# (full, no-mxu, cumprod: K1's cull; no-transc: its own), and pg-*, which
# compute K1's function (K1's reach is the least that function needs).
CULLED = ("full", "no-transc", "no-mxu") + K1_FUNCTION
# What K1's time minus each variant's isolates on the card (the JAX
# script's attribution, "differences attribute the unit cost"). The bodies
# built from K1's kernel differ from it in the one class named; pg-* in
# the layout.
ISOLATES = {
    "cumprod": "K1's per-pair T product against a two-level product "
               "(groups of 8), same walk",
    "pg-roll": "K1's culled walk against every (pair, pixel) on tensor "
               "cores, T a quad-scan product (the TPU body's matrix form)",
    "pg-log": "K1's culled walk against every (pair, pixel) on tensor "
              "cores, T's log sum a triangular-mask product",
    "no-transc": "expf and the per-pair product against a divide and a "
                 "running sum; no-transc's cull reaches more (pair, warp) "
                 "(its rows below give each walk's ns per (pair, warp))",
    "no-mxu": "the dependent per-pair T chain (T*(1-alpha)) against a "
              "log1pf sum per pair, same walk",
    "no-compute": "the cull and the walk of the reached pairs (alpha, T, "
                  "the sums) beyond the staging",
    "no-input": "the feature read, the staging and the cull, less the "
                "walk of every pair the cull skips (no-input walks all)",
    "empty": "all of a block's work: read, staging, cull, walk, barriers",
}

def make_workload(cfg: RenderConfig, blocks_per_tile: int, seed: int = 0):
    """The JAX script's synthetic workload (``scripts/profile_kernel.py``,
    ``main``): every tile owns ``blocks_per_tile`` consecutive full blocks;
    u, v uniform over the tile, conics a, c in [0.05, 0.3], b in
    [-0.02, 0.02], opacity 0.05 (transmittance never saturates), colours
    and depth uniform in [0, 1]. The same numpy draws in the same order, so
    ``pair_feat`` is bit-identical to the script's for the same seed.

    Returns CPU tensors ``pair_feat`` [16, tiles * blocks_per_tile * G] f32
    and ``tile_start``, ``tile_count`` [num_tiles] int32 (the tile ranges
    the port's kernels take in place of the TPU grid's block metadata).
    """
    G = cfg.pair_block
    num_tiles = cfg.num_tiles
    block_tile = np.repeat(np.arange(num_tiles, dtype=np.int32),
                           blocks_per_tile)
    rng = np.random.default_rng(seed)
    npairs = block_tile.shape[0] * G
    feat = np.zeros((FEAT_WIDTH, npairs), np.float32)
    feat[0] = rng.uniform(0, cfg.tile, npairs)  # u
    feat[1] = rng.uniform(0, cfg.tile, npairs)  # v
    feat[2] = rng.uniform(0.05, 0.3, npairs)  # conic a
    feat[3] = rng.uniform(-0.02, 0.02, npairs)  # conic b
    feat[4] = rng.uniform(0.05, 0.3, npairs)  # conic c
    feat[5] = 0.05  # opacity
    feat[6:10] = rng.uniform(0, 1, (4, npairs))
    tile_of_pair = np.repeat(block_tile, G)  # u, v to global pixels
    feat[0] += (tile_of_pair % cfg.tiles_x) * cfg.tile
    feat[1] += (tile_of_pair // cfg.tiles_x) * cfg.tile
    per_tile = blocks_per_tile * G
    tile_start = torch.arange(num_tiles, dtype=torch.int32) * per_tile
    tile_count = torch.full((num_tiles,), per_tile, dtype=torch.int32)
    return torch.from_numpy(feat), tile_start, tile_count


def bound_ms(name: str, blocks: int, cfg: RenderConfig, reached=None):
    """(least time on one H100 in ms, "bytes" or "operations") for the
    variant over ``blocks`` composited blocks: each input byte read once
    and each output byte written once at 3.35 TB/s, against the operations
    at 67 TFLOP/s f32. ``no-compute`` counts the 10 staged rows it is
    defined to read (the TPU body reads the whole feature block) and one
    add per staged u and per pixel; ``no-input`` reads no feature; ``empty``
    only writes its output. For :data:`CULLED`, ``reached`` (the (pair,
    warp) of those blocks that the variant's cull does not skip, from
    :func:`reached_pair_warps`) counts 32 pixels for each reached (pair,
    warp) plus the cull's operations; without it every (pair, pixel)
    counts, the TPU kernel's work, as it always does for no-input, which
    walks every pair.
    """
    G, P = cfg.pair_block, cfg.tile * cfg.tile
    per = OPS_PER_PAIR_PIXEL.get(name)
    out_bytes = cfg.num_tiles * 8 * P * 4
    if name == "empty":
        ops, nbytes = 0, out_bytes
    else:
        feat_bytes = 0 if name == "no-input" else blocks * FEAT_ROWS * G * 4
        nbytes = feat_bytes + out_bytes + 2 * cfg.num_tiles * 4
        if name == "no-compute":
            ops = blocks * (G + P)
        elif reached is not None and name in CULLED:
            warps = kernel_warps(cfg.tile)
            ops = reached * (P // warps) * per \
                + blocks * G * (warps * OPS_CULL_PER_PAIR_WARP
                                + OPS_CULL_PER_PAIR)
        else:
            ops = blocks * G * P * per
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def reached_pair_warps(out, pair_feat, tile_start, cfg: RenderConfig,
                       rational: bool = False):
    """The (pair, warp) of the blocks a compositor output ``out`` composited
    (its row 5) that K1's cull (``rational``: no-transc's) does not skip,
    and their total."""
    blk, tile, _ = active_blocks(tile_start, tile_block_offsets(out), cfg)
    n = cull_audit(pair_feat, blk, tile, cfg, rational=rational)
    return n["total"] - n["skipped"], n["total"]


def launch_count(name: str) -> int:
    """The kernel launch counter of the variant's wrapper."""
    return composite_pairs.launches if name == "full" else \
        ablate.launches[name]


def device_ms(fn, iters):
    """Device ms per launch: CUDA events around ``iters`` launches that the
    host enqueues while the stream spins (about 0.5 ms of clock cycles per
    launch), so the events time back-to-back kernels, not the host."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000 * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run_variant(name, fn, pair_feat, tile_start, tile_count,
                cfg: RenderConfig, iters: int) -> dict:
    """Time one variant and print the JAX script's line (name, ms per
    launch, ns per block, tile-0 digest) plus, on the card, its bound.
    Returns those numbers and the launches it made."""
    on_card = pair_feat.device.type == "cuda"
    num_blocks = pair_feat.shape[1] // cfg.pair_block
    launches = launch_count(name)
    out = fn(pair_feat, tile_start, tile_count, cfg)  # warm-up
    digest = float(out[0, 0:5].sum())  # tile-0 digest: cross-variant sanity
    call = functools.partial(fn, pair_feat, tile_start, tile_count, cfg)
    if on_card:
        ms = device_ms(call, iters)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        ms = (time.perf_counter() - t0) / iters * 1e3
    res = {"name": name, "ms": ms, "ns_per_block": ms / num_blocks * 1e6,
           "digest": digest, "launches": launch_count(name) - launches,
           "blocks": int(out[:, 5, 0].sum())}
    line = (f"{name:11s} {ms:9.4f} ms  {res['ns_per_block']:7.1f} ns/block  "
            f"tile0-digest {digest:.4f}")
    if on_card:
        reached = None
        if name in CULLED:
            reached, total = reached_pair_warps(
                out, pair_feat, tile_start, cfg, rational=name == "no-transc")
            res["cull_skips"] = 1.0 - reached / max(total, 1)
            res["reached"] = reached
            res["ns_per_pair_warp"] = ms / max(reached, 1) * 1e6
            res["tpu_work_bound_ms"] = bound_ms(name, res["blocks"], cfg)[0]
        res["bound_ms"], res["bound_by"] = bound_ms(name, res["blocks"], cfg,
                                                    reached)
        res["share"] = res["bound_ms"] / ms
        line += (f"  bound {res['bound_ms']:.4f} ms by {res['bound_by']} "
                 f"({res['share']:.1%} of it; {res['blocks']} blocks "
                 f"composited, {res['launches']} launches)")
        if name in PG_VARIANTS:
            res["ps_per_pair_pixel"] = ms * 1e9 / max(
                res["blocks"] * cfg.pair_block * cfg.tile * cfg.tile, 1)
            line += (f"; {res['ps_per_pair_pixel']:.4f} ps per (pair, pixel) "
                     f"computed")
        elif name == "full":
            res["ps_per_pair_pixel"] = ms * 1e9 / max(
                reached * (cfg.tile * cfg.tile // kernel_warps(cfg.tile)), 1)
            line += (f"; {res['ps_per_pair_pixel']:.4f} ps per reached "
                     f"(pair, pixel)")
        if reached is not None:
            whose = "its" if name in ("full", "no-transc", "no-mxu",
                                      "cumprod") else "K1's"
            line += (f"; {whose} cull skips {res['cull_skips']:.4f} of "
                     f"(pair, warp), {res['ns_per_pair_warp']:.3f} ns per "
                     f"reached (pair, warp); TPU work (every (pair, pixel)) "
                     f"{res['tpu_work_bound_ms']:.4f} ms")
    print(line, flush=True)
    return res


def attribution(results: list) -> list:
    """The lines of the attribution table: K1's time minus each variant's,
    and what the difference isolates (:data:`ISOLATES`). Empty unless
    ``full`` ran."""
    by = {r["name"]: r for r in results}
    if "full" not in by:
        return []
    k1 = by["full"]["ms"]
    return [f"  full - {n:10s} {k1 - by[n]['ms']:+9.4f} ms  {ISOLATES[n]}"
            for n in by if n != "full"]


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--blocks-per-tile", type=int, default=4)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--only", default=None,
                   help="comma-separated variant subset")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    names = list(VARIANTS) if not args.only else args.only.split(",")
    for name in names:
        if name not in VARIANTS:
            raise ValueError(f"unknown variant {name!r}; known: "
                             f"{', '.join(VARIANTS)}")
    dev = resolve_device(args.device)
    cfg = RenderConfig(height=args.height, width=args.width,
                       max_pairs=2**18)
    pair_feat, tile_start, tile_count = (
        t.to(dev) for t in make_workload(cfg, args.blocks_per_tile))
    bpt = args.blocks_per_tile
    clock = (f"CUDA events, {args.iters} launches after 1 warm-up"
             if dev.type == "cuda" else "host clock, plain PyTorch versions")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={dev} ({name}) tiles={cfg.num_tiles} "
          f"blocks={cfg.num_tiles * bpt} ({bpt}/tile); times: {clock}",
          flush=True)
    res = [run_variant(n, VARIANTS[n], pair_feat, tile_start, tile_count,
                       cfg, args.iters) for n in names]
    table = attribution(res)
    if table:
        print("K1 minus each variant (what the difference isolates):",
              flush=True)
        print("\n".join(table), flush=True)
    return res


if __name__ == "__main__":
    main()
