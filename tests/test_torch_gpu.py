"""The port on a CUDA card: the Hopper compositors against their plain
versions, and a train step on the card against the same step on the CPU.

Needs a card; every test here skips without one. It imports neither JAX
nor the suite's conftest (the GPU machine has no JAX), so run it with

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu

Tolerances: the forward kernel vs the plain compositor on the same inputs,
rows 0-5 bit for bit (the kernel is built with -fmad=false and keeps the
plain version's order of operations; the (pair, warp) its cull skips have
alpha == 0 at every pixel of the warp, where they change nothing), and the
count of skipped (pair, warp) it reports equal to the plain test's
(``pair_warp_reach``, same arithmetic). A whole render on the card vs
the same render on the CPU: 1e-4 abs with equal pair counts, because the
projection runs on each device's own math library (a float one ulp apart
can move one (pair, pixel) across the alpha cutoff).

The forward kernel writing its block-start state: its output bit-identical
to the output without state, and the state at the composited blocks
bit-identical to the plain forward's (same arithmetic, same order). The
backward kernel, given that state, vs its plain version: rows 0-9 within
1e-5 of each row's max abs (alpha, T and w round alike; the order of the
pixel sums, fused multiply-adds in the ten partials and the division's
fast path differ), exact zeros outside the blocks the forward composited,
and two runs bit-identical (no float atomics). A train step on the card vs
on the CPU: gradients within 5e-4 of each leaf's largest, the render's own
gradient tolerance.

The XLA compositor (``backend="xla"``, plain PyTorch on the card) vs the
kernel's render with ``max_per_tile`` at the largest tile: 2e-5 (depth:
of its largest value; alpha where the kernel's final T is above
``transmittance_min``, since the kernel stops a saturated tile early and
the xla compositor does not); the kernels with ``tile_rank_cap=K`` vs the XLA
compositor with ``max_per_tile=K``: images 2e-5, gradients 5e-4 of each
leaf's largest (the JAX gate's bounds). ``evaluate_views`` batched vs per
view on the card: PSNR 1e-3 dB, L1 1e-6 (the JAX gate's bounds).

The eight K3 kernels of the profiler vs their plain versions: rows 0-4
within 2e-5 abs, row 5 exact, rows 6-7 zero (built and ordered alike);
the six built from K1's kernel also with opacities spread across the
cutoff, their skip counts equal to the plain test's. K1's registers,
shared memory and CTAs per SM as its redesign left them.
cumprod, pg-roll and pg-log compute the forward compositor's function, so
they are also held against its plain version within the same 2e-5 (their
T is rounded in another association; pg-roll and pg-log sum on tensor
cores, whose sums are not IEEE sums, with every operand split into two
TF32 parts). The TF32 split on the card and its plain version: bit for
bit.
"""

import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as gt
import torch_card_cases as C
from gsplat_tpu_torch.ops import raster_ablate as tabl
from gsplat_tpu_torch.ops import raster_cuda as tras
from gsplat_tpu_torch.ops.binning import bin_gaussians
from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
from gsplat_tpu_torch.ops.projection import project_gaussians
from gsplat_tpu_torch.ops.rasterize import _pair_features, gather_pair_features
from gsplat_tpu_torch.ops.sh import evaluate_sh
from gsplat_tpu_torch.profile_kernel import make_workload
from gsplat_tpu_torch.profile_stages import serving_path

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

CFG = dict(height=128, width=192, max_pairs=2**15)
CAM = dict(fx=160.0, fy=158.0, cx=96.5, cy=63.5)
TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return gt.resolve_device("cuda")


def _scene(n, seed, opacity_shift=0.0, scale_shift=0.0):
    r = np.random.default_rng(1234 + seed)
    p = {"pos": np.stack([r.uniform(-2, 2, n), r.uniform(-2, 2, n),
                          r.uniform(3, 8, n)], -1).astype(np.float32)}
    p["scale_raw"] = (r.normal(0, 0.3, (n, 3)) - 2.0 + scale_shift).astype(
        np.float32)
    p["q_raw"] = r.normal(0, 1.0, (n, 4)).astype(np.float32)
    p["q_raw"][:, 3] += 2.0
    p["opacity_raw"] = (r.normal(0.5, 1.0, n) + opacity_shift).astype(
        np.float32)
    p["f_dc"] = r.normal(0, 0.8, (n, 3)).astype(np.float32)
    p["f_rest"] = r.normal(0, 0.05, (n, 45)).astype(np.float32)
    return p, np.eye(4, dtype=np.float32)


def _inputs(params, c2w, cfg, dev):
    t = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
    c2w = torch.from_numpy(c2w).to(dev)
    with torch.no_grad():
        cov = build_cov3d_packed(t["scale_raw"], t["q_raw"])
        colors = evaluate_sh(t["f_dc"], t["f_rest"], t["pos"], c2w)
        proj = project_gaussians(t["pos"], cov, t["opacity_raw"], c2w,
                                 *CAM.values(), cfg)
        b = bin_gaussians(proj, cfg)
        feat = _pair_features(proj, colors, torch.float32)[b.depth_order.long()]
        return gather_pair_features(feat, b.pair_slot, b.gauss_offsets), b


def _active_slots(b, fwd_out, cfg):
    """[padded_pairs] bool: slots of the blocks the forward composited."""
    G = cfg.pair_block
    meta = b.block_meta.long()
    tile = meta >> tras.META_SHIFT
    rank = torch.arange(meta.shape[0], device=meta.device) \
        - b.tile_start.long()[tile] // G
    active = ((meta & tras.META_DEAD) == 0) & (rank >= 0) \
        & (rank < fwd_out[tile, 5, 0].long())
    return active.repeat_interleave(G)


# The full-size cases, 1920x1080 with the bench's camera: "synthetic1080p"
# 32,768 random gaussians seen from a camera turned 0.08 rad off the
# origin's (the suite's make_scene), "bench1080p" the bench checkpoint from
# its bench pose, "workload1080p" the profiler's workload (every tile four
# full blocks, max_pairs 2**18).
FULL = dict(height=1080, width=1920, max_pairs=2**22)
FULL_CAM = C.camera(1920, 1080)
FULL_KINDS = [(k, G) for k in ("synthetic1080p", "bench1080p")
              for G in (128, 256)]
SMALL_KINDS = [(k, G) for k in ("plain", "saturated") for G in (32, 128, 256)]


@functools.lru_cache(maxsize=1)
def _bench(dev):
    """(pool, bench pose, center, radius) of the bench checkpoint."""
    return C.checkpoint(dev)


def _synthetic(n):
    params, _ = _scene(n, 0)
    th = 0.08
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]], np.float32)
    c2w[:3, 3] = [0.1, -0.05, 0.2]
    return params, c2w


def _full_inputs(kind, cfg, dev):
    """(pair features, binning) of a full-size case at ``cfg``; for
    "workload1080p" the workload's tile ranges stand for the binning."""
    if kind == "workload1080p":
        pf, ts, tc = (t.to(dev) for t in make_workload(cfg, 4))
        return pf, SimpleNamespace(tile_start=ts, tile_count=tc)
    if kind == "bench1080p":
        pool, c2w, _, _ = _bench(dev)
        params, alive = pool.params, pool.alive
    else:
        params, c2w = _synthetic(32768)
        params = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
        alive = None
    sp = serving_path(params, c2w, *FULL_CAM, cfg, alive=alive)
    return sp["pair_feat"], sp["bin"]


def _case(kind, pair_block, dev, **kw):
    """(pair features, binning, cfg) of a small case ("plain", "saturated":
    600 gaussians at 192x128) or a full-size one."""
    if kind in ("plain", "saturated"):
        shift = dict(opacity_shift=6.0, scale_shift=1.0) \
            if kind == "saturated" else {}
        params, c2w = _scene(600, 0, **shift)
        cfg = gt.RenderConfig(**CFG, pair_block=pair_block, **kw)
        return (*_inputs(params, c2w, cfg, dev), cfg)
    full = dict(FULL, max_pairs=2**18) if kind == "workload1080p" else FULL
    cfg = gt.RenderConfig(**full, pair_block=pair_block, **kw)
    return (*_full_inputs(kind, cfg, dev), cfg)


def _plain_chunks(cfg):
    """(tiles, blocks) per chunk of the plain K1 and K2: 1,024 tiles and
    256 blocks at tile 16 and pair_block 128, scaled so that a chunk's
    [m, G, tile^2] temporaries keep their size."""
    work = cfg.pair_block * cfg.tile * cfg.tile
    return (max(1024 * 128 * 256 // work, 16),
            max(256 * 128 * 256 // work, 8))


@pytest.mark.parametrize("kind,pair_block", SMALL_KINDS + FULL_KINDS
                         + [("workload1080p", 128)])
def test_kernel_matches_plain(cuda, kind, pair_block):
    """K1 against its plain version, rows 0-5 bit for bit, finite, and the
    (pair, warp) its cull skips against the plain test's count: the small
    scenes, and at 1920x1080 the synthetic scene, the bench checkpoint at
    its bench pose and the profiler's workload."""
    pf, b, cfg = _case(kind, pair_block, cuda)
    before = tras.composite_pairs.launches
    got = tras.composite_pairs(pf, b.tile_start, b.tile_count, cfg)
    assert tras.composite_pairs.launches == before + 1
    want = tras.composite_pairs_plain(pf, b.tile_start, b.tile_count, cfg,
                                      tile_chunk=_plain_chunks(cfg)[0])
    torch.cuda.synchronize()
    assert torch.equal(got[:, :6], want[:, :6])
    assert (got[:, 6:] == 0).all() and torch.isfinite(got).all()
    if kind == "saturated":
        nblk = (b.tile_count + pair_block - 1) // pair_block
        assert (got[:, 5, 0] < nblk).any(), "no tile was skipped"
    # The (pair, warp) the kernel's cull skipped, against the plain test on
    # the composited blocks.
    skipped = torch.zeros(1, dtype=torch.int64, device=cuda)
    again = tras._launch_fwd(pf, b.tile_start, b.tile_count, cfg,
                             skipped=skipped)
    blk, tile, _ = tras.active_blocks(b.tile_start,
                                      tras.tile_block_offsets(want), cfg)
    n = tras.cull_audit(pf, blk, tile, cfg)
    torch.cuda.synchronize()
    assert torch.equal(again, got)
    assert n["unsafe"] == 0
    assert int(skipped.item()) == n["skipped"] > 0


def _dense_scene(n=1200, seed=11):
    """Dim, overlapping splats in a small patch: tiles far deeper than a
    rank cap of 64, and few saturate."""
    r = np.random.default_rng(seed)
    p = {"pos": np.stack([r.uniform(-0.4, 0.4, n), r.uniform(-0.4, 0.4, n),
                          r.uniform(3, 8, n)], -1).astype(np.float32)}
    p["scale_raw"] = (r.normal(0, 0.3, (n, 3)) - 1.4).astype(np.float32)
    p["q_raw"] = (r.normal(0, 1, (n, 4)) + [0, 0, 0, 2]).astype(np.float32)
    p["opacity_raw"] = r.normal(-1.5, 0.8, n).astype(np.float32)
    p["f_dc"] = r.normal(0, 0.8, (n, 3)).astype(np.float32)
    p["f_rest"] = r.normal(0, 0.05, (n, 45)).astype(np.float32)
    return p, np.eye(4, dtype=np.float32)


def _check_fwd_bwd(cuda, pf, b, cfg, counter, bwd_counter):
    """Both kernels against their plain versions on one layout: the
    forward's rows 0-5 and state bit for bit, the backward within 1e-5 of
    each row's max, zeros off the composited blocks, two runs equal; each
    launch counted once in its own counter. Returns the forward output."""
    args = (pf, b.tile_start, b.tile_count)
    tchunk, bchunk = _plain_chunks(cfg)
    before = getattr(tras.composite_pairs, counter)
    fwd, state = tras._composite_fwd(*args, cfg, with_state=True)
    assert getattr(tras.composite_pairs, counter) == before + 1
    want, want_state = tras.composite_pairs_plain(*args, cfg,
                                                  tile_chunk=tchunk,
                                                  with_state=True)
    torch.cuda.synchronize()
    assert torch.equal(fwd[:, :6], want[:, :6])
    active = _active_slots(b, fwd, cfg)
    assert active.any()
    blocks = active[::cfg.pair_block]
    assert torch.equal(state[blocks], want_state[blocks])
    gen = torch.Generator(device=cuda).manual_seed(0)
    gout = torch.randn(cfg.num_tiles, 8, cfg.tile**2, generator=gen,
                       device=cuda)
    before = getattr(tras.composite_pairs, bwd_counter)
    got = tras.composite_pairs_bwd(*args, fwd, state, gout, cfg)
    assert getattr(tras.composite_pairs, bwd_counter) == before + 1
    want_d = tras.composite_pairs_bwd_plain(*args, fwd, state, gout, cfg,
                                            block_chunk=bchunk)
    again = tras.composite_pairs_bwd(*args, fwd, state, gout, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, again), "two runs differ"
    for r in range(10):
        scale = float(want_d[r].abs().max())
        assert float((got[r] - want_d[r]).abs().max()) <= 1e-5 * scale, r
    assert (got[:, ~active] == 0).all()
    return fwd


@pytest.mark.parametrize("kind,pair_block", [
    (k, G) for k in ("plain", "saturated") for G in (32, 128)]
    + [("bench1080p", 128)])
def test_log_kernels_match_plain(cuda, kind, pair_block):
    """transmittance_math="log": K1 bit for bit with its plain version, its
    cull's count equal to the plain test's; K2 from K1's state. On the
    small scenes the colour rows within 2e-6 of the cumprod kernel's."""
    pf, b, cfg = _case(kind, pair_block, cuda, transmittance_math="log")
    fwd = _check_fwd_bwd(cuda, pf, b, cfg, "log_launches",
                         "bwd_log_launches")
    skipped = torch.zeros(1, dtype=torch.int64, device=cuda)
    tras._launch_fwd(pf, b.tile_start, b.tile_count, cfg, skipped=skipped)
    blk, tile, _ = tras.active_blocks(b.tile_start,
                                      tras.tile_block_offsets(fwd), cfg)
    n = tras.cull_audit(pf, blk, tile, cfg)
    torch.cuda.synchronize()
    assert n["unsafe"] == 0 and int(skipped.item()) == n["skipped"] > 0
    if kind != "bench1080p":
        # The colour rows against the cumprod kernel's: the JAX package's
        # 2e-6 gate between its two modes (on its 64x64 scene).
        cum = tras.composite_pairs(pf, b.tile_start, b.tile_count,
                                   cfg.with_(transmittance_math="cumprod"))
        assert float((cum[:, 0:3] - fwd[:, 0:3]).abs().max()) <= 2e-6
    if kind == "saturated":
        nblk = (b.tile_count + pair_block - 1) // pair_block
        assert (fwd[:, 5, 0] < nblk).any(), "no tile was skipped"


@pytest.mark.parametrize("case", ["sized", "overflow", "bench1080p",
                                  "bench1080p_overflow"])
def test_truncated_kernels_match_plain(cuda, case):
    """A rank-truncated list (tile_rank_cap 64, the occlusion cull on), and
    one whose capacity overflows (trunc_pairs 320, where one tile's second
    block lies past the end); at the bench checkpoint's 1080p bench pose
    with tile_rank_cap 1024 and 64 depth chunks, trunc_pairs sized as
    --auto_pairs sizes it and at half the truncated demand: the forward
    stops at the list's end as its plain version does, the backward
    follows it. The overflowing frame at the bench pose reports its
    overflow and equals the plain compositor's image on the same list."""
    from gsplat_tpu_torch.render import pair_demand

    overflow = case.endswith("overflow")
    if case.startswith("bench"):
        pool, c2w, _, _ = _bench(cuda)
        cfg = gt.RenderConfig(**FULL, tile_rank_cap=1024, cull_chunks=64)
        with torch.no_grad():
            tk = int(pair_demand(pool.params, c2w, *FULL_CAM, cfg,
                                 alive=pool.alive)[2])
        cfg = cfg.with_(trunc_pairs=tk // 2 if overflow else C.rup(tk))
        pf, b = _full_inputs("bench1080p", cfg, cuda)
    else:
        params, c2w = _dense_scene()
        cfg = gt.RenderConfig(**CFG, pair_block=32, tile_rank_cap=64,
                              trunc_pairs=10 * 32 if overflow else 0)
        pf, b = _inputs(params, c2w, cfg, cuda)
        assert int(b.num_pairs_kept) < int(b.num_pairs)
    G = cfg.pair_block
    assert pf.shape[1] == cfg.trunc_padded_pairs
    assert (int(b.trunc_demand) > cfg.trunc_padded_pairs) == overflow
    fwd = _check_fwd_bwd(cuda, pf, b, cfg, "launches", "bwd_launches")
    ts = b.tile_start.long()
    nblk = (b.tile_count.long() + G - 1) // G
    walked = (ts + nblk * G <= pf.shape[1]) | (nblk == 0)
    # Overflow: some tile's blocks run past the end and it stops there.
    assert bool((~walked).any()) == overflow
    assert bool((ts + fwd[:, 5, 0].long() * G <= pf.shape[1]).all())
    assert torch.isfinite(fwd).all()
    if case == "bench1080p_overflow":
        with torch.no_grad():
            img, aux = gt.render_from_params(pool.params, c2w, *FULL_CAM,
                                             cfg, alive=pool.alive)
        assert int(aux.trunc_demand) > aux.trunc_capacity
        assert torch.isfinite(img).all()
        assert torch.equal(img, C.image_from_tiles(fwd, b.tile_count, cfg))


def _stacked_inputs(params, cfg, dev, views=3):
    """``views`` poses of one scene stacked by ``stack_view_projections``
    (view v's tile rows offset by v * tiles_y): (pair features, binning,
    the stacked config with view_tile_rows = tiles_y)."""
    from gsplat_tpu_torch.render import stack_view_projections

    t = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
    with torch.no_grad():
        cov = build_cov3d_packed(t["scale_raw"], t["q_raw"])
        projs, colors = [], []
        for v in range(views):
            c2w = torch.eye(4, device=dev)
            c2w[0, 3] = 0.3 * v - 0.3
            colors.append(evaluate_sh(t["f_dc"], t["f_rest"], t["pos"], c2w))
            projs.append(project_gaussians(t["pos"], cov, t["opacity_raw"],
                                           c2w, *CAM.values(), cfg))
        proj_b = type(projs[0])(*(torch.stack(f) for f in zip(*projs)))
        stacked, bcfg = stack_view_projections(proj_b, cfg)
        b = bin_gaussians(stacked, bcfg)
        feat = _pair_features(stacked, torch.cat(colors), torch.float32)[
            b.depth_order.long()]
        return gather_pair_features(feat, b.pair_slot, b.gauss_offsets), b, \
            bcfg


def _train_batch_inputs(dev):
    """The bench checkpoint's training batch (its bench pose and three
    orbit poses at 960x540) stacked as render_batch_from_params stacks
    it: (pair features, binning, the stacked config, a view's config)."""
    from gsplat_tpu_torch.render import stack_view_projections

    pool, c2w, center, radius = _bench(dev)
    cfg, batch, _ = C.train_views(pool, c2w, center, radius)
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
            type(projs[0])(*(torch.stack(f) for f in zip(*projs))), cfg)
        b = bin_gaussians(stacked, bcfg)
        feat = _pair_features(stacked, torch.cat(colors), torch.float32)[
            b.depth_order.long()]
        return gather_pair_features(feat, b.pair_slot, b.gauss_offsets), b, \
            bcfg, cfg


@pytest.mark.parametrize("math,views", [("cumprod", "small"), ("log", "small"),
                                        ("cumprod", "train_batch")])
def test_wrapped_rows_kernels_match_plain(cuda, math, views):
    """Batched views (view_tile_rows > 0): K1 bit for bit with its plain
    version and its cull's count equal to the plain test's under the row
    wrap; K2 from K1's state within 1e-5. Three views of the small scene,
    and the bench checkpoint's training batch, four views at 960x540."""
    if views == "train_batch":
        pf, b, bcfg, cfg = _train_batch_inputs(cuda)
    else:
        params, _ = _scene(600, 0)
        cfg = gt.RenderConfig(**CFG, transmittance_math=math)
        pf, b, bcfg = _stacked_inputs(params, cfg, cuda)
    assert bcfg.view_tile_rows == cfg.tiles_y
    log = math == "log"
    fwd = _check_fwd_bwd(cuda, pf, b, bcfg,
                         "log_launches" if log else "launches",
                         "bwd_log_launches" if log else "bwd_launches")
    skipped = torch.zeros(1, dtype=torch.int64, device=cuda)
    tras._launch_fwd(pf, b.tile_start, b.tile_count, bcfg, skipped=skipped)
    blk, tile, _ = tras.active_blocks(b.tile_start,
                                      tras.tile_block_offsets(fwd), bcfg)
    n = tras.cull_audit(pf, blk, tile, bcfg)
    torch.cuda.synchronize()
    assert n["unsafe"] == 0 and int(skipped.item()) == n["skipped"] > 0
    occ = b.tile_count > 0
    assert occ[bcfg.num_tiles * 2 // 3:].any(), "the last view is empty"


@pytest.mark.parametrize("kind", ["plain", "saturated"])
def test_compact_backward_matches_plain(cuda, kind):
    """K2 in compact mode (kb >= and < the composited blocks): within 1e-5
    of its plain version, columns past the kept blocks zero, two runs
    equal, each launch counted in bwd_compact_launches; the kept columns
    equal to the block layout's."""
    shift = dict(opacity_shift=6.0, scale_shift=1.0) if kind == "saturated" \
        else {}
    params, c2w = _scene(600, 0, **shift)
    cfg = gt.RenderConfig(**CFG)
    pf, b = _inputs(params, c2w, cfg, cuda)
    args = (pf, b.tile_start, b.tile_count)
    fwd, state = tras._composite_fwd(*args, cfg, with_state=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    gout = torch.randn(cfg.num_tiles, 8, cfg.tile**2, generator=gen,
                       device=cuda)
    full = tras.composite_pairs_bwd(*args, fwd, state, gout, cfg)
    off = tras.tile_block_offsets(fwd)
    n_active = int(off[-1])
    G = cfg.pair_block
    for kb in (n_active + 3, max(n_active // 2, 1)):
        before = tras.composite_pairs.bwd_compact_launches
        got = tras.composite_pairs_bwd(*args, fwd, state, gout, cfg, kb=kb)
        again = tras.composite_pairs_bwd(*args, fwd, state, gout, cfg, kb=kb)
        assert tras.composite_pairs.bwd_compact_launches == before + 2
        want = tras.composite_pairs_bwd_plain(*args, fwd, state, gout, cfg,
                                              kb=kb)
        torch.cuda.synchronize()
        assert tuple(got.shape) == (10, kb * G)
        assert torch.equal(got, again), "two runs differ"
        for r in range(10):
            scale = float(want[r].abs().max())
            assert float((got[r] - want[r]).abs().max()) <= 1e-5 * scale, r
        kept = min(n_active, kb)
        assert (got[:, kept * G:] == 0).all()
        blk, _, _, valid = tras.composited_blocks(b.tile_start, off, kb,
                                                  cfg)
        cols = (blk[valid, None] * G
                + torch.arange(G, device=cuda)).reshape(-1)
        assert torch.equal(got[:, :kept * G], full[:, cols])


@pytest.mark.parametrize("batched", [False, True])
def test_sized_compaction_is_bit_exact_on_card(cuda, batched):
    """bwd_pairs at the demand gives the gradients of bwd_pairs = 0 bit for
    bit on the card (one view, and a batch of three)."""
    params, c2w = _scene(600, 0)
    cfg = gt.RenderConfig(**CFG)
    poses = np.stack([c2w] * 3)
    poses[:, 0, 3] = [-0.3, 0.0, 0.3]

    def run(cfg):
        t = {k: torch.from_numpy(v).to(cuda).requires_grad_(True)
             for k, v in params.items()}
        if batched:
            img, aux = gt.render_batch_from_params(t, poses, *CAM.values(),
                                                   cfg)
        else:
            img, aux = gt.render_from_params(t, c2w, *CAM.values(), cfg)
        (img.mean() + (img * img).mean()).backward()
        return aux, {k: v.grad for k, v in t.items()}

    aux0, g0 = run(cfg)
    demand = int(aux0.bwd_demand)
    per_view = -(-demand // 3) if batched else demand
    auxc, gc = run(cfg.with_(bwd_pairs=per_view))
    assert int(auxc.bwd_demand) <= auxc.bwd_capacity
    for k in params:
        assert torch.equal(g0[k], gc[k]), k


def test_render_on_card_matches_cpu(cuda):
    params, c2w = _scene(600, 3)
    cfg = gt.RenderConfig(**CFG)
    out = {}
    for dev in ("cpu", cuda):
        t = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
        with torch.no_grad():
            out[str(dev)[:4]] = gt.render_from_params(t, c2w, *CAM.values(),
                                                      cfg)
    (img_c, aux_c), (img_g, aux_g) = out["cpu"], out["cuda"]
    assert int(aux_c.num_pairs) == int(aux_g.num_pairs)
    assert float((img_g.cpu() - img_c).abs().max()) <= 1e-4
    assert float((aux_g.alpha.cpu() - aux_c.alpha).abs().max()) <= 1e-4


@pytest.mark.parametrize("kind,pair_block", SMALL_KINDS + FULL_KINDS)
def test_forward_kernel_state_matches_plain(cuda, kind, pair_block):
    pf, b, cfg = _case(kind, pair_block, cuda)
    args = (pf, b.tile_start, b.tile_count, cfg)
    bare = tras._composite_fwd(*args)
    out, state = tras._composite_fwd(*args, with_state=True)
    _, want = tras.composite_pairs_plain(*args, with_state=True,
                                         tile_chunk=_plain_chunks(cfg)[0])
    torch.cuda.synchronize()
    assert torch.equal(out, bare)
    active = _active_slots(b, out, cfg)[::pair_block]
    assert active.any()
    assert torch.equal(state[active], want[active])


@pytest.mark.parametrize("kind,pair_block", SMALL_KINDS + FULL_KINDS)
def test_backward_kernel_matches_plain(cuda, kind, pair_block):
    pf, b, cfg = _case(kind, pair_block, cuda)
    args = (pf, b.tile_start, b.tile_count)
    fwd, state = tras._composite_fwd(*args, cfg, with_state=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    gout = torch.randn(cfg.num_tiles, 8, cfg.tile**2, generator=gen,
                       device=cuda)
    before = tras.composite_pairs.bwd_launches
    got = tras.composite_pairs_bwd(*args, fwd, state, gout, cfg)
    assert tras.composite_pairs.bwd_launches == before + 1
    want = tras.composite_pairs_bwd_plain(*args, fwd, state, gout, cfg,
                                          block_chunk=_plain_chunks(cfg)[1])
    again = tras.composite_pairs_bwd(*args, fwd, state, gout, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, again), "two runs differ"
    for r in range(10):
        scale = float(want[r].abs().max())
        assert float((got[r] - want[r]).abs().max()) <= 1e-5 * scale, r
    off = ~_active_slots(b, fwd, cfg)
    assert off.any() and (got[:, off] == 0).all()
    if kind == "saturated":
        nblk = (b.tile_count + pair_block - 1) // pair_block
        assert (fwd[:, 5, 0] < nblk).any(), "no tile was skipped"


def test_kernel_runs_backward_for_grad_and_refuses_other_tiles(cuda):
    params, c2w = _scene(600, 3)
    cfg = gt.RenderConfig(**CFG)
    pf, b = _inputs(params, c2w, cfg, cuda)
    pf = pf.clone().requires_grad_(True)
    k1, k2 = tras.composite_pairs.launches, tras.composite_pairs.bwd_launches
    out = tras.composite_pairs(pf, b.tile_start, b.tile_count, cfg)
    gout = torch.ones_like(out)
    out.backward(gout)
    assert tras.composite_pairs.launches == k1 + 1
    assert tras.composite_pairs.bwd_launches == k2 + 1
    _, state = tras.composite_pairs_plain(pf.detach(), b.tile_start,
                                          b.tile_count, cfg, with_state=True)
    want = tras.composite_pairs_bwd_plain(pf.detach(), b.tile_start,
                                          b.tile_count, out.detach(), state,
                                          gout, cfg)
    for r in range(10):
        scale = float(want[r].abs().max())
        assert float((pf.grad[r] - want[r]).abs().max()) <= 1e-5 * scale
    with pytest.raises(ValueError, match="state"):  # no fallback
        tras.composite_pairs_bwd(pf.detach(), b.tile_start, b.tile_count,
                                 out.detach(), None, gout, cfg)
    cfg8 = cfg.with_(tile=8)
    ts8 = torch.zeros(cfg8.num_tiles, dtype=torch.int32, device=cuda)
    pf8 = torch.zeros(10, cfg8.padded_pairs, device=cuda)
    with pytest.raises(ValueError, match="tile=16"):
        tras.composite_pairs(pf8, ts8, ts8, cfg8)
    fo8 = torch.zeros(cfg8.num_tiles, 8, 64, device=cuda)
    st8 = torch.zeros(cfg8.num_pair_blocks, 5, 64, device=cuda)
    with pytest.raises(ValueError, match="tile=16"):
        tras.composite_pairs_bwd(pf8, ts8, ts8, fo8, st8, fo8, cfg8)
    ts = torch.zeros(cfg.num_tiles, dtype=torch.int32, device=cuda)
    empty = torch.zeros(10, cfg.padded_pairs, device=cuda)
    out, st = tras._composite_fwd(empty, ts, ts, cfg, with_state=True)
    d = tras.composite_pairs_bwd(empty, ts, ts, out, st,
                                 torch.ones_like(out), cfg)
    torch.cuda.synchronize()
    assert (out[:, 4] == 1).all() and (out[:, [0, 1, 2, 3, 5]] == 0).all()
    assert (d == 0).all()


def test_train_step_on_card_matches_cpu(cuda):
    params, c2w = _scene(600, 3)
    n = 640  # 40 dead slots
    params = {k: np.concatenate([v, np.zeros((n - 600,) + v.shape[1:],
                                             np.float32)])
              for k, v in params.items()}
    alive = np.arange(n) < 600
    cfg = gt.RenderConfig(**CFG)
    tcfg = gt.TrainConfig(capacity=n, batch_size=2)
    poses = np.stack([c2w, c2w])
    poses[1, 0, 3] = 0.2
    target = {k: torch.from_numpy(v) for k, v in params.items()}
    target["f_dc"] = target["f_dc"] + 0.5
    with torch.no_grad():  # one ground truth for both devices
        imgs = torch.stack([gt.render_from_params(
            target, p, *CAM.values(), cfg, alive=torch.from_numpy(alive))[0]
            for p in poses])
    grads = {}
    for dev in ("cpu", cuda):
        pool = gt.pool_from_numpy(params, alive, device=dev)
        batch = {"image": imgs.to(dev), "c2w": torch.from_numpy(poses).to(dev)}
        batch.update({k: torch.full((2,), v, device=dev)
                      for k, v in CAM.items()})
        state = gt.init_train_state(pool, tcfg)
        _, m = gt.make_train_step(cfg, tcfg)(state, batch)
        assert int(m["nonfinite_skipped"]) == 0
        grads[str(dev)[:4]] = {k: p.grad.cpu() for k, p in
                               pool.params.items()}
    for k, want in grads["cpu"].items():
        got = grads["cuda"][k]
        scale = float(want.abs().max())
        assert scale > 0 and torch.isfinite(got).all(), k
        assert float((got - want).abs().max()) <= 5e-4 * scale, k


@pytest.mark.parametrize("opacity", [0.05, 0.9, "workload1080p"])
@pytest.mark.parametrize("variant", list(tabl.VARIANTS))
def test_ablation_kernel_matches_plain(cuda, variant, opacity):
    """The profiler's workload at 192x128; at opacity 0.9 every variant
    with the skip rule (all but empty, no-compute and no-input, whose
    features ignore the opacity) skips continuation blocks. And the
    profiler's own workload at 1920x1080 (opacity 0.05), where the bodies
    that cull report the (pair, warp) they skipped, equal to the plain
    test's count (no-transc's with its own alpha's threshold)."""
    if opacity == "workload1080p":
        cfg = gt.RenderConfig(**dict(FULL, max_pairs=2**18))
        pf, ts, tc = (t.to(cuda) for t in make_workload(cfg, 4))
    else:
        cfg = gt.RenderConfig(**CFG)
        pf, ts, tc = (t.to(cuda) for t in make_workload(cfg, 4))
        pf[5] = opacity
    skipped = torch.zeros(1, dtype=torch.int64, device=cuda)
    kw = {"skipped": skipped} if variant in tabl.CULLS else {}
    before = tabl.ablate.launches[variant]
    got = tabl.ablate(variant, pf, ts, tc, cfg, **kw)
    assert tabl.ablate.launches[variant] == before + 1
    want = tabl.ablate_plain(variant, pf, ts, tc, cfg, tile_chunk=512)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got[:, :5] - want[:, :5]).abs().max()) <= TOL
    assert torch.equal(got[:, 5], want[:, 5])
    assert (got[:, 6:] == 0).all()
    if opacity == 0.9 and variant not in ("empty", "no-compute", "no-input"):
        assert (got[:, 5, 0] < 4).any(), "no tile was skipped"
    if opacity == "workload1080p" and variant in tabl.CULLS:
        blk, tile, _ = tras.active_blocks(ts, tras.tile_block_offsets(want),
                                          cfg)
        n = tras.cull_audit(pf, blk, tile, cfg, rational=tabl.CULLS[variant])
        assert n["unsafe"] == 0 and n["skipped"] > 0
        assert int(skipped.item()) == n["skipped"]
    if variant in tabl.K1_FUNCTION:
        k1 = tras.composite_pairs_plain(pf, ts, tc, cfg, tile_chunk=512)
        assert float((got[:, :5] - k1[:, :5]).abs().max()) <= TOL
        assert torch.equal(got[:, 5], k1[:, 5])


def test_profiler_runs_every_variant_in_order(cuda):
    """python -m gsplat_tpu_torch.profile_kernel --iters 20 through its
    main, the launch counts set to 0 just before: every variant launched,
    its count the profiler's own, a positive time, its tile-0 digest
    within 1e-3 of its plain version's on the same 1080p workload; and
    the times in the order of the work the bodies do, empty <= no-compute
    <= full, each within 5 %."""
    from gsplat_tpu_torch import profile_kernel

    cfg = gt.RenderConfig(**dict(FULL, max_pairs=2**18))
    pf, ts, tc = (t.to(cuda) for t in make_workload(cfg, 4))
    digests = {"full": float(tras.composite_pairs_plain(
        pf, ts, tc, cfg, tile_chunk=512)[0, 0:5].sum())}
    for v in profile_kernel.VARIANTS:
        if v != "full":
            digests[v] = float(tabl.ablate_plain(
                v, pf, ts, tc, cfg, tile_chunk=512)[0, 0:5].sum())
    del pf, ts, tc
    tras.composite_pairs.launches = 0
    for v in tabl.ablate.launches:
        tabl.ablate.launches[v] = 0
    res = {r["name"]: r for r in profile_kernel.main(
        ["--iters", "20", "--device", str(cuda)])}
    for name, digest in digests.items():
        r, n = res[name], profile_kernel.launch_count(name)
        assert n > 0 and r["launches"] == n and r["ms"] > 0, (name, r)
        assert abs(r["digest"] - digest) <= 1e-3, (name, r, digest)
    e, nc, k1 = (res[v]["ms"] for v in ("empty", "no-compute", "full"))
    assert e <= 1.05 * nc and nc <= 1.05 * k1, (e, nc, k1)


@pytest.mark.parametrize("variant", tabl.K1_BODIES)
def test_k1_body_matches_plain_and_its_cull(cuda, variant):
    """The six bodies built from K1's kernel on the profiler's workload at
    192x128 with opacities spread from below the cutoff to 0.9 (some tiles
    saturate): rows 0-4 within 2e-5, row 5 exact, rows 6-7 zero; the bodies
    that cull report the (pair, warp) they skipped, equal to the plain
    test's count (no-transc's with its own alpha's threshold), none with
    a non-zero alpha."""
    cfg = gt.RenderConfig(**CFG)
    pf, ts, tc = (t.to(cuda) for t in make_workload(cfg, 4))
    r = np.random.default_rng(3)
    pf[5] = torch.from_numpy(np.exp(r.uniform(
        np.log(0.5 / 128), np.log(0.9), pf.shape[1])).astype(np.float32)
    ).to(cuda)
    skipped = torch.zeros(1, dtype=torch.int64, device=cuda)
    kw = {"skipped": skipped} if variant in tabl.CULLS else {}
    got = tabl.ablate(variant, pf, ts, tc, cfg, **kw)
    want = tabl.ablate_plain(variant, pf, ts, tc, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got[:, :5] - want[:, :5]).abs().max()) <= TOL
    assert torch.equal(got[:, 5], want[:, 5])
    assert (got[:, 6:] == 0).all()
    if variant in tabl.CULLS:
        blk, tile, _ = tras.active_blocks(ts, tras.tile_block_offsets(want),
                                          cfg)
        n = tras.cull_audit(pf, blk, tile, cfg, rational=tabl.CULLS[variant])
        assert n["unsafe"] == 0 and n["skipped"] > 0
        assert int(skipped.item()) == n["skipped"]


def _indexed_inputs(kind, cfg, dev):
    """(table [N, TABLE_WIDTH], the pair list [10, pairs] the gathered K1
    reads, binning, the config it was binned at) of "batched" (three views
    of the small scene stacked, view_tile_rows set) or "truncated" (the
    dense patch at tile_rank_cap 600: deep tiles cut, several blocks
    kept)."""
    from gsplat_tpu_torch.ops.rasterize import _gather, _pair_table
    from gsplat_tpu_torch.render import stack_view_projections

    if kind == "truncated":
        params, c2w = _dense_scene()
        cfg = cfg.with_(tile_rank_cap=600)
    else:
        params, c2w = _scene(600, 0)
    t = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
    poses = [torch.from_numpy(c2w).to(dev)]
    if kind == "batched":
        poses = [poses[0].clone() for _ in range(3)]
        for v, p in enumerate(poses):
            p[0, 3] += 0.3 * v - 0.3
    with torch.no_grad():
        cov = build_cov3d_packed(t["scale_raw"], t["q_raw"])
        projs = [project_gaussians(t["pos"], cov, t["opacity_raw"], p,
                                   *CAM.values(), cfg) for p in poses]
        colors = torch.cat([evaluate_sh(t["f_dc"], t["f_rest"], t["pos"], p)
                            for p in poses])
        proj = projs[0]
        if kind == "batched":
            proj, cfg = stack_view_projections(type(proj)(
                *(torch.stack(f) for f in zip(*projs))), cfg)
        b = bin_gaussians(proj, cfg)
        table = _pair_table(proj, colors, b.depth_order)
        pf = _gather(_pair_features(proj, colors, torch.float32)[
            b.depth_order.long()], b.pair_slot)
    return table, pf, b, cfg


@pytest.mark.parametrize("kind", ["batched", "truncated"])
@pytest.mark.parametrize("math", ["cumprod", "log"])
@pytest.mark.parametrize("tile,pair_block", [
    (t, G) for t in (16, 32) for G in (128, 256, 512)])
def test_indexed_k1_matches_the_gathered_k1(cuda, tile, pair_block, math,
                                             kind):
    """K1 reading each pair's row by its slot from the depth-ordered table
    against K1 reading the gathered pair list, on a batched list and a
    truncated one, at every (tile, G) instantiation and both
    transmittances: the output bit for bit (as int32), the same (pair,
    warp) skipped, each launch in its own counter."""
    cfg = gt.RenderConfig(**CFG, tile=tile, pair_block=pair_block,
                          transmittance_math=math)
    table, pf, b, cfg = _indexed_inputs(kind, cfg, cuda)
    if kind == "truncated":
        assert int(b.num_pairs_kept) < int(b.num_pairs)
        assert int(b.tile_count.max()) > pair_block
    else:
        assert cfg.view_tile_rows == CFG["height"] // tile
    args = (b.tile_start, b.tile_count, cfg)
    counter = "log_launches" if math == "log" else "launches"
    cp = tras.composite_pairs
    n_idx, n_list = cp.indexed_launches, getattr(cp, counter)
    got = tras.composite_pairs_indexed(table, b.pair_slot, *args)
    assert cp.indexed_launches == n_idx + 1
    assert getattr(cp, counter) == n_list
    want = tras.composite_pairs(pf, *args)
    assert getattr(cp, counter) == n_list + 1
    skips = [torch.zeros(1, dtype=torch.int64, device=cuda) for _ in "ab"]
    tras._launch_fwd(table, *args, skipped=skips[0], pair_slot=b.pair_slot)
    tras._launch_fwd(pf, *args, skipped=skips[1])
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got[:, 5, 0] > 0).any() and torch.isfinite(got).all()
    assert int(skips[0].item()) == int(skips[1].item()) > 0


def test_pair_table_kernel_matches_plain(cuda):
    """pair_table_kernel against pair_table_plain, bit for bit (as int32):
    100,003 rows (not a whole number of CTAs) in a random order, a third of
    them not valid and holding NaN and inf, NaN in valid rows too, each
    launch counted; no rows; and the bench checkpoint's table at its 1080p
    bench pose."""
    gen = torch.Generator().manual_seed(0)
    n = 100_003
    f = [torch.randn(n, w, generator=gen) for w in (2, 3, 1, 3, 1)]
    valid = torch.rand(n, generator=gen) > 1 / 3
    dead = torch.nonzero(~valid)[:, 0]
    for a in f:
        a[dead] = float("nan")
        a[dead[::7]] = float("inf")
    f[4][5] = float("nan")
    assert bool(valid[5])
    args = [torch.randperm(n, generator=gen).to(torch.int32), valid,
            f[0], f[1], f[2][:, 0], f[3], f[4][:, 0]]
    card = [a.to(cuda) for a in args]
    pool, c2w, _, _ = _bench(cuda)
    sp = serving_path(pool.params, c2w, *FULL_CAM, gt.RenderConfig(**FULL),
                      alive=pool.alive)
    p = sp["proj"]
    bench = [sp["bin"].depth_order, p.valid, p.uv, p.conic, p.opacity,
             sp["colors"], p.depth]
    for a in (card, [a[:0] for a in card], bench):
        before = tras.pair_table.launches
        got = tras.pair_table(*a)
        assert tras.pair_table.launches == before + (a[0].shape[0] > 0)
        want = tras.pair_table_plain(*a)
        assert got.shape == (a[0].shape[0], tras.TABLE_WIDTH)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert (got[:, 10:] == 0).all()


@pytest.mark.parametrize("scene", ["small", "bench1080p"])
def test_served_frame_reads_the_table_bit_for_bit(cuda, scene, monkeypatch):
    """A frame through viewer.make_render_fn (no autograd: K1 reads the
    table by slot) against the same frame through the pair list (_gather,
    then composite_pairs, put in composite_pairs_indexed's place): bit for
    bit; the served frame counts one indexed K1 launch and no other."""
    from gsplat_tpu_torch.ops import rasterize
    from gsplat_tpu_torch.viewer import make_render_fn

    if scene == "bench1080p":
        pool, c2w, _, _ = _bench(cuda)
        params, alive, cam = pool.params, pool.alive, FULL_CAM
        cfg = gt.RenderConfig(**FULL)
    else:
        params, c2w = _scene(600, 3)
        params, alive, cam = _card_params(params, cuda), None, CAM.values()
        cfg = gt.RenderConfig(**CFG)
    fn = make_render_fn(params, cfg, *cam, alive=alive)
    cp = tras.composite_pairs
    counts = lambda: (cp.indexed_launches, cp.launches,  # noqa: E731
                      cp.log_launches)
    before = counts()
    img = fn(c2w)
    assert [a - b for a, b in zip(counts(), before)] == [1, 0, 0]

    def through_the_list(table, pair_slot, tile_start, tile_count, cfg):
        pf = rasterize._gather(table[:, :tras.FEAT_ROWS], pair_slot)
        return tras.composite_pairs(pf, tile_start, tile_count, cfg)

    monkeypatch.setattr(rasterize.raster_cuda, "composite_pairs_indexed",
                        through_the_list)
    before = counts()
    want = fn(c2w)
    assert [a - b for a, b in zip(counts(), before)] == [0, 1, 0]
    torch.cuda.synchronize()
    assert torch.equal(img.view(torch.int32), want.view(torch.int32))
    assert 0.0 < float(img.mean()) < 1.0


def test_a_train_step_reads_the_gathered_list(cuda):
    """A train step records autograd: its K1 reads the gathered pair list
    (``launches``), K2 runs once, and the indexed read does not engage."""
    params, c2w = _scene(600, 0)
    cfg = gt.RenderConfig(**CFG)
    tcfg = gt.TrainConfig(capacity=600, batch_size=1)
    state = gt.init_train_state(gt.pool_from_numpy(
        params, np.ones(600, bool), device=cuda), tcfg)
    with torch.no_grad():
        img = gt.render_from_params(_card_params(params, cuda), c2w,
                                    *CAM.values(), cfg)[0]
    batch = {"image": (img + 0.1)[None].clamp(0, 1),
             "c2w": torch.from_numpy(c2w)[None].to(cuda)}
    batch.update({k: torch.full((1,), v, device=cuda)
                  for k, v in CAM.items()})
    cp = tras.composite_pairs
    before = (cp.launches, cp.bwd_launches, cp.indexed_launches)
    state, m = gt.make_train_step(cfg, tcfg)(state, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(m["total"]))
    assert (cp.launches - before[0], cp.bwd_launches - before[1],
            cp.indexed_launches - before[2]) == (1, 1, 0)


@pytest.mark.parametrize("pair_block", [32, 160, 256])
@pytest.mark.parametrize("variant", ["pg-roll", "pg-log"])
def test_pg_kernel_matches_plain(cuda, variant, pair_block):
    """pg-roll and pg-log (tensor cores, every (pair, pixel)) at the
    smallest, an odd and the largest pair_block, at least 512 pairs a tile,
    opacities spread from below the cutoff to 0.99 and half of them 0.99,
    so that tiles saturate after different blocks: rows 0-4 within 2e-5
    of their plain version and of K1's, row 5 exact, rows 6-7 zero; the
    kernel spills nothing."""
    cfg = gt.RenderConfig(**CFG, pair_block=pair_block)
    bpt = max(3, 512 // pair_block)
    pf, ts, tc = (t.to(cuda) for t in make_workload(cfg, bpt))
    r = np.random.default_rng(5)
    op = np.exp(r.uniform(np.log(0.5 / 128), np.log(0.99), pf.shape[1]))
    op[r.uniform(size=op.shape) < 0.5] = 0.99
    pf[5] = torch.from_numpy(op.astype(np.float32)).to(cuda)
    got = tabl.ablate(variant, pf, ts, tc, cfg)
    want = tabl.ablate_plain(variant, pf, ts, tc, cfg)
    k1 = tras.composite_pairs_plain(pf, ts, tc, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    for ref in (want, k1):
        assert float((got[:, :5] - ref[:, :5]).abs().max()) <= TOL
        assert torch.equal(got[:, 5], ref[:, 5])
    assert (got[:, 6:] == 0).all()
    assert (got[:, 5, 0] < bpt).any()
    res = tabl.pg_resources(variant, cuda)
    assert res["local_bytes"] == 0 and res["ctas_per_sm"] >= 2


def test_tf32_split_kernel_matches_plain(cuda):
    """The pg kernels' TF32 split on the card (cvt.rna) against the plain
    version's bit arithmetic, bit for bit: random floats over a wide range
    of exponents, exact ties, subnormals and specials (NaN where NaN)."""
    r = np.random.default_rng(11)
    b = r.integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    ties = (b & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
    wide = r.normal(0, 1, 1 << 16) * np.exp(r.uniform(-80, 80, 1 << 16))
    x = np.concatenate([
        wide.astype(np.float32), b.view(np.float32), ties.view(np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                  np.finfo(np.float32).max], np.float32),
    ])
    xt = torch.from_numpy(x)
    before = tabl.tf32_split.launches
    got = tabl.tf32_split(xt.to(cuda))
    assert tabl.tf32_split.launches == before + 1
    for k, p in zip(got, tabl.tf32_split_plain(xt)):
        k = k.cpu()
        nan = torch.isnan(p)
        assert torch.equal(torch.isnan(k), nan)
        assert torch.equal(k[~nan].view(torch.int32), p[~nan].view(torch.int32))


# K1 reading the table by slot at <16, 256, cumprod>: its registers and
# CTAs per SM as built (nvcc 12, sm_90a)
INDEXED_REGS, INDEXED_CTAS = 47, 5


def _ptxas_entry(ptxas, args):
    """nvcc's -v report of the raster_fwd_kernel instantiation whose
    mangled template arguments are ``args`` (registers, shared memory,
    spills), split on its full mangled name."""
    import re

    names = [n for n in re.findall(r"Compiling entry function '([^']+)'",
                                   ptxas)
             if f"raster_fwd_kernelI{args}EE" in n]
    assert len(names) == 1, names
    part = ptxas.split(f"'{names[0]}'", 1)[1].split("Compiling entry", 1)[0]
    m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", part)
    spills = re.search(r"(\d+) bytes spill stores", part)
    return int(m.group(1)), int(m.group(2)), int(spills.group(1))


def test_k1_resources_unchanged(cuda):
    """K1 ("cumprod", tile 16, G <= 256) keeps the resources of its
    redesign now that its body is shared with the ablations: 40 registers,
    12,288 B of static shared memory, 6 CTAs per SM, and no library
    spills; the same instantiation reading the table by slot (kIndexed)
    holds what it was measured at."""
    from gsplat_tpu_torch.ops import _build
    import re

    built = _build.build()
    ptxas = built["raster_fwd"]["ptxas"]
    assert _ptxas_entry(ptxas, "Li16ELi256ELb0ELi0ELb0E") == (40, 12288, 0)
    assert tras.fwd_ctas_per_sm(cuda) == 6
    assert _ptxas_entry(ptxas, "Li16ELi256ELb0ELi0ELb1E") == (
        INDEXED_REGS, 12288, 0)
    assert tras.fwd_ctas_per_sm(cuda, indexed=True) == INDEXED_CTAS
    for name, info in built.items():
        for n in re.findall(r"(\d+) bytes spill stores", info["ptxas"]):
            assert int(n) == 0, name


def test_render_gradients_are_bit_identical_across_runs(cuda):
    """K2 has no float atomics and the gather backward scans in a fixed
    order, so a whole fwd+bwd repeats bit for bit."""
    params, c2w = _scene(600, 0)
    cfg = gt.RenderConfig(**CFG)
    grads = []
    for _ in range(2):
        t = {k: torch.from_numpy(v).to(cuda).requires_grad_(True)
             for k, v in params.items()}
        img, _ = gt.render_from_params(t, c2w, *CAM.values(), cfg)
        (img.mean() + (img * img).mean()).backward()
        grads.append({k: v.grad for k, v in t.items()})
    for k in params:
        assert torch.equal(grads[0][k], grads[1][k]), k


def _adc_pool(dev, cap=400, seed=5):
    """A random pool with scattered alive slots, opacities and scales
    across the thresholds, and its host copy."""
    r = np.random.default_rng(seed)
    params = {
        "pos": r.normal(0, 2, (cap, 3)),
        "opacity_raw": r.normal(-3.0, 2.0, cap),
        "f_dc": r.normal(0, 1, (cap, 3)),
        "f_rest": r.normal(0, 0.1, (cap, 45)),
        "scale_raw": r.normal(-4.5, 1.0, (cap, 3)),
        "q_raw": r.normal(0, 1, (cap, 4)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    alive = r.uniform(0, 1, cap) < 0.7
    return gt.pool_from_numpy(params, alive, device=dev), r


@pytest.mark.parametrize("form", ["reference", "paper"])
def test_adc_on_card_matches_cpu(cuda, form):
    """Both ADC forms on the card and on the CPU, given the same draws:
    masks, counts, alive and every copied row exact; the values computed
    from exp(scale) (split offsets) within 1 ulp (reference) or 1e-6 abs
    (paper, through the rotation), since each device rounds exp with its
    own math library."""
    from gsplat_tpu_torch.models import adc

    out = {}
    for side, dev in (("host", "cpu"), ("card", cuda)):
        pool, r = _adc_pool(dev)
        cap = pool.capacity
        if form == "reference":
            grad = torch.from_numpy(r.normal(0, 0.01, (cap, 3)).astype(
                np.float32)).to(dev)
            noise = torch.from_numpy(r.normal(0, 1, (cap, 3)).astype(
                np.float32)).to(dev)
            res = adc.densify_and_prune(pool, grad, noise=noise)
        else:
            uv = torch.from_numpy(np.abs(r.normal(0, 3e-4, cap)).astype(
                np.float32)).to(dev)
            radius = torch.from_numpy(r.integers(0, 40, cap).astype(
                np.int32)).to(dev)
            noise = tuple(torch.from_numpy(r.normal(0, 1, (cap, 3)).astype(
                np.float32)).to(dev) for _ in range(2))
            res = adc.densify_and_prune_paper(
                pool, uv, radius, noise=noise, scene_extent=2.5,
                max_screen_size=30)
        out[side] = (pool, res)
    (p_cpu, r_cpu), (p_gpu, r_gpu) = out["host"], out["card"]
    for f in ("num_pruned", "num_split", "num_cloned", "num_overflowed"):
        assert int(getattr(r_gpu, f)) == int(getattr(r_cpu, f)), f
    assert int(r_cpu.num_split) > 0 and int(r_cpu.num_cloned) > 0
    assert torch.equal(r_gpu.new_slot_mask.cpu(), r_cpu.new_slot_mask)
    assert torch.equal(p_gpu.alive.cpu(), p_cpu.alive)
    for k in ("opacity_raw", "f_dc", "f_rest", "q_raw"):
        assert torch.equal(getattr(p_gpu, k).detach().cpu(),
                           getattr(p_cpu, k).detach()), k
    for k in ("pos", "scale_raw"):
        got = getattr(p_gpu, k).detach().cpu().numpy()
        want = getattr(p_cpu, k).detach().numpy()
        if form == "reference":
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_fit_on_card_grows_the_pool_and_round_trips_a_checkpoint(cuda,
                                                                  tmp_path):
    """A small fit() on the card: a clone-only ADC overflows a 64-slot pool,
    which grows, and a 64-pair max_pairs overflows and grows; every step
    launches K1 and K2 once per view; the final checkpoint, loaded into a
    fresh state, equals the returned state bit for bit."""
    import importlib

    from gsplat_tpu_torch.train import trainer
    fit_mod = importlib.import_module("gsplat_tpu_torch.train.fit")

    params, c2w = _scene(48, 7)
    cfg = gt.RenderConfig(**CFG)
    poses = np.stack([c2w, c2w])
    poses[1, 0, 3] = 0.2
    with torch.no_grad():
        imgs = torch.stack([gt.render_from_params(
            {k: torch.from_numpy(v).to(cuda) for k, v in params.items()},
            p, *CAM.values(), cfg)[0] for p in poses])
    batch = {"image": imgs, "c2w": torch.from_numpy(poses).to(cuda)}
    batch.update({k: torch.full((2,), v, device=cuda)
                  for k, v in CAM.items()})

    def batches():
        while True:
            yield batch

    tcfg = gt.TrainConfig(iterations=8, batch_size=2, capacity=64,
                          densification_interval=4, densify_until_iter=9,
                          max_grad=1e-9, scale_threshold=1e3,
                          opacity_reset_interval=10_000,
                          checkpoint_interval=4)
    pts = np.concatenate([params["pos"], np.clip(params["f_dc"], 0, 1)], -1)
    k1, k2 = tras.composite_pairs.launches, tras.composite_pairs.bwd_launches
    logs = []
    state, report = fit_mod.fit(batches(), cfg.with_(max_pairs=64), tcfg,
                                output_dir=str(tmp_path), initial_points=pts,
                                log_every=2, log_fn=logs.append)
    assert tras.composite_pairs.launches - k1 == 16
    assert tras.composite_pairs.bwd_launches - k2 == 16
    assert any("growing pool capacity" in m for m in logs), logs
    assert any("growing max_pairs" in m for m in logs), logs
    assert state.pool.capacity == 128 and report.num_gaussians > 64
    assert report.nonfinite_steps == 0 and np.isfinite(report.final_loss)
    fresh = gt.init_train_state(gt.init_pool_from_points(pts, 64), tcfg)
    back = trainer.load_checkpoint(report.checkpoints[-1], fresh)
    assert back.pool.pos.device.type == "cuda"
    assert int(back.step) == int(state.step) == 8
    assert torch.equal(back.pool.alive, state.pool.alive)
    for k in gt.models.PARAM_KEYS:
        assert torch.equal(getattr(back.pool, k), getattr(state.pool, k)), k
        a = back.opt_state.state[getattr(back.pool, k)]
        b = state.opt_state.state[getattr(state.pool, k)]
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[f], b[f]), (k, f)


# --- the XLA compositor and evaluation on the card ----------------------------

def _card_params(params, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in params.items()}


def test_xla_matches_kernel_on_card(cuda):
    """``backend="xla"`` (plain PyTorch on the card) with ``max_per_tile``
    at the largest tile count against the kernel's render: image, depth
    and alpha within 2e-5 (depth: of its largest value); fewer slots per
    tile change the image, and launch no kernel."""
    params, c2w = _scene(600, 3)
    p = _card_params(params, cuda)
    cfg = gt.RenderConfig(**CFG)
    with torch.no_grad():
        img_k, aux_k = gt.render_from_params(p, c2w, *CAM.values(), cfg)
        cp = tras.composite_pairs
        n = (cp.launches, cp.indexed_launches)
        big = int(aux_k.max_tile_count)
        img_x, aux_x = gt.render_from_params(
            p, c2w, *CAM.values(), cfg.with_(backend="xla", max_per_tile=big))
        img_c, _ = gt.render_from_params(
            p, c2w, *CAM.values(), cfg.with_(backend="xla",
                                             max_per_tile=big // 4))
    assert (cp.launches, cp.indexed_launches) == n
    assert img_x.is_cuda and aux_x.bwd_demand is None
    assert float((img_x - img_k).abs().max()) <= TOL
    # The kernel stops a tile once every pixel's T is at or below
    # transmittance_min; the xla compositor multiplies T through all its
    # slots. So alpha agrees where the kernel's T stayed above it, and the
    # xla alpha is saturated elsewhere.
    live = aux_k.alpha < 1.0 - cfg.transmittance_min
    assert float((aux_x.alpha - aux_k.alpha)[live].abs().max()) <= TOL
    assert bool((aux_x.alpha[~live] >= 1.0 - cfg.transmittance_min
                 - TOL).all())
    assert float((aux_x.depth - aux_k.depth).abs().max()) \
        <= TOL * max(1.0, float(aux_k.depth.abs().max()))
    assert float((img_c - img_k).abs().max()) > 1e-3


def test_truncated_kernel_matches_xla_cap_on_card(cuda):
    """``tile_rank_cap=K`` through the kernels against ``backend="xla"``
    with ``max_per_tile=K`` (the JAX gate, tests/test_pallas_kernel.py:
    183-216): images within 2e-5, gradients within 5e-4 of each leaf's
    largest."""
    rng = np.random.default_rng(11)
    n = 1200
    params = {
        "pos": np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.4, 0.4, n),
                         rng.uniform(3, 8, n)], -1).astype(np.float32),
        "scale_raw": (rng.normal(0, 0.3, (n, 3)) - 1.4).astype(np.float32),
        "q_raw": (rng.normal(0, 1, (n, 4))
                  + np.array([0, 0, 0, 2])).astype(np.float32),
        "opacity_raw": rng.normal(-1.5, 0.8, n).astype(np.float32),
        "f_dc": rng.normal(0, 0.8, (n, 3)).astype(np.float32),
        "f_rest": rng.normal(0, 0.05, (n, 45)).astype(np.float32),
    }
    K = 128
    base = gt.RenderConfig(**CFG, max_per_tile=4096)
    tgt = torch.from_numpy(rng.uniform(0, 1, (128, 192, 3)).astype(
        np.float32)).to(cuda)
    out = {}
    for name, cfg in (("kernel", base.with_(tile_rank_cap=K)),
                      ("xla", base.with_(backend="xla", max_per_tile=K))):
        p = {k: v.requires_grad_(True)
             for k, v in _card_params(params, cuda).items()}
        img, aux = gt.render_from_params(p, np.eye(4, dtype=np.float32),
                                         *CAM.values(), cfg)
        (torch.mean(torch.abs(img - tgt)) + torch.mean(img * img)).backward()
        out[name] = (img.detach(), aux, {k: v.grad for k, v in p.items()})
    (img_k, aux_k, g_k), (img_x, _, g_x) = out["kernel"], out["xla"]
    assert int(aux_k.num_pairs_kept) < int(aux_k.num_pairs)
    assert float((img_k - img_x).abs().max()) <= TOL
    for k in params:
        scale = float(g_x[k].abs().max()) + 1e-12
        assert float((g_k[k] - g_x[k]).abs().max()) / scale <= 5e-4, k


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_evaluate_views_batch_matches_per_view_on_card(cuda, backend):
    """``evaluate_views`` on the card: ``render_batch=2`` (one binning and
    one launch per chunk, the last padded) against per-view, PSNR within
    1e-3 dB and L1 within 1e-6; a starved ``max_pairs`` grown by
    ``auto_size`` reproduces them."""
    from gsplat_tpu_torch.evaluation import evaluate_views

    params, _ = _scene(400, 5)
    p = _card_params(params, cuda)
    rng = np.random.default_rng(5)
    views = []
    for i in range(3):
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = 0.2 * i - 0.2
        views.append({"image": rng.uniform(0, 1, (128, 192, 3)).astype(
            np.float32), "c2w": c2w, **CAM})
    cfg = gt.RenderConfig(**CFG, max_per_tile=512, backend=backend)
    r1 = evaluate_views(p, views, cfg)
    r2 = evaluate_views(p, views, cfg, render_batch=2)
    r3 = evaluate_views(p, views, cfg.with_(max_pairs=1024))
    assert r3["eval_max_pairs"] >= r3["max_pair_demand"] > 1024
    for a, b, c in zip(r1["per_view"], r2["per_view"], r3["per_view"]):
        assert a["psnr"] == pytest.approx(b["psnr"], abs=1e-3)
        assert a["l1"] == pytest.approx(b["l1"], abs=1e-6)
        assert a["psnr"] == pytest.approx(c["psnr"], abs=1e-3)


# --- K1 and K2 at tile 32 and at pair_block 512 --------------------------------

# The (tile, pair_block) the kernels take beyond tile 16 with G <= 256.
NEW_RANGES = [(16, 512), (32, 128), (32, 256), (32, 512)]


def _check_cull_count(cuda, pf, b, fwd, cfg):
    """The (pair, warp) K1's cull skipped against the plain test."""
    skipped = torch.zeros(1, dtype=torch.int64, device=cuda)
    tras._launch_fwd(pf, b.tile_start, b.tile_count, cfg, skipped=skipped)
    blk, tile, _ = tras.active_blocks(b.tile_start,
                                      tras.tile_block_offsets(fwd), cfg)
    n = tras.cull_audit(pf, blk, tile, cfg)
    torch.cuda.synchronize()
    assert n["unsafe"] == 0 and int(skipped.item()) == n["skipped"] > 0


@pytest.mark.parametrize("tile,pair_block", NEW_RANGES)
@pytest.mark.parametrize("kind", ["plain", "saturated", "synthetic1080p",
                                  "bench1080p"])
def test_kernels_match_plain_at_new_ranges(cuda, kind, tile, pair_block):
    """K1 (rows 0-5 and state bit for bit, its cull's count equal to the
    plain test's) and K2 from K1's state (1e-5 of each row's max, zeros
    off the composited blocks, two runs equal) at tile 32 and at
    pair_block 512, as at tile 16: 3,000 gaussians at 192x128, and the
    full-size cases at 1920x1080."""
    if kind in ("plain", "saturated"):
        shift = dict(opacity_shift=6.0, scale_shift=1.0) \
            if kind == "saturated" else {}
        params, c2w = _scene(3000, 0, **shift)
        cfg = gt.RenderConfig(**{**CFG, "max_pairs": 2**17}, tile=tile,
                              pair_block=pair_block)
        pf, b = _inputs(params, c2w, cfg, cuda)
    else:
        cfg = gt.RenderConfig(**FULL, tile=tile, pair_block=pair_block)
        pf, b = _full_inputs(kind, cfg, cuda)
    fwd = _check_fwd_bwd(cuda, pf, b, cfg, "launches", "bwd_launches")
    _check_cull_count(cuda, pf, b, fwd, cfg)
    bare = tras.composite_pairs(pf, b.tile_start, b.tile_count, cfg)
    torch.cuda.synchronize()
    assert torch.equal(bare, fwd)
    nblk = (b.tile_count + pair_block - 1) // pair_block
    if kind == "saturated" and bool((nblk > 1).any()):
        assert (fwd[:, 5, 0] < nblk).any(), "no tile was skipped"


@pytest.mark.parametrize("mode", ["log", "compact", "rows_mod", "truncated",
                                  "log_bench1080p", "compact_bench1080p"])
def test_kernel_modes_match_plain_at_tile_32(cuda, mode):
    """Each mode of the kernels at tile 32 and pair_block 256: the log
    transmittance, K2's compact mode (kb at and below the composited
    blocks), batched views (rows_mod) and a rank-truncated list that
    overflows its capacity; the log form and the compact mode also on the
    bench checkpoint at its 1080p bench pose."""
    tile, G = 32, 256
    if mode == "rows_mod":
        params, _ = _scene(1500, 0)
        cfg = gt.RenderConfig(**CFG, tile=tile, pair_block=G)
        pf, b, cfg = _stacked_inputs(params, cfg, cuda)
        fwd = _check_fwd_bwd(cuda, pf, b, cfg, "launches", "bwd_launches")
        _check_cull_count(cuda, pf, b, fwd, cfg)
        return
    if mode == "truncated":
        params, c2w = _dense_scene(3000)
        cfg = gt.RenderConfig(**CFG, tile=tile, pair_block=G,
                              tile_rank_cap=512, trunc_pairs=3 * G)
        pf, b = _inputs(params, c2w, cfg, cuda)
        assert int(b.trunc_demand) > cfg.trunc_padded_pairs
        fwd = _check_fwd_bwd(cuda, pf, b, cfg, "launches", "bwd_launches")
        assert torch.isfinite(fwd).all()
        return
    math = "log" if mode.startswith("log") else "cumprod"
    if mode.endswith("bench1080p"):
        cfg = gt.RenderConfig(**FULL, tile=tile, pair_block=G,
                              transmittance_math=math)
        pf, b = _full_inputs("bench1080p", cfg, cuda)
    else:
        params, c2w = _scene(3000, 0)
        cfg = gt.RenderConfig(**{**CFG, "max_pairs": 2**17}, tile=tile,
                              pair_block=G, transmittance_math=math)
        pf, b = _inputs(params, c2w, cfg, cuda)
    if math == "log":
        fwd = _check_fwd_bwd(cuda, pf, b, cfg, "log_launches",
                             "bwd_log_launches")
        _check_cull_count(cuda, pf, b, fwd, cfg)
        return
    args = (pf, b.tile_start, b.tile_count)
    fwd, state = tras._composite_fwd(*args, cfg, with_state=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    gout = torch.randn(cfg.num_tiles, 8, tile**2, generator=gen, device=cuda)
    full = tras.composite_pairs_bwd(*args, fwd, state, gout, cfg)
    off = tras.tile_block_offsets(fwd)
    n_active = int(off[-1])
    for kb in (n_active, max(n_active // 2, 1)):
        before = tras.composite_pairs.bwd_compact_launches
        got = tras.composite_pairs_bwd(*args, fwd, state, gout, cfg, kb=kb)
        assert tras.composite_pairs.bwd_compact_launches == before + 1
        want = tras.composite_pairs_bwd_plain(
            *args, fwd, state, gout, cfg, kb=kb,
            block_chunk=_plain_chunks(cfg)[1])
        torch.cuda.synchronize()
        for r in range(10):
            scale = float(want[r].abs().max())
            assert float((got[r] - want[r]).abs().max()) <= 1e-5 * scale, r
        blk, _, _, valid = tras.composited_blocks(b.tile_start, off, kb, cfg)
        cols = (blk[valid, None] * G
                + torch.arange(G, device=cuda)).reshape(-1)
        kept = min(n_active, kb)
        assert torch.equal(got[:, :kept * G], full[:, cols])
        assert (got[:, kept * G:] == 0).all()


def test_kernels_refuse_other_ranges_naming_xla(cuda):
    """Tile 8 and pair blocks that are not multiples of 32 or exceed 512
    raise before any launch, naming backend='xla'."""
    for kw in (dict(tile=8), dict(pair_block=1024), dict(pair_block=48)):
        cfg = gt.RenderConfig(**CFG, **kw)
        ts = torch.zeros(cfg.num_tiles, dtype=torch.int32, device=cuda)
        pf = torch.zeros(10, cfg.padded_pairs, device=cuda)
        n = tras.composite_pairs.launches
        with pytest.raises(ValueError, match="backend='xla'"):
            tras.composite_pairs(pf, ts, ts, cfg)
        assert tras.composite_pairs.launches == n


def test_device_batches_on_card_match_host_batches(cuda, tmp_path):
    """``device_batches`` keeps the views on the card once (f32, or uint8
    dequantized after the gather) and yields the host batches' views in
    the same order."""
    from gsplat_tpu_torch.data.dataset import GaussianDataset

    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "images")
    for i in range(5):
        np.save(tmp_path / "images" / f"{i:03d}.npy",
                rng.integers(0, 256, (12, 16, 3), dtype=np.uint8))
    np.save(tmp_path / "cam_meta.npy", {"fx": 20.0, "fy": 20.0})
    np.save(tmp_path / "poses.npy",
            np.tile(np.eye(4, dtype=np.float32), (5, 1, 1)))
    ds = GaussianDataset(str(tmp_path), scale_factor=1.0)
    host = ds.batches(2, seed=3)
    dev_f = ds.device_batches(2, seed=3, device=cuda)
    dev_q = ds.device_batches(2, seed=3, device=cuda, quantize=True)
    for _ in range(4):
        h, f, q = next(host), next(dev_f), next(dev_q)
        assert f["image"].is_cuda and q["image"].dtype == torch.float32
        assert torch.equal(f["image"].cpu(), torch.from_numpy(h["image"]))
        assert float((q["image"].cpu() - torch.from_numpy(h["image"]))
                     .abs().max()) <= 1e-6
        assert torch.equal(f["c2w"].cpu(), torch.from_numpy(h["c2w"]))


# --- the ellipse cull and the (data, tile) grid (slice 11) -------------------

@pytest.mark.parametrize("kind", ["plain", "saturated", "bench1080p"])
def test_kernels_match_plain_on_ellipse_list(cuda, kind):
    """K1 and K2 on the ellipse cull's shorter pair list (fewer pairs a
    tile, shifted block boundaries), as on the rect list: elongated
    splats at 192x128, and the bench checkpoint at its 1080p bench pose."""
    if kind == "bench1080p":
        rect = gt.RenderConfig(**FULL)
        cfg = rect.with_(cull_mode="ellipse")
        pf, b = _full_inputs(kind, cfg, cuda)
        _, b_rect = _full_inputs(kind, rect, cuda)
    else:
        shift = dict(opacity_shift=6.0, scale_shift=1.0) \
            if kind == "saturated" else {}
        params, c2w = _scene(600, 0, **shift)
        params["scale_raw"][:, 0] += 1.6  # elongated: the ellipse culls
        rect = gt.RenderConfig(**CFG)
        cfg = rect.with_(cull_mode="ellipse")
        pf, b = _inputs(params, c2w, cfg, cuda)
        _, b_rect = _inputs(params, c2w, rect, cuda)
    assert 0 < int(b.num_pairs) < int(b_rect.num_pairs)
    assert int(b.num_pairs) <= cfg.max_pairs
    assert 0 < int(b.num_rows) <= cfg.row_capacity
    _check_fwd_bwd(cuda, pf, b, cfg, "launches", "bwd_launches")


def _band_rank(params, c2w):
    """One rank of a 2-rank band grid on the card: (rank 0's image, its
    K1 launches, which read the table by slot: no autograd records)."""
    from gsplat_tpu_torch.parallel import make_mesh, make_sharded_render

    mesh = make_mesh(tile=2)
    p = {k: torch.from_numpy(v).to(mesh.device) for k, v in params.items()}
    before = tras.composite_pairs.indexed_launches
    img = make_sharded_render(gt.RenderConfig(**CFG), mesh)(
        p, None, c2w, *CAM.values())
    torch.cuda.synchronize()
    return img.cpu().numpy(), tras.composite_pairs.indexed_launches - before


def test_band_render_of_two_gloo_ranks_on_card_matches_single_rank(cuda):
    """Two gloo ranks share the card, one band each: the gathered image
    within 1e-6 of the single-rank render (tests/test_sharding.py:90), one
    K1 launch a rank."""
    from gsplat_tpu_torch.parallel import launch

    params, c2w = _scene(600, 0)
    img, k1 = launch(_band_rank, 2, backend="gloo", args=(params, c2w))
    p = {k: torch.from_numpy(v).to(cuda) for k, v in params.items()}
    with torch.no_grad():
        want, _ = gt.render_from_params(p, c2w, *CAM.values(),
                                        gt.RenderConfig(**CFG))
    assert img.shape == (CFG["height"], CFG["width"], 3)
    assert float(np.abs(img - want.cpu().numpy()).max()) <= 1e-6
    assert k1 == 1


def _gauss_batch(params, alive, cfg, dev):
    """Two views of the scene with f_dc + 0.5 as ground truth."""
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[1, 0, 3] = 0.2
    target = {k: torch.from_numpy(v) for k, v in params.items()}
    target["f_dc"] = target["f_dc"] + 0.5
    with torch.no_grad():
        imgs = torch.stack([gt.render_from_params(
            target, p, *CAM.values(), cfg, alive=torch.from_numpy(alive))[0]
            for p in poses])
    batch = {"image": imgs.to(dev), "c2w": torch.from_numpy(poses).to(dev)}
    batch.update({k: torch.full((2,), v, device=dev)
                  for k, v in CAM.items()})
    return batch


def _gauss_rank(params, alive, ring):
    """One rank of a tile-2 grid on the card training the gaussian-sharded
    step: rank 0's (gathered parameters, loss, ring overflow, its K1 and
    K2 launches)."""
    from gsplat_tpu_torch.parallel import (gather_train_state,
                                           make_gauss_sharded_train_step,
                                           make_mesh, shard_train_state)

    mesh = make_mesh(tile=2)
    cfg = gt.RenderConfig(**CFG)
    tcfg = gt.TrainConfig(capacity=alive.shape[0], batch_size=2)
    state = shard_train_state(gt.init_train_state(
        gt.pool_from_numpy(params, alive, device=mesh.device), tcfg), mesh)
    batch = _gauss_batch(params, alive, cfg, mesh.device)
    k1, k2 = tras.composite_pairs.launches, tras.composite_pairs.bwd_launches
    state, m = make_gauss_sharded_train_step(
        cfg, tcfg, mesh, ring=ring,
        ring_capacity=512 if ring else None)(state, batch)
    torch.cuda.synchronize()
    k1 = tras.composite_pairs.launches - k1
    k2 = tras.composite_pairs.bwd_launches - k2
    whole = gather_train_state(state, mesh)
    return ({k: v.detach().cpu().numpy() for k, v in
             whole.pool.params.items()}, float(m["total"]),
            int(m["ring_overflow"]), k1, k2)


@pytest.mark.parametrize("ring", [False, True])
def test_gauss_sharded_step_of_two_gloo_ranks_on_card_matches_single_rank(
        cuda, ring):
    """Two gloo ranks share the card with the pool sharded over them (the
    ring's buffers 512 of the 640 slots): one step within JAX's bounds of
    the single-rank step (loss 1e-5, pos and f_dc 5e-6,
    tests/test_sharding.py:149-158), K1 and K2 launched per view."""
    from gsplat_tpu_torch.parallel import launch

    params, _ = _scene(600, 3)
    n = 640  # 40 dead slots
    params = {k: np.concatenate([v, np.zeros((n - 600,) + v.shape[1:],
                                             np.float32)])
              for k, v in params.items()}
    alive = np.arange(n) < 600
    got, loss, ovf, k1, k2 = launch(_gauss_rank, 2, backend="gloo",
                                    args=(params, alive, ring))
    cfg = gt.RenderConfig(**CFG)
    tcfg = gt.TrainConfig(capacity=n, batch_size=2)
    state = gt.init_train_state(gt.pool_from_numpy(params, alive,
                                                   device=cuda), tcfg)
    state, m = gt.make_train_step(cfg, tcfg)(
        state, _gauss_batch(params, alive, cfg, cuda))
    assert ovf == 0 and k1 == 2 and k2 == 2
    assert abs(loss - float(m["total"])) <= 1e-5
    for k in ("pos", "f_dc"):
        want = state.pool.params[k].detach().cpu().numpy()
        assert float(np.abs(got[k] - want).max()) <= 5e-6, k
