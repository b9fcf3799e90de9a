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

The eight K3 kernels of the profiler vs their plain versions: rows 0-4
within 2e-5 abs, row 5 exact, rows 6-7 zero (built and ordered alike).
cumprod, pg-roll and pg-log compute the forward compositor's function, so
they are also held against its plain version within the same 2e-5 (their
T is rounded in another association).
"""

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch.ops import raster_ablate as tabl
from gsplat_tpu_torch.ops import raster_cuda as tras
from gsplat_tpu_torch.ops.binning import bin_gaussians
from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
from gsplat_tpu_torch.ops.projection import project_gaussians
from gsplat_tpu_torch.ops.rasterize import _pair_features, gather_pair_features
from gsplat_tpu_torch.ops.sh import evaluate_sh
from gsplat_tpu_torch.profile_kernel import make_workload

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


@pytest.mark.parametrize("pair_block", [32, 128, 256])
@pytest.mark.parametrize("kind", ["plain", "saturated"])
def test_kernel_matches_plain(cuda, kind, pair_block):
    shift = dict(opacity_shift=6.0, scale_shift=1.0) if kind == "saturated" \
        else {}
    params, c2w = _scene(600, 0, **shift)
    cfg = gt.RenderConfig(**CFG, pair_block=pair_block)
    pf, b = _inputs(params, c2w, cfg, cuda)
    before = tras.composite_pairs.launches
    got = tras.composite_pairs(pf, b.tile_start, b.tile_count, cfg)
    assert tras.composite_pairs.launches == before + 1
    want = tras.composite_pairs_plain(pf, b.tile_start, b.tile_count, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :6], want[:, :6])
    assert (got[:, 6:] == 0).all()
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
    before = getattr(tras.composite_pairs, counter)
    fwd, state = tras._composite_fwd(*args, cfg, with_state=True)
    assert getattr(tras.composite_pairs, counter) == before + 1
    want, want_state = tras.composite_pairs_plain(*args, cfg,
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
    want_d = tras.composite_pairs_bwd_plain(*args, fwd, state, gout, cfg)
    again = tras.composite_pairs_bwd(*args, fwd, state, gout, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, again), "two runs differ"
    for r in range(10):
        scale = float(want_d[r].abs().max())
        assert float((got[r] - want_d[r]).abs().max()) <= 1e-5 * scale, r
    assert (got[:, ~active] == 0).all()
    return fwd


@pytest.mark.parametrize("pair_block", [32, 128])
@pytest.mark.parametrize("kind", ["plain", "saturated"])
def test_log_kernels_match_plain(cuda, kind, pair_block):
    """transmittance_math="log": K1 bit for bit with its plain version, its
    cull's count equal to the plain test's; K2 from K1's state."""
    shift = dict(opacity_shift=6.0, scale_shift=1.0) if kind == "saturated" \
        else {}
    params, c2w = _scene(600, 0, **shift)
    cfg = gt.RenderConfig(**CFG, pair_block=pair_block,
                          transmittance_math="log")
    pf, b = _inputs(params, c2w, cfg, cuda)
    fwd = _check_fwd_bwd(cuda, pf, b, cfg, "log_launches",
                         "bwd_log_launches")
    skipped = torch.zeros(1, dtype=torch.int64, device=cuda)
    tras._launch_fwd(pf, b.tile_start, b.tile_count, cfg, skipped=skipped)
    blk, tile, _ = tras.active_blocks(b.tile_start,
                                      tras.tile_block_offsets(fwd), cfg)
    n = tras.cull_audit(pf, blk, tile, cfg)
    torch.cuda.synchronize()
    assert n["unsafe"] == 0 and int(skipped.item()) == n["skipped"] > 0
    # The colour rows against the cumprod kernel's: the JAX package's 2e-6
    # gate between its two modes, held on the image.
    cum = tras.composite_pairs(pf, b.tile_start, b.tile_count,
                               cfg.with_(transmittance_math="cumprod"))
    assert float((cum[:, 0:3] - fwd[:, 0:3]).abs().max()) <= 2e-6
    if kind == "saturated":
        nblk = (b.tile_count + pair_block - 1) // pair_block
        assert (fwd[:, 5, 0] < nblk).any(), "no tile was skipped"


@pytest.mark.parametrize("trunc_pairs", [0, 10 * 32])
def test_truncated_kernels_match_plain(cuda, trunc_pairs):
    """A rank-truncated list (tile_rank_cap 64, the occlusion cull on), and
    one whose capacity overflows (trunc_pairs 320, where one tile's second
    block lies past the end): the forward stops at the list's end as its
    plain version does, the backward follows it."""
    params, c2w = _dense_scene()
    cfg = gt.RenderConfig(**CFG, pair_block=32, tile_rank_cap=64,
                          trunc_pairs=trunc_pairs)
    pf, b = _inputs(params, c2w, cfg, cuda)
    assert pf.shape[1] == cfg.trunc_padded_pairs
    assert int(b.num_pairs_kept) < int(b.num_pairs)
    overflow = int(b.trunc_demand) > cfg.trunc_padded_pairs
    assert overflow == bool(trunc_pairs)
    fwd = _check_fwd_bwd(cuda, pf, b, cfg, "launches", "bwd_launches")
    nblk = (b.tile_count.long() + 31) // 32
    walked = (b.tile_start.long() + nblk * 32 <= pf.shape[1]) | (nblk == 0)
    # Overflow: some tile's blocks run past the end and it stops there.
    assert bool((~walked).any()) == overflow
    assert torch.isfinite(fwd).all()


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


@pytest.mark.parametrize("math", ["cumprod", "log"])
def test_wrapped_rows_kernels_match_plain(cuda, math):
    """Batched views (view_tile_rows > 0): K1 bit for bit with its plain
    version and its cull's count equal to the plain test's under the row
    wrap; K2 from K1's state within 1e-5."""
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


@pytest.mark.parametrize("pair_block", [32, 128, 256])
@pytest.mark.parametrize("kind", ["plain", "saturated"])
def test_forward_kernel_state_matches_plain(cuda, kind, pair_block):
    shift = dict(opacity_shift=6.0, scale_shift=1.0) if kind == "saturated" \
        else {}
    params, c2w = _scene(600, 0, **shift)
    cfg = gt.RenderConfig(**CFG, pair_block=pair_block)
    pf, b = _inputs(params, c2w, cfg, cuda)
    args = (pf, b.tile_start, b.tile_count, cfg)
    bare = tras._composite_fwd(*args)
    out, state = tras._composite_fwd(*args, with_state=True)
    _, want = tras.composite_pairs_plain(*args, with_state=True)
    torch.cuda.synchronize()
    assert torch.equal(out, bare)
    active = _active_slots(b, out, cfg)[::pair_block]
    assert active.any()
    assert torch.equal(state[active], want[active])


@pytest.mark.parametrize("pair_block", [32, 128, 256])
@pytest.mark.parametrize("kind", ["plain", "saturated"])
def test_backward_kernel_matches_plain(cuda, kind, pair_block):
    shift = dict(opacity_shift=6.0, scale_shift=1.0) if kind == "saturated" \
        else {}
    params, c2w = _scene(600, 0, **shift)
    cfg = gt.RenderConfig(**CFG, pair_block=pair_block)
    pf, b = _inputs(params, c2w, cfg, cuda)
    args = (pf, b.tile_start, b.tile_count)
    fwd, state = tras._composite_fwd(*args, cfg, with_state=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    gout = torch.randn(cfg.num_tiles, 8, cfg.tile**2, generator=gen,
                       device=cuda)
    before = tras.composite_pairs.bwd_launches
    got = tras.composite_pairs_bwd(*args, fwd, state, gout, cfg)
    assert tras.composite_pairs.bwd_launches == before + 1
    want = tras.composite_pairs_bwd_plain(*args, fwd, state, gout, cfg)
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


@pytest.mark.parametrize("opacity", [0.05, 0.9])
@pytest.mark.parametrize("variant", list(tabl.VARIANTS))
def test_ablation_kernel_matches_plain(cuda, variant, opacity):
    """The profiler's workload at 192x128; at opacity 0.9 every variant
    with the skip rule (all but empty, no-compute and no-input, whose
    features ignore the opacity) skips continuation blocks."""
    cfg = gt.RenderConfig(**CFG)
    pf, ts, tc = (t.to(cuda) for t in make_workload(cfg, 4))
    pf[5] = opacity
    before = tabl.ablate.launches[variant]
    got = tabl.ablate(variant, pf, ts, tc, cfg)
    assert tabl.ablate.launches[variant] == before + 1
    want = tabl.ablate_plain(variant, pf, ts, tc, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got[:, :5] - want[:, :5]).abs().max()) <= TOL
    assert torch.equal(got[:, 5], want[:, 5])
    assert (got[:, 6:] == 0).all()
    if opacity > 0.5 and variant not in ("empty", "no-compute", "no-input"):
        assert (got[:, 5, 0] < 4).any(), "no tile was skipped"
    if variant in tabl.K1_FUNCTION:
        k1 = tras.composite_pairs_plain(pf, ts, tc, cfg)
        assert float((got[:, :5] - k1[:, :5]).abs().max()) <= TOL
        assert torch.equal(got[:, 5], k1[:, 5])


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
