"""Port: the forward compositor's per-warp pair cull (ops/raster_cuda.py).

K1 (ops/csrc/raster_fwd.cu) lets each warp skip the pairs of a block that
cannot reach its 8x4 pixel patch. It stays equal to the plain compositor
bit for bit only if every (pair, warp) it skips has alpha == 0 at all 32
pixels of the warp. The kernel runs only on a card (tests/test_torch_gpu.py
holds its output and its skip count against the plain versions there); its
test, ``pair_warp_reach``, is plain PyTorch with the kernel's arithmetic,
and runs here:

* on scenes rendered through the port's stages on the CPU (``make_scene``
  seeds 0 and 3, a saturated scene, the trained checkpoint at the bench
  pose at 270x480), a block of padding and degenerate pairs, and pairs
  built to sit at the test's edges (long thin ellipses at every angle,
  opacities near the cutoff), no dropped (pair, warp) has a non-zero
  ``_block_alpha`` at any of its 32 pixels (exact: alpha is compared with
  0);
* the test drops a large share where the scene allows it (on the
  checkpoint more than 0.3), so a test that drops nothing cannot pass;
* on pair features the cull mostly drops, the plain compositor still
  matches the JAX package's Pallas forward kernel (interpret mode) within
  the 2e-5 of tests/test_torch_raster.py;
* the no-transc ablation's cull (``rational=True``: the threshold for its
  alpha ``op / (1 + q/2)``), on the same scenes and edge ellipses: no
  dropped (pair, warp) has a non-zero rational alpha, and it drops fewer
  than K1's test, whose threshold would drop live pairs of that alpha.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_scene

import gsplat_tpu.config as jconfig
import gsplat_tpu_torch as gt
import gsplat_tpu_torch.config as tconfig
from gsplat_tpu_torch.ops import raster_cuda as tras
from gsplat_tpu_torch.ops.binning import bin_gaussians
from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
from gsplat_tpu_torch.ops.projection import project_gaussians
from gsplat_tpu_torch.ops.rasterize import _pair_features, gather_pair_features
from gsplat_tpu_torch.ops.sh import evaluate_sh
from gsplat_tpu_torch.viewer import estimate_scene_center_radius, look_at
from test_torch_raster import (CFG, _check_against_jax, _jax_composite,
                               _jax_pairs, _saturated_scene)

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "bench_assets", "trained_ckpt.npz")
KEYS = ("pos", "scale_raw", "q_raw", "opacity_raw", "f_dc", "f_rest")


def _pairs(params, c2w, cfg, cam, alive=None):
    """The port's serving stages on the CPU, up to the pair features."""
    t = {k: torch.as_tensor(params[k]) for k in KEYS}
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    with torch.no_grad():
        cov = build_cov3d_packed(t["scale_raw"], t["q_raw"])
        colors = evaluate_sh(t["f_dc"], t["f_rest"], t["pos"], c2w)
        proj = project_gaussians(t["pos"], cov, t["opacity_raw"], c2w, *cam,
                                 cfg, extra_valid=alive)
        b = bin_gaussians(proj, cfg)
        feat = _pair_features(proj, colors, torch.float32)[
            b.depth_order.long()]
        return gather_pair_features(feat, b.pair_slot, b.gauss_offsets), b


def _all_blocks(tile_start, tile_count, cfg):
    """(block, tile) of every block that holds a tile's pairs."""
    G = cfg.pair_block
    nblk = (tile_count.long() + G - 1) // G
    tile = torch.repeat_interleave(torch.arange(nblk.shape[0]), nblk)
    first = torch.cumsum(nblk, 0) - nblk
    rank = torch.arange(tile.shape[0]) - first[tile]
    return tile_start.long()[tile] // G + rank, tile


def _check_blocks(pair_feat, blocks, tiles, cfg, chunk=64, rational=False):
    """Every (pair, warp) pair_warp_reach drops has alpha == 0 at all 32 of
    the warp's pixels (``rational``: the no-transc ablation's test and
    alpha). Returns the share of (pair, warp) dropped."""
    n = tras.cull_audit(pair_feat, blocks, tiles, cfg, chunk=chunk,
                        rational=rational)
    assert n["unsafe"] == 0, "a dropped (pair, warp) has a non-zero alpha"
    assert n["total"] > 0
    return n["skipped"] / n["total"]


@pytest.mark.parametrize("kind", ["seed0", "seed3", "saturated"])
def test_cull_is_conservative_on_scenes(kind):
    scene = _saturated_scene() if kind == "saturated" else \
        make_scene(None, n=600, seed_offset=int(kind[-1]))
    cfg = gt.RenderConfig(height=128, width=192, max_pairs=2**15)
    pf, b = _pairs(scene, scene["c2w"], cfg, (160.0, 158.0, 96.5, 63.5))
    blocks, tiles = _all_blocks(b.tile_start, b.tile_count, cfg)
    share = _check_blocks(pf, blocks, tiles, cfg)
    assert share > 0.1, share


def test_cull_is_conservative_on_checkpoint_bench_pose():
    """The trained checkpoint from the bench pose (camera at centre + (0,
    -0.6R, -4.4R)) at 270x480, on the blocks the plain compositor
    composites: the kernel's work."""
    pool = gt.restore_pool(CKPT, device="cpu")
    alive = pool.alive
    params = {k: v.detach() for k, v in pool.params.items()}
    center, radius = estimate_scene_center_radius(
        positions=params["pos"].numpy()[alive.numpy()])
    c2w = look_at(center + np.array([0.0, -0.6 * radius, -4.4 * radius]),
                  center)
    H, W = 270, 480
    cfg = gt.RenderConfig(height=H, width=W, max_pairs=2**20)
    f = 0.85 * W
    pf, b = _pairs(params, c2w, cfg, (f, f, W / 2.0, H / 2.0), alive=alive)
    out = tras.composite_pairs_plain(pf, b.tile_start, b.tile_count, cfg)
    blocks, tiles, _ = tras.active_blocks(
        b.tile_start, tras.tile_block_offsets(out), cfg)
    assert blocks.shape[0] > 100
    share = _check_blocks(pf, blocks, tiles, cfg)
    assert share > 0.3, share


def test_cull_edge_cases():
    """One block of 32 pairs in tile 0 of a 32x16 image: the cases the
    test must skip everywhere, never skip, or skip exactly."""
    cfg = gt.RenderConfig(height=16, width=32, max_pairs=64, pair_block=32)
    f = np.zeros((10, 1, 32), np.float32)  # pair 0: a padding slot
    far = [1000.0, 1000.0, 1.0, 0.0, 1.0, 0.9, 0.5, 0.5, 0.5, 3.0]
    for j in range(1, 32):
        f[:, 0, j] = far  # a small splat far away: skipped everywhere
    f[:, 0, 1] = [1000, 1000, 1, 1, 1, 0.9, 0.5, 0.5, 0.5, 3]  # det 0
    f[:, 0, 2] = [1000, 1000, -1, 0, 1, 0.9, 0.5, 0.5, 0.5, 3]  # a < 0
    f[:, 0, 3] = [np.nan, 4, 1, 0, 1, 0.9, 0.5, 0.5, 0.5, 3]  # NaN centre
    f[:, 0, 4] = [1000, 1000, 1, 0, 1, 0.9, np.inf, 0.5, 0.5, 3]  # inf rgb
    f[:, 0, 5] = [4, 2, 1, 0, 1, 0.0, 0.5, 0.5, 0.5, 3]  # opacity 0
    f[:, 0, 6] = [4, 2, 1, 0, 1, -0.5, 0.5, 0.5, 0.5, 3]  # opacity < 0
    f[:, 0, 7] = [4, 2, 1, 0, 1, 0.5 / 128, 0.5, 0.5, 0.5, 3]  # < cutoff
    f[:, 0, 8] = [3.5, 1.5, 4, 0, 4, 0.9, 0.5, 0.5, 0.5, 3]  # in warp 0
    f[:, 0, 9] = [1000, 1000, 1, 0.99999, 1, 0.9, 0.5, 0.5, 0.5, 3]  # thin
    f[:, 0, 10] = [1000, 1000, 1, 0, 1, np.inf, 0.5, 0.5, 0.5, 3]  # inf op
    f[:, 0, 11] = [3.5, 1.5, 1e-3, 0, 1e-3, 0.9, 0.5, 0.5, 0.5, 3]  # wide
    f = torch.from_numpy(f)
    tiles = torch.zeros(1, dtype=torch.int64)
    reach = tras.pair_warp_reach(f, tiles, cfg)[0]  # [32, 8]
    never = [1, 2, 3, 4, 9, 10, 11]
    everywhere = [0, 5, 6, 7] + list(range(12, 32))
    assert reach[never].all()
    assert not reach[everywhere].any()
    assert reach[8].tolist() == [True] + [False] * 7
    # Conservative on these too, and with no cutoff nothing is skipped.
    _check_blocks(f.reshape(10, 32), torch.zeros(1, dtype=torch.int64),
                  tiles, cfg)
    assert tras.pair_warp_reach(f, tiles, cfg.with_(alpha_cutoff=0.0)).all()


def test_cull_is_conservative_at_its_edges():
    """Long thin ellipses at every angle (axis ratios to 1500:1, kappa
    below 1e-5 at the thinnest), centres in and around the tile, opacities
    log-uniform from half the cutoff to 1 and within 1e-5 of it: the cases
    where rounding would bite if the margins were short."""
    cfg = gt.RenderConfig(height=16, width=16, max_pairs=2**13)
    G, m = cfg.pair_block, 48
    r = np.random.default_rng(7)
    n = m * G
    th = r.uniform(0, np.pi, n)
    s1 = np.exp(r.uniform(np.log(0.5), np.log(300.0), n))
    s2 = np.exp(r.uniform(np.log(0.2), np.log(3.0), n))
    c, s = np.cos(th), np.sin(th)
    cxx = c * c * s1**2 + s * s * s2**2
    cyy = s * s * s1**2 + c * c * s2**2
    cxy = c * s * (s1**2 - s2**2)
    det = cxx * cyy - cxy**2
    op = np.exp(r.uniform(np.log(0.5 / 128), 0.0, n))
    op[::5] = (1.0 / 128) * (1.0 + r.uniform(-1e-5, 1e-5, op[::5].shape))
    feat = np.stack([
        r.uniform(-12, 28, n), r.uniform(-12, 28, n),
        cyy / det, -cxy / det, cxx / det, op,
        r.uniform(0, 1, n), r.uniform(0, 1, n), r.uniform(0, 1, n),
        r.uniform(1, 9, n)]).astype(np.float32)
    pf = torch.from_numpy(feat)
    blocks = torch.arange(m)
    share = _check_blocks(pf, blocks, torch.zeros(m, dtype=torch.int64),
                          cfg, chunk=m)
    assert share > 0.3, share


def test_plain_compositor_matches_jax_where_the_cull_drops_most():
    """A scene's pair layout with every conic scaled by 16 (splats 4x
    smaller): most (pair, warp) are dropped, and the plain compositor
    still matches the JAX package's Pallas forward (interpret mode)."""
    scene = make_scene(None, n=192, seed_offset=0)
    pair_feat, b = _jax_pairs(*(jnp.asarray(scene[k]) for k in
                                KEYS + ("c2w",)))
    pf = np.array(pair_feat)
    pf[2:5] *= 16.0  # padding slots stay all-zero
    want = np.asarray(_jax_composite(jnp.asarray(pf), b.block_meta,
                                     jconfig.RenderConfig(**CFG)))
    cfg = tconfig.RenderConfig(**CFG)
    pf_t = torch.from_numpy(pf)
    ts = torch.from_numpy(np.array(b.tile_start))
    tc = torch.from_numpy(np.array(b.tile_count))
    got = tras.composite_pairs_plain(pf_t, ts, tc, cfg)
    _check_against_jax(got, want, tc)
    blocks, tiles = _all_blocks(ts, tc, cfg)
    assert _check_blocks(pf_t, blocks, tiles, cfg) > 0.5


@pytest.mark.parametrize("pair_block", [128, 512])
@pytest.mark.parametrize("kind", ["seed0", "saturated"])
def test_cull_is_conservative_at_tile_32(kind, pair_block):
    """At tile 32 K1 runs 32 warps of 8x4 pixels, four across: the warp
    patches tile the tile exactly once, and no (pair, warp) the test drops
    has a non-zero alpha."""
    cfg = gt.RenderConfig(height=128, width=192, max_pairs=2**15, tile=32,
                          pair_block=pair_block)
    pix = tras.warp_pixels(cfg)
    assert tuple(pix.shape) == (tras.kernel_warps(32), 32) == (32, 32)
    assert torch.equal(pix.reshape(-1).sort().values, torch.arange(1024))
    scene = _saturated_scene() if kind == "saturated" else \
        make_scene(None, n=600, seed_offset=0)
    pf, b = _pairs(scene, scene["c2w"], cfg, (160.0, 158.0, 96.5, 63.5))
    blocks, tiles = _all_blocks(b.tile_start, b.tile_count, cfg)
    share = _check_blocks(pf, blocks, tiles, cfg)
    assert share > 0.1, share


@pytest.mark.parametrize("kind", ["seed0", "saturated", "edges"])
def test_rational_cull_is_conservative(kind):
    """The no-transc ablation's cull: exact zeros of its own alpha where it
    drops, and no more drops than K1's test (1 / (1 + q/2) >= exp(-q/2),
    so K1's threshold would drop live (pair, warp) of this alpha); fewer
    where opacities do not put both reaches at ``chi2_clip``."""
    if kind == "edges":
        cfg = gt.RenderConfig(height=16, width=16, max_pairs=2**13)
        r = np.random.default_rng(11)
        n = 16 * cfg.pair_block
        th = r.uniform(0, np.pi, n)
        s1 = np.exp(r.uniform(np.log(0.5), np.log(300.0), n))
        s2 = np.exp(r.uniform(np.log(0.2), np.log(3.0), n))
        c, s = np.cos(th), np.sin(th)
        cxx = c * c * s1**2 + s * s * s2**2
        cyy = s * s * s1**2 + c * c * s2**2
        cxy = c * s * (s1**2 - s2**2)
        det = cxx * cyy - cxy**2
        op = np.exp(r.uniform(np.log(0.5 / 128), 0.0, n))
        op[::5] = (1.0 / 128) * (1.0 + r.uniform(-1e-5, 1e-5, op[::5].shape))
        pf = torch.from_numpy(np.stack([
            r.uniform(-12, 28, n), r.uniform(-12, 28, n),
            cyy / det, -cxy / det, cxx / det, op,
            r.uniform(0, 1, n), r.uniform(0, 1, n), r.uniform(0, 1, n),
            r.uniform(1, 9, n)]).astype(np.float32))
        blocks = torch.arange(16)
        tiles = torch.zeros(16, dtype=torch.int64)
    else:
        scene = _saturated_scene() if kind == "saturated" else \
            make_scene(None, n=600, seed_offset=0)
        cfg = gt.RenderConfig(height=128, width=192, max_pairs=2**15)
        pf, b = _pairs(scene, scene["c2w"], cfg, (160.0, 158.0, 96.5, 63.5))
        blocks, tiles = _all_blocks(b.tile_start, b.tile_count, cfg)
    share = _check_blocks(pf, blocks, tiles, cfg, rational=True)
    k1 = _check_blocks(pf, blocks, tiles, cfg)
    assert 0.05 < share <= k1, (share, k1)
    if kind != "saturated":  # there opacity puts both reaches at chi2_clip
        assert share < k1, (share, k1)
