"""Port parity: the forward compositor (ops/raster_cuda.py).

The plain PyTorch compositor is held against the JAX package's
``composite_pairs`` (its Pallas forward kernel, run in interpret mode on
the CPU as tests/test_pallas_kernel.py runs it) on the SAME pair features,
block metadata and tile ranges, carried across as numpy.

Tolerance: rows 0-4 within 2e-5 abs on occupied tiles (the JAX kernel
builds T with a grouped product and sums with a dot, the port with
sequential products and sums: a few ulp apart, as the JAX package's own
kernel-vs-XLA test allows); row 5 (blocks composited) exactly. Tiles with
no pair are not written by the JAX kernel, so only occupied tiles are
compared there.

The CUDA kernel itself runs only on a card: tests/test_torch_gpu.py holds
it against this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_scene

import gsplat_tpu.config as jconfig
import gsplat_tpu_torch.config as tconfig
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.ops import gaussian as jgau
from gsplat_tpu.ops import projection as jproj
from gsplat_tpu.ops import raster_pallas as jras
from gsplat_tpu.ops import sh as jsh
from gsplat_tpu.ops.rasterize import _pair_features, gather_pair_features
from gsplat_tpu_torch.ops import _build
from gsplat_tpu_torch.ops import raster_cuda as tras

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

CFG = dict(height=64, width=64, max_pairs=4096, pair_block=32)
CAM = (60.0, 58.0, 32.5, 31.5)
TOL = 2e-5


@jax.jit
def _jax_pairs(pos, scale_raw, q_raw, opacity_raw, f_dc, f_rest, c2w):
    cfg = jconfig.RenderConfig(**CFG)
    cov = jgau.build_cov3d_packed(scale_raw, q_raw)
    colors = jsh.evaluate_sh(f_dc, f_rest, pos, c2w)
    proj = jproj.project_gaussians(pos, cov, opacity_raw, c2w, *CAM, cfg)
    b = jbin.bin_gaussians(proj, cfg)
    feat10 = _pair_features(proj, colors, jnp.float32)[b.depth_order]
    pf10 = gather_pair_features(cfg.max_pairs, False, 0, feat10,
                                b.pair_slot, b.gauss_offsets)
    pair_feat = jnp.concatenate(
        [pf10, jnp.zeros((jras.FEAT_WIDTH - 10, pf10.shape[1]))], axis=0)
    return pair_feat, b


_jax_composite = jax.jit(jras.composite_pairs, static_argnums=(2,))


def _case(scene):
    keys = ("pos", "scale_raw", "q_raw", "opacity_raw", "f_dc", "f_rest",
            "c2w")
    pair_feat, b = _jax_pairs(*(jnp.asarray(scene[k]) for k in keys))
    want = np.asarray(_jax_composite(pair_feat, b.block_meta,
                                     jconfig.RenderConfig(**CFG)))
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         (("pair_feat", pair_feat), ("tile_start", b.tile_start),
          ("tile_count", b.tile_count))}
    return t, want


def _check_against_jax(got, want, tile_count):
    occ = tile_count.numpy() > 0
    assert occ.any()
    err = np.abs(got.numpy()[occ, 0:5] - want[occ, 0:5]).max()
    assert err <= TOL, f"rows 0-4 max abs {err}"
    np.testing.assert_array_equal(got.numpy()[occ, 5], want[occ, 5])
    # Unoccupied tiles: defined here (JAX leaves them unwritten).
    g = got.numpy()[~occ]
    assert (g[:, [0, 1, 2, 3, 5, 6, 7]] == 0).all() and (g[:, 4] == 1).all()


def _saturated_scene():
    s = make_scene(None, n=256, seed_offset=2)
    s["opacity_raw"] = s["opacity_raw"] + 6.0  # near-opaque
    s["scale_raw"] = s["scale_raw"] + 1.0  # large splats
    return s


@pytest.mark.parametrize("seed", [0, 3])
def test_plain_compositor_matches_jax_kernel(seed):
    t, want = _case(make_scene(None, n=192, seed_offset=seed))
    cfg = tconfig.RenderConfig(**CFG)
    launches = tras.composite_pairs.launches
    got = tras.composite_pairs(t["pair_feat"], t["tile_start"],
                               t["tile_count"], cfg)
    assert tras.composite_pairs.launches == launches  # CPU: plain version
    _check_against_jax(got, want, t["tile_count"])
    # Only rows 0-9 are read; chunking over tiles changes nothing.
    chunked = tras.composite_pairs_plain(
        t["pair_feat"][:10].contiguous(), t["tile_start"], t["tile_count"],
        cfg, tile_chunk=5)
    assert torch.equal(chunked, got)


def test_plain_compositor_saturation_skip_matches_jax_kernel():
    """Opaque splats saturate tiles: continuation blocks are skipped
    block-granularly, and row 5 counts only the composited blocks."""
    t, want = _case(_saturated_scene())
    cfg = tconfig.RenderConfig(**CFG)
    got = tras.composite_pairs(t["pair_feat"], t["tile_start"],
                               t["tile_count"], cfg)
    _check_against_jax(got, want, t["tile_count"])
    nblk = (t["tile_count"] + cfg.pair_block - 1) // cfg.pair_block
    assert (got[:, 5, 0] < nblk).any(), "no tile was skipped"
    assert float(got[:, 4].min()) <= cfg.transmittance_min


def test_pack_block_meta_matches():
    r = np.random.default_rng(0)
    tile = r.integers(0, 8160, 1000).astype(np.int32)
    first = r.integers(-1, 2, 1000).astype(np.int32)
    got = tras.pack_block_meta(torch.from_numpy(tile), torch.from_numpy(first))
    want = jras.pack_block_meta(jnp.asarray(tile), jnp.asarray(first))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_rejects_bad_inputs():
    cfg = tconfig.RenderConfig(**CFG)
    nt, npairs = cfg.num_tiles, cfg.padded_pairs
    pf = torch.zeros(10, npairs)
    ts = torch.zeros(nt, dtype=torch.int32)
    tc = torch.zeros(nt, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        tras.composite_pairs(pf.double(), ts, tc, cfg)
    with pytest.raises(ValueError, match="float32"):
        tras.composite_pairs(pf[:9], ts, tc, cfg)
    with pytest.raises(ValueError, match="int32"):
        tras.composite_pairs(pf, ts.long(), tc, cfg)
    with pytest.raises(ValueError, match="tile_count"):
        tras.composite_pairs(pf, ts, tc[:-1], cfg)
    with pytest.raises(ValueError, match="multiple of pair_block"):
        tras.composite_pairs(pf[:, :-1], ts, tc, cfg)
    with pytest.raises(ValueError, match="transmittance_math"):
        tras.composite_pairs(pf, ts, tc, cfg.with_(transmittance_math="exp"))
    # view_tile_rows (batched views) is ported (test_torch_batched.py): a
    # negative one is refused, and one that wraps no row changes no bit.
    with pytest.raises(ValueError, match="view_tile_rows"):
        tras.composite_pairs(pf, ts, tc, cfg.with_(view_tile_rows=-1))
    t, _ = _case(make_scene(None, n=192, seed_offset=0))
    args = (t["pair_feat"], t["tile_start"], t["tile_count"])
    assert torch.equal(
        tras.composite_pairs(*args, cfg.with_(view_tile_rows=cfg.tiles_y)),
        tras.composite_pairs(*args, cfg))
    for mode in ("cumprod", "log"):  # empty scene
        out = tras.composite_pairs(pf, ts, tc,
                                   cfg.with_(transmittance_math=mode))
        assert (out[:, 4] == 1).all() and (out[:, [0, 1, 2, 3, 5]] == 0).all()


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
