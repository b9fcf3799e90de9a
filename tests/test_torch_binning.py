"""Port parity: tile binning is bit-identical to the JAX package.

Both binnings get the SAME ProjectedGaussians (the JAX projection's
output, carried across as numpy), so float rounding cannot move an
integer. Every TileBinning field must then be equal exactly: pair_slot,
tile_start, tile_count, block_meta (dead blocks included), num_pairs
(the true demand, also on overflow), depth_order and gauss_offsets.
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
from gsplat_tpu_torch.ops import binning as tbin
from gsplat_tpu_torch.ops import projection as tproj

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

CAM = (60.0, 58.0, 32.5, 31.5)
# One XLA compile per shape instead of one per eager op (test time).
_jit_project = jax.jit(jproj.project_gaussians, static_argnums=(8,))
_jit_bin = jax.jit(jbin.bin_gaussians, static_argnums=(1,))
FIELDS = ("pair_slot", "tile_start", "tile_count", "block_meta", "num_pairs",
          "depth_order", "gauss_offsets", "num_rows", "num_pairs_kept",
          "trunc_demand")


def _jax_projection(s, kw, extra_valid=None):
    cov = jgau.build_cov3d_packed(jnp.asarray(s["scale_raw"]),
                                  jnp.asarray(s["q_raw"]))
    return _jit_project(
        jnp.asarray(s["pos"]), cov, jnp.asarray(s["opacity_raw"]),
        jnp.asarray(s["c2w"]), *CAM, jconfig.RenderConfig(**kw),
        None if extra_valid is None else jnp.asarray(extra_valid))


def _to_torch(proj_j):
    return tproj.ProjectedGaussians(
        *(torch.from_numpy(np.array(a)) for a in proj_j))


def _check(proj_j, kw):
    want = _jit_bin(proj_j, jconfig.RenderConfig(**kw))
    got = tbin.bin_gaussians(_to_torch(proj_j), tconfig.RenderConfig(**kw))
    for f in FIELDS:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == torch.int32, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    return got


CFG = dict(height=64, width=64, max_pairs=4096, pair_block=32)


@pytest.mark.parametrize("seed", [0, 3])
def test_binning_bit_identical(seed):
    s = make_scene(None, n=256, seed_offset=seed)
    got = _check(_jax_projection(s, CFG), CFG)
    meta = got.block_meta.numpy()
    assert (meta & 2).any() and (meta & 1).any()  # dead and first blocks


def test_binning_bit_identical_wide_blocks_ties_and_dead_slots():
    """pair_block 128 on a non-square odd-sized image; duplicated
    gaussians (equal depths, so the stable order decides) and dead slots."""
    s = make_scene(None, n=200, seed_offset=5)
    for k in ("pos", "scale_raw", "q_raw", "opacity_raw", "f_dc", "f_rest"):
        s[k] = np.concatenate([s[k], s[k][:60]])
    alive = np.ones(260, bool)
    alive[::7] = False
    kw = dict(height=72, width=100, max_pairs=8192)
    _check(_jax_projection(s, kw, extra_valid=alive), kw)


def test_binning_overflow_drops_back_gaussians():
    """Tiny capacity: whole gaussians drop from the back of the depth
    order and num_pairs still reports the true demand."""
    s = make_scene(None, n=256, seed_offset=1)
    kw = dict(CFG, max_pairs=100)
    got = _check(_jax_projection(s, kw), kw)
    assert int(got.num_pairs) > 100
    assert int(got.gauss_offsets[-1]) <= 100
    assert int(got.tile_count.sum()) == int(got.gauss_offsets[-1])


def test_binning_all_culled():
    s = make_scene(None, n=64, seed_offset=4)
    s["opacity_raw"] = s["opacity_raw"] - 50.0
    got = _check(_jax_projection(s, CFG), CFG)
    assert int(got.num_pairs) == 0
    assert (got.pair_slot == -1).all()
    assert ((got.block_meta.numpy() & 3) == 2).all()  # every block dead


def test_depth_order_stable():
    depth = np.array([3.0, 1.0, 3.0, np.inf, 1.0, 2.0, 3.0], np.float32)
    valid = np.array([1, 1, 1, 1, 1, 0, 1], bool)
    got = tbin.depth_order(torch.from_numpy(depth), torch.from_numpy(valid))
    want = jbin.depth_order(jnp.asarray(depth), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [1, 4, 0, 2, 6, 3, 5])


@pytest.mark.parametrize("kw,match", [
    (dict(cull_mode="ellipse"), "ellipse"),
    # Truncation is ported; with the ellipse cull it still raises.
    pytest.param(dict(tile_rank_cap=64, cull_mode="ellipse"), "ellipse",
                 id="kw1-tile_rank_cap"),
])
def test_unported_binning_modes_raise(kw, match):
    s = make_scene(None, n=32, seed_offset=0)
    proj = _to_torch(_jax_projection(s, CFG))
    with pytest.raises(NotImplementedError, match=match):
        tbin.bin_gaussians(proj, tconfig.RenderConfig(**CFG, **kw))
