"""Port parity: tile binning is bit-identical to the JAX package.

Both binnings get the SAME ProjectedGaussians (the JAX projection's
output, carried across as numpy), so float rounding cannot move an
integer. Every TileBinning field must then be equal exactly: pair_slot,
tile_start, tile_count, block_meta (dead blocks included), num_pairs
(the true demand, also on overflow), depth_order and gauss_offsets.
"""

import importlib

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

jrender = importlib.import_module("gsplat_tpu.render")  # the package's
# ``render`` attribute is a function

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
    # The ellipse cull is ported (test_torch_ellipse.py), with and without
    # truncation: both cases now hold its binning to JAX's, every field
    # equal; an unknown cull_mode raises.
    (dict(cull_mode="ellipse"), "ellipse"),
    pytest.param(dict(tile_rank_cap=64, cull_mode="ellipse"), "ellipse",
                 id="kw1-tile_rank_cap"),
])
def test_unported_binning_modes_raise(kw, match):
    s = make_scene(None, n=32, seed_offset=0)
    cfg = dict(CFG, **kw)
    got = _check(_jax_projection(s, cfg), cfg)
    assert int(got.num_rows) > 0
    proj = _to_torch(_jax_projection(s, CFG))
    with pytest.raises(ValueError, match="cull_mode"):
        tbin.bin_gaussians(proj, tconfig.RenderConfig(
            **dict(cfg, cull_mode=match + "x")))


# --- the three plain steps (emit, tile sort, align) against JAX -------------

def _jax_batched(s, kw, views=3):
    """Three views' projections stacked into one scene by JAX's
    ``stack_view_projections``: (stacked projection, the batch's config
    as keyword arguments, view_tile_rows > 0)."""
    jcfg = jconfig.RenderConfig(**kw)
    cov = jgau.build_cov3d_packed(jnp.asarray(s["scale_raw"]),
                                  jnp.asarray(s["q_raw"]))
    projs = []
    for v in range(views):
        c2w = np.array(s["c2w"])
        c2w[:3, 3] += np.array([0.3 * v - 0.3, 0.1 * v, 0.0], np.float32)
        projs.append(_jit_project(
            jnp.asarray(s["pos"]), cov, jnp.asarray(s["opacity_raw"]),
            jnp.asarray(c2w), *CAM, jcfg, None))
    proj_b = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *projs)
    stacked, bcfg = jrender.stack_view_projections(proj_b, jcfg)
    return stacked, {f: getattr(bcfg, f)
                     for f in tconfig.RenderConfig.__dataclass_fields__}


def _steps_spy(monkeypatch):
    """Count the calls of the three plain steps inside bin_gaussians."""
    calls = {"emit": 0, "sort": 0, "align": 0}
    for step, name in (("emit", "emit_pairs_plain"),
                       ("sort", "sort_pairs_plain"),
                       ("align", "align_pairs_plain")):
        fn = getattr(tbin, name)

        def spy(*a, _fn=fn, _step=step, **k):
            calls[_step] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(tbin, name, spy)
    return calls


@pytest.mark.parametrize("case", ["batched", "overflow", "ellipse",
                                  "trunc_cull", "sentinel"])
def test_plain_steps_match_jax(case, monkeypatch):
    """The CPU path of the emission, the stable tile sort and the aligned
    scatter gives JAX's every field, bit for bit: batched views
    (``view_tile_rows``), the whole-gaussian drop at a tiny ``max_pairs``,
    the ellipse expansion's pairs through the sort and the scatter,
    truncation with the occlusion cull, and a grid of 16 tiles, where the
    sentinel tile 16 needs the sort's top key bit."""
    s = make_scene(None, n=256, seed_offset=7)
    kw = dict(CFG)
    if case == "batched":
        proj_j, kw = _jax_batched(s, dict(CFG, max_pairs=2048))
        assert kw["view_tile_rows"] == 4 and kw["height"] == 192
    else:
        kw.update({"overflow": dict(max_pairs=300),
                   "ellipse": dict(cull_mode="ellipse"),
                   "trunc_cull": dict(tile_rank_cap=64, occlusion_cull=True,
                                      cull_chunks=8),
                   "sentinel": dict(max_pairs=8192)}[case])
        proj_j = _jax_projection(s, kw)
    calls = _steps_spy(monkeypatch)
    got = _check(proj_j, kw)
    assert calls == {"emit": int(case != "ellipse"), "sort": 1, "align": 1}
    num_tiles = tconfig.RenderConfig(**kw).num_tiles
    if case == "overflow":
        assert int(got.num_pairs) > kw["max_pairs"]
    if case == "trunc_cull":
        assert int(got.num_pairs) < int(_jit_bin(
            proj_j, jconfig.RenderConfig(**dict(kw, occlusion_cull=False))
        ).num_pairs)  # the cull dropped pairs before the sort
    if case == "sentinel":
        assert num_tiles == 16 and tbin._end_bit(num_tiles) == 5
        assert int(got.num_pairs) < kw["max_pairs"] // 2  # many sentinels


def _sort_keys_int64(tile_id, slot, n: int, num_tiles: int):
    """The unique int64 key order the tile sort replaces: tile-major,
    depth slot within a tile, every unused slot (the sentinel tile) last."""
    t, sl = tile_id.to(torch.int64), slot.to(torch.int64)
    key = torch.where(t < num_tiles, t * (n + 1) + sl, num_tiles * (n + 1))
    key = torch.sort(key)[0]
    return key // (n + 1), key % (n + 1)


def test_tile_sort_equals_int64_key_order_on_tied_depths():
    """Duplicated gaussians tie in depth (the stable depth order decides
    between them); the tile-only stable sort of the emitted pairs gives
    the int64 key sort's (tile, slot) order exactly."""
    s = make_scene(None, n=150, seed_offset=2)
    for k in ("pos", "scale_raw", "q_raw", "opacity_raw", "f_dc", "f_rest"):
        s[k] = np.concatenate([s[k], s[k][:50], s[k][:50]])
    kw = dict(CFG, max_pairs=8192)
    proj = _to_torch(_jax_projection(s, kw))
    cfg = tconfig.RenderConfig(**kw)
    order, tile_min, n_u, _, counts = tbin._footprints(proj)
    depth = proj.depth[order.long()]
    assert (depth[1:] == depth[:-1]).sum() >= 50  # tied neighbours
    _, offsets = tbin._capacity_drop(counts, cfg)
    tile_id, slot = tbin.emit_pairs_plain(offsets, tile_min, n_u, cfg)
    st, ss = tbin.sort_pairs_plain(tile_id, slot, cfg.num_tiles)
    wt, ws = _sort_keys_int64(tile_id, slot, order.shape[0], cfg.num_tiles)
    real = wt < cfg.num_tiles
    assert int(real.sum()) == int(offsets[-1]) > 0
    np.testing.assert_array_equal(st.numpy(), wt.numpy())
    np.testing.assert_array_equal(ss.numpy()[real.numpy()],
                                  ws.numpy()[real.numpy()])
