"""Port parity: the compacted backward (``RenderConfig.bwd_pairs``).

The backward kernel's compact mode writes only the blocks the forward
composited, item i of the composited-block list at columns ``[i*G,
(i+1)*G)`` of a ``[10, kb*G]`` gradient, and the gather's reduction sorts
that list alone (the JAX package's ``_composite_gathered`` / ``_cg_bwd``,
``gsplat_tpu/ops/rasterize.py:289-373``). The same seeded numpy inputs go
through the JAX package (its Pallas kernels in interpret mode, as
tests/test_pallas_kernel.py runs them) and through gsplat_tpu_torch on
the CPU.

What is held, and how closely:

* the compacted block list against JAX's ``_cg_bwd`` (its ``keep`` and
  ``src``, read from the block metadata and features it hands
  ``_bwd_pallas``): integers and gathered features exactly; the compact
  plain backward against JAX's ``_bwd_pallas`` on them within 5e-4 of
  each row's max (the JAX package's gradient tolerance,
  tests/test_pallas_kernel.py:80), unused columns exactly zero;
* renders and gradients with ``bwd_pairs`` against JAX's: images within
  2e-5, gradients within 5e-4 of each leaf's max, sized and overflowing,
  with the demand and capacity equal;
* the JAX package's own gates on the port (tests/test_pallas_kernel.py:
  372-412): ``bwd_pairs`` at the demand gives the gradients of
  ``bwd_pairs = 0`` bit for bit, with and without ``tile_rank_cap`` and in
  both transmittance modes; overflow is reported and stays finite;
* the gather's own ``bwd_cap`` branch (``_gpf_bwd``) against JAX's VJP
  within 5e-4 of each row's max;
* ``fit()``'s growth of ``bwd_pairs`` against the JAX ``fit()``'s log line.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu.config as jconfig
import gsplat_tpu_torch as gt
import gsplat_tpu_torch.config as tconfig
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.ops import gaussian as jgau
from gsplat_tpu.ops import projection as jproj
from gsplat_tpu.ops import raster_pallas as jras
from gsplat_tpu.ops import sh as jsh
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
from gsplat_tpu_torch.ops import raster_cuda as tras
from gsplat_tpu_torch.ops import rasterize as trz
from test_pallas_kernel import _bwd_scene

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

jfit = importlib.import_module("gsplat_tpu.train.fit")
jrz = importlib.import_module("gsplat_tpu.ops.rasterize")
tfit = importlib.import_module("gsplat_tpu_torch.train.fit")

# JAX's compacted-backward scene (tests/test_pallas_kernel.py:350) framed
# at 64x64: saturated tiles skip most of their blocks.
CAM = (75.0, 75.0, 32.0, 32.0)
BASE = dict(height=64, width=64, max_pairs=2**13, pair_block=32)
IMG_TOL = 2e-5
GRAD_TOL = 5e-4


def _params():
    return {k: np.asarray(v) for k, v in _bwd_scene().items()}


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _weights(shape):
    return np.cos(0.37 * np.arange(int(np.prod(shape)))).reshape(
        shape).astype(np.float32)


# --- the compacted block list against JAX's _cg_bwd --------------------------

def _jax_case(cfg_kw):
    """JAX's forward inputs (feat10 in depth order and the binning)."""
    cfg = jconfig.RenderConfig(**cfg_kw)
    p = {k: jnp.asarray(v) for k, v in _params().items()}
    c2w = jnp.eye(4)

    @jax.jit
    def run(p):
        cov = jgau.build_cov3d_packed(p["scale_raw"], p["q_raw"])
        colors = jsh.evaluate_sh(p["f_dc"], p["f_rest"], p["pos"], c2w)
        proj = jproj.project_gaussians(p["pos"], cov, p["opacity_raw"], c2w,
                                       *CAM, cfg)
        b = jbin.bin_gaussians(proj, cfg)
        return jrz._pair_features(proj, colors, jnp.float32)[
            b.depth_order], b

    return run(p)


@pytest.mark.parametrize("kw", [
    dict(bwd_pairs=2**13),  # above the demand: every block kept
    dict(bwd_pairs=20 * 32),  # below it: the trailing tiles' blocks drop
    dict(bwd_pairs=20 * 32, tile_rank_cap=64),
], ids=["sized", "overflow", "truncated"])
def test_compacted_block_list_matches_jax(kw, monkeypatch):
    """JAX's kept blocks, in its order, and its compact backward."""
    cfg_kw = dict(BASE, **kw)
    jcfg = jconfig.RenderConfig(**cfg_kw)
    tcfg = tconfig.RenderConfig(**cfg_kw)
    feat10, b = _jax_case(cfg_kw)
    G = tcfg.pair_block
    gout = np.random.default_rng(5).normal(
        0, 1, (tcfg.num_tiles, 8, tcfg.tile**2)).astype(np.float32)
    real = jras._bwd_pallas

    @jax.jit
    def jax_fwd_bwd(feat10, pair_slot, block_meta, gout):
        """JAX's forward and backward, with what _cg_bwd hands
        _bwd_pallas (the compacted features and metadata) and its
        output."""
        seen = {}

        def recorder(feat_c, meta_c, fwd, g, cfg):
            seen.update(feat_c=feat_c, meta_c=meta_c)
            seen["d"] = real(feat_c, meta_c, fwd, g, cfg)
            return seen["d"]

        out, res = jrz._cg_fwd(jcfg, feat10, pair_slot, block_meta)
        monkeypatch.setattr(jras, "_bwd_pallas", recorder)
        seg = jrz._cg_bwd(jcfg, res, gout)[0]
        monkeypatch.setattr(jras, "_bwd_pallas", real)
        return out, seg, seen

    out_j, seg_j, seen = jax.tree_util.tree_map(np.asarray, jax_fwd_bwd(
        feat10, b.pair_slot, b.block_meta, jnp.asarray(gout)))

    f10 = torch.from_numpy(np.array(feat10))
    slot, ts, tc = (torch.from_numpy(np.array(a)) for a in
                    (b.pair_slot, b.tile_start, b.tile_count))
    pf = trz._gather(f10, slot)
    out_t, state = tras.composite_pairs_plain(pf, ts, tc, tcfg,
                                              with_state=True)
    occ = tc.numpy() > 0
    np.testing.assert_array_equal(out_t.numpy()[occ, 5],
                                  np.asarray(out_j)[occ, 5])
    nb = pf.shape[1] // G
    kb = min(-(-tcfg.bwd_pairs // G), nb)
    off = tras.tile_block_offsets(out_t)
    blk, _, _, valid = tras.composited_blocks(ts, off, kb, tcfg)
    blk, valid = blk.numpy(), valid.numpy()
    demand = int((out_t[:, 5, 0] * torch.from_numpy(occ)).sum())
    assert int(valid.sum()) == min(demand, kb)
    assert (demand > kb) == (kw["bwd_pairs"] < 2**13)
    # JAX's keep/src: the kept blocks' metadata, the rest marked dead.
    meta = np.asarray(b.block_meta)
    np.testing.assert_array_equal(seen["meta_c"][valid], meta[blk[valid]])
    assert (seen["meta_c"][~valid] == jras.META_DEAD).all()
    fc = seen["feat_c"][:10].reshape(10, kb, G)[:, valid]
    np.testing.assert_array_equal(
        fc, pf.numpy().reshape(10, nb, G)[:, blk[valid]])

    d_t = tras.composite_pairs_bwd_plain(pf, ts, tc, out_t, state,
                                         torch.from_numpy(gout), tcfg, kb=kb)
    assert tuple(d_t.shape) == (10, kb * G)
    d_t = d_t.numpy().reshape(10, kb, G)
    assert (d_t[:, ~valid] == 0).all()
    d_j = seen["d"][:10].reshape(10, kb, G)
    for r in range(10):
        assert _rel(d_t[r], d_j[r]) <= GRAD_TOL, r

    # The whole backward: per-gaussian rows against JAX's reduction.
    f10.requires_grad_(True)
    out = trz._CompositeGathered.apply(f10, slot, ts, tc, tcfg)
    out.backward(torch.from_numpy(gout))
    for r in range(10):
        assert _rel(f10.grad.numpy()[:, r], seg_j[:, r]) <= GRAD_TOL, r


# --- renders and gradients against JAX ---------------------------------------

def _jax_value_grad(cfg_kw):
    cfg = gj.RenderConfig(**cfg_kw, backend="pallas")
    w = jnp.asarray(_weights((64, 64, 3)))

    def loss(p):
        img, aux = gj.render_from_params(p, jnp.eye(4), *CAM, cfg)
        return jnp.sum(img * w), (img, aux)

    (_, (img, aux)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in _params().items()})
    return np.asarray(img), aux, {k: np.asarray(v) for k, v in g.items()}


def _torch_value_grad(cfg_kw, params=None):
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in (params or _params()).items()}
    img, aux = gt.render_from_params(p, np.eye(4, dtype=np.float32), *CAM,
                                     gt.RenderConfig(**cfg_kw))
    loss = torch.sum(img * torch.from_numpy(_weights(tuple(img.shape))))
    loss.backward()
    return img.detach(), aux, {k: v.grad for k, v in p.items()}


@pytest.mark.parametrize("bwd_pairs", [2**13, 20 * 32],
                         ids=["sized", "overflow"])
def test_compacted_render_and_gradients_match_jax(bwd_pairs):
    cfg_kw = dict(BASE, bwd_pairs=bwd_pairs)
    img_j, aux_j, g_j = _jax_value_grad(cfg_kw)
    img_t, aux_t, g_t = _torch_value_grad(cfg_kw)
    assert int(aux_t.bwd_demand) == int(aux_j.bwd_demand)
    assert aux_t.bwd_capacity == int(aux_j.bwd_capacity) == bwd_pairs
    assert (int(aux_t.bwd_demand) > bwd_pairs) == (bwd_pairs < 2**13)
    assert float(np.abs(img_t.numpy() - img_j).max()) <= IMG_TOL
    for k in PARAM_KEYS:
        assert torch.isfinite(g_t[k]).all(), k
        assert _rel(g_t[k].numpy(), g_j[k]) <= GRAD_TOL, k


# --- the JAX package's gates, on the port ------------------------------------

@pytest.mark.parametrize("math", ["cumprod", "log"])
@pytest.mark.parametrize("cap", [0, 256], ids=["exact", "truncated"])
def test_sized_compaction_is_bit_exact(math, cap):
    """bwd_pairs at the demand: the image and every gradient equal those of
    bwd_pairs = 0 bit for bit (the reduction sorts the same cotangents in
    the same order), and the demand undercuts the list (else the test
    would compare nothing compacted away)."""
    cfg_kw = dict(BASE, transmittance_math=math, tile_rank_cap=cap)
    img0, aux0, g0 = _torch_value_grad(cfg_kw)
    demand = int(aux0.bwd_demand)
    assert 0 < demand < gt.RenderConfig(**cfg_kw).trunc_padded_pairs
    imgc, auxc, gc = _torch_value_grad(dict(cfg_kw, bwd_pairs=demand))
    assert auxc.bwd_capacity == demand
    assert torch.equal(img0, imgc)
    for k in PARAM_KEYS:
        assert torch.equal(g0[k], gc[k]), k


def test_overflow_reported_never_silent():
    _, aux, g = _torch_value_grad(dict(BASE, bwd_pairs=64))
    assert int(aux.bwd_demand) > aux.bwd_capacity == 64
    for k in PARAM_KEYS:
        assert torch.isfinite(g[k]).all(), k


# --- the gather's bwd_cap branch ---------------------------------------------

@pytest.mark.parametrize("bwd_cap", [40 * 128, 6 * 128],
                         ids=["sized", "overflow"])
def test_gather_bwd_cap_matches_jax(bwd_cap):
    """JAX's gather_pair_features VJP with bwd_cap (all-zero 128-pair
    blocks dropped, the first cdiv(bwd_cap, 128) kept) against the port's
    on one binning and a cotangent with whole zero blocks."""
    cfg_kw = dict(BASE)
    feat10, b = _jax_case(cfg_kw)
    cap = b.pair_slot.shape[0]
    assert cap % 128 == 0
    r = np.random.default_rng(2)
    g = r.normal(0, 1, (10, cap)).astype(np.float32)
    g.reshape(10, -1, 128)[:, r.uniform(size=cap // 128) < 0.5] = 0.0
    _, vjp = jax.vjp(lambda f: jrz.gather_pair_features(
        cap, False, bwd_cap, f, b.pair_slot, b.gauss_offsets), feat10)
    want = np.asarray(vjp(jnp.asarray(g))[0])
    f10 = torch.from_numpy(np.array(feat10)).requires_grad_(True)
    out = trz.gather_pair_features(
        f10, torch.from_numpy(np.array(b.pair_slot)),
        torch.from_numpy(np.array(b.gauss_offsets)), bwd_cap=bwd_cap)
    out.backward(torch.from_numpy(g))
    for k in range(10):
        assert _rel(f10.grad.numpy()[:, k], want[:, k]) <= GRAD_TOL, k


# --- fit() -------------------------------------------------------------------

def test_fit_grows_bwd_pairs_like_jax():
    """A compacted-backward overflow is logged and grows bwd_pairs, with
    the JAX fit()'s message, demand and new capacity."""
    from test_torch_fit import H, W, _iterate, _scene

    pts, batches = _scene()
    logs = {"jax": [], "torch": []}
    kw = dict(height=H, width=W, max_pairs=2048, pair_block=32,
              bwd_pairs=64)
    tkw = dict(iterations=2, batch_size=2, capacity=64,
               densification_interval=10_000, opacity_reset_interval=10_000,
               checkpoint_interval=10_000)
    jfit.fit(_iterate(batches), gj.RenderConfig(**kw, backend="pallas"),
             gj.TrainConfig(**tkw), initial_points=pts, log_every=2,
             log_fn=logs["jax"].append)
    _, report = tfit.fit(_iterate(batches), gt.RenderConfig(**kw),
                         gt.TrainConfig(**tkw), initial_points=pts,
                         log_every=2, log_fn=logs["torch"].append,
                         device="cpu")
    grow = [[m for m in logs[k] if "bwd_pairs" in m] for k in logs]
    assert grow[0] and grow[0] == grow[1], logs
    assert report.overflow_events == 1 and np.isfinite(report.final_loss)
