"""Port parity: the serving levers. Per-tile rank truncation with the
pre-sort occlusion cull, the truncated gather backward, demand-sized and
bucketed capacities, and the render_trained flags.

The same seeded numpy inputs go through the JAX package (its Pallas
compositor in interpret mode, as tests/test_pallas_kernel.py runs it) and
through gsplat_tpu_torch on the CPU. Binning is fed the JAX projection on
both sides, so integers must agree exactly: ``pair_slot``, ``tile_start``,
``tile_count``, ``block_meta``, ``num_pairs``, ``num_pairs_kept``,
``trunc_demand``, the cover counts and ``_occlusion_cull``'s output.
Images within 2e-5 of JAX's (the compositor's own tolerance: T built in
another order), gradients within 5e-4 of each leaf's max (the JAX
package's own gradient tolerance, tests/test_pallas_kernel.py:80).

The JAX package's own gates are re-run on the port
(tests/test_pallas_kernel.py:185-298): the cull on against off
bit-identical, truncation with a cap above every tile's count exact,
overflow reported and finite, ``trunc_demand`` independent of the probe's
``max_pairs``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_scene

import gsplat_tpu as gj
import gsplat_tpu.config as jconfig
import gsplat_tpu_torch as gt
import gsplat_tpu_torch.config as tconfig
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.viewer import make_bucketed_render_fn as jbucketed
from gsplat_tpu_torch import render_trained
from gsplat_tpu_torch import viewer as tviewer
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
from gsplat_tpu_torch.ops import binning as tbin
from test_pallas_kernel import _dense_scene
from test_torch_binning import _check, _jax_projection
from test_torch_render import CKPT

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

jfit = importlib.import_module("gsplat_tpu.train.fit")
tfit = importlib.import_module("gsplat_tpu_torch.train.fit")

CAM = dict(fx=60.0, fy=58.0, cx=32.5, cy=31.5)
BASE = dict(height=64, width=64, max_pairs=2**15, pair_block=32)
TRUNC = dict(BASE, tile_rank_cap=32)
IMG_TOL = 2e-5
GRAD_TOL = 5e-4


def _dense():
    s = _dense_scene()
    s["c2w"] = np.eye(4, dtype=np.float32)
    return s


def _params(s):
    return {k: np.array(s[k]) for k in PARAM_KEYS}


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


# --- binning: integers exact ------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(cull_chunks=16),
    dict(),  # the default 64 depth chunks
    dict(occlusion_cull=False),
    dict(trunc_pairs=10 * 32),  # capacity overflow, a tile cut mid-run
    dict(max_pairs=2**10),  # a probe whose own capacity clips the pairs
    dict(tile_rank_cap=64, cull_chunks=5, max_pairs=3000, trunc_pairs=700),
], ids=["chunks16", "chunks64", "nocull", "overflow", "smallprobe", "mixed"])
def test_truncated_binning_bit_identical(kw):
    cfg = dict(TRUNC, **kw)
    got = _check(_jax_projection(_dense(), cfg), cfg)
    assert int(got.num_pairs_kept) < int(got.num_pairs)
    assert got.pair_slot.shape[0] == \
        tconfig.RenderConfig(**cfg).trunc_padded_pairs


def _depth_ordered(cfg_kw):
    """The cull's inputs in depth order, from the JAX projection."""
    proj = _jax_projection(_dense(), cfg_kw)
    order = jbin.depth_order(proj.depth, proj.valid)
    tmin = proj.tile_min[order]
    tmax = proj.tile_max[order]
    n_u = jnp.maximum(tmax[:, 0] - tmin[:, 0] + 1, 0)
    n_v = jnp.maximum(tmax[:, 1] - tmin[:, 1] + 1, 0)
    return tmin, n_u, n_v, (n_u * n_v).astype(jnp.int32)


@pytest.mark.parametrize("cap,chunks", [(32, 16), (32, 64), (64, 7)])
def test_occlusion_cull_matches_jax(cap, chunks):
    kw = dict(BASE, tile_rank_cap=cap, cull_chunks=chunks)
    args = _depth_ordered(kw)
    want = np.asarray(jbin._occlusion_cull(*args, jconfig.RenderConfig(**kw)))
    t = [torch.from_numpy(np.array(a)).long() for a in args]
    got = tbin._occlusion_cull(*t, tconfig.RenderConfig(**kw)).numpy()
    np.testing.assert_array_equal(got, want)
    assert ((got == 0) & (np.asarray(args[3]) > 0)).any(), "nothing culled"


def test_cover_counts_match_jax():
    r = np.random.default_rng(3)
    n, ty, tx = 500, 9, 13
    y0 = r.integers(0, ty, n).astype(np.int32)
    x0 = r.integers(0, tx, n).astype(np.int32)
    y1 = np.minimum(y0 + r.integers(0, 5, n), ty).astype(np.int32)
    x1 = np.minimum(x0 + r.integers(0, 5, n), tx).astype(np.int32)
    kept = r.uniform(size=n) < 0.8
    j = [jnp.asarray(a) for a in (y0, y1, x0, x1, kept)]
    t = [torch.from_numpy(a) for a in (y0, y1, x0, x1, kept)]
    want = np.asarray(jbin._rect_cover_counts(*j, ty, tx))
    got = tbin._cover_counts(*t, ty, tx)
    np.testing.assert_array_equal(got[0].numpy(), want)
    C = 6
    want = np.asarray(jbin._rect_cover_counts(*j, ty, tx, chunks=C))
    chunk = torch.arange(n) // -(-n // C)
    np.testing.assert_array_equal(
        tbin._cover_counts(*t, ty, tx, chunk, C).numpy(), want)


# --- renders and gradients against JAX ---------------------------------------

def _jax_value_grad(params, c2w, cfg_kw, tgt):
    cfg = gj.RenderConfig(**cfg_kw, backend="pallas")

    def loss(p):
        img, aux = gj.render_from_params(p, jnp.asarray(c2w), *CAM.values(),
                                         cfg)
        return jnp.mean(jnp.abs(img - tgt)) + jnp.mean(img * img), (img, aux)

    (_, (img, aux)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in params.items()})
    return np.asarray(img), aux, {k: np.asarray(v) for k, v in g.items()}


def _torch_value_grad(params, c2w, cfg_kw, tgt):
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in params.items()}
    img, aux = gt.render_from_params(p, c2w, *CAM.values(),
                                     gt.RenderConfig(**cfg_kw))
    loss = torch.mean(torch.abs(img - torch.from_numpy(tgt))) \
        + torch.mean(img * img)
    loss.backward()
    return img.detach().numpy(), aux, {k: v.grad.numpy()
                                       for k, v in p.items()}


@pytest.mark.parametrize("kw", [dict(), dict(trunc_pairs=10 * 32)],
                         ids=["sized", "overflow"])
def test_truncated_render_and_gradients_match_jax(kw):
    """Image within 2e-5 and every gradient within 5e-4 of JAX's (the
    truncated gather backward included); on overflow both composite the
    blocks that fit, and report it."""
    s = _dense()
    cfg = dict(TRUNC, **kw)
    tgt = np.random.default_rng(2).uniform(0, 1, (64, 64, 3)).astype(
        np.float32)
    img_j, aux_j, g_j = _jax_value_grad(_params(s), s["c2w"], cfg, tgt)
    img_t, aux_t, g_t = _torch_value_grad(_params(s), s["c2w"], cfg, tgt)
    for f in ("num_pairs", "num_pairs_kept", "trunc_demand", "bwd_demand"):
        assert int(getattr(aux_t, f)) == int(getattr(aux_j, f)), f
    assert aux_t.trunc_capacity == aux_j.trunc_capacity
    assert (int(aux_t.trunc_demand) > aux_t.trunc_capacity) == bool(kw)
    assert np.isfinite(img_t).all()
    assert float(np.abs(img_t - img_j).max()) <= IMG_TOL
    for k in PARAM_KEYS:
        assert np.isfinite(g_t[k]).all(), k
        assert _rel(g_t[k], g_j[k]) <= GRAD_TOL, k


# --- the JAX package's gates, on the port ------------------------------------

def _render(params, c2w, cfg_kw, grad=False):
    p = {k: torch.from_numpy(v).requires_grad_(grad)
         for k, v in params.items()}
    img, aux = gt.render_from_params(p, c2w, *CAM.values(),
                                     gt.RenderConfig(**cfg_kw))
    if grad:
        (torch.mean(img) + torch.mean(img * img)).backward()
        return img.detach(), aux, {k: v.grad for k, v in p.items()}
    return img, aux


def test_occlusion_cull_leaves_the_render_bit_identical():
    """Cull on against off: the image bit for bit, the kept pairs equal,
    the demand lower; gradients within 1e-7 (JAX's gate)."""
    s = _dense()
    base = dict(TRUNC, cull_chunks=16)
    img_off, aux_off, g_off = _render(_params(s), s["c2w"],
                                      dict(base, occlusion_cull=False), True)
    img_on, aux_on, g_on = _render(_params(s), s["c2w"], base, True)
    assert int(aux_on.num_pairs) < int(aux_off.num_pairs)
    assert int(aux_on.num_pairs_kept) == int(aux_off.num_pairs_kept)
    assert torch.equal(img_on, img_off)
    for k in PARAM_KEYS:
        assert float((g_on[k] - g_off[k]).abs().max()) < 1e-7, k


def test_rank_truncation_off_is_exact():
    """A cap above every tile's count: bit for bit with no truncation."""
    s = make_scene(None, n=192, seed_offset=6)
    kw = dict(BASE, max_pairs=4096)
    img_0, _ = _render(_params(s), s["c2w"], kw)
    img_t, aux_t = _render(_params(s), s["c2w"], dict(kw, tile_rank_cap=256))
    assert int(aux_t.num_pairs_kept) == int(aux_t.num_pairs)
    assert torch.equal(img_t, img_0)


def test_trunc_demand_is_capacity_independent():
    """A probe whose max_pairs clips most pairs reports the same truncated
    demand and kept pairs as one that holds them all."""
    s = _dense()
    with torch.no_grad():
        _, big = _render(_params(s), s["c2w"], TRUNC)
        _, small = _render(_params(s), s["c2w"], dict(TRUNC, max_pairs=2**10))
    assert int(big.num_pairs) > 2**10
    assert int(small.trunc_demand) == int(big.trunc_demand)
    assert int(small.num_pairs_kept) == int(big.num_pairs_kept)
    d = gt.pair_demand({k: torch.from_numpy(v) for k, v in
                        _params(s).items()}, s["c2w"], *CAM.values(),
                       gt.RenderConfig(**dict(TRUNC, max_pairs=2**10)))
    assert int(d[2]) == int(big.trunc_demand)


# --- bucketed capacities -----------------------------------------------------

def _bucket_scene():
    """The JAX package's bucketing scene (tests/test_viewer_utils.py:206)
    at 600 gaussians and 160x120, with far (6.0) and near (1.0) orbit
    poses: their demands differ by 3x, so the ladder has two rungs."""
    rng = np.random.default_rng(9)
    n = 600
    params = {
        "pos": np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                         rng.uniform(2, 5, n)], axis=-1).astype(np.float32),
        "scale_raw": (rng.normal(0, 0.3, (n, 3)) - 1.8).astype(np.float32),
        "q_raw": (rng.normal(0, 1, (n, 4))
                  + np.array([0, 0, 0, 2.0])).astype(np.float32),
        "opacity_raw": rng.normal(0.5, 1, n).astype(np.float32),
        "f_dc": rng.normal(0, 0.8, (n, 3)).astype(np.float32),
        "f_rest": rng.normal(0, 0.05, (n, 45)).astype(np.float32),
    }
    cfg = dict(height=120, width=160, max_pairs=2**16, pair_block=32,
               tile_rank_cap=64)
    traj = np.concatenate([
        tviewer.create_orbit_trajectory(np.array([0.0, 0.0, 3.5]),
                                        radius=6.0, num_frames=3),
        tviewer.create_orbit_trajectory(np.array([0.0, 0.0, 3.5]),
                                        radius=1.0, num_frames=2),
    ])
    return params, cfg, traj


def test_bucketed_rungs_match_jax(monkeypatch):
    """The same trajectory gives JAX's ladder, each pose's rung and
    capacities, and its per-pose demands; the bucketed frames equal one
    fixed-capacity render's. JAX's rung renders are stood in for by a
    recorder (the ladder is built before any render), so each pose's rung
    is read from the call it dispatches."""
    import gsplat_tpu.viewer as jviewer

    params, cfg, traj = _bucket_scene()
    cam = (120.0, 120.0, 80.0, 60.0)
    calls = []

    def recorder(p, c, *a, **k):
        def fn(c2w):
            calls.append((c.max_pairs, c.trunc_pairs))
            return jnp.zeros((c.height, c.width, 3))
        return fn

    monkeypatch.setattr(jviewer, "make_render_fn", recorder)
    msgs_j, msgs_t = [], []
    jfn = jbucketed({k: jnp.asarray(v) for k, v in params.items()},
                    gj.RenderConfig(**cfg), *cam, trajectory=traj,
                    num_buckets=3, verbose=msgs_j.append)
    del calls[:]  # the warm-up calls
    for c in traj:
        jfn(c)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tcfg = gt.RenderConfig(**cfg)
    fn = tviewer.make_bucketed_render_fn(tp, tcfg, *cam, trajectory=traj,
                                         num_buckets=3, report_demand=True,
                                         verbose=msgs_t.append)
    assert msgs_t == msgs_j and "rung" in msgs_t[0]
    assert len(set(fn.assign)) > 1, "one rung serves every pose"
    assert [(fn.cfgs[a].max_pairs, fn.cfgs[a].trunc_pairs)
            for a in fn.assign] == calls
    probe = jax.jit(lambda c: gj.pair_demand(
        {k: jnp.asarray(v) for k, v in params.items()}, c, *cam,
        gj.RenderConfig(**cfg)))
    assert fn.demands == [tuple(int(x) for x in probe(jnp.asarray(c)))
                          for c in traj]
    single = tviewer.make_render_fn(tp, tcfg, *cam, report_demand=True)
    f1, s1 = tviewer.render_trajectory(single, traj,
                                       pair_capacity=tcfg.max_pairs)
    f2, s2 = tviewer.render_trajectory(fn, traj, pair_capacity=tcfg.max_pairs)
    assert s1["max_pairs_seen"] == s2["max_pairs_seen"]
    for a, b in zip(f1, f2):
        np.testing.assert_array_equal(a, b)


# --- the CLI, training and fit() ---------------------------------------------

def test_render_trained_serving_levers_on_cpu(tmp_path, monkeypatch):
    """The new flags through --device cpu at a small size: demand-sized,
    bucketed, truncated, log-space, white background, dilated."""
    monkeypatch.chdir(tmp_path)
    stats = render_trained.main([
        "--checkpoint", CKPT, "--num_frames", "2", "--height", "36",
        "--width", "64", "--max_pairs", "262144", "--orbit_scale", "4.4",
        "--device", "cpu", "--benchmark_only", "--auto_pairs",
        "--bucket_pairs", "2", "--tile_rank_cap", "256", "--cull_chunks",
        "16", "--transmittance_math", "log", "--background", "white",
        "--aa_mode", "dilate"])
    assert stats["frames"] == 2 and stats["pair_overflow_frames"] == 0
    assert len(stats["rung_of_frame"]) == 2 and stats["rungs"]
    assert max(stats["frame_demand"]) <= max(stats["rungs"]) <= 262144
    assert 0.0 < min(stats["frame_mean"]) and max(stats["frame_mean"]) < 1.0


def test_fit_grows_the_truncated_capacity_like_jax():
    """A truncated-list overflow is logged and grows trunc_pairs, with the
    JAX fit()'s message, demand and new capacity."""
    from test_torch_fit import H, W, _iterate, _scene

    pts, batches = _scene()
    logs = {"jax": [], "torch": []}
    kw = dict(height=H, width=W, max_pairs=2048, pair_block=32,
              tile_rank_cap=32, trunc_pairs=64)
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
    grow = [[m for m in logs[k] if "trunc_pairs" in m] for k in logs]
    assert grow[0] and grow[0] == grow[1], logs
    assert report.overflow_events == 1 and np.isfinite(report.final_loss)
