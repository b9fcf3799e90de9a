"""Port parity: the pool constructors, both ADC forms, the opacity raise,
the ADC steps on a trained state, capacity growth and checkpoints.

The same seeded numpy inputs go through the JAX package (jitted, as its
``adc_step`` runs them) and through gsplat_tpu_torch on the CPU. The ADC's normal draws are JAX's own
(``jax.random.normal`` on the key JAX's function gets, ``jax.random.split``
of it for the paper form), passed to the port through ``noise=``.

Tolerances:
* pool constructors, checkpoints both ways, a grown state made from one
  checkpoint: bit for bit;
* every ADC mask and count (alive, new slots, pruned, split, cloned,
  overflowed, the slot allocation): exact;
* reference ADC parameters: 1 float32 ulp (``exp`` of the scales may
  round one ulp apart in the two libraries; the rest is exactly rounded);
* paper ADC parameters: 1e-6 abs (the rotation's sums and the quaternion
  norm round in another order);
* ``raise_low_opacity``: 1e-6 abs on ``opacity_raw``;
* a paper-mode train step (Pallas in interpret mode on the JAX side):
  ``visible`` and ``max_radius`` exact, ``uv_grad_sum`` within 5e-4 of its
  max (the render's own gradient tolerance, tests/test_torch_grads.py);
* moments after one step: ``exp_avg`` within 5e-4 of its max (the
  first-step gradient tolerance of tests/test_torch_train.py), and
  ``exp_avg_sq`` within 1e-3 of its max (a square doubles the relative
  error); the rows the ADC reset exactly 0.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu.models.adc as jadc
import gsplat_tpu.models.gaussians as jgauss
import gsplat_tpu.train.trainer as jtrainer
import gsplat_tpu_torch as gt
import gsplat_tpu_torch.models.adc as tadc
import gsplat_tpu_torch.models.gaussians as tgauss
import gsplat_tpu_torch.train.trainer as ttrainer
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
from test_train import CFG as JCFG
from test_train import _make_batch, _make_pool

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

RCFG = dict(height=64, width=64, max_pairs=4096)
JPALLAS = JCFG.with_(backend="pallas")


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _tpool(jpool):
    return gt.pool_from_numpy({k: np.asarray(v) for k, v in
                               jpool.params.items()},
                              np.asarray(jpool.alive), device="cpu")


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _assert_pools_equal(tpool, jpool):
    np.testing.assert_array_equal(_np(tpool.alive), np.asarray(jpool.alive))
    for k in PARAM_KEYS:
        got, want = _np(getattr(tpool, k)), np.asarray(jpool.params[k])
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


# --- pool constructors ---------------------------------------------------------

@pytest.mark.parametrize("cols,bands", [(3, 3), (6, 1), (6, 0)])
def test_pool_functions_bit_identical(cols, bands):
    r = np.random.default_rng(cols + bands)
    pts = r.normal(0, 2, (50, cols)).astype(np.float32)
    if cols == 6:
        pts[:, 3:] = r.uniform(0, 255, (50, 3))  # rescaled to [0, 1]
    jpool = jgauss.init_pool_from_points(pts, 80, num_sh_bands=bands, seed=5)
    tpool = tgauss.init_pool_from_points(pts, 80, num_sh_bands=bands, seed=5,
                                         device="cpu")
    _assert_pools_equal(tpool, jpool)

    # A pool with scattered alive slots: compaction and export.
    alive = r.uniform(0, 1, 80) < 0.5
    jp = jgauss.GaussianPool(params=jpool.params, alive=jnp.asarray(alive))
    tp = gt.pool_from_numpy({k: np.asarray(v) for k, v in
                             jpool.params.items()}, alive, device="cpu")
    _assert_pools_equal(tgauss.compact_pool(tp), jgauss.compact_pool(jp))
    want = jgauss.export_params(jp)
    got = tgauss.export_params(tp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _assert_pools_equal(tgauss.pool_from_dense(want, 64, device="cpu"),
                        jgauss.pool_from_dense(want, 64))
    with pytest.raises(ValueError):
        tgauss.init_pool_from_points(pts, 10, device="cpu")


# --- reference ADC ------------------------------------------------------------

def _adc_case(name):
    """(jax pool, pos_grad [cap, 3] or [cap]) of one reference-ADC case."""
    if name == "prune_split_clone":  # tests/test_train.py:113
        pool = _make_pool(n=64)
        p = dict(pool.params)
        p["opacity_raw"] = p["opacity_raw"].at[:10].set(-8.0)
        p["scale_raw"] = p["scale_raw"].at[10:14].set(0.0)
        p["scale_raw"] = p["scale_raw"].at[14:18].set(-6.0)
        pool = jgauss.GaussianPool(params=p, alive=pool.alive)
        return pool, jnp.zeros((pool.capacity, 3)).at[10:18].set(1.0)
    if name == "overflow":  # tests/test_train.py:141
        pool = _make_pool(n=64, capacity=70)
        p = dict(pool.params)
        p["scale_raw"] = jnp.full_like(p["scale_raw"], 0.0)
        pool = jgauss.GaussianPool(params=p, alive=pool.alive)
        return pool, jnp.zeros((70, 3)).at[:64].set(1.0)
    # Random pools: scattered alive slots, opacities across the prune
    # threshold, scales across the split threshold, grads across max_grad.
    seed = {"random_a": 0, "random_b": 1}[name]
    r = np.random.default_rng(100 + seed)
    cap = 300
    params = {
        "pos": r.normal(0, 2, (cap, 3)),
        "opacity_raw": r.normal(-3.0, 2.0, cap),
        "f_dc": r.normal(0, 1, (cap, 3)),
        "f_rest": r.normal(0, 0.1, (cap, 45)),
        "scale_raw": r.normal(-4.6, 1.0, (cap, 3)),
        "q_raw": r.normal(0, 1, (cap, 4)),
    }
    params = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    alive = jnp.asarray(r.uniform(0, 1, cap) < (0.6 if seed == 0 else 0.9))
    g = r.normal(0, 0.01, (cap, 3)).astype(np.float32)
    if seed == 1:
        g = np.linalg.norm(g, axis=-1)  # a precomputed [cap] statistic
    return jgauss.GaussianPool(params=params, alive=alive), jnp.asarray(g)


def _free_slot_reference(alive, spawn):
    """The i-th spawner takes the i-th free slot, in slot order."""
    free = list(np.flatnonzero(~alive))
    dest = np.full(alive.shape[0], alive.shape[0], np.int32)
    for rank, i in enumerate(np.flatnonzero(spawn)):
        if rank < len(free):
            dest[i] = free[rank]
    return dest


@pytest.mark.parametrize("case", ["prune_split_clone", "overflow",
                                  "random_a", "random_b"])
def test_densify_and_prune_matches_jax(case):
    jpool, grad = _adc_case(case)
    key = jax.random.key(7)
    want = jax.jit(jadc.densify_and_prune)(jpool, grad, key)
    noise = np.array(jax.random.normal(key, jpool.params["pos"].shape,
                                       jnp.float32))
    tpool = _tpool(jpool)
    got = tadc.densify_and_prune(tpool, torch.from_numpy(np.array(grad)),
                                 noise=torch.from_numpy(noise))
    assert got.pool is tpool  # written in place
    for f in ("num_pruned", "num_split", "num_cloned", "num_overflowed"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
        assert getattr(got, f).dtype == torch.int32, f
    np.testing.assert_array_equal(_np(got.new_slot_mask),
                                  np.asarray(want.new_slot_mask))
    np.testing.assert_array_equal(_np(tpool.alive),
                                  np.asarray(want.pool.alive))
    for k in PARAM_KEYS:
        np.testing.assert_array_max_ulp(_np(getattr(tpool, k)),
                                        np.asarray(want.pool.params[k]),
                                        maxulp=1)
    if case == "prune_split_clone":
        assert (int(got.num_pruned), int(got.num_split),
                int(got.num_cloned)) == (10, 4, 4)
    if case == "overflow":
        assert int(got.num_overflowed) == 58


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_allocation_matches_rank_order(seed):
    r = np.random.default_rng(seed)
    alive = r.uniform(0, 1, 200) < [0.3, 0.7, 0.95][seed]
    spawn = alive & (r.uniform(0, 1, 200) < 0.6)
    fits, dest, over = tadc.allocate_slots(torch.from_numpy(alive),
                                           torch.from_numpy(spawn))
    want = _free_slot_reference(alive, spawn)
    np.testing.assert_array_equal(_np(dest), want)
    np.testing.assert_array_equal(_np(fits), want < 200)
    assert int(over) == max(int(spawn.sum()) - int((~alive).sum()), 0)
    assert len(set(want[want < 200])) == int((want < 200).sum())


def test_raise_low_opacity_matches_jax():
    jpool, _ = _adc_case("random_a")
    want = jax.jit(jadc.raise_low_opacity)(jpool)
    tpool = _tpool(jpool)
    assert tadc.raise_low_opacity(tpool) is tpool
    got = _np(tpool.opacity_raw)
    np.testing.assert_allclose(got, np.asarray(want.params["opacity_raw"]),
                               rtol=0, atol=1e-6)
    low = np.asarray(jpool.alive) & (
        1 / (1 + np.exp(-np.asarray(jpool.params["opacity_raw"]))) < 0.01)
    assert low.sum() > 10
    unchanged = ~low
    np.testing.assert_array_equal(
        got[unchanged], np.asarray(jpool.params["opacity_raw"])[unchanged])


# --- paper ADC -----------------------------------------------------------------

def _paper_case(name):
    if name == "mechanics":  # tests/test_train.py:216
        n, cap = 6, 16
        r = np.random.default_rng(0)
        pos = r.normal(0, 1, (cap, 3)).astype(np.float32)
        scale_raw = np.full((cap, 3), -3.0, np.float32)
        scale_raw[1] = -2.0
        scale_raw[4] = 1.0
        opacity_raw = np.full(cap, 2.0, np.float32)
        opacity_raw[2] = -8.0
        params = {
            "pos": pos, "scale_raw": scale_raw,
            "q_raw": np.tile([0, 0, 0, 1.0], (cap, 1)).astype(np.float32),
            "opacity_raw": opacity_raw,
            "f_dc": r.uniform(0, 1, (cap, 3)).astype(np.float32),
            "f_rest": np.zeros((cap, 45), np.float32),
        }
        alive = np.arange(cap) < n
        grads = np.zeros(cap, np.float32)
        grads[0] = grads[1] = 0.01
        radii = np.zeros(cap, np.int32)
        radii[3] = 50
        kw = dict(grad_threshold=0.0002, min_opacity=0.005,
                  percent_dense=0.01, scene_extent=5.0, max_screen_size=20)
    else:  # a random pool with screen-size pruning on
        cap = 400
        r = np.random.default_rng(21)
        params = {
            "pos": r.normal(0, 2, (cap, 3)),
            "opacity_raw": r.normal(-2.0, 2.5, cap),
            "f_dc": r.normal(0, 1, (cap, 3)),
            "f_rest": r.normal(0, 0.1, (cap, 45)),
            "scale_raw": r.normal(-4.4, 1.0, (cap, 3)),
            "q_raw": r.normal(0, 1, (cap, 4)),
        }
        params = {k: v.astype(np.float32) for k, v in params.items()}
        alive = r.uniform(0, 1, cap) < 0.7
        grads = np.abs(r.normal(0, 3e-4, cap)).astype(np.float32)
        radii = r.integers(0, 40, cap).astype(np.int32)
        kw = dict(grad_threshold=0.0002, min_opacity=0.005,
                  percent_dense=0.01, scene_extent=2.5, max_screen_size=30)
    jpool = jgauss.GaussianPool(
        params={k: jnp.asarray(v) for k, v in params.items()},
        alive=jnp.asarray(alive))
    return jpool, grads, radii, kw


@pytest.mark.parametrize("case", ["mechanics", "random_screen_prune"])
def test_densify_and_prune_paper_matches_jax(case):
    jpool, grads, radii, kw = _paper_case(case)
    key = jax.random.key(3)
    want = jax.jit(functools.partial(jadc.densify_and_prune_paper, **kw))(
        jpool, jnp.asarray(grads), jnp.asarray(radii), key)
    k1, k2 = jax.random.split(key)
    shape = jpool.params["scale_raw"].shape
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(
        k, shape, jnp.float32))) for k in (k1, k2))
    tpool = _tpool(jpool)
    got = tadc.densify_and_prune_paper(tpool, torch.from_numpy(grads),
                                       torch.from_numpy(radii), noise=noise,
                                       **kw)
    for f in ("num_pruned", "num_split", "num_cloned", "num_overflowed"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    np.testing.assert_array_equal(_np(got.new_slot_mask),
                                  np.asarray(want.new_slot_mask))
    np.testing.assert_array_equal(_np(tpool.alive),
                                  np.asarray(want.pool.alive))
    for k in PARAM_KEYS:
        np.testing.assert_allclose(_np(getattr(tpool, k)),
                                   np.asarray(want.pool.params[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    if case == "mechanics":
        assert (int(got.num_cloned), int(got.num_split),
                int(got.num_pruned)) == (1, 1, 3)
    else:
        assert int(got.num_split) > 5 and int(got.num_cloned) > 5
        assert int(got.num_pruned) > 20


# --- the paper-mode train step and the ADC steps on a trained state ----------

@pytest.fixture(scope="module")
def paper_step():
    """One paper-mode step of both packages from the same pool and batch
    (the JAX state is a fresh copy: its step donates its input)."""
    jpool = _make_pool()
    batch = _make_batch(jpool)
    tcfg_j = gj.TrainConfig(capacity=512, batch_size=2, adc_mode="paper")
    tcfg = gt.TrainConfig(capacity=512, batch_size=2, adc_mode="paper")
    state_j, m_j = jtrainer.make_train_step(JPALLAS, tcfg_j)(
        jtrainer.init_train_state(_make_pool(), tcfg_j), batch)
    pool = _tpool(jpool)
    state, m = gt.make_train_step(gt.RenderConfig(**RCFG), tcfg)(
        gt.init_train_state(pool, tcfg), _tbatch(batch))
    return dict(state_j=state_j, m_j=m_j, state=state, m=m, tcfg=tcfg,
                tcfg_j=tcfg_j, batch=batch)


def test_paper_train_step_statistics_match_jax(paper_step):
    m, m_j = paper_step["m"], paper_step["m_j"]
    np.testing.assert_array_equal(_np(m["visible"]),
                                  np.asarray(m_j["visible"]))
    np.testing.assert_array_equal(_np(m["max_radius"]),
                                  np.asarray(m_j["max_radius"]))
    assert m["visible"].dtype == m["max_radius"].dtype == torch.int32
    want = np.asarray(m_j["uv_grad_sum"])
    assert (want > 0).sum() > 20
    assert _rel_err(_np(m["uv_grad_sum"]), want) <= 5e-4
    assert abs(float(m["total"]) - float(m_j["total"])) <= 1e-5


def _moments(opt, pool):
    return {k: (_np(opt.state[getattr(pool, k)]["exp_avg"]),
                _np(opt.state[getattr(pool, k)]["exp_avg_sq"]))
            for k in PARAM_KEYS}


def _jmoments(opt_state):
    """{leaf: (mu, nu)} of the JAX optimizer state (optax leaf order)."""
    leaves = jax.tree.leaves(opt_state)
    out = {}
    for (k, field), x in zip(ttrainer.OPT_LEAVES, leaves):
        if field in ("exp_avg", "exp_avg_sq"):
            out.setdefault(k, []).append(np.asarray(x))
    return {k: tuple(v) for k, v in out.items()}


def _check_reset(tstate, jstate, mask):
    got, want = _moments(tstate.opt_state, tstate.pool), _jmoments(
        jstate.opt_state)
    for k in PARAM_KEYS:
        for i, tol in ((0, 5e-4), (1, 1e-3)):
            g, w = got[k][i], want[k][i]
            assert (g[mask] == 0).all() and (w[mask] == 0).all(), k
            assert _rel_err(g[~mask], w[~mask]) <= tol, (k, i)
            assert np.abs(g[~mask]).max() > 0, k


@pytest.fixture(scope="module")
def ref_step():
    """One reference-mode step of both packages from the same pool and
    batch (shared: tests copy the port's state before writing it)."""
    jpool = _make_pool()
    batch = _make_batch(jpool)
    tcfg_j = gj.TrainConfig(capacity=512, batch_size=2)
    tcfg = gt.TrainConfig(capacity=512, batch_size=2)
    jstep = jtrainer.make_train_step(JPALLAS, tcfg_j)
    state_j, m_j = jstep(jtrainer.init_train_state(_make_pool(), tcfg_j),
                         batch)
    state, _ = gt.make_train_step(gt.RenderConfig(**RCFG), tcfg)(
        gt.init_train_state(_tpool(jpool), tcfg), _tbatch(batch))
    return dict(state_j=state_j, m_j=m_j, state=state, tcfg=tcfg,
                tcfg_j=tcfg_j, batch=batch, jstep=jstep)


def test_adc_step_after_one_step_matches_jax(ref_step):
    state_j, m_j = ref_step["state_j"], ref_step["m_j"]
    state = _copy_state(ref_step["state"], ref_step["tcfg"])
    # Force a prune (slot 0) in both; feed both ADCs JAX's pos gradient.
    p = dict(state_j.pool.params)
    p["opacity_raw"] = p["opacity_raw"].at[0].set(-8.0)
    state_j = jtrainer.TrainState(
        pool=jgauss.GaussianPool(params=p, alive=state_j.pool.alive),
        opt_state=state_j.opt_state, step=state_j.step)
    with torch.no_grad():
        state.pool.opacity_raw[0] = -8.0
    key = jax.random.key(1)
    thresholds = (0.01, 0.001, 0.01)
    grad = m_j["pos_grad"]
    new_j, res_j = jtrainer.adc_step(state_j, grad, key, thresholds)
    noise = torch.from_numpy(np.array(jax.random.normal(
        key, grad.shape, jnp.float32)))
    new_t, res_t = ttrainer.adc_step(state, torch.from_numpy(np.array(grad)),
                                     None, thresholds, noise=noise)
    for f in ("num_pruned", "num_split", "num_cloned", "num_overflowed"):
        assert int(getattr(res_t, f)) == int(getattr(res_j, f)), f
    assert int(res_t.num_pruned) >= 1
    assert int(res_t.num_split) + int(res_t.num_cloned) > 0
    mask = np.asarray(res_j.new_slot_mask)
    np.testing.assert_array_equal(_np(res_t.new_slot_mask), mask)
    _check_reset(new_t, new_j, mask)
    # Counts untouched (optax leaves `count` as it is).
    for st in new_t.opt_state.state.values():
        assert float(st["step"]) == 1.0


def test_adc_step_paper_after_one_step_matches_jax(paper_step):
    state, state_j = paper_step["state"], paper_step["state_j"]
    m_j, tcfg, tcfg_j = paper_step["m_j"], paper_step["tcfg"], paper_step[
        "tcfg_j"]
    uv = np.asarray(m_j["uv_grad_sum"]) / np.maximum(
        np.asarray(m_j["visible"]), 1).astype(np.float32)
    radius = np.asarray(m_j["max_radius"])
    # An extent that puts the split threshold at the median largest scale.
    big = np.exp(np.asarray(state_j.pool.params["scale_raw"])).max(-1)
    extent = float(np.median(big[np.asarray(state_j.pool.alive)])) / 0.01
    kw = dict(densify_grad_threshold=1e-4, scene_extent=extent)
    cfg_j = dataclasses.replace(tcfg_j, **kw)
    cfg_t = dataclasses.replace(tcfg, **kw)
    key = jax.random.key(4)
    new_j, res_j = jtrainer.adc_step_paper(
        state_j, jnp.asarray(uv), jnp.asarray(radius), key, cfg_j)
    k1, k2 = jax.random.split(key)
    shape = (state.pool.capacity, 3)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(
        k, shape, jnp.float32))) for k in (k1, k2))
    tstate = _copy_state(state, cfg_t)  # the fixture's state is shared
    new_t, res_t = ttrainer.adc_step_paper(
        tstate, torch.from_numpy(uv), torch.from_numpy(np.array(radius)),
        None, cfg_t,
        noise=noise)
    for f in ("num_pruned", "num_split", "num_cloned", "num_overflowed"):
        assert int(getattr(res_t, f)) == int(getattr(res_j, f)), f
    assert int(res_t.num_split) > 0 and int(res_t.num_cloned) > 0
    mask = np.asarray(res_j.new_slot_mask)
    np.testing.assert_array_equal(_np(res_t.new_slot_mask), mask)
    _check_reset(new_t, new_j, mask)


def _copy_state(state, tcfg):
    """An independent copy of a port train state (pool, moments, counts)."""
    pool = gt.pool_from_numpy({k: _np(v) for k, v in state.pool.params.items()},
                              _np(state.pool.alive), device="cpu")
    new = gt.init_train_state(pool, tcfg)
    for k in PARAM_KEYS:
        src = state.opt_state.state[getattr(state.pool, k)]
        dst = new.opt_state.state[getattr(pool, k)]
        for f in ("step", "exp_avg", "exp_avg_sq"):
            dst[f].copy_(src[f])
    return new._replace(step=state.step.clone())


# --- growth and checkpoints ------------------------------------------------------

def _jax_state_leaves(state):
    return ([np.asarray(state.step), np.asarray(state.pool.alive)]
            + [np.asarray(state.pool.params[k]) for k in PARAM_KEYS]
            + [np.asarray(x) for x in jax.tree.leaves(state.opt_state)])


def test_checkpoints_round_trip_both_ways_bit_identical(tmp_path,
                                                        paper_step):
    """JAX save -> port load -> port save -> JAX load: every leaf equal,
    dtypes included."""
    state_j, tcfg_j = paper_step["state_j"], paper_step["tcfg_j"]
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jtrainer.save_checkpoint(a, state_j)
    fresh = gt.init_train_state(
        tgauss.init_pool_from_points(np.zeros((3, 3), np.float32), 16,
                                     device="cpu"), paper_step["tcfg"])
    tstate = ttrainer.load_checkpoint(a, fresh)
    assert tstate.pool.capacity == 512 and int(tstate.step) == 1
    ttrainer.save_checkpoint(b, tstate)
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for name in fa.files:
            assert fa[name].dtype == fb[name].dtype, name
            np.testing.assert_array_equal(fa[name], fb[name], err_msg=name)
    back = jtrainer.load_checkpoint(
        b, jtrainer.init_train_state(_make_pool(), tcfg_j))
    for x, y in zip(_jax_state_leaves(back), _jax_state_leaves(state_j)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    # A file whose two pos counts differ is refused.
    with np.load(b) as fb:
        bad = dict(fb)
    bad["opt_12"] = np.asarray(7, np.int32)
    np.savez(str(tmp_path / "bad.npz"), **bad)
    with pytest.raises(ValueError, match="pos"):
        ttrainer.load_checkpoint(str(tmp_path / "bad.npz"), fresh)


def test_restored_state_continues_like_the_original(tmp_path):
    """The twin of tests/test_train.py:195 on the port."""
    jpool = _make_pool()
    batch = _tbatch(_make_batch(jpool))
    tcfg = gt.TrainConfig(capacity=512, batch_size=2)
    step = gt.make_train_step(gt.RenderConfig(**RCFG), tcfg)
    state, _ = step(gt.init_train_state(_tpool(jpool), tcfg), batch)
    path = str(tmp_path / "ckpt.npz")
    ttrainer.save_checkpoint(path, state)
    restored = ttrainer.load_checkpoint(
        path, gt.init_train_state(_tpool(_make_pool(seed=9)), tcfg))
    assert int(restored.step) == 1
    for k in PARAM_KEYS:
        assert torch.equal(getattr(restored.pool, k), getattr(state.pool, k))
    s1, m1 = step(state, batch)
    s2, m2 = step(restored, batch)
    assert float(m1["total"]) == float(m2["total"])
    for k in PARAM_KEYS:
        assert torch.equal(getattr(s1.pool, k), getattr(s2.pool, k)), k
        a = s1.opt_state.state[getattr(s1.pool, k)]
        b = s2.opt_state.state[getattr(s2.pool, k)]
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[f], b[f]), (k, f)


def test_grow_state_capacity_matches_jax(tmp_path, ref_step):
    """Both packages grow the same one-step state (carried across by a
    checkpoint): bit for bit; then one more step on each agrees as a first
    step does (loss 1e-5, gradients 5e-4 of each leaf's largest)."""
    state_j, batch, tcfg = ref_step["state_j"], ref_step["batch"], ref_step[
        "tcfg"]
    path = str(tmp_path / "s1.npz")
    jtrainer.save_checkpoint(path, state_j)
    state = ttrainer.load_checkpoint(path, gt.init_train_state(
        _tpool(_make_pool(capacity=256)), tcfg))
    grown_j = jtrainer.grow_state_capacity(state_j, 800)
    grown = ttrainer.grow_state_capacity(state, 800)
    assert ttrainer.grow_state_capacity(grown, 600) is grown
    assert grown.pool.capacity == 800 and grown.pool is not state.pool
    got = [_np(grown.step), _np(grown.pool.alive)] + [
        _np(getattr(grown.pool, k)) for k in PARAM_KEYS]
    want = _jax_state_leaves(grown_j)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    moments = _jmoments(grown_j.opt_state)
    for k, (mu, nu) in _moments(grown.opt_state, grown.pool).items():
        np.testing.assert_array_equal(mu, moments[k][0])
        np.testing.assert_array_equal(nu, moments[k][1])
        assert float(grown.opt_state.state[getattr(grown.pool, k)]["step"]) \
            == 1.0
    assert (_np(grown.pool.opacity_raw)[512:] == -10.0).all()
    # One more step on each grown state (the JAX step donates its input).
    _, m_j = ref_step["jstep"](grown_j, batch)
    _, m = gt.make_train_step(gt.RenderConfig(**RCFG), tcfg)(grown,
                                                             _tbatch(batch))
    assert abs(float(m["total"]) - float(m_j["total"])) <= 1e-5
    assert _rel_err(_np(m["pos_grad"]), m_j["pos_grad"]) <= 5e-4
    assert (_np(grown.pool.pos)[512:] == 0).all()  # dead rows do not move


def test_opt_leaf_layout_matches_optax():
    """The port's leaf order is optax's, as the JAX state lists it: the
    counts are int32 scalars and the moments have the parameters' shapes."""
    state_j = jtrainer.init_train_state(_make_pool(n=8, capacity=32),
                                        gj.TrainConfig(capacity=32))
    leaves = jax.tree.leaves(state_j.opt_state)
    assert len(leaves) == len(ttrainer.OPT_LEAVES) == 19
    for (k, field), x in zip(ttrainer.OPT_LEAVES, leaves):
        if field in ("step", "schedule_step"):
            assert x.shape == () and x.dtype == jnp.int32, (k, field)
        else:
            assert x.shape == state_j.pool.params[k].shape, (k, field)
