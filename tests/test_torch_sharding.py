"""Port parity: rendering and training over a (data, tile) process grid.

One module fixture starts a data 2 x tile 2 grid of four gloo ranks on
the CPU (``parallel.launch``, a ``file://`` store in a fresh temporary
directory, so xdist workers never share a port); each rank runs every
scenario of tests/torch_sharding_ranks.py once and saves its results.
The JAX side runs the functions of the same name on conftest's virtual
CPU devices, at tests/test_sharding.py's configuration. Bounds (JAX's
own, tests/test_sharding.py):

* the band render at tile 2 (rect and ellipse) and the batch render of
  4 poses: within 1e-6 of JAX's sharded render and of the port's
  single-rank render (``:90``, ``:632``);
* the sharded step (scan and batched, reference and paper ADC, rect and
  ellipse): loss within 1e-5; ``pos`` within 1e-6 and the other leaves
  within 2e-5 of the port's single-rank step (``:109``, ``:502``);
  against JAX's sharded step, ``pos`` within 1e-6 and the other leaves
  by the port's cross-package rule for Adam's first update
  (tests/test_torch_train.py: elementwise 1e-4 relative where the
  gradient is large, else within the learning rate), gradients within
  5e-4 of each leaf's max; ``uv_grad_sum`` within 1e-6 + 1e-4 x max;
  ``visible`` and ``max_radius`` exact; the band demands equal;
* all four ranks' parameters and Adam moments bit-identical;
* ``evaluate_views(mesh=)``: PSNR and SSIM within 1e-4 relative;
* a 3-iteration ``fit(mesh=)`` with a clone-only ADC (no random draw):
  the ADC overflow line and the alive count equal to JAX's, losses within
  1 %.

The gaussian-sharded (ZeRO-style) path, on the same spawn (and a data 1 x
tile 4 grid of the same processes), with JAX's bounds
(tests/test_sharding.py):

* the all-gather step (scan and batched, reference and paper ADC, rect
  and ellipse): every rank holds C/T rows of every capacity leaf, Adam's
  included; against the port's single-rank step the loss within 1e-5,
  ``pos`` and ``f_dc`` within 5e-6 (``:149-158``) and the other leaves
  within 2e-5 (``:571``), the paper statistics as at ``:405-420``;
  against JAX's ``make_gauss_sharded_train_step`` as the replicated step
  above;
* the ring at tile 2 and tile 4 with ``ring_capacity`` 256 below the 512
  slots: within 5e-6 of the all-gather step, ``ring_overflow`` 0; at 8,
  overflow above 0; ``batched_render`` with the ring refused
  (``:303-347``, ``:577-579``);
* ``shard_train_state`` then ``gather_train_state`` bit for bit;
  ``adc_on_shards`` bit for bit to the single-rank ADC (``:266``);
* ``fit(mesh=, gauss_sharded=True | "ring")`` at ``:192``'s configuration
  (the ADC firing): the alive count equal to the port's single-rank
  ``fit()`` and the surviving original slots' ``pos`` within 5e-4
  (``:259-263``); the clone-only fit against JAX's, as above;
* the DCP checkpoint pair: written by the four ranks' shards, read by the
  tile 4 grid and by one process, bit for bit.

The communication model (``gsplat_tpu_torch/comm_model.py``): the bytes
each rank sends through the four collective sites of
``parallel/sharding.py`` (counted by wrapping them in the same spawn,
``torch_sharding_ranks.count_collectives``) in the replicated and the
gaussian-sharded steps (scan and batched, reference and paper ADC, rect
and ellipse) and the ring at tile 2 and tile 4 equal the model's closed
forms for that grid, collective by collective, within 1 %.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu_torch as gt
from gsplat_tpu.evaluation import evaluate_views as jevaluate
from gsplat_tpu.parallel import (make_mesh, make_sharded_batch_render,
                                 make_sharded_render,
                                 make_sharded_train_step)
from gsplat_tpu.parallel.sharding import (make_gauss_sharded_train_step,
                                          shard_train_state)
from gsplat_tpu.models import GaussianPool
from gsplat_tpu.train import init_train_state
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
from gsplat_tpu_torch import comm_model
from gsplat_tpu_torch import parallel as tparallel
from gsplat_tpu_torch.parallel import launch
from gsplat_tpu_torch.train import trainer as ttrainer
from test_torch_fit import _scene
from torch_sharding_ranks import (ADC_SEED, ADC_THRESHOLDS, CAM, CFG,
                                  FIT_CFG, FIT_TRAIN, GAUSS_FIT_TRAIN,
                                  RING_CAP, STEPS, TCFG,
                                  fresh_state, run_grid, run_step,
                                  state_arrays, tie_inputs)

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

jfit = importlib.import_module("gsplat_tpu.train.fit")
# The steps also held to JAX's sharded step: scan and batched, reference
# and paper ADC (every step is held to the port's single-rank step).
JAX_STEPS = ("scan_ref", "batched_paper")


def _poses(n=4):
    out = []
    for i in range(n):
        c = np.eye(4, dtype=np.float32)
        c[0, 3] = 0.12 * i
        c[1, 3] = 0.05 * (i % 3)
        out.append(c)
    return np.stack(out)


def _pool_arrays(n=96, seed=0):
    """tests/test_sharding.py's ``_pool``, built by the port
    (``init_pool_from_points`` is held to JAX's in test_torch_adc.py)."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([
        np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(3.0, 6.0, n)], axis=-1),
        rng.uniform(0, 1, (n, 3))], axis=-1).astype(np.float32)
    pool = gt.init_pool_from_points(pts, capacity=512, seed=seed,
                                    device="cpu")
    return ({k: v.detach().numpy().copy() for k, v in pool.params.items()},
            pool.alive.numpy().copy())


def _jax_pool(inputs):
    return GaussianPool(
        params={k: jnp.asarray(v) for k, v in inputs["params"].items()},
        alive=jnp.asarray(inputs["alive"]))


def _batch(params, alive, b=4):
    """tests/test_sharding.py's ``_batch`` (targets with f_dc + 0.4),
    rendered by the port."""
    target = {k: torch.from_numpy(v) for k, v in params.items()}
    target["f_dc"] = target["f_dc"] + 0.4
    c2ws, images = [], []
    for i in range(b):
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = 0.15 * i
        with torch.no_grad():
            img, _ = gt.render_from_params(
                target, c2w, *CAM.values(), gt.RenderConfig(**CFG),
                alive=torch.from_numpy(alive))
        c2ws.append(c2w)
        images.append(img.numpy())
    return {"image": np.stack(images), "c2w": np.stack(c2ws),
            **{k: np.full((b,), v, np.float32) for k, v in CAM.items()}}


@pytest.fixture(scope="module")
def inputs():
    params, alive = _pool_arrays()
    batch = _batch(params, alive)
    views = [{"image": batch["image"][i], "c2w": batch["c2w"][i], **CAM}
             for i in range(4)]
    pts, fit_batches = _scene()
    # tests/test_sharding.py:192's fit: two views of _batch, its cloud.
    rng = np.random.default_rng(0)
    gauss_pts = np.concatenate([
        np.stack([rng.uniform(-1.5, 1.5, 96), rng.uniform(-1.5, 1.5, 96),
                  rng.uniform(3.0, 6.0, 96)], axis=-1),
        rng.uniform(0, 1, (96, 3))], axis=-1).astype(np.float32)
    return {
        "gauss_fit_batch": _batch(params, alive, b=2),
        "gauss_fit_points": gauss_pts,
        "params": params,
        "alive": alive,
        "batch": batch,
        "poses": _poses(),
        "views": views,
        "fit_points": pts,
        "fit_batches": [fit_batches[i % 2] for i in range(3)],
    }


@pytest.fixture(scope="module")
def grid(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("grid")
    launch(run_grid, 4, backend="gloo", device="cpu",
           args=(inputs, str(out)))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    assert [r["coord"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        r["out_dir"] = out
    return ranks


def _single_render(inputs, c2w, cull="rect"):
    p = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}
    with torch.no_grad():
        img, _ = gt.render_from_params(
            p, c2w, *CAM.values(), gt.RenderConfig(**CFG, cull_mode=cull),
            alive=torch.from_numpy(inputs["alive"]))
    return img.numpy()


def _max_abs(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("cull", ["rect", "ellipse"])
def test_band_render_matches_jax_and_single_rank(grid, inputs, cull):
    jp = _jax_pool(inputs)
    mesh = make_mesh(n_devices=2, data=1, tile=2)
    want = make_sharded_render(gj.RenderConfig(**CFG, cull_mode=cull),
                               mesh)(jp.params, jp.alive, jnp.eye(4),
                                     *CAM.values())
    single = _single_render(inputs, np.eye(4, dtype=np.float32), cull)
    for r in grid:
        got = r["render_" + cull]
        assert got.shape == (64, 64, 3)
        assert _max_abs(got, want) <= 1e-6
        assert _max_abs(got, single) <= 1e-6
        np.testing.assert_array_equal(got, grid[0]["render_" + cull])


def test_batch_render_matches_jax_and_per_pose(grid, inputs):
    jp = _jax_pool(inputs)
    mesh = make_mesh(n_devices=4, data=2, tile=2)
    want = make_sharded_batch_render(gj.RenderConfig(**CFG), mesh)(
        jp.params, jp.alive, jnp.asarray(inputs["poses"]), *CAM.values())
    per_pose = np.stack([_single_render(inputs, c) for c in inputs["poses"]])
    for r in grid:
        assert r["batch_render"].shape == (4, 64, 64, 3)
        assert _max_abs(r["batch_render"], want) <= 1e-6
        assert _max_abs(r["batch_render"], per_pose) <= 1e-6
        assert "not divisible" in r["batch_indivisible"]


def _jax_step(inputs, tkw, cull):
    tcfg = gj.TrainConfig(**TCFG, **tkw)
    cfg = gj.RenderConfig(**CFG, cull_mode=cull)
    mesh = make_mesh(n_devices=4, data=2, tile=2)
    state = init_train_state(_jax_pool(inputs), tcfg)
    state, m = make_sharded_train_step(cfg, tcfg, mesh)(
        state, {k: jnp.asarray(v) for k, v in inputs["batch"].items()})
    return ({k: np.asarray(v) for k, v in state.pool.params.items()},
            {k: np.asarray(v) for k, v in m.items()})


def _lrs(tcfg):
    return {"pos": tcfg.position_lr_init * 0.01,
            "opacity_raw": tcfg.opacity_lr, "f_dc": tcfg.feature_lr,
            "f_rest": tcfg.feature_lr / 20.0, "scale_raw": tcfg.scaling_lr,
            "q_raw": tcfg.rotation_lr}


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_step_matches_jax_and_single_rank(grid, inputs, name):
    tkw, cull = STEPS[name]
    paper = tkw.get("adc_mode") == "paper"
    st, m, _ = grid[0]["step_" + name]
    # All four ranks hold the same state, bit for bit.
    for r in grid[1:]:
        for k, v in r["step_" + name][0].items():
            np.testing.assert_array_equal(v, st[k], err_msg=k)
    # Against the port's single-rank step (JAX's own sharded-vs-single
    # bounds). The single-rank step renders rect: the ellipse's culled
    # tiles carry zero alpha (tests/test_sharding.py:581).
    st1, m1, g1 = run_step(inputs, None, tkw, "rect")
    assert abs(float(m["total"]) - float(m1["total"])) <= 1e-5
    for k in PARAM_KEYS:
        tol = 1e-6 if k == "pos" else 2e-5
        assert _max_abs(st[k], st1[k]) <= tol, k
    if name not in JAX_STEPS:
        return
    # Against JAX's sharded step. Adam's first update is about lr sign(g):
    # compared elementwise where the port's single-rank gradient is large.
    jst, jm = _jax_step(inputs, tkw, cull)
    old = inputs["params"]
    assert abs(float(m["total"]) - float(jm["total"])) <= 1e-5
    assert int(m["max_band_pairs"]) == int(jm["max_band_pairs"])
    assert int(m["band_pair_capacity"]) == int(jm["band_pair_capacity"])
    if cull == "ellipse":
        assert int(m["row_demand"]) == int(jm["row_demand"]) > 0
        assert int(m["row_capacity"]) == int(jm["row_capacity"])
    _check_first_update(st, jst, m["pos_grad"], jm["pos_grad"], g1, old,
                        tkw)
    if paper:
        for ref in (jm, m1) if name in JAX_STEPS else (m1,):
            a, b = np.asarray(ref["uv_grad_sum"]), m["uv_grad_sum"]
            assert a.max() > 0
            assert _max_abs(a, b) <= 1e-6 + 1e-4 * float(np.abs(a).max())
            np.testing.assert_array_equal(m["visible"], ref["visible"])
            np.testing.assert_array_equal(m["max_radius"],
                                          ref["max_radius"])


def _check_first_update(st, jst, g, gw, g1, old, tkw):
    """The port's first update against JAX's: the position gradients
    within 5e-4 of JAX's max, ``pos`` within 1e-6, the other leaves by
    the cross-package rule (elementwise 1e-4 relative where the port's
    single-rank gradient ``g1`` is large, every update within its lr)."""
    assert _max_abs(g, gw) <= 5e-4 * float(np.abs(gw).max())
    lrs = _lrs(gt.TrainConfig(**TCFG, **tkw))
    for k in PARAM_KEYS:
        if k == "pos":
            assert _max_abs(st[k], jst[k]) <= 1e-6
            continue
        d_t, d_j = st[k] - old[k], jst[k] - old[k]
        big = np.abs(g1[k]) > 1e-3 * np.abs(g1[k]).max()
        assert big.any(), k
        np.testing.assert_allclose(d_t[big], d_j[big], rtol=1e-4, atol=0,
                                   err_msg=k)
        assert (np.abs(d_t) <= lrs[k] * (1 + 1e-6)
                + np.spacing(np.abs(old[k]))).all(), k


def test_evaluate_views_mesh_matches_jax_and_single_rank(grid, inputs):
    jp = _jax_pool(inputs)
    views = inputs["views"]
    mesh = make_mesh(n_devices=4, data=2, tile=2)
    want = jevaluate(jp.params, views, gj.RenderConfig(**CFG),
                     alive=jp.alive, mesh=mesh)
    p = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}
    single = gt.evaluation.evaluate_views(
        p, views, gt.RenderConfig(**CFG),
        alive=torch.from_numpy(inputs["alive"]))
    for r in grid:
        got = r["eval"]
        assert got["num_views"] == want["num_views"] == 4
        for ref in (want, single):
            np.testing.assert_allclose(got["psnr"], ref["psnr"], rtol=1e-4)
            np.testing.assert_allclose(got["ssim"], ref["ssim"], rtol=1e-4)
        assert got == grid[0]["eval"]


def test_fit_mesh_matches_jax(grid, inputs):
    logs = []
    jstate, jrep = jfit.fit(
        iter(inputs["fit_batches"]),
        gj.RenderConfig(**FIT_CFG, backend="pallas"),
        gj.TrainConfig(**FIT_TRAIN), initial_points=inputs["fit_points"],
        mesh=make_mesh(n_devices=4, data=2, tile=2), log_every=1,
        log_fn=logs.append)
    got = grid[0]["fit"]
    adc = [m for m in logs if "ADC overflow" in m]
    assert adc and adc == [m for m in got["logs"] if "ADC overflow" in m]
    assert got["num_gaussians"] == jrep.num_gaussians
    assert got["overflow_events"] == jrep.overflow_events
    assert [it for it, _ in got["losses"]] == [it for it, _ in jrep.losses]
    for (it, a), (_, b) in zip(got["losses"], jrep.losses):
        assert abs(a - b) <= 0.01 * b, (it, a, b)
    # Ranks other than 0 log nothing; every rank holds the same state.
    for r in grid[1:]:
        assert r["fit"]["logs"] == []
        for k, v in r["fit"]["state"].items():
            np.testing.assert_array_equal(v, got["state"][k], err_msg=k)
    np.testing.assert_array_equal(got["state"]["pos"].shape,
                                  np.asarray(jstate.pool.params["pos"]).shape)


# --------------------------------------------------------------------------
# The gaussian-sharded (ZeRO-style) path.
# --------------------------------------------------------------------------


def _rows(grid, res_key, idx, key, data=0, ranks=2):
    """The tile ranks' rows of a per-gaussian result, concatenated in
    tile order (the data replica ``data`` of a tile-``ranks`` grid)."""
    return np.concatenate([grid[data * ranks + t][res_key][idx][key]
                           for t in range(ranks)])


def _jax_gauss_step(inputs, tkw, cull):
    tcfg = gj.TrainConfig(**TCFG, **tkw)
    mesh = make_mesh(n_devices=4, data=2, tile=2)
    state = shard_train_state(init_train_state(_jax_pool(inputs), tcfg),
                              mesh)
    state, m = make_gauss_sharded_train_step(
        gj.RenderConfig(**CFG, cull_mode=cull), tcfg, mesh)(
            state, {k: jnp.asarray(v) for k, v in inputs["batch"].items()})
    return ({k: np.asarray(v) for k, v in state.pool.params.items()},
            {k: np.asarray(v) for k, v in m.items()})


@pytest.mark.parametrize("name", list(STEPS))
def test_gauss_sharded_step_matches_jax_and_single_rank(grid, inputs, name):
    tkw, cull = STEPS[name]
    paper = tkw.get("adc_mode") == "paper"
    key = "gauss_" + name
    st, m, _ = grid[0][key]
    half = TCFG["capacity"] // 2
    for r in grid:
        # Each rank holds its 256 of the 512 rows of every capacity leaf.
        assert set(r[key][2].values()) == {half}
        assert len(r[key][2]) == 1 + 3 * len(PARAM_KEYS)
        for k, v in r[key][0].items():
            np.testing.assert_array_equal(v, st[k], err_msg=k)
    st1, m1, g1 = run_step(inputs, None, tkw, "rect")
    assert abs(float(m["total"]) - float(m1["total"])) <= 1e-5
    for k in PARAM_KEYS:
        tol = 5e-6 if k in ("pos", "f_dc") else 2e-5
        assert _max_abs(st[k], st1[k]) <= tol, k
    assert int(m["ring_overflow"]) == 0
    assert int(m["max_band_pairs"]) <= int(m["band_pair_capacity"])
    if cull == "ellipse":
        assert 0 < int(m["row_demand"]) <= int(m["row_capacity"])
    refs = [m1]
    if name in JAX_STEPS:
        jst, jm = _jax_gauss_step(inputs, tkw, cull)
        assert abs(float(m["total"]) - float(jm["total"])) <= 1e-5
        assert int(m["max_band_pairs"]) == int(jm["max_band_pairs"])
        assert int(m["band_pair_capacity"]) == int(jm["band_pair_capacity"])
        assert int(jm["ring_overflow"]) == 0
        _check_first_update(st, jst, _rows(grid, key, 1, "pos_grad"),
                            jm["pos_grad"], g1, inputs["params"], tkw)
        refs.append(jm)
    if paper:
        for ref in refs:
            a = np.asarray(ref["uv_grad_sum"])
            b = _rows(grid, key, 1, "uv_grad_sum")
            assert a.max() > 0
            assert _max_abs(a, b) <= 1e-6 + 1e-4 * float(np.abs(a).max())
            np.testing.assert_array_equal(_rows(grid, key, 1, "visible"),
                                          ref["visible"])
            np.testing.assert_array_equal(_rows(grid, key, 1, "max_radius"),
                                          ref["max_radius"])


@pytest.mark.parametrize("ring,ag", [("ring2", "scan_ref"), ("ring4", "ag4")])
def test_ring_matches_all_gather(grid, ring, ag):
    """The ring with 256-row buffers (below the 512 slots) against the
    all-gather step on the same grid."""
    st, m = grid[0]["gauss_" + ring][:2]
    sa, ma = grid[0]["gauss_" + ag][:2]
    assert int(m["ring_overflow"]) == 0
    assert abs(float(m["total"]) - float(ma["total"])) <= 1e-5
    for k in PARAM_KEYS:
        assert _max_abs(st[k], sa[k]) <= 5e-6, k
    for r in grid[1:]:
        for k, v in r["gauss_" + ring][0].items():
            np.testing.assert_array_equal(v, st[k], err_msg=k)


def test_ring_breaks_depth_ties_as_the_all_gather(grid, inputs):
    """Copies of 48 gaussians in another shard tie in depth with their
    originals: the ring's images equal the all-gather's bit for bit (its
    buffer goes back to the pool's slot order), and the single-rank
    render's, which breaks ties by slot, within 1e-6."""
    params, alive = tie_inputs(inputs)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    with torch.no_grad():
        want = np.stack([gt.render_from_params(
            p, c, *CAM.values(), gt.RenderConfig(**CFG),
            alive=torch.from_numpy(alive))[0].numpy()
            for c in inputs["batch"]["c2w"]])
    for r in grid:
        np.testing.assert_array_equal(r["ties_ring"], r["ties_ag"])
        assert _max_abs(r["ties_ring"], want) <= 1e-6


def test_ring_overflow_reported_and_batched_refused(grid):
    assert all(int(r["gauss_ring4_starved"][1]["ring_overflow"]) > 0
               for r in grid)
    assert RING_CAP < TCFG["capacity"]
    with pytest.raises(ValueError, match="ring"):
        tparallel.make_gauss_sharded_train_step(
            gt.RenderConfig(**CFG), gt.TrainConfig(batched_render=True),
            None, ring=True)


def test_shard_then_gather_is_identity(grid, inputs):
    want = state_arrays(fresh_state(inputs, gt.TrainConfig(**TCFG),
                                    moments_seed=1))
    for r in grid:
        for k, v in want.items():
            np.testing.assert_array_equal(r["roundtrip"][k], v, err_msg=k)
        assert "does not split" in r["indivisible"]


@pytest.mark.parametrize("mode", ["reference", "paper"])
def test_adc_on_sharded_pool_matches_single_rank(grid, inputs, mode):
    n = TCFG["capacity"]
    rng = np.random.default_rng(5)
    grad = torch.from_numpy(rng.uniform(0, 2e-3, n).astype(np.float32))
    rad = torch.from_numpy(rng.integers(0, 9, n).astype(np.int32))
    tcfg = gt.TrainConfig(**TCFG, adc_mode=mode, densify_grad_threshold=1e-3)
    state = fresh_state(inputs, tcfg, moments_seed=2)
    gen = torch.Generator().manual_seed(ADC_SEED)
    if mode == "reference":
        state, res = ttrainer.adc_step(state, grad, gen, ADC_THRESHOLDS)
    else:
        state, res = ttrainer.adc_step_paper(state, grad, rad, gen, tcfg)
    want = state_arrays(state)
    counts = [int(getattr(res, f)) for f in (
        "num_pruned", "num_split", "num_cloned", "num_overflowed")]
    assert counts[1] + counts[2] > 0
    mask = res.new_slot_mask.numpy()
    for r in grid:
        got = r["adc_" + mode]
        assert got["counts"] == counts
        assert got["rows"] == n // 4
        assert int(got["alive"]) == int(state.pool.num_alive())
        for k, v in want.items():
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)
    np.testing.assert_array_equal(np.concatenate(
        [grid[t]["adc_" + mode]["new_slot_mask"] for t in range(4)]), mask)


@pytest.mark.parametrize("tag", ["fit_gauss", "fit_ring"])
def test_gauss_sharded_fit_matches_single_rank(grid, inputs, tag):
    st1, rep1 = gt.fit(iter([inputs["gauss_fit_batch"]] * 12),
                       gt.RenderConfig(**CFG),
                       gt.TrainConfig(**GAUSS_FIT_TRAIN),
                       initial_points=inputs["gauss_fit_points"],
                       log_every=4, log_fn=lambda s: None, device="cpu")
    got = grid[0][tag]
    n1 = int(st1.pool.num_alive())
    assert n1 > 96, "densification never fired"
    assert got["num_gaussians"] == n1
    both = got["alive"] & st1.pool.alive.numpy()
    both[96:] = False
    assert both.sum() > 90
    assert _max_abs(got["state"]["pos"][both],
                    st1.pool.pos.detach().numpy()[both]) <= 5e-4
    assert [it for it, _ in got["losses"]] == [it for it, _ in rep1.losses]
    assert not any("ring-stream overflow" in x for x in got["logs"])
    for r in grid[1:]:
        assert r[tag]["logs"] == []
        for k, v in r[tag]["state"].items():
            np.testing.assert_array_equal(v, got["state"][k], err_msg=k)
    if tag == "fit_gauss":
        # Rank 0 wrote the gathered state (the npz layout).
        ck = grid[0]["out_dir"] / tag / "checkpoint_final.npz"
        pool = gt.restore_pool(ck, device="cpu")
        for k in PARAM_KEYS:
            np.testing.assert_array_equal(getattr(pool, k).detach().numpy(),
                                          got["state"][k], err_msg=k)
        np.testing.assert_array_equal(pool.alive.numpy(), got["alive"])


def test_gauss_sharded_fit_matches_jax(grid, inputs):
    logs = []
    _, jrep = jfit.fit(
        iter(inputs["fit_batches"]),
        gj.RenderConfig(**FIT_CFG, backend="pallas"),
        gj.TrainConfig(**FIT_TRAIN), initial_points=inputs["fit_points"],
        mesh=make_mesh(n_devices=4, data=2, tile=2), gauss_sharded=True,
        log_every=1, log_fn=logs.append)
    got = grid[0]["fit_clone"]
    adc = [m for m in logs if "ADC overflow" in m]
    assert adc and adc == [m for m in got["logs"] if "ADC overflow" in m]
    assert got["num_gaussians"] == jrep.num_gaussians
    assert got["overflow_events"] == jrep.overflow_events
    assert [it for it, _ in got["losses"]] == [it for it, _ in jrep.losses]
    for (it, a), (_, b) in zip(got["losses"], jrep.losses):
        assert abs(a - b) <= 0.01 * b, (it, a, b)


def test_dcp_checkpoint_loads_into_any_grid_and_one_process(grid, inputs):
    saved = grid[0]["dcp_saved"]
    for r in grid:
        assert r["dcp_step"] == 1
        for k, v in saved.items():
            np.testing.assert_array_equal(r["dcp_saved"][k], v, err_msg=k)
            np.testing.assert_array_equal(r["dcp_loaded4"][k], v, err_msg=k)
    state = ttrainer.load_checkpoint_dcp(
        grid[0]["out_dir"] / "dcp",
        fresh_state(inputs, gt.TrainConfig(**TCFG)))
    assert int(state.step) == 1
    for k, v in state_arrays(state).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)


# (the rank's result key, the model's family, its grid (data, tile), paper)
COUNTED = {f"step_{k}": ("band", (2, 2), v[0].get("adc_mode") == "paper")
           for k, v in STEPS.items()}
COUNTED.update({f"gauss_{k}": ("gauss", (2, 2),
                               v[0].get("adc_mode") == "paper")
                for k, v in STEPS.items()})
COUNTED.update({"ring2": ("ring", (2, 2), False),
                "ring4": ("ring", (1, 4), False),
                "ring4_starved": ("ring", (1, 4), False)})


@pytest.mark.parametrize("case", list(COUNTED))
def test_comm_model_matches_counted_bytes(grid, case):
    """Every rank's bytes through each collective in one step equal the
    model's volume for the grid, collective by collective, within 1 %
    (the clip's and the NaN guard's scalar reductions included)."""
    family, (n_data, n_tile), paper = COUNTED[case]
    want = comm_model.step_volumes(
        family, TCFG["batch_size"], CFG["height"], CFG["width"],
        TCFG["capacity"], n_data, n_tile, paper=paper)["kinds"]
    for r in grid:
        got = r["bytes_" + case]
        assert set(got) == set(want)
        for kind, w in want.items():
            assert abs(got[kind] - w) <= 0.01 * w, (r["coord"], kind,
                                                    got[kind], w)
        assert sum(got.values()) > 0
