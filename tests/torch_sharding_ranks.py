"""The rank side of tests/test_torch_sharding.py (imported by the spawned
gloo ranks, so it imports torch and the port only, never JAX).

:func:`run_grid` runs every scenario once on one rank of a data 2 x tile 2
grid of CPU processes (and, for the gaussian-sharded path, of a data 1 x
tile 4 grid of the same processes) and writes that rank's results to
``<out_dir>/rank<r>.pt`` (numpy arrays, ints and strings).
:func:`run_cli_grid` is the rank side of tests/test_torch_cli.py's
gaussian-sharded train CLI runs.
"""

import contextlib
import os

import numpy as np
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch.evaluation import evaluate_views
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
from gsplat_tpu_torch.parallel import (adc_on_shards, gather_train_state,
                                       local_batch,
                                       make_gauss_sharded_render,
                                       make_gauss_sharded_train_step,
                                       make_mesh, make_sharded_batch_render,
                                       make_sharded_render,
                                       make_sharded_train_step, num_alive,
                                       shard_rows, shard_train_state)
from gsplat_tpu_torch.parallel import sharding
from gsplat_tpu_torch.parallel.mesh import TILE_AXIS, cli_rank
from gsplat_tpu_torch.train import __main__ as train_cli
from gsplat_tpu_torch.train import trainer

# tests/test_sharding.py's configuration.
CFG = dict(height=64, width=64, max_pairs=4096, max_per_tile=128,
           tile_chunk=8)
TCFG = dict(capacity=512, batch_size=4)
CAM = dict(fx=60.0, fy=60.0, cx=32.0, cy=32.0)
# Scan and batched, reference and paper ADC, rect and ellipse.
STEPS = {
    "scan_ref": (dict(), "rect"),
    "batched_paper": (dict(adc_mode="paper", batched_render=True), "rect"),
    "scan_paper_ellipse": (dict(adc_mode="paper"), "ellipse"),
    "batched_ref_ellipse": (dict(batched_render=True), "ellipse"),
}
FIT_TRAIN = dict(iterations=3, batch_size=2, capacity=64,
                 densification_interval=2, densify_until_iter=12,
                 max_grad=1e-9, scale_threshold=1e3,
                 opacity_reset_interval=10_000, checkpoint_interval=10_000)
FIT_CFG = dict(height=48, width=48, max_pairs=2048, pair_block=32)
# The ring at tile 2 and tile 4 below the pool's 512 slots, and starved.
RING_CAP, RING_STARVED = 256, 8
# tests/test_sharding.py:192's fit (the reference ADC firing).
GAUSS_FIT_TRAIN = dict(iterations=12, batch_size=2, capacity=512,
                       densification_interval=4, densify_until_iter=12,
                       opacity_reset_interval=10_000,
                       checkpoint_interval=10_000, max_grad=1e-4)
# adc_step's thresholds and statistic (tests/test_sharding.py:266).
ADC_THRESHOLDS, ADC_SEED = (0.01, 1e-3, 0.01), 3


@contextlib.contextmanager
def count_collectives(out: dict):
    """Wrap the four collective sites of ``parallel/sharding.py``
    (``_reduce``, ``_all_gather``, ``_reduce_scatter_rows``, ``_permute``)
    and add to ``out[kind]`` the bytes this rank sends through each, by the
    ring algorithms' counts over the k ranks of the call: an all-reduce of
    S bytes 2 (k - 1) S / k, an all-gather of a shard of s bytes (k - 1) s,
    a reduce-scatter of S bytes (k - 1) S / k, a permute its tensor."""
    real = {k: getattr(sharding, k) for k in (
        "_reduce", "_all_gather", "_reduce_scatter_rows", "_permute")}
    for k in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all"):
        out.setdefault(k, 0.0)

    def nbytes(t):
        return t.numel() * t.element_size()

    def reduce(t, group, n, op=torch.distributed.ReduceOp.SUM):
        if n > 1:
            out["all_reduce"] += 2 * (n - 1) / n * nbytes(t)
        return real["_reduce"](t, group, n, op)

    def all_gather(x, group, n, axis):
        if n > 1:
            out["all_gather"] += (n - 1) * nbytes(x)
        return real["_all_gather"](x, group, n, axis)

    def reduce_scatter_rows(g, mesh):
        n = mesh.shape[TILE_AXIS]
        if n > 1:
            out["reduce_scatter"] += (n - 1) / n * nbytes(g)
        return real["_reduce_scatter_rows"](g, mesh)

    def permute(x, mesh, shift):
        if shift % mesh.shape[TILE_AXIS]:
            out["all_to_all"] += nbytes(x)
        return real["_permute"](x, mesh, shift)

    wrapped = {"_reduce": reduce, "_all_gather": all_gather,
               "_reduce_scatter_rows": reduce_scatter_rows,
               "_permute": permute}
    try:
        for k, fn in wrapped.items():
            setattr(sharding, k, fn)
        yield out
    finally:
        for k, fn in real.items():
            setattr(sharding, k, fn)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def state_arrays(state) -> dict:
    """Parameters, Adam moments and counts of a train state, as numpy."""
    out = {}
    opt = state.opt_state
    for k in PARAM_KEYS:
        p = state.pool.params[k]
        st = opt.state[p]
        out[k] = _np(p).copy()
        out[k + ".m"] = _np(st["exp_avg"]).copy()
        out[k + ".v"] = _np(st["exp_avg_sq"]).copy()
        out[k + ".n"] = _np(st["step"]).copy()
    return out


def run_step(inp, mesh, tkw, cull, counted=None):
    """One sharded (``mesh``) or single-device (None) step from a fresh
    state: (state arrays, metrics, the clipped and masked gradients the
    update applied), as numpy. ``counted``: a dict that gets the bytes
    this rank sends in the step (:func:`count_collectives`)."""
    cfg = gt.RenderConfig(**CFG, cull_mode=cull)
    tcfg = gt.TrainConfig(**TCFG, **tkw)
    pool = gt.pool_from_numpy(inp["params"], inp["alive"], device="cpu")
    state = gt.init_train_state(pool, tcfg)
    batch = {k: torch.from_numpy(v.copy()) for k, v in inp["batch"].items()}
    if mesh is None:
        state, m = gt.make_train_step(cfg, tcfg)(state, batch)
    else:
        step = make_sharded_train_step(cfg, tcfg, mesh)
        batch = local_batch(batch, mesh)
        with count_collectives({} if counted is None else counted):
            state, m = step(state, batch)
    grads = {k: _np(p.grad).copy() for k, p in state.pool.params.items()}
    return state_arrays(state), {k: _np(v) for k, v in m.items()}, grads


def capacity_shapes(state) -> dict:
    """The local row counts of every capacity leaf (params, alive, Adam's
    moments)."""
    opt = state.opt_state
    out = {"alive": state.pool.alive.shape[0]}
    for k in PARAM_KEYS:
        p = state.pool.params[k]
        out[k] = p.shape[0]
        out[k + ".m"] = opt.state[p]["exp_avg"].shape[0]
        out[k + ".v"] = opt.state[p]["exp_avg_sq"].shape[0]
    return out


def fresh_state(inp, tcfg, moments_seed=None):
    """The input pool's train state on the CPU; with ``moments_seed`` its
    Adam moments are seeded non-zero (so that a moment reset shows)."""
    pool = gt.pool_from_numpy(inp["params"], inp["alive"], device="cpu")
    state = gt.init_train_state(pool, tcfg)
    if moments_seed is not None:
        r = np.random.default_rng(moments_seed)
        with torch.no_grad():
            for p in pool.params.values():
                for key in ("exp_avg", "exp_avg_sq"):
                    m = state.opt_state.state[p][key]
                    m.copy_(torch.from_numpy(r.uniform(
                        0, 1e-3, tuple(m.shape)).astype(np.float32)))
    return state


def run_gauss_step(inp, mesh, tkw, cull="rect", ring=False,
                   ring_capacity=None, counted=None):
    """One gaussian-sharded step from the sharded fresh state: (the
    gathered state's arrays, the metrics (this rank's rows where
    per-gaussian), the capacity leaves' local row counts). ``counted``: a
    dict that gets the bytes this rank sends in the step."""
    cfg = gt.RenderConfig(**CFG, cull_mode=cull)
    tcfg = gt.TrainConfig(**TCFG, **tkw)
    state = shard_train_state(fresh_state(inp, tcfg), mesh)
    batch = {k: torch.from_numpy(v.copy()) for k, v in inp["batch"].items()}
    step = make_gauss_sharded_train_step(cfg, tcfg, mesh, ring=ring,
                                         ring_capacity=ring_capacity)
    batch = local_batch(batch, mesh)
    with count_collectives({} if counted is None else counted):
        state, m = step(state, batch)
    return (state_arrays(gather_train_state(state, mesh)),
            {k: _np(v) for k, v in m.items()}, capacity_shapes(state))


def tie_inputs(inp):
    """The input pool with slots 0-47 copied to slots 300-347 (another
    shard at tile 2 and 4) in other colours: the copies tie in depth with
    their originals, so the order the exchange leaves them in shows."""
    params = {k: v.copy() for k, v in inp["params"].items()}
    alive = inp["alive"].copy()
    src, dst = slice(0, 48), slice(300, 348)
    for v in params.values():
        v[dst] = v[src]
    params["f_dc"][dst] = params["f_dc"][src][:, ::-1] + 0.3
    alive[dst] = True
    return params, alive


def run_gauss(inp, mesh, mesh4, out_dir):
    """Every gaussian-sharded scenario on this rank."""
    res = {}
    # Depth ties across shards: the ring's image against the all-gather's.
    params, alive = tie_inputs(inp)
    rows = shard_rows(TCFG["capacity"], mesh4)
    views = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    for tag, ring in (("ag", False), ("ring", True)):
        fn = make_gauss_sharded_render(gt.RenderConfig(**CFG), mesh4,
                                       ring=ring, ring_capacity=RING_CAP)
        res["ties_" + tag] = _np(fn(
            {k: torch.from_numpy(v)[rows] for k, v in params.items()},
            torch.from_numpy(alive)[rows], views)[0])
    for name, (tkw, cull) in STEPS.items():
        counted = res.setdefault("bytes_gauss_" + name, {})
        res["gauss_" + name] = run_gauss_step(inp, mesh, tkw, cull,
                                              counted=counted)
    res["gauss_ag4"] = run_gauss_step(inp, mesh4, {})
    for tag, m, cap in (("ring2", mesh, RING_CAP), ("ring4", mesh4, RING_CAP),
                        ("ring4_starved", mesh4, RING_STARVED)):
        counted = res.setdefault("bytes_" + tag, {})
        res["gauss_" + tag] = run_gauss_step(inp, m, {}, ring=True,
                                             ring_capacity=cap,
                                             counted=counted)
    # shard -> gather is the identity; a capacity T does not divide raises.
    tcfg = gt.TrainConfig(**TCFG)
    state = fresh_state(inp, tcfg, moments_seed=1)
    res["roundtrip"] = state_arrays(gather_train_state(
        shard_train_state(state, mesh4), mesh4))
    try:
        shard_rows(510, mesh4)
    except ValueError as e:
        res["indivisible"] = str(e)
    # The ADC on a sharded pool (both forms), one generator seed a rank.
    n = TCFG["capacity"]
    r = np.random.default_rng(5)
    grad = torch.from_numpy(r.uniform(0, 2e-3, n).astype(np.float32))
    rad = torch.from_numpy(r.integers(0, 9, n).astype(np.int32))
    rows = shard_rows(n, mesh4)
    for mode in ("reference", "paper"):
        tcfg = gt.TrainConfig(**TCFG, adc_mode=mode,
                              densify_grad_threshold=1e-3)
        state = shard_train_state(fresh_state(inp, tcfg, moments_seed=2),
                                  mesh4)
        gen = torch.Generator().manual_seed(ADC_SEED)
        if mode == "reference":
            def adc(st, g):
                return trainer.adc_step(st, g, gen, ADC_THRESHOLDS)
            state, result = adc_on_shards(state, mesh4, adc, grad[rows])
        else:
            def adc(st, g, rr):
                return trainer.adc_step_paper(st, g, rr, gen, tcfg)
            state, result = adc_on_shards(state, mesh4, adc, grad[rows],
                                          rad[rows])
        res["adc_" + mode] = {
            "state": state_arrays(gather_train_state(state, mesh4)),
            "alive": _np(num_alive(state.pool, mesh4)),
            "counts": [int(getattr(result, f)) for f in (
                "num_pruned", "num_split", "num_cloned", "num_overflowed")],
            "new_slot_mask": _np(result.new_slot_mask).copy(),
            "rows": state.pool.capacity}
    # fit(mesh=, gauss_sharded=True | "ring"), tests/test_sharding.py:192.
    for tag, how in (("fit_gauss", True), ("fit_ring", "ring")):
        logs = []
        batches = iter([inp["gauss_fit_batch"]] * 12)
        fit_out = os.path.join(out_dir, tag) if tag == "fit_gauss" else None
        st, rep = gt.fit(batches, gt.RenderConfig(**CFG),
                         gt.TrainConfig(**GAUSS_FIT_TRAIN),
                         initial_points=inp["gauss_fit_points"], mesh=mesh,
                         gauss_sharded=how, log_every=4, log_fn=logs.append,
                         output_dir=fit_out)
        res[tag] = {"logs": logs, "losses": rep.losses,
                    "num_gaussians": rep.num_gaussians,
                    "alive": _np(st.pool.alive).copy(),
                    "state": state_arrays(st)}
    # The clone-only fit held to JAX's (run_grid's fit scenario, sharded).
    logs = []
    st, rep = gt.fit(iter(inp["fit_batches"]), gt.RenderConfig(**FIT_CFG),
                     gt.TrainConfig(**FIT_TRAIN),
                     initial_points=inp["fit_points"], mesh=mesh,
                     gauss_sharded=True, log_every=1, log_fn=logs.append)
    res["fit_clone"] = {"logs": logs, "losses": rep.losses,
                        "overflow_events": rep.overflow_events,
                        "num_gaussians": rep.num_gaussians}
    # The DCP pair: the four ranks save the data 2 x tile 2 shards of a
    # trained state; the tile 4 grid loads them.
    tcfg = gt.TrainConfig(**TCFG)
    state = shard_train_state(fresh_state(inp, tcfg, moments_seed=3), mesh)
    batch = {k: torch.from_numpy(v.copy()) for k, v in inp["batch"].items()}
    state, _ = make_gauss_sharded_train_step(
        gt.RenderConfig(**CFG), tcfg, mesh)(state, local_batch(batch, mesh))
    ckpt = os.path.join(out_dir, "dcp")
    trainer.save_checkpoint_dcp(ckpt, state, mesh)
    res["dcp_saved"] = state_arrays(gather_train_state(state, mesh))
    tmpl = shard_train_state(fresh_state(inp, tcfg), mesh4)
    loaded = trainer.load_checkpoint_dcp(ckpt, tmpl, mesh4)
    res["dcp_loaded4"] = state_arrays(gather_train_state(loaded, mesh4))
    res["dcp_step"] = int(loaded.step)
    return res


def run_grid(inp, out_dir):
    torch.set_num_threads(1)
    mesh = make_mesh(data=2, tile=2, device="cpu")
    res = {"coord": mesh.coord}
    params = {k: torch.from_numpy(v) for k, v in inp["params"].items()}
    alive = torch.from_numpy(inp["alive"])
    for cull in ("rect", "ellipse"):
        fn = make_sharded_render(gt.RenderConfig(**CFG, cull_mode=cull),
                                 mesh)
        res["render_" + cull] = _np(fn(params, alive, np.eye(4), *CAM.values()))
    bfn = make_sharded_batch_render(gt.RenderConfig(**CFG), mesh)
    res["batch_render"] = _np(bfn(params, alive, inp["poses"],
                                  *CAM.values()))
    try:
        bfn(params, alive, inp["poses"][:3], *CAM.values())
    except ValueError as e:
        res["batch_indivisible"] = str(e)
    for name, (tkw, cull) in STEPS.items():
        counted = res.setdefault("bytes_step_" + name, {})
        res["step_" + name] = run_step(inp, mesh, tkw, cull, counted=counted)
    res["eval"] = evaluate_views(params, inp["views"],
                                 gt.RenderConfig(**CFG), alive=alive,
                                 mesh=mesh)
    logs = []
    it = iter(inp["fit_batches"])
    state, rep = gt.fit(it, gt.RenderConfig(**FIT_CFG),
                        gt.TrainConfig(**FIT_TRAIN),
                        initial_points=inp["fit_points"], mesh=mesh,
                        log_every=1, log_fn=logs.append)
    res["fit"] = {"logs": logs, "losses": rep.losses,
                  "overflow_events": rep.overflow_events,
                  "num_gaussians": rep.num_gaussians,
                  "state": state_arrays(state)}
    res.update(run_gauss(inp, mesh, make_mesh(data=1, tile=4, device="cpu"),
                         out_dir))
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def run_cli_grid(argss):
    """The train CLI's rank function (:func:`cli_rank` of ``_grid_train``,
    as its ``main`` launches it) for each parsed argument list in turn, in
    one spawn: rank 0's reports."""
    torch.set_num_threads(1)
    return [cli_rank(train_cli._grid_train, a, a.mesh_data, a.mesh_tile)
            for a in argss]
