"""The rank side of tests/test_torch_sharding.py (imported by the spawned
gloo ranks, so it imports torch and the port only, never JAX).

:func:`run_grid` runs every scenario once on one rank of a data 2 x tile 2
grid of CPU processes and writes that rank's results to
``<out_dir>/rank<r>.pt`` (numpy arrays, ints and strings).
"""

import os

import numpy as np
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch.evaluation import evaluate_views
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
from gsplat_tpu_torch.parallel import (local_batch, make_mesh,
                                       make_sharded_batch_render,
                                       make_sharded_render,
                                       make_sharded_train_step)

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


def run_step(inp, mesh, tkw, cull):
    """One sharded (``mesh``) or single-device (None) step from a fresh
    state: (state arrays, metrics, the clipped and masked gradients the
    update applied), as numpy."""
    cfg = gt.RenderConfig(**CFG, cull_mode=cull)
    tcfg = gt.TrainConfig(**TCFG, **tkw)
    pool = gt.pool_from_numpy(inp["params"], inp["alive"], device="cpu")
    state = gt.init_train_state(pool, tcfg)
    batch = {k: torch.from_numpy(v.copy()) for k, v in inp["batch"].items()}
    if mesh is None:
        state, m = gt.make_train_step(cfg, tcfg)(state, batch)
    else:
        state, m = make_sharded_train_step(cfg, tcfg, mesh)(
            state, local_batch(batch, mesh))
    grads = {k: _np(p.grad).copy() for k, p in state.pool.params.items()}
    return state_arrays(state), {k: _np(v) for k, v in m.items()}, grads


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
        res["step_" + name] = run_step(inp, mesh, tkw, cull)
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
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
