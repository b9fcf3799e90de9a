"""2D Gaussian Splatting (Huang et al., SIGGRAPH 2024, arXiv:2403.17888):
each primitive a surfel (two scales in its tangent plane), composited by
ray-splat intersection with a low-pass filter into rgb, alpha, depth,
normal and distortion maps, trained with the depth-distortion and
normal-consistency terms beside L1 and D-SSIM.

The scene is ``gs3d``'s (the configuration's garden scene, drawn from the
seed) with the first two scale columns kept. A "frame" is the rgb image
[H, W, 3]: the ground truth of training is the reference's frame of the
unperturbed scene. Training perturbs the leaves the traffic names and
trains every leaf; the loss weights are the traffic's ``train`` block's
(``lambda_dist``, ``lambda_normal``), the distortion's depth range and the
low-pass filter the configuration's ``render`` block's (``dist_near``,
``dist_far``, ``filter_inv_square``, which the program's ``RenderConfig``
does not hold: they go to its ``SurfelConfig``). The reference is
``reference/gs2d.py``.

Beside gs3d's three training numbers, ``train_numbers`` gives
``maps_max_gap`` (the first step's depth, normal and distortion maps, the
program's against the reference's, each over the map's largest
magnitude: the program's maps are rendered from the state the first step
starts from, the reference's are its first step's) and ``q_grad_max_gap``
(the rotation leaf's first gradient, elementwise, over the reference's
largest).

Program side (they import ``gsplat_tpu_torch`` inside themselves, or read
what it made): ``_surfel_config``, ``program_pool``,
``program_train_pool``, ``render_config``, ``serve_entry``,
``train_entry``, ``first_grad``, ``trained_params``.

Reference side (the benchmark's own modules and torch; nothing of the
program): ``scene``, ``frame``, ``loss_grad``, ``optimizer``,
``frame_numbers``, ``train_numbers``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from benchmark import harness, poses, scenes
from benchmark.reference import compare
from benchmark.reference import gs2d as ref2d
from benchmark.reference import render as ref

ROOT = Path(__file__).resolve().parents[2]
SURFEL_KEYS = ("filter_inv_square", "dist_near", "dist_far")
MAP_KEYS = ("depth", "normal", "dist")
gs3d = harness.load_model("gs3d")

# The first step's maps for maps_max_gap: the program's ("program", from
# train_entry's step) and the reference's in each dtype (("reference",
# dtype), from loss_grad's first call after optimizer()).
_MAPS = {}

first_grad = gs3d.first_grad
trained_params = gs3d.trained_params


# -- the program ----------------------------------------------------------

def _surfel_config(cell):
    # SurfelConfig exists only where the program has surfels: a program
    # without them fails here, at once.
    from gsplat_tpu_torch.config import SurfelConfig

    r, t = cell.config["render"], cell.mix.get("train", {})
    return SurfelConfig(lambda_dist=t.get("lambda_dist", 100.0),
                        lambda_normal=t.get("lambda_normal", 0.05),
                        **{k: r[k] for k in SURFEL_KEYS})


def program_pool(cell, seed: int, dev):
    """The program's surfel pool, as drawn."""
    from gsplat_tpu_torch.models.gaussians import GaussianPool

    _surfel_config(cell)
    return GaussianPool(*scene(cell, seed, dev))


def program_train_pool(cell, seed: int, dev):
    """The pool training starts from: the leaves the mix names perturbed
    by the draws ``scenes.perturbed`` gives the reference."""
    from gsplat_tpu_torch.models.gaussians import GaussianPool

    _surfel_config(cell)
    params, alive = scene(cell, seed, dev)
    return GaussianPool(scenes.perturbed(params, cell.mix["perturb"], seed),
                        alive)


def render_config(cell, pool, cams):
    """(the program's ``RenderConfig``, the pair demand of each camera):
    gs3d's, from the ``render`` block without the surfel constants, the
    demand counted by the surfel footprint."""
    from gsplat_tpu_torch.config import RenderConfig
    from gsplat_tpu_torch.render import pair_demand

    mix = cell.mix
    sc = _surfel_config(cell)
    block = {k: v for k, v in cell.config["render"].items()
             if k not in SURFEL_KEYS}
    cfg = RenderConfig(height=mix["height"], width=mix["width"], **block)
    fx, fy, cx, cy = poses.intrinsics(mix)
    probe = cfg.with_(max_pairs=4096)
    with torch.no_grad():
        dem = [int(pair_demand(pool.params, c, fx, fy, cx, cy, probe,
                               alive=pool.alive, surfel=sc)[0])
               for c in cams]
    return cfg.with_(max_pairs=gs3d._rup(max(dem),
                                         mix["capacity_headroom"])), dem


def serve_entry(cell, pool, cfg, hooks: dict):
    """pose -> (rgb [H, W, 3], probe): ``viewer.make_render_fn`` over the
    surfel pool."""
    return gs3d.serve_entry(cell, pool, cfg, hooks)


def train_entry(cell, pool, cfg, views, gt, hooks: dict):
    """(state, step, batches): ``train.trainer.make_train_step`` at batch
    1 with the mix's ``train`` rates (3DGS's in ``TrainConfig``, the loss
    weights in ``SurfelConfig``), its state over the surfel pool, and one
    batch a view. The step's first call first renders the state it starts
    from at its view (no autograd) and keeps the depth, normal and
    distortion maps for ``maps_max_gap``."""
    import dataclasses

    from gsplat_tpu_torch.config import TrainConfig
    from gsplat_tpu_torch.render import render_from_params
    from gsplat_tpu_torch.train.trainer import (init_train_state,
                                                make_train_step)

    mix = cell.mix
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    tcfg = TrainConfig(capacity=pool.capacity, batch_size=1,
                       **{k: v for k, v in mix["train"].items()
                          if k in names})
    sc = _surfel_config(cell)
    state = init_train_state(pool, tcfg, surfel=sc)
    inner = hooks.get("make_train_step", make_train_step)(cfg, tcfg)
    _MAPS.pop("program", None)

    def step(st, batch):
        if "program" not in _MAPS:
            with torch.no_grad():
                _, aux = render_from_params(
                    st.pool.params, batch["c2w"][0], batch["fx"][0],
                    batch["fy"][0], batch["cx"][0], batch["cy"][0], cfg,
                    alive=st.pool.alive, surfel=sc)
                _MAPS["program"] = {"depth": aux.depth.cpu(),
                                    "normal": aux.normal.cpu(),
                                    "dist": aux.distortion.cpu()}
        return inner(st, batch)

    fx, fy, cx, cy = poses.intrinsics(mix)

    def batch(v):
        dev = gt[v].device
        return {"image": gt[v][None],
                "c2w": torch.from_numpy(views[v][None]).to(dev),
                **{k: torch.full((1,), x, dtype=torch.float32, device=dev)
                   for k, x in (("fx", fx), ("fy", fy), ("cx", cx),
                                ("cy", cy))}}

    return state, step, [batch(v) for v in range(len(views))]


# -- the reference --------------------------------------------------------

def scene(cell, seed: int, dev):
    """(params {leaf: float32 tensor}, alive) on ``dev``: gs3d's scene
    with the first two scale columns, drawn without the program."""
    params, alive = scenes.scene(cell.config, seed, dev, ROOT)
    params["scale_raw"] = params["scale_raw"][:, :2].contiguous()
    return params, alive


def _renderer(cell) -> ref.Renderer:
    return ref.Renderer.from_config(cell.config["render"])


def _surfels(cell) -> ref2d.Surfels:
    return ref2d.Surfels.from_config(cell.config["render"],
                                     cell.mix.get("train"))


def frame(cell, params, alive, cam, dtype=torch.float32,
          count_work: bool = False):
    """(the reference's rgb frame [H, W, 3], with ``count_work`` the work
    counts that ``counts/`` reads, the slots and ``surfel_units`` (1)
    included; else None)."""
    maps, c = ref2d.render(params, alive, cam, _renderer(cell),
                           _surfels(cell), dtype, count_work)
    return maps["rgb"].float(), (None if c is None else dict(
        c, slots=int(alive.shape[0]), surfel_units=1))


def loss_grad(cell, params, alive, cam, target, dtype=torch.float32):
    """(loss, {leaf: gradient}) of the frame against the rgb ``target``:
    L1 + D-SSIM with the mix's weights plus the distortion and normal
    terms. The first call after ``optimizer`` keeps its maps."""
    loss, grads, maps = ref2d.render_grad(
        params, alive, cam, _renderer(cell), _surfels(cell), target,
        cell.mix["train"], dtype)
    key = ("reference", str(dtype))
    if key not in _MAPS:
        _MAPS[key] = {k: maps[k].float().cpu() for k in MAP_KEYS}
    return loss, grads


def optimizer(cell, start: dict, dtype=torch.float32) -> ref.Adam:
    """Adam with the paper's rates (the mix's ``train`` block). The
    reference's steps in ``dtype`` start here: its maps kept before are
    let go."""
    _MAPS.pop(("reference", str(dtype)), None)
    return ref.Adam(start, cell.mix["train"], dtype=dtype)


def frame_numbers(pairs) -> dict:
    """``pairs``: [(program frame, reference frame)], rgb [H, W, 3] each."""
    return compare.frame_numbers(pairs)


def _maps_gap() -> float:
    """The gap of the maps in the program's place (the program's, or in the
    control the reference's in a lower precision) to the float32
    reference's."""
    refm = _MAPS.pop(("reference", str(torch.float32)), None)
    prog = _MAPS.pop("program", None)
    low = [k for k in _MAPS if k[0] == "reference"]
    if prog is None and low:
        prog = _MAPS.pop(low[0])
    if prog is None or refm is None:
        return float("inf")
    gap = 0.0
    for k in MAP_KEYS:
        top = float(refm[k].abs().max())
        d = float((prog[k] - refm[k]).abs().max())
        g = d / top if top > 0 else d
        gap = max(gap, g if g == g else float("inf"))
    return gap


def train_numbers(prog_losses, ref_losses, prog_g1, ref_g1, prog_delta,
                  ref_delta) -> dict:
    """gs3d's three numbers over every leaf, ``maps_max_gap`` and
    ``q_grad_max_gap`` (module docstring)."""
    out = compare.train_numbers(prog_losses, ref_losses, prog_g1, ref_g1,
                                prog_delta, ref_delta)
    out["maps_max_gap"] = _maps_gap()
    gp, gr = prog_g1["q_raw"].float(), ref_g1["q_raw"].float()
    top = float(gr.abs().max())
    gap = float((gp - gr).abs().max())
    gap = gap / top if top > 0 else gap
    out["q_grad_max_gap"] = gap if gap == gap else float("inf")
    return out
