"""Plain 3D Gaussian Splatting (Kerbl et al. 2023): the model of every
configuration that names no ``"model"``. The harness finds it by name
(``models/<model>.py``) and reaches every piece of a run that depends on
the model through these functions; the loops, clocks, failure rules,
traced stretch and result line are the harness's.

The scene is six leaves a gaussian (``scenes.PARAM_KEYS``) and an alive
mask: a checkpoint (``"checkpoint"``) or the garden recipe drawn from
the seed (``"garden"``). Training perturbs the leaves the traffic mix
names (``scenes.noise``). The reference is ``reference/render.py`` with
the configuration's nine renderer constants (``Renderer``): it renders
``aa_mode`` ``"none"`` only, whatever else the ``render`` block holds.

Program side (they import ``gsplat_tpu_torch`` inside themselves, or read
what it made): ``program_pool``, ``program_train_pool``,
``render_config``, ``serve_entry``, ``train_entry``, ``first_grad``,
``trained_params``.

Reference side (the benchmark's own modules and torch; nothing of the
program): ``scene``, ``frame``, ``loss_grad``, ``optimizer``,
``frame_numbers``, ``train_numbers``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from benchmark import poses, scenes
from benchmark.reference import render as ref
from benchmark.reference.compare import frame_numbers, train_numbers

ROOT = Path(__file__).resolve().parents[2]


# -- the program ----------------------------------------------------------

def program_pool(cell, seed: int, dev):
    """The program's pool: a checkpoint through ``restore_pool``, a garden
    scene handed over as made."""
    from gsplat_tpu_torch.models.gaussians import GaussianPool
    from gsplat_tpu_torch.train.trainer import restore_pool

    sc = cell.config["scene"]
    if sc["kind"] == "checkpoint":
        return restore_pool(ROOT / sc["file"], device=dev)
    params, alive = scenes.scene(cell.config, seed, dev, ROOT)
    return GaussianPool(params, alive)


def program_train_pool(cell, seed: int, dev):
    """The pool training starts from: the leaves the mix names perturbed
    by the draws ``scenes.perturbed`` gives the reference."""
    from gsplat_tpu_torch.models.gaussians import GaussianPool

    pool = program_pool(cell, seed, dev)
    if cell.config["scene"]["kind"] == "checkpoint":
        with torch.no_grad():
            for k, v in scenes.noise(pool.params, cell.mix["perturb"],
                                     seed).items():
                pool.params[k].add_(v)
        return pool
    return GaussianPool(scenes.perturbed(pool.params, cell.mix["perturb"],
                                         seed), pool.alive)


def _rup(demand: int, headroom: float) -> int:
    """``demand`` x ``headroom`` rounded up to 4,096 (``--auto_pairs``)."""
    return max(4096, -(-int(demand * headroom) // 4096) * 4096)


def render_config(cell, pool, cams):
    """(the program's ``RenderConfig``, the pair demand of each camera):
    the configuration's ``render`` block at the mix's image size, with
    ``max_pairs`` the largest demand over ``cams`` x ``headroom``,
    rounded up to 4,096."""
    from gsplat_tpu_torch.config import RenderConfig
    from gsplat_tpu_torch.render import pair_demand

    mix = cell.mix
    cfg = RenderConfig(height=mix["height"], width=mix["width"],
                       **cell.config["render"])
    fx, fy, cx, cy = poses.intrinsics(mix)
    probe = cfg.with_(max_pairs=4096)
    with torch.no_grad():
        dem = [int(pair_demand(pool.params, c, fx, fy, cx, cy, probe,
                               alive=pool.alive)[0]) for c in cams]
    return cfg.with_(max_pairs=_rup(max(dem), mix["capacity_headroom"])), dem


def serve_entry(cell, pool, cfg, hooks: dict):
    """pose -> (frame [H, W, 3], probe): ``viewer.make_render_fn`` over the
    pool, its probe's element 1 the frame's pair demand."""
    from gsplat_tpu_torch.viewer import make_render_fn

    fx, fy, cx, cy = poses.intrinsics(cell.mix)
    return hooks.get("make_render_fn", make_render_fn)(
        pool.params, cfg, fx, fy, cx, cy, alive=pool.alive,
        report_demand=True)


def train_entry(cell, pool, cfg, views, gt, hooks: dict):
    """(state, step, batches): ``train.trainer.make_train_step`` at batch
    1 with the mix's ``train`` rates, its state over the pool, and one
    batch a view (its ground truth and camera)."""
    from gsplat_tpu_torch.config import TrainConfig
    from gsplat_tpu_torch.train.trainer import (init_train_state,
                                                make_train_step)

    mix = cell.mix
    tcfg = TrainConfig(capacity=pool.capacity, batch_size=1, **mix["train"])
    state = init_train_state(pool, tcfg)
    step = hooks.get("make_train_step", make_train_step)(cfg, tcfg)
    fx, fy, cx, cy = poses.intrinsics(mix)

    def batch(v):
        dev = gt[v].device
        return {"image": gt[v][None],
                "c2w": torch.from_numpy(views[v][None]).to(dev),
                **{k: torch.full((1,), x, dtype=torch.float32, device=dev)
                   for k, x in (("fx", fx), ("fy", fy), ("cx", cx),
                                ("cy", cy))}}

    return state, step, [batch(v) for v in range(len(views))]


def first_grad(state) -> dict:
    """The first gradient as Adam got it, worked out from its state after
    one step: ``exp_avg / (1 - beta1)``, on the host."""
    opt = state.opt_state
    return {name: (opt.state[p]["exp_avg"] / 0.1).detach().cpu()
            for name, p in state.pool.params.items()}


def trained_params(state) -> dict:
    """A host copy of the parameters."""
    return {name: p.detach().to("cpu", copy=True)
            for name, p in state.pool.params.items()}


# -- the reference --------------------------------------------------------

def scene(cell, seed: int, dev):
    """(params {leaf: float32 tensor}, alive bool tensor) on ``dev``, read
    or drawn without the program."""
    return scenes.scene(cell.config, seed, dev, ROOT)


def _renderer(cell) -> ref.Renderer:
    return ref.Renderer.from_config(cell.config["render"])


def frame(cell, params, alive, cam, dtype=torch.float32,
          count_work: bool = False):
    """(the reference's frame [H, W, 3], with ``count_work`` the work
    counts that ``counts/`` reads, the slots included; else None)."""
    img, c = ref.render(params, alive, cam, _renderer(cell), dtype=dtype,
                        count_work=count_work)
    return img, (None if c is None else dict(c, slots=int(alive.shape[0])))


def loss_grad(cell, params, alive, cam, target, dtype=torch.float32):
    """(loss, {leaf: gradient}) of the frame against ``target``: L1 +
    D-SSIM with the mix's weights."""
    t = cell.mix["train"]
    return ref.render_grad(params, alive, cam, _renderer(cell),
                           ref.photo_loss(target, t["lambda_l1"],
                                          t["lambda_ssim"]), dtype=dtype)


def optimizer(cell, start: dict, dtype=torch.float32) -> ref.Adam:
    """Adam with the paper's rates (the mix's ``train`` block): its
    ``prepare(grads, alive)`` clips and masks, ``step(params, grads)``
    returns the new parameters."""
    return ref.Adam(start, cell.mix["train"], dtype=dtype)
