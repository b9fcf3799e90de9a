"""Feature 3DGS (Zhou et al., CVPR 2024, arXiv:2312.03203): 3DGS whose
gaussians also carry C feature floats (``f_sem``), composited with
colour's weights into a feature map, resized to the teacher's size,
decoded by a 1x1 convolution to the teacher's D channels (``dec_w``
[D, C], ``dec_b`` [D]) and held to the teacher map by an L1 term.

The scene is ``gs3d``'s (the configuration's garden scene, drawn from the
seed) plus ``f_sem`` ~ N(0, 1) and the decoder drawn as
``torch.nn.Conv2d`` draws its default, each from its own stream of the
seed. A "frame" is the pair (rgb [H, W, 3], decoded feature map [D, h,
w]) at the traffic's ``teacher_scale``: the ground truth of training is
the reference's pair of the unperturbed scene, so the teacher map is the
reference's own decoded map. Training perturbs the leaves the traffic
names (``f_sem`` among them) and trains every leaf and the decoder. The
reference is ``reference/feat3dgs.py``.

Program side (they import ``gsplat_tpu_torch`` inside themselves, or read
what it made): ``program_pool``, ``program_train_pool``, ``_program``,
``render_config``, ``serve_entry``, ``train_entry``, ``first_grad``,
``trained_params``.

Reference side (the benchmark's own modules and torch; nothing of the
program): ``scene``, ``frame``, ``loss_grad``, ``optimizer``,
``frame_numbers``, ``train_numbers``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from benchmark import harness, poses, scenes
from benchmark.reference import compare
from benchmark.reference import feat3dgs as feat
from benchmark.reference import render as ref

ROOT = Path(__file__).resolve().parents[2]
gs3d = harness.load_model("gs3d")

render_config = gs3d.render_config


# -- the program ----------------------------------------------------------

class _Program:
    """The program's pool (``params`` with ``f_sem``, ``alive``, as the
    harness reads a pool) and the decoder's two tensors."""

    def __init__(self, pool, decoder: dict):
        self.pool, self.decoder = pool, decoder
        self.params, self.alive = pool.params, pool.alive


def _program(params: dict, alive):
    # FEATURE_KEY exists only where the program carries features: a
    # program without them fails here, at once.
    from gsplat_tpu_torch.config import DECODER_KEYS, FEATURE_KEY
    from gsplat_tpu_torch.models.gaussians import GaussianPool

    keys = scenes.PARAM_KEYS + (FEATURE_KEY,)
    return _Program(GaussianPool({k: params[k] for k in keys}, alive),
                    {k: params[k] for k in DECODER_KEYS})


def program_pool(cell, seed: int, dev):
    """The program's pool with ``f_sem``, and the decoder, as drawn."""
    return _program(*scene(cell, seed, dev))


def program_train_pool(cell, seed: int, dev):
    """The pool training starts from: the leaves the mix names perturbed
    by the draws ``scenes.perturbed`` gives the reference."""
    params, alive = scene(cell, seed, dev)
    return _program(scenes.perturbed(params, cell.mix["perturb"], seed),
                    alive)


def serve_entry(cell, pool, cfg, hooks: dict):
    """pose -> ((rgb [H, W, 3], decoded map [D, h, w]), probe):
    ``viewer.make_render_fn`` over the pool with features, its map
    decoded by ``ops.losses.decode_features`` at the teacher's size."""
    from gsplat_tpu_torch.ops.losses import decode_features
    from gsplat_tpu_torch.viewer import make_render_fn

    mix = cell.mix
    fx, fy, cx, cy = poses.intrinsics(mix)
    size = _teacher_size(cell)
    fn = hooks.get("make_render_fn", make_render_fn)(
        pool.params, cfg, fx, fy, cx, cy, alive=pool.alive,
        report_demand=True)

    def serve(c2w):
        (rgb, fmap), probe = fn(c2w)
        with torch.no_grad():
            return (rgb, decode_features(fmap, size, pool.decoder)), probe
    return serve


def train_entry(cell, pool, cfg, views, gt, hooks: dict):
    """(state, step, batches): ``train.trainer.make_train_step`` at batch
    1 with the mix's ``train`` rates (3DGS's in ``TrainConfig``, the
    feature leaf's, the decoder's and the feature loss weight in
    ``FeatureConfig``), its state over the pool and the decoder, and one
    batch a view (its rgb, teacher map and camera)."""
    import dataclasses

    from gsplat_tpu_torch.config import FeatureConfig, TrainConfig
    from gsplat_tpu_torch.train.trainer import (init_train_state,
                                                make_train_step)

    mix = cell.mix
    t = mix["train"]
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    tcfg = TrainConfig(capacity=pool.pool.capacity, batch_size=1,
                       **{k: v for k, v in t.items() if k in names})
    fcfg = FeatureConfig(
        semantic_feature_lr=t["semantic_feature_lr"],
        decoder_lr=t["decoder_lr"],
        semantic_loss_weight=t["semantic_loss_weight"])
    state = init_train_state(pool.pool, tcfg, fcfg, decoder=pool.decoder)
    make = hooks.get("make_train_step")
    step = (make or make_train_step)(cfg, tcfg)
    fx, fy, cx, cy = poses.intrinsics(mix)

    def batch(v):
        rgb, teacher = gt[v]
        dev = rgb.device
        return {"image": rgb[None], "teacher": teacher[None],
                "c2w": torch.from_numpy(views[v][None]).to(dev),
                **{k: torch.full((1,), x, dtype=torch.float32, device=dev)
                   for k, x in (("fx", fx), ("fy", fy), ("cx", cx),
                                ("cy", cy))}}

    return state, step, [batch(v) for v in range(len(views))]


def first_grad(state) -> dict:
    """The first gradient of every leaf as Adam got it, worked out from its
    state after one step: ``exp_avg / (1 - beta1)``, on the host."""
    opt = state.opt_state
    return {g["name"]: (opt.state[g["params"][0]]["exp_avg"] / 0.1)
            .detach().cpu() for g in opt.param_groups}


def trained_params(state) -> dict:
    """A host copy of every leaf: the pool's and the decoder's."""
    leaves = {**state.pool.params, **state.decoder}
    return {name: p.detach().to("cpu", copy=True)
            for name, p in leaves.items()}


# -- the reference --------------------------------------------------------

def scene(cell, seed: int, dev):
    """(params {leaf: float32 tensor}: gs3d's six, ``f_sem`` [N, C],
    ``dec_w`` [D, C], ``dec_b`` [D]; alive) on ``dev``, drawn from the
    configuration and the seed without the program."""
    params, alive = scenes.scene(cell.config, seed, dev, ROOT)
    n = alive.shape[0]
    C = int(cell.config["feature_dim"])
    D = int(cell.config["decoder"]["out"])
    g = scenes.generator(seed, "features", dev)
    params["f_sem"] = torch.randn(n, C, generator=g, device=dev)
    g = scenes.generator(seed, "decoder", dev)
    bound = 1.0 / C ** 0.5
    params["dec_w"] = (2.0 * torch.rand(D, C, generator=g, device=dev)
                       - 1.0) * bound
    params["dec_b"] = (2.0 * torch.rand(D, generator=g, device=dev)
                       - 1.0) * bound
    return params, alive


def _renderer(cell) -> ref.Renderer:
    return ref.Renderer.from_config(cell.config["render"])


def _teacher_size(cell) -> tuple:
    mix = cell.mix
    return (int(mix["height"] * mix["train"]["teacher_scale"]),
            int(mix["width"] * mix["train"]["teacher_scale"]))


def frame(cell, params, alive, cam, dtype=torch.float32,
          count_work: bool = False):
    """((rgb [H, W, 3], decoded feature map [D, h, w]), with
    ``count_work`` gs3d's work counts with ``slots``, ``channels`` (C),
    ``teacher_pixels`` (h w) and ``decoder_params`` (D C + D); else
    None)."""
    rgb, fmap, c = feat.render(params, alive, cam, _renderer(cell), dtype,
                               count_work)
    h, w = _teacher_size(cell)
    with torch.no_grad():
        dec = feat.decode(fmap, (h, w), params["dec_w"].to(dtype),
                          params["dec_b"].to(dtype))
    del fmap
    if c is not None:
        D, C = params["dec_w"].shape
        c = dict(c, slots=int(alive.shape[0]), channels=int(C),
                 teacher_pixels=h * w, decoder_params=int(D * C + D))
    return (rgb.float(), dec.float()), c


def loss_grad(cell, params, alive, cam, target, dtype=torch.float32):
    """(loss, {leaf: gradient}) of the frame against ``target`` = (rgb,
    teacher map): L1 + D-SSIM with the mix's weights plus the feature L1
    at ``semantic_loss_weight``."""
    return feat.render_grad(params, alive, cam, _renderer(cell), target,
                            cell.mix["train"], dtype)


def optimizer(cell, start: dict, dtype=torch.float32) -> feat.Adam:
    """Adam with the mix's rates for 3DGS's leaves, ``f_sem`` and the
    decoder."""
    return feat.Adam(start, cell.mix["train"], dtype=dtype)


def frame_numbers(pairs) -> dict:
    """``pairs``: [(program frame, reference frame)], each (rgb, decoded
    map): the worst frame's largest and mean absolute rgb difference and
    its largest decoded-map difference over the map's largest value."""
    rgb = compare.frame_numbers([(p[0], r[0]) for p, r in pairs])
    gap = 0.0
    for p, r in pairs:
        d = (p[1].float() - r[1].float()).abs().max()
        top = float(r[1].abs().max())
        gap = max(gap, float(d) / top if top > 0 else float(d))
    return dict(rgb, feature_max_rel=gap if gap == gap else float("inf"))


def train_numbers(prog_losses, ref_losses, prog_g1, ref_g1, prog_delta,
                  ref_delta) -> dict:
    """gs3d's three numbers over every leaf (``f_sem`` and the decoder's
    included), and ``fsem_grad_max_gap``: the largest absolute difference
    of the first gradient of ``f_sem`` over the moved elements
    (``compare.moved_elements``), over the reference's largest. The norm
    gaps cannot see features credited to the wrong gaussian; this can."""
    out = compare.train_numbers(prog_losses, ref_losses, prog_g1, ref_g1,
                                prog_delta, ref_delta)
    gp, gr = prog_g1["f_sem"].float(), ref_g1["f_sem"].float()
    moved = compare.moved_elements({k: ref_g1[k] for k in ref_g1})["f_sem"]
    top = float(gr.abs().max())
    gap = float(torch.where(moved, (gp - gr).abs(), 0.0).max())
    gap = gap / top if top > 0 else gap
    out["fsem_grad_max_gap"] = gap if gap == gap else float("inf")
    return out
