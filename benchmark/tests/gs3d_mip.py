"""A fixture model, kept out of ``benchmark/models/`` so that it is no
configuration of the benchmark: ``gs3d`` with the port's Mip filter
(``"aa_mode": "mip"`` in the configuration's ``render`` block), found by
name as a later model would be (``test_bench_models.py`` copies it into
a ``models/`` folder of its own).

The program side is ``gs3d``'s, which hands the whole ``render`` block to
the program's ``RenderConfig``. The reference side is its own: gs3d's
reference with the filter applied to each splat's 2D covariance before
the eigenvalue clamp, as ``gsplat_tpu_torch/ops/projection.py`` does:
``aa_dilation`` added to the diagonal and the opacity scaled by
sqrt(det before / det after). It also brings a driver of a made-up
traffic kind, ``still``.

Program side: ``program_pool``, ``program_train_pool``,
``render_config``, ``serve_entry``, ``train_entry``, ``first_grad``,
``trained_params``, ``run_still``.

Reference side: ``scene``, ``frame``, ``loss_grad``, ``optimizer``,
``frame_numbers``, ``train_numbers``, ``mip_filter``.
"""

from __future__ import annotations

import time

import torch

from benchmark import harness, poses
from benchmark.reference import render as ref

gs3d = harness.load_model("gs3d")

program_pool = gs3d.program_pool
program_train_pool = gs3d.program_train_pool
render_config = gs3d.render_config
serve_entry = gs3d.serve_entry
train_entry = gs3d.train_entry
first_grad = gs3d.first_grad
trained_params = gs3d.trained_params
scene = gs3d.scene
optimizer = gs3d.optimizer
frame_numbers = gs3d.frame_numbers
train_numbers = gs3d.train_numbers


def mip_filter(cell):
    """(sa, sb, sc, opacity) -> the filtered ones, at the configuration's
    ``aa_dilation``."""
    dilation = cell.config["render"]["aa_dilation"]

    def apply(sa, sb, sc, opacity):
        det_before = torch.clamp(sa * sc - sb * sb, min=1e-12)
        sa = sa + dilation
        sc = sc + dilation
        det_after = torch.clamp(sa * sc - sb * sb, min=1e-12)
        return sa, sb, sc, opacity * torch.sqrt(det_before / det_after)
    return apply


def frame(cell, params, alive, cam, dtype=torch.float32, count_work=False):
    rnd = ref.Renderer.from_config(cell.config["render"])
    img, c = ref.render(params, alive, cam, rnd, dtype=dtype,
                        count_work=count_work, filter2d=mip_filter(cell))
    return img, (None if c is None else dict(c, slots=int(alive.shape[0])))


def loss_grad(cell, params, alive, cam, target, dtype=torch.float32):
    t = cell.mix["train"]
    return ref.render_grad(params, alive, cam,
                           ref.Renderer.from_config(cell.config["render"]),
                           ref.photo_loss(target, t["lambda_l1"],
                                          t["lambda_ssim"]),
                           dtype=dtype, filter2d=mip_filter(cell))


def run_still(cell, seed, seconds, trace, dev, t_start, hooks=None):
    """Traffic kind ``still``: one frame of the path's first pose through
    the serve entry, compared with the reference's frame."""
    pool = program_pool(cell, seed, dev)
    center, radius = harness._center_radius(pool.params, pool.alive)
    pose = poses.path_poses(cell.mix["path"], center, radius)[0]
    cfg, demands = render_config(cell, pool, [pose])
    img, _ = serve_entry(cell, pool, cfg, hooks or {})(pose)
    params, alive = scene(cell, seed, dev)
    want = frame(cell, params, alive, harness._camera(cell.mix, pose))[0]
    return {"attempted": 1, "failed": 0,
            "e2e": {"setup_s": time.perf_counter() - t_start},
            "memory_peak_bytes": 0,
            "info": {"driver": "still", "max_demand": max(demands)},
            "numbers": frame_numbers([(img, want)])}


DRIVERS = {"still": run_still}
