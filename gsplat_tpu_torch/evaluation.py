"""Quality evaluation: PSNR / SSIM / L1 over held-out views.

Counterpart of ``gsplat_tpu/evaluation.py``: ``psnr`` (``:19``) and
``evaluate_views`` (``:25-162``). Views render on the parameters' device
(the compositor kernel on CUDA tensors, its plain version on CPU tensors),
without autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import RenderConfig
from .ops.clamps import maximum
from .ops.losses import ssim
from .parallel.sharding import make_sharded_batch_render
from .render import pair_demand, render_batch_from_params, render_from_params


def psnr(img: torch.Tensor, ref: torch.Tensor, max_val: float = 1.0):
    """Peak signal-to-noise ratio in dB (0-d tensor)."""
    mse = torch.mean((img - ref) ** 2)
    return 10.0 * torch.log10(max_val * max_val / maximum(mse, 1e-12))


def _f32(x, dev) -> torch.Tensor:
    """A view's field (array, float or tensor) as float32 on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def evaluate_views(
    params: dict,
    views: list,
    cfg: RenderConfig,
    alive=None,
    render_batch: int = 1,
    mesh=None,
    auto_size: bool = True,
) -> dict:
    """Render each view and compare it to its ground truth.

    Args:
        params: the six parameter tensors on one device (e.g.
            ``GaussianPool.params``).
        views: list of dicts with image [H, W, 3] (array or tensor), c2w,
            fx, fy, cx, cy.
        render_batch: views rendered per launch through
            ``render_batch_from_params`` (one binning and one compositor
            launch; the last chunk pads by repeating its final view).
        mesh: this rank's ``(data, tile)`` grid: each launch splits its
            views over ``data`` and each frame into bands over ``tile``
            (``parallel.make_sharded_batch_render``); every rank returns
            the scores. ``render_batch`` must be a multiple of the data
            size (it defaults to it when 1).
        auto_size: probe the pair demand of every view first (projection
            and binning only, ``pair_demand``) and grow ``max_pairs`` (and,
            with ``tile_rank_cap``, ``trunc_pairs``) to 1.1 x the largest,
            rounded up to 4,096, where it exceeds them: an under-sized
            evaluation drops the farthest gaussians and reports a collapsed
            score. The demand and the capacity used are in the result.
            In ellipse mode the row capacity follows ``max_pairs`` where
            ``max_rows`` is 0; an explicit ``max_rows`` is kept (JAX's).

    Returns:
        JAX's dict: mean ``psnr``, ``ssim``, ``l1``; ``per_view`` (a dict
        of the three per view); ``num_views``; ``max_pair_demand``;
        ``eval_max_pairs``.
    """
    dev = params["pos"].device
    imgs = []
    max_demand = 0
    with torch.no_grad():
        if auto_size:
            max_trunc = 0
            for v in views:
                d0, _, d2 = pair_demand(
                    params, _f32(v["c2w"], dev), _f32(v["fx"], dev),
                    _f32(v["fy"], dev), _f32(v["cx"], dev),
                    _f32(v["cy"], dev), cfg, alive=alive)
                max_demand = max(max_demand, int(d0))
                max_trunc = max(max_trunc, int(d2))

            def _rup(x):
                return -(-int(x * 1.1) // 4096) * 4096

            upd = {}
            if max_demand > cfg.max_pairs:
                upd["max_pairs"] = _rup(max_demand)
            if cfg.tile_rank_cap and max_trunc > cfg.trunc_pairs:
                upd["trunc_pairs"] = _rup(max_trunc)
            if upd:
                cfg = cfg.with_(**upd)
        if mesh is not None and render_batch == 1:
            render_batch = mesh.shape["data"]
        if render_batch > 1:
            if mesh is not None:
                sfn = make_sharded_batch_render(cfg, mesh)

                def render_chunk(c2w, fx, fy, cx, cy):
                    return sfn(params, alive, c2w, fx, fy, cx, cy)
            else:

                def render_chunk(c2w, fx, fy, cx, cy):
                    return render_batch_from_params(
                        params, c2w, fx, fy, cx, cy, cfg, alive=alive)[0]

            B = render_batch
            for s in range(0, len(views), B):
                chunk = views[s:s + B]
                real = len(chunk)
                chunk = chunk + [chunk[-1]] * (B - real)

                def field(k):
                    return torch.stack([_f32(v[k], dev) for v in chunk])

                out = render_chunk(field("c2w"), field("fx"), field("fy"),
                                   field("cx"), field("cy"))
                imgs.extend(out[i] for i in range(real))
        else:
            for v in views:
                img, _ = render_from_params(
                    params, _f32(v["c2w"], dev), _f32(v["fx"], dev),
                    _f32(v["fy"], dev), _f32(v["cx"], dev),
                    _f32(v["cy"], dev), cfg, alive=alive)
                imgs.append(img)

        per_view = []
        for v, img in zip(views, imgs):
            gt = _f32(v["image"], dev)
            per_view.append({
                "psnr": float(psnr(img, gt)),
                "ssim": float(ssim(img, gt)),
                "l1": float(torch.mean(torch.abs(img - gt))),
            })
    return {
        "psnr": float(np.mean([v["psnr"] for v in per_view])),
        "ssim": float(np.mean([v["ssim"] for v in per_view])),
        "l1": float(np.mean([v["l1"] for v in per_view])),
        "per_view": per_view,
        "num_views": len(per_view),
        "max_pair_demand": max_demand,
        "eval_max_pairs": cfg.max_pairs,
    }
