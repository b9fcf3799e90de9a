"""Training: optimizer, LR schedule, the train step; checkpoint loading.

Counterpart of ``gsplat_tpu/train/trainer.py:43-374`` for
``adc_mode="reference"`` in the per-view form, and of ``restore_pool``
(``:508-516``):

* per-parameter Adam groups (eps = ``adam_eps``) with the reference LRs
  (pos on the exponential schedule with its 1 %-delay phase, opacity,
  f_dc, f_rest = feature_lr / 20, scale, rotation): ``torch.optim.Adam``,
  one parameter group per leaf, ``foreach`` and ``fused`` off;
* the position LR reads the OPTIMIZER's own update count, 0 at the first
  update (optax ``scale_by_learning_rate(schedule)``);
* the position gradient is L2-clipped at ``grad_clip_pos``, then dead
  slots' gradients are zeroed;
* with ``nan_guard``, a non-finite loss or gradient restores the
  parameters, the Adam moments and the Adam step counts on the device,
  with no host sync, and the step reports ``nonfinite_skipped``;
* the views of a batch are rendered one after the other (``lax.scan``
  becomes a Python loop); the loss is the mean of the per-view losses.

PyTorch idiom: ``step_fn`` updates the pool's parameters and the optimizer
in place (the JAX step donates its input state) and returns a
``TrainState`` that shares them. On CUDA the optimizer is ``capturable``,
so its step counts and the position LR stay on the device; on the CPU
they are host tensors.

Checkpoint writing (``save_checkpoint``/``load_checkpoint`` with the
optimizer state), the ADC steps and ``fit()`` come with a later slice;
``adc_mode="paper"``, ``batched_render`` and ``uv_taps`` raise
``NotImplementedError``.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..config import RenderConfig, TrainConfig
from ..device import resolve_device
from ..models.gaussians import PARAM_KEYS, GaussianPool, pool_from_numpy
from ..ops.losses import compute_loss
from ..render import render_from_params


def position_lr(step, cfg: TrainConfig) -> torch.Tensor:
    """Exponential decay with the reference's 1%-delay phase
    (train.py:445-457). Returns a 0-d f32 tensor on ``step``'s device."""
    step = torch.as_tensor(step, dtype=torch.float32)
    frac = torch.clamp(step / cfg.position_lr_max_steps, max=1.0)
    lr = cfg.position_lr_init * (
        cfg.position_lr_final / cfg.position_lr_init
    ) ** frac
    lr = torch.where(step >= cfg.position_lr_max_steps,
                     cfg.position_lr_final, lr)
    delay = step < cfg.position_lr_delay_mult * cfg.position_lr_max_steps
    return torch.where(delay, lr * 0.01, lr)


def _fixed_lrs(cfg: TrainConfig) -> dict:
    """The constant LRs of every leaf but pos (reference train.py:394-401)."""
    return {
        "opacity_raw": cfg.opacity_lr,
        "f_dc": cfg.feature_lr,
        "f_rest": cfg.feature_lr / 20.0,
        "scale_raw": cfg.scaling_lr,
        "q_raw": cfg.rotation_lr,
    }


def make_optimizer(params: dict, cfg: TrainConfig) -> torch.optim.Adam:
    """Per-parameter Adam groups matching reference train.py:394-401.

    One group per leaf, named by ``group["name"]``. Its state is created
    here, zeroed, so the first update reads step count 0 like every other.
    """
    dev = params["pos"].device
    capturable = dev.type == "cuda"
    count_dev = dev if capturable else torch.device("cpu")
    lr0 = position_lr(torch.zeros((), device=count_dev), cfg)
    lrs = dict(_fixed_lrs(cfg), pos=lr0 if capturable else float(lr0))
    opt = torch.optim.Adam(
        [{"params": [params[k]], "lr": lrs[k], "name": k} for k in PARAM_KEYS],
        betas=(0.9, 0.999), eps=cfg.adam_eps, foreach=False, fused=False,
        capturable=capturable,
    )
    for k in PARAM_KEYS:
        p = params[k]
        opt.state[p] = {
            "step": torch.zeros((), dtype=torch.float32, device=count_dev),
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(
                p, memory_format=torch.preserve_format),
        }
    return opt


class TrainState(NamedTuple):
    pool: GaussianPool
    opt_state: torch.optim.Adam
    step: torch.Tensor  # [] int32


def init_train_state(pool: GaussianPool, cfg: TrainConfig) -> TrainState:
    dev = resolve_device(pool.pos.device)  # on CUDA: TF32 off for SSIM
    return TrainState(
        pool=pool,
        opt_state=make_optimizer(pool.params, cfg),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _guard_nonfinite(loss, grads: dict, tensors: list, saved: list):
    """Keep the previous values of ``tensors`` (the parameters and the
    optimizer's moments and counts, ``saved`` before the update) when the
    loss or any gradient is non-finite: each is overwritten in place by
    ``where(finite, new, old)`` on its device, with no host sync. Returns
    the skipped flag, [] int32."""
    finite = torch.isfinite(loss)
    for g in grads.values():
        finite = finite & torch.all(torch.isfinite(g))
    for new, old in zip(tensors, saved):
        new.copy_(torch.where(finite.to(new.device), new, old))
    return torch.where(finite, 0, 1).to(torch.int32)


def _clip_pos_grad(grads: dict, max_norm: float) -> dict:
    """clip_grad_norm_ on the position leaf only (train.py:536)."""
    g = grads["pos"]
    norm = torch.sqrt(torch.sum(g * g))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    out = dict(grads)
    out["pos"] = g * scale
    return out


def sh_warmup_mask(step, cfg: TrainConfig):
    """[45] f32 coefficient mask for SH-degree warmup, or None when off.

    Active degree = min(step // interval, 3); f_rest is laid out
    [15 R, 15 G, 15 B] with 3 deg-1, 5 deg-2, 7 deg-3 terms per channel.
    """
    if not cfg.sh_warmup_interval:
        return None
    step = torch.as_tensor(step)
    deg = torch.clamp(step // cfg.sh_warmup_interval, max=3)
    i = torch.arange(15, device=step.device)
    band = 1 + (i >= 3).to(torch.int64) + (i >= 8).to(torch.int64)
    return (band <= deg).to(torch.float32).repeat(3)  # [45]


def apply_sh_warmup(params: dict, step, cfg: TrainConfig) -> dict:
    """Return params with f_rest masked by the warmup schedule (no-op off)."""
    m = sh_warmup_mask(step, cfg)
    if m is None:
        return params
    return {**params, "f_rest": params["f_rest"] * m}


def batch_loss_fn(
    params: dict,
    alive: torch.Tensor,
    batch: dict,
    render_cfg: RenderConfig,
    train_cfg: TrainConfig,
    uv_taps: torch.Tensor | None = None,
):
    """Mean L1+SSIM loss over a batch of views, rendered one after another.

    batch: dict with 'image' [B,H,W,3], 'c2w' [B,4,4], 'fx','fy','cx','cy'
    [B], tensors on the pool's device. Returns (loss, metrics) with the
    metrics as 0-d tensors (``pair_capacity`` an int): nothing here waits
    for the device.
    """
    if train_cfg.batched_render:
        raise NotImplementedError(
            "batched_render (one shared binning for the batch) is not "
            "ported yet")
    if uv_taps is not None:
        raise NotImplementedError(
            "uv_taps (the paper-ADC view-space tap) comes with the ADC slice")
    totals, l1s, ssims, pairs = [], [], [], []
    for i in range(batch["c2w"].shape[0]):
        img, aux = render_from_params(
            params, batch["c2w"][i], batch["fx"][i], batch["fy"][i],
            batch["cx"][i], batch["cy"][i], render_cfg, alive=alive,
        )
        total, comps = compute_loss(img, batch["image"][i],
                                    train_cfg.lambda_l1,
                                    train_cfg.lambda_ssim)
        totals.append(total)
        l1s.append(comps["l1"])
        ssims.append(comps["ssim"])
        pairs.append(aux.num_pairs)
    return torch.mean(torch.stack(totals)), {
        "l1": torch.mean(torch.stack(l1s)).detach(),
        "ssim": torch.mean(torch.stack(ssims)).detach(),
        "pair_demand": torch.max(torch.stack(pairs)),
        "pair_capacity": render_cfg.max_pairs,
    }


def _optimizer_tensors(opt: torch.optim.Adam) -> list:
    """Every tensor one update changes: parameters, moments, step counts."""
    out = []
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            out += [p, st["exp_avg"], st["exp_avg_sq"], st["step"]]
    return out


def make_train_step(render_cfg: RenderConfig, train_cfg: TrainConfig):
    """Build the single-step update. Returns step_fn(state, batch) ->
    (new_state, metrics), updating the state's pool and optimizer in place.
    """
    if train_cfg.adc_mode == "paper":
        raise NotImplementedError(
            "adc_mode='paper' (view-space tap statistics) comes with the "
            "ADC slice")
    if train_cfg.adc_mode != "reference":
        raise ValueError(f"unknown adc_mode {train_cfg.adc_mode!r}")
    if train_cfg.batched_render:
        raise NotImplementedError(
            "batched_render (one shared binning for the batch) is not "
            "ported yet")

    def step_fn(state: TrainState, batch: dict):
        pool, opt = state.pool, state.opt_state
        params = pool.params
        for p in params.values():
            p.grad = None
        loss, metrics = batch_loss_fn(
            apply_sh_warmup(params, state.step, train_cfg), pool.alive,
            batch, render_cfg, train_cfg,
        )
        loss.backward()
        with torch.no_grad():
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in params.items()}
            grads = _clip_pos_grad(grads, train_cfg.grad_clip_pos)
            # Dead slots must not drift.
            grads = {
                k: torch.where(
                    pool.alive.reshape((-1,) + (1,) * (g.dim() - 1)), g, 0.0)
                for k, g in grads.items()
            }
            for k, p in params.items():
                p.grad = grads[k]
            # The position schedule reads the optimizer's own update count.
            for group in opt.param_groups:
                if group["name"] == "pos":
                    lr = position_lr(opt.state[params["pos"]]["step"],
                                     train_cfg)
                    group["lr"] = lr if group["capturable"] else float(lr)
            if train_cfg.nan_guard:
                tensors = _optimizer_tensors(opt)
                saved = [t.clone() for t in tensors]
            with warnings.catch_warnings():
                # capturable=True keeps the counts on the device; it is not
                # used for graph capture here, which Adam warns about.
                warnings.filterwarnings(
                    "ignore", message=".*capturable=True.*")
                opt.step()
            if train_cfg.nan_guard:
                metrics["nonfinite_skipped"] = _guard_nonfinite(
                    loss.detach(), grads, tensors, saved)
        new_state = TrainState(pool=pool, opt_state=opt,
                               step=state.step + 1)
        metrics.update(total=loss.detach(), pos_grad=grads["pos"])
        return new_state, metrics

    return step_fn


def restore_pool(path, device="cuda") -> GaussianPool:
    """Load only the Gaussian pool (params + alive) from a checkpoint
    (the single-file ``.npz`` of the JAX trainer's ``save_checkpoint``)."""
    with np.load(path) as data:
        params = {
            k[len("param_"):]: data[k]
            for k in data.files
            if k.startswith("param_")
        }
        alive = data["__alive__"]
    return pool_from_numpy(params, alive, device)
