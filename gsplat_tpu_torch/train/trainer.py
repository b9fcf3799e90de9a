"""Training: optimizer, LR schedule, the train step, the ADC steps and
checkpoints.

Counterpart of ``gsplat_tpu/train/trainer.py:43-582``:

* per-parameter Adam groups (eps = ``adam_eps``) with the reference LRs
  (pos on the exponential schedule with its 1 %-delay phase, opacity,
  f_dc, f_rest = feature_lr / 20, scale, rotation): ``torch.optim.Adam``,
  one parameter group per leaf, holds the state (moments and counts) but
  does not step: ``ops.update.adam_update`` updates every leaf at once
  (on CUDA two hand-written kernels, ``csrc/update.cu``: one read of the
  gradients, then one pass over gradient, parameter and moments);
* the position LR reads the OPTIMIZER's own update count, 0 at the first
  update (optax ``scale_by_learning_rate(schedule)``);
* the position gradient is L2-clipped at ``grad_clip_pos``, then dead
  slots' gradients are zeroed, inside that update;
* with ``nan_guard``, a non-finite loss or gradient makes the update
  write no parameter, Adam moment or step count (decided on the device,
  with no host sync, and no copy kept), and the step reports
  ``nonfinite_skipped``;
* the views of a batch are rendered one after the other (``lax.scan``
  becomes a Python loop) and the loss is the mean of the per-view losses,
  or, with ``batched_render``, all at once through one binning and one
  compositor launch (``render_batch_from_params``) and the loss of the
  batch;
* with ``adc_mode="paper"`` the step also differentiates a zero
  view-space tap per view and returns ``uv_grad_sum``, ``visible`` and
  ``max_radius``, the paper's densification statistics;
* ``adc_step``/``adc_step_paper``/``opacity_raise_step`` run the ADC on
  the pool in place and zero the moments of the slots it rewrote;
  ``grow_state_capacity`` makes a larger pool and optimizer;
* ``save_checkpoint``/``load_checkpoint``: the JAX package's ``.npz``
  layout, readable by both packages (optax's 19 leaves, below);
* a pool with per-gaussian features (``f_sem``, Feature 3DGS; the port's
  own, ``config.FeatureConfig``) trains its decoder beside it
  (``TrainState.decoder``): the loss adds the decoded feature map's L1 to
  the batch's teacher maps, Adam takes ``f_sem`` and the decoder at their
  own rates, and the checkpoints carry both with their Adam state in keys
  of their own beside the JAX layout;
  a surfel pool (a two-column ``scale_raw``: 2D Gaussian Splatting; the
  port's own, ``config.SurfelConfig``, in ``TrainState.surfel``) renders
  through the surfel compositor and its loss adds the depth-distortion
  and normal-consistency terms (``ops.losses.geometry_loss``); every
  leaf, the update, the ADC and the checkpoints are 3DGS's;
  ``save_checkpoint_dcp``/``load_checkpoint_dcp``: the orbax pair's
  collective directory checkpoints, on ``torch.distributed.checkpoint``,
  for a state sharded over a process grid.

PyTorch idiom: ``step_fn`` updates the pool's parameters and the optimizer
in place (the JAX step donates its input state) and returns a
``TrainState`` that shares them. On CUDA the optimizer is ``capturable``,
so its step counts and the position LR stay on the device; on the CPU
they are host tensors.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..config import (DECODER_KEYS, FEATURE_KEY, FeatureConfig,
                      RenderConfig, SurfelConfig, TrainConfig,
                      is_surfel_pool)
from ..device import resolve_device
from ..models.adc import (densify_and_prune, densify_and_prune_paper,
                          raise_low_opacity)
from ..models.gaussians import PARAM_KEYS, GaussianPool, pool_from_numpy
from ..ops.losses import compute_loss, feature_loss, geometry_loss
from ..ops.update import adam_update
from ..render import render_batch_from_params, render_from_params
from ..utils.profiling import span


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


def _fixed_lrs(cfg: TrainConfig, features: FeatureConfig | None = None
               ) -> dict:
    """The constant LRs of every leaf but pos (reference train.py:394-401),
    and with ``features`` those of ``f_sem`` and the decoder."""
    lrs = {
        "opacity_raw": cfg.opacity_lr,
        "f_dc": cfg.feature_lr,
        "f_rest": cfg.feature_lr / 20.0,
        "scale_raw": cfg.scaling_lr,
        "q_raw": cfg.rotation_lr,
    }
    if features is not None:
        lrs[FEATURE_KEY] = features.semantic_feature_lr
        lrs.update({k: features.decoder_lr for k in DECODER_KEYS})
    return lrs


def _count_device(params: dict) -> torch.device:
    """Where Adam's step counts live: the card when it is capturable."""
    dev = params["pos"].device
    return dev if dev.type == "cuda" else torch.device("cpu")


def _build_adam(params: dict, lrs: dict, eps: float) -> torch.optim.Adam:
    """One Adam group per leaf of ``params``, in its order, named by
    ``group["name"]``, with its state created here, zeroed, so the first
    update reads step count 0 like every other. On CUDA it is
    ``capturable``."""
    count_dev = _count_device(params)
    opt = torch.optim.Adam(
        [{"params": [params[k]], "lr": lrs[k], "name": k} for k in params],
        betas=(0.9, 0.999), eps=eps, foreach=False, fused=False,
        capturable=count_dev.type == "cuda",
    )
    for k in params:
        p = params[k]
        opt.state[p] = {
            "step": torch.zeros((), dtype=torch.float32, device=count_dev),
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(
                p, memory_format=torch.preserve_format),
        }
    return opt


def make_optimizer(params: dict, cfg: TrainConfig,
                   features: FeatureConfig | None = None
                   ) -> torch.optim.Adam:
    """Per-parameter Adam groups matching reference train.py:394-401 (and,
    with ``features``, the feature leaf's and the decoder's)."""
    count_dev = _count_device(params)
    lr0 = position_lr(torch.zeros((), device=count_dev), cfg)
    lrs = dict(_fixed_lrs(cfg, features),
               pos=lr0 if count_dev.type == "cuda" else float(lr0))
    return _build_adam(params, lrs, cfg.adam_eps)


def _rebuild_optimizer(old: torch.optim.Adam,
                       params: dict) -> torch.optim.Adam:
    """A zeroed optimizer for new parameter tensors with ``old``'s LRs
    (the capturable position-LR tensor stays on the card) and eps."""
    lrs = {g["name"]: (g["lr"].clone() if isinstance(g["lr"], torch.Tensor)
                       else g["lr"]) for g in old.param_groups}
    return _build_adam(params, lrs, old.defaults["eps"])


class TrainState(NamedTuple):
    pool: GaussianPool
    opt_state: torch.optim.Adam
    step: torch.Tensor  # [] int32
    # Feature 3DGS's decoder ({"dec_w": [D, C], "dec_b": [D]} leaf
    # tensors) and its rates and loss weight when the pool carries
    # features, else None.
    decoder: dict | None = None
    features: FeatureConfig | None = None
    # A surfel pool's (2D Gaussian Splatting) loss weights and distortion
    # range, else None.
    surfel: SurfelConfig | None = None


def _leaves(state: TrainState) -> dict:
    """Every leaf the optimizer updates: the pool's, then the decoder's."""
    return {**state.pool.params, **(state.decoder or {})}


def init_train_state(pool: GaussianPool, cfg: TrainConfig,
                     features: FeatureConfig | None = None,
                     decoder: dict | None = None,
                     surfel: SurfelConfig | None = None) -> TrainState:
    """The state training starts from. A pool with features (``f_sem``
    [N, C]) needs Feature 3DGS's ``decoder`` (``dec_w`` [D, C], ``dec_b``
    [D], e.g. :func:`models.gaussians.init_decoder`), whose tensors
    become leaves, and trains with ``features`` (``FeatureConfig()``
    where None); a pool without takes neither. A surfel pool (a
    two-column ``scale_raw``) trains with ``surfel`` (``SurfelConfig()``
    where None); a 3DGS pool takes none."""
    dev = resolve_device(pool.pos.device)  # on CUDA: TF32 off for SSIM
    if is_surfel_pool(pool.params):
        if FEATURE_KEY in pool.params:
            raise ValueError("a surfel pool (two-column scale_raw) carries "
                             "no per-gaussian features (f_sem)")
        surfel = surfel or SurfelConfig()
    elif surfel is not None:
        raise ValueError("a SurfelConfig takes a surfel pool (a two-column "
                         "scale_raw)")
    if FEATURE_KEY not in pool.params:
        if features is not None or decoder is not None:
            raise ValueError("a decoder and a FeatureConfig take a pool with "
                             "per-gaussian features (f_sem)")
    else:
        if decoder is None:
            raise ValueError("a pool with per-gaussian features (f_sem) "
                             "trains with a decoder: pass decoder=")
        C = pool.f_sem.shape[1]
        w, b = decoder["dec_w"], decoder["dec_b"]
        if w.dim() != 2 or w.shape[1] != C or tuple(b.shape) != w.shape[:1]:
            raise ValueError(f"the decoder must be dec_w [D, {C}] and dec_b "
                             f"[D], got {tuple(w.shape)} and "
                             f"{tuple(b.shape)}")
        features = features or FeatureConfig()
        decoder = {k: torch.nn.Parameter(decoder[k].detach().to(
            dev, torch.float32).contiguous()) for k in DECODER_KEYS}
    return TrainState(
        pool=pool,
        opt_state=make_optimizer({**pool.params, **(decoder or {})}, cfg,
                                 features),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        decoder=decoder,
        features=features,
        surfel=surfel,
    )


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
    decoder: dict | None = None,
    features: FeatureConfig | None = None,
    surfel: SurfelConfig | None = None,
):
    """Mean L1+SSIM loss over a batch of views, rendered one after another.

    batch: dict with 'image' [B,H,W,3], 'c2w' [B,4,4], 'fx','fy','cx','cy'
    [B], tensors on the pool's device. uv_taps: optional [B, N, 2] zeros
    (the paper-ADC view-space tap, one per view). Returns (loss, metrics)
    with the metrics as tensors (capacities as ints): nothing here waits
    for the device. With ``cull_mode="ellipse"`` they gain the largest
    view's ``row_demand`` and ``row_capacity``. With ``tile_rank_cap``
    the metrics gain the largest
    view's ``trunc_demand`` and ``trunc_capacity`` (the truncated list's
    ``trunc_padded_pairs``); with ``bwd_pairs``, the largest view's
    ``bwd_demand`` and ``bwd_capacity`` (``backend="xla"`` has no
    backward demand: -1 per view, and no entry batched, as in JAX). With ``uv_taps`` they gain
    per-gaussian ``visible`` (views with a non-zero screen radius) and
    ``max_radius`` ([N] int32, detached).

    With ``train_cfg.batched_render`` the batch goes through one binning
    and one compositor launch (``render_batch_from_params``); the loss of
    the batch's images is the mean of the per-view losses up to the order
    of float sums. The demands and capacities are then the batch's
    (``pair_capacity`` B x ``max_pairs``, as the JAX package reports it).

    With ``decoder`` (params carrying ``f_sem``) each view's loss adds
    ``features.semantic_loss_weight`` times ``ops.losses.feature_loss`` of
    its feature map against ``batch["teacher"][i]`` ([B, D, h, w]), and
    the metrics gain ``feat_l1``; views go one at a time.

    With ``surfel`` (params of a surfel pool) each view renders through
    the surfel compositor and its loss adds ``ops.losses.geometry_loss``
    (the distortion and normal terms at ``surfel``'s weights); the metrics
    gain ``dist`` and ``normal``; views go one at a time.
    """
    if decoder is not None and train_cfg.batched_render:
        raise ValueError("per-gaussian features train one view at a time: "
                         "batched_render must be False")
    if surfel is not None and train_cfg.batched_render:
        raise ValueError("surfels train one view at a time: "
                         "batched_render must be False")
    if train_cfg.batched_render:
        imgs, aux = render_batch_from_params(
            params, batch["c2w"], batch["fx"], batch["fy"], batch["cx"],
            batch["cy"], render_cfg, alive=alive, uv_taps=uv_taps)
        total, comps = compute_loss(imgs, batch["image"],
                                    train_cfg.lambda_l1,
                                    train_cfg.lambda_ssim)
        metrics = {
            "l1": comps["l1"].detach(),
            "ssim": comps["ssim"].detach(),
            "pair_demand": aux.num_pairs,
            "pair_capacity": aux.pair_capacity,
        }
        if render_cfg.cull_mode == "ellipse":
            metrics["row_demand"] = aux.num_rows
            metrics["row_capacity"] = aux.row_capacity
        if render_cfg.tile_rank_cap:
            metrics["trunc_demand"] = aux.trunc_demand
            metrics["trunc_capacity"] = aux.trunc_capacity
        if render_cfg.bwd_pairs and aux.bwd_demand is not None:
            metrics["bwd_demand"] = aux.bwd_demand
            metrics["bwd_capacity"] = aux.bwd_capacity
        if uv_taps is not None:
            radii = aux.screen_radius.detach()  # [B, N]
            metrics["visible"] = torch.sum((radii > 0).to(torch.int32),
                                           dim=0, dtype=torch.int32)
            metrics["max_radius"] = torch.amax(radii, dim=0)
        return total, metrics
    totals, l1s, ssims, pairs, rows, tds, bds, radii, feats, geo = (
        [] for _ in range(10))
    for i in range(batch["c2w"].shape[0]):
        img, aux = render_from_params(
            params, batch["c2w"][i], batch["fx"][i], batch["fy"][i],
            batch["cx"][i], batch["cy"][i], render_cfg, alive=alive,
            uv_tap=None if uv_taps is None else uv_taps[i], surfel=surfel,
        )
        total, comps = compute_loss(img, batch["image"][i],
                                    train_cfg.lambda_l1,
                                    train_cfg.lambda_ssim)
        if surfel is not None:
            g, parts = geometry_loss(aux, batch["fx"][i], batch["fy"][i],
                                     batch["cx"][i], batch["cy"][i], surfel)
            total = total + g
            geo.append(torch.stack([parts["dist"], parts["normal"]]))
        if decoder is not None:
            fl = feature_loss(aux.features, batch["teacher"][i], decoder)
            total = total + features.semantic_loss_weight * fl
            feats.append(fl)
        totals.append(total)
        l1s.append(comps["l1"])
        ssims.append(comps["ssim"])
        pairs.append(aux.num_pairs)
        rows.append(aux.num_rows)
        tds.append(aux.trunc_demand)
        # backend="xla" reports no backward demand: -1, as in JAX.
        bds.append(aux.bwd_demand if aux.bwd_demand is not None
                   else torch.full((), -1, dtype=torch.int32,
                                   device=img.device))
        if uv_taps is not None:
            radii.append(aux.screen_radius.detach())
    metrics = {
        "l1": torch.mean(torch.stack(l1s)).detach(),
        "ssim": torch.mean(torch.stack(ssims)).detach(),
        "pair_demand": torch.max(torch.stack(pairs)),
        "pair_capacity": render_cfg.max_pairs,
    }
    if feats:
        metrics["feat_l1"] = torch.mean(torch.stack(feats)).detach()
    if geo:
        g = torch.mean(torch.stack(geo), dim=0).detach()
        metrics["dist"], metrics["normal"] = g[0], g[1]
    if render_cfg.cull_mode == "ellipse":
        # The row stage's capacity: its overflow drops whole gaussians,
        # so fit() reads and grows it.
        metrics["row_demand"] = torch.max(torch.stack(rows))
        metrics["row_capacity"] = render_cfg.row_capacity
    if render_cfg.tile_rank_cap:
        # The truncated list's own capacity (trunc_pairs): its overflow
        # drops whole trailing blocks, so fit() reads and grows it.
        metrics["trunc_demand"] = torch.max(torch.stack(tds))
        metrics["trunc_capacity"] = render_cfg.trunc_padded_pairs
    if render_cfg.bwd_pairs:
        # The compacted backward's capacity: its overflow drops the
        # trailing tiles' gradients, so fit() reads and grows it.
        metrics["bwd_demand"] = torch.max(torch.stack(bds))
        metrics["bwd_capacity"] = render_cfg.bwd_capacity
    if uv_taps is not None:
        radii = torch.stack(radii)  # [B, N]
        metrics["visible"] = torch.sum((radii > 0).to(torch.int32), dim=0,
                                       dtype=torch.int32)
        metrics["max_radius"] = torch.amax(radii, dim=0)
    return torch.mean(torch.stack(totals)), metrics


def _optimizer_tensors(opt: torch.optim.Adam) -> list:
    """Every tensor one update changes: parameters, moments, step counts."""
    out = []
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            out += [p, st["exp_avg"], st["exp_avg_sq"], st["step"]]
    return out


def tap_norm_sum(tap_grad: torch.Tensor,
                 render_cfg: RenderConfig) -> torch.Tensor:
    """``sum_v ||d loss / d uv_v * (W/2, H/2)||`` over the views of a
    ``[B, N, 2]`` tap gradient: [N]. The scale takes the pixel tap to the
    NDC units the paper thresholds."""
    ndc = torch.tensor([render_cfg.width * 0.5, render_cfg.height * 0.5],
                       dtype=torch.float32, device=tap_grad.device)
    g = tap_grad * ndc
    return torch.sum(torch.sqrt(g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]),
                     dim=0)


def value_and_grads(state: TrainState, batch: dict,
                    render_cfg: RenderConfig, train_cfg: TrainConfig):
    """The batch loss and its gradients, without the update: returns
    (loss, metrics, grads) and leaves each parameter's ``.grad`` set.

    With ``adc_mode == "paper"`` it also differentiates a zero view-space
    tap per view and adds ``uv_grad_sum`` to the metrics: the batch sum
    of per-view ``||d loss / d uv * (W/2, H/2)||`` ([N]). The tap is in
    pixels; the paper thresholds its statistic in NDC units (INRIA's
    ndc2Pix: d pix / d ndc = size / 2), so the scale keeps
    ``densify_grad_threshold`` at the paper's 2e-4 meaning.

    A state with a decoder (a pool with features) adds the feature term
    at ``state.features``' weight, and its grads hold the decoder's
    leaves too.
    """
    pool = state.pool
    params = pool.params
    for p in _leaves(state).values():
        p.grad = None
    taps = None
    if train_cfg.adc_mode == "paper":
        taps = torch.zeros((batch["c2w"].shape[0], pool.capacity, 2),
                           dtype=torch.float32, device=pool.pos.device,
                           requires_grad=True)
    loss, metrics = batch_loss_fn(
        apply_sh_warmup(params, state.step, train_cfg), pool.alive,
        batch, render_cfg, train_cfg, uv_taps=taps, decoder=state.decoder,
        features=state.features, surfel=state.surfel,
    )
    with span("gs.backward"):
        loss.backward()
    with torch.no_grad():
        if taps is not None:
            g = taps.grad if taps.grad is not None else torch.zeros_like(taps)
            metrics["uv_grad_sum"] = tap_norm_sum(g, render_cfg)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in _leaves(state).items()}
    return loss.detach(), metrics, grads


def apply_update(state: TrainState, loss: torch.Tensor, grads: dict,
                 train_cfg: TrainConfig, shard_sum=None, grid_max=None):
    """One optimizer update from the batch's loss and gradients, in
    place (:func:`ops.update.adam_update`): the position gradient clipped
    at ``grad_clip_pos``, dead slots' gradients zeroed, the position LR
    read from the optimizer's own count, Adam, and with ``nan_guard`` no
    write at all where the step is non-finite. On a gaussian-sharded pool
    ``shard_sum`` sums the clip's sum of squares over the shards and
    ``grid_max`` decides the NaN guard over every rank (both in-place
    all-reduces). Each leaf's ``.grad`` is left as the gradient the update
    took: the position leaf's clipped and masked in place, the others as
    they came (dead slots' rows unmasked). Returns (new_state, metrics:
    ``total``, ``pos_grad``, the clipped and masked position gradient,
    and with ``nan_guard`` ``nonfinite_skipped``)."""
    opt = state.opt_state
    metrics = {}
    with span("gs.update"), torch.no_grad():
        # The position schedule reads the optimizer's own update count.
        for group in opt.param_groups:
            if group["name"] == "pos":
                lr = position_lr(opt.state[group["params"][0]]["step"],
                                 train_cfg)
                group["lr"] = lr if group["capturable"] else float(lr)
        skipped, pos_grad = adam_update(
            opt, grads, state.pool.alive, loss, train_cfg.grad_clip_pos,
            shard_sum, grid_max, nan_guard=train_cfg.nan_guard)
        for group in opt.param_groups:  # the gradients the update took
            group["params"][0].grad = grads[group["name"]]
        if train_cfg.nan_guard:
            metrics["nonfinite_skipped"] = skipped
    new_state = state._replace(step=state.step + 1)
    metrics.update(total=loss, pos_grad=pos_grad)
    return new_state, metrics


def make_train_step(render_cfg: RenderConfig, train_cfg: TrainConfig):
    """Build the single-step update. Returns step_fn(state, batch) ->
    (new_state, metrics), updating the state's pool and optimizer in place.

    With ``train_cfg.adc_mode == "paper"`` the metrics also hold
    ``uv_grad_sum``, ``visible`` and ``max_radius`` (see
    :func:`value_and_grads`). A state whose pool carries features trains
    Feature 3DGS with ``state.features``: its batches carry ``teacher``
    maps, and the decoder is updated with the pool.
    """
    if train_cfg.adc_mode not in ("reference", "paper"):
        raise ValueError(f"unknown adc_mode {train_cfg.adc_mode!r}")

    def step_fn(state: TrainState, batch: dict):
        with span("gs.step"):
            loss, metrics, grads = value_and_grads(state, batch, render_cfg,
                                                   train_cfg)
            new_state, upd = apply_update(state, loss, grads, train_cfg)
        metrics.update(upd)
        return new_state, metrics

    return step_fn


# --------------------------------------------------------------------------
# ADC on the train state.
# --------------------------------------------------------------------------


def reset_opt_state_slots(opt: torch.optim.Adam,
                          slot_mask: torch.Tensor) -> torch.optim.Adam:
    """Zero the Adam moments (``exp_avg``, ``exp_avg_sq``) of the slots
    the ADC rewrote, in every leaf; the step counts stay, as optax leaves
    ``count``; the decoder's moments are not the slots'. In place;
    returns ``opt``."""
    with torch.no_grad():
        for group in opt.param_groups:
            if group["name"] in DECODER_KEYS:
                continue
            st = opt.state[group["params"][0]]
            for key in ("exp_avg", "exp_avg_sq"):
                m = st[key]
                m.masked_fill_(slot_mask.reshape((-1,) + (1,) * (m.dim() - 1)),
                               0.0)
    return opt


def map_capacity_leaves(state: TrainState, take) -> TrainState:
    """A new state whose capacity leaves, the parameters, ``alive`` and
    both Adam moments, are ``take(leaf, fill)`` (``fill``: what a new dead
    slot holds, -10 for ``opacity_raw``, False for ``alive``, else 0),
    with a new optimizer of the same LRs; Adam's step counts and the step
    stay. Growth, and the sharding of ``parallel``, are such maps."""
    old = state.opt_state
    with torch.no_grad():
        params = {k: take(v.detach(), -10.0 if k == "opacity_raw" else 0.0)
                  for k, v in state.pool.params.items()}
        pool = GaussianPool(params, take(state.pool.alive, False))
        opt = _rebuild_optimizer(old, {**pool.params,
                                       **(state.decoder or {})})
        for k, p_old in _leaves(state).items():
            p_new = pool.params[k] if k in pool.params else p_old
            src, dst = old.state[p_old], opt.state[p_new]
            dst["step"].copy_(src["step"])
            for key in ("exp_avg", "exp_avg_sq"):
                dst[key].copy_(src[key] if k in DECODER_KEYS
                               else take(src[key], 0.0))
    return state._replace(pool=pool, opt_state=opt)


def grow_state_capacity(state: TrainState, new_capacity: int) -> TrainState:
    """Grow the pool and the optimizer to a larger slot capacity.

    Growth changes shapes, so this builds a new ``GaussianPool`` (the old
    rows first; new rows zero, opacity_raw -10, dead) and a new optimizer
    with the same LRs, whose moments are the old ones followed by zero rows
    (the fresh-Adam state the ADC's moment reset would give them) and whose
    step counts are the old ones. ``fit()`` calls this when the ADC reports
    dropped spawns.
    """
    cap = state.pool.capacity
    if new_capacity <= cap:
        return state
    pad = new_capacity - cap
    return map_capacity_leaves(state, lambda x, fill: torch.cat(
        [x, x.new_full((pad,) + x.shape[1:], fill)]))


def adc_step(state: TrainState, pos_grad: torch.Tensor,
             generator: torch.Generator | None, thresholds,
             noise: torch.Tensor | None = None):
    """Densify/prune (reference form) + optimizer-moment reset, in place.
    ``thresholds`` = (opacity_threshold, max_grad, scale_threshold).
    Returns (state, AdcResult)."""
    opacity_threshold, max_grad, scale_threshold = thresholds
    result = densify_and_prune(
        state.pool, pos_grad, generator,
        opacity_threshold=opacity_threshold,
        max_grad=max_grad,
        scale_threshold=scale_threshold,
        noise=noise,
    )
    reset_opt_state_slots(state.opt_state, result.new_slot_mask)
    return state, result


def adc_step_paper(state: TrainState, avg_uv_grad: torch.Tensor,
                   max_radius: torch.Tensor,
                   generator: torch.Generator | None, cfg: TrainConfig,
                   noise: tuple | None = None):
    """Original-paper densify/prune + optimizer-moment reset, in place.
    Returns (state, AdcResult)."""
    result = densify_and_prune_paper(
        state.pool, avg_uv_grad, max_radius, generator,
        grad_threshold=cfg.densify_grad_threshold,
        min_opacity=cfg.min_opacity,
        percent_dense=cfg.percent_dense,
        scene_extent=cfg.scene_extent,
        max_screen_size=cfg.max_screen_size,
        noise=noise,
    )
    reset_opt_state_slots(state.opt_state, result.new_slot_mask)
    return state, result


def opacity_raise_step(state: TrainState) -> TrainState:
    raise_low_opacity(state.pool)
    return state


# --------------------------------------------------------------------------
# Checkpointing (params + optimizer state + alive + step).
# --------------------------------------------------------------------------

# optax's leaf order of the JAX package's optimizer state (multi_transform
# over the sorted leaf names; each an Adam (count, mu, nu), pos with its
# schedule's count after them). The port's float32 step counts are written
# as int32, Adam's count in both pos count slots.
OPT_LEAVES = tuple(
    (k, field)
    for k in sorted(PARAM_KEYS)
    for field in ("step", "exp_avg", "exp_avg_sq")
    + (("schedule_step",) if k == "pos" else ())
)


# The optimizer fields of the leaves outside the JAX layout (``f_sem`` and
# the decoder's), each saved as ``optx_<leaf>_<field>``.
EXTRA_OPT_FIELDS = ("step", "exp_avg", "exp_avg_sq")


def save_checkpoint(path, state: TrainState):
    """Single-file ``.npz`` checkpoint in the JAX package's layout:
    ``__step__``, ``__alive__``, ``__num_opt_leaves__`` (19),
    ``param_<name>`` and ``opt_0`` .. ``opt_18`` (``OPT_LEAVES``). A pool
    with features adds ``param_f_sem``, the decoder's ``decoder_dec_w``
    and ``decoder_dec_b``, and each of those three leaves' Adam state as
    ``optx_<leaf>_<field>`` (``EXTRA_OPT_FIELDS``)."""
    pool, opt = state.pool, state.opt_state
    leaves = []
    for k, field in OPT_LEAVES:
        st = opt.state[getattr(pool, k)]
        if field in ("step", "schedule_step"):
            leaves.append(np.asarray(int(st["step"]), np.int32))
        else:
            leaves.append(st[field].detach().cpu().numpy())
    extra = {}
    for k, p in _leaves(state).items():
        if k in PARAM_KEYS:
            continue
        st = opt.state[p]
        extra[f"optx_{k}_step"] = np.asarray(int(st["step"]), np.int32)
        for field in EXTRA_OPT_FIELDS[1:]:
            extra[f"optx_{k}_{field}"] = st[field].detach().cpu().numpy()
    np.savez(
        path,
        __step__=np.asarray(int(state.step), np.int32),
        __alive__=pool.alive.cpu().numpy(),
        __num_opt_leaves__=len(leaves),
        **{f"param_{k}": v.detach().cpu().numpy()
           for k, v in pool.params.items()},
        **{f"opt_{i}": x for i, x in enumerate(leaves)},
        **{f"decoder_{k}": v.detach().cpu().numpy()
           for k, v in (state.decoder or {}).items()},
        **extra,
    )


def restore_pool(path, device="cuda") -> GaussianPool:
    """Load only the Gaussian pool (params + alive) from a checkpoint
    (the single-file ``.npz`` of either package's ``save_checkpoint``)."""
    with np.load(path) as data:
        params = {
            k[len("param_"):]: data[k]
            for k in data.files
            if k.startswith("param_")
        }
        alive = data["__alive__"]
    return pool_from_numpy(params, alive, device)


def load_checkpoint(path, state: TrainState) -> TrainState:
    """Restore a checkpoint on ``state``'s device: a new pool (of the
    file's capacity) and a new optimizer with ``state``'s LRs, holding the
    file's moments and step counts (and a file's features and decoder,
    which ``state`` must have had too). Refuses a file whose optimizer
    leaves do not match (``OPT_LEAVES``) or whose two pos counts differ."""
    with np.load(path) as data:
        n = int(data["__num_opt_leaves__"])
        if n != len(OPT_LEAVES):
            raise ValueError(
                f"checkpoint has {n} optimizer leaves, expected "
                f"{len(OPT_LEAVES)} (optimizer config changed?)")
        leaves = dict(zip(OPT_LEAVES, (data[f"opt_{i}"] for i in range(n))))
        extra = {k[len("optx_"):]: data[k] for k in data.files
                 if k.startswith("optx_")}
        decoder = {k: data[f"decoder_{k}"] for k in DECODER_KEYS
                   if f"decoder_{k}" in data.files}
        step = int(data["__step__"])
    if int(leaves["pos", "step"]) != int(leaves["pos", "schedule_step"]):
        raise ValueError(
            f"checkpoint's pos Adam count {int(leaves['pos', 'step'])} and "
            f"schedule count {int(leaves['pos', 'schedule_step'])} differ; "
            f"the port keeps one count")
    dev = state.pool.pos.device
    pool = restore_pool(path, device=dev)
    decoder = {k: torch.nn.Parameter(torch.from_numpy(v).to(dev))
               for k, v in decoder.items()} or None
    params = {**pool.params, **(decoder or {})}
    if (FEATURE_KEY in params) != (state.decoder is not None):
        raise ValueError(
            "checkpoint and state disagree on features: "
            f"file {'with' if FEATURE_KEY in params else 'without'}, state "
            f"{'with' if state.decoder is not None else 'without'}")
    if is_surfel_pool(params) != (state.surfel is not None):
        raise ValueError(
            "checkpoint and state disagree on surfels: file "
            f"{'with' if is_surfel_pool(params) else 'without'}, state "
            f"{'with' if state.surfel is not None else 'without'}")
    opt = _rebuild_optimizer(state.opt_state, params)
    with torch.no_grad():
        for k, p in params.items():
            st = opt.state[p]
            if k in PARAM_KEYS:
                got = {f: leaves[k, f] for f in ("step", "exp_avg",
                                                 "exp_avg_sq")}
            else:
                got = {f: extra[f"{k}_{f}"] for f in EXTRA_OPT_FIELDS}
            st["step"].fill_(float(got["step"]))
            for field in ("exp_avg", "exp_avg_sq"):
                m = got[field]
                if m.shape != tuple(p.shape):
                    raise ValueError(f"checkpoint's {k} {field} has shape "
                                     f"{m.shape}, the parameter {tuple(p.shape)}")
                st[field].copy_(torch.from_numpy(m))
    return state._replace(
        pool=pool, opt_state=opt,
        step=torch.tensor(step, dtype=torch.int32, device=dev),
        decoder=decoder)


# --------------------------------------------------------------------------
# Collective checkpoints (torch.distributed.checkpoint), the counterpart of
# the JAX package's orbax pair (save_checkpoint_orbax :550,
# load_checkpoint_orbax :567).
# --------------------------------------------------------------------------


def _state_tree(state: TrainState, mesh=None) -> dict:
    """The checkpoint's tree (JAX's ``_state_tree``, :541-547): params,
    alive, the optimizer's per-leaf ``step``/``exp_avg``/``exp_avg_sq``
    and the step, as detached views of ``state``'s own tensors (a load
    writes through them). With ``mesh`` (a gaussian-sharded state, as
    ``parallel.shard_train_state`` lays it out) every capacity leaf is a
    ``DTensor`` sharded on dim 0 over the mesh's tile group, so the
    checkpoint holds each row once whatever grid wrote it."""
    wrap = lambda t: t  # noqa: E731
    if mesh is not None and mesh.shape["tile"] > 1:
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Shard

        dmesh = DeviceMesh.from_group(mesh.tile_group, mesh.device.type)

        def wrap(t):
            return DTensor.from_local(t, dmesh, [Shard(0)], run_check=False)

    pool, opt = state.pool, state.opt_state
    return {
        "params": {k: wrap(p.detach()) for k, p in pool.params.items()},
        "alive": wrap(pool.alive),
        "opt_state": {k: {"step": opt.state[p]["step"],
                          "exp_avg": wrap(opt.state[p]["exp_avg"]),
                          "exp_avg_sq": wrap(opt.state[p]["exp_avg_sq"])}
                      for k, p in pool.params.items()},
        "step": state.step,
    }


def save_checkpoint_dcp(path, state: TrainState, mesh=None):
    """Directory checkpoint through ``torch.distributed.checkpoint``: the
    counterpart of the JAX package's ``save_checkpoint_orbax``
    (sharding-aware, for training across processes, where one ``.npz``
    would race).

    Collective: every rank of the process group calls it alike. With
    ``mesh`` the state is gaussian-sharded (``parallel.shard_train_state``)
    and each rank writes its rows; without it the state is whole on every
    rank (one process, or the replicated grid), and the planner keeps one
    copy. Either checkpoint loads into any grid and into one process
    (:func:`load_checkpoint_dcp`)."""
    import torch.distributed.checkpoint as dcp

    with warnings.catch_warnings():
        # One process: DCP says it assumes no process group.
        warnings.filterwarnings("ignore", message=".*single process.*")
        dcp.save(_state_tree(state, mesh), checkpoint_id=os.fspath(path))


def load_checkpoint_dcp(path, state: TrainState, mesh=None) -> TrainState:
    """Restore a :func:`save_checkpoint_dcp` checkpoint into a state of
    matching structure and capacity, in place (the counterpart of
    ``load_checkpoint_orbax``): its parameters, alive mask, Adam moments
    and counts and step take the file's values; the LRs stay. With
    ``mesh`` the state is gaussian-sharded and each rank reads its rows,
    whatever grid wrote the file. Collective like the save. Returns the
    state."""
    import torch.distributed.checkpoint as dcp

    with torch.no_grad(), warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*single process.*")
        dcp.load(_state_tree(state, mesh), checkpoint_id=os.fspath(path))
    return state
