"""Device-memory footprint of the port's render and train steps.

Counterpart of ``gsplat_tpu/utils/memory.py``. The JAX package's keys keep
the JAX package's values exactly (``pair_features_mb``, ``sort_mb``,
``tile_planes_mb``, ``per_gaussian_mb``, ``backward_dfeat_mb``,
``optimizer_mb``, ``images_mb``): they count one XLA graph's dominant
arrays. ``total_mb`` is deliberately not JAX's total: it is the port's peak,
built from the tensors the port allocates, because the port's step differs
from the TPU graph in what it keeps. PyTorch runs eagerly and autograd
keeps every view's saved tensors until ``backward()``: the per-view step
(``train.trainer.batch_loss_fn``) renders all its views first, so all of
them hold their pair features, K1's block-start state and the per-gaussian
and per-pixel tensors autograd saves until the backward; ``batched_render``
holds one list of B times the capacity; ``bwd_pairs`` shrinks only the
backward's working set. The TPU estimate, one view's arrays, read 431 MB
for a step that peaked at 3.1 GiB on the card.

Every term is a tensor's shape times its dtype's size (the ``*_mb`` keys,
1e6 bytes), named for what the port allocates:

* held to the backward, per list (``ops/rasterize.py::_CompositeGathered``
  saves them): the gathered pair features ``[10, slots]`` f32, K1's
  block-start state ``[slots / G, 5, tile^2]`` f32, ``pair_slot``
  ``[slots]`` int32, K1's output ``[tiles, 8, tile^2]`` f32;
* held to the backward, per view: :data:`AUTOGRAD_FLOATS_PER_GAUSSIAN`
  floats a pool slot (what autograd saves in covariance, SH, projection
  and the depth order) and :data:`LOSS_FLOATS_PER_PIXEL` floats a pixel
  (the image clip and L1 + SSIM);
* the backward's working set on one list (``_CompositeGathered.backward``):
  K2's zero-filled gradient ``[10, cols]`` f32, the reduction's keys
  (int32), the stable sort's values and indices (int32, int64), the rows
  gathered in sorted order and their contiguous copy for
  ``segment_reduce`` (``[cols, 10]`` f32 each), and the cotangent of K1's
  output; ``cols`` is the list's slots, or ``kb * G`` with ``bwd_pairs``;
* the forward's working sets: the gather (``_gather``: its int64 index,
  the ``index_select`` result, the masked copy, the mask; a served frame
  builds no pair list, only the depth-ordered ``[N, 12]`` table K1 reads
  by slot) and binning at
  its sort (``ops/binning.py``: the expansion's int64 owner slot and tile,
  its mask, the int64 key, the sort's values and indices and the radix
  sort's alternate buffers), and the SSIM map's temporaries;
* the state: parameters, Adam's two moments, the batch's ground truth on
  the device and, at the update, the gradients (the update,
  ``ops.update.adam_update``, works in place and keeps no copy).

The peak is the largest of the step's phases: the last list's binning and
its gather, the loss at the end of the forward, the first compositor
backward (the last view's, after its loss's saved tensors are freed) and
the update. Allocator rounding and kernels' scratch are not counted.
"""

from __future__ import annotations

from ..config import RenderConfig, TrainConfig, cdiv

_F32 = 4
_PARAM_FLOATS = 3 + 3 + 4 + 1 + 3 + 45  # pos/scale/quat/opacity/f_dc/f_rest
# Floats a pool slot of the tensors autograd saves for one view at SH
# degree 3, by stage: SH 89 (the [N, 16, 3] packed coefficients 48, the
# basis 16 and its 7 products and the colour's sigmoid terms 25);
# covariance 46 (the scale and rotation chain of build_cov3d_packed,
# normalize_quat, exp_scale); projection 87 (camera-space rows and the
# projected conic's quadratic forms 51.5, the clamps' masks and operands
# 23, the eigenvalue clamp 5.25, the 2x2 inverse 4, the integer casts'
# masks 3.25); the depth order's int64 index 2.
AUTOGRAD_FLOATS_PER_GAUSSIAN = 224
# Floats a pixel autograd saves for one view's loss: SSIM 54 (the five
# stacked statistics and their blur, 3 channels each, and 24 of the SSIM
# map's products), the image clip 14 (the [H, W, 5] planes and its
# masks), L1 3 (the sign of the difference).
LOSS_FLOATS_PER_PIXEL = 71
# The SSIM map's temporaries beyond what it saves: mu1^2, mu2^2, mu1 mu2
# and the three (co)variances, 3 channels each.
LOSS_TRANSIENT_FLOATS_PER_PIXEL = 18
# Bytes a (pair, tile) slot of K1's list while it is gathered: int64
# index 8, index_select result 40, masked copy 40, mask 1.
GATHER_BYTES_PER_SLOT = 8 + 40 + 40 + 1
# Bytes a gaussian of the depth-ordered table a served frame's K1 reads by
# slot ([N, 12] f32, written by one kernel, raster_cuda.pair_table)
TABLE_BYTES_PER_GAUSSIAN = 48
# Bytes a pair of max_pairs at binning's sort: owner slot and tile 16,
# mask 1, key 8, sorted values and indices 16, the radix sort's alternate
# key and index buffers 16.
BINNING_BYTES_PER_PAIR = 16 + 1 + 8 + 16 + 16
# Bytes a gradient column of the compositor's backward: K2's gradient
# 40, keys 4, sorted keys and indices 12, sorted rows 40, their
# contiguous copy 40.
BACKWARD_BYTES_PER_COLUMN = 40 + 4 + 12 + 40 + 40


def _mb(nbytes) -> float:
    return nbytes / 1e6


def _jax_render_terms(cfg: RenderConfig, n: int) -> dict:
    """The JAX package's render keys, its values (bytes)."""
    cap = cfg.padded_pairs
    p = cfg.tile * cfg.tile
    return {
        "pair_features_mb": 16 * cap * _F32,  # feature-major [16, padded]
        "sort_mb": 4 * cap * _F32,  # keys + payload + sorted pair
        "tile_planes_mb": cfg.num_tiles * 8 * p * _F32,
        "per_gaussian_mb": (_PARAM_FLOATS + 16) * n * _F32,
    }


def _list_terms(cfg: RenderConfig) -> dict:
    """What one pair list keeps to the backward, in bytes."""
    slots = cfg.padded_pairs
    p = cfg.tile * cfg.tile
    return {
        "saved_pair_features": 10 * slots * _F32,
        "block_state": slots // cfg.pair_block * 5 * p * _F32,
        "pair_slot": slots * 4,
        "tile_out": cfg.num_tiles * (8 * p * _F32 + 2 * 4),
    }


def estimate_render_memory(cfg: RenderConfig, n_gaussians: int) -> dict:
    """Peak device bytes of one served frame (no autograd), in MB: the
    JAX package's keys with its values, and the port's terms: the
    parameters, the projection's per-gaussian outputs and the larger of
    binning's and K1's working sets (with ``pair_slot``), summed in
    ``total_mb``. No pair list is gathered: K1 reads the depth-ordered
    table by slot."""
    n = n_gaussians
    jax = _jax_render_terms(cfg, n)
    params = _PARAM_FLOATS * n * _F32
    projected = 16 * n * _F32
    slot = cfg.padded_pairs * 4
    tile_out = cfg.num_tiles * 8 * cfg.tile * cfg.tile * _F32
    # Binning at its sort; K1 (the table and the output).
    transient = max(BINNING_BYTES_PER_PAIR * cfg.max_pairs,
                    slot + TABLE_BYTES_PER_GAUSSIAN * n + tile_out)
    total = params + projected + transient
    out = {k: _mb(v) for k, v in jax.items()}
    out.update(params_mb=_mb(params), projected_mb=_mb(projected),
               pair_slot_mb=_mb(slot), forward_working_mb=_mb(transient),
               total_mb=_mb(total))
    return out


def _train_parts(cfg: RenderConfig, train_cfg: TrainConfig, n: int,
                 rows: int, views: int, lists: list, kb_cols: int,
                 exchanged: int = 0) -> dict:
    """The step's parts (bytes): ``n`` gaussians rendered per view, ``rows``
    pool rows held by this process, ``views`` views, ``lists`` the pair
    lists' configs, ``kb_cols`` the backward's gradient columns, and
    ``exchanged`` bytes a view holds of an exchanged set (0 on one
    device)."""
    hw = cfg.height * cfg.width
    held_lists = {}
    for lc in lists:
        for k, v in _list_terms(lc).items():
            held_lists[k] = held_lists.get(k, 0) + v
    gauss = views * AUTOGRAD_FLOATS_PER_GAUSSIAN * n * _F32
    loss = views * LOSS_FLOATS_PER_PIXEL * hw * _F32
    held = sum(held_lists.values()) + gauss + loss + views * exchanged
    big = max(lists, key=lambda lc: lc.padded_pairs)
    tile_grad = big.num_tiles * 8 * big.tile * big.tile * _F32
    backward = BACKWARD_BYTES_PER_COLUMN * kb_cols + tile_grad
    # The loss saved for the last view (per view) or the batch is freed
    # before its compositor's backward runs.
    loss_last = loss if len(lists) == 1 else loss // views
    params = _PARAM_FLOATS * rows * _F32
    adam = 2 * params
    images = train_cfg.batch_size * hw * 3 * _F32
    taps = 2 * views * n * 2 * _F32 if train_cfg.adc_mode == "paper" else 0
    state = params + adam + images + taps
    ssim_tmp = LOSS_TRANSIENT_FLOATS_PER_PIXEL * hw * _F32 * (
        views if len(lists) == 1 else 1)
    # Before the last list's binning: everything else is held already.
    last = lists[-1]
    before = state + held - sum(_list_terms(last).values()) - loss_last
    phases = {
        "binning": before + BINNING_BYTES_PER_PAIR * last.max_pairs,
        "gather": before + (4 + GATHER_BYTES_PER_SLOT) * last.padded_pairs,
        "loss": state + held + ssim_tmp,
        "backward": state + held - loss_last + backward,
        "update": state + params,
    }
    peak = max(phases, key=phases.get)
    return {"held_lists": held_lists, "held_gauss": gauss, "held_loss": loss,
            "held": held, "backward": backward, "params": params,
            "adam": adam, "images": images, "phases": phases, "peak": peak}


def estimate_train_memory(
    cfg: RenderConfig, train_cfg: TrainConfig, n_gaussians: int | None = None,
    *, gauss_sharded_tile: int = 1,
) -> dict:
    """Peak device bytes of one training step (fwd + bwd + Adam), in MB.

    The JAX package's keys with its values, and the port's terms: the
    views live at the backward (``views_live``), what each keeps to it and
    their sum (``held_to_backward_mb``), the backward's and the forward's
    working sets, the parameters, Adam's moments and the batch's images,
    each phase's total and the largest (``total_mb``, at
    ``peak_phase``). ``gauss_sharded_tile`` > 1: one rank of the
    gaussian-sharded step over that many tile ranks (its C/T rows of the
    parameters, moments and projections, the whole exchanged set per view
    and its band's pair list)."""
    n = n_gaussians if n_gaussians is not None else train_cfg.capacity
    # The JAX package's estimate, its keys and values.
    fwd = _jax_render_terms(cfg, n)
    mult = train_cfg.batch_size if train_cfg.batched_render else 1
    dfeat = 16 * cfg.padded_pairs * _F32 * mult
    opt_state = 2 * _PARAM_FLOATS * train_cfg.capacity * _F32
    images = 3 * cfg.height * cfg.width * _F32 * train_cfg.batch_size * 2
    out = {k: _mb(v) * (mult if "pair" in k or "sort" in k or "tile" in k
                        else 1) for k, v in fwd.items()}
    out.update(backward_dfeat_mb=_mb(dfeat), optimizer_mb=_mb(opt_state),
               images_mb=_mb(images))

    B = train_cfg.batch_size
    T = gauss_sharded_tile
    rows = train_cfg.capacity // T
    lcfg, exchanged = cfg, 0
    if T > 1:
        # The band's list (parallel.sharding.band_config) and, per view,
        # the exchanged set: 10 floats and 6 int32 a gaussian, gathered,
        # and the band's localized copies of uv, tile rows and validity.
        tiles_y = cdiv(cfg.tiles_y, T)
        lcfg = cfg.with_(height=tiles_y * cfg.tile,
                         max_pairs=max(1024, 2 * cfg.max_pairs // T))
        exchanged = (10 + 6 + 2 + 4 + 1) * train_cfg.capacity * _F32
    if train_cfg.batched_render:
        views_live = B
        bcfg = lcfg.with_(height=B * lcfg.padded_height,
                          max_pairs=B * lcfg.max_pairs,
                          bwd_pairs=B * lcfg.bwd_pairs,
                          view_tile_rows=lcfg.tiles_y)
        lists = [bcfg]
    else:
        views_live = B
        lists = [lcfg] * B
    big = lists[0]
    nb = big.padded_pairs // big.pair_block
    cols = (min(cdiv(big.bwd_pairs, big.pair_block), nb) * big.pair_block
            if big.bwd_pairs else big.padded_pairs)
    parts = _train_parts(cfg, train_cfg, n // T if T > 1 else n, rows,
                         views_live, lists, cols, exchanged)
    hl = parts["held_lists"]
    out.update(
        views_live=views_live,
        saved_pair_features_mb=_mb(hl["saved_pair_features"]),
        block_state_mb=_mb(hl["block_state"]),
        pair_slot_mb=_mb(hl["pair_slot"]),
        tile_out_mb=_mb(hl["tile_out"]),
        autograd_per_gaussian_mb=_mb(parts["held_gauss"]),
        loss_saved_mb=_mb(parts["held_loss"]),
        held_to_backward_mb=_mb(parts["held"]),
        backward_working_mb=_mb(parts["backward"]),
        params_mb=_mb(parts["params"]),
        adam_mb=_mb(parts["adam"]),
        batch_images_mb=_mb(parts["images"]),
        **{f"{k}_phase_mb": _mb(v) for k, v in parts["phases"].items()},
        peak_phase=parts["peak"],
        total_mb=_mb(parts["phases"][parts["peak"]]),
    )
    return out
