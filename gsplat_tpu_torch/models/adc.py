"""Adaptive density control (clone / split / prune) on a fixed-capacity pool.

Counterpart of ``gsplat_tpu/models/adc.py``: ``AdcResult``,
``densify_and_prune`` (the reference's thresholds), ``raise_low_opacity``
and ``densify_and_prune_paper`` (Kerbl et al. 2023, §5.2), with the same
masks, the same prefix-sum slot allocation and the same overflow count:
the i-th spawner takes the i-th free slot, spawns beyond the free slots
are dropped (lowest slot indices win) and counted, never silent.

PyTorch idiom: each function writes the pool IN PLACE, under
``torch.no_grad()``: the rows of its ``nn.Parameter``s that receive a
child, and its ``alive`` buffer. An optimizer keyed on those parameters
keeps its keys; ``new_slot_mask`` names the slots whose moments must be
reset (``train.trainer.reset_opt_state_slots``). The result's ``pool``
is the same module. Counts are 0-d int32 tensors on the pool's device.

Randomness comes from an explicit ``torch.Generator`` on the pool's
device. ``noise=`` supplies the standard-normal draws instead (the JAX
package's ``jax.random.normal`` draws, in the tests), so both packages can
be compared exactly.

A surfel pool (a two-column ``scale_raw``: 2D Gaussian Splatting) splits
in the surfel's tangent plane: its scales are taken as ``(s_u, s_v, 0)``,
so the third standard deviation of the draw is 0, and the offset is
rotated into the world by the surfel's rotation in both forms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.gaussian import quat_to_rotmat
from .gaussians import GaussianPool


class AdcResult(NamedTuple):
    pool: GaussianPool
    new_slot_mask: torch.Tensor  # [capacity] bool: slots whose moments reset
    num_pruned: torch.Tensor
    num_split: torch.Tensor
    num_cloned: torch.Tensor
    num_overflowed: torch.Tensor  # spawns dropped for lack of free slots


def _count(mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(mask.to(torch.int32)).to(torch.int32)


def allocate_slots(alive: torch.Tensor, spawn: torch.Tensor):
    """Prefix-sum slot allocation: spawner rank -> free slot index.

    Returns (fits [cap] bool, dest [cap] int32 with ``cap`` where a row
    does not fit, num_overflowed [] int32). The r-th spawner (in slot
    order) takes the r-th free slot (``~alive``); free slots are assigned
    uniquely by rank, so ``dest[fits]`` has no repeats.
    """
    cap = alive.shape[0]
    free = ~alive
    free_rank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    spawn_rank = torch.cumsum(spawn.to(torch.int32), 0, dtype=torch.int32) - 1
    num_free = _count(free)
    num_spawn = _count(spawn)
    slot_ids = torch.arange(cap, dtype=torch.int32, device=alive.device)
    # free_slot_of_rank[r] = index of the r-th free slot (0 past the last).
    free_slot_of_rank = torch.zeros(cap, dtype=torch.int32,
                                    device=alive.device)
    free_slot_of_rank[free_rank[free].long()] = slot_ids[free]
    fits = spawn & (spawn_rank < num_free)
    dest = torch.where(
        fits, free_slot_of_rank[torch.clamp(spawn_rank, 0, cap - 1).long()],
        cap)
    num_overflowed = torch.clamp(num_spawn - num_free, min=0)
    return fits, dest.to(torch.int32), num_overflowed


def _write_children(pool: GaussianPool, child: dict, fits, dest):
    """``param[dest[fits]] = child[fits]`` for every parameter: only the
    rows that fit, each to its own free slot. Returns the new-slot mask."""
    idx = dest[fits].long()
    for k, p in pool.params.items():
        p[idx] = child[k][fits]
    new_slot = torch.zeros_like(fits)
    new_slot[idx] = True
    return new_slot


def _scales3(scale_raw: torch.Tensor) -> torch.Tensor:
    """[cap, 3] scales: ``exp(scale_raw)``, a surfel's with a zero third
    (its normal's) column."""
    scales = torch.exp(scale_raw)
    if scales.shape[1] == 3:
        return scales
    return torch.cat([scales, torch.zeros_like(scales[:, :1])], dim=1)


def _rotate(q_raw: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """R @ e for [cap, 3] vectors ``e`` and each slot's rotation from its
    normalised quaternion, written out (no matmul)."""
    q = q_raw
    n4 = torch.sqrt(q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]
                    + q[:, 2] * q[:, 2] + q[:, 3] * q[:, 3])
    R = quat_to_rotmat(q / (n4[:, None] + 1e-12))  # [cap, 3, 3]
    return torch.stack([R[:, i, 0] * e[:, 0] + R[:, i, 1] * e[:, 1]
                        + R[:, i, 2] * e[:, 2] for i in range(3)], -1)


def pos_grad_norm(g: torch.Tensor) -> torch.Tensor:
    """Per-slot L2 norm of [cap, 3] vectors, summed in component order."""
    return torch.sqrt(g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1]
                      + g[:, 2] * g[:, 2])


def densify_and_prune(
    pool: GaussianPool,
    pos_grad: torch.Tensor,
    generator: torch.Generator | None = None,
    opacity_threshold: float = 0.01,
    max_grad: float = 0.01,
    scale_threshold: float = 0.01,
    noise: torch.Tensor | None = None,
) -> AdcResult:
    """One ADC step in the reference's form (reference train.py:89-195).

    * prune: alive slots with sigmoid(opacity) < opacity_threshold die;
    * split: alive slots with max(exp(scale)) > scale_threshold and
      ||grad_pos|| > max_grad spawn ONE child at pos + noise * scale * 0.1
      with scale_raw - 0.5; the parent is kept unchanged;
    * clone: alive slots with max scale <= scale_threshold and a high
      grad spawn an exact copy.

    ``pos_grad`` is [cap, 3] gradient vectors or a [cap] norm statistic
    (accumulate NORMS over an interval, never signed vectors).
    ``noise`` [cap, 3]: the standard-normal draws; else drawn from
    ``generator``. Pruned and new slots are in ``new_slot_mask``. A
    surfel's split offset is ``R (noise * (s_u, s_v, 0)) * 0.1``, in its
    tangent plane.
    """
    with torch.no_grad():
        params = pool.params
        opacity = torch.sigmoid(params["opacity_raw"])
        prune = pool.alive & (opacity < opacity_threshold)
        alive = pool.alive & ~prune

        grad_norm = pos_grad if pos_grad.dim() == 1 else pos_grad_norm(pos_grad)
        scales = torch.exp(params["scale_raw"])
        max_scale = torch.amax(scales, dim=-1)
        high_grad = grad_norm > max_grad
        split = alive & (max_scale > scale_threshold) & high_grad
        clone = alive & (max_scale <= scale_threshold) & high_grad
        fits, dest, num_overflowed = allocate_slots(alive, split | clone)

        if noise is None:
            noise = torch.randn(params["pos"].shape, generator=generator,
                                device=scales.device, dtype=scales.dtype)
        if scales.shape[1] == 3:
            offset = noise * scales * 0.1
        else:
            offset = _rotate(params["q_raw"],
                             noise * _scales3(params["scale_raw"])) * 0.1
        child = {k: v.detach() for k, v in params.items()}
        child["pos"] = params["pos"] + torch.where(split[:, None], offset, 0.0)
        child["scale_raw"] = params["scale_raw"] - torch.where(
            split[:, None], 0.5, 0.0)
        # Children are read from spawners (alive) and written to free
        # slots (~alive): disjoint rows, so writing in place is safe.
        new_slot = _write_children(pool, child, fits, dest)
        pool.alive.copy_(alive | new_slot)
        return AdcResult(
            pool=pool,
            new_slot_mask=new_slot | prune,  # pruned slots also reset
            num_pruned=_count(prune),
            num_split=_count(split & fits),
            num_cloned=_count(clone & fits),
            num_overflowed=num_overflowed,
        )


def raise_low_opacity(pool: GaussianPool) -> GaussianPool:
    """The reference's periodic opacity 'reset' (train.py:569-574): alive
    gaussians with opacity < 0.01 get opacity += 0.01 (in probability
    space, written back through the logit, in float32). In place."""
    with torch.no_grad():
        raw = pool.opacity_raw
        opacity = torch.sigmoid(raw)
        mask = pool.alive & (opacity < 0.01)
        bumped = torch.clamp(opacity + 0.01, 1e-7, 1 - 1e-7)
        raw.copy_(torch.where(mask, torch.log(bumped) - torch.log1p(-bumped),
                              raw))
    return pool


def densify_and_prune_paper(
    pool: GaussianPool,
    avg_uv_grad: torch.Tensor,
    max_radius: torch.Tensor,
    generator: torch.Generator | None = None,
    grad_threshold: float = 0.0002,
    min_opacity: float = 0.005,
    percent_dense: float = 0.01,
    scene_extent: float = 5.0,
    max_screen_size: int = 0,
    noise: tuple | None = None,
) -> AdcResult:
    """Original-paper ADC (Kerbl et al. 2023 §5.2), fixed-capacity form.

    * the statistic is the view-space positional gradient norm averaged
      over the views where the gaussian was visible (``avg_uv_grad``);
    * split vs clone at ``percent_dense * scene_extent``;
    * SPLIT samples two positions from the gaussian (pos + R (eps *
      scales)), divides the scales by 1.6, REPLACES the parent with child
      A and writes child B to a free slot; CLONE writes a copy;
    * with ``max_screen_size > 0``, gaussians whose radius exceeded it in
      a view, or whose largest scale exceeds 0.1 * scene_extent, die.

    ``noise``: the pair (eps_a, eps_b) of [cap, 3] standard-normal draws
    before the ``* scales``; else both drawn from ``generator``, a first.
    A surfel's scales are ``(s_u, s_v, 0)`` there.
    Replaced parents are in ``new_slot_mask`` with the pruned and new
    slots.
    """
    with torch.no_grad():
        params = pool.params
        pos, scale_raw = params["pos"], params["scale_raw"]
        f32 = scale_raw.dtype
        opacity = torch.sigmoid(params["opacity_raw"])
        scales = torch.exp(scale_raw)
        max_scale = torch.amax(scales, dim=-1)

        prune = pool.alive & (opacity < min_opacity)
        if max_screen_size > 0:
            prune |= pool.alive & (max_radius > max_screen_size)
            prune |= pool.alive & (max_scale > 0.1 * scene_extent)
        alive = pool.alive & ~prune

        high_grad = avg_uv_grad >= grad_threshold
        big = max_scale > percent_dense * scene_extent
        split = alive & big & high_grad
        clone = alive & ~big & high_grad
        fits, dest, num_overflowed = allocate_slots(alive, split | clone)

        scales3 = _scales3(scale_raw)
        if noise is None:
            noise = tuple(torch.randn(scales3.shape, generator=generator,
                                      device=scales.device, dtype=f32)
                          for _ in range(2))
        off_a, off_b = (_rotate(params["q_raw"], eps * scales3)
                        for eps in noise)
        log16 = torch.log(torch.tensor(1.6, dtype=f32, device=pos.device))
        split_scale_raw = scale_raw - log16

        child = {k: v.detach() for k, v in params.items()}
        child["pos"] = torch.where(split[:, None], pos + off_b, pos)
        child["scale_raw"] = torch.where(split[:, None], split_scale_raw,
                                         scale_raw)
        rep = split & fits
        child_a = pos + off_a  # read before any row is written
        new_slot = _write_children(pool, child, fits, dest)
        # A fitting split's parent slot takes child A in place.
        pos.copy_(torch.where(rep[:, None], child_a, pos))
        scale_raw.copy_(torch.where(rep[:, None], split_scale_raw, scale_raw))
        pool.alive.copy_(alive | new_slot)
        return AdcResult(
            pool=pool,
            new_slot_mask=new_slot | prune | rep,
            num_pruned=_count(prune),
            num_split=_count(split & fits),
            num_cloned=_count(clone & fits),
            num_overflowed=num_overflowed,
        )
