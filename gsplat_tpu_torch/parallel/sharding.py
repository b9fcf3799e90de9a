"""Rendering and training over a ``(data, tile)`` process grid.

Counterpart of ``gsplat_tpu/parallel/sharding.py`` for a replicated state:
``band_config`` (``:49-63``), ``render_band`` (``:66-76``),
``gather_bands`` (``:79-82``), ``make_sharded_train_step`` (``:85-289``),
``make_sharded_batch_render`` (``:693-754``) and ``make_sharded_render``
(``:757-785``). Each rank of the grid runs these with its own
:class:`~.mesh.Mesh`; the collectives are ``torch.distributed`` calls on
the mesh's groups.

* ``data``: each rank renders its share of the views; gradients are
  averaged over the axis.
* ``tile``: within a view each rank renders one horizontal band of tile
  rows. The band reuses the single-view pipeline unchanged: the principal
  point moves up by the band's first pixel row (``cy - band * band_px``),
  the height shrinks to the band, and the vertical frustum guard widens
  (``pix_guard_v``) so that splats centred in other bands still composite
  into this one. The band's K1 and K2 launches see only the band's pairs.
  The gathered image is the single-rank image.

Gradients. Every rank of a tile group evaluates the same loss on the same
gathered image, so each holds the same image cotangent; the backward of
:func:`gather_bands` hands each band its own rows of it, and the step
sums the parameter gradients over the tile group, which gives the true
gradient (JAX's transpose of ``all_gather`` hands each band an
``n_tile``-scaled cotangent and divides it out with ``pmean``). One
``all_reduce`` over the whole grid then sums over ``tile`` and ``data``,
and the step divides by the data size. Every rank applies the same
reduced gradient to the same replicated state, so parameters and Adam
moments stay bit-identical across ranks.

The ZeRO-style gaussian-sharded step, its ring, and ``shard_train_state``
are not ported yet (the next slice).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import RenderConfig, TrainConfig
from ..ops.losses import compute_loss
from ..render import render_batch_from_params, render_from_params
from ..train.trainer import (TrainState, apply_sh_warmup, apply_update,
                             tap_norm_sum)
from .mesh import DATA_AXIS, TILE_AXIS, Mesh


def band_config(cfg: RenderConfig, n_bands: int) -> tuple[RenderConfig, int]:
    """Render config for one horizontal band out of ``n_bands``.

    Returns (band_cfg, band_pixel_rows). Bands are tile-row aligned; the
    last band may cover padding rows (cropped after the gather).
    """
    rows = -(-cfg.tiles_y // n_bands)  # tile rows per band
    band_px = rows * cfg.tile
    band_cfg = cfg.with_(
        height=band_px,
        pix_guard_v=cfg.pix_guard + cfg.padded_height,
        # Each band sees ~1/n_bands of the pairs; keep capacity headroom x2.
        max_pairs=max(1024, (2 * cfg.max_pairs) // n_bands),
    )
    return band_cfg, band_px


def _reduce(t: torch.Tensor, group, n: int, op=dist.ReduceOp.SUM):
    """In-place all-reduce over ``group`` (``n`` ranks); the identity when
    ``n`` is 1."""
    if n > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(x: torch.Tensor, group, n: int, axis: int) -> torch.Tensor:
    """The ``n`` ranks' ``x`` concatenated along ``axis`` in rank order."""
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis)


class _GatherBands(torch.autograd.Function):
    """All-gather of the bands over the tile group; the backward keeps this
    band's rows of the (tile-replicated) cotangent."""

    @staticmethod
    def forward(ctx, band, mesh: Mesh, axis: int):
        ctx.band, ctx.axis, ctx.rows = mesh.coord[1], axis, band.shape[axis]
        return _all_gather(band, mesh.tile_group, mesh.shape[TILE_AXIS],
                           axis)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.axis, ctx.band * ctx.rows, ctx.rows), None, \
            None


def gather_bands(band_img: torch.Tensor, cfg: RenderConfig, mesh: Mesh,
                 axis: int = 0) -> torch.Tensor:
    """All-gather the bands along ``axis`` over the tile group -> the full
    image, cropped to ``cfg.height`` rows (on every rank of the group)."""
    full = _GatherBands.apply(band_img, mesh, axis)
    return full.narrow(axis, 0, cfg.height)


def _band_cy(cy, mesh: Mesh, band_px: int, like: torch.Tensor):
    """The band's principal point: ``cy - band * band_px`` (f32)."""
    cy = torch.as_tensor(cy, dtype=torch.float32, device=like.device)
    return cy - float(mesh.coord[1] * band_px)


def render_band(params, c2w, fx, fy, cx, cy, cfg: RenderConfig,
                band_cfg: RenderConfig, band_px: int, mesh: Mesh,
                alive=None, uv_tap=None):
    """Render this rank's band of the image: (band [band_px, W, 3],
    RenderAux)."""
    return render_from_params(
        params, c2w, fx, fy, cx, _band_cy(cy, mesh, band_px, params["pos"]),
        band_cfg, alive=alive, uv_tap=uv_tap)


def _alive_of(params, alive):
    if alive is None:
        return torch.ones(params["pos"].shape[0], dtype=torch.bool,
                          device=params["pos"].device)
    return alive


def make_sharded_render(render_cfg: RenderConfig, mesh: Mesh):
    """Band-parallel inference: fn(params, alive, c2w, fx, fy, cx, cy) ->
    the full [H, W, 3] image on every rank (one K1 launch per rank)."""
    band_cfg, band_px = band_config(render_cfg, mesh.shape[TILE_AXIS])

    @torch.no_grad()
    def render_fn(params, alive, c2w, fx, fy, cx, cy):
        band, _ = render_band(params, c2w, fx, fy, cx, cy, render_cfg,
                              band_cfg, band_px, mesh,
                              alive=_alive_of(params, alive))
        return gather_bands(band, render_cfg, mesh)

    return render_fn


def make_sharded_batch_render(render_cfg: RenderConfig, mesh: Mesh):
    """Data x band parallel inference: B poses -> [B, H, W, 3] images.

    The poses are split over ``data`` (rank d takes poses ``[d*B/D,
    (d+1)*B/D)``), each frame into bands over ``tile``; each rank renders
    its poses' bands through ``render_batch_from_params``, so one K1 launch
    per rank per call. The bands are gathered over the tile group, then
    the frames over the data group, so every rank returns all B frames.

    Returns fn(params, alive, c2w_b, fx, fy, cx, cy) with c2w_b [B, 4, 4],
    B a multiple of the data size (else ValueError); intrinsics may be
    scalars (shared) or [B].
    """
    n_tile, n_data = mesh.shape[TILE_AXIS], mesh.shape[DATA_AXIS]
    band_cfg, band_px = band_config(render_cfg, n_tile)

    @torch.no_grad()
    def render_fn(params, alive, c2w_b, fx, fy, cx, cy):
        dev = params["pos"].device
        c2w_b = torch.as_tensor(c2w_b, dtype=torch.float32, device=dev)
        B = c2w_b.shape[0]
        if B % n_data:
            raise ValueError(f"pose batch {B} not divisible by the mesh's "
                             f"data axis ({n_data})")
        bl = B // n_data
        sl = slice(mesh.coord[0] * bl, (mesh.coord[0] + 1) * bl)

        def local(x):
            x = torch.as_tensor(x, dtype=torch.float32, device=dev)
            return torch.broadcast_to(x, (B,))[sl]

        bands, _ = render_batch_from_params(
            params, c2w_b[sl], local(fx), local(fy), local(cx),
            _band_cy(local(cy), mesh, band_px, params["pos"]), band_cfg,
            alive=_alive_of(params, alive))
        full = gather_bands(bands, render_cfg, mesh, axis=1)
        return _all_gather(full, mesh.data_group, n_data, axis=0)

    return render_fn


def make_sharded_train_step(render_cfg: RenderConfig,
                            train_cfg: TrainConfig, mesh: Mesh):
    """The train step over the grid, with a replicated state.

    Returns step_fn(state, batch) -> (state, metrics), updating the
    state's pool and optimizer in place like ``make_train_step``.
    ``batch`` is this rank's share of the global batch: the views of its
    data coordinate (``data.GaussianDataset.device_batches(mesh=)`` yields
    them; ``local_batch`` cuts them from a global batch). Per view the
    band renders, the bands are gathered and the loss is the full image's;
    with ``train_cfg.batched_render`` the local views' bands render
    through one binning and one K1 launch.

    Metrics: ``total``, ``l1``, ``ssim`` (means over the data axis),
    ``pos_grad``, ``max_band_pairs`` (the largest band demand on any rank)
    and ``band_pair_capacity`` (the band's ``max_pairs``, times the local
    batch when batched); in ellipse mode ``row_demand`` and
    ``row_capacity`` likewise; with ``adc_mode="paper"`` ``uv_grad_sum``,
    ``visible`` and ``max_radius`` of the global batch; with
    ``nan_guard`` ``nonfinite_skipped``.
    """
    if train_cfg.adc_mode not in ("reference", "paper"):
        raise ValueError(f"unknown adc_mode {train_cfg.adc_mode!r}")
    n_tile, n_data = mesh.shape[TILE_AXIS], mesh.shape[DATA_AXIS]
    n_all = n_tile * n_data
    band_cfg, band_px = band_config(render_cfg, n_tile)
    paper = train_cfg.adc_mode == "paper"

    def loss_batched(params, alive, batch, taps):
        bands, aux = render_batch_from_params(
            params, batch["c2w"], batch["fx"], batch["fy"], batch["cx"],
            _band_cy(batch["cy"], mesh, band_px, params["pos"]), band_cfg,
            alive=alive, uv_taps=taps)  # [B_local, band_px, W, 3]
        full = gather_bands(bands, render_cfg, mesh, axis=1)
        total, comps = compute_loss(full, batch["image"],
                                    train_cfg.lambda_l1,
                                    train_cfg.lambda_ssim)
        # Packed as [pairs, rows] so the row demand rides the same max.
        demand = torch.stack([aux.num_pairs, aux.num_rows])
        radii = aux.screen_radius.detach() if paper else None
        return total, comps["l1"], comps["ssim"], demand, radii

    def loss_views(params, alive, batch, taps):
        totals, l1s, ssims, demands, radii = [], [], [], [], []
        for i in range(batch["c2w"].shape[0]):
            band, aux = render_band(
                params, batch["c2w"][i], batch["fx"][i], batch["fy"][i],
                batch["cx"][i], batch["cy"][i], render_cfg, band_cfg,
                band_px, mesh, alive=alive,
                uv_tap=None if taps is None else taps[i])
            img = gather_bands(band, render_cfg, mesh)
            total, comps = compute_loss(img, batch["image"][i],
                                        train_cfg.lambda_l1,
                                        train_cfg.lambda_ssim)
            totals.append(total)
            l1s.append(comps["l1"])
            ssims.append(comps["ssim"])
            demands.append(torch.stack([aux.num_pairs, aux.num_rows]))
            if paper:
                radii.append(aux.screen_radius.detach())
        return (torch.mean(torch.stack(totals)),
                torch.mean(torch.stack(l1s)), torch.mean(torch.stack(ssims)),
                torch.amax(torch.stack(demands), dim=0),
                torch.stack(radii) if paper else None)

    loss_fn = loss_batched if train_cfg.batched_render else loss_views

    def step_fn(state: TrainState, batch: dict):
        pool = state.pool
        params = pool.params
        for p in params.values():
            p.grad = None
        b_local = batch["c2w"].shape[0]
        taps = None
        if paper:
            taps = torch.zeros((b_local, pool.capacity, 2),
                               dtype=torch.float32, device=pool.pos.device,
                               requires_grad=True)
        total, l1, ssim, demand, radii = loss_fn(
            apply_sh_warmup(params, state.step, train_cfg), pool.alive,
            batch, taps)
        total.backward()
        with torch.no_grad():
            # Band partials summed over tile, then the mean over data: one
            # all-reduce of every leaf over the whole grid.
            keys = list(params)
            grads = [params[k].grad if params[k].grad is not None
                     else torch.zeros_like(params[k]) for k in keys]
            flat = _reduce(torch.cat([g.reshape(-1) for g in grads]), None,
                           n_all) / n_data
            grads = dict(zip(keys, (
                f.view_as(g) for f, g in zip(
                    torch.split(flat, [g.numel() for g in grads]), grads))))
            losses = _reduce(torch.stack([total.detach(), l1.detach(),
                                          ssim.detach()]),
                             mesh.data_group, n_data) / n_data
            # Worst band demand on the grid: an overflowing band drops
            # splats, so training must see it.
            demand = _reduce(demand.clone(), None, n_all, dist.ReduceOp.MAX)
            cap_views = b_local if train_cfg.batched_render else 1
            metrics = {"l1": losses[1], "ssim": losses[2],
                       "max_band_pairs": demand[0],
                       "band_pair_capacity": band_cfg.max_pairs * cap_views}
            if band_cfg.cull_mode == "ellipse":
                metrics["row_demand"] = demand[1]
                metrics["row_capacity"] = band_cfg.row_capacity * cap_views
            if paper:
                # The view-space gradient: band partials summed over tile
                # (the true per-view gradient), its norms summed over the
                # local views, the mean over data (the global 1/B).
                tg = taps.grad if taps.grad is not None \
                    else torch.zeros_like(taps)
                tg = _reduce(tg, mesh.tile_group, n_tile)
                metrics["uv_grad_sum"] = _reduce(
                    tap_norm_sum(tg, render_cfg), mesh.data_group,
                    n_data) / n_data
                # Visible in a view if any band saw a positive radius.
                radii = _reduce(radii.clone(), mesh.tile_group, n_tile,
                                dist.ReduceOp.MAX)  # [B_local, N]
                metrics["visible"] = _reduce(
                    torch.sum((radii > 0).to(torch.int32), dim=0,
                              dtype=torch.int32), mesh.data_group, n_data)
                metrics["max_radius"] = _reduce(
                    torch.amax(radii, dim=0), mesh.data_group, n_data,
                    dist.ReduceOp.MAX)
        new_state, upd = apply_update(state, losses[0], grads, train_cfg)
        metrics.update(upd)
        return new_state, metrics

    return step_fn


def local_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's share of a global batch: the views of its data
    coordinate (the batch must divide by the data size)."""
    n_data = mesh.shape[DATA_AXIS]
    B = batch["c2w"].shape[0]
    if B % n_data:
        raise ValueError(f"batch {B} not divisible by the mesh's data axis "
                         f"({n_data})")
    bl = B // n_data
    d = mesh.coord[0]
    return {k: v[d * bl:(d + 1) * bl] for k, v in batch.items()}
