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

The ZeRO-style gaussian-sharded path, for scenes too large for one
rank's state: ``make_gauss_sharded_train_step`` (``:291-672``) with its
exchanges ``collect_all_gather`` (``:349-356``) and ``collect_ring``
(``:358-418``), ``band_localize`` (``:331-347``), ``shard_train_state``
(``:675-690``) and its inverse ``gather_train_state``, and the ADC on a
sharded pool (``adc_on_shards``; JAX runs it through GSPMD). Parameters,
gradients and Adam moments are split over ``tile``; each rank projects
its own gaussians with the full-frame camera and exchanges their screen
features, then bins and composites its band of the whole set.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import (FEATURE_KEY, RenderConfig, TrainConfig,
                      is_anchor_pool, is_surfel_pool)
from ..models.gaussians import GaussianPool
from ..ops.binning import bin_gaussians
from ..ops.gaussian import build_cov3d_packed
from ..ops.losses import compute_loss
from ..ops.projection import ProjectedGaussians, project_gaussians
from ..ops.rasterize import rasterize_binned
from ..ops.sh import evaluate_sh
from ..render import (render_batch_from_params, render_from_params,
                      stack_view_projections)
from ..train.trainer import (TrainState, apply_sh_warmup, apply_update,
                             map_capacity_leaves, tap_norm_sum)
from ..utils.profiling import span
from .mesh import DATA_AXIS, TILE_AXIS, Mesh


def _refuse_features(state: TrainState):
    """The sharded steps train plain 3DGS: a pool with per-gaussian
    features (Feature 3DGS) or of surfels (2D Gaussian Splatting) trains
    on one device."""
    if state.scaffold is not None or is_anchor_pool(state.pool.params):
        raise ValueError("the sharded train steps do not decode anchors "
                         "(Scaffold-GS): train an anchor pool on one device")
    if state.decoder is not None or FEATURE_KEY in state.pool.params:
        raise ValueError("the sharded train steps do not train per-gaussian "
                         "features (f_sem): train such a pool on one device")
    if state.surfel is not None or is_surfel_pool(state.pool.params):
        raise ValueError("the sharded train steps do not train surfels (a "
                         "two-column scale_raw): train such a pool on one "
                         "device")


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

    def step(state: TrainState, batch: dict):
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
        with span("gs.backward"):
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

    def step_fn(state: TrainState, batch: dict):
        _refuse_features(state)
        with span("gs.step"):
            return step(state, batch)

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


# --------------------------------------------------------------------------
# The gaussian-sharded (ZeRO-style) path: make_gauss_sharded_train_step
# (:291-672) and shard_train_state (:675-690).
# --------------------------------------------------------------------------


def shard_rows(capacity: int, mesh: Mesh) -> slice:
    """This rank's rows of a pool of ``capacity`` slots: ``[t*C/T,
    (t+1)*C/T)`` for tile coordinate t of T (ValueError unless T divides
    the capacity)."""
    n_tile = mesh.shape[TILE_AXIS]
    if capacity % n_tile:
        raise ValueError(f"pool capacity {capacity} does not split over "
                         f"the tile axis ({n_tile} ranks)")
    n = capacity // n_tile
    return slice(mesh.coord[1] * n, (mesh.coord[1] + 1) * n)


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Lay out a whole train state for :func:`make_gauss_sharded_train_step`.

    Every leaf whose dim 0 is the pool capacity C (the parameters,
    ``alive`` and both Adam moments) is cut to this rank's rows
    (:func:`shard_rows`); everything else (Adam's counts and LRs, the
    step) is replicated. The result is a :class:`TrainState` whose
    ``pool.capacity`` is the local C/T. ValueError unless T divides C;
    a one-band grid returns ``state`` itself."""
    _refuse_features(state)
    rows = shard_rows(state.pool.capacity, mesh)
    if mesh.shape[TILE_AXIS] == 1:
        return state
    return map_capacity_leaves(state, lambda x, _: x[rows].clone())


def gather_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The inverse of :func:`shard_train_state`: every capacity leaf
    all-gathered over the tile group, so every rank holds the whole state
    (collective over the group). A one-band grid returns ``state``."""
    n_tile = mesh.shape[TILE_AXIS]
    if n_tile == 1:
        return state
    return map_capacity_leaves(state,
                               lambda x, _: _all_gather_rows(x, mesh))


def _all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tile group's ``x`` stacked along dim 0 in rank order."""
    return _all_gather(x, mesh.tile_group, mesh.shape[TILE_AXIS], 0)


def _reduce_scatter_rows(g: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tile group's ``g`` summed, this rank's rows kept (dim 0)."""
    n = mesh.shape[TILE_AXIS]
    if n == 1:
        return g
    out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
    dist.reduce_scatter(out, list(g.contiguous().chunk(n)),
                        group=mesh.tile_group)
    return out


class _GatherShards(torch.autograd.Function):
    """All-gather of the shards' rows over the tile group; the backward is
    the reduce-scatter of the cotangent, so each rank gets its own rows
    summed over the bands (the true gradient: each band's backward
    already holds only its own rows of the image cotangent)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh = mesh
        return _all_gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_rows(g, ctx.mesh), None


def _permute(x: torch.Tensor, mesh: Mesh, shift: int) -> torch.Tensor:
    """``x`` sent to tile rank ``(t + shift) % T``; what tile rank
    ``(t - shift) % T`` sent returned (``lax.ppermute`` over the ring), as
    an all-to-all whose only non-empty split goes to the next rank. gloo
    takes it on both devices (its send and receive abort on CUDA tensors);
    NCCL runs it as grouped send/receive."""
    n = mesh.shape[TILE_AXIS]
    t = mesh.coord[1]
    x = x.contiguous()
    out = torch.empty_like(x)
    dst, src = (t + shift) % n, (t - shift) % n
    rows = x.shape[0]
    dist.all_to_all_single(
        out, x, [rows if r == src else 0 for r in range(n)],
        [rows if r == dst else 0 for r in range(n)],
        group=mesh.tile_group)
    return out


class _Ppermute(torch.autograd.Function):
    """One step of the ring: to the next tile rank; the backward sends the
    cotangent the other way round."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh = mesh
        return _permute(x, mesh, 1)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.mesh, -1), None


# Exchanged per gaussian: 10 floats (uv, depth, conic, opacity, rgb) that
# carry gradients, 6 int32 (radius, tile_min, tile_max, valid) that do not.
def _pack(proj: ProjectedGaussians, colors: torch.Tensor):
    f = torch.cat([proj.uv, proj.depth[..., None], proj.conic,
                   proj.opacity[..., None], colors], dim=-1)
    i = torch.cat([proj.radius[..., None], proj.tile_min, proj.tile_max,
                   proj.valid[..., None].to(torch.int32)], dim=-1)
    return f, i


def _unpack(f: torch.Tensor, i: torch.Tensor):
    proj = ProjectedGaussians(
        uv=f[..., 0:2], depth=f[..., 2], conic=f[..., 3:6],
        opacity=f[..., 6], radius=i[..., 0], tile_min=i[..., 1:3],
        tile_max=i[..., 3:5], valid=i[..., 5] != 0)
    return proj, f[..., 7:10]


def band_localize(proj: ProjectedGaussians, row0: int, band_rows: int,
                  tile: int) -> ProjectedGaussians:
    """Shift a full-frame projection into the band whose first tile row is
    ``row0``: v and the tile rows move up by ``row0`` (tiles) and the
    splats that miss the band's ``band_rows`` rows become invalid (JAX's
    ``band_localize``, :331-347, expression for expression)."""
    tmin_y = proj.tile_min[..., 1] - row0
    tmax_y = proj.tile_max[..., 1] - row0
    valid = proj.valid & (tmax_y >= 0) & (tmin_y <= band_rows - 1)
    tmin_y = torch.where(valid, torch.clamp(tmin_y, 0, band_rows - 1), 0)
    tmax_y = torch.where(valid, torch.clamp(tmax_y, 0, band_rows - 1), -1)
    shift = torch.tensor([0.0, float(row0 * tile)], dtype=torch.float32,
                         device=proj.uv.device)
    return proj._replace(
        uv=proj.uv - shift,
        valid=valid,
        tile_min=torch.stack([proj.tile_min[..., 0], tmin_y], dim=-1),
        tile_max=torch.stack([proj.tile_max[..., 0], tmax_y], dim=-1),
    )


def collect_all_gather(proj: ProjectedGaussians, colors: torch.Tensor,
                       mesh: Mesh, axis: int = 0):
    """The exchange (JAX's ``collect_all_gather``, :349-356): every shard's
    projections and colours, rows along ``axis``, all-gathered over the
    tile group in rank order (the pool's slot order). Gradients of the
    float fields return shard-local (reduce-scatter); the integer fields
    ride along. Returns (projections, colours) of the whole pool."""
    f, i = _pack(proj, colors)
    f = _GatherShards.apply(f.movedim(axis, 0), mesh).movedim(0, axis)
    i = _all_gather_rows(i.movedim(axis, 0), mesh).movedim(0, axis)
    return _unpack(f, i)


def collect_ring(proj: ProjectedGaussians, colors: torch.Tensor, mesh: Mesh,
                 row0: int, band_rows: int, tile: int, capacity: int):
    """The ring exchange (JAX's ``collect_ring``, :358-418): the shards
    travel the tile ring in T steps; at each the current piece is
    localized to this band and its valid splats are compacted, in ring
    order, into buffers of ``capacity`` rows (slot ``min(k, capacity)``
    of a ``capacity + 1`` buffer, the last row dropped, as JAX's
    ``mode="drop"``); then the piece moves to tile rank ``t + 1``
    (:class:`_Ppermute`; its backward streams the cotangent back). The
    kept rows are then put back in the pool's slot order, so that depth
    ties composite as the all-gather's do. The working set is
    O(capacity) instead of O(N). Returns (projections,
    colours) of the band, localized, and the overflow ``max(demand -
    capacity, 0)`` ([] int32), reported, never silent."""
    n_tile = mesh.shape[TILE_AXIS]
    t = mesh.coord[1]
    f, i = _pack(proj, colors)
    dev = f.device
    fbuf = f.new_zeros((capacity + 1, f.shape[1]))
    ibuf = torch.tensor([0, 0, 0, -1, -1, 0], dtype=torch.int32,
                        device=dev).repeat(capacity + 1, 1)
    # Each row's shard (unfilled rows: n_tile, after every shard).
    shard = torch.full((capacity + 1,), n_tile, dtype=torch.int64,
                       device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    for step in range(n_tile):
        piece, col = _unpack(f, i)
        piece = band_localize(piece, row0, band_rows, tile)
        sel = piece.valid
        k = count + torch.cumsum(sel.to(torch.int32), 0,
                                 dtype=torch.int32) - 1
        dest = torch.where(sel & (k < capacity), k, capacity).to(torch.int64)
        pf, pi = _pack(piece, col)
        fbuf = fbuf.index_copy(0, dest, pf)
        ibuf = ibuf.index_copy(0, dest, pi)
        shard = shard.index_fill(0, dest, (t - step) % n_tile)
        count = count + torch.sum(sel.to(torch.int32), dtype=torch.int32)
        if step < n_tile - 1:  # the last piece's move is never read
            f = _Ppermute.apply(f, mesh)
            i = _permute(i, mesh, 1)
    # Ring order -> the pool's slot order (shard by shard, as the
    # all-gather lays the set out): binning's stable depth sort then
    # breaks depth ties alike in both exchanges, so that they composite
    # the same pairs in the same order (JAX's buffer keeps ring order).
    order = torch.argsort(shard[:capacity], stable=True)
    band, band_colors = _unpack(fbuf[:capacity][order],
                                ibuf[:capacity][order])
    return band, band_colors, torch.clamp(count - capacity, min=0)


def make_gauss_sharded_render(render_cfg: RenderConfig, mesh: Mesh,
                              batched: bool = False, ring: bool = False,
                              ring_capacity: int | None = None):
    """The gaussian-sharded renderer that :func:`make_gauss_sharded_train_step`
    differentiates: fn(params, alive, views, uv_taps=None) -> (images [B,
    H, W, 3] on every rank of the tile group, this rank's worst [pairs,
    rows] band demand, the ring overflow ([] int32), ``radius`` [B,
    n_local] of the local shard's full-frame projections).

    ``params`` and ``alive`` are this rank's rows of the pool; ``views``
    holds ``c2w`` [B, 4, 4] and ``fx``, ``fy``, ``cx``, ``cy`` [B]. Per
    view each rank builds its gaussians' covariances and colours and
    projects them with the full-frame camera (JAX's
    ``render_band_gauss_sharded``, :422-450; every rank holds another
    shard, so band cameras would gather an inconsistent mix), the screen
    features are exchanged over the tile group (:func:`collect_all_gather`,
    or :func:`collect_ring` with ``ring``; its ``ring_capacity`` defaults
    to the whole pool), localized to this rank's band, binned and
    composited (K1 on CUDA; K2 in the backward); the bands are gathered.
    With ``batched`` (JAX's ``loss_fn_batched``, :456-520) the views go
    through one exchange, one binning and one K1 launch
    (``stack_view_projections``); the ring is per view, so ``batched``
    with ``ring`` raises ValueError. No background is added, as in JAX.
    """
    if batched and ring:
        raise ValueError(
            "batched_render with the ring exchange is not implemented (the "
            "ring is per view); use the all-gather exchange "
            "(gauss_sharded=True) or batched_render=False")
    n_tile = mesh.shape[TILE_AXIS]
    band_cfg, band_px = band_config(render_cfg, n_tile)
    band_rows = band_px // render_cfg.tile
    row0 = mesh.coord[1] * band_rows

    def project(params, alive, cov3d, c2w, fx, fy, cx, cy, tap):
        colors = evaluate_sh(params["f_dc"], params["f_rest"],
                             params["pos"], c2w)
        proj = project_gaussians(params["pos"], cov3d,
                                 params["opacity_raw"], c2w, fx, fy, cx, cy,
                                 render_cfg, extra_valid=alive, uv_tap=tap)
        return proj, colors

    def per_view(params, alive, views, taps):
        bands, demands, ovfs, radii = [], [], [], []
        for v in range(views["c2w"].shape[0]):
            cov3d = build_cov3d_packed(params["scale_raw"], params["q_raw"])
            proj, colors = project(
                params, alive, cov3d, views["c2w"][v], views["fx"][v],
                views["fy"][v], views["cx"][v], views["cy"][v],
                None if taps is None else taps[v])
            if ring:
                cap = (ring_capacity if ring_capacity is not None
                       else proj.uv.shape[0] * n_tile)
                band, band_colors, ovf = collect_ring(
                    proj, colors, mesh, row0, band_rows, render_cfg.tile,
                    cap)
            else:
                band, band_colors = collect_all_gather(proj, colors, mesh)
                band = band_localize(band, row0, band_rows, render_cfg.tile)
                ovf = torch.zeros((), dtype=torch.int32,
                                  device=colors.device)
            binning = bin_gaussians(band, band_cfg)
            img, _ = rasterize_binned(band, band_colors, binning, band_cfg)
            bands.append(gather_bands(img, render_cfg, mesh))
            demands.append(torch.stack([binning.num_pairs,
                                        binning.num_rows]))
            ovfs.append(ovf)
            radii.append(proj.radius)
        return (torch.stack(bands), torch.amax(torch.stack(demands), dim=0),
                torch.amax(torch.stack(ovfs)), torch.stack(radii))

    def all_views(params, alive, views, taps):
        B = views["c2w"].shape[0]
        cov3d = build_cov3d_packed(params["scale_raw"], params["q_raw"])
        projs, colors = [], []
        for v in range(B):
            proj, col = project(params, alive, cov3d, views["c2w"][v],
                                views["fx"][v], views["fy"][v],
                                views["cx"][v], views["cy"][v],
                                None if taps is None else taps[v])
            projs.append(proj)
            colors.append(col)
        proj_b = ProjectedGaussians(*(torch.stack(f) for f in zip(*projs)))
        # One exchange for the whole batch, rows along dim 1.
        full, colors_full = collect_all_gather(proj_b, torch.stack(colors),
                                               mesh, axis=1)
        band = band_localize(full, row0, band_rows, render_cfg.tile)
        stacked, bcfg = stack_view_projections(band, band_cfg)
        binning = bin_gaussians(stacked, bcfg)
        img, _ = rasterize_binned(
            stacked, colors_full.reshape(B * full.uv.shape[1], 3), binning,
            bcfg)
        bands = img.reshape(B, band_cfg.padded_height, render_cfg.width,
                            3)[:, :band_px]
        return (gather_bands(bands, render_cfg, mesh, axis=1),
                torch.stack([binning.num_pairs, binning.num_rows]),
                torch.zeros((), dtype=torch.int32, device=img.device),
                proj_b.radius)

    render = all_views if batched else per_view

    def render_fn(params, alive, views, uv_taps=None):
        dev = params["pos"].device
        views = {k: torch.as_tensor(views[k], dtype=torch.float32,
                                    device=dev)
                 for k in ("c2w", "fx", "fy", "cx", "cy")}
        return render(params, alive, views, uv_taps)

    return render_fn


def make_gauss_sharded_train_step(render_cfg: RenderConfig,
                                  train_cfg: TrainConfig, mesh: Mesh,
                                  ring: bool = False,
                                  ring_capacity: int | None = None):
    """The train step with the gaussian pool sharded over ``tile``
    (ZeRO-style: parameters, gradients and Adam moments each 1/T a rank;
    JAX's ``make_gauss_sharded_train_step``, :291-672).

    ``state`` is laid out by :func:`shard_train_state` (this rank's
    C/T rows) and ``batch`` is this rank's share of the views
    (:func:`local_batch`). The images come from
    :func:`make_gauss_sharded_render` (``batched_render`` batches its
    views; ``ring`` with ``batched_render`` raises ValueError); the loss
    is the mean of the views' losses, or the batch's when batched.

    Gradients. The exchange's backward is a reduce-scatter (or the ring's
    reverse permutes) and :func:`gather_bands`' backward keeps each
    band's rows, so each rank's gradients are its rows of the true
    gradient: unlike JAX (:570, :601) nothing is divided by ``n_tile``.
    They are averaged over ``data``; the position clip reads the whole
    pool's norm (the sum of squares summed over the tile group); the NaN
    guard decides over the whole grid. The update is applied in place, as
    ``make_train_step``.

    Metrics: ``total``, ``l1``, ``ssim`` (means over ``data``),
    ``pos_grad`` (this rank's rows, clipped and masked),
    ``max_band_pairs`` and ``ring_overflow`` (maxima over the grid),
    ``band_pair_capacity``; in ellipse mode ``row_demand`` and
    ``row_capacity``; with ``adc_mode="paper"`` ``uv_grad_sum``,
    ``visible`` and ``max_radius`` of this rank's rows over the global
    batch; with ``nan_guard`` ``nonfinite_skipped``.
    """
    if train_cfg.adc_mode not in ("reference", "paper"):
        raise ValueError(f"unknown adc_mode {train_cfg.adc_mode!r}")
    render = make_gauss_sharded_render(render_cfg, mesh,
                                       train_cfg.batched_render, ring,
                                       ring_capacity)
    n_tile, n_data = mesh.shape[TILE_AXIS], mesh.shape[DATA_AXIS]
    n_all = n_tile * n_data
    band_cfg, _ = band_config(render_cfg, n_tile)
    paper = train_cfg.adc_mode == "paper"

    def loss_fn(params, alive, batch, taps):
        imgs, demand, ovf, radii = render(params, alive, batch, taps)
        if train_cfg.batched_render:
            total, comps = compute_loss(imgs, batch["image"],
                                        train_cfg.lambda_l1,
                                        train_cfg.lambda_ssim)
            return (total, comps["l1"], comps["ssim"], demand, ovf,
                    radii.detach())
        totals, l1s, ssims = [], [], []
        for v in range(imgs.shape[0]):
            total, comps = compute_loss(imgs[v], batch["image"][v],
                                        train_cfg.lambda_l1,
                                        train_cfg.lambda_ssim)
            totals.append(total)
            l1s.append(comps["l1"])
            ssims.append(comps["ssim"])
        return (torch.mean(torch.stack(totals)),
                torch.mean(torch.stack(l1s)), torch.mean(torch.stack(ssims)),
                demand, ovf, radii.detach())

    def step(state: TrainState, batch: dict):
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
        total, l1, ssim, demand, ovf, radii = loss_fn(
            apply_sh_warmup(params, state.step, train_cfg), pool.alive,
            batch, taps)
        with span("gs.backward"):
            total.backward()
        with torch.no_grad():
            # Shard-local already (the exchange's reduce-scatter); the
            # mean over data in one all-reduce of every leaf.
            keys = list(params)
            grads = [params[k].grad if params[k].grad is not None
                     else torch.zeros_like(params[k]) for k in keys]
            flat = _reduce(torch.cat([g.reshape(-1) for g in grads]),
                           mesh.data_group, n_data) / n_data
            grads = dict(zip(keys, (
                f.view_as(g) for f, g in zip(
                    torch.split(flat, [g.numel() for g in grads]), grads))))
            losses = _reduce(torch.stack([total.detach(), l1.detach(),
                                          ssim.detach()]),
                             mesh.data_group, n_data) / n_data
            # The worst band's demand and ring overflow on the grid.
            worst = _reduce(torch.cat([demand.to(torch.int32),
                                       ovf.reshape(1).to(torch.int32)]),
                            None, n_all, dist.ReduceOp.MAX)
            cap_views = b_local if train_cfg.batched_render else 1
            metrics = {"l1": losses[1], "ssim": losses[2],
                       "max_band_pairs": worst[0],
                       "band_pair_capacity": band_cfg.max_pairs * cap_views,
                       "ring_overflow": worst[2]}
            if band_cfg.cull_mode == "ellipse":
                metrics["row_demand"] = worst[1]
                metrics["row_capacity"] = band_cfg.row_capacity * cap_views
            if paper:
                # This rank's rows: the tap gradients came back summed
                # over the bands; the mean over data is the global 1/B.
                tg = taps.grad if taps.grad is not None \
                    else torch.zeros_like(taps)
                metrics["uv_grad_sum"] = _reduce(
                    tap_norm_sum(tg, render_cfg), mesh.data_group,
                    n_data) / n_data
                metrics["visible"] = _reduce(
                    torch.sum((radii > 0).to(torch.int32), dim=0,
                              dtype=torch.int32), mesh.data_group, n_data)
                metrics["max_radius"] = _reduce(
                    torch.amax(radii, dim=0), mesh.data_group, n_data,
                    dist.ReduceOp.MAX)
        new_state, upd = apply_update(
            state, losses[0], grads, train_cfg,
            shard_sum=lambda t: _reduce(t, mesh.tile_group, n_tile),
            grid_max=lambda t: _reduce(t, None, n_all, dist.ReduceOp.MAX))
        metrics.update(upd)
        return new_state, metrics

    def step_fn(state: TrainState, batch: dict):
        _refuse_features(state)
        with span("gs.step"):
            return step(state, batch)

    return step_fn


def num_alive(pool: GaussianPool, mesh: Mesh | None = None) -> torch.Tensor:
    """The pool's alive count; over a gaussian-sharded ``mesh`` the sum of
    the shards' ([] int32, on every rank)."""
    n = pool.num_alive().to(torch.int32)
    if mesh is None or mesh.shape[TILE_AXIS] == 1:
        return n
    return _reduce(n.reshape(1), mesh.tile_group, mesh.shape[TILE_AXIS])[0]


def adc_on_shards(state: TrainState, mesh: Mesh, adc, *stats):
    """An ADC step on a gaussian-sharded state (JAX runs ``adc_step`` on
    the sharded global arrays through GSPMD; here one process per rank):
    the state and the shard-local statistics (``stats``, dim 0 the rows)
    are gathered over the tile group, ``adc(whole_state, *whole_stats)``
    (``train.trainer.adc_step`` / ``adc_step_paper`` with one seeded
    generator on every rank, so every rank draws the same noise) runs on
    every rank, and each keeps its rows, written into ``state`` in place.
    The result equals the single-rank ADC bit for bit. Returns (state,
    AdcResult) with the counts of the whole pool and ``new_slot_mask`` of
    this rank's rows."""
    if mesh.shape[TILE_AXIS] == 1:
        return adc(state, *stats)
    whole = gather_train_state(state, mesh)
    whole, result = adc(whole, *(_all_gather_rows(s, mesh) for s in stats))
    rows = shard_rows(whole.pool.capacity, mesh)
    with torch.no_grad():
        state.pool.alive.copy_(whole.pool.alive[rows])
        for k, p in state.pool.params.items():
            q = whole.pool.params[k]
            p.copy_(q[rows])
            src, dst = whole.opt_state.state[q], state.opt_state.state[p]
            dst["exp_avg"].copy_(src["exp_avg"][rows])
            dst["exp_avg_sq"].copy_(src["exp_avg_sq"][rows])
    return state, result._replace(pool=state.pool,
                                  new_slot_mask=result.new_slot_mask[rows])
