"""Host-side training loop: it glues the batches, the train
step, the ADC schedule, opacity raises, checkpoints and metrics logging.

Counterpart of ``gsplat_tpu/train/fit.py`` (``FitReport`` :42, ``fit``
:55), on one device or over a ``(data, tile)`` process grid (``mesh``):
* the initial cloud is the dataset's point cloud when it offers one
  (``pointcloud_path()``), else a seeded random cloud;
* a dataset whose views fit under ``device_cache_bytes`` is kept on the
  device once (f32, else uint8) and each batch is a gather there;
* one train step for the whole run, updating the pool in place; the ADC
  runs on the device on the schedule's boundaries (``adc_step`` /
  ``adc_step_paper``), and zeroes only the moments of the slots it
  rewrote;
* the reference-mode statistic is an EMA of per-step position-gradient
  NORMS between ADC boundaries; the paper mode sums per-view view-space
  gradient norms, visibility counts and the largest screen radius;
* checkpoints hold the optimizer state, in the JAX package's ``.npz``
  layout;
* with ``features`` (Feature 3DGS) the pool starts with zero feature
  vectors and a drawn decoder, batches carry ``teacher`` maps, and the
  ADC's children copy their parent's features (one device only);
* ``max_pairs``, the pool capacity, in ellipse mode the row stage's
  ``max_rows``, with ``tile_rank_cap`` the truncated list's
  ``trunc_pairs`` and with ``bwd_pairs`` the compacted backward's
  capacity grow from the observed demand.

The host waits for the device where the JAX ``fit()`` does: at ``log_every``
boundaries (loss, alive count, pair demand) and on each densification
(the overflow count, and the ADC's own allocation of free slots).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..config import FeatureConfig, RenderConfig, TrainConfig
from ..data.pointcloud import load_point_cloud
from ..device import resolve_device
from ..models.adc import pos_grad_norm
from ..models.gaussians import (init_decoder, init_pool_from_points,
                                with_features)
from ..utils.logging import MetricsLogger
from ..parallel.mesh import TILE_AXIS
from ..parallel.sharding import (adc_on_shards, gather_train_state,
                                 local_batch, make_gauss_sharded_train_step,
                                 make_sharded_train_step, num_alive,
                                 shard_train_state)
from ..utils.memory import estimate_train_memory
from .trainer import (
    TrainState,
    adc_step,
    adc_step_paper,
    grow_state_capacity,
    init_train_state,
    load_checkpoint,
    make_train_step,
    opacity_raise_step,
    save_checkpoint,
)


@dataclass
class FitReport:
    """Summary of a fit() run (losses are host floats)."""

    iterations: int = 0
    final_loss: float = float("nan")
    losses: list = field(default_factory=list)
    num_gaussians: int = 0
    checkpoints: list = field(default_factory=list)
    wall_time_s: float = 0.0
    overflow_events: int = 0
    nonfinite_steps: int = 0  # updates skipped by the NaN guard


def _to_device(batch: dict, dev: torch.device) -> dict:
    """Batch arrays or tensors on ``dev``; floating ones as float32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t.to(dev, torch.float32 if t.is_floating_point() else None)
    return out


def _quiet(msg: str) -> None:
    """The log of a rank other than 0: nothing."""


def _local(batches, mesh):
    """Global batches -> this rank's views (unchanged without a mesh)."""
    if mesh is None:
        return batches
    return (local_batch(b, mesh) for b in batches)


def fit(
    dataset,
    render_cfg: RenderConfig,
    train_cfg: TrainConfig,
    output_dir: str | None = None,
    initial_points: np.ndarray | None = None,
    resume_from: str | None = None,
    mesh=None,
    gauss_sharded: bool = False,
    log_every: int = 50,
    log_fn: Callable[[str], None] = print,
    seed: int = 0,
    device="cuda",
    device_cache_bytes: int = 4 << 30,
    features: FeatureConfig | None = None,
    feature_dims: tuple[int, int] = (128, 512),
) -> tuple[TrainState, FitReport]:
    """Train a Gaussian pool on a dataset. Returns (state, report).

    Args:
        dataset: an iterator of batch dicts ('image' [B,H,W,3], 'c2w'
            [B,4,4], 'fx','fy','cx','cy' [B], arrays or tensors), or any
            object with ``.batches(batch_size, seed=...)`` returning one
            (``data.GaussianDataset``).
        initial_points: [N, 3|6] cloud; without it, the dataset's point
            cloud (``pointcloud_path()``, read by
            ``data.pointcloud.load_point_cloud``) where it offers one, else
            a seeded random 10k-point cloud.
        resume_from: a checkpoint (either package's ``.npz``) to continue
            from; it replaces the initial pool.
        mesh: this rank's ``(data, tile)`` grid (``parallel.make_mesh``):
            every rank calls ``fit()`` alike; the step is
            ``make_sharded_train_step``, each batch's views are split over
            ``data``, and the state stays replicated, bit-identical on
            every rank (the ADC draws from one seed on every rank). Only
            rank 0 logs and writes files. The device is the mesh's.
        gauss_sharded: with ``mesh``, ``True`` (the all-gather exchange)
            or ``"ring"`` trains the ZeRO-style gaussian-sharded step
            (``make_gauss_sharded_train_step``): the state is sharded over
            ``tile`` after init or resume (``shard_train_state``), the ADC
            gathers it and its statistics over the tile group and keeps
            each rank's rows (``adc_on_shards``, equal to the single-rank
            ADC), the logged alive count is the whole pool's, a ring
            overflow is logged, and checkpoints and the returned state
            are the gathered whole state (what JAX's global arrays read
            as). Without a mesh it is ignored, as in JAX.
        device: ``"cuda"`` (default; raises without a card) or ``"cpu"``.
        device_cache_bytes: when the dataset offers ``device_batches`` and
            its views fit under this many bytes, they are copied to the
            device once and each batch is a gather there: in f32 where
            ``size_bytes()`` fits, else as uint8 (``size_bytes(1)``,
            dequantized after the gather), else batches come from the host
            each step. 0 turns the cache off.
        features: train Feature 3DGS at these rates and loss weight
            (``config.FeatureConfig``). Not with ``mesh``.
        feature_dims: (C, D) with ``features``: the pool gets C zero
            feature floats a gaussian (as the authors' code starts them)
            and the decoder to D channels is drawn from ``seed``
            (``models.gaussians.init_decoder``); every batch must carry
            ``teacher`` [B, D, h, w].

    Static capacities grow from the observed demand: a pair-capacity
    overflow (checked at log_every boundaries; the steps between are still
    correct, farthest pairs dropped and reported) grows
    ``RenderConfig.max_pairs``, and an ADC spawn overflow grows the pool
    capacity. Both ratchet geometrically (>= 1.5x). With
    ``tile_rank_cap``, a truncated-list overflow (``trunc_demand`` above
    ``trunc_capacity``; whole trailing blocks dropped, reported) grows
    ``RenderConfig.trunc_pairs`` to 1.25x the demand, rounded up to 1,024.
    With ``bwd_pairs``, a compacted-backward overflow (``bwd_demand``
    above ``bwd_capacity``; the trailing tiles' gradients dropped, reported)
    grows ``RenderConfig.bwd_pairs`` the same way. In ellipse mode a
    row-stage overflow (``row_demand`` above ``row_capacity``; whole
    gaussians dropped, reported) grows ``RenderConfig.max_rows`` the same
    way. With ``batched_render`` these demands are the batch's; under a
    mesh ``max_pairs`` grows from the worst band's demand, and the pool
    does not grow (an ADC overflow is logged, as in JAX). The JAX
    ``fit()``'s ``auto_capacity=False``, which only logs the overflow, is
    not ported.
    """
    if features is not None and mesh is not None:
        raise ValueError("per-gaussian features train on one device: "
                         "fit(features=...) takes no mesh")
    dev = mesh.device if mesh is not None else resolve_device(device)
    sharded = mesh is not None and bool(gauss_sharded)
    main = mesh is None or mesh.rank == 0
    # Every rank gathers a sharded state for a checkpoint; rank 0 writes.
    checkpointing = bool(output_dir)
    if not main:
        output_dir = None
        log_fn = _quiet
    t0 = time.time()
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)

    # --- initialization cloud (train.py:341-370) ---
    if initial_points is None:
        pc_path = getattr(dataset, "pointcloud_path", lambda: None)()
        if pc_path:
            initial_points = load_point_cloud(pc_path)
            log_fn(f"init from {pc_path}: {initial_points.shape[0]} points")
        else:
            rng = np.random.default_rng(seed)
            pts = rng.normal(0.0, 1.5, (10_000, 3))
            pts[:, 2] += 4.0
            initial_points = pts.astype(np.float32)
            log_fn("no point cloud found; random 10k-point init")

    if initial_points.shape[0] > train_cfg.capacity:
        rng = np.random.default_rng(seed)
        keep = rng.choice(
            initial_points.shape[0], train_cfg.capacity // 2, replace=False
        )
        initial_points = initial_points[keep]
        log_fn(
            f"subsampled init cloud to {initial_points.shape[0]} "
            f"(capacity {train_cfg.capacity})"
        )

    pool = init_pool_from_points(
        initial_points,
        capacity=train_cfg.capacity,
        num_sh_bands=train_cfg.num_sh_bands,
        seed=seed,
        device=dev,
    )
    decoder = None
    if features is not None:
        C, D = feature_dims
        pool = with_features(pool, torch.zeros(
            pool.capacity, C, dtype=torch.float32, device=dev))
        decoder = init_decoder(C, D, seed, dev)
    state = init_train_state(pool, train_cfg, features, decoder)

    if resume_from:
        state = load_checkpoint(resume_from, state)
        log_fn(f"resumed from {resume_from} at step {int(state.step)}")

    def build_step(rcfg: RenderConfig):
        if sharded:
            return make_gauss_sharded_train_step(
                rcfg, train_cfg, mesh, ring=gauss_sharded == "ring")
        if mesh is not None:
            return make_sharded_train_step(rcfg, train_cfg, mesh)
        return make_train_step(rcfg, train_cfg)

    def whole(state):
        """The whole state (gathered over the tile group when sharded)."""
        return gather_train_state(state, mesh) if sharded else state

    if sharded:
        state = shard_train_state(state, mesh)
    step_fn = build_step(render_cfg)

    if hasattr(dataset, "__next__"):
        batches = _local(dataset, mesh)
    elif (
        device_cache_bytes
        and hasattr(dataset, "device_batches")
        and hasattr(dataset, "size_bytes")
        and dataset.size_bytes(1) <= device_cache_bytes
    ):
        # Cache tiers: f32 when it fits, else uint8 (a quarter of the
        # bytes, dequantized after the gather), else host batches.
        quantize = dataset.size_bytes() > device_cache_bytes
        log_fn(
            f"device-caching {len(dataset)} views "
            f"({dataset.size_bytes(1 if quantize else 4) / 1e6:.0f} MB"
            + (", uint8-quantized" if quantize else "")
            + (f", replicated over {mesh.size} devices)"
               if mesh is not None else ")")
        )
        batches = dataset.device_batches(
            train_cfg.batch_size, seed=seed, mesh=mesh, quantize=quantize,
            device=dev,
        )
    else:
        batches = _local(dataset.batches(train_cfg.batch_size, seed=seed),
                         mesh)

    report = FitReport()
    metrics_log = None
    if output_dir:
        metrics_log = MetricsLogger(log_dir=output_dir, name="train")
    gen = torch.Generator(device=dev).manual_seed(seed)
    # Accumulated position-gradient NORMS between ADC boundaries (an EMA of
    # per-step ||g||; norms, so oscillating gradients don't cancel).
    pos_grad_accum = None
    # Paper-mode ADC statistics: running sums of per-view view-space
    # gradient norms / visibility counts / max screen radius.
    paper_adc = train_cfg.adc_mode == "paper"
    uv_sum = vis_sum = rad_max = None
    skip_sum = None  # device-side accumulator (no per-step host sync)
    start = int(state.step)
    log_fn(
        f"training: {train_cfg.iterations} iters, batch "
        f"{train_cfg.batch_size}, capacity {train_cfg.capacity}, "
        f"{render_cfg.width}x{render_cfg.height}"
    )

    for it in range(start + 1, train_cfg.iterations + 1):
        batch = _to_device(next(batches), dev)
        state, metrics = step_fn(state, batch)

        if paper_adc:
            if uv_sum is None:
                uv_sum = metrics["uv_grad_sum"]
                vis_sum = metrics["visible"]
                rad_max = metrics["max_radius"]
            else:
                uv_sum = uv_sum + metrics["uv_grad_sum"]
                vis_sum = vis_sum + metrics["visible"]
                rad_max = torch.maximum(rad_max, metrics["max_radius"])
        else:
            g = pos_grad_norm(metrics["pos_grad"])
            pos_grad_accum = g if pos_grad_accum is None else (
                0.5 * pos_grad_accum + 0.5 * g
            )

        if "nonfinite_skipped" in metrics:
            s = metrics["nonfinite_skipped"]
            skip_sum = s if skip_sum is None else skip_sum + s

        if it % log_every == 0 or it == train_cfg.iterations:
            loss = float(metrics["total"])
            report.losses.append((it, loss))
            n_alive = int(num_alive(state.pool, mesh if sharded else None))
            # Pair-capacity overflow (one device: 'pair_demand'; a grid:
            # the worst band's 'max_band_pairs') is never silent; it also
            # grows max_pairs, so capacities need no hand-tuning.
            if "max_band_pairs" in metrics:
                demand = int(metrics["max_band_pairs"])
                cap_pairs = int(metrics["band_pair_capacity"])
            else:
                demand = int(metrics["pair_demand"])
                cap_pairs = int(metrics["pair_capacity"])
            if demand > cap_pairs:
                report.overflow_events += 1
                ratio = max(demand / cap_pairs * 1.25, 1.5)
                new_mp = -(-int(render_cfg.max_pairs * ratio) // 1024) * 1024
                est = estimate_train_memory(
                    render_cfg.with_(max_pairs=new_mp), train_cfg
                )
                log_fn(
                    f"iter {it}: pair overflow (demand {demand}, "
                    f"capacity {cap_pairs}) — growing max_pairs "
                    f"{render_cfg.max_pairs} -> {new_mp} (recompile; "
                    f"~{est['total_mb']:.0f} MB estimated step footprint)"
                )
                render_cfg = render_cfg.with_(max_pairs=new_mp)
                step_fn = build_step(render_cfg)
            # The ellipse's row stage: the same never-silent growth.
            if "row_demand" in metrics:
                rdemand = int(metrics["row_demand"])
                rcap = int(metrics["row_capacity"])
                if rdemand > rcap:
                    report.overflow_events += 1
                    new_mr = -(-int(rdemand * 1.25) // 1024) * 1024
                    log_fn(
                        f"iter {it}: row overflow (demand {rdemand}, "
                        f"capacity {rcap}) — growing max_rows -> "
                        f"{new_mr} (recompile)"
                    )
                    render_cfg = render_cfg.with_(max_rows=new_mr)
                    step_fn = build_step(render_cfg)
            # The truncated list has its own capacity (trunc_pairs): the
            # same never-silent growth (overflow drops trailing blocks).
            if "trunc_demand" in metrics:
                tdemand = int(metrics["trunc_demand"])
                tcap = int(metrics["trunc_capacity"])
                if tdemand > tcap:
                    report.overflow_events += 1
                    new_tp = -(-int(tdemand * 1.25) // 1024) * 1024
                    log_fn(
                        f"iter {it}: truncated-list overflow (demand "
                        f"{tdemand}, capacity {tcap}) — growing "
                        f"trunc_pairs -> {new_tp} (recompile)"
                    )
                    render_cfg = render_cfg.with_(trunc_pairs=new_tp)
                    step_fn = build_step(render_cfg)
            # The compacted backward too (overflow loses gradient blocks).
            if "bwd_demand" in metrics:
                bdemand = int(metrics["bwd_demand"])
                bcap = int(metrics["bwd_capacity"])
                if bdemand > bcap:
                    report.overflow_events += 1
                    new_bp = -(-int(bdemand * 1.25) // 1024) * 1024
                    log_fn(
                        f"iter {it}: backward-compaction overflow "
                        f"(demand {bdemand}, capacity {bcap}) — growing "
                        f"bwd_pairs -> {new_bp} (recompile)"
                    )
                    render_cfg = render_cfg.with_(bwd_pairs=new_bp)
                    step_fn = build_step(render_cfg)
            ring_ovf = int(metrics.get("ring_overflow", 0))
            if ring_ovf > 0:
                report.overflow_events += 1
                log_fn(
                    f"iter {it}: ring-stream overflow — a band needed "
                    f"{ring_ovf} more gaussian slots than ring_capacity; "
                    f"raise it (splats dropped are reported, never silent)"
                )
            log_fn(
                f"iter {it:6d}  loss {loss:.5f}  l1 {float(metrics['l1']):.5f}"
                f"  ssim {float(metrics['ssim']):.5f}  gaussians {n_alive}"
            )
            if metrics_log is not None:
                metrics_log.log(
                    it,
                    total=loss,
                    l1=float(metrics["l1"]),
                    ssim=float(metrics["ssim"]),
                    gaussians=n_alive,
                )

        # --- ADC schedule (train.py:543-574) ---
        if (
            it % train_cfg.densification_interval == 0
            and it < train_cfg.densify_until_iter
        ):
            if paper_adc:
                avg_uv = uv_sum / torch.clamp(vis_sum, min=1).to(torch.float32)

                def adc(st, avg, rad):
                    return adc_step_paper(st, avg, rad, gen, train_cfg)

                stats = (avg_uv, rad_max)
                uv_sum = vis_sum = rad_max = None
            else:
                def adc(st, grad):
                    return adc_step(st, grad, gen, (
                        train_cfg.prune_opacity_threshold,
                        train_cfg.max_grad,
                        train_cfg.scale_threshold,
                    ))

                stats = (pos_grad_accum,)
                pos_grad_accum = None
            if sharded:
                state, adc_result = adc_on_shards(state, mesh, adc, *stats)
            else:
                state, adc_result = adc(state, *stats)
            overflow = int(adc_result.num_overflowed)
            if overflow:
                report.overflow_events += 1
                cap_now = state.pool.capacity * (
                    mesh.shape[TILE_AXIS] if sharded else 1)
                if mesh is None:
                    new_cap = max(2 * cap_now, cap_now + 2 * overflow)
                    log_fn(
                        f"iter {it}: ADC overflow, {overflow} spawns "
                        f"dropped — growing pool capacity {cap_now} -> "
                        f"{new_cap} (recompile; dropped spawns re-fire at "
                        f"the next densification)"
                    )
                    state = grow_state_capacity(state, new_cap)
                else:
                    log_fn(
                        f"iter {it}: ADC overflow, {overflow} spawns "
                        f"dropped (pool capacity {cap_now})"
                    )

        if it % train_cfg.opacity_reset_interval == 0:
            state = opacity_raise_step(state)

        if checkpointing and it % train_cfg.checkpoint_interval == 0:
            full = whole(state)
            if output_dir:
                path = os.path.join(output_dir, f"checkpoint_{it:06d}.npz")
                save_checkpoint(path, full)
                report.checkpoints.append(path)

    if metrics_log is not None:
        metrics_log.close()
    state = whole(state)
    if output_dir:
        path = os.path.join(output_dir, "checkpoint_final.npz")
        save_checkpoint(path, state)
        report.checkpoints.append(path)
        with open(os.path.join(output_dir, "train_log.json"), "w") as f:
            json.dump(
                {
                    "losses": report.losses,
                    "iterations": train_cfg.iterations,
                    "overflow_events": report.overflow_events,
                },
                f,
            )

    report.iterations = train_cfg.iterations
    if skip_sum is not None:
        report.nonfinite_steps = int(skip_sum)
        if report.nonfinite_steps:
            log_fn(
                f"NaN guard skipped {report.nonfinite_steps} "
                f"non-finite update(s)"
            )
    report.final_loss = report.losses[-1][1] if report.losses else float("nan")
    report.num_gaussians = int(state.pool.num_alive())
    report.wall_time_s = time.time() - t0
    return state, report
