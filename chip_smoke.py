#!/usr/bin/env python
"""GPU smoke test of the PyTorch/CUDA port (gsplat_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):
  1. card check: torch.cuda.is_available(); the card's name and power limit;
  2. build every kernel of the serving, training and profiling paths from
     ``gsplat_tpu_torch/ops/csrc`` (raster_fwd = K1, raster_bwd = K2,
     raster_ablate = K3's eight bodies: six built from K1's own kernel,
     raster_fwd_kernel.cuh, and pg-roll, pg-log in their own tensor-core
     template; one nvcc per source, all started together), with ptxas
     registers/spills (a spill fails the run) and K1's registers, shared
     memory and CTAs per SM, which must stay as K1_RESOURCES;
 2b. the binning kernels (binning.cu: emission, tile sort, aligned
     scatter) against the plain steps on profile_binning.kernel_cases
     (binning_phase: the checkpoint's orbit, three stacked views, the
     ellipse cull and the rank truncation; the 3 M garden scene near the
     origin camera and at a third of its capacity), every TileBinning
     field bit for bit and each launch counter risen; each kernel's time
     at the 3 M frame beside its plain version's and its bound by bytes;
 2c. Feature 3DGS's compositors (raster_feat.cu: F1, the feature map,
     and F2, its backward; feat_phase): on the 3 M garden scene with 128
     feature channels at 1297x840, F1 against its plain version bit for
     bit, F2 within FEAT_BWD_TOL in d f_sem and the six geometry rows,
     each kernel's time beside its plain version's and its bound, then
     FEAT_STEPS x FEAT_VIEWS views of make_train_step on that pool with a
     decoder to 512 channels, F1's and F2's counters set to 0 first: one
     launch of each a view;
  3. K1, then K2 on a seeded cotangent, against their plain PyTorch versions
     on a seeded synthetic scene at 1920x1080 (K1 rows 0-5 bit-identical to
     the plain version; K1 writing its block-start state: output
     bit-identical to K1 without it, state bit-identical to the plain
     forward's; K1's per-warp pair cull: the share of (pair, warp) the
     plain test ``pair_warp_reach`` skips in the composited blocks, none
     with a non-zero alpha, and the kernel's own count beside it; K2, given
     K1's state: within BWD_TOL, exact zeros outside the composited blocks,
     finite, a second call bit-identical);
  4. the same on ``bench_assets/trained_ckpt.npz`` at 1920x1080 from the
     bench pose (camera at center + (0, -0.6R, -4.4R));
  5. serving: restore_pool -> make_render_fn -> render_trajectory over the
     bench pose plus an 8-frame orbit at orbit_scale 4.4, with the kernel's
     launch count read around the run (and the binning kernels', which
     must launch once a binned frame), and the served bench-pose frame held
     against the image assembled from the plain compositor's output; the
     memory model's estimate (utils.memory) beside the run's own peak
     (the peak less what earlier phases held), within MEMORY_TOL;
  6. timing of K1 alone (CUDA events), without and with state writing,
     beside its plain version, its bound (the (pair, pixel) its cull
     reaches and the cull's own operations, against the bytes) and the
     TPU kernel's work (every (pair, pixel) of a composited block), and the
     device time of each stage of one frame;
  7. fwd+bwd at 1080p at the bench pose (render_from_params, loss
     mean(im) + mean(im^2), .backward()): one K1 and one K2 launch per call,
     finite gradients, dead slots' gradients 0, ms per call, and the device
     time of the backward's parts (K2, the reduction to per-gaussian
     gradients, autograd through projection, SH and covariance);
  8. training: init_train_state -> make_train_step -> 6 steps of batch 4 at
     960x540 on the checkpoint with f_dc and opacity perturbed, ground truth
     rendered from the unperturbed checkpoint: the loss falls, no step is
     skipped, dead slots do not move, K1 and K2 launch views x steps times,
     the binning kernels once a binned view, no pair overflow; step ms, per-view ms, peak device memory and the
     memory model's estimate within MEMORY_TOL of the step's own peak;
     then the comm model (python -m gsplat_tpu_torch.comm_model) fed this
     step's ms per view;
 8b. fit(): four runs of 12 iterations on the batch of phase 8, each
     resumed from the perturbed checkpoint that the port's save_checkpoint
     wrote: (a) reference ADC at the JAX defaults, (b) as (a) with
     max_grad 1e-9, which must grow the pool past 131,072 slots (and
     max_pairs where a logged pair demand exceeds it), (c) paper ADC, (d)
     as (a) from max_pairs 2**20, which must grow max_pairs. Each:
     finite losses, no skipped step, K1 and K2 launched views x iterations
     times; (a), (c) the final loss below the first logged after the last
     densification. Then (a)'s iteration-6 checkpoint reloaded bit for bit,
     direct adc_step_paper and adc_step calls on (a)'s state, the latter at
     (b)'s max_grad, each of which must spawn (alive count; counts, reset
     mask and every child row as the rule gives them; moments zeroed on
     the reset slots and unchanged elsewhere, rows outside them
     unchanged), and (c)'s uv_grad_sum through K2 within
     BWD_TOL of the plain backward compositor. ADC counts, capacities,
     max_pairs, step ms, ADC ms and peak memory per run, beside the
     memory model's estimate (within MEMORY_TOL for (a));
  9. timing of K2 alone (CUDA events) at the bench pose, on the inputs the
     fwd+bwd of phase 7 gave it, with its registers, CTAs launched and
     active and the state's bytes, beside its plain version and its bound;
 10. the compositor-ablation profiler (K3): pg-roll's and pg-log's
     registers, static shared bytes, CTAs per SM (occupancy API) and
     spills (phase 2 fails on any); K1 and the eight K3 kernels
     (raster_ablate.cu: cumprod, pg-roll, pg-log, no-transc, no-mxu,
     no-compute, no-input, empty) against their plain versions on the
     profiler's 1080p workload (K1 rows 0-5 bit for bit, and its cull as in
     phase 3; the others rows 0-4 within TOL, row 5 exact, rows 6-7 zero),
     and cumprod and pg-* also against K1's plain version (they compute
     K1's function); the bodies that cull (no-transc with its own
     threshold, no-mxu, cumprod) report the (pair, warp) they skipped,
     equal to the plain test's count; the plain versions' times, then
     ``profile_kernel.main(["--iters", "20"])`` with the launch counts set to
     0 just before it: ms, ns/block and share of bound of each variant, each
     launch count, the tile-0 digests against the plain versions', the
     attribution table (K1's time minus each variant's and the class the
     difference isolates), pg-roll's and pg-log's ps per (pair, pixel)
     computed beside K1's per (pair, pixel) its cull reaches, and the gate
     empty <= no-compute <= full within ABLATION_ORDER_SLACK;
 11. the serving levers on the checkpoint at 1920x1080: the SASS
     instructions of expf and log1pf (probe kernels, cuobjdump), which the
     log kernels' bounds count;
     (a) transmittance_math="log" at the bench pose: K1-log against its
         plain version (rows 0-5 and state bit for bit, its cull's count
         beside the plain test's), K2-log given K1-log's state (BWD_TOL,
         zeros off the composited blocks, two launches bit-identical), the
         log image against the cumprod one; the bench pose and the orbit
         served and one fwd+bwd, with both log counts set to 0 before;
         times, plain times and bounds of both;
     (b) truncation at the bench pose (tile_rank_cap 1024, cull_chunks 64,
         trunc_pairs sized from pair_demand as --auto_pairs does): the
         demand with and without the occlusion cull, K1 on the truncated
         list bit for bit with its plain version and K2 on it as in phase
         4, the cull on against off bit-identical with equal kept pairs,
         the image against the exact one, frame times with and without
         the lever (capacities sized over the trajectory) and the lever's
         stage times, one fwd+bwd;
     (c) overflow (trunc_pairs at half the demand): reported, finite, the
         image equal to the plain compositor's on the same list, no block
         read past the list's end;
     (d) render_trained --orbit_scale 1.0 --num_frames 8 --tile_rank_cap
         1024 --bucket_pairs 4 --max_pairs 2**24: each pose's demand and
         rung, overflow frames, and at every pose (the one of highest
         demand first) the PSNR of the served truncated frame against an
         exact render sized to its demand;
 12. the training levers on the checkpoint:
     (a) the batch of phase 8 (4 views at 960x540) stacked into one list
         (view_tile_rows = the view's tile rows): K1 with rows_mod bit for
         bit with its plain version and its cull's count beside the plain
         test's; the batch image bit for bit against the 4 per-view K1
         images fed the same projections; render_batch_from_params within
         1e-5 of the per-view renders; K1's time over the batch and over
         the 4 views;
     (b) K2 with rows_mod on that list, as in phase 4;
     (c) K2 in compact mode at the 1080p bench pose on phase 7's inputs,
         bwd_pairs grown from the demand as fit() grows it (1.25 x,
         rounded to 1,024): against its plain version (BWD_TOL, zeros past
         the kept blocks, two launches bit-identical, the kept columns
         equal to K2's), its time beside K2's and its bound, the
         reduction's time at both sizes; the gradients with bwd_pairs
         against bwd_pairs = 0 bit for bit (the bench pose, and the batch
         batched), and at half the demand the overflow reported and the
         gradients finite;
     (d) 6 batched train steps (batched_render), without and with the
         compacted backward, each with the counts set to 0 before: the loss
         falls, no step skipped, one K1 and one K2 launch per step; step
         ms beside phase 8's, peak memory and the memory model's estimate
     within MEMORY_TOL of each run's own peak, the batched step's parts;
     (e) one fit() of 12 iterations, batched, from bwd_pairs 1,024, which
         must grow;
     (f) batched serving at 1080p, 4 poses a launch: phase 5's poses
         through make_batch_render_fn (the bench-pose frame within 1e-5 of
         phase 5's) and render_trained --render_batch 4 over the orbit;
         frame ms beside phase 5's;
 13. the XLA compositor, evaluation and the measuring tools, at full
     width on the checkpoint:
     (a) backend="xla" (plain PyTorch on the card) at the 1080p bench pose
         with max_per_tile at its largest tile: image within 2e-5 of K1's
         frame (itself equal to phase 5's), depth within 2e-5 of its
         largest value, alpha within 2e-5 where K1's final T stays above
         transmittance_min (K1 stops a saturated tile early; the xla
         compositor does not, so there its alpha only has to be
         saturated); K1 with tile_rank_cap 1024 against "xla"
         with max_per_tile 1024 (within 2e-5) at the bench pose and at
         phase 11d's close-in pose of highest demand; a fwd+bwd through
         "xla" against one through K1/K2 at 960x540 (each gradient leaf
         within 5e-4 of its max); frame ms and peak memory of both;
     (b) evaluate_views on phase 8's views: the perturbed pool before and
         after the 6 steps (PSNR must rise), the checkpoint against its
         own renders (above 100 dB), render_batch=4 against per view (1e-3
         dB, L1 1e-6), auto_size from max_pairs 2**18;
     (c) one served frame and one fwd+bwd at 1080p, each traced
         (utils.profiling.trace) and read back: device-busy share, kernel
         launches, the ten kernels with the most time, the longest idle
         gaps; K1 and K2 events as many as their counts; then one frame
         traced stage by stage: host ms, launches and device-busy ms of
         each stage;
     (d) profile_stages exact and with the lever (tile_rank_cap 1024,
         --auto_pairs), and profile_binning, at the bench pose;
     (e) cull_sweep at 16-256 chunks: at 64, the bench pose's demand and
         kept pairs equal to phase 11b's;
     (f) the truncation ladder at 4 close-in poses, K in {1024, 4096}, its
         banded exact reference against a full-frame exact render (max
         abs, PSNR);
 14. the dataset flow through the entry points a user runs, at 960x540
     and batch 4 (the training configuration's full width), each run with
     the launch counts set to 0 just before it:
     (a) a Mip-NeRF-360-layout raw scene in chip_data/ (git-ignored,
         cleared first): 24 views of the checkpoint at 1920x1080 around the
         bench orbit as PNG, poses_bounds.npy, sparse/0/points3D.bin with
         the alive means and DC colours; prepare_dataset mipnerf on it;
     (b) train (its main) from the prepared point cloud with the device
         image cache (21 views after holdout 8), capacity 131,072,
         max_pairs 2**21, 60 iterations, the paper's density control every
         20 (at the JAX defaults the reference rule's max_grad never fires
         on this start): finite
         losses, the last logged below the first logged after the last
         densification, no skipped step, K1 and K2 launched views x
         iterations times, the final checkpoint read by restore_pool equal
         to the pool; step ms and peak memory;
     (c) the same through fit() on the same GaussianDataset at tile 32
         and pair_block 512;
     (d) evaluate and eval_checkpoint on (b)'s checkpoint over the 3
         held-out views, inference --trajectory, render_trained
         --render_training_views --export_ply --export_splat (the PLY read
         back with import_gaussians_ply equals the pool);
     (e) fit() runs of 4 iterations at (16, 512), (32, 128), (32, 256),
         and at (32, 256) in the log form and with the compacted backward;
     (f) K1 and K2 at (16, 256) and at each (tile, pair_block) of (e) and
         (c) on phase 3's synthetic scene and phase 4's bench pose as
         phases 3-4 hold them (K1 rows 0-5 and state bit for bit, its
         cull's count; K2 within BWD_TOL, zeros off the composited blocks,
         two launches equal), at (32, 256) also the log form and K2's
         compact mode; at the bench pose each timed (CUDA events) beside
         its plain version and bound;
 15. the ellipse cull and the (data, tile) process grid, both on K1 and K2:
     (a) cull_mode="ellipse" on the checkpoint at 1920x1080: the bench
         pose's pair demand against rect's and its rows against
         row_capacity; K1 on the ellipse list bit for bit with its plain
         version and K2 given its state within BWD_TOL, K1's time on both
         lists; the image within 2e-6 and depth within 2e-5 of rect's,
         alpha within 2e-6 where rect's final T is above
         transmittance_min (elsewhere K1 stops the tile at a block
         boundary, which the shorter list moves: there the ellipse's
         alpha must be saturated); frame and
         bin_gaussians times both ways (host clock; CUDA events); a fwd+bwd
         each way, every leaf's gradient within 5e-5 of its max of rect's
         and K2 against its plain version on the inputs autograd gave it;
         a 12-iteration fit() at 960x540, batch 4, from max_rows 4,096,
         which must grow max_rows once; render_trained --cull_mode ellipse
         with --auto_pairs and with --bucket_pairs 4 over the 8-frame
         orbit;
     (b) one spawn of 4 gloo ranks on the card, data 2 x tile 2: the band
         render at the bench pose (rect and ellipse) and the batch render
         of 4 poses at 1080p bit for bit against one process rendering
         the same bands, and against the full-frame single-rank renders
         within the crossings a band's shifted principal point causes
         (GRID_FLIP_SHARE, the edge alpha; JAX's 1e-6 holds at its 64x64
         test, where tests/test_torch_sharding.py holds the port to it);
         the train step at 960x540, batch 4 (scan and batched, reference
         and paper ADC): its gradients within 1e-5 of each leaf's max of
         one process's gradients of the same banded loss, uv_grad_sum
         within 1e-6 + 1e-4 x max and visible and max_radius equal to
         that process's; against the full-frame single-rank step, the
         loss within 1e-5 and Adam's first update as the CPU tests
         compare it; every rank's parameters and Adam moments
         bit-identical; a
         12-iteration fit(mesh=) with the paper ADC; evaluate_views(mesh=)
         against single-rank PSNR and SSIM within 1e-4 relative; each
         rank's K1 and K2 launches summed into the kernels line; the
         grid's step time beside the single-rank step's (not a speed
         figure: the ranks share one card, and gloo moves collectives
         through host memory); then python -m gsplat_tpu_torch.train
         --mesh_data 2 --mesh_tile 2 --dist_backend gloo for 20 iterations
         on phase 14's prepared dataset;
 16. the gaussian-sharded (ZeRO-style) step, one spawn of 4 gloo ranks on
     the card: (a) data 2 x tile 2 from phase 8's perturbed checkpoint at
     960x540, batch 4, in four forms (scan and batched, reference and
     paper ADC): every rank holds 65,536 rows of every capacity leaf; the
     gathered images bit for bit and the gradients within 1e-5 of each
     leaf's max of one process computing the same banded render
     (full-frame projection, band_localize per band, each band's binning
     and K1); against the full-frame single-rank step the loss within
     1e-5 and Adam's first update as the CPU tests compare it; the two
     data replicas' shards bit-identical; the paper statistics against
     the banded process; K1 and K2 against their plain versions on the
     band inputs autograd gave K2; each rank's step ms and peak memory
     beside phase 15b's replicated step on the grid; (b) data 1 x tile 4 of
     the same processes: the ring with ring_capacity 1.25 x the largest
     band's gaussian demand against the all-gather step (images bit for
     bit, gradients within 1e-5 of each leaf's max, Adam's first update as
     the CPU tests compare it, overflow 0), and a starved ring_capacity of
     1,024 reporting its overflow; (c) fit(mesh=, gauss_sharded=True) and
     "ring", 12 iterations with the reference ADC from the perturbed
     checkpoint, alive count and losses within 1 % of the single-rank
     fit(); its state saved with save_checkpoint_dcp by the grid and
     loaded in this process bit for bit; (d) python -m
     gsplat_tpu_torch.train --mesh_data 2 --mesh_tile 2 --gauss_sharded
     [--ring] --dist_backend gloo, 20 iterations each, on phase 14's
     dataset;
 17. the bench asset's recipe in full: python -m
     gsplat_tpu_torch.make_bench_asset (scripts/make_bench_asset.sh's
     train_synthetic flags: 800 iterations, capacity 131,072, 120,000 GT
     gaussians in 400 clusters, 960x540, 16 views, max_pairs 2**21) into a
     temporary directory: the asset's keys, shapes and dtypes those of
     bench_assets/trained_ckpt.npz, __step__ 800, no optimizer leaves,
     restore_pool on the card equal to fit()'s final pool; a finite final
     loss; K1 and K2 launched once a step (K1 also for the 16 GT renders
     and the 16 evaluated views); on the 16 GT views the port's asset's
     PSNR at least the JAX asset's minus ASSET_PSNR_SLACK; the memory
     model within MEMORY_TOL of the run's own peak. Printed: growth and
     overflow events, ADC ms per call, wall time and steps/s, the GT
     views' demand, and for both assets at their own 1080p bench poses
     the pair demand (the JAX asset's equal to phase 4's), K1's blocks
     and ms, and the served frames' median;
 18. the bench: bench.main(["--ellipse-ab"]) in process (python -m
     gsplat_tpu_torch.bench at full width: 1080p, 2**17 synthetic
     gaussians, 20 iterations, the checkpoint's 131,072 slots), with the
     launch counts set to 0 just before it: its last line one JSON object
     with bench.py's metric and keys (BENCH_r05.json's less pixel_grad_*,
     plus the ellipse A/B's), no *_error key, no NaN; the checkpoint's pair
     demand equal to phase 4's, its culled demand and kept pairs to phase
     11b's, its ellipse demand to phase 15a's with image error 0, the
     truncated image within 2e-5 of the exact one; K1, K2 and K2 in
     compact mode launched (its isolated child's launches are not
     counted). Printed: the line, each integer key beside the TPU v5e's
     (BENCH_r05.json), the in-bench and isolated fwd+bwd's agreement and
     the phase's seconds;
 19. one JSON line {"kernels": [...]} (twenty-nine kernels: phase 14's
     ranges as their own entries; binning_emit, binning_sort and
     binning_align with their launches in phases 5 and 8, counted from 0
     there, and phase 2b's error and times; feat_fwd and feat_bwd with
     their launches in phase 2c's training steps, counted from 0 there,
     and that phase's errors and times), the card line, and the final line {"ok": true, "device":
     {...}}.

Imports nothing of JAX or of the JAX package.
"""

import dataclasses
import functools
import json
import os
import re
import shutil
import sys
import time

import numpy as np
import torch

# One definition of the card's peak rates, K1's bound and the device timer
# (CUDA events behind a busy stream), shared with the profiler.
from gsplat_tpu_torch.profile_kernel import (PEAK_BYTES, PEAK_F32_FLOPS,
                                             bound_ms, device_ms,
                                             transcendental_instructions)
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
# The card's name and power limit, as nvidia-smi prints them (the bench's
# "device").
from gsplat_tpu_torch.bench import device_label
# One definition of the stage and backward-part timers, shared with the
# stage profiler.
from gsplat_tpu_torch.profile_stages import (bench_pose, bwd_parts_ms,
                                             record_backward, serving_path,
                                             stage_ms)

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "bench_assets", "trained_ckpt.npz")
H, W = 1080, 1920
MAX_PAIRS = 2**22
# K3 kernels vs plain, rows 0-4 abs (both round alike: -fmad=false); K1
# must equal its plain version bit for bit.
TOL = 2e-5
# K2 vs plain, rows 0-9, relative to each row's max abs: alpha, T and w
# round alike; the pixel sums' order, fused multiply-adds in the ten
# partials and the division's fast path (raster_bwd.cu) differ.
BWD_TOL = 1e-5
# Arithmetic operations per active (pair, pixel) in K2 (raster_bwd.cu),
# counted as K1's are in profile_kernel.OPS_PER_PAIR_PIXEL: du, dv (2),
# q (9), -q/2 (1), exp (1), op*g (1), min (1), w = alpha*T (1), gdotc (7),
# gP += gdotc*w (2), gS (1), 1-alpha and its floor (2), dalpha (4:
# gdotc*T, gS+gTT, divide, subtract), dq (3), the u and v partials (6
# each), the three conic partials (2, 3, 2), the opacity partial (1), the
# four colour partials (4), the four prefix sums (8), T*(1-alpha) (2), and
# one add per partial for the pixel sum (10).
OPS_BWD_PER_PAIR_PIXEL = 79
# The TPU body each ablation kernel replaces (scripts/profile_kernel.py).
ABLATION_REPLACES = {
    "empty": "scripts/profile_kernel.py:222",
    "no-compute": "scripts/profile_kernel.py:173",
    "no-transc": "scripts/profile_kernel.py:50",
    "no-mxu": "scripts/profile_kernel.py:145",
    "no-input": "scripts/profile_kernel.py:184",
    "cumprod": "scripts/profile_kernel.py:90",
    "pg-roll": "scripts/profile_kernel.py:231 (roll)",
    "pg-log": "scripts/profile_kernel.py:231 (log)",
}
# Phase 10's gate on the ablations' times: empty <= no-compute <= full,
# each within 5 % (the times of one call; a body that does a subset of
# another's work should not take longer).
ABLATION_ORDER_SLACK = 1.05
# K1's resources since its redesign (registers, static shared bytes, CTAs
# per SM at tile 16, G <= 256, "cumprod"): the ablations share its source,
# which must leave K1 as it was.
K1_RESOURCES = (40, 12288, 6)
# The memory model (gsplat_tpu_torch/utils/memory.py) against a run's own
# peak: within 25 % for serving, the per-view step, the batched step
# without and with bwd_pairs, and fit() (a); elsewhere printed.
MEMORY_TOL = 0.25
FEAT_ROWS = 10
TRAIN_H, TRAIN_W = 540, 960  # the reference's training resolution
TRAIN_PAIRS = 2**21
TRAIN_BATCH = 4
TRAIN_STEPS = 6
FIT_ITERS = 12  # iterations of each fit() run of phase 8b
LEVER_CAP = 1024  # tile_rank_cap of phase 11 (the README's K)
LEVER_CHUNKS = 64  # cull_chunks of phase 11 (the JAX default)
CLOSE_PAIRS = 2**24  # --max_pairs of phase 11d's bucketed close-in orbit
# The (tile, pair_block) the kernels take beyond tile 16 with G <= 256
# (phase 14).
RANGES = ((16, 512), (32, 128), (32, 256), (32, 512))
# Phase 14's dataset: a git-ignored directory the script clears first, the
# views of its raw scene, and the training run's iterations and
# densification interval; the other ranges' fit() runs take RANGE_ITERS.
DATA_DIR = os.path.join(ROOT, "chip_data")
SCENE_VIEWS = 24
SCENE_PAIRS = 2**21  # the training run's max_pairs (the train CLI's)
SCENE_ITERS = 60
SCENE_INTERVAL = 20
RANGE_ITERS = 4
# Phase 2c: Feature 3DGS's compositors (F1, F2) on the 3 M garden scene
# with C = 128 feature floats a gaussian (the paper's speed-up setting) at
# the benchmark's training view, 1297x840, and the teacher map at half
# that on each side with LSeg's 512 channels; FEAT_VIEWS views a step,
# one at a time, for FEAT_STEPS steps.
FEAT_C, FEAT_D = 128, 512
FEAT_H, FEAT_W = 840, 1297
FEAT_VIEWS, FEAT_STEPS = 2, 2
FEAT_SEED = 24
# F2 vs plain, d f_sem and the six geometry rows it adds, relative to each
# output's largest value: F2 sums with float atomics in no fixed order (d f
# over a gaussian's pairs and the warps of its tiles, the geometry partials
# over the four channel groups and the warps), the plain version in
# sequential and einsum order; each output sums up to a few hundred terms
# of one sign or both, a few hundred float32 roundings of 6e-8 at most.
FEAT_BWD_TOL = 1e-5


def kernel_resources(ptxas: str, kernel: str, log: bool = False,
                     tile: int = 16, max_g: int = 256):
    """(registers, static shared bytes) of one instantiation of a
    compositor (``raster_fwd_kernel<tile, max_g, log>`` or
    ``raster_bwd_kernel<tile, log>``, the "cumprod" form or, with ``log``,
    the "log" one) from its library's ptxas report."""
    args = f"Li{tile}E" + (f"Li{max_g}E" if kernel == "raster_fwd_kernel"
                           else "")
    part = ptxas.split(f"{kernel}I{args}Lb{int(log)}E", 1)[1]
    m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?",
                  part.split("Compiling entry", 1)[0])
    return int(m.group(1)), int(m.group(2) or 0)


def tensor_bytes(*ts) -> int:
    """Bytes of the tensors (dicts and lists of them too)."""
    n = 0
    for t in ts:
        if isinstance(t, dict):
            n += tensor_bytes(*t.values())
        elif isinstance(t, (list, tuple)):
            n += tensor_bytes(*t)
        elif torch.is_tensor(t):
            n += t.numel() * t.element_size()
    return n


def memory_line(card, label, other, est, gate=False, dev=None):
    """Print a run's peak (``torch.cuda.max_memory_allocated`` since the
    last reset) beside the memory model's estimate ``est`` (a dict of
    ``utils.memory``): ``other`` is what the device held before the run
    that the run does not own (earlier phases' tensors; the run's own
    inputs, such as its batch, are not in it), so the run's own peak is
    the peak less ``other``. With ``gate`` the estimate must lie within
    MEMORY_TOL of it. Returns (own peak GiB, estimate / own)."""
    peak = torch.cuda.max_memory_allocated(dev)
    own = peak - other
    e = est["total_mb"] * 1e6
    ratio = e / own
    ok = abs(ratio - 1.0) <= MEMORY_TOL
    print(f"[{card}] memory, {label}: peak {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated), {other / 2**30:.3f} GiB of it "
          f"held before the run by others, the run's own {own / 2**30:.3f} "
          f"GiB; estimate (utils.memory) {e / 2**30:.3f} GiB"
          + (f" at its {est['peak_phase']} phase" if "peak_phase" in est
             else "") + f"; estimate / own {ratio:.3f}, estimate / peak "
          f"{e / peak:.3f}" + (f"; gate +-{MEMORY_TOL:.0%}: {ok}" if gate
                               else ""), flush=True)
    if gate and not ok:
        raise SystemExit(f"FAIL: the memory model misses {label}'s peak: "
                         f"estimate / own {ratio:.3f}")
    return own / 2**30, ratio


def make_scene(n, seed):
    """Random gaussians in front of a camera at the origin looking down +z
    (the recipe of the test suite's make_scene)."""
    r = np.random.default_rng(1234 + seed)
    params = {"pos": np.stack(
        [r.uniform(-2.0, 2.0, n), r.uniform(-2.0, 2.0, n),
         r.uniform(3.0, 8.0, n)], axis=-1).astype(np.float32)}
    params["scale_raw"] = (r.normal(0, 0.3, (n, 3)) - 2.0).astype(np.float32)
    params["q_raw"] = r.normal(0, 1.0, (n, 4)).astype(np.float32)
    params["q_raw"][:, 3] += 2.0
    params["opacity_raw"] = r.normal(0.5, 1.0, n).astype(np.float32)
    params["f_dc"] = r.normal(0, 0.8, (n, 3)).astype(np.float32)
    params["f_rest"] = r.normal(0, 0.05, (n, 45)).astype(np.float32)
    th = 0.08
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]], np.float32)
    c2w[:3, 3] = [0.1, -0.05, 0.2]
    return params, c2w


def compare(name, out_k, out_p, tile_count):
    """K1 vs plain on every tile: rows 0-5 bit for bit."""
    occ = tile_count > 0
    err = float((out_k[:, 0:5] - out_p[:, 0:5]).abs().max())
    same = bool(torch.equal(out_k[:, 0:6], out_p[:, 0:6]))
    finite = bool(torch.isfinite(out_k).all())
    print(f"[{name}] K1 vs plain: rows 0-5 bit-identical: {same} (max abs "
          f"err rows 0-4 {err:.3e}), finite: {finite}, occupied tiles "
          f"{int(occ.sum())}", flush=True)
    if not (same and finite):
        raise SystemExit(f"FAIL: {name}: K1 disagrees with its plain version")
    return err


def check_cull(name, pf, ts, tc, out_p, cfg):
    """K1's per-warp pair cull on the blocks the plain forward composited:
    the share of (pair, warp) the plain test ``pair_warp_reach`` skips,
    none of them with a non-zero alpha at any of the warp's 32 pixels, and
    the count K1 reports for the same inputs (printed beside it; they
    should be equal). Returns ``raster_cuda.cull_audit``'s counts."""
    from gsplat_tpu_torch.ops.raster_cuda import (_launch_fwd, active_blocks,
                                                  cull_audit,
                                                  tile_block_offsets)

    blk, tile, _ = active_blocks(ts, tile_block_offsets(out_p), cfg)
    n = cull_audit(pf, blk, tile, cfg)
    counter = torch.zeros(1, dtype=torch.int64, device=pf.device)
    _launch_fwd(pf, ts, tc, cfg, skipped=counter)
    kernel = int(counter.item())
    total = max(n["total"], 1)
    print(f"[{name}] K1 cull: plain test skips {n['skipped']} of "
          f"{n['total']} (pair, warp) = {n['skipped'] / total:.4f} in "
          f"{blk.shape[0]} composited blocks ({n['zero'] / total:.4f} have "
          f"alpha == 0 at all 32 pixels), {n['unsafe']} with a non-zero "
          f"alpha; the kernel reports {kernel} skipped (difference "
          f"{kernel - n['skipped']})", flush=True)
    if n["unsafe"]:
        raise SystemExit(f"FAIL: {name}: the cull skips a pair with a "
                         f"non-zero alpha")
    return n


def active_slots(binning, out, cfg):
    """[padded_pairs] bool: slots of the blocks the forward composited (each
    tile's first out[:, 5] blocks; dead blocks never)."""
    G = cfg.pair_block
    meta = binning.block_meta.long()
    tile = meta >> 2
    rank = torch.arange(meta.shape[0], device=meta.device) \
        - binning.tile_start.long()[tile] // G
    active = ((meta & 2) == 0) & (rank >= 0) & (rank < out[tile, 5, 0].long())
    return active.repeat_interleave(G)


def rel_err(d_k, d_p):
    """Max over rows 0-9 of |kernel - plain| / the row's max |plain|."""
    rel = []
    for r in range(FEAT_ROWS):
        scale = float(d_p[r].abs().max())
        err = float((d_k[r] - d_p[r]).abs().max())
        rel.append(err / scale if scale > 0 else (0.0 if err == 0 else 1.0))
    return max(rel)


def check_bwd(name, pf, binning, out, state_p, cfg, seed, block_chunk=256,
              keep=None):
    """K1 writing its block-start state: output bit-identical to `out` (K1
    without state), state bit-identical to the plain forward's `state_p`
    at the composited blocks. Then K2, given K1's state, vs its plain
    version on a seeded cotangent: rows 0-9 within BWD_TOL of each row's
    max abs, exact zeros outside the composited blocks, finite, and a
    second launch bit-identical. Returns the max abs error; with a dict
    ``keep``, also puts K2's inputs (``bargs``) and gradient (``d_k``)
    there."""
    from gsplat_tpu_torch.ops.raster_cuda import (_composite_fwd,
                                                  composite_pairs_bwd,
                                                  composite_pairs_bwd_plain)

    ts, tc = binning.tile_start, binning.tile_count
    out_s, state = _composite_fwd(pf, ts, tc, cfg, with_state=True)
    torch.cuda.synchronize()
    act = active_slots(binning, out, cfg)[::cfg.pair_block]
    same_out = bool(torch.equal(out_s, out))
    same_state = bool(torch.equal(state[act], state_p[act]))
    print(f"[{name}] K1 with state writing: output bit-identical to K1 "
          f"without: {same_out}; state of the {int(act.sum())} composited "
          f"blocks bit-identical to the plain forward's: {same_state}",
          flush=True)
    if not (same_out and same_state):
        raise SystemExit(f"FAIL: {name}: K1's state disagrees")
    gen = torch.Generator(device=pf.device).manual_seed(seed)
    gout = torch.randn(cfg.num_tiles, 8, cfg.tile**2, generator=gen,
                       device=pf.device)
    args = (pf, ts, tc, out, state, gout, cfg)
    d_p = composite_pairs_bwd_plain(*args, block_chunk=block_chunk)
    off = ~active_slots(binning, out, cfg)
    d_k = composite_pairs_bwd(*args)
    d_k2 = composite_pairs_bwd(*args)
    torch.cuda.synchronize()
    rel = rel_err(d_k, d_p)
    zeros = bool((d_k[:, off] == 0).all())
    finite = bool(torch.isfinite(d_k).all())
    same = bool(torch.equal(d_k, d_k2))
    err = float((d_k - d_p).abs().max())
    print(f"[{name}] K2 vs plain: max abs err {err:.3e}, max per-row "
          f"relative {rel:.3e} (tol {BWD_TOL}), zeros outside the "
          f"{int((~off).sum()) // cfg.pair_block} composited blocks: "
          f"{zeros}, finite: {finite}, two launches bit-identical: {same}",
          flush=True)
    if not (rel <= BWD_TOL and zeros and finite and same):
        raise SystemExit(f"FAIL: {name}: K2 disagrees with its plain version")
    if keep is not None:
        keep.update(bargs=args, d_k=d_k)
    return err


def detached(args):
    """The arguments autograd hands K2, tensors detached (its saved forward
    output is the graph's), so the checks that reuse them record nothing."""
    return tuple(a.detach() if isinstance(a, torch.Tensor) else a
                 for a in args)


def fwd_bwd_phase(pool, c2w, fx, fy, cx, cy, cfg, card, reps=5):
    """fwd+bwd of render_from_params at the bench pose (the port's
    counterpart of bench.py:202-222). Returns the inputs K2 was given on
    the last call (for its timing) and the gradient it returned."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops import raster_cuda

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in pool.params.items()}
    seen = {}
    plain_bwd = raster_cuda.composite_pairs_bwd

    def seen_bwd(*args, **kw):  # records what autograd hands K2
        seen["args"] = detached(args)
        seen["d"] = plain_bwd(*args, **kw)
        return seen["d"]

    def call():
        for p in params.values():
            p.grad = None
        img, _ = gt.render_from_params(params, c2w, fx, fy, cx, cy, cfg,
                                       alive=pool.alive)
        (torch.mean(img) + torch.mean(img * img)).backward()

    raster_cuda.composite_pairs_bwd = seen_bwd
    try:
        call()  # warm-up
        torch.cuda.synchronize()
        k1, k2 = (raster_cuda.composite_pairs.launches,
                  raster_cuda.composite_pairs.bwd_launches)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        raster_cuda.composite_pairs_bwd = plain_bwd
    n1 = raster_cuda.composite_pairs.launches - k1
    n2 = raster_cuda.composite_pairs.bwd_launches - k2
    dead = ~pool.alive
    finite = all(bool(torch.isfinite(p.grad).all()) for p in params.values())
    dead_zero = all(bool((p.grad[dead] == 0).all()) for p in params.values())
    print(f"[{card}] fwd+bwd 1080p bench pose: {float(np.median(times)):.3f} "
          f"ms median of {reps} (host clock to synchronize; "
          + ", ".join(f"{t:.3f}" for t in times) + f"), K1 launches {n1}, "
          f"K2 launches {n2} for {reps} calls; grads finite {finite}, dead "
          f"slots' grads 0: {dead_zero}", flush=True)
    if not (n1 == n2 == reps and finite and dead_zero):
        raise SystemExit("FAIL: fwd+bwd at 1080p")
    return params, seen


def train_views(pool, bench_c2w, center, radius):
    """The training workload at 960x540: (cfg, batch of the bench pose and
    3 orbit poses with ground truth rendered from the unperturbed
    checkpoint, the checkpoint's parameters as numpy with f_dc and
    opacity_raw + N(0, 0.1))."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.viewer import create_orbit_trajectory

    dev = pool.pos.device
    cfg = gt.RenderConfig(height=TRAIN_H, width=TRAIN_W,
                          max_pairs=TRAIN_PAIRS)
    f = 0.85 * TRAIN_W
    poses = np.concatenate([bench_c2w[None], create_orbit_trajectory(
        center, 4.4 * radius, num_frames=TRAIN_BATCH - 1,
        elevation_deg=15.0)]).astype(np.float32)
    with torch.no_grad():  # ground truth: the unperturbed checkpoint
        images = torch.stack([gt.render_from_params(
            pool.params, p, f, f, TRAIN_W / 2.0, TRAIN_H / 2.0, cfg,
            alive=pool.alive)[0] for p in poses])
    batch = {"image": images, "c2w": torch.from_numpy(poses).to(dev)}
    for k, v in (("fx", f), ("fy", f), ("cx", TRAIN_W / 2.0),
                 ("cy", TRAIN_H / 2.0)):
        batch[k] = torch.full((TRAIN_BATCH,), v, device=dev)
    rng = np.random.default_rng(0)
    start = {k: v.detach().cpu().numpy() for k, v in pool.params.items()}
    for k in ("f_dc", "opacity_raw"):
        start[k] = start[k] + rng.normal(0, 0.1, start[k].shape).astype(
            np.float32)
    return cfg, batch, start


def train_phase(pool, bench_c2w, center, radius, card):
    """TRAIN_STEPS steps of the port's train step at 960x540, batch 4.
    Returns (K1 launches, K2 launches, step ms, the parameters after the
    steps, the binning kernels' launches in the steps)."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs

    from gsplat_tpu_torch.utils.memory import estimate_train_memory

    dev = pool.pos.device
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated()  # before the batch and the state
    cfg, batch, start = train_views(pool, bench_c2w, center, radius)
    tpool = gt.pool_from_numpy(start, pool.alive.cpu().numpy(), device=dev)
    tcfg = gt.TrainConfig(capacity=tpool.capacity, batch_size=TRAIN_BATCH,
                          densification_interval=10**9,
                          opacity_reset_interval=10**9)
    state = gt.init_train_state(tpool, tcfg)
    step = gt.make_train_step(cfg, tcfg)
    dead = ~tpool.alive
    dead_before = {k: v.detach()[dead].clone() for k, v in
                   tpool.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite_pairs.launches = 0
    composite_pairs.bwd_launches = 0
    ms, metrics = [], []
    with BinCalls() as bins:
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append(m)
    k1, k2 = composite_pairs.launches, composite_pairs.bwd_launches
    bin_n = bins.check(card, f"train {TRAIN_STEPS} steps")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["total"]) for m in metrics]
    skipped = [int(m["nonfinite_skipped"]) for m in metrics]
    demand = [int(m["pair_demand"]) for m in metrics]
    dead_same = all(torch.equal(v.detach()[dead], dead_before[k])
                    for k, v in tpool.params.items())
    step_ms = float(np.median(ms[1:]))
    print(f"[{card}] train {TRAIN_STEPS} steps, batch {TRAIN_BATCH} at "
          f"{TRAIN_W}x{TRAIN_H}, {int(tpool.num_alive())} alive of "
          f"{tpool.capacity}: losses " + ", ".join(f"{v:.6f}" for v in losses)
          + f"; skipped {skipped}; pair demand {demand} of {cfg.max_pairs}; "
          f"K1 launches {k1}, K2 launches {k2}; dead slots unchanged: "
          f"{dead_same}", flush=True)
    print(f"[{card}] train step ms (host clock to synchronize): "
          + ", ".join(f"{t:.3f}" for t in ms) + f"; median of steps 2-"
          f"{TRAIN_STEPS} {step_ms:.3f} ms, per view "
          f"{step_ms / TRAIN_BATCH:.3f} ms; peak device memory "
          f"{peak_gib:.2f} GiB", flush=True)
    views = TRAIN_BATCH * TRAIN_STEPS
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and skipped == [0] * TRAIN_STEPS and dead_same
            and k1 == k2 == views and max(demand) <= cfg.max_pairs
            and bins.calls >= views):
        raise SystemExit("FAIL: training phase")
    memory_line(card, f"the per-view step ({TRAIN_BATCH} views at "
                f"{TRAIN_W}x{TRAIN_H})", other,
                estimate_train_memory(cfg, tcfg), gate=True)
    trained = {k: v.detach().clone() for k, v in tpool.params.items()}
    parts = train_parts_ms(state, batch, cfg, tcfg)
    print(f"[{card}] train step parts (CUDA events, median of 3, after the "
          f"checked steps): " + ", ".join(f"{k} {v:.3f} ms"
                                         for k, v in parts.items()),
          flush=True)
    return k1, k2, step_ms, trained, bin_n


def train_parts_ms(state, batch, cfg, tcfg, reps=3):
    """Device time of a train step and of its parts: the forward of the
    batch (renders + losses), its backward, Adam's update alone, and what
    is left of the step (gradient clip and mask, the non-finite guard)."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.train.trainer import apply_sh_warmup, batch_loss_fn

    params, alive = state.pool.params, state.pool.alive
    step = gt.make_train_step(cfg, tcfg)
    holder = [state]

    def forward():
        return batch_loss_fn(apply_sh_warmup(params, holder[0].step, tcfg),
                             alive, batch, cfg, tcfg)[0]

    def forward_backward():
        for p in params.values():
            p.grad = None
        forward().backward()

    def full_step():
        holder[0] = step(holder[0], batch)[0]

    t = {}
    for name, fn in (("fwd", forward), ("fwd+bwd", forward_backward),
                     ("adam", state.opt_state.step), ("step", full_step)):
        fn()
        t[name] = float(np.median([device_ms(fn, 1) for _ in range(reps)]))
    return {"step": t["step"], "forward (4 views + loss)": t["fwd"],
            "backward": t["fwd+bwd"] - t["fwd"], "Adam": t["adam"],
            "clip + mask + guard": t["step"] - t["fwd+bwd"] - t["adam"]}


def _state_snapshot(state) -> dict:
    """Clones of everything a checkpoint holds: step, alive, the six
    parameters, and each leaf's Adam step count and moments."""
    snap = {"step": state.step.clone(), "alive": state.pool.alive.clone()}
    for k, p in state.pool.params.items():
        st = state.opt_state.state[p]
        snap[k] = p.detach().clone()
        for f in ("step", "exp_avg", "exp_avg_sq"):
            snap[f"{k}.{f}"] = st[f].clone()
    return snap


def _instrument_fit(fit_mod, rec):
    """Wrap the names fit() calls (make_train_step, adc_step,
    adc_step_paper) to record, per run: each step's host ms (to
    synchronize()) and pair demand, the max_pairs of each step it builds,
    the state after step ``rec["snapshot_at"]``, and each ADC call's
    result, capacity before it and CUDA events around it. Returns the
    originals, for :func:`_restore_fit`."""
    real = (fit_mod.make_train_step, fit_mod.adc_step, fit_mod.adc_step_paper)

    def make(render_cfg, train_cfg):
        rec["max_pairs"].append(render_cfg.max_pairs)
        step = real[0](render_cfg, train_cfg)

        def timed(state, batch):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["steps"] += 1
            rec["demand"].append((rec["steps"], int(m["pair_demand"]),
                                  int(m["pair_capacity"])))
            rec["last_metrics"] = m
            if rec["steps"] == rec["snapshot_at"]:
                rec["snapshot"] = _state_snapshot(state)
            return state, m
        return timed

    def adc(fn):
        def timed(state, *args, **kw):
            cap = state.pool.capacity
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, res = fn(state, *args, **kw)
            ev[1].record()
            rec["adc"].append((rec["steps"], cap, ev, res))
            return state, res
        return timed

    fit_mod.make_train_step = make
    fit_mod.adc_step = adc(real[1])
    fit_mod.adc_step_paper = adc(real[2])
    return real


def _restore_fit(fit_mod, real):
    fit_mod.make_train_step, fit_mod.adc_step, fit_mod.adc_step_paper = real


def expected_spawns(before, prune, split, clone, child, parent=None):
    """What an ADC call must write, from its masks and child rows as the
    rule defines them (not from models/adc.py): the r-th spawner in slot
    order takes the r-th slot that is free after pruning, spawners past
    the free slots are dropped. Returns (parents, children, overflowed,
    reset mask, {param: (slots, rows)}): each child slot holds its
    parent's child row; with ``parent`` (the paper split's child A), each
    fitting split's own slot holds that row."""
    alive = before["alive"] & ~prune
    spawners = torch.nonzero(split | clone)[:, 0]
    free = torch.nonzero(~alive)[:, 0]
    k = min(len(spawners), len(free))
    parents, children = spawners[:k], free[:k]
    reset = prune.clone()
    reset[children] = True
    rows = {key: (children, child[key][parents]) for key in child}
    if parent is not None:
        rep = parents[split[parents]]
        reset[rep] = True
        for key, v in parent.items():
            rows[key] = (torch.cat([children, rep]),
                         torch.cat([rows[key][1], v[rep]]))
    return parents, children, len(spawners) - k, reset, rows


def reference_spawns(before, grad, noise, tcfg):
    """The reference form's masks and child rows (reference
    train.py:89-195): prune below the opacity threshold; among the
    survivors with a gradient norm above max_grad, split the large (one
    child at pos + noise * scale * 0.1, scale_raw - 0.5) and clone the
    small (an exact copy)."""
    g = grad if grad.dim() == 1 else torch.sqrt(
        grad[:, 0] * grad[:, 0] + grad[:, 1] * grad[:, 1]
        + grad[:, 2] * grad[:, 2])
    prune = before["alive"] & (
        torch.sigmoid(before["opacity_raw"]) < tcfg.prune_opacity_threshold)
    alive = before["alive"] & ~prune
    scales = torch.exp(before["scale_raw"])
    big = torch.amax(scales, dim=-1) > tcfg.scale_threshold
    high = g > tcfg.max_grad
    split, clone = alive & big & high, alive & ~big & high
    child = {k: before[k] for k in PARAM_KEYS}
    child["pos"] = before["pos"] + torch.where(
        split[:, None], noise * scales * 0.1, 0.0)
    child["scale_raw"] = before["scale_raw"] - torch.where(
        split[:, None], 0.5, 0.0)
    return expected_spawns(before, prune, split, clone, child)


def paper_spawns(before, avg_uv, rad, noise, tcfg):
    """The paper form's masks and child rows (Kerbl et al. 2023, 5.2): a
    split writes pos + R (eps_b * scales) to a free slot and pos + R
    (eps_a * scales) over its parent, both with the scales / 1.6; a clone
    writes a copy."""
    from gsplat_tpu_torch.ops.gaussian import quat_to_rotmat

    scales = torch.exp(before["scale_raw"])
    max_scale = torch.amax(scales, dim=-1)
    alive0 = before["alive"]
    prune = alive0 & (torch.sigmoid(before["opacity_raw"]) < tcfg.min_opacity)
    if tcfg.max_screen_size > 0:
        prune |= alive0 & (rad > tcfg.max_screen_size)
        prune |= alive0 & (max_scale > 0.1 * tcfg.scene_extent)
    alive = alive0 & ~prune
    big = max_scale > tcfg.percent_dense * tcfg.scene_extent
    high = avg_uv >= tcfg.densify_grad_threshold
    split, clone = alive & big & high, alive & ~big & high
    q = before["q_raw"]
    R = quat_to_rotmat(q / (torch.linalg.vector_norm(q, dim=-1,
                                                     keepdim=True) + 1e-12))
    pos = before["pos"]
    scale_raw = before["scale_raw"] - torch.log(torch.tensor(
        1.6, dtype=torch.float32, device=pos.device))
    child = {k: before[k] for k in PARAM_KEYS}
    child["pos"] = torch.where(split[:, None], pos + (
        R * (noise[1] * scales)[:, None, :]).sum(-1), pos)
    child["scale_raw"] = torch.where(split[:, None], scale_raw,
                                     before["scale_raw"])
    parent = {"pos": pos + (R * (noise[0] * scales)[:, None, :]).sum(-1),
              "scale_raw": scale_raw}
    return expected_spawns(before, prune, split, clone, child, parent)


def check_adc_identities(name, state, call, expect, card):
    """One direct ADC call on ``state``, timed (profile_kernel.device_ms;
    the call waits for the device where it indexes by a mask, so that
    wait is inside the time), against ``expect(before)`` (reference_spawns
    or paper_spawns on the state before the call, with the call's noise):
    it must spawn; its counts, new_slot_mask and every written row are
    what the rule gives (positions within 1e-6 of their largest value,
    since the paper form's rotation is summed in another order; the rest
    exact); alive after = before - pruned + split + cloned; exp_avg and
    exp_avg_sq exactly 0 on new_slot_mask and unchanged elsewhere, step
    counts unchanged; every parameter row outside new_slot_mask
    unchanged, the dead slots that received no spawn among them. Returns
    the ms."""
    before = _state_snapshot(state)
    parents, children, overflow, reset, rows = expect(before)
    out = {}
    ms = device_ms(lambda: out.setdefault("r", call()), 1)
    state, res = out["r"]
    pool = state.pool
    n0, n1 = int(before["alive"].sum()), int(pool.alive.sum())
    counts = [int(getattr(res, f)) for f in (
        "num_pruned", "num_split", "num_cloned", "num_overflowed")]
    mask = res.new_slot_mask
    kept = ~mask
    spawned = counts[1] + counts[2]
    ok_alive = n1 == n0 - counts[0] + spawned
    ok_spawn = (spawned > 0 and spawned == len(children)
                and counts[3] == overflow and torch.equal(mask, reset))
    ok_moments = ok_rows = True
    for k, p in pool.params.items():
        st = state.opt_state.state[p]
        for f in ("exp_avg", "exp_avg_sq"):
            ok_moments &= bool((st[f][mask] == 0).all()) and bool(
                torch.equal(st[f][kept], before[f"{k}.{f}"][kept]))
        ok_moments &= bool(torch.equal(st["step"], before[f"{k}.step"]))
        ok_rows &= bool(torch.equal(p.detach()[kept], before[k][kept]))
        slots, want = rows[k]
        got = p.detach()[slots]
        if k == "pos":
            ok_spawn &= bool((got - want).abs().max() <= 1e-6 * max(
                1.0, float(want.abs().max())))
        else:
            ok_spawn &= bool(torch.equal(got, want))
    print(f"[{card}] {name} on the state run (a) returned: {ms:.3f} ms "
          f"(CUDA events); pruned {counts[0]}, split {counts[1]}, cloned "
          f"{counts[2]}, overflowed {counts[3]}; alive {n0} -> {n1} "
          f"(= before - pruned + split + cloned: {ok_alive}); spawned, and "
          f"counts, reset mask and the {len(children)} child slots (each "
          f"holding its parent's row, split offset applied) as the rule "
          f"gives: {ok_spawn}; moments 0 on the {int(mask.sum())} reset "
          f"slots and unchanged elsewhere, counts unchanged: {ok_moments}; "
          f"rows outside the reset slots unchanged (among them "
          f"{int((~before['alive'] & kept).sum())} dead slots that received "
          f"no spawn): {ok_rows}", flush=True)
    if not (ok_alive and ok_spawn and ok_moments and ok_rows):
        raise SystemExit(f"FAIL: {name} identities")
    return ms


def uv_statistics(state, batch, cfg, tcfg, plain=False):
    """(uv_grad_sum, visible, max_radius) of one paper-mode step on
    ``state`` without its update; with ``plain`` the backward compositor
    is its plain version (composite_pairs_bwd_plain) in place of K2."""
    from gsplat_tpu_torch.ops import raster_cuda
    from gsplat_tpu_torch.train.trainer import value_and_grads

    real = raster_cuda.composite_pairs_bwd
    if plain:
        raster_cuda.composite_pairs_bwd = functools.partial(
            raster_cuda.composite_pairs_bwd_plain, block_chunk=256)
    try:
        _, m, _ = value_and_grads(state, batch, cfg, tcfg)
    finally:
        raster_cuda.composite_pairs_bwd = real
    torch.cuda.synchronize()
    return m["uv_grad_sum"], m["visible"], m["max_radius"]


def fit_checks_a(res, runs, batch, dev, card):
    """Run (a)'s iteration-6 checkpoint, loaded into a fresh state, equals
    the state after step 6 bit for bit; then one direct adc_step_paper and
    one adc_step (at (b)'s max_grad) on the state (a) returned, each
    spawning, with their identities and child rows.
    Returns the two calls' ms."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.train import trainer

    state, report, rec = res["state"], res["report"], res["rec"]
    path = next(c for c in report.checkpoints if c.endswith("000006.npz"))
    fresh = gt.init_train_state(gt.init_pool_from_points(
        np.zeros((4, 3), np.float32), 8, device=dev), runs["a"])
    loaded = _state_snapshot(trainer.load_checkpoint(path, fresh))
    saved = rec["snapshot"]
    same = loaded.keys() == saved.keys() and all(
        torch.equal(loaded[k], saved[k]) for k in saved)
    print(f"[{card}] fit (a): the iteration-6 checkpoint loaded into a fresh "
          f"state equals the state after step 6 bit for bit (step, alive, "
          f"params, moments, counts; {len(saved)} tensors): {same}",
          flush=True)
    if not same:
        raise SystemExit("FAIL: checkpoint reload")
    # The paper call first, on (a)'s state as it came back; then the
    # reference call with (b)'s max_grad, so that it spawns (at (a)'s
    # max_grad it only prunes) and runs out of free slots.
    gen = torch.Generator(device=dev).manual_seed(1)
    uv, vis, rad = uv_statistics(state, batch, res["cfg"], runs["c"])
    avg = uv / torch.clamp(vis, min=1).to(torch.float32)
    eps = tuple(torch.randn(state.pool.pos.shape, generator=gen, device=dev)
                for _ in range(2))
    paper_ms = check_adc_identities(
        "adc_step_paper", state, lambda: trainer.adc_step_paper(
            state, avg, rad, None, runs["c"], noise=eps),
        lambda b: paper_spawns(b, avg, rad, eps, runs["c"]), card)
    tcfg = runs["b"]
    grad = rec["last_metrics"]["pos_grad"]
    noise = torch.randn(state.pool.pos.shape, generator=gen, device=dev)
    adc_ms = check_adc_identities(
        "adc_step", state, lambda: trainer.adc_step(
            state, grad, None, (tcfg.prune_opacity_threshold, tcfg.max_grad,
                                tcfg.scale_threshold), noise=noise),
        lambda b: reference_spawns(b, grad, noise, tcfg), card)
    return adc_ms, paper_ms


def fit_run(fit_mod, name, tcfg, cfg, batch, points, start_ckpt, out_dir,
            card):
    """One fit() run with the launch counts set to 0 just before it and
    read just after, its record (_instrument_fit) and its checks: finite
    losses, no skipped step, K1 and K2 launched views x iterations times;
    (a), (c): the final loss below the first logged after the last
    densification; (b): the pool grew past its capacity; (d): max_pairs
    grew and the last step's demand fits it; (b), (d): "growing max_pairs"
    was logged wherever a logged pair demand exceeded the capacity.
    Returns a dict of what the later checks read."""
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs
    from gsplat_tpu_torch.utils.memory import estimate_train_memory

    rec = {"max_pairs": [], "ms": [], "demand": [], "adc": [], "steps": 0,
           "snapshot_at": 6 if name == "a" else None}
    lines = []

    def log(msg):
        lines.append(msg)
        print(f"  [fit {name}] {msg}", flush=True)

    def batches():
        while True:
            yield batch

    cap0 = tcfg.capacity
    real = _instrument_fit(fit_mod, rec)
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - tensor_bytes(batch)
    torch.cuda.reset_peak_memory_stats()
    composite_pairs.launches = 0
    composite_pairs.bwd_launches = 0
    try:
        state, report = fit_mod.fit(
            batches(), cfg, tcfg, output_dir=out_dir, initial_points=points,
            resume_from=start_ckpt, log_every=2, log_fn=log,
            device=batch["image"].device)
    finally:
        _restore_fit(fit_mod, real)
    k1, k2 = composite_pairs.launches, composite_pairs.bwd_launches
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    views = TRAIN_BATCH * FIT_ITERS
    adc = [(it, capb, ev[0].elapsed_time(ev[1]), [int(getattr(r, f)) for f in (
        "num_pruned", "num_split", "num_cloned", "num_overflowed")])
        for it, capb, ev, r in rec["adc"]]
    print(f"[{card}] fit ({name}) {tcfg.adc_mode} ADC, {FIT_ITERS} "
          f"iterations of batch {TRAIN_BATCH} at {TRAIN_W}x{TRAIN_H}: logged "
          f"losses " + ", ".join(f"{it}: {v:.6f}" for it, v in report.losses)
          + f"; nonfinite steps {report.nonfinite_steps}; overflow events "
          f"{report.overflow_events}; K1 launches {k1}, K2 launches {k2} "
          f"(views x iterations = {views})", flush=True)
    for it, capb, ms, c in adc:
        print(f"  [{card}] fit ({name}) densification at iteration {it}: "
              f"pruned {c[0]}, split {c[1]}, cloned {c[2]}, overflowed "
              f"{c[3]} (capacity {capb}); {ms:.3f} ms (CUDA events around "
              f"the ADC call)", flush=True)
    print(f"  [{card}] fit ({name}): capacity {cap0} -> "
          f"{state.pool.capacity}, {report.num_gaussians} alive at the end; "
          f"max_pairs {rec['max_pairs'][0]} -> {rec['max_pairs'][-1]}; pair "
          f"demand per step " + ", ".join(
              f"{it}: {d}/{c}" for it, d, c in rec["demand"])
          + f"; step ms (host clock to synchronize) median "
          f"{float(np.median(rec['ms'])):.3f} (" + ", ".join(
              f"{t:.1f}" for t in rec["ms"]) + f"); peak device memory "
          f"{peak_gib:.2f} GiB; wall {report.wall_time_s:.2f} s", flush=True)
    # The run holds this script's snapshot of the state after step 6 (the
    # checkpoint check's) from then on: not fit()'s.
    memory_line(card, f"fit ({name}) (its step at capacity "
                f"{state.pool.capacity}, max_pairs {rec['max_pairs'][-1]}; "
                f"the script's step-6 snapshot counted as held by others)",
                other + tensor_bytes(rec.get("snapshot")),
                estimate_train_memory(
                    cfg.with_(max_pairs=rec["max_pairs"][-1]),
                    dataclasses.replace(tcfg, capacity=state.pool.capacity)),
                gate=name == "a")
    losses = [v for _, v in report.losses]
    ok = (all(np.isfinite(losses)) and report.nonfinite_steps == 0
          and k1 == k2 == views and len(rec["ms"]) == FIT_ITERS)
    if name in ("a", "c"):
        last = max(it for it, *_ in adc)
        after = [v for it, v in report.losses if it > last][0]
        ok &= report.final_loss < after
        print(f"  [{card}] fit ({name}): final loss {report.final_loss:.6f} "
              f"below the first logged after the last densification "
              f"({after:.6f}): {report.final_loss < after}", flush=True)
    if name == "b":
        grew = any("growing pool capacity" in m for m in lines)
        ok &= (report.overflow_events >= 1 and grew
               and state.pool.capacity > cap0 and report.num_gaussians > cap0)
    if name == "d":
        ok &= (rec["max_pairs"][-1] > cfg.max_pairs
               and rec["demand"][-1][1] <= rec["demand"][-1][2])
    if name in ("b", "d"):
        logged = {it for it, _ in report.losses}
        for it, d, c in rec["demand"]:
            if it in logged and d > c:
                ok &= any(m.startswith(f"iter {it}: pair overflow")
                          and "growing max_pairs" in m for m in lines)
    if not ok:
        raise SystemExit(f"FAIL: fit run ({name})")
    return dict(state=state, report=report, rec=rec, k1=k1, k2=k2,
                cfg=cfg.with_(max_pairs=rec["max_pairs"][-1]))


def fit_phase(pool, bench_c2w, center, radius, card):
    """Phase 8b: fit() at full width from the perturbed checkpoint, four
    runs of FIT_ITERS iterations on the batch of phase 8, each resumed from
    one file the port's save_checkpoint wrote (the perturbed pool, a fresh
    optimizer state): (a) reference ADC at the JAX defaults; (b) as (a)
    with max_grad 1e-9, so that the pool must grow; (c) paper ADC; (d) as
    (a) from max_pairs 2**20, so that max_pairs must grow. Then the
    iteration-6 checkpoint of (a) against the state after step 6, direct
    adc_step and adc_step_paper calls on (a)'s state, and (c)'s
    uv_grad_sum through K2 against the plain backward compositor.
    Returns (K1 launches, K2 launches) of the runs."""
    import importlib
    import tempfile

    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.train import trainer

    fit_mod = importlib.import_module("gsplat_tpu_torch.train.fit")
    dev = pool.pos.device
    cfg, batch, start = train_views(pool, bench_c2w, center, radius)
    points = pool.pos.detach()[pool.alive].cpu().numpy()
    common = dict(iterations=FIT_ITERS, batch_size=TRAIN_BATCH,
                  capacity=pool.capacity, checkpoint_interval=6)
    ref = dict(common, densification_interval=4, densify_until_iter=12,
               opacity_reset_interval=8)
    runs = {
        "a": gt.TrainConfig(**ref),
        "b": gt.TrainConfig(**ref, max_grad=1e-9),
        "c": gt.TrainConfig(**common, adc_mode="paper",
                            densify_grad_threshold=2e-4,
                            scene_extent=float(radius), max_screen_size=0,
                            densification_interval=6, densify_until_iter=12,
                            opacity_reset_interval=10**9),
        # (d) starts at max_pairs TRAIN_PAIRS / 2 = 2**20, below the 1.22 M
        # pairs a view needs.
        "d": gt.TrainConfig(**ref),
    }
    k1 = k2 = 0
    tmp = tempfile.mkdtemp(prefix="gsplat_fit_")
    try:
        start_ckpt = os.path.join(tmp, "start.npz")
        trainer.save_checkpoint(start_ckpt, gt.init_train_state(
            gt.pool_from_numpy(start, pool.alive.cpu().numpy(), device=dev),
            runs["a"]))
        for name, tcfg in runs.items():
            rcfg = cfg.with_(max_pairs=TRAIN_PAIRS // 2) if name == "d" \
                else cfg
            res = fit_run(fit_mod, name, tcfg, rcfg, batch, points,
                          start_ckpt, os.path.join(tmp, name), card)
            k1 += res["k1"]
            k2 += res["k2"]
            if name == "a":
                fit_checks_a(res, runs, batch, dev, card)
            if name == "c":
                paper = res
            shutil.rmtree(os.path.join(tmp, name), ignore_errors=True)
            del res

        # (c): uv_grad_sum through K2 against the plain backward compositor.
        uv_k, vis_k, rad_k = uv_statistics(paper["state"], batch,
                                           paper["cfg"], runs["c"])
        uv_p, vis_p, rad_p = uv_statistics(paper["state"], batch,
                                           paper["cfg"], runs["c"],
                                           plain=True)
        scale = float(uv_p.abs().max())
        err = float((uv_k - uv_p).abs().max())
        same = bool(torch.equal(vis_k, vis_p) and torch.equal(rad_k, rad_p))
        print(f"[{card}] fit (c): one paper step's uv_grad_sum through K2 vs "
              f"the plain backward compositor: max abs {err:.3e} of max "
              f"{scale:.3e} (relative {err / max(scale, 1e-30):.3e}, tol "
              f"{BWD_TOL}); {int((vis_k > 0).sum())} gaussians visible; "
              f"visible and max_radius exact: {same}", flush=True)
        if not (scale > 0 and err <= BWD_TOL * scale and same):
            raise SystemExit("FAIL: uv_grad_sum through K2 disagrees with "
                             "the plain backward compositor")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return k1, k2


def ablation_phase(card, dev):
    """Phase 10: K1 and the eight K3 kernels against their plain versions
    on the profiler's 1080p workload (K1 rows 0-5 bit for bit and its cull
    checked; the K3 kernels rows 0-4 within TOL, row 5 exact; rows 6-7
    zero, finite), cumprod and pg-* also against K1's plain
    version (rows 0-4 within TOL, row 5 exact). The six bodies built from
    K1's kernel (``raster_ablate.K1_BODIES``); those that cull
    (``raster_ablate.CULLS``) also report the (pair, warp) they skipped,
    which must equal the plain test's count (``cull_audit``, no-transc with
    its own threshold), none with a non-zero alpha of the body's own. Then
    each plain version's time, and the profiler through its entry point
    with every launch count set to 0 just before: its attribution table
    (K1 minus each variant, the class each difference isolates) and the
    gate empty <= no-compute <= full within ABLATION_ORDER_SLACK.
    Returns ({variant: max abs error}, {variant: plain ms}, {variant: the
    profiler's result}, {variant: launches in the profiler's run}, the
    share of (pair, warp) K1's cull skips)."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch import profile_kernel
    from gsplat_tpu_torch.ops import _build
    from gsplat_tpu_torch.ops.raster_ablate import (CULLS, K1_BODIES,
                                                    K1_FUNCTION, PG_VARIANTS,
                                                    VARIANTS, ablate,
                                                    ablate_plain,
                                                    pg_resources)
    from gsplat_tpu_torch.ops.raster_cuda import (active_blocks,
                                                  composite_pairs,
                                                  composite_pairs_plain,
                                                  cull_audit,
                                                  tile_block_offsets)

    cfg = gt.RenderConfig(height=H, width=W, max_pairs=2**18)
    ptxas = _build.build(("raster_ablate",))["raster_ablate"]["ptxas"]
    for v in PG_VARIANTS:
        r = pg_resources(v, dev)
        part = ptxas.split(f"raster_pg_kernelILi{VARIANTS[v] - 6}E", 1)[1]
        spills = sum(int(n) for n in re.findall(
            r"(\d+) bytes spill (?:stores|loads)",
            part.split("Compiling entry", 1)[0]))
        print(f"[{card}] {v} (mma.sync m16n8k8 TF32, 8 warps of 2 pixel "
              f"rows): {r['registers']} registers, {r['shared_bytes']} B "
              f"static shared, {r['ctas_per_sm']} CTAs of 256 threads per "
              f"SM (occupancy API), {r['local_bytes']} B local, {spills} B "
              f"spilled (ptxas)", flush=True)
    pf, ts, tc = (t.to(dev) for t in profile_kernel.make_workload(cfg, 4))
    pairs = {"full": (composite_pairs, composite_pairs_plain)}
    pairs.update({v: (functools.partial(ablate, v),
                      functools.partial(ablate_plain, v))
                  for v in profile_kernel.VARIANTS if v != "full"})
    errs, plain_ms, digests = {}, {}, {}
    for name, (kernel, plain) in pairs.items():
        plain_fn = functools.partial(plain, pf, ts, tc, cfg, tile_chunk=512)
        skipped = torch.zeros(1, dtype=torch.int64, device=dev)
        out_k = kernel(pf, ts, tc, cfg, skipped=skipped) if name in CULLS \
            else kernel(pf, ts, tc, cfg)
        out_p = plain_fn()
        torch.cuda.synchronize()
        errs[name] = float((out_k[:, 0:5] - out_p[:, 0:5]).abs().max())
        # K1 must equal its plain version bit for bit, rows 0-5.
        tol, first, exact = (0.0, 0, "rows 0-5") if name == "full" else \
            (TOL, 5, "row 5")
        same5 = bool(torch.equal(out_k[:, first:6], out_p[:, first:6]))
        zero67 = bool((out_k[:, 6:] == 0).all())
        finite = bool(torch.isfinite(out_k).all())
        digests[name] = float(out_p[0, 0:5].sum())
        src = "K1's kernel" if name in K1_BODIES + ("full",) else \
            "its own template"
        print(f"[profile workload 1080p] {name} ({src}) vs plain: max abs "
              f"err rows 0-4 {errs[name]:.3e} (tol {tol}), {exact} exact: "
              f"{same5}, rows 6-7 zero: {zero67}, finite: {finite}, blocks "
              f"composited {int(out_k[:, 5, 0].sum())}", flush=True)
        if not (errs[name] <= tol and same5 and zero67 and finite):
            raise SystemExit(f"FAIL: {name} disagrees with its plain version")
        if name in CULLS:
            blk, tile, _ = active_blocks(ts, tile_block_offsets(out_p), cfg)
            n = cull_audit(pf, blk, tile, cfg, rational=CULLS[name])
            got = int(skipped.item())
            print(f"[profile workload 1080p] {name}'s cull "
                  f"({'its own alpha' if CULLS[name] else 'K1'}'s "
                  f"threshold): the kernel skipped {got} of {n['total']} "
                  f"(pair, warp), the plain test {n['skipped']} "
                  f"({n['skipped'] / n['total']:.4f}), all-zero "
                  f"{n['zero']}, unsafe {n['unsafe']}", flush=True)
            if got != n["skipped"] or n["unsafe"] != 0 or got == 0:
                raise SystemExit(f"FAIL: {name}'s cull disagrees with the "
                                 f"plain test")
        if name == "full":
            k1_plain = out_p
            n = check_cull("profile workload 1080p", pf, ts, tc, out_p, cfg)
            cull = n["skipped"] / n["total"]
        else:
            plain_ms[name] = device_ms(plain_fn, 1)
        if name in K1_FUNCTION:
            err_k1 = float((out_k[:, 0:5] - k1_plain[:, 0:5]).abs().max())
            same5_k1 = bool(torch.equal(out_k[:, 5], k1_plain[:, 5]))
            print(f"[profile workload 1080p] {name} vs K1's plain version: "
                  f"max abs err rows 0-4 {err_k1:.3e} (tol {TOL}), row 5 "
                  f"exact: {same5_k1}", flush=True)
            if not (err_k1 <= TOL and same5_k1):
                raise SystemExit(f"FAIL: {name} disagrees with K1's plain "
                                 f"version")
        del out_k, out_p
    del k1_plain

    # The slice's main path: the profiler, as a user runs it. It prints the
    # attribution table (K1 minus each variant) itself.
    composite_pairs.launches = 0
    for v in ablate.launches:
        ablate.launches[v] = 0
    res = {r["name"]: r for r in profile_kernel.main(
        ["--iters", "20", "--device", str(dev)])}
    counts = {name: profile_kernel.launch_count(name) for name in pairs}
    print(f"[{card}] profiler launches (counts set to 0 before it): "
          + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
    for name in pairs:
        r = res[name]
        if counts[name] == 0 or r["launches"] != counts[name] \
                or not r["ms"] > 0 or abs(r["digest"] - digests[name]) > 1e-3:
            raise SystemExit(f"FAIL: profiler variant {name}: {r}, plain "
                             f"digest {digests[name]}, {counts[name]} "
                             f"launches")
    for v in PG_VARIANTS:
        print(f"[{card}] {v}: {res[v]['ps_per_pair_pixel']:.4f} ps per "
              f"(pair, pixel) computed (every (pair, pixel) of "
              f"{res[v]['blocks']} blocks) against K1's "
              f"{res['full']['ps_per_pair_pixel']:.4f} ps per (pair, pixel) "
              f"its cull reaches ({res['full']['reached']} (pair, warp) x "
              f"32); {res[v]['ms']:.4f} ms against K1's "
              f"{res['full']['ms']:.4f}", flush=True)
    e, nc, k1 = (res[v]["ms"] for v in ("empty", "no-compute", "full"))
    order = e <= ABLATION_ORDER_SLACK * nc and \
        nc <= ABLATION_ORDER_SLACK * k1
    print(f"[{card}] gate empty <= no-compute <= full (x "
          f"{ABLATION_ORDER_SLACK}): {e:.4f} <= {nc:.4f} <= {k1:.4f} ms: "
          f"{order}", flush=True)
    if not order:
        raise SystemExit("FAIL: the ablations are out of order: a body "
                         "that does less takes longer than one that does "
                         "more")
    return errs, plain_ms, res, counts, cull


def rup(x):
    """--auto_pairs' sizing (render_trained.py): the demand + 20 %, rounded
    up to 4,096."""
    return max(4096, -(-int(x * 1.2) // 4096) * 4096)


def bwd_bound(bargs, cfg, ops_per_pair_pixel, out_cols=None):
    """K2's bound on the inputs autograd handed it (pair_feat, tile_start,
    tile_count, out, state, gout, cfg): (ms, "bytes" or "operations",
    operations, bytes, composited blocks). Read once: the tile ranges and
    each tile's block count (row 5), the active blocks' feature rows and
    block-start state, rows 0-4 of the forward output and of the cotangent
    of the tiles with active blocks; written once: the whole [10, pairs]
    gradient, zeros included, or in compact mode its [10, out_cols]."""
    G, P = cfg.pair_block, cfg.tile * cfg.tile
    bblocks = int(torch.where(bargs[2] > 0, bargs[3][:, 5, 0], 0.0).sum())
    bops = bblocks * G * P * ops_per_pair_pixel
    btiles = int(((bargs[2] > 0) & (bargs[3][:, 5, 0] > 0)).sum())
    bbytes = cfg.num_tiles * 3 * 4 + bblocks * (FEAT_ROWS * G + 5 * P) * 4 \
        + btiles * 2 * 5 * P * 4 \
        + FEAT_ROWS * (out_cols or bargs[0].shape[1]) * 4
    bt_ops = bops / PEAK_F32_FLOPS * 1e3
    bt_bytes = bbytes / PEAK_BYTES * 1e3
    return (max(bt_ops, bt_bytes), "operations" if bt_ops >= bt_bytes
            else "bytes", bops, bbytes, bblocks)


def grads_of(pool, c2w, fx, fy, cx, cy, cfg):
    """One fwd+bwd of render_from_params (loss mean(im) + mean(im^2)):
    (the inputs autograd handed K2, whether every gradient is finite)."""
    leaves, seen = record_backward(pool.params, c2w, fx, fy, cx, cy, cfg,
                                   pool.alive)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(p.grad).all()) for p in leaves.values())
    return seen["args"], finite


def log_phase(pool, c2w, traj, fx, fy, cx, cy, cfg, pf, binning, plain_img,
              card, instr):
    """Phase 11a: transmittance_math="log" at the bench pose. K1-log
    against its plain version (rows 0-5 and state bit for bit, the cull's
    count), K2-log given K1-log's state (BWD_TOL, zeros, two launches
    equal), the log image against the cumprod one; then the main path with
    both counts set to 0: the bench pose and the orbit served through
    make_render_fn, and one fwd+bwd of render_from_params. Times and bounds
    of both kernels. Returns the two kernels' entries of the kernels line.
    """
    from gsplat_tpu_torch.ops.raster_cuda import (_composite_fwd,
                                                  composite_pairs,
                                                  composite_pairs_bwd,
                                                  composite_pairs_bwd_plain,
                                                  composite_pairs_plain)
    from gsplat_tpu_torch.profile_kernel import log_ops_per_pair_pixel
    from gsplat_tpu_torch.viewer import make_render_fn, render_trajectory

    cfg_l = cfg.with_(transmittance_math="log")
    ts, tc = binning.tile_start, binning.tile_count
    name = "log, trained 1080p bench pose"
    out_k = composite_pairs(pf, ts, tc, cfg_l)
    out_p, state_p = composite_pairs_plain(pf, ts, tc, cfg_l,
                                           tile_chunk=1024, with_state=True)
    torch.cuda.synchronize()
    err = compare(name, out_k, out_p, tc)
    cull = check_cull(name, pf, ts, tc, out_p, cfg_l)
    bwd_err = check_bwd(name, pf, binning, out_k, state_p, cfg_l, seed=3)
    del state_p
    d_img = float((image_from_tiles(out_p, tc, cfg_l) - plain_img).abs()
                  .max())
    print(f"[{name}] log image vs cumprod image (plain compositors, same "
          f"pairs): max abs {d_img:.3e} (the JAX package's gate on its "
          f"64x64 scene: 2e-6)", flush=True)

    # The main path: serving, then one fwd+bwd, in the log form.
    composite_pairs.log_launches = 0
    composite_pairs.bwd_log_launches = 0
    render_fn = make_render_fn(pool.params, cfg_l, fx, fy, cx, cy,
                               alive=pool.alive, report_demand=True)
    _, stats = render_trajectory(render_fn, traj, keep_frames=False,
                                 pair_capacity=cfg.max_pairs)
    bargs, finite = grads_of(pool, c2w, fx, fy, cx, cy, cfg_l)
    k1n = composite_pairs.log_launches
    k2n = composite_pairs.bwd_log_launches
    print(f"[{card}] log served {len(traj)} poses: mean "
          f"{stats['mean_ms']:.3f} ms, median {stats['median_ms']:.3f} ms, "
          f"pipelined {stats['pipelined_ms']:.3f} ms/frame (host clock), "
          f"overflow frames {stats['pair_overflow_frames']}; one fwd+bwd, "
          f"grads finite {finite}; K1-log launches {k1n}, K2-log launches "
          f"{k2n} (counts set to 0 before)", flush=True)
    if not (finite and k1n == 2 * len(traj) + 2 and k2n == 1
            and stats["pair_overflow_frames"] == 0):
        raise SystemExit("FAIL: the log path's launches or gradients")

    G = cfg.pair_block
    blocks = int(torch.where(tc > 0, out_k[:, 5, 0], 0.0).sum())
    fwd_ms = device_ms(lambda: composite_pairs(pf, ts, tc, cfg_l), 20)
    fwd_plain_ms = device_ms(lambda: composite_pairs_plain(
        pf, ts, tc, cfg_l, tile_chunk=1024), 2)
    ops1 = log_ops_per_pair_pixel(26, instr)
    f_bound, f_by = bound_ms("full", blocks, cfg_l,
                             cull["total"] - cull["skipped"], ops1)
    bwd_ms = device_ms(lambda: composite_pairs_bwd(*bargs), 20)
    bwd_plain_ms = device_ms(lambda: composite_pairs_bwd_plain(
        *bargs, block_chunk=256), 2)
    ops2 = log_ops_per_pair_pixel(OPS_BWD_PER_PAIR_PIXEL, instr)
    b_bound, b_by, bops, bbytes, bblocks = bwd_bound(bargs, cfg_l, ops2)
    state_ms = device_ms(lambda: _composite_fwd(pf, ts, tc, cfg_l,
                                                with_state=True), 20)
    print(f"[{card}] raster_fwd[log] at the bench pose: {fwd_ms:.4f} ms "
          f"(CUDA events, 20 launches; writing the state {state_ms:.4f} "
          f"ms), plain {fwd_plain_ms:.3f} ms; {blocks} active blocks; "
          f"bound {f_bound:.4f} ms by {f_by} ({ops1} operations per reached "
          f"(pair, pixel): log1pf {instr['log1pf']} and expf "
          f"{instr['expf']} SASS instructions; share {f_bound / fwd_ms:.3f})"
          f"; raster_bwd[log]: {bwd_ms:.4f} ms (20 launches), plain "
          f"{bwd_plain_ms:.3f} ms; {bblocks} active blocks; bound "
          f"{b_bound:.4f} ms by {b_by} ({ops2} per (pair, pixel), "
          f"{bops:.3e} ops, {bbytes:.3e} bytes; share "
          f"{b_bound / bwd_ms:.3f})", flush=True)
    entry = dict(route="cuda", library_ms=None)
    return [dict(entry, name="raster_fwd[log]",
                 source="gsplat_tpu_torch/ops/csrc/raster_fwd.cu",
                 replaces="gsplat_tpu/ops/raster_pallas.py:192 (log)",
                 launches=k1n, max_abs_err=err, ms=fwd_ms,
                 plain_ms=fwd_plain_ms, bound_ms=f_bound, bound_by=f_by),
            dict(entry, name="raster_bwd[log]",
                 source="gsplat_tpu_torch/ops/csrc/raster_bwd.cu",
                 replaces="gsplat_tpu/ops/raster_pallas.py:243 (log)",
                 launches=k2n, max_abs_err=bwd_err, ms=bwd_ms,
                 plain_ms=bwd_plain_ms, bound_ms=b_bound, bound_by=b_by)]


def trunc_phase(pool, c2w, traj, fx, fy, cx, cy, cfg, exact_img, card):
    """Phases 11b and 11c: per-tile rank truncation at the bench pose
    (tile_rank_cap LEVER_CAP, LEVER_CHUNKS depth chunks, trunc_pairs sized
    as --auto_pairs does): K1 on the truncated list bit for bit with its
    plain version, K2 on it as in phase 4; the cull on against off
    bit-identical with equal kept pairs and a lower demand; the image
    against the exact one; frame times with and without the lever over the
    served trajectory (exact, lever, lever, exact; the counts set to 0
    around the lever's runs); one fwd+bwd. Then overflow, trunc_pairs at
    half the demand: reported, finite, equal to the plain version on the
    same list, no block read past the list's end. Returns (K1, K2)
    launches of the lever's main-path runs and {"demand", "kept"}: the
    bench pose's pair demand after the cull and its kept pairs."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops.raster_cuda import (composite_pairs,
                                                  composite_pairs_plain)
    from gsplat_tpu_torch.render import pair_demand
    from gsplat_tpu_torch.viewer import make_render_fn, render_trajectory

    cfg_t = cfg.with_(tile_rank_cap=LEVER_CAP, cull_chunks=LEVER_CHUNKS)

    def demand(c, k):
        with torch.no_grad():
            return tuple(int(x) for x in pair_demand(
                pool.params, c, fx, fy, cx, cy, k, alive=pool.alive))

    dem = [demand(c, cfg_t) for c in traj]  # traj[0] is the bench pose
    pk, _, tk = dem[0]
    nocull = demand(c2w, cfg_t.with_(occlusion_cull=False))[0]
    print(f"[{card}] truncation K={LEVER_CAP} at the bench pose: pair "
          f"demand {pk} with the occlusion cull ({LEVER_CHUNKS} chunks), "
          f"{nocull} without ({pk / nocull - 1:+.1%}); truncated demand "
          f"{tk} slots; orbit poses (pairs, truncated): "
          + ", ".join(f"({d[0]}, {d[2]})" for d in dem[1:]), flush=True)
    if not pk < nocull:
        raise SystemExit("FAIL: the occlusion cull removed no pair")

    cfg_b = cfg_t.with_(trunc_pairs=rup(tk))
    name = f"truncated K={LEVER_CAP}, bench pose"
    sp = serving_path(pool.params, c2w, fx, fy, cx, cy, cfg_b,
                      alive=pool.alive)
    pf, b = sp["pair_feat"], sp["bin"]
    out_k = composite_pairs(pf, b.tile_start, b.tile_count, cfg_b)
    out_p, state_p = composite_pairs_plain(pf, b.tile_start, b.tile_count,
                                           cfg_b, tile_chunk=1024,
                                           with_state=True)
    torch.cuda.synchronize()
    print(f"[{name}] list of {pf.shape[1]} slots (trunc_pairs "
          f"{cfg_b.trunc_pairs}), {int(b.num_pairs_kept)} pairs kept of "
          f"{int(b.num_pairs)}", flush=True)
    compare(name, out_k, out_p, b.tile_count)
    check_cull(name, pf, b.tile_start, b.tile_count, out_p, cfg_b)
    check_bwd(name, pf, b, out_k, state_p, cfg_b, seed=4)
    del state_p, out_p

    with torch.no_grad():
        img_on, aux_on = gt.render_from_params(
            pool.params, c2w, fx, fy, cx, cy, cfg_b, alive=pool.alive)
        img_off, aux_off = gt.render_from_params(
            pool.params, c2w, fx, fy, cx, cy,
            cfg_b.with_(occlusion_cull=False), alive=pool.alive)
    same = bool(torch.equal(img_on, img_off))
    kept = (int(aux_on.num_pairs_kept), int(aux_off.num_pairs_kept))
    d_exact = float((img_on - exact_img).abs().max())
    print(f"[{name}] cull on vs off: image bit-identical {same}, pairs kept "
          f"{kept[0]} / {kept[1]}, pair demand {int(aux_on.num_pairs)} / "
          f"{int(aux_off.num_pairs)}; truncated image vs the exact served "
          f"frame: max abs {d_exact:.3e}", flush=True)
    if not (same and kept[0] == kept[1]
            and int(aux_on.num_pairs) < int(aux_off.num_pairs)):
        raise SystemExit("FAIL: the occlusion cull changed the image")

    # Frame time with and without the lever, capacities as --auto_pairs
    # sizes them over the trajectory.
    cfg_auto = cfg_t.with_(
        max_pairs=min(rup(max(d[0] for d in dem)), cfg.max_pairs),
        trunc_pairs=rup(max(d[2] for d in dem)))
    exact_fn = make_render_fn(pool.params, cfg, fx, fy, cx, cy,
                              alive=pool.alive, report_demand=True)
    lever_fn = make_render_fn(pool.params, cfg_auto, fx, fy, cx, cy,
                              alive=pool.alive, report_demand=True)
    runs = []
    for i, fn in enumerate((exact_fn, lever_fn, lever_fn, exact_fn)):
        if i == 1:
            composite_pairs.launches = 0
            composite_pairs.bwd_launches = 0
        runs.append(render_trajectory(fn, traj, keep_frames=False,
                                      pair_capacity=cfg.max_pairs)[1])
        if i == 2:
            bargs, finite = grads_of(pool, c2w, fx, fy, cx, cy, cfg_b)
            k1, k2 = composite_pairs.launches, composite_pairs.bwd_launches
    print(f"[{card}] served {len(traj)} poses, exact (max_pairs "
          f"{cfg.max_pairs}) / with the lever (max_pairs "
          f"{cfg_auto.max_pairs}, trunc_pairs {cfg_auto.trunc_pairs}), host "
          f"clock: median " + " / ".join(f"{r['median_ms']:.3f}"
                                         for r in runs)
          + " ms; mean " + " / ".join(f"{r['mean_ms']:.3f}" for r in runs)
          + " ms; pipelined " + " / ".join(f"{r['pipelined_ms']:.3f}"
                                           for r in runs)
          + f" ms/frame (runs exact, lever, lever, exact); one truncated "
          f"fwd+bwd: grads finite {finite}; K1 launches {k1}, K2 launches "
          f"{k2} in the lever's runs", flush=True)
    G = cfg.pair_block
    if not (finite and k1 == 2 * (2 * len(traj) + 1) + 1 and k2 == 1
            and all(r["pair_overflow_frames"] == 0 for r in runs)):
        raise SystemExit("FAIL: the truncated path's launches or gradients")
    del bargs
    stages = stage_ms(pool.params, c2w, fx, fy, cx, cy, cfg_auto, pool.alive)
    print(f"[{card}] stages of one bench-pose frame with the lever (CUDA "
          f"events, median of 5): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in stages.items()), flush=True)

    # --- 11c. overflow: trunc_pairs at half the demand ---
    cfg_c = cfg_t.with_(trunc_pairs=tk // 2)
    name = f"truncated K={LEVER_CAP}, trunc_pairs {tk // 2}"
    sp = serving_path(pool.params, c2w, fx, fy, cx, cy, cfg_c,
                      alive=pool.alive)
    pf, b = sp["pair_feat"], sp["bin"]
    out_k = composite_pairs(pf, b.tile_start, b.tile_count, cfg_c)
    out_p = composite_pairs_plain(pf, b.tile_start, b.tile_count, cfg_c,
                                  tile_chunk=1024)
    with torch.no_grad():
        img_c, aux_c = gt.render_from_params(
            pool.params, c2w, fx, fy, cx, cy, cfg_c, alive=pool.alive)
    torch.cuda.synchronize()
    compare(name, out_k, out_p, b.tile_count)
    n = pf.shape[1]
    ts = b.tile_start.long()
    walked = ts + out_k[:, 5, 0].long() * G
    nblk = (b.tile_count.long() + G - 1) // G
    cut = int(((ts + nblk * G > n) & (nblk > 0)).sum())
    inside = bool((walked <= n).all())
    d_plain = float((img_c - image_from_tiles(out_p, b.tile_count, cfg_c))
                    .abs().max())
    reported = int(aux_c.trunc_demand) > aux_c.trunc_capacity
    finite = bool(torch.isfinite(img_c).all())
    print(f"[{name}] overflow reported: {reported} (trunc_demand "
          f"{int(aux_c.trunc_demand)} > capacity {aux_c.trunc_capacity}); "
          f"image finite {finite}, vs the plain compositor on the same list "
          f"max abs {d_plain:.3e}; every walk inside the list's {n} slots: "
          f"{inside} ({cut} tiles cut at the end); vs the exact frame max "
          f"abs {float((img_c - exact_img).abs().max()):.3e}", flush=True)
    if not (reported and finite and d_plain == 0.0 and inside):
        raise SystemExit("FAIL: truncated-list overflow")
    return k1, k2, {"demand": pk, "kept": kept[0]}


def bucket_phase(pool, fx, fy, cx, cy, cfg, center, radius, card):
    """Phase 11d: a bucketed close-in orbit through the CLI, as a user runs
    it (render_trained --orbit_scale 1.0 --num_frames 8 --tile_rank_cap
    LEVER_CAP --bucket_pairs 4 --max_pairs CLOSE_PAIRS), with the K1 count
    set to 0 before: each pose's demand and rung, the overflow frames, and
    at every pose, the one of highest demand first, the PSNR of the served
    (truncated) frame against an exact render sized to the pose's demand.
    Returns the K1 launches and {"c2w", "exact_demand"} of the pose of
    highest demand."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch import render_trained
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs
    from gsplat_tpu_torch.render import pair_demand
    from gsplat_tpu_torch.viewer import create_orbit_trajectory

    argv = ["--checkpoint", CKPT, "--num_frames", "8", "--orbit_scale", "1.0",
            "--tile_rank_cap", str(LEVER_CAP), "--cull_chunks",
            str(LEVER_CHUNKS), "--bucket_pairs", "4", "--max_pairs",
            str(CLOSE_PAIRS), "--benchmark_only"]
    print(f"[{card}] python -m gsplat_tpu_torch.render_trained "
          + " ".join(argv), flush=True)
    composite_pairs.launches = 0
    stats = render_trained.main(argv)
    k1 = composite_pairs.launches
    print(f"[{card}] bucketed close-in orbit: rungs {stats['rungs']}; per "
          f"pose (pairs, truncated slots, rung): " + ", ".join(
              f"({d}, {t}, {stats['rungs'][r]})" for d, t, r in zip(
                  stats["frame_demand"], stats["frame_trunc_demand"],
                  stats["rung_of_frame"]))
          + f"; overflow frames {stats['pair_overflow_frames']} (demand "
          f"above {CLOSE_PAIRS}); median {stats['median_ms']:.3f} ms, mean "
          f"{stats['mean_ms']:.3f} ms, pipelined "
          f"{stats['pipelined_ms']:.3f} ms/frame; K1 launches {k1}",
          flush=True)
    if k1 < 8 or stats["frames"] != 8:
        raise SystemExit("FAIL: the bucketed orbit")

    # Every pose: the served (truncated) frame against an exact render
    # sized to the pose's demand; the pose of highest demand printed first.
    traj = create_orbit_trajectory(center, radius * 1.0, num_frames=8,
                                   elevation_deg=15.0)
    order = np.argsort(stats["frame_demand"])[::-1]
    psnrs = {}
    for i in order:
        cfg_r = stats["rung_cfgs"][stats["rung_of_frame"][i]]
        with torch.no_grad():
            exact_demand = int(pair_demand(pool.params, traj[i], fx, fy, cx,
                                           cy, cfg, alive=pool.alive)[0])
            cfg_x = cfg.with_(max_pairs=rup(exact_demand))
            img_t, aux_t = gt.render_from_params(
                pool.params, traj[i], fx, fy, cx, cy, cfg_r,
                alive=pool.alive)
            img_x, aux_x = gt.render_from_params(
                pool.params, traj[i], fx, fy, cx, cy, cfg_x,
                alive=pool.alive)
            tc = serving_path(pool.params, traj[i], fx, fy, cx, cy, cfg_x,
                              alive=pool.alive)["bin"].tile_count.float()
        mse = float(torch.mean((img_t - img_x) ** 2))
        psnrs[int(i)] = float("inf") if mse == 0 \
            else 10.0 * np.log10(1.0 / mse)
        print(f"[{card}] close-in pose {i}: exact demand {exact_demand} "
              f"pairs (max_pairs {cfg_x.max_pairs}; pairs per tile: median "
              f"{float(torch.median(tc)):.0f}, largest "
              f"{int(aux_x.max_tile_count)}), served truncated at rung "
              f"{cfg_r.max_pairs} (trunc_pairs {cfg_r.trunc_pairs}, demand "
              f"{int(aux_t.num_pairs)}, truncated {int(aux_t.trunc_demand)}"
              f"): PSNR {psnrs[int(i)]:.2f} dB against the exact render, "
              f"max abs {float((img_t - img_x).abs().max()):.3e}",
              flush=True)
        if not (bool(torch.isfinite(img_t).all())
                and int(aux_x.num_pairs) <= cfg_x.max_pairs):
            raise SystemExit("FAIL: the close-in comparison")
        del img_x, aux_x, tc
    print(f"[{card}] close-in orbit, K={LEVER_CAP}: PSNR at the pose of "
          f"highest demand ({int(order[0])}) {psnrs[int(order[0])]:.2f} dB, "
          f"worst over the 8 poses {min(psnrs.values()):.2f} dB", flush=True)
    top = int(order[0])
    with torch.no_grad():
        top_demand = int(pair_demand(pool.params, traj[top], fx, fy, cx, cy,
                                     cfg, alive=pool.alive)[0])
    return k1, {"c2w": traj[top], "exact_demand": top_demand}


def stacked_views(pool, batch, cfg):
    """The batch's per-view projections and colours, made with the calls
    render_batch_from_params makes, and their stacking: (stacked
    projections, their colours [B*N, 3], the stacked config, per-view
    projections, per-view colours)."""
    from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
    from gsplat_tpu_torch.ops.projection import (ProjectedGaussians,
                                                 project_gaussians)
    from gsplat_tpu_torch.ops.sh import evaluate_sh
    from gsplat_tpu_torch.render import stack_view_projections

    p = pool.params
    views = range(batch["c2w"].shape[0])
    with torch.no_grad():
        cov = build_cov3d_packed(p["scale_raw"], p["q_raw"])
        projs = [project_gaussians(
            p["pos"], cov, p["opacity_raw"], batch["c2w"][v], batch["fx"][v],
            batch["fy"][v], batch["cx"][v], batch["cy"][v], cfg,
            extra_valid=pool.alive) for v in views]
        colors = [evaluate_sh(p["f_dc"], p["f_rest"], p["pos"],
                              batch["c2w"][v]) for v in views]
        stacked, bcfg = stack_view_projections(
            ProjectedGaussians(*(torch.stack(f) for f in zip(*projs))), cfg)
    return stacked, torch.cat(colors), bcfg, projs, colors


def binned(proj, colors, cfg):
    """(pair features [10, pairs], binning) of a projection, as
    rasterize_binned gathers them."""
    from gsplat_tpu_torch.ops.binning import bin_gaussians
    from gsplat_tpu_torch.ops.rasterize import _gather, _pair_features

    with torch.no_grad():
        b = bin_gaussians(proj, cfg)
        feat10 = _pair_features(proj, colors, torch.float32)[
            b.depth_order.long()]
        return _gather(feat10, b.pair_slot), b


def param_grads(pool, cfg, c2w, fx, fy, cx, cy, batched=False):
    """One fwd+bwd (loss mean(im) + mean(im^2)) of render_from_params, or
    with ``batched`` of render_batch_from_params over the poses ``c2w``
    [B, 4, 4]: (aux, {leaf: gradient})."""
    import gsplat_tpu_torch as gt

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in pool.params.items()}
    render = gt.render_batch_from_params if batched else gt.render_from_params
    img, aux = render(params, c2w, fx, fy, cx, cy, cfg, alive=pool.alive)
    (torch.mean(img) + torch.mean(img * img)).backward()
    return aux, {k: p.grad for k, p in params.items()}


def grown_bwd_pairs(demand):
    """bwd_pairs as fit() grows it from an observed demand: 1.25 x the
    demand, rounded up to 1,024."""
    return -(-int(demand * 1.25) // 1024) * 1024


def levers_batch_phase(pool, batch, cfg, card):
    """Phase 12a-b: the training batch of phase 8 (B views at 960x540) as
    one stacked list: K1 with rows_mod against its plain version (rows 0-5
    bit for bit, its cull's count beside the plain test's), K2 with
    rows_mod from K1's state as in phase 4, the batch image against the B
    per-view K1 images fed the same projections (bit for bit), and
    render_batch_from_params against per-view renders (within 1e-5). K1
    times, batched and per view. Returns (K1 max abs err, K2 max abs err).
    """
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops.raster_cuda import (composite_pairs,
                                                  composite_pairs_plain)

    B = batch["c2w"].shape[0]
    stacked, colors, bcfg, projs, vcolors = stacked_views(pool, batch, cfg)
    pf, b = binned(stacked, colors, bcfg)
    ts, tc = b.tile_start, b.tile_count
    name = f"batch of {B} at {TRAIN_W}x{TRAIN_H}, view_tile_rows " \
           f"{bcfg.view_tile_rows}"
    out_k = composite_pairs(pf, ts, tc, bcfg)
    out_p, state_p = composite_pairs_plain(pf, ts, tc, bcfg, tile_chunk=1024,
                                           with_state=True)
    torch.cuda.synchronize()
    print(f"[{name}] one list of {pf.shape[1]} slots for {int(b.num_pairs)} "
          f"pairs ({bcfg.num_tiles} tiles, max_pairs {bcfg.max_pairs})",
          flush=True)
    err = compare(name, out_k, out_p, tc)
    cull = check_cull(name, pf, ts, tc, out_p, bcfg)
    bwd_err = check_bwd(name, pf, b, out_k, state_p, bcfg, seed=6)
    del state_p, out_p
    img_b = image_from_tiles(out_k, tc, bcfg).reshape(
        B, cfg.padded_height, cfg.width, 3)[:, :cfg.height]
    views, same = [], []
    for v in range(B):
        pf_v, b_v = binned(projs[v], vcolors[v], cfg)
        out_v = composite_pairs(pf_v, b_v.tile_start, b_v.tile_count, cfg)
        same.append(bool(torch.equal(
            image_from_tiles(out_v, b_v.tile_count, cfg), img_b[v])))
        views.append((pf_v, b_v.tile_start, b_v.tile_count))
    with torch.no_grad():
        imgs, aux = gt.render_batch_from_params(
            pool.params, batch["c2w"], batch["fx"], batch["fy"], batch["cx"],
            batch["cy"], cfg, alive=pool.alive)
        d_rb = max(float((imgs[v] - gt.render_from_params(
            pool.params, batch["c2w"][v], batch["fx"][v], batch["fy"][v],
            batch["cx"][v], batch["cy"][v], cfg, alive=pool.alive)[0])
            .abs().max()) for v in range(B))
    blocks = int(torch.where(tc > 0, out_k[:, 5, 0], 0.0).sum())
    k1_ms = device_ms(lambda: composite_pairs(pf, ts, tc, bcfg), 20)
    k1_views_ms = device_ms(lambda: [composite_pairs(*a, cfg) for a in views],
                            20)
    bound, by = bound_ms("full", blocks, bcfg,
                         cull["total"] - cull["skipped"])
    print(f"[{name}] batch image vs the {B} per-view K1 images on the same "
          f"projections: bit-identical {same}; render_batch_from_params vs "
          f"per-view render_from_params: max abs {d_rb:.3e} (tol 1e-5); "
          f"batch pair demand {int(aux.num_pairs)} of {aux.pair_capacity}; "
          f"K1 over the batch {k1_ms:.4f} ms (CUDA events, 20 launches; "
          f"{blocks} composited blocks; bound {bound:.4f} ms by {by}) vs "
          f"{B} per-view launches {k1_views_ms:.4f} ms", flush=True)
    if not (all(same) and d_rb <= 1e-5
            and int(aux.num_pairs) <= aux.pair_capacity):
        raise SystemExit("FAIL: the batch disagrees with its views")
    return err, bwd_err


def levers_compact_phase(pool, c2w, fx, fy, cx, cy, cfg, batch, train_cfg,
                         bargs, slot, card):
    """Phase 12c: K2 in compact mode at the 1080p bench pose, on the inputs
    the fwd+bwd of phase 7 handed K2 (``bargs``; ``slot`` the bench pose's
    pair_slot; ``batch`` and ``train_cfg`` phase 8's): bwd_pairs sized
    from the demand as fit() grows it, K2 compact against its plain
    version (BWD_TOL, zeros past the kept blocks, two launches
    bit-identical, the kept columns equal to K2's),
    times beside K2's and the reduction's at both sizes; the gradients
    sized against bwd_pairs = 0 bit for bit, at the bench pose and for the
    training batch; overflow at half the demand reported and finite.
    Returns a dict of the numbers the kernels line and phase 12d read."""
    from gsplat_tpu_torch.ops import raster_cuda as rc
    from gsplat_tpu_torch.ops.rasterize import (_reduce_pair_grads,
                                                composited_pair_keys)

    G = cfg.pair_block
    nb = bargs[0].shape[1] // G
    out, ts = bargs[3], bargs[1]
    if not (slot.shape[0] == nb * G and torch.equal(ts, bargs[1])):
        raise SystemExit("FAIL: the bench pose's binning changed")
    demand = int(torch.where(bargs[2] > 0, out[:, 5, 0], 0.0).sum()) * G
    bp = grown_bwd_pairs(demand)
    kb = min(-(-bp // G), nb)
    name = f"K2 compact, bench pose, bwd_pairs {bp}"
    d_full = rc.composite_pairs_bwd(*bargs)
    d_k = rc.composite_pairs_bwd(*bargs, kb=kb)
    d_k2 = rc.composite_pairs_bwd(*bargs, kb=kb)
    d_p = rc.composite_pairs_bwd_plain(*bargs, block_chunk=256, kb=kb)
    off = rc.tile_block_offsets(out)
    blk, _, _, valid = rc.composited_blocks(ts, off, kb, cfg)
    kept = int(valid.sum())
    cols = (blk[valid, None] * G + torch.arange(G, device=blk.device)
            ).reshape(-1)
    torch.cuda.synchronize()
    rel = []
    for r in range(FEAT_ROWS):
        scale = float(d_p[r].abs().max())
        e = float((d_k[r] - d_p[r]).abs().max())
        rel.append(e / scale if scale > 0 else (0.0 if e == 0 else 1.0))
    err = float((d_k - d_p).abs().max())
    zeros = bool((d_k[:, kept * G:] == 0).all())
    same = bool(torch.equal(d_k, d_k2))
    as_k2 = bool(torch.equal(d_k[:, :kept * G], d_full[:, cols]))
    print(f"[{name}] demand {demand} pair slots ({demand // G} blocks) of "
          f"{nb * G}; kb {kb}, {kept} blocks kept; K2 compact vs plain: max "
          f"abs {err:.3e}, max per-row relative {max(rel):.3e} (tol "
          f"{BWD_TOL}); zeros past the kept blocks: {zeros}; two launches "
          f"bit-identical: {same}; kept columns equal to K2's: {as_k2}",
          flush=True)
    if not (max(rel) <= BWD_TOL and zeros and same and as_k2
            and kept == demand // G):
        raise SystemExit("FAIL: K2 compact disagrees with its plain version")
    k2_ms = device_ms(lambda: rc.composite_pairs_bwd(*bargs), 20)
    k2c_ms = device_ms(lambda: rc.composite_pairs_bwd(*bargs, kb=kb), 20)
    plain_ms = device_ms(lambda: rc.composite_pairs_bwd_plain(
        *bargs, block_chunk=256, kb=kb), 2)
    bound, by, bops, bbytes, _ = bwd_bound(bargs, cfg, OPS_BWD_PER_PAIR_PIXEL,
                                           out_cols=kb * G)
    n = pool.capacity

    def reduce(k, d):
        return lambda: _reduce_pair_grads(
            composited_pair_keys(slot, ts, out, n, k, cfg), d, n)

    red_full = device_ms(reduce(0, d_full), 5)
    red_comp = device_ms(reduce(kb, d_k), 5)
    del d_full, d_k, d_k2, d_p
    print(f"[{card}] raster_bwd[compact] at the bench pose: {k2c_ms:.4f} ms "
          f"(CUDA events, 20 launches) against raster_bwd {k2_ms:.4f} ms on "
          f"the same inputs; plain {plain_ms:.3f} ms; bound {bound:.4f} ms "
          f"by {by} ({bops:.3e} ops, {bbytes:.3e} bytes; share "
          f"{bound / k2c_ms:.3f}); the reduction (keys, stable sort of "
          f"{nb * G} / {kb * G} slots, segmented sum) {red_full:.3f} / "
          f"{red_comp:.3f} ms (whole list / compact, CUDA events, median "
          f"of 5)", flush=True)

    # Gradients: sized against bwd_pairs = 0, bit for bit; half: reported.
    fwdbwd = {}
    for label, c in (("0", cfg), ("sized", cfg.with_(bwd_pairs=bp))):
        param_grads(pool, c, c2w, fx, fy, cx, cy)
        torch.cuda.synchronize()
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            aux, g = param_grads(pool, c, c2w, fx, fy, cx, cy)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        fwdbwd[label] = (aux, g, float(np.median(ms)))
    g0, gs = fwdbwd["0"][1], fwdbwd["sized"][1]
    bit = all(torch.equal(g0[k], gs[k]) for k in g0)
    aux_h, g_h = param_grads(pool, cfg.with_(bwd_pairs=demand // 2), c2w, fx,
                             fy, cx, cy)
    reported = int(aux_h.bwd_demand) > aux_h.bwd_capacity
    finite = all(bool(torch.isfinite(v).all()) for v in g_h.values())
    # The training batch, batched, sized from its own demand.
    args = (batch["c2w"], batch["fx"], batch["fy"], batch["cx"], batch["cy"])
    aux_b0, gb0 = param_grads(pool, train_cfg, *args, batched=True)
    bdemand = int(aux_b0.bwd_demand)
    bbp = grown_bwd_pairs(bdemand)
    aux_bs, gbs = param_grads(pool, train_cfg.with_(bwd_pairs=bbp), *args,
                              batched=True)
    bit_b = all(torch.equal(gb0[k], gbs[k]) for k in gb0)
    print(f"[{card}] bench-pose fwd+bwd with bwd_pairs {bp} vs 0: gradients "
          f"bit-identical {bit} (demand {int(fwdbwd['sized'][0].bwd_demand)} "
          f"of capacity {fwdbwd['sized'][0].bwd_capacity}); host clock to "
          f"synchronize, median of 5: {fwdbwd['sized'][2]:.3f} ms vs "
          f"{fwdbwd['0'][2]:.3f} ms; at half the demand (bwd_pairs "
          f"{demand // 2}): overflow reported {reported}, gradients finite "
          f"{finite}; the training batch ({batch['c2w'].shape[0]} views "
          f"batched, demand {bdemand}, bwd_pairs {bbp}, capacity "
          f"{aux_bs.bwd_capacity}): gradients bit-identical to bwd_pairs 0: "
          f"{bit_b}", flush=True)
    if not (bit and reported and finite and bit_b
            and int(fwdbwd["sized"][0].bwd_demand)
            <= fwdbwd["sized"][0].bwd_capacity):
        raise SystemExit("FAIL: the compacted backward's gradients")
    return dict(err=err, ms=k2c_ms, plain_ms=plain_ms, bound=bound, by=by,
                batch_bwd_pairs=bbp, k2_ms=k2_ms)


def levers_train_phase(pool, batch, start, cfg, bwd_pairs, train_ms, card):
    """Phase 12d: TRAIN_STEPS steps with batched_render, without and with
    the compacted backward (bwd_pairs from phase 12c), each with the launch
    counts set to 0 just before it: the loss falls, no step is skipped,
    one K1 and one K2 launch per step (compact with bwd_pairs), no
    overflow; step ms beside phase 8's per-view step, peak memory, and the
    parts of the batched step. Returns the launches {counter: n}."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs
    from gsplat_tpu_torch.utils.memory import estimate_train_memory

    B = batch["c2w"].shape[0]
    tcfg = gt.TrainConfig(capacity=pool.capacity, batch_size=B,
                          densification_interval=10**9,
                          opacity_reset_interval=10**9, batched_render=True)
    state = tpool = step = None
    counters = ("launches", "bwd_launches", "bwd_compact_launches")
    total = dict.fromkeys(counters, 0)
    for label, rcfg in (("batched", cfg),
                        (f"batched, bwd_pairs {bwd_pairs}",
                         cfg.with_(bwd_pairs=bwd_pairs))):
        state = tpool = step = None  # the previous run's state is freed
        torch.cuda.synchronize()
        other = torch.cuda.memory_allocated() - tensor_bytes(batch)
        tpool = gt.pool_from_numpy(start, pool.alive.cpu().numpy(),
                                   device=pool.pos.device)
        state = gt.init_train_state(tpool, tcfg)
        step = gt.make_train_step(rcfg, tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            setattr(composite_pairs, c, 0)
        ms, metrics = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append(m)
        n = {c: getattr(composite_pairs, c) for c in counters}
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(m["total"]) for m in metrics]
        skipped = [int(m["nonfinite_skipped"]) for m in metrics]
        over = [int(m["pair_demand"]) > int(m["pair_capacity"])
                or int(m.get("bwd_demand", 0)) > int(m.get("bwd_capacity", 0))
                for m in metrics]
        med = float(np.median(ms[1:]))
        compact = rcfg.bwd_pairs > 0
        print(f"[{card}] train {TRAIN_STEPS} steps, {label}, batch {B} at "
              f"{TRAIN_W}x{TRAIN_H}: losses " + ", ".join(
                  f"{v:.6f}" for v in losses) + f"; skipped {skipped}; pair "
              f"demand {[int(m['pair_demand']) for m in metrics]} of "
              f"{metrics[0]['pair_capacity']}"
              + (f"; bwd demand {[int(m['bwd_demand']) for m in metrics]} of "
                 f"{metrics[0]['bwd_capacity']}" if compact else "")
              + f"; launches {n}; step ms (host clock to synchronize) "
              + ", ".join(f"{t:.3f}" for t in ms) + f"; median of steps 2-"
              f"{TRAIN_STEPS} {med:.3f} ms against {train_ms:.3f} ms per "
              f"view-by-view step (phase 8); peak device memory {peak:.2f} "
              f"GiB", flush=True)
        memory_line(card, f"the step, {label}", other,
                    estimate_train_memory(rcfg, tcfg), gate=True)
        want = dict(launches=TRAIN_STEPS,
                    bwd_launches=0 if compact else TRAIN_STEPS,
                    bwd_compact_launches=TRAIN_STEPS if compact else 0)
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
                and skipped == [0] * TRAIN_STEPS and not any(over)
                and n == want):
            raise SystemExit(f"FAIL: batched training ({label})")
        for c in counters:
            total[c] += n[c]
    parts = train_parts_ms(state, batch, rcfg, tcfg)
    print(f"[{card}] batched step parts ({label}; CUDA events, median of 3): "
          + ", ".join(f"{k.replace('4 views', f'{B} views batched')} "
                      f"{v:.3f} ms" for k, v in parts.items()), flush=True)
    return total


def levers_fit_phase(pool, batch, start, cfg, card):
    """Phase 12e: one fit() of FIT_ITERS iterations with batched_render,
    the reference ADC of phase 8b (a) and bwd_pairs 1,024, far below the
    batch's demand, with the launch counts set to 0 just before it: the
    overflow is logged and grows bwd_pairs, the losses stay finite, no
    step is skipped, one K1 and one compact K2 launch per iteration, and
    the last step's demand fits. Returns the launches {counter: n}."""
    import importlib
    import tempfile

    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs
    from gsplat_tpu_torch.train import trainer

    fit_mod = importlib.import_module("gsplat_tpu_torch.train.fit")
    B = batch["c2w"].shape[0]
    tcfg = gt.TrainConfig(iterations=FIT_ITERS, batch_size=B,
                          capacity=pool.capacity, checkpoint_interval=10**9,
                          densification_interval=4, densify_until_iter=12,
                          opacity_reset_interval=8, batched_render=True)
    rcfg = cfg.with_(bwd_pairs=1024)
    rec = {"max_pairs": [], "ms": [], "demand": [], "adc": [], "steps": 0,
           "snapshot_at": None}
    lines = []

    def log(msg):
        lines.append(msg)
        print(f"  [fit e] {msg}", flush=True)

    def batches():
        while True:
            yield batch

    counters = ("launches", "bwd_launches", "bwd_compact_launches")
    tmp = tempfile.mkdtemp(prefix="gsplat_fit_")
    try:
        ckpt = os.path.join(tmp, "start.npz")
        trainer.save_checkpoint(ckpt, gt.init_train_state(
            gt.pool_from_numpy(start, pool.alive.cpu().numpy(),
                               device=pool.pos.device), tcfg))
        points = pool.pos.detach()[pool.alive].cpu().numpy()
        real = _instrument_fit(fit_mod, rec)
        torch.cuda.synchronize()
        other = torch.cuda.memory_allocated() - tensor_bytes(batch)
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            setattr(composite_pairs, c, 0)
        try:
            state, report = fit_mod.fit(
                batches(), rcfg, tcfg, initial_points=points,
                resume_from=ckpt, log_every=2, log_fn=log,
                device=pool.pos.device)
        finally:
            _restore_fit(fit_mod, real)
        n = {c: getattr(composite_pairs, c) for c in counters}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    m = rec["last_metrics"]
    grew = [x for x in lines if "growing bwd_pairs" in x]
    losses = [v for _, v in report.losses]
    print(f"[{card}] fit (e) batched, bwd_pairs from 1024: logged losses "
          + ", ".join(f"{it}: {v:.6f}" for it, v in report.losses)
          + f"; overflow events {report.overflow_events}; growth lines "
          f"{len(grew)}; last step's bwd demand {int(m['bwd_demand'])} of "
          f"{int(m['bwd_capacity'])}; launches {n}; step ms median "
          f"{float(np.median(rec['ms'])):.3f} (" + ", ".join(
              f"{t:.1f}" for t in rec["ms"]) + f"); peak device memory "
          f"{peak:.2f} GiB; {report.num_gaussians} alive", flush=True)
    from gsplat_tpu_torch.utils.memory import estimate_train_memory

    # bwd_capacity is the batch's (B x a view's bwd_pairs, rounded).
    memory_line(card, "fit (e), batched, bwd_pairs grown", other,
                estimate_train_memory(rcfg.with_(
                    max_pairs=rec["max_pairs"][-1],
                    bwd_pairs=int(m["bwd_capacity"]) // B), tcfg))
    if not (grew and all(np.isfinite(losses)) and report.nonfinite_steps == 0
            and n == dict(launches=FIT_ITERS, bwd_launches=0,
                          bwd_compact_launches=FIT_ITERS)
            and int(m["bwd_demand"]) <= int(m["bwd_capacity"])):
        raise SystemExit("FAIL: fit (e), batched with bwd_pairs growth")
    return n


def levers_serve_phase(pool, traj, fx, fy, cx, cy, cfg, served_first,
                       serve_stats, card):
    """Phase 12f: batched serving at 1080p, 4 poses per launch, with the K1
    count set to 0 just before each run: make_batch_render_fn over phase
    5's poses (bench pose + 8-frame orbit; the last batch padded), its
    bench-pose frame against phase 5's served frame (within 1e-5), and
    ``render_trained --render_batch 4`` over the 8-frame orbit. Frame ms
    beside phase 5's. Returns the K1 launches."""
    from gsplat_tpu_torch import render_trained
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs
    from gsplat_tpu_torch.viewer import (make_batch_render_fn,
                                         render_trajectory)

    B = 4
    fn = make_batch_render_fn(pool.params, cfg, fx, fy, cx, cy,
                              alive=pool.alive, batch=B, report_demand=True)
    d_first = float((fn(traj[:B])[0][0] - served_first).abs().max())
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - tensor_bytes(pool.params,
                                                         pool.alive)
    torch.cuda.reset_peak_memory_stats()
    composite_pairs.launches = 0
    _, st = render_trajectory(fn, traj, batch_size=B, keep_frames=False,
                              pair_capacity=B * cfg.max_pairs)
    k1 = composite_pairs.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    from gsplat_tpu_torch.utils.memory import estimate_render_memory

    memory_line(card, f"batched serving, {B} poses a launch (one stacked "
                f"list)", other, estimate_render_memory(cfg.with_(
                    height=B * cfg.padded_height, max_pairs=B * cfg.max_pairs,
                    view_tile_rows=cfg.tiles_y), pool.capacity))
    argv = ["--checkpoint", CKPT, "--num_frames", "8", "--orbit_scale", "4.4",
            "--render_batch", str(B), "--max_pairs", str(cfg.max_pairs),
            "--benchmark_only"]
    composite_pairs.launches = 0
    cli = render_trained.main(argv)
    k1_cli = composite_pairs.launches
    print(f"[{card}] batched serving, {B} poses per launch over phase 5's "
          f"{len(traj)} poses: per frame mean {st['mean_ms']:.3f} ms, median "
          f"{st['median_ms']:.3f} ms (host clock to synchronize over a batch, "
          f"/ {B}) against phase 5's per-pose mean "
          f"{serve_stats['mean_ms']:.3f}, median "
          f"{serve_stats['median_ms']:.3f}, pipelined "
          f"{serve_stats['pipelined_ms']:.3f} ms; batch demands "
          f"{st['frame_pairs']} of {B * cfg.max_pairs}, overflow batches "
          f"{st['pair_overflow_frames']}; K1 launches {k1}; peak device "
          f"memory {peak:.2f} GiB; bench-pose frame vs phase 5's: max abs "
          f"{d_first:.3e}", flush=True)
    print(f"[{card}] python -m gsplat_tpu_torch.render_trained "
          + " ".join(argv) + f": per frame mean {cli['mean_ms']:.3f} ms, "
          f"median {cli['median_ms']:.3f} ms, overflow batches "
          f"{cli['pair_overflow_frames']}; K1 launches {k1_cli}", flush=True)
    n_batches = -(-len(traj) // B)
    if not (d_first <= 1e-5 and k1 == n_batches + 1
            and st["pair_overflow_frames"] == 0 and k1_cli == 8 // B + 1
            and cli["pair_overflow_frames"] == 0 and cli["frames"] == 8):
        raise SystemExit("FAIL: batched serving")
    return k1 + k1_cli


def _counts():
    """K1 and K2 launch counts ("cumprod" forms), read together."""
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs

    return composite_pairs.launches, composite_pairs.bwd_launches


def _since(before):
    k1, k2 = _counts()
    return k1 - before[0], k2 - before[1]


def _timed_render(pool, pose, fx, fy, cx, cy, cfg):
    """One render (no autograd) timed on the host clock to synchronize,
    with its peak device memory: (img, aux, ms, GiB)."""
    import gsplat_tpu_torch as gt

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        img, aux = gt.render_from_params(pool.params, pose, fx, fy, cx, cy,
                                         cfg, alive=pool.alive)
    torch.cuda.synchronize()
    return (img, aux, (time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated() / 2**30)


def alpha_error(alpha_x, alpha_k, cfg):
    """The xla alpha plane against K1's: (max abs difference where K1's
    final T is above transmittance_min, the least xla alpha elsewhere).
    K1 stops compositing a tile once every pixel's T is at or below
    transmittance_min (the TPU kernel's early exit), so its final T there
    is the T at that point; the xla compositor multiplies T through all
    max_per_tile pairs (its w are zero past that point either way). Where
    K1's T stayed above the threshold no tile stopped early, so both
    multiplied the same factors."""
    live = alpha_k < 1.0 - cfg.transmittance_min
    d = float((alpha_x - alpha_k)[live].abs().max()) if bool(live.any()) \
        else 0.0
    sat = float(alpha_x[~live].min()) if bool((~live).any()) else 1.0
    return d, sat


def xla_phase(pool, c2w, fx, fy, cx, cy, cfg, served_first, close, card):
    """Phase 13a: the XLA compositor (backend="xla", plain PyTorch on the
    card) against K1 at 1080p: (1) with max_per_tile at the bench pose's
    largest tile, image, depth and alpha against K1's frame (and K1's
    frame against phase 5's served frame); (2) K1 with tile_rank_cap
    LEVER_CAP against "xla" with max_per_tile LEVER_CAP at the bench pose
    and at phase 11d's close-in pose of highest demand; (3) a fwd+bwd
    through "xla" against one through K1 and K2 at 960x540 (the loss of
    tests/test_pallas_kernel.py:202-210), each gradient leaf within 5e-4
    of its max. Frame ms and peak memory of both compositors are printed
    (a record, not a gate). Returns (K1, K2) launches."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.render import pair_demand

    before = _counts()
    img_k, aux_k, k_ms, k_peak = _timed_render(pool, c2w, fx, fy, cx, cy,
                                               cfg)
    K = int(aux_k.max_tile_count)
    cfg_x = cfg.with_(backend="xla", max_per_tile=K)
    _timed_render(pool, c2w, fx, fy, cx, cy, cfg_x)  # warm-up
    img_x, aux_x, x_ms, x_peak = _timed_render(pool, c2w, fx, fy, cx, cy,
                                               cfg_x)
    d_img = float((img_x - img_k).abs().max())
    d_alpha_all = float((aux_x.alpha - aux_k.alpha).abs().max())
    d_alpha, sat_alpha = alpha_error(aux_x.alpha, aux_k.alpha, cfg)
    d_depth = float((aux_x.depth - aux_k.depth).abs().max())
    depth_max = float(aux_k.depth.abs().max())
    d_served = float((img_k - served_first).abs().max())
    print(f"[{card}] xla vs K1 at the 1080p bench pose, max_per_tile {K} "
          f"(the largest tile): image max abs {d_img:.3e}, alpha "
          f"{d_alpha:.3e} where K1's T stayed above transmittance_min "
          f"({d_alpha_all:.3e} over all pixels; the least xla alpha where "
          f"K1 stopped early {sat_alpha:.7f}), depth {d_depth:.3e} "
          f"(largest depth "
          f"{depth_max:.3f}); K1's frame vs phase 5's served frame "
          f"{d_served:.3e}; per_tile_capacity {aux_x.per_tile_capacity}, "
          f"bwd_demand {aux_x.bwd_demand}", flush=True)
    print(f"[{card}] frame (host clock to synchronize, one call after a "
          f"warm-up): xla {x_ms:.3f} ms, peak {x_peak:.2f} GiB; K1 "
          f"{k_ms:.3f} ms, peak {k_peak:.2f} GiB", flush=True)
    if not (d_img <= TOL and d_alpha <= TOL and d_served == 0.0
            and sat_alpha >= 1.0 - cfg.transmittance_min - TOL
            and d_depth <= TOL * max(1.0, depth_max)
            and aux_x.bwd_demand is None and aux_x.per_tile_capacity == K):
        raise SystemExit("FAIL: the xla compositor disagrees with K1")

    # (2) K1's rank cap against the xla per-tile cap.
    cfg_t = cfg.with_(tile_rank_cap=LEVER_CAP, cull_chunks=LEVER_CHUNKS)
    for name, pose, exact in (("bench pose", c2w, None),
                              ("close-in pose", close["c2w"],
                               close["exact_demand"])):
        with torch.no_grad():
            pd, _, td = (int(x) for x in pair_demand(
                pool.params, pose, fx, fy, cx, cy, cfg_t, alive=pool.alive))
        k_cfg = cfg_t.with_(max_pairs=max(cfg.max_pairs, rup(pd)),
                            trunc_pairs=rup(td))
        x_cfg = cfg.with_(backend="xla", max_per_tile=LEVER_CAP)
        if exact is not None:
            x_cfg = x_cfg.with_(max_pairs=rup(exact))
        img_t, aux_t, t_ms, _ = _timed_render(pool, pose, fx, fy, cx, cy,
                                              k_cfg)
        img_c, aux_c, c_ms, c_peak = _timed_render(pool, pose, fx, fy, cx,
                                                   cy, x_cfg)
        d = float((img_t - img_c).abs().max())
        over = int(aux_c.num_pairs) > x_cfg.max_pairs \
            or int(aux_t.trunc_demand) > aux_t.trunc_capacity
        print(f"[{card}] K1 tile_rank_cap {LEVER_CAP} vs xla max_per_tile "
              f"{LEVER_CAP} at the {name}: image max abs {d:.3e}; pairs "
              f"kept {int(aux_t.num_pairs_kept)} of {int(aux_c.num_pairs)} "
              f"(largest tile {int(aux_c.max_tile_count)}); K1 {t_ms:.3f} "
              f"ms, xla {c_ms:.3f} ms (first call, max_pairs "
              f"{x_cfg.max_pairs}), peak {c_peak:.2f} GiB; overflow {over}",
              flush=True)
        if not (d <= TOL and not over):
            raise SystemExit(f"FAIL: truncated K1 vs the xla cap, {name}")
        del img_t, img_c, aux_t, aux_c

    # (3) Gradients through xla against K1/K2 at 960x540.
    tf = 0.85 * TRAIN_W
    tcfg = gt.RenderConfig(height=TRAIN_H, width=TRAIN_W,
                           max_pairs=TRAIN_PAIRS)
    gen = torch.Generator(device=pool.pos.device).manual_seed(2)
    tgt = torch.rand(TRAIN_H, TRAIN_W, 3, generator=gen,
                     device=pool.pos.device)
    grads, ms, kg = {}, {}, 0
    for name in ("pallas", "xla"):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in pool.params.items()}
        # xla composites as many pairs per tile as K1's largest tile holds.
        cfg_g = tcfg if name == "pallas" else tcfg.with_(
            backend="xla", max_per_tile=kg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img, aux = gt.render_from_params(p, c2w, tf, tf, TRAIN_W / 2.0,
                                         TRAIN_H / 2.0, cfg_g,
                                         alive=pool.alive)
        (torch.mean(torch.abs(img - tgt)) + torch.mean(img * img)).backward()
        torch.cuda.synchronize()
        ms[name] = ((time.perf_counter() - t0) * 1e3,
                    torch.cuda.max_memory_allocated() / 2**30)
        grads[name] = {k: v.grad for k, v in p.items()}
        kg = kg or int(aux.max_tile_count)
    rel = {}
    for k in PARAM_KEYS:
        scale = float(grads["xla"][k].abs().max()) + 1e-12
        rel[k] = float((grads["pallas"][k] - grads["xla"][k]).abs().max()) \
            / scale
    print(f"[{card}] fwd+bwd at {TRAIN_W}x{TRAIN_H}, xla (max_per_tile "
          f"{kg}) vs K1/K2: gradient max abs / leaf max "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (bound 5e-4); host clock to synchronize, first call: xla "
          f"{ms['xla'][0]:.1f} ms, peak {ms['xla'][1]:.2f} GiB; K1/K2 "
          f"{ms['pallas'][0]:.1f} ms, peak {ms['pallas'][1]:.2f} GiB",
          flush=True)
    if not all(v <= 5e-4 for v in rel.values()):
        raise SystemExit("FAIL: xla gradients disagree with K1/K2")
    return _since(before)


def eval_phase(pool, trained, batch, cfg, start, card):
    """Phase 13b: evaluate_views on phase 8's training views (960x540, the
    unperturbed checkpoint rendered through K1 as ground truth): the
    perturbed pool before and after phase 8's steps (PSNR must rise), the
    checkpoint against its own renders (above 100 dB), render_batch=4
    against per-view (PSNR 1e-3 dB, L1 1e-6), auto_size from max_pairs
    2**18 (the capacity grows to the demand and reproduces the sized
    metrics). Returns the K1 launches."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.evaluation import evaluate_views

    alive = pool.alive
    views = [{"image": batch["image"][i], "c2w": batch["c2w"][i],
              **{k: float(batch[k][i]) for k in ("fx", "fy", "cx", "cy")}}
             for i in range(batch["c2w"].shape[0])]
    before_pool = gt.pool_from_numpy(start, alive.cpu().numpy(),
                                     device=alive.device)
    k1 = _counts()[0]
    r_before = evaluate_views(before_pool.params, views, cfg, alive=alive)
    r_after = evaluate_views(trained, views, cfg, alive=alive)
    r_self = evaluate_views(pool.params, views, cfg, alive=alive)
    r_b4 = evaluate_views(trained, views, cfg, alive=alive, render_batch=4)
    r_auto = evaluate_views(trained, views, cfg.with_(max_pairs=2**18),
                            alive=alive)
    k1 = _counts()[0] - k1

    def fig(r):
        return "; ".join(f"{v['psnr']:.3f} dB / {v['ssim']:.5f} / "
                         f"{v['l1']:.6f}" for v in r["per_view"])

    for name, r in (("perturbed, before the steps", r_before),
                    ("after the 6 steps", r_after),
                    ("after, render_batch=4", r_b4),
                    ("after, auto_size from max_pairs 2**18", r_auto),
                    ("the checkpoint itself", r_self)):
        print(f"[{card}] evaluate_views, {name}: mean PSNR "
              f"{r['psnr']:.4f} dB, SSIM {r['ssim']:.6f}, L1 {r['l1']:.7f}; "
              f"per view (PSNR / SSIM / L1) {fig(r)}; demand "
              f"{r['max_pair_demand']}, max_pairs {r['eval_max_pairs']}",
              flush=True)
    d_psnr = max(abs(a["psnr"] - b["psnr"])
                 for a, b in zip(r_after["per_view"], r_b4["per_view"]))
    d_l1 = max(abs(a["l1"] - b["l1"])
               for a, b in zip(r_after["per_view"], r_b4["per_view"]))
    d_auto = max(abs(a["psnr"] - b["psnr"])
                 for a, b in zip(r_after["per_view"], r_auto["per_view"]))
    print(f"[{card}] evaluation: PSNR gain {r_after['psnr'] - r_before['psnr']:+.4f} "
          f"dB over the steps; batched vs per view: PSNR {d_psnr:.2e} dB, "
          f"L1 {d_l1:.2e}; auto-sized vs sized PSNR {d_auto:.2e} dB; K1 "
          f"launches {k1}", flush=True)
    if not (r_after["psnr"] > r_before["psnr"]
            and min(v["psnr"] for v in r_self["per_view"]) > 100.0
            and d_psnr <= 1e-3 and d_l1 <= 1e-6 and d_auto <= 1e-3
            and r_auto["eval_max_pairs"] >= r_auto["max_pair_demand"]
            > 2**18):
        raise SystemExit("FAIL: evaluation")
    return k1


def kernel_events(summary, name):
    """Kernel launches in a trace summary whose name holds ``name``."""
    return sum(c for k, (c, _) in summary["by_kernel"].items() if name in k)


def trace_phase(pool, c2w, fx, fy, cx, cy, cfg, card):
    """Phase 13c: one served frame and one fwd+bwd at 1080p at the bench
    pose, each inside utils.profiling.trace; each Chrome trace read back
    (utils.profiling.summarize_trace): the device-busy share of the traced
    window, the kernel launches, the ten kernels with the most time, the
    longest idle gaps. The trace must hold as many K1 and K2 events as
    their counts say. Then one served frame traced under the program's
    spans (profile_trace.trace_stages, after a frame with no root that
    absorbs the records a trace can lose at its start): each leaf span's
    host time, launches and device time, every launch's device record in
    the trace; the leaves alone are summed, as a span's numbers include
    the spans it holds.
    Returns (K1, K2) launches."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.profile_trace import (STAGES, print_stages,
                                                print_summary, trace_stages)
    from gsplat_tpu_torch.utils.profiling import summarize_trace, trace
    from gsplat_tpu_torch.viewer import make_render_fn

    log_dir = os.path.join(ROOT, "traces", "chip_smoke")
    render_fn = make_render_fn(pool.params, cfg, fx, fy, cx, cy,
                               alive=pool.alive)

    def fwd_bwd():
        p = {k: v.detach().requires_grad_(True)
             for k, v in pool.params.items()}
        img, _ = gt.render_from_params(p, c2w, fx, fy, cx, cy, cfg,
                                       alive=pool.alive)
        (torch.mean(img) + torch.mean(img * img)).backward()

    before = _counts()
    frame_kernels = 0
    for name, fn in (("served frame", lambda: render_fn(c2w)),
                     ("fwd+bwd", fwd_bwd)):
        fn()  # warm-up, outside the trace
        torch.cuda.synchronize()
        n0 = _counts()
        with trace(log_dir) as prof:
            fn()
            torch.cuda.synchronize()
        n1, n2 = _since(n0)
        s = summarize_trace(prof.chrome_trace_path)
        e1 = kernel_events(s, "raster_fwd_kernel")
        e2 = kernel_events(s, "raster_bwd_kernel")
        print(f"[{card}] trace of one {name} at 1080p "
              f"({os.path.relpath(prof.chrome_trace_path, ROOT)}): K1 events "
              f"{e1} (count {n1}), K2 events {e2} (count {n2})", flush=True)
        print_summary(s, 1, f"[{card}] {name}")
        frame_kernels = frame_kernels or s["kernels"]
        if not (s["kernels"] > 0 and e1 == n1 and e2 == n2 and n1 == 1):
            raise SystemExit(f"FAIL: the trace of the {name} lacks the "
                             f"counted kernel events")
    st = trace_stages(pool.params, c2w, fx, fy, cx, cy, cfg, pool.alive,
                      log_dir)
    print_stages(st, f"[{card}] 1080p bench pose")
    ranges = [st["ranges"][k] for k in STAGES]
    launched = sum(r["launches"] for r in ranges)
    held = sum(r["kernels"] for r in ranges)
    print(f"[{card}] stage trace: {launched} launches in the leaf spans "
          f"of the traced frame, {held} of their device records in the "
          f"trace (the served frame's trace: {frame_kernels} kernel "
          f"launches)", flush=True)
    if not (held == launched > 0
            and kernel_events(st, "raster_fwd_kernel") == 2):
        raise SystemExit("FAIL: the stage trace lost device records")
    return _since(before)


BINNING_SOURCE = "gsplat_tpu_torch/ops/csrc/binning.cu"
BINNING_SEED = 2718281830  # the garden scene's draw in phase 2b


def binning_phase(dev, card):
    """Phase 2b: the binning kernels (emission, tile sort, aligned scatter)
    against the plain steps they replace, on every case of
    ``profile_binning.kernel_cases`` (the checkpoint's orbit, the 3 M
    garden scene near the origin camera and at a third of its capacity,
    three stacked views, the ellipse cull, the rank truncation): every
    TileBinning field bit for bit, each launch counter risen. Then, at the
    first garden pose, each kernel's device time beside its plain
    version's (``profile_binning.step_times``) and its bound by bytes: the
    emission writes 8 B a slot and reads 32 B a gaussian; a stable sort
    reads and writes each 8 B pair once; the alignment reads the 4 B tile
    of every slot, the 4 B slot of every kept pair and two [T+1] int64
    starts, and writes 4 B a kept pair. Returns ({step: {ms, plain_ms,
    bound_ms}}, the largest integer difference over every case's
    fields)."""
    from gsplat_tpu_torch import profile_binning as PB
    from gsplat_tpu_torch.ops import binning as B

    err, frame = 0, None
    with torch.no_grad():
        for case in PB.CHECK_CASES:
            for label, proj, cfg, emits in PB.kernel_cases(
                    case, dev, seed=BINNING_SEED, checkpoint=CKPT):
                r = PB.compare_kernels(proj, cfg)
                torch.cuda.synchronize()
                err = max(err, r["max_abs_err"])
                print(f"[{card}] binning {label}: demand {r['num_pairs']}, "
                      f"capacity {cfg.max_pairs}, kernels vs plain "
                      + ("bit for bit" if not r["bad"] else
                         f"DIFFER in {r['bad']} (max abs "
                         f"{r['max_abs_err']})")
                      + f", launches +{r['launches']}", flush=True)
                if r["bad"] or r["launches"] != [emits, 1, 1]:
                    raise SystemExit(f"FAIL: binning kernels on {label}")
                if case == "garden3m-drift" and frame is None:
                    frame = (proj, cfg)
                del proj

        # --- the steps' times at the first garden pose ---
        proj, cfg = frame
        kern = PB.step_times(proj, cfg, 10)
        plain = PB.step_times(proj, cfg, 2, plain=True)
        _, _, _, _, counts = B._footprints(proj)
        m, n = cfg.max_pairs, counts.shape[0]
        d = int(B._capacity_drop(counts, cfg)[1][-1])
        T = cfg.num_tiles
        nbytes = {"emit": 8 * m + 32 * n, "sort": 16 * m,
                  "align": 4 * m + 8 * d + 16 * (T + 1)}
    out = {}
    for step, b in nbytes.items():
        out[step] = r = {"ms": kern[step], "plain_ms": plain[step],
                         "bound_ms": b / PEAK_BYTES * 1e3}
        print(f"[{card}] binning {step} at the 3 M frame ({m} slots, {d} "
              f"pairs): {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms by bytes "
              f"({100 * r['bound_ms'] / r['ms']:.1f} %)", flush=True)
    return out, err


def feat_phase(dev, card):
    """Phase 2c: Feature 3DGS's compositors on the 3 M garden scene
    (``scene.make_scene``, ``profile_binning.GARDEN_GAUSSIANS``) with
    ``f_sem`` ~ N(0, 1) of FEAT_C channels, at FEAT_W x FEAT_H from the
    garden's first pose: F1 (``raster_feat.composite_features``) equal to
    its plain version bit for bit; F2 (``composite_features_bwd``, on a
    seeded cotangent of the map and of K1's tiles) within FEAT_BWD_TOL of
    its plain version in d f_sem and in each of the six geometry rows it
    adds to K2's output, K2's other rows untouched; each kernel's device
    time (20 launches) beside its plain version's and its bound: F1 two
    operations a channel per (pair, pixel) of non-zero weight against the
    contributing pairs' feature floats read and the map written, F2 four
    against those floats read and their gradient written and the map and
    its cotangent read (``raster_feat.weight_counts``; the alpha and
    transmittance are K1's work). Then the main path's own training:
    ``init_train_state`` over the pool with features and a drawn decoder,
    ``make_train_step``, FEAT_STEPS steps of FEAT_VIEWS views one at a time
    against teacher maps decoded from the unperturbed scene, with F1's and
    F2's counters set to 0 first: one launch of each a view, finite losses,
    no step skipped. Returns {"F1": entry, "F2": entry} with ms, plain_ms,
    bound_ms, bound_by, max_abs_err (relative for F2) and launches."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch import profile_binning as PB
    from gsplat_tpu_torch.models.gaussians import init_decoder
    from gsplat_tpu_torch.ops import raster_feat as rf
    from gsplat_tpu_torch.ops.losses import decode_features
    from gsplat_tpu_torch.ops.raster_cuda import (_composite_fwd,
                                                  composite_pairs,
                                                  composite_pairs_bwd)
    from gsplat_tpu_torch.render import pair_demand
    from gsplat_tpu_torch.scene import make_scene

    t_phase = time.perf_counter()
    params = make_scene(PB.GARDEN_GAUSSIANS, FEAT_SEED, dev)
    n = params["pos"].shape[0]
    g = torch.Generator(device=dev).manual_seed(FEAT_SEED)
    params["f_sem"] = torch.randn(n, FEAT_C, generator=g, device=dev)
    f, cx, cy = 0.85 * FEAT_W, FEAT_W / 2.0, FEAT_H / 2.0
    poses = [PB._origin_pose(*p) for p in PB.GARDEN_POSES[:FEAT_VIEWS]]
    cfg = gt.RenderConfig(height=FEAT_H, width=FEAT_W, max_pairs=4096)
    demand = max(int(pair_demand(params, c, f, f, cx, cy, cfg)[0])
                 for c in poses)
    cfg = cfg.with_(max_pairs=PB._sized(demand))
    res = rf.feat_resources(dev, cfg.pair_block)
    print(f"[{card}] feature compositors at pair_block {cfg.pair_block}: "
          + "; ".join(f"{k} {v['registers']} registers, {v['local_bytes']} "
                      f"B local, {v['ctas_per_sm']} CTAs of 256 threads per "
                      f"SM" for k, v in res.items()), flush=True)
    if res["F1"]["local_bytes"] or res["F2"]["local_bytes"]:
        raise SystemExit("FAIL: a feature compositor spills")

    # --- F1 and F2 against their plain versions at the first pose ---
    with torch.no_grad():
        sp = serving_path(params, poses[0], f, f, cx, cy, cfg)
        pf, bn = sp["pair_feat"], sp["bin"]
        del sp
        ts, tc = bn.tile_start, bn.tile_count
        out, state = _composite_fwd(pf, ts, tc, cfg, with_state=True)
        args = (pf, bn.pair_slot, bn.depth_order, params["f_sem"], ts, out)
        n0 = rf.composite_features.launches
        fmap = rf.composite_features(*args, cfg)
        f1_n = rf.composite_features.launches - n0
        fplain = rf.composite_features_plain(*args, cfg)
        torch.cuda.synchronize()
        f1_err = float((fmap - fplain).abs().max())
        print(f"[{card}] F1 at {FEAT_W}x{FEAT_H}, {n} gaussians, "
              f"{int(bn.num_pairs)} pairs of {cfg.max_pairs}, C {FEAT_C}: "
              f"launches +{f1_n}; vs plain "
              + ("bit for bit" if torch.equal(fmap, fplain) else
                 f"DIFFERS (max abs {f1_err:.3e})")
              + f"; map max {float(fmap.abs().max()):.4f}", flush=True)
        if f1_n != 1 or not torch.equal(fmap, fplain) \
                or not float(fmap.abs().max()) > 0.0:
            raise SystemExit("FAIL: F1 against its plain version")
        del fplain
        gF = torch.randn(fmap.shape, generator=g, device=dev) * 1e-6
        gout = torch.randn(out.shape, generator=g, device=dev) * 1e-6
        d0 = composite_pairs_bwd(pf, ts, tc, out, state, gout, cfg)
        dk, dp = d0.clone(), d0.clone()
        n0 = rf.composite_features.bwd_launches
        gk = rf.composite_features_bwd(*args, fmap, gF, dk, cfg)
        f2_n = rf.composite_features.bwd_launches - n0
        gp = rf.composite_features_bwd_plain(*args, fmap, gF, dp, cfg)
        torch.cuda.synchronize()
        errs = {"d f_sem": float((gk - gp).abs().max())
                / float(gp.abs().max())}
        for r, name in enumerate(("u", "v", "a", "b", "c", "opacity")):
            add_k, add_p = dk[r] - d0[r], dp[r] - d0[r]
            top = float(add_p.abs().max())
            errs[name] = (float((add_k - add_p).abs().max()) / top
                          if top > 0 else float("inf"))
        rest = torch.equal(dk[6:], d0[6:])
        f2_err = max(errs.values())
        print(f"[{card}] F2 vs plain, max abs difference over each "
              f"output's largest: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tolerance {FEAT_BWD_TOL}); launches +{f2_n}; K2's rows "
              f"6-9 untouched: {rest}", flush=True)
        if f2_n != 1 or f2_err > FEAT_BWD_TOL or not rest:
            raise SystemExit("FAIL: F2 against its plain version")
        del gp, dp

        # --- times and bounds ---
        pair_pixels, contrib = rf.weight_counts(pf, ts, out, cfg)
        pixels = FEAT_H * FEAT_W
        work = {"F1": (2 * FEAT_C * pair_pixels,
                       4 * FEAT_C * (contrib + pixels)),
                "F2": (4 * FEAT_C * pair_pixels,
                       4 * FEAT_C * (2 * contrib + 2 * pixels))}
        scratch = d0.clone()
        kern = {"F1": lambda: rf.composite_features(*args, cfg),
                "F2": lambda: rf.composite_features_bwd(*args, fmap, gF,
                                                        scratch, cfg)}
        plain = {"F1": lambda: rf.composite_features_plain(*args, cfg),
                 "F2": lambda: rf.composite_features_bwd_plain(
                     *args, fmap, gF, scratch, cfg)}
        entries = {}
        for k in ("F1", "F2"):
            for _ in range(3):
                kern[k]()
            ms = device_ms(kern[k], 20)
            plain_ms = device_ms(plain[k], 1)
            ops, nbytes = work[k]
            by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
            entries[k] = {
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(by_ops, by_bytes) * 1e3,
                "bound_by": "operations" if by_ops >= by_bytes else "bytes",
                "max_abs_err": f1_err if k == "F1" else f2_err}
            e = entries[k]
            print(f"[{card}] {k} at the garden's first pose: {ms:.4f} ms "
                  f"(CUDA events, 20 launches), plain {plain_ms:.3f} ms; "
                  f"bound {e['bound_ms']:.4f} ms by {e['bound_by']} "
                  f"({pair_pixels} (pair, pixel) of non-zero weight, "
                  f"{contrib} contributing pairs; share of bound "
                  f"{100 * e['bound_ms'] / ms:.1f} %)", flush=True)
        del args, pf, bn, out, state, fmap, gF, gout, d0, dk, gk, scratch

    # --- the main path's feature training steps ---
    dec = init_decoder(FEAT_C, FEAT_D, FEAT_SEED, dev)
    th, tw = FEAT_H // 2, FEAT_W // 2
    with torch.no_grad():  # ground truth: the unperturbed scene
        frames = [gt.render_from_params(params, c, f, f, cx, cy, cfg)
                  for c in poses]
        images = torch.stack([im for im, _ in frames])
        teacher = torch.stack([decode_features(aux.features, (th, tw), dec)
                               for _, aux in frames])
        del frames
    batches = [{"image": images[i:i + 1], "teacher": teacher[i:i + 1],
                "c2w": torch.from_numpy(poses[i][None]).to(dev),
                **{k: torch.full((1,), v, device=dev)
                   for k, v in (("fx", f), ("fy", f), ("cx", cx),
                                ("cy", cy))}}
               for i in range(FEAT_VIEWS)]
    with torch.no_grad():
        for k in ("f_sem", "opacity_raw"):
            params[k] += 0.1 * torch.randn(params[k].shape, generator=g,
                                           device=dev)
    pool = gt.GaussianPool(params, torch.ones(n, dtype=torch.bool,
                                              device=dev))
    tcfg = gt.TrainConfig(capacity=n, batch_size=1,
                          densification_interval=10**9,
                          opacity_reset_interval=10**9)
    state = gt.init_train_state(pool, tcfg, gt.FeatureConfig(), dec)
    step = gt.make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    rf.composite_features.launches = 0
    rf.composite_features.bwd_launches = 0
    composite_pairs.launches = composite_pairs.bwd_launches = 0
    losses, skipped = [], []
    for _ in range(FEAT_STEPS):
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["total"]))
            skipped.append(int(m["nonfinite_skipped"]))
    torch.cuda.synchronize()
    f1_n, f2_n = (rf.composite_features.launches,
                  rf.composite_features.bwd_launches)
    k1_n, k2_n = composite_pairs.launches, composite_pairs.bwd_launches
    views = FEAT_STEPS * FEAT_VIEWS
    print(f"[{card}] Feature 3DGS training through make_train_step: "
          f"{views} views ({FEAT_STEPS} steps of {FEAT_VIEWS} views one at "
          f"a time), losses " + ", ".join(f"{v:.6f}" for v in losses)
          + f", skipped {skipped}; launches F1 {f1_n}, F2 {f2_n}, K1 "
          f"{k1_n}, K2 {k2_n}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if not (f1_n == f2_n == k1_n == k2_n == views
            and all(np.isfinite(losses)) and not any(skipped)):
        raise SystemExit("FAIL: Feature 3DGS training steps")
    entries["F1"]["launches"], entries["F2"]["launches"] = f1_n, f2_n
    del state, pool, params, images, teacher, batches, step
    torch.cuda.empty_cache()
    return entries


class BinCalls:
    """Counts ``bin_gaussians`` calls on the serving and training paths
    (``ops.rasterize`` and ``render.pair_demand`` look it up by name) and
    the binning kernels' launches while inside: ``check()`` fails unless
    each kernel launched once a call (the emission once a rect call)."""

    def __enter__(self):
        import importlib

        from gsplat_tpu_torch.ops import binning

        # The modules, by name: the package's ``render`` is a function.
        self.mods = [importlib.import_module(f"gsplat_tpu_torch.{m}")
                     for m in ("render", "ops.rasterize")]
        self.real = binning.bin_gaussians
        self.calls = self.rect = 0

        def counted(proj, cfg):
            self.calls += 1
            self.rect += cfg.cull_mode == "rect"
            return self.real(proj, cfg)

        for mod in self.mods:
            mod.bin_gaussians = counted
        binning.emit_pairs.launches = 0
        binning.sort_pairs.launches = 0
        binning.align_pairs.launches = 0
        return self

    def __exit__(self, *exc):
        from gsplat_tpu_torch.ops import binning

        for mod in self.mods:
            mod.bin_gaussians = self.real
        self.launches = [binning.emit_pairs.launches,
                         binning.sort_pairs.launches,
                         binning.align_pairs.launches]
        return False

    def check(self, card, what):
        print(f"[{card}] {what}: bin_gaussians calls {self.calls} ({self.rect}"
              f" rect); binning_emit, binning_sort, binning_align launches "
              f"{self.launches}", flush=True)
        if self.calls == 0 or self.launches != [self.rect, self.calls,
                                                self.calls]:
            raise SystemExit(f"FAIL: the binning kernels on {what}")
        return self.launches


def tools_phase(pool, c2w, fx, fy, cx, cy, cfg, lever, card):
    """Phase 13d-f: the measuring CLIs at the bench pose through their
    mains, as a user runs them: profile_stages exact and with the lever
    (tile_rank_cap LEVER_CAP, --auto_pairs), profile_binning, cull_sweep
    (its 64-chunk bench-pose demand and kept pairs equal to phase 11b's),
    and the truncation ladder at 4 close-in poses with K in {1024, 4096},
    its banded exact reference held against a full-frame exact render
    sized to each pose's demand. Returns (K1, K2) launches."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch import (cull_sweep, profile_binning,
                                  profile_stages, trunc_error_ladder)

    before = _counts()
    runs = {}
    for name, extra in (("exact", []), ("lever", [
            "--tile_rank_cap", str(LEVER_CAP), "--auto_pairs"])):
        argv = ["--checkpoint", CKPT] + extra
        print(f"[{card}] python -m gsplat_tpu_torch.profile_stages "
              + " ".join(argv), flush=True)
        runs[name] = profile_stages.main(argv)
    print(f"[{card}] python -m gsplat_tpu_torch.profile_binning", flush=True)
    binning_ms = profile_binning.main(["--checkpoint", CKPT])
    print(f"[{card}] python -m gsplat_tpu_torch.cull_sweep", flush=True)
    sweep = cull_sweep.main(["--checkpoint", CKPT])
    at64 = sweep["bench(4.4x)"]
    print(f"[{card}] cull_sweep at {LEVER_CHUNKS} chunks, bench pose: "
          f"demand {at64['chunks'][LEVER_CHUNKS]['demand']} (phase 11b "
          f"{lever['demand']}), kept {at64['kept']} (phase 11b "
          f"{lever['kept']})", flush=True)
    if not (at64["chunks"][LEVER_CHUNKS]["demand"] == lever["demand"]
            and at64["kept"] == lever["kept"]):
        raise SystemExit("FAIL: cull_sweep disagrees with phase 11b")
    argv = ["--checkpoint", CKPT, "--caps", "1024", "4096"]
    print(f"[{card}] python -m gsplat_tpu_torch.trunc_error_ladder "
          + " ".join(argv), flush=True)
    lad = trunc_error_ladder.main(argv)
    for i, (pose, band) in enumerate(zip(lad["poses"], lad["exact"])):
        cfg_x = cfg.with_(max_pairs=rup(lad["exact_demand"][i]))
        with torch.no_grad():
            full, aux = gt.render_from_params(pool.params, pose, fx, fy, cx,
                                              cy, cfg_x, alive=pool.alive)
        diff = band - full
        mse = float(torch.mean(diff * diff))
        psnr = float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)
        rows = (diff.abs().amax(dim=(1, 2)) > 0).nonzero().flatten()
        print(f"[{card}] ladder pose {i}: banded exact ({lad['bands']} "
              f"bands) vs the full-frame exact render (demand "
              f"{int(aux.num_pairs)}, max_pairs {cfg_x.max_pairs}): max abs "
              f"{float(diff.abs().max()):.3e}, PSNR {psnr:.2f} dB, "
              f"{rows.numel()} rows differ"
              + (f" ({int(rows.min())}-{int(rows.max())})" if rows.numel()
                 else ""), flush=True)
        if int(aux.num_pairs) > cfg_x.max_pairs:
            raise SystemExit("FAIL: the full-frame exact render overflowed")
        del full, aux, diff
    k = _since(before)
    print(f"[{card}] measuring CLIs: K1 launches {k[0]}, K2 launches {k[1]}",
          flush=True)
    return k, runs, binning_ms, sweep, lad


def plain_chunks(cfg):
    """(tiles, blocks) per chunk of the plain K1 and K2 at cfg: phases
    3-4's 1,024 tiles and 256 blocks at tile 16 and pair_block 128, scaled
    so that a chunk's [m, G, tile^2] temporaries keep their size."""
    work = cfg.pair_block * cfg.tile * cfg.tile
    return (max(1024 * 128 * 256 // work, 16),
            max(256 * 128 * 256 // work, 8))


def range_kernels(name, pf, binning, cfg, seed, card, timed=True,
                  instr=None):
    """K1 and K2 at cfg's (tile, pair_block, transmittance) on one pair
    list, as phases 3-4 hold them (compare, check_cull, check_bwd). With
    ``timed``, the CUDA-event times of both kernels and their plain
    versions and their bounds (in the "log" form counted with ``instr``,
    phase 11's SASS counts). Returns a dict (errors, times, bounds, K2's
    inputs and gradient)."""
    from gsplat_tpu_torch.ops.raster_cuda import (composite_pairs,
                                                  composite_pairs_bwd,
                                                  composite_pairs_bwd_plain,
                                                  composite_pairs_plain)

    ts, tc = binning.tile_start, binning.tile_count
    tchunk, bchunk = plain_chunks(cfg)
    out_k = composite_pairs(pf, ts, tc, cfg)
    out_p, state_p = composite_pairs_plain(pf, ts, tc, cfg, tile_chunk=tchunk,
                                           with_state=True)
    torch.cuda.synchronize()
    r = {"err": compare(name, out_k, out_p, tc),
         "cull": check_cull(name, pf, ts, tc, out_p, cfg)}
    r["bwd_err"] = check_bwd(name, pf, binning, out_k, state_p, cfg, seed,
                             block_chunk=bchunk, keep=r)
    del state_p
    bargs, cull = r["bargs"], r["cull"]
    nblk = int(torch.where(tc > 0, out_k[:, 5, 0], 0.0).sum())
    if not timed:
        return r
    from gsplat_tpu_torch.profile_kernel import log_ops_per_pair_pixel

    log = cfg.transmittance_math == "log"
    ops1 = log_ops_per_pair_pixel(26, instr) if log else None
    ops2 = log_ops_per_pair_pixel(OPS_BWD_PER_PAIR_PIXEL, instr) if log \
        else OPS_BWD_PER_PAIR_PIXEL
    r["ms"] = device_ms(lambda: composite_pairs(pf, ts, tc, cfg), 20)
    r["plain_ms"] = device_ms(lambda: composite_pairs_plain(
        pf, ts, tc, cfg, tile_chunk=tchunk), 2)
    r["bound"], r["by"] = bound_ms("full", nblk, cfg,
                                   cull["total"] - cull["skipped"], ops1)
    r["bwd_ms"] = device_ms(lambda: composite_pairs_bwd(*bargs), 20)
    r["bwd_ctas"] = composite_pairs.bwd_ctas
    r["bwd_plain_ms"] = device_ms(lambda: composite_pairs_bwd_plain(
        *bargs, block_chunk=bchunk), 2)
    r["bwd_bound"], r["bwd_by"], *_ = bwd_bound(bargs, cfg, ops2)
    print(f"[{card}] {name}: raster_fwd {r['ms']:.4f} ms (CUDA events, 20 "
          f"launches), plain {r['plain_ms']:.3f} ms, bound "
          f"{r['bound']:.4f} ms by {r['by']} (share "
          f"{r['bound'] / r['ms']:.3f}); raster_bwd {r['bwd_ms']:.4f} ms "
          f"({r['bwd_ctas']} CTAs), plain {r['bwd_plain_ms']:.3f} ms, bound "
          f"{r['bwd_bound']:.4f} ms by {r['bwd_by']} (share "
          f"{r['bwd_bound'] / r['bwd_ms']:.3f}); {nblk} composited blocks, "
          f"{int(binning.num_pairs)} pairs", flush=True)
    return r


def compact_range(name, r, card):
    """K2 in compact mode on range_kernels' inputs: kb at the composited
    blocks and at half of them, against its plain version (BWD_TOL), the
    kept columns equal to K2's block layout, zeros past them; its time and
    bound at kb = the composited blocks. Returns (err, ms, plain ms, bound,
    bound_by)."""
    from gsplat_tpu_torch.ops import raster_cuda as rc

    bargs, cfg = r["bargs"], r["bargs"][6]
    G = cfg.pair_block
    off = rc.tile_block_offsets(bargs[3])
    n = int(off[-1])
    _, bchunk = plain_chunks(cfg)
    errs = []
    for kb in (n, max(n // 2, 1)):
        d_k = rc.composite_pairs_bwd(*bargs, kb=kb)
        d_p = rc.composite_pairs_bwd_plain(*bargs, block_chunk=bchunk, kb=kb)
        blk, _, _, valid = rc.composited_blocks(bargs[1], off, kb, cfg)
        cols = (blk[valid, None] * G
                + torch.arange(G, device=blk.device)).reshape(-1)
        kept = min(n, kb)
        torch.cuda.synchronize()
        rel = rel_err(d_k, d_p)
        same = bool(torch.equal(d_k[:, :kept * G], r["d_k"][:, cols]))
        zeros = bool((d_k[:, kept * G:] == 0).all())
        errs.append(float((d_k - d_p).abs().max()))
        print(f"[{name}] K2 compact, kb {kb} of {n} composited blocks: max "
              f"per-row relative {rel:.3e} (tol {BWD_TOL}), kept columns "
              f"equal K2's: {same}, zeros past them: {zeros}", flush=True)
        if not (rel <= BWD_TOL and same and zeros):
            raise SystemExit(f"FAIL: {name}: K2 compact disagrees")
    ms = device_ms(lambda: rc.composite_pairs_bwd(*bargs, kb=n), 20)
    plain_ms = device_ms(lambda: rc.composite_pairs_bwd_plain(
        *bargs, block_chunk=bchunk, kb=n), 2)
    bound, by, *_ = bwd_bound(bargs, cfg, OPS_BWD_PER_PAIR_PIXEL,
                              out_cols=n * G)
    print(f"[{card}] {name}: raster_bwd[compact] {ms:.4f} ms (20 launches), "
          f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms by {by} (share "
          f"{bound / ms:.3f})", flush=True)
    return max(errs), ms, plain_ms, bound, by


def ranges_phase(sparams, sc2w, pool, c2w, fx, fy, cx, cy, card, instr):
    """Phase 14f: K1 and K2 at each (tile, pair_block) of RANGES on phase
    3's synthetic scene and phase 4's bench pose at 1080p, as phases 3-4
    hold them; at the bench pose each timed beside (16, 256), with its
    bound; at (32, 256) also the log transmittance and K2's compact mode.
    K1's registers and CTAs per SM, K2's CTAs. Returns {key: numbers}."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops.raster_cuda import fwd_ctas_per_sm

    out = {}
    for tile, G in ((16, 256),) + RANGES:
        cfg = gt.RenderConfig(height=H, width=W, max_pairs=MAX_PAIRS,
                              tile=tile, pair_block=G)
        print(f"[{card}] tile {tile}, pair_block {G}: K1 "
              f"{fwd_ctas_per_sm(pool.pos.device, tile=tile, pair_block=G)} "
              f"CTAs of {tile * tile} threads per SM (occupancy API)",
              flush=True)
        sp = serving_path(sparams, sc2w, fx, fy, cx, cy, cfg)
        range_kernels(f"synthetic 1080p, tile {tile}, G {G}", sp["pair_feat"],
                      sp["bin"], cfg, seed=1, card=card, timed=False)
        sp = serving_path(pool.params, c2w, fx, fy, cx, cy, cfg,
                          alive=pool.alive)
        name = f"bench pose 1080p, tile {tile}, G {G}"
        out[(tile, G)] = range_kernels(name, sp["pair_feat"], sp["bin"],
                                       cfg, seed=2, card=card)
        if (tile, G) == (32, 256):
            out["compact"] = compact_range(name, out[(tile, G)], card)
            out["log"] = range_kernels(
                f"log, {name}", sp["pair_feat"], sp["bin"],
                cfg.with_(transmittance_math="log"), seed=3, card=card,
                instr=instr)
        for r in out.values():  # the kernels line reads only the numbers
            if isinstance(r, dict):
                r.pop("bargs", None)
                r.pop("d_k", None)
        del sp
        torch.cuda.empty_cache()
    return out


class _Tee:
    """A text stream that writes to two streams (the CLIs print their log
    lines; phase 14 reads them)."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def write(self, s):
        self.a.write(s)
        return self.b.write(s)

    def flush(self):
        self.a.flush()
        self.b.flush()


def run_cli(fn, argv):
    """fn(argv) with its standard output also captured: (result, lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        res = fn(argv)
    return res, buf.getvalue().splitlines()


def write_raw_scene(pool, center, radius, card):
    """Phase 14a: a Mip-NeRF-360-layout raw scene in DATA_DIR/raw: SCENE_VIEWS
    views of the checkpoint rendered at 1920x1080 around the bench orbit
    (radius x 4.4, elevations alternating 10 and 20 degrees) as PNG,
    poses_bounds.npy (LLFF's 3x5 layout with (H, W, focal)) and
    sparse/0/points3D.bin holding the alive means and their DC colours.
    Returns the raw directory."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.data.images import save_image
    from gsplat_tpu_torch.viewer import create_orbit_trajectory, make_render_fn

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    raw = os.path.join(DATA_DIR, "raw")
    os.makedirs(os.path.join(raw, "images"))
    os.makedirs(os.path.join(raw, "sparse", "0"))
    f = 0.85 * W
    cfg = gt.RenderConfig(height=H, width=W, max_pairs=MAX_PAIRS)
    poses = np.concatenate([
        create_orbit_trajectory(center, 4.4 * radius,
                                num_frames=SCENE_VIEWS // 2,
                                elevation_deg=e)
        for e in (10.0, 20.0)]).astype(np.float32)
    render = make_render_fn(pool.params, cfg, f, f, W / 2.0, H / 2.0,
                            alive=pool.alive)
    t0 = time.perf_counter()
    for i, c2w in enumerate(poses):
        save_image(os.path.join(raw, "images", f"{i:03d}.png"),
                   render(c2w).cpu().numpy())
    # OpenCV (right, down, forward) -> LLFF (down, right, back) columns.
    llff = np.stack([poses[:, :3, 1], poses[:, :3, 0], -poses[:, :3, 2],
                     poses[:, :3, 3], np.tile([H, W, f], (len(poses), 1))],
                    axis=2)
    bounds = np.tile([0.1, 100.0], (len(poses), 1))
    np.save(os.path.join(raw, "poses_bounds.npy"),
            np.concatenate([llff.reshape(len(poses), 15), bounds], 1))
    alive = pool.alive.cpu().numpy()
    xyz = pool.pos.detach().cpu().numpy()[alive].astype(np.float64)
    sh_c0 = 0.28209479177387814
    rgb = 1.0 / (1.0 + np.exp(-pool.f_dc.detach().cpu().numpy()[alive]
                              * sh_c0))
    rec = np.zeros(xyz.shape[0], np.dtype([
        ("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
        ("track", "<u8")]))
    rec["id"] = np.arange(xyz.shape[0])
    rec["xyz"] = xyz
    rec["rgb"] = np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)
    with open(os.path.join(raw, "sparse", "0", "points3D.bin"), "wb") as fh:
        fh.write(np.uint64(xyz.shape[0]).tobytes())
        fh.write(rec.tobytes())
    print(f"[{card}] 14a: raw scene of {len(poses)} views at {W}x{H} (PNG) "
          f"and {xyz.shape[0]} points in {time.perf_counter() - t0:.2f} s",
          flush=True)
    return raw


def check_fit_run(name, state, report, rec, lines, k1, k2, iters, interval,
                  card, peak_gib):
    """A dataset fit's checks: finite losses, no skipped step, K1 and K2
    launched views x iterations times, the last logged loss below the
    first logged after the last densification before the end (when there
    is one), and the step times, ADC counts and demand printed."""
    views = TRAIN_BATCH * iters
    losses = [v for _, v in report.losses]
    last_adc = max((it for it in range(interval, iters, interval)),
                   default=None)
    adc = [(it, [int(getattr(r, f)) for f in (
        "num_pruned", "num_split", "num_cloned", "num_overflowed")])
        for it, _, _, r in rec["adc"]]
    ms = rec["ms"]
    print(f"[{card}] {name}: logged losses " + ", ".join(
        f"{it}: {v:.6f}" for it, v in report.losses)
        + f"; nonfinite steps {report.nonfinite_steps}; K1 launches {k1}, K2 "
        f"launches {k2} (views x iterations = {views}); densifications "
        f"{adc}; capacity {state.pool.capacity}, {report.num_gaussians} "
        f"alive; max_pairs {rec['max_pairs']}; step ms (host clock to "
        f"synchronize) median {float(np.median(ms[1:])):.3f}, first "
        f"{ms[0]:.1f}, mean of the rest {float(np.mean(ms[1:])):.3f}; peak "
        f"device memory {peak_gib:.2f} GiB; wall {report.wall_time_s:.2f} s",
        flush=True)
    ok = (all(np.isfinite(losses)) and report.nonfinite_steps == 0
          and k1 == k2 == views and len(ms) == iters and len(adc) >= 1)
    if last_adc is not None:
        after = [v for it, v in report.losses if it > last_adc][0]
        ok &= losses[-1] < after
        print(f"  [{card}] {name}: last logged loss {losses[-1]:.6f} below "
              f"the first logged after the last densification (iteration "
              f"{last_adc}: {after:.6f}): {losses[-1] < after}", flush=True)
    if not ok:
        raise SystemExit(f"FAIL: {name}")
    return float(np.median(ms[1:]))


def dataset_phase(pool, center, radius, card, device="cuda"):
    """Phase 14: the dataset flow through the entry points a user runs, at
    the training configuration's full width (960x540, batch 4):
    (a) write_raw_scene, then prepare_dataset mipnerf (--downsample 1);
    (b) train (its main) from the prepared point cloud with the device
        image cache: holdout 8, 60 iterations, densification every 20;
    (c) the same through fit() on the same GaussianDataset at tile 32 and
        pair_block 512;
    (d) evaluate and eval_checkpoint on (b)'s checkpoint over the held-out
        views, inference --trajectory, render_trained --export_ply (read
        back with import_gaussians_ply, equal to the pool) and
        --render_training_views;
    (e) fit() runs of RANGE_ITERS iterations at the other (tile,
        pair_block) of RANGES, and at (32, 256) in the log form and with
        the compacted backward.
    Each run with the launch counts set to 0 just before it. Returns
    {name: (K1 launches, K2 launches)} for the kernels line."""
    import importlib

    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch import (eval_checkpoint, evaluate, inference,
                                  prepare_dataset, render_trained)
    from gsplat_tpu_torch.data import GaussianDataset
    from gsplat_tpu_torch.data.gsply import import_gaussians_ply
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs as cp
    from gsplat_tpu_torch.train.__main__ import main as train_main
    from gsplat_tpu_torch.utils.memory import estimate_train_memory

    fit_mod = importlib.import_module("gsplat_tpu_torch.train.fit")
    counts = {}

    def zero():
        for k in ("launches", "bwd_launches", "log_launches",
                  "bwd_log_launches", "bwd_compact_launches"):
            setattr(cp, k, 0)

    def read():
        return {k: getattr(cp, k) for k in (
            "launches", "bwd_launches", "log_launches", "bwd_log_launches",
            "bwd_compact_launches")}

    t14 = time.perf_counter()
    raw = write_raw_scene(pool, center, radius, card)
    prep = os.path.join(DATA_DIR, "prepared")
    info, _ = run_cli(prepare_dataset.main, [
        "mipnerf", "--input_dir", raw, "--output_dir", prep,
        "--downsample", "1"])
    if not (info["num_images"] == SCENE_VIEWS
            and info["num_points"] == int(pool.alive.sum())):
        raise SystemExit(f"FAIL: prepare_dataset: {info}")

    # --- 14b: train through its main ---
    iters, interval = SCENE_ITERS, SCENE_INTERVAL
    argv = ["--data_dir", prep, "--output_dir",
            os.path.join(DATA_DIR, "out_b"), "--scale_factor", "0.5",
            "--batch_size", str(TRAIN_BATCH), "--capacity", "131072",
            "--max_pairs", str(SCENE_PAIRS), "--holdout_every", "8",
            "--densification_interval", str(interval), "--adc_mode",
            "paper", "--iterations", str(iters), "--log_every", "5",
            "--checkpoint_interval",
            str(10**9), "--device", device]
    rec = {"max_pairs": [], "ms": [], "demand": [], "adc": [], "steps": 0,
           "snapshot_at": None}
    real = _instrument_fit(fit_mod, rec)
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero()
    try:
        (state, report), lines = run_cli(train_main, argv)
    finally:
        _restore_fit(fit_mod, real)
    n = read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    views_train = SCENE_VIEWS - -(-SCENE_VIEWS // 8)
    cached = views_train * TRAIN_H * TRAIN_W * 3 * 4
    est = estimate_train_memory(
        gt.RenderConfig(height=TRAIN_H, width=TRAIN_W,
                        max_pairs=rec["max_pairs"][-1]),
        gt.TrainConfig(batch_size=TRAIN_BATCH,
                       capacity=state.pool.capacity, adc_mode="paper"))
    memory_line(card, f"14b train CLI (its step, and the {views_train} "
                f"device-cached views, {cached / 1e6:.0f} MB)", other,
                dict(est, total_mb=est["total_mb"] + cached / 1e6))
    init = [m for m in lines if m.startswith("init from")]
    cache = [m for m in lines if m.startswith(
        f"device-caching {views_train} views")]
    print(f"[{card}] 14b: init line {init}, cache line {cache}", flush=True)
    if not (init and cache):
        raise SystemExit("FAIL: 14b did not start from the prepared point "
                         "cloud with the device image cache")
    step_b = check_fit_run("14b train", state, report, rec, lines,
                           n["launches"], n["bwd_launches"], iters, interval,
                           card, peak)
    ckpt = report.checkpoints[-1]
    back = gt.restore_pool(ckpt, device=device)
    same = all(torch.equal(getattr(back, k), getattr(state.pool, k).detach())
               for k in PARAM_KEYS) and torch.equal(back.alive,
                                                    state.pool.alive)
    print(f"[{card}] 14b: {ckpt} read by restore_pool equals the trained "
          f"pool: {same}", flush=True)
    if not same:
        raise SystemExit("FAIL: 14b checkpoint")
    counts["b"] = (n["launches"], n["bwd_launches"])

    # --- 14c: the same at tile 32 and pair_block 512, through fit() ---
    ds = GaussianDataset(prep, scale_factor=0.5, holdout_every=8,
                         split="train")
    rcfg = gt.RenderConfig(height=ds.height, width=ds.width,
                           max_pairs=SCENE_PAIRS, tile=32, pair_block=512)
    tcfg = gt.TrainConfig(iterations=iters, batch_size=TRAIN_BATCH,
                          capacity=131072, position_lr_max_steps=iters,
                          densification_interval=interval,
                          adc_mode="paper", checkpoint_interval=10**9)
    rec = {"max_pairs": [], "ms": [], "demand": [], "adc": [], "steps": 0,
           "snapshot_at": None}
    lines = []
    real = _instrument_fit(fit_mod, rec)
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero()
    try:
        state_c, report_c = fit_mod.fit(
            ds, rcfg, tcfg, output_dir=os.path.join(DATA_DIR, "out_c"),
            log_every=5, log_fn=lines.append, device=device)
    finally:
        _restore_fit(fit_mod, real)
    n = read()
    peak_c = torch.cuda.max_memory_allocated() / 2**30
    est = estimate_train_memory(rcfg.with_(max_pairs=rec["max_pairs"][-1]),
                                dataclasses.replace(
                                    tcfg, capacity=state_c.pool.capacity))
    memory_line(card, f"14c fit() at tile 32, pair_block 512 (and the "
                f"{views_train} device-cached views)", other,
                dict(est, total_mb=est["total_mb"] + cached / 1e6))
    for m in lines:
        print(f"  [14c] {m}")
    step_c = check_fit_run("14c fit at tile 32, pair_block 512", state_c,
                           report_c, rec, lines, n["launches"],
                           n["bwd_launches"], iters, interval, card, peak_c)
    counts[(32, 512)] = (n["launches"], n["bwd_launches"])
    print(f"[{card}] 14b/14c step ms: tile 16 G 128 {step_b:.3f}, tile 32 "
          f"G 512 {step_c:.3f}; losses at the end {report.final_loss:.6f} "
          f"and {report_c.final_loss:.6f}", flush=True)
    del state_c

    # --- 14d: evaluate, eval_checkpoint, inference, export ---
    zero()
    ev, _ = run_cli(evaluate.main, [
        "--checkpoint", ckpt, "--data_dir", prep, "--scale_factor", "0.5",
        "--holdout_every", "8", "--max_pairs", str(SCENE_PAIRS), "--device",
        device])
    ec, _ = run_cli(eval_checkpoint.main, [
        "--checkpoint", ckpt, "--scene_dir", prep, "--holdout_every", "8",
        "--device", device])
    traj_path = os.path.join(DATA_DIR, "trajectory.npy")
    np.save(traj_path, ds.c2w[:4])
    frames, _ = run_cli(inference.main, [
        "--checkpoint", ckpt, "--trajectory", traj_path, "--data_dir", prep,
        "--output_dir", os.path.join(DATA_DIR, "novel"), "--max_pairs",
        str(SCENE_PAIRS), "--device", device])
    ply = os.path.join(DATA_DIR, "export.ply")
    run_cli(render_trained.main, [
        "--checkpoint", ckpt, "--data_dir", prep, "--scale_factor", "0.5",
        "--output_dir", os.path.join(DATA_DIR, "renders"), "--num_frames",
        "2", "--benchmark_only", "--render_training_views", "--export_ply",
        ply, "--export_splat", os.path.join(DATA_DIR, "export.splat"),
        "--device", device])
    n = read()
    counts["d"] = (n["launches"], n["bwd_launches"])
    imported = import_gaussians_ply(ply)
    alive = state.pool.alive
    want = {k: getattr(state.pool, k).detach()[alive].cpu().numpy()
            for k in PARAM_KEYS}
    q = want["q_raw"] / (np.linalg.norm(want["q_raw"], axis=1,
                                        keepdims=True) + 1e-12)
    exact = all(np.array_equal(imported[k], want[k]) for k in
                ("pos", "f_dc", "f_rest", "opacity_raw", "scale_raw"))
    q_err = float(np.abs(imported["q_raw"] - q).max())
    pngs = sorted(os.listdir(os.path.join(DATA_DIR, "novel")))
    print(f"[{card}] 14d: evaluate on {ev['num_views']} held-out views: "
          f"PSNR {ev['psnr']:.3f} dB, SSIM {ev['ssim']:.4f}; eval_checkpoint "
          f"(full resolution) PSNR {ec['psnr']} dB over {ec['num_views']} "
          f"views, demand {ec['max_pair_demand']}; inference wrote "
          f"{len(pngs)} frames; the exported PLY read back: pos, f_dc, "
          f"f_rest, opacity, scale equal the pool's {exact}, rotation "
          f"(normalized) max abs {q_err:.2e}; K1 launches {n['launches']}",
          flush=True)
    test_views = -(-SCENE_VIEWS // 8)
    if not (ev["num_views"] == test_views == ec["num_views"]
            and np.isfinite(ev["psnr"]) and np.isfinite(ec["psnr"])
            and len(frames) == len(pngs) == 4 and exact and q_err <= 1e-6
            and n["launches"] > 0):
        raise SystemExit("FAIL: 14d")

    # --- 14e: the other ranges, the log form and the compacted backward ---
    for key in [r for r in RANGES if r != (32, 512)] + ["log", "compact"]:
        tile, G = (32, 256) if isinstance(key, str) else key
        kw = dict(transmittance_math="log") if key == "log" else {}
        if key == "compact":
            kw = dict(bwd_pairs=2**20)
        rcfg = gt.RenderConfig(height=ds.height, width=ds.width,
                               max_pairs=2 * SCENE_PAIRS, tile=tile, pair_block=G,
                               **kw)
        tcfg = gt.TrainConfig(iterations=RANGE_ITERS, batch_size=TRAIN_BATCH,
                              capacity=131072, densification_interval=10**9,
                              checkpoint_interval=10**9)
        zero()
        st, rep = fit_mod.fit(ds, rcfg, tcfg, log_every=RANGE_ITERS,
                              log_fn=lambda m: None, device=device)
        n = read()
        if key == "log":
            k1, k2 = n["log_launches"], n["bwd_log_launches"]
        elif key == "compact":
            k1, k2 = n["launches"], n["bwd_compact_launches"]
        else:
            k1, k2 = n["launches"], n["bwd_launches"]
        views = TRAIN_BATCH * RANGE_ITERS
        print(f"[{card}] 14e fit at tile {tile}, G {G} {kw}: losses "
              f"{rep.losses}, nonfinite {rep.nonfinite_steps}; K1 {k1}, K2 "
              f"{k2} launches (views x iterations = {views})", flush=True)
        if not (k1 == k2 == views and rep.nonfinite_steps == 0
                and np.isfinite(rep.final_loss)):
            raise SystemExit(f"FAIL: 14e at {key}")
        counts[key] = (k1, k2)
        del st
    print(f"[{card}] phase 14a-e took {time.perf_counter() - t14:.1f} s",
          flush=True)
    return counts


def range_entries(ranges, counts):
    """The kernels line's entries of phase 14: K1 and K2 at each (tile,
    pair_block) of RANGES, and at (32, 256) K1 and K2 in the log form and
    K2 in compact mode; launches from phase 14's fit() runs, times, errors
    and bounds from ranges_phase."""
    fwd = dict(route="cuda", library_ms=None,
               source="gsplat_tpu_torch/ops/csrc/raster_fwd.cu")
    bwd = dict(fwd, source="gsplat_tpu_torch/ops/csrc/raster_bwd.cu")
    out = []
    for key in RANGES + ("log",):
        r = ranges[key]
        tag, form = ("log,t32,G256", " (log)") if key == "log" else (
            f"t{key[0]},G{key[1]}", "")
        k1, k2 = counts[key]
        out += [dict(fwd, name=f"raster_fwd[{tag}]",
                     replaces=f"gsplat_tpu/ops/raster_pallas.py:192{form}",
                     launches=k1, max_abs_err=r["err"], ms=r["ms"],
                     plain_ms=r["plain_ms"], bound_ms=r["bound"],
                     bound_by=r["by"]),
                dict(bwd, name=f"raster_bwd[{tag}]",
                     replaces=f"gsplat_tpu/ops/raster_pallas.py:243{form}",
                     launches=k2, max_abs_err=r["bwd_err"], ms=r["bwd_ms"],
                     plain_ms=r["bwd_plain_ms"], bound_ms=r["bwd_bound"],
                     bound_by=r["bwd_by"])]
    err, ms, plain_ms, bound, by = ranges["compact"]
    out.append(dict(bwd, name="raster_bwd[compact,t32,G256]",
                    replaces="gsplat_tpu/ops/raster_pallas.py:243 (over the "
                             "compacted block list of rasterize.py:331)",
                    launches=counts["compact"][1], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound, bound_by=by))
    return out


def image_from_tiles(out, tile_count, cfg):
    """[num_tiles, 8, P] compositor output -> [H, W, 3] image, as
    rasterize_binned assembles it."""
    t = cfg.tile
    occ = (tile_count > 0)[:, None, None]
    rgb = torch.where(occ, out[:, 0:3], 0.0)
    img = rgb.reshape(cfg.tiles_y, cfg.tiles_x, 3, t, t).permute(
        0, 3, 1, 4, 2).reshape(cfg.padded_height, cfg.padded_width, 3)
    return torch.clamp(img[: cfg.height, : cfg.width], 0.0, 1.0)


# --------------------------------------------------------------------------
# Phase 15: the ellipse cull and the (data, tile) process grid.
# --------------------------------------------------------------------------

# Ellipse against rect, JAX's own bounds (tests/test_binning_ellipse.py):
# image and alpha 2e-6, depth 2e-5 (:67-76), gradients 5e-5 of each
# leaf's max (:96).
ELL_IMG_TOL, ELL_DEPTH_TOL, ELL_GRAD_TOL = 2e-6, 2e-5, 5e-5
ELL_ROWS0 = 4096  # 15a fit()'s starting max_rows, far below the demand
# The grid of phase 15b: four gloo ranks on one card. JAX's bounds for
# sharded against single-device results (tests/test_sharding.py: images
# 1e-6, :90; pos 1e-6 and the other leaves 2e-5 after a step, :109, :502)
# hold at its 64x64 scene, and tests/test_torch_sharding.py holds the port
# to them there. At 1080p they cannot: a band shifts the principal point
# (cy - band * band_px), so uv rounds otherwise in float32 and a pair can
# cross the edge of its support (q at min(chi2_clip, 2 ln(op / cutoff)))
# at a pixel. So the card holds the grid bit for bit to one process
# rendering the same bands, and to the full-frame single-rank render
# within such crossings: max abs at most the largest alpha a pair has at
# that edge, alpha_max * exp(-chi2_clip / 2), and at most GRID_FLIP_SHARE
# of the values beyond GRID_IMG_TOL. The step likewise: its gradients
# within GRID_GRAD_TOL of each leaf's max of one process's gradients of
# the same banded loss (only the order of the sums differs), the paper
# statistics against that process's; against the full-frame single-rank
# step, the loss within 1e-5 and Adam's first update compared as
# tests/test_torch_train.py does (the crossings move small gradients).
GRID_DATA, GRID_TILE = 2, 2
GRID_IMG_TOL, GRID_FLIP_SHARE, GRID_GRAD_TOL = 1e-6, 1e-3, 1e-5
GRID_STEPS = {
    "scan_ref": {},
    "scan_paper": {"adc_mode": "paper"},
    "batched_ref": {"batched_render": True},
    "batched_paper": {"adc_mode": "paper", "batched_render": True},
}
GRID_FIT_ITERS = 12
GRID_CLI_ITERS = 20


def _zero_counts():
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs as cp

    cp.launches = 0
    cp.bwd_launches = 0


def _frame_ms(fn, poses, reps=1):
    """Median host ms (to synchronize) of fn(pose) over the poses."""
    ms = []
    for _ in range(reps):
        for p in poses:
            t0 = time.perf_counter()
            fn(p)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def ellipse_phase(pool, c2w, traj, fx, fy, cx, cy, cfg, batch, start,
                  train_cfg, card):
    """Phase 15a: cull_mode="ellipse" on the checkpoint at full width.
    (1) the bench pose's binning both ways (pair demand, rows against
    row_capacity), K1 on the ellipse list bit for bit with its plain
    version and K2 given its state within BWD_TOL; (2) the rendered image,
    alpha and depth against rect's; frame and bin_gaussians times both
    ways; (3) a 1080p fwd+bwd each way, every leaf's gradient within
    ELL_GRAD_TOL of its max of rect's, and K2 of the ellipse fwd+bwd
    against its plain version on the inputs autograd gave it; (4) a
    FIT_ITERS-iteration fit() at 960x540, batch 4, from max_rows
    ELL_ROWS0, which must grow max_rows once; (5) render_trained
    --cull_mode ellipse with --auto_pairs and with --bucket_pairs 4 over
    the 8-frame orbit. The launches of (2)-(5) are counted (each with the
    counts set to 0 just before it). Returns {"k1", "k2", "err",
    "bwd_err", "pairs": the bench pose's ellipse pair demand}."""
    import importlib
    import tempfile

    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch import render_trained
    from gsplat_tpu_torch.ops.binning import bin_gaussians
    from gsplat_tpu_torch.ops.raster_cuda import (composite_pairs,
                                                  composite_pairs_bwd_plain,
                                                  composite_pairs_plain)
    from gsplat_tpu_torch.train import trainer
    from gsplat_tpu_torch.viewer import make_render_fn

    cp = composite_pairs
    ecfg = cfg.with_(cull_mode="ellipse")
    n = {"k1": 0, "k2": 0}

    def add():
        n["k1"] += cp.launches
        n["k2"] += cp.bwd_launches

    # (1) binning, K1 and K2 on the ellipse list
    sp_r = serving_path(pool.params, c2w, fx, fy, cx, cy, cfg,
                        alive=pool.alive)
    sp = serving_path(pool.params, c2w, fx, fy, cx, cy, ecfg,
                      alive=pool.alive)
    b, pf = sp["bin"], sp["pair_feat"]
    pairs_r, pairs_e, rows = (int(sp_r["bin"].num_pairs), int(b.num_pairs),
                              int(b.num_rows))
    print(f"[{card}] 15a ellipse at the 1080p bench pose: pair demand "
          f"{pairs_e} (rect {pairs_r}, {pairs_e / pairs_r:.4f} of it), "
          f"rows {rows} of row_capacity {ecfg.row_capacity}", flush=True)
    if not (0 < pairs_e < pairs_r and 0 < rows <= ecfg.row_capacity
            and pairs_e <= ecfg.max_pairs):
        raise SystemExit("FAIL: 15a ellipse demand")
    out_k = composite_pairs(pf, b.tile_start, b.tile_count, ecfg)
    out_p, state_p = composite_pairs_plain(
        pf, b.tile_start, b.tile_count, ecfg, tile_chunk=1024,
        with_state=True)
    torch.cuda.synchronize()
    err = compare("ellipse 1080p bench pose", out_k, out_p, b.tile_count)
    bwd_err = check_bwd("ellipse 1080p bench pose", pf, b, out_k, state_p,
                        ecfg, seed=5)
    del state_p, out_p
    br, pfr = sp_r["bin"], sp_r["pair_feat"]
    k1ms = {"rect": device_ms(lambda: composite_pairs(
        pfr, br.tile_start, br.tile_count, cfg), 20),
        "ellipse": device_ms(lambda: composite_pairs(
            pf, b.tile_start, b.tile_count, ecfg), 20)}
    out_r = composite_pairs(pfr, br.tile_start, br.tile_count, cfg)
    blocks = {m: int(torch.where(bb.tile_count > 0, o[:, 5, 0], 0.0).sum())
              for m, bb, o in (("ellipse", b, out_k), ("rect", br, out_r))}
    print(f"[{card}] 15a K1 at the bench pose (CUDA events, 20 launches, "
          f"not counted): rect {k1ms['rect']:.4f} ms over "
          f"{blocks['rect']} composited blocks, ellipse "
          f"{k1ms['ellipse']:.4f} ms over {blocks['ellipse']}", flush=True)

    # (2) the image both ways; frame and binning times
    with torch.no_grad():
        img_r, aux_r = gt.render_from_params(pool.params, c2w, fx, fy, cx,
                                             cy, cfg, alive=pool.alive)
        _zero_counts()
        img_e, aux_e = gt.render_from_params(pool.params, c2w, fx, fy, cx,
                                             cy, ecfg, alive=pool.alive)
        torch.cuda.synchronize()
        add()
    di = float((img_e - img_r).abs().max())
    dd = float((aux_e.depth - aux_r.depth).abs().max())
    # Alpha where rect's final T stays above transmittance_min; elsewhere
    # K1 stopped the tile at a block boundary, which the ellipse's shorter
    # list moves, so there both alphas only have to be saturated.
    da, sat = alpha_error(aux_e.alpha, aux_r.alpha, cfg)
    da_all = float((aux_e.alpha - aux_r.alpha).abs().max())
    print(f"[{card}] 15a ellipse vs rect frame: image max abs {di:.3e}, "
          f"depth {dd:.3e} (tol {ELL_DEPTH_TOL}); alpha {da:.3e} (tol "
          f"{ELL_IMG_TOL}) where rect's T > transmittance_min, the least "
          f"ellipse alpha elsewhere {sat:.7f} (max abs over the frame "
          f"{da_all:.3e}); row_capacity {aux_e.row_capacity}", flush=True)
    if not (di <= ELL_IMG_TOL and da <= ELL_IMG_TOL and dd <= ELL_DEPTH_TOL
            and sat >= 1.0 - cfg.transmittance_min - ELL_IMG_TOL
            and aux_e.row_capacity == ecfg.row_capacity):
        raise SystemExit("FAIL: 15a ellipse image")
    fns = {m: make_render_fn(pool.params, c, fx, fy, cx, cy,
                             alive=pool.alive)
           for m, c in (("rect", cfg), ("ellipse", ecfg))}
    for f in fns.values():
        f(traj[0])
    _zero_counts()
    frame = {m: _frame_ms(fns[m], traj) for m in ("rect", "ellipse")}
    n["k1"] += cp.launches  # rect and ellipse frames: main-path launches
    binms = {}
    for m, c, proj in (("rect", cfg, sp_r["proj"]),
                       ("ellipse", ecfg, sp["proj"])):
        bin_gaussians(proj, c)
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bin_gaussians(proj, c)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        binms[m] = (float(np.median(host)),
                    device_ms(lambda: bin_gaussians(proj, c), 5))
    print(f"[{card}] 15a frame ms over the bench pose and the 8-pose orbit "
          f"(host clock to synchronize, median): rect {frame['rect']:.3f}, "
          f"ellipse {frame['ellipse']:.3f}; bin_gaussians at the bench "
          f"pose: rect {binms['rect'][0]:.3f} ms host / "
          f"{binms['rect'][1]:.3f} ms CUDA events, ellipse "
          f"{binms['ellipse'][0]:.3f} / {binms['ellipse'][1]:.3f}",
          flush=True)

    # (3) fwd+bwd at 1080p both ways
    grads = {}
    for m, c in (("rect", cfg), ("ellipse", ecfg)):
        _zero_counts()
        gp, seen = fwd_bwd_phase(pool, c2w, fx, fy, cx, cy, c, card,
                                 reps=2)
        add()
        grads[m] = {k: p.grad for k, p in gp.items()}
        if m == "ellipse":
            d_p = composite_pairs_bwd_plain(*seen["args"], block_chunk=256)
            rel = rel_err(seen["d"], d_p)
            bwd_err = max(bwd_err, float((seen["d"] - d_p).abs().max()))
            del d_p
    gerr = {k: float((grads["ellipse"][k] - grads["rect"][k]).abs().max())
            / max(float(grads["rect"][k].abs().max()), 1e-30)
            for k in PARAM_KEYS}
    print(f"[{card}] 15a fwd+bwd ellipse vs rect, max abs error over each "
          f"leaf's max: " + ", ".join(f"{k} {v:.2e}" for k, v in
                                      gerr.items())
          + f" (tol {ELL_GRAD_TOL}); K2 on the ellipse list vs plain: "
          f"relative {rel:.3e} (tol {BWD_TOL})", flush=True)
    if not (max(gerr.values()) <= ELL_GRAD_TOL and rel <= BWD_TOL):
        raise SystemExit("FAIL: 15a ellipse gradients")
    del grads

    # (4) fit() from a row capacity far below the demand
    fit_mod = importlib.import_module("gsplat_tpu_torch.train.fit")
    B = batch["c2w"].shape[0]
    tcfg = gt.TrainConfig(iterations=FIT_ITERS, batch_size=B,
                          capacity=pool.capacity, checkpoint_interval=10**9,
                          densification_interval=10**9,
                          opacity_reset_interval=10**9)
    rcfg = train_cfg.with_(cull_mode="ellipse", max_rows=ELL_ROWS0)
    rec = {"max_pairs": [], "ms": [], "demand": [], "adc": [], "steps": 0,
           "snapshot_at": None}
    lines = []

    def log(msg):
        lines.append(msg)
        print(f"  [fit ellipse] {msg}", flush=True)

    def batches():
        while True:
            yield batch

    tmp = tempfile.mkdtemp(prefix="gsplat_fit_")
    try:
        ckpt = os.path.join(tmp, "start.npz")
        trainer.save_checkpoint(ckpt, gt.init_train_state(
            gt.pool_from_numpy(start, pool.alive.cpu().numpy(),
                               device=pool.pos.device), tcfg))
        points = pool.pos.detach()[pool.alive].cpu().numpy()
        real = _instrument_fit(fit_mod, rec)
        _zero_counts()
        try:
            state, report = fit_mod.fit(
                batches(), rcfg, tcfg, initial_points=points,
                resume_from=ckpt, log_every=2, log_fn=log,
                device=pool.pos.device)
        finally:
            _restore_fit(fit_mod, real)
        k1, k2 = cp.launches, cp.bwd_launches
        add()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    m = rec["last_metrics"]
    grew = [x for x in lines if "growing max_rows" in x]
    losses = [v for _, v in report.losses]
    print(f"[{card}] 15a fit ellipse from max_rows {ELL_ROWS0}: growth "
          f"{grew}; last step's row demand {int(m['row_demand'])} of "
          f"{int(m['row_capacity'])}, pair demand {int(m['pair_demand'])} "
          f"of {int(m['pair_capacity'])}; losses "
          + ", ".join(f"{it}: {v:.6f}" for it, v in report.losses)
          + f"; K1 {k1}, K2 {k2}; step ms median "
          f"{float(np.median(rec['ms'][1:])):.3f}", flush=True)
    if not (len(grew) == 1 and all(np.isfinite(losses))
            and report.nonfinite_steps == 0 and k1 == k2 == B * FIT_ITERS
            and int(m["row_demand"]) <= int(m["row_capacity"])):
        raise SystemExit("FAIL: 15a fit with the ellipse cull")

    # (5) render_trained over the 8-frame orbit, demand-sized and bucketed
    for flags in (["--auto_pairs"], ["--bucket_pairs", "4"]):
        _zero_counts()
        st, _ = run_cli(render_trained.main, [
            "--checkpoint", CKPT, "--benchmark_only", "--num_frames", "8",
            "--orbit_scale", "4.4", "--max_pairs", str(MAX_PAIRS),
            "--cull_mode", "ellipse"] + flags)
        k1 = cp.launches
        add()
        print(f"[{card}] 15a render_trained --cull_mode ellipse "
              f"{' '.join(flags)}: {st['median_ms']:.3f} ms median, max "
              f"pairs {st['max_pairs_seen']} and rows "
              f"{st['max_rows_seen']} seen, overflow frames "
              f"{st['pair_overflow_frames']}, K1 {k1}", flush=True)
        if st["pair_overflow_frames"] or k1 < 8 or st["max_rows_seen"] <= 0:
            raise SystemExit("FAIL: 15a render_trained with the ellipse")
    n.update(err=err, bwd_err=bwd_err, pairs=pairs_e)
    return n


def _state_digest(state) -> str:
    """sha256 over a train state's parameters, Adam moments and counts."""
    import hashlib

    h = hashlib.sha256()
    for k in PARAM_KEYS:
        p = state.pool.params[k]
        st = state.opt_state.state[p]
        for t in (p, st["exp_avg"], st["exp_avg_sq"], st["step"]):
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _max_diff(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


def banded_grads(pool, start, batch, rcfg, tcfg):
    """What the grid's step computes, in one process: each view's
    GRID_TILE bands rendered one after another (render_from_params, or
    batched render_batch_from_params), stacked, cropped, the batch's loss
    and its gradients, clipped and masked as the step does. Returns
    (loss, grads, paper statistics or None)."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops.losses import compute_loss
    from gsplat_tpu_torch.parallel import band_config
    from gsplat_tpu_torch.train.trainer import _clip_pos_grad, tap_norm_sum

    dev = pool.pos.device
    params = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
              for k, v in start.items()}
    bcfg, band_px = band_config(rcfg, GRID_TILE)
    B, Hh = batch["c2w"].shape[0], rcfg.height
    paper = tcfg.adc_mode == "paper"
    taps = torch.zeros((B, pool.capacity, 2), device=dev,
                       requires_grad=True) if paper else None
    cams = [batch[k] for k in ("fx", "fy", "cx")]
    radii = []
    if tcfg.batched_render:
        bands = []
        for b in range(GRID_TILE):
            img, aux = gt.render_batch_from_params(
                params, batch["c2w"], *cams, batch["cy"] - b * band_px,
                bcfg, alive=pool.alive, uv_taps=taps)
            bands.append(img)
            radii.append(aux.screen_radius.detach())
        loss = compute_loss(torch.cat(bands, dim=1)[:, :Hh], batch["image"],
                            tcfg.lambda_l1, tcfg.lambda_ssim)[0]
    else:
        totals = []
        for i in range(B):
            bands, rad = [], []
            for b in range(GRID_TILE):
                img, aux = gt.render_from_params(
                    params, batch["c2w"][i], *(c[i] for c in cams),
                    batch["cy"][i] - b * band_px, bcfg, alive=pool.alive,
                    uv_tap=None if taps is None else taps[i])
                bands.append(img)
                rad.append(aux.screen_radius.detach())
            radii.append(torch.stack(rad, dim=1))  # [N, bands]
            totals.append(compute_loss(torch.cat(bands)[:Hh],
                                       batch["image"][i], tcfg.lambda_l1,
                                       tcfg.lambda_ssim)[0])
        loss = torch.mean(torch.stack(totals))
    loss.backward()
    with torch.no_grad():
        grads = _clip_pos_grad({k: p.grad for k, p in params.items()},
                               tcfg.grad_clip_pos)
        grads = {k: torch.where(pool.alive.reshape(
            (-1,) + (1,) * (g.dim() - 1)), g, 0.0) for k, g in grads.items()}
        stats = None
        if paper:
            if tcfg.batched_render:  # [B, N] per band -> max over bands
                rmax = torch.amax(torch.stack(radii), dim=0)
            else:
                rmax = torch.amax(torch.stack(radii), dim=-1)  # [B, N]
            stats = {"uv_grad_sum": tap_norm_sum(taps.grad, rcfg),
                     "visible": torch.sum((rmax > 0).to(torch.int32), dim=0,
                                          dtype=torch.int32),
                     "max_radius": torch.amax(rmax, dim=0)}
    return loss.detach(), grads, stats


def first_update(new, ref, start, tcfg, dev, ref_grads=None):
    """Adam's first update of ``new`` (parameters) against ``ref``'s (a
    state, or parameters with ``ref_grads``), as tests/test_torch_train.py
    compares them across paths: (max relative difference where ref's
    gradient is large, per leaf; every update within its lr)."""
    lrs = {"pos": tcfg.position_lr_init * 0.01,
           "opacity_raw": tcfg.opacity_lr, "f_dc": tcfg.feature_lr,
           "f_rest": tcfg.feature_lr / 20.0, "scale_raw": tcfg.scaling_lr,
           "q_raw": tcfg.rotation_lr}
    uerr, lr_ok = {}, True
    for k in PARAM_KEYS:
        if ref_grads is None:
            g1, p1 = ref.pool.params[k].grad, ref.pool.params[k].detach()
        else:
            g1, p1 = ref_grads[k], ref[k]
        s0 = torch.from_numpy(start[k]).to(dev)
        d, d1 = new[k] - s0, p1 - s0
        big = g1.abs() > 1e-3 * float(g1.abs().max())
        uerr[k] = float(((d - d1).abs() / d1.abs().clamp(min=1e-30))[big]
                        .max()) if bool(big.any()) else 0.0
        lr_ok = lr_ok and bool((d.abs() <= lrs[k] * (1 + 1e-6)
                                + s0.abs() * 2**-23).all())
    return uerr, lr_ok


def grid_rank(card):
    """One rank of phase 15b's data x tile grid of gloo ranks on the card.
    Each part runs with the launch counts set to 0 just before it; rank 0
    also computes the single-rank references and checks the parts against
    them (a failure raises, which fails the rank and the phase). Returns,
    on rank 0: {"checks": the lines rank 0 printed, "counts": every rank's
    (K1, K2), "grid_ms", "single_ms"}."""
    import tempfile

    import torch.distributed as dist

    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.evaluation import evaluate_views
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs as cp
    from gsplat_tpu_torch.parallel import (band_config, local_batch,
                                           make_mesh,
                                           make_sharded_batch_render,
                                           make_sharded_render,
                                           make_sharded_train_step)
    from gsplat_tpu_torch.train import trainer
    from gsplat_tpu_torch.viewer import create_orbit_trajectory

    mesh = make_mesh(data=GRID_DATA, tile=GRID_TILE)
    main_rank = mesh.rank == 0
    dev = mesh.device
    pool = gt.restore_pool(CKPT, device=dev)
    alive_np = pool.alive.cpu().numpy()
    c2w, center, radius = bench_pose(pool)
    cfg = gt.RenderConfig(height=H, width=W, max_pairs=MAX_PAIRS)
    fx = fy = 0.85 * W
    cx, cy = W / 2.0, H / 2.0
    n = [0, 0]
    lines = []

    def run(fn):
        torch.cuda.synchronize()
        _zero_counts()
        out = fn()
        torch.cuda.synchronize()
        n[0] += cp.launches
        n[1] += cp.bwd_launches
        return out

    def check(ok, what):
        lines.append(what)
        print(f"[{card}] 15b {what}", flush=True)
        if not ok:
            raise SystemExit(f"FAIL: 15b {what}")

    def single(c, poses):
        """One process: the full frames, and the same bands rendered one
        after another and stacked ([B, H, W, 3] each)."""
        bcfg, band_px = band_config(c, GRID_TILE)
        with torch.no_grad():
            full = torch.stack([gt.render_from_params(
                pool.params, p, fx, fy, cx, cy, c, alive=pool.alive)[0]
                for p in poses])
            bands = torch.cat([gt.render_batch_from_params(
                pool.params, poses, fx, fy, cx, cy - b * band_px, bcfg,
                alive=pool.alive)[0] for b in range(GRID_TILE)], dim=1)
        return full, bands[:, :H]

    def image_check(what, img, poses, c):
        full, bands = single(c, poses)
        same = bool(torch.equal(img, bands))
        d = (img - full).abs()
        e, share = float(d.max()), float((d > GRID_IMG_TOL).float().mean())
        edge = c.alpha_max * float(np.exp(-c.chi2_clip / 2))
        check(same and e <= edge and share <= GRID_FLIP_SHARE,
              f"{what}: bit-identical to one process rendering the same "
              f"bands: {same}; against the full-frame single-rank render: "
              f"max abs {e:.3e} (at most {edge:.4e}, a pair's alpha at the "
              f"edge of its support), {share:.2e} of the values beyond "
              f"{GRID_IMG_TOL} (at most {GRID_FLIP_SHARE})")

    # (1) the band render at the bench pose, rect and ellipse
    for cull in ("rect", "ellipse"):
        ccfg = cfg.with_(cull_mode=cull)
        fn = make_sharded_render(ccfg, mesh)
        img = run(lambda: fn(pool.params, pool.alive, c2w, fx, fy, cx, cy))
        if main_rank:
            image_check(f"band render ({cull}) at the 1080p bench pose",
                        img[None], c2w[None], ccfg)
    # (2) the batch render of 4 poses
    poses = np.concatenate([c2w[None], create_orbit_trajectory(
        center, radius * 4.4, num_frames=3, elevation_deg=15.0)])
    bfn = make_sharded_batch_render(cfg, mesh)
    imgs = run(lambda: bfn(pool.params, pool.alive, poses, fx, fy, cx, cy))
    if main_rank:
        image_check("batch render of 4 poses at 1080p", imgs, poses, cfg)
    del imgs
    dist.barrier()

    # (3) the train step, scan and batched, reference and paper ADC
    tcfg0, batch, start = train_views(pool, c2w, center, radius)
    lb = local_batch(batch, mesh)
    grid_ms = single_ms = None
    for name, tkw in GRID_STEPS.items():
        tcfg = gt.TrainConfig(capacity=pool.capacity, batch_size=TRAIN_BATCH,
                              densification_interval=10**9,
                              opacity_reset_interval=10**9, **tkw)
        state = gt.init_train_state(
            gt.pool_from_numpy(start, alive_np, device=dev), tcfg)
        step = make_sharded_train_step(tcfg0, tcfg, mesh)
        state, m = run(lambda: step(state, lb))
        digests = [None] * mesh.size
        dist.all_gather_object(digests, _state_digest(state))
        if main_rank:
            ref = gt.init_train_state(
                gt.pool_from_numpy(start, alive_np, device=dev), tcfg)
            sstep = gt.make_train_step(tcfg0, tcfg)
            ref, m1 = sstep(ref, batch)
            bl, bg, bstats = banded_grads(pool, start, batch, tcfg0, tcfg)
            gerr, ferr = {}, {}
            for k in PARAM_KEYS:
                g = state.pool.params[k].grad
                g1 = ref.pool.params[k].grad
                gerr[k] = _max_diff(g, bg[k]) / max(
                    float(bg[k].abs().max()), 1e-30)
                ferr[k] = _max_diff(g, g1) / max(float(g1.abs().max()),
                                                 1e-30)
            uerr, lr_ok = first_update(
                {k: p.detach() for k, p in state.pool.params.items()}, ref,
                start, tcfg, dev)
            ok = (len(set(digests)) == 1
                  and max(gerr.values()) <= GRID_GRAD_TOL
                  and abs(float(m["total"]) - float(bl)) <= 1e-5
                  and max(uerr.values()) <= 1e-4 and lr_ok
                  and abs(float(m["total"]) - float(m1["total"])) <= 1e-5
                  and int(m["nonfinite_skipped"]) == 0
                  and int(m["max_band_pairs"]) <= int(
                      m["band_pair_capacity"]))
            what = (f"step {name}: all {mesh.size} ranks' parameters and "
                    f"moments bit-identical: {len(set(digests)) == 1}; "
                    f"gradients vs one process's banded loss over each "
                    f"leaf's max (tol {GRID_GRAD_TOL}): " + ", ".join(
                        f"{k} {v:.2e}" for k, v in gerr.items())
                    + f"; loss {float(m['total']):.6f}, banded "
                    f"{float(bl):.6f}, full-frame single rank "
                    f"{float(m1['total']):.6f}; against the full-frame "
                    f"step: gradients over each leaf's max " + ", ".join(
                        f"{k} {v:.2e}" for k, v in ferr.items())
                    + " (the crossings), updates where its gradient is "
                    "large, relative (tol 1e-4): " + ", ".join(
                        f"{k} {v:.2e}" for k, v in uerr.items())
                    + f", every update within its lr: {lr_ok}; band demand "
                    f"{int(m['max_band_pairs'])} of "
                    f"{int(m['band_pair_capacity'])}")
            if "uv_grad_sum" in m:
                a, b = bstats["uv_grad_sum"], m["uv_grad_sum"]
                ue = _max_diff(a, b)
                ok = ok and ue <= 1e-6 + 1e-4 * float(a.abs().max()) \
                    and torch.equal(m["visible"], bstats["visible"]) \
                    and torch.equal(m["max_radius"], bstats["max_radius"])
                what += (f"; against the banded process: uv_grad_sum max "
                         f"abs {ue:.3e} (max {float(a.abs().max()):.3e}), "
                         f"visible and max_radius equal")
            del bg
            check(ok, what)
            if name == "scan_ref":  # the single-rank step's time
                ms = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    sstep(ref, batch)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                single_ms = float(np.median(ms))
            del ref
        dist.barrier()
        if name == "scan_ref":  # the grid's step time, after the first
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                run(lambda: step(state, lb))
                ms.append((time.perf_counter() - t0) * 1e3)
            grid_ms = float(np.median(ms))
        del state

    # (4) fit(mesh=) with the paper ADC from the perturbed checkpoint
    tcfg = gt.TrainConfig(iterations=GRID_FIT_ITERS, batch_size=TRAIN_BATCH,
                          capacity=pool.capacity, checkpoint_interval=10**9,
                          adc_mode="paper", densification_interval=4,
                          densify_until_iter=12, opacity_reset_interval=8)
    points = pool.pos.detach()[pool.alive].cpu().numpy()
    tmp = tempfile.mkdtemp(prefix=f"gsplat_grid{mesh.rank}_")
    fit_lines = []
    try:
        ckpt = os.path.join(tmp, "start.npz")
        trainer.save_checkpoint(ckpt, gt.init_train_state(
            gt.pool_from_numpy(start, alive_np, device=dev), tcfg))

        def batches():
            while True:
                yield batch

        state, report = run(lambda: gt.fit(
            batches(), tcfg0, tcfg, initial_points=points,
            resume_from=ckpt, mesh=mesh, log_every=4,
            log_fn=fit_lines.append))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    digests = [None] * mesh.size
    dist.all_gather_object(digests, _state_digest(state))
    if main_rank:
        losses = [v for _, v in report.losses]
        check(len(set(digests)) == 1 and all(np.isfinite(losses))
              and report.nonfinite_steps == 0 and len(fit_lines) > 0,
              f"fit(mesh=) {GRID_FIT_ITERS} iterations, paper ADC every 4: "
              f"losses " + ", ".join(f"{it}: {v:.6f}"
                                     for it, v in report.losses)
              + f"; {report.num_gaussians} alive; final state bit-identical "
              f"on all ranks: {len(set(digests)) == 1}; log: "
              + " | ".join(x for x in fit_lines if "ADC" in x or "grow" in x))
    del state

    # (5) evaluate_views(mesh=): the perturbed pool on phase 8's views
    views = [{"image": batch["image"][i], "c2w": batch["c2w"][i],
              "fx": float(batch["fx"][i]), "fy": float(batch["fy"][i]),
              "cx": float(batch["cx"][i]), "cy": float(batch["cy"][i])}
             for i in range(TRAIN_BATCH)]
    perturbed = gt.pool_from_numpy(start, alive_np, device=dev)
    ev = run(lambda: evaluate_views(perturbed.params, views, tcfg0,
                                    alive=perturbed.alive, mesh=mesh))
    if main_rank:
        ev1 = evaluate_views(perturbed.params, views, tcfg0,
                             alive=perturbed.alive)
        check(abs(ev["psnr"] - ev1["psnr"]) <= 1e-4 * abs(ev1["psnr"])
              and abs(ev["ssim"] - ev1["ssim"]) <= 1e-4 * abs(ev1["ssim"]),
              f"evaluate_views(mesh=): PSNR {ev['psnr']:.6f} vs single "
              f"{ev1['psnr']:.6f}, SSIM {ev['ssim']:.6f} vs {ev1['ssim']:.6f}")
    counts = [None] * mesh.size
    dist.all_gather_object(counts, tuple(n))
    return {"checks": lines, "counts": counts, "grid_ms": grid_ms,
            "single_ms": single_ms} if main_rank else None


def grid_phase(card):
    """Phase 15b: one spawn of GRID_DATA x GRID_TILE gloo ranks on the card
    (parallel.launch; the kernels were built in phase 2, so the ranks load
    them), running :func:`grid_rank`; then the train CLI over the same
    grid (its own spawn) for GRID_CLI_ITERS iterations on phase 14's
    prepared dataset. Returns (K1, K2) launches of every rank of the
    first spawn."""
    from gsplat_tpu_torch.parallel import launch
    from gsplat_tpu_torch.train.__main__ import main as train_main

    t0 = time.perf_counter()
    res = launch(grid_rank, GRID_DATA * GRID_TILE, backend="gloo",
                 args=(card,))
    k1 = sum(c[0] for c in res["counts"])
    k2 = sum(c[1] for c in res["counts"])
    print(f"[{card}] 15b launches per rank (K1, K2): {res['counts']}; the "
          f"grid's scan step {res['grid_ms']:.3f} ms against the single-rank "
          f"step {res['single_ms']:.3f} ms (host clock to synchronize, "
          f"median of 3; not a speed figure: {GRID_DATA * GRID_TILE} ranks "
          f"share one card and gloo moves every collective through host "
          f"memory); the spawn took {time.perf_counter() - t0:.1f} s",
          flush=True)
    if not (k1 > 0 and k2 > 0):
        raise SystemExit("FAIL: 15b launched no kernel")
    out = os.path.join(DATA_DIR, "out_grid")
    t0 = time.perf_counter()
    _, report = train_main([
        "--data_dir", os.path.join(DATA_DIR, "prepared"), "--output_dir",
        out, "--scale_factor", "0.5", "--batch_size", str(TRAIN_BATCH),
        "--capacity", "131072", "--max_pairs", str(SCENE_PAIRS),
        "--holdout_every", "8", "--iterations", str(GRID_CLI_ITERS),
        "--log_every", "5", "--checkpoint_interval", str(10**9),
        "--mesh_data", str(GRID_DATA), "--mesh_tile", str(GRID_TILE),
        "--dist_backend", "gloo"])
    losses = [v for _, v in report.losses]
    done = os.path.exists(os.path.join(out, "checkpoint_final.npz"))
    print(f"[{card}] 15b python -m gsplat_tpu_torch.train --mesh_data "
          f"{GRID_DATA} --mesh_tile {GRID_TILE} --dist_backend gloo, "
          f"{GRID_CLI_ITERS} iterations: losses " + ", ".join(
              f"{it}: {v:.6f}" for it, v in report.losses)
          + f"; final checkpoint written: {done}; "
          f"{time.perf_counter() - t0:.1f} s (its ranks' launches are not "
          f"in the kernels line: they stay in the CLI's own processes)",
          flush=True)
    if not (report.iterations == GRID_CLI_ITERS and all(np.isfinite(losses))
            and report.nonfinite_steps == 0 and done):
        raise SystemExit("FAIL: 15b train CLI over the grid")
    return k1, k2


# Phase 16: the gaussian-sharded (ZeRO-style) step on the same kind of grid.
# Its image must equal one process computing the same banded render bit for
# bit (full-frame projection, band_localize per band, each band's binning
# and K1), its gradients that process's within GRID_GRAD_TOL of each leaf's
# max. The ring's images must equal the all-gather exchange's bit for bit
# (its buffer goes back to the pool's slot order, so depth ties composite
# alike), its gradients match within GRID_GRAD_TOL of each leaf's max, with
# no overflow, its updated pos and f_dc within JAX's 5e-6
# (tests/test_sharding.py:330-339) and its first Adam update by the CPU
# tests' rule; a starved ring (GAUSS_STARVED rows) must report its
# overflow. fit() with either exchange: alive count and losses within
# GAUSS_FIT_TOL of the single-rank fit() from the same start.
GAUSS_TILE4 = 4  # 16b's data 1 x tile 4 grid
GAUSS_RING_MARGIN = 1.25
GAUSS_STARVED = 1024
GAUSS_FIT_TOL = 0.01
RING_TOL = 5e-6  # ring vs all-gather, updated pos and f_dc
GAUSS_DCP_DIR = os.path.join(DATA_DIR, "gauss_dcp")


def banded_gauss(pool, start, batch, rcfg, tcfg, n_tile):
    """What the gaussian-sharded grid computes, in one process: each
    view's full-frame projection of the whole pool, localized to each of
    ``n_tile`` bands (``band_localize``), each band binned and composited
    (K1; batched: the views' localized projections of a band stacked into
    one list), the bands stacked and cropped, the loss and its gradients,
    clipped and masked as the step does. Returns (images [B, H, W, 3],
    loss, gradients, paper statistics or None)."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
    from gsplat_tpu_torch.ops.losses import compute_loss
    from gsplat_tpu_torch.ops.rasterize import rasterize_binned
    from gsplat_tpu_torch.ops.sh import evaluate_sh
    from gsplat_tpu_torch.parallel import band_config, band_localize
    from gsplat_tpu_torch.render import stack_view_projections
    from gsplat_tpu_torch.train.trainer import _clip_pos_grad, tap_norm_sum

    dev = pool.pos.device
    params = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
              for k, v in start.items()}
    bcfg, band_px = band_config(rcfg, n_tile)
    rows = band_px // rcfg.tile
    B, Hh = batch["c2w"].shape[0], rcfg.height
    paper = tcfg.adc_mode == "paper"
    taps = torch.zeros((B, pool.capacity, 2), device=dev,
                       requires_grad=True) if paper else None

    def project(v, cov3d):
        c2w = batch["c2w"][v]
        colors = evaluate_sh(params["f_dc"], params["f_rest"], params["pos"],
                             c2w)
        proj = gt.project_gaussians(
            params["pos"], cov3d, params["opacity_raw"], c2w, batch["fx"][v],
            batch["fy"][v], batch["cx"][v], batch["cy"][v], rcfg,
            extra_valid=pool.alive, uv_tap=None if taps is None else taps[v])
        return proj, colors

    if tcfg.batched_render:
        cov3d = build_cov3d_packed(params["scale_raw"], params["q_raw"])
        pcs = [project(v, cov3d) for v in range(B)]
        proj_b = gt.ProjectedGaussians(*(torch.stack(f) for f in zip(
            *[p for p, _ in pcs])))
        cols = torch.cat([c for _, c in pcs])
        bands = []
        for b in range(n_tile):
            st, scfg = stack_view_projections(
                band_localize(proj_b, b * rows, rows, rcfg.tile), bcfg)
            img, _ = rasterize_binned(st, cols, gt.bin_gaussians(st, scfg),
                                      scfg)
            bands.append(img.reshape(B, bcfg.padded_height, rcfg.width,
                                     3)[:, :band_px])
        imgs = torch.cat(bands, dim=1)[:, :Hh]
        loss = compute_loss(imgs, batch["image"], tcfg.lambda_l1,
                            tcfg.lambda_ssim)[0]
        radii = proj_b.radius
    else:
        ims, totals, radii = [], [], []
        for v in range(B):
            proj, col = project(v, build_cov3d_packed(params["scale_raw"],
                                                      params["q_raw"]))
            bands = []
            for b in range(n_tile):
                band = band_localize(proj, b * rows, rows, rcfg.tile)
                bands.append(rasterize_binned(
                    band, col, gt.bin_gaussians(band, bcfg), bcfg)[0])
            im = torch.cat(bands)[:Hh]
            ims.append(im)
            totals.append(compute_loss(im, batch["image"][v], tcfg.lambda_l1,
                                       tcfg.lambda_ssim)[0])
            radii.append(proj.radius)
        imgs = torch.stack(ims)
        loss = torch.mean(torch.stack(totals))
        radii = torch.stack(radii)
    loss.backward()
    with torch.no_grad():
        grads = _clip_pos_grad({k: p.grad for k, p in params.items()},
                               tcfg.grad_clip_pos)
        grads = {k: torch.where(pool.alive.reshape(
            (-1,) + (1,) * (g.dim() - 1)), g, 0.0) for k, g in grads.items()}
        stats = None
        if paper:
            stats = {"uv_grad_sum": tap_norm_sum(taps.grad, rcfg),
                     "visible": torch.sum((radii > 0).to(torch.int32), dim=0,
                                          dtype=torch.int32),
                     "max_radius": torch.amax(radii, dim=0)}
    return imgs.detach(), loss.detach(), grads, stats


def band_gauss_demand(pool, batch, rcfg, n_tile):
    """The largest number of gaussians one band of one view holds (the
    ring's buffer demand), from the whole pool's full-frame projections."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
    from gsplat_tpu_torch.parallel import band_config, band_localize

    rows = band_config(rcfg, n_tile)[1] // rcfg.tile
    demand = 0
    with torch.no_grad():
        cov3d = build_cov3d_packed(pool.scale_raw, pool.q_raw)
        for v in range(batch["c2w"].shape[0]):
            proj = gt.project_gaussians(
                pool.pos, cov3d, pool.opacity_raw, batch["c2w"][v],
                batch["fx"][v], batch["fy"][v], batch["cx"][v],
                batch["cy"][v], rcfg, extra_valid=pool.alive)
            for b in range(n_tile):
                band = band_localize(proj, b * rows, rows, rcfg.tile)
                demand = max(demand, int(band.valid.sum()))
    return demand


def gauss_rank(card):
    """One rank of phase 16's grid of gloo ranks on the card: (a) the
    gaussian-sharded step over data 2 x tile 2 in four forms, (b) the ring
    over data 1 x tile 4 of the same processes, (c) fit() with either
    exchange and the DCP checkpoint. Each part runs with the launch counts
    set to 0 just before it; rank 0 computes the one-process references
    and checks the parts (a failure raises, which fails the rank and the
    phase). Returns, on rank 0: {"counts": every rank's (K1, K2),
    "digest": the gathered fit state's digest, "alive": its alive count,
    "lines": what rank 0 checked, "k2_err": K2's largest abs error against
    its plain version on the band inputs}."""
    import tempfile

    import torch.distributed as dist

    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops import raster_cuda
    from gsplat_tpu_torch.ops.raster_cuda import (composite_pairs_bwd_plain,
                                                  composite_pairs_plain)
    from gsplat_tpu_torch.parallel import (gather_train_state, local_batch,
                                           make_gauss_sharded_render,
                                           make_gauss_sharded_train_step,
                                           make_mesh,
                                           make_sharded_train_step,
                                           shard_train_state)
    from gsplat_tpu_torch.parallel.sharding import _all_gather
    from gsplat_tpu_torch.train import trainer
    from gsplat_tpu_torch.utils.memory import estimate_train_memory

    cp = raster_cuda.composite_pairs
    mesh = make_mesh(data=GRID_DATA, tile=GRID_TILE)
    mesh4 = make_mesh(data=1, tile=GAUSS_TILE4)
    main_rank = mesh.rank == 0
    dev = mesh.device
    pool = gt.restore_pool(CKPT, device=dev)
    alive_np = pool.alive.cpu().numpy()
    c2w, center, radius = bench_pose(pool)
    rcfg, batch, start = train_views(pool, c2w, center, radius)
    lb = local_batch(batch, mesh)
    n = [0, 0]
    lines = []

    def run(fn):
        torch.cuda.synchronize()
        _zero_counts()
        out = fn()
        torch.cuda.synchronize()
        n[0] += cp.launches
        n[1] += cp.bwd_launches
        return out

    def check(ok, what):
        lines.append(what)
        print(f"[{card}] 16 {what}", flush=True)
        if not ok:
            raise SystemExit(f"FAIL: 16 {what}")

    def fresh(tcfg):
        return gt.init_train_state(
            gt.pool_from_numpy(start, alive_np, device=dev), tcfg)

    def tcfg_of(**kw):
        return gt.TrainConfig(capacity=pool.capacity, batch_size=TRAIN_BATCH,
                              densification_interval=10**9,
                              opacity_reset_interval=10**9, **kw)

    def timed_step(step, state, views):
        """(state, metrics, ms, peak GiB) of one counted step; what the
        process held before it, less the step's state and views, goes to
        ``held_by_others[0]`` (bytes)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        opt = state.opt_state
        held_by_others[0] = torch.cuda.memory_allocated(dev) - tensor_bytes(
            state.pool.params, state.pool.alive, views,
            [[opt.state[q]["exp_avg"], opt.state[q]["exp_avg_sq"]]
             for q in state.pool.params.values()])
        t0 = time.perf_counter()
        state, m = run(lambda: step(state, views))
        ms = (time.perf_counter() - t0) * 1e3
        return state, m, ms, torch.cuda.max_memory_allocated(dev) / 2**30

    def rank_ratio(tcfg, peak_gib, n_tile):
        """The memory model's estimate for this rank's gaussian-sharded
        step over its own peak (its local views)."""
        est = estimate_train_memory(rcfg, dataclasses.replace(
            tcfg, batch_size=TRAIN_BATCH // (mesh.size // n_tile)),
            gauss_sharded_tile=n_tile)
        return est["total_mb"] * 1e6 / (peak_gib * 2**30
                                        - held_by_others[0])

    # (a) the gaussian-sharded step, four forms, data 2 x tile 2.
    held_by_others = [0]
    seen, k2_err, mem = {}, 0.0, {}
    real_bwd = raster_cuda.composite_pairs_bwd
    for name, tkw in GRID_STEPS.items():
        tcfg = tcfg_of(**tkw)
        state = shard_train_state(fresh(tcfg), mesh)
        opt = state.opt_state
        rows = {"alive": state.pool.alive.shape[0]}
        for k, p in state.pool.params.items():
            rows[k] = p.shape[0]
            rows[k + ".m"] = opt.state[p]["exp_avg"].shape[0]
            rows[k + ".v"] = opt.state[p]["exp_avg_sq"].shape[0]
        with torch.no_grad():  # the images the step's loss reads
            imgs = make_gauss_sharded_render(
                rcfg, mesh, batched=tcfg.batched_render)(
                    state.pool.params, state.pool.alive, lb)[0]
        imgs = _all_gather(imgs, mesh.data_group, GRID_DATA, 0)
        step = make_gauss_sharded_train_step(rcfg, tcfg, mesh)
        if name == "scan_ref":  # what autograd hands K2 on this band
            def seen_bwd(*args, **kw):
                seen["args"] = detached(args)
                seen["d"] = real_bwd(*args, **kw)
                return seen["d"]
            raster_cuda.composite_pairs_bwd = seen_bwd
        try:
            state, m, ms, peak = timed_step(step, state, lb)
        finally:
            raster_cuda.composite_pairs_bwd = real_bwd
        mem[name] = (ms, peak, rank_ratio(tcfg, peak, GRID_TILE))
        if name == "scan_ref":  # K1 and K2 against their plain versions
            pf, ts, tc, out = seen["args"][:4]
            with torch.no_grad():
                out_p = composite_pairs_plain(pf, ts, tc, seen["args"][6],
                                              tile_chunk=1024)
            compare(f"16a rank {mesh.rank} band list", out, out_p, tc)
            d_p = composite_pairs_bwd_plain(*seen["args"], block_chunk=256)
            rel = rel_err(seen["d"], d_p)
            k2_err = float((seen["d"] - d_p).abs().max())
            print(f"[{card}] 16a rank {mesh.rank}: K2 on the band inputs "
                  f"autograd gave it vs plain: relative {rel:.3e} (tol "
                  f"{BWD_TOL}), max abs {k2_err:.3e}", flush=True)
            if rel > BWD_TOL:
                raise SystemExit("FAIL: 16a K2 disagrees with its plain "
                                 "version on the band inputs")
            del seen["args"], seen["d"], d_p, out_p
            # Phase 15b's replicated step on the same grid and views.
            rstate = fresh(tcfg)
            rstep = make_sharded_train_step(rcfg, tcfg, mesh)
            _, _, rms, rpeak = timed_step(rstep, rstate, lb)
            mem["replicated"] = (rms, rpeak, None)
            # Steps after the first (median of 3); the gaussian-sharded
            # one on a copy, so that the checks below read the first.
            copy = shard_train_state(gather_train_state(state, mesh), mesh)
            mem["later"] = {tag: float(np.median([
                timed_step(stp, st, lb)[2] for _ in range(3)]))
                for tag, stp, st in (("scan_ref", step, copy),
                                     ("replicated", rstep, rstate))}
            del rstate, copy
        digests = [None] * mesh.size
        dist.all_gather_object(digests, _state_digest(state))
        grads = {k: _all_gather(p.grad, mesh.tile_group, GRID_TILE, 0)
                 for k, p in state.pool.params.items()}
        whole = gather_train_state(state, mesh)
        paper = {k: _all_gather(m[k], mesh.tile_group, GRID_TILE, 0)
                 for k in ("uv_grad_sum", "visible", "max_radius") if k in m}
        if main_rank:
            bimgs, bl, bg, bstats = banded_gauss(pool, start, batch, rcfg,
                                                 tcfg, GRID_TILE)
            same_img = bool(torch.equal(imgs, bimgs))
            del bimgs
            ref = fresh(tcfg)
            ref, m1 = gt.make_train_step(rcfg, tcfg)(ref, batch)
            gerr = {k: _max_diff(grads[k], bg[k]) / max(
                float(bg[k].abs().max()), 1e-30) for k in PARAM_KEYS}
            uerr, lr_ok = first_update(
                {k: v.detach() for k, v in whole.pool.params.items()}, ref,
                start, tcfg, dev)
            replicas = all(digests[t] == digests[GRID_TILE + t]
                           for t in range(GRID_TILE))
            ok = (same_img and replicas
                  and set(rows.values()) == {pool.capacity // GRID_TILE}
                  and max(gerr.values()) <= GRID_GRAD_TOL
                  and abs(float(m["total"]) - float(bl)) <= 1e-5
                  and abs(float(m["total"]) - float(m1["total"])) <= 1e-5
                  and max(uerr.values()) <= 1e-4 and lr_ok
                  and int(m["nonfinite_skipped"]) == 0
                  and int(m["ring_overflow"]) == 0
                  and int(m["max_band_pairs"]) <= int(
                      m["band_pair_capacity"]))
            what = (f"16a step {name}: each rank holds "
                    f"{sorted(set(rows.values()))} rows of every capacity "
                    f"leaf; gathered images bit-identical to one process's "
                    f"banded render: {same_img}; data replicas' shards "
                    f"bit-identical: {replicas}; gradients vs that "
                    f"process's over each leaf's max (tol {GRID_GRAD_TOL}): "
                    + ", ".join(f"{k} {v:.2e}" for k, v in gerr.items())
                    + f"; loss {float(m['total']):.6f}, banded "
                    f"{float(bl):.6f}, full-frame single rank "
                    f"{float(m1['total']):.6f}; Adam's first update vs the "
                    f"single-rank step where its gradient is large, "
                    f"relative (tol 1e-4): " + ", ".join(
                        f"{k} {v:.2e}" for k, v in uerr.items())
                    + f", every update within its lr: {lr_ok}; band demand "
                    f"{int(m['max_band_pairs'])} of "
                    f"{int(m['band_pair_capacity'])}")
            if paper:
                a = bstats["uv_grad_sum"]
                ue = _max_diff(a, paper["uv_grad_sum"])
                ok = ok and ue <= 1e-6 + 1e-4 * float(a.abs().max()) \
                    and torch.equal(paper["visible"], bstats["visible"]) \
                    and torch.equal(paper["max_radius"],
                                    bstats["max_radius"])
                what += (f"; uv_grad_sum vs the banded process max abs "
                         f"{ue:.3e} (max {float(a.abs().max()):.3e}), "
                         f"visible and max_radius equal")
            del bg, ref
            check(ok, what)
        del state, whole, grads, imgs
        dist.barrier()
    peaks = [None] * mesh.size
    dist.all_gather_object(peaks, mem)
    if main_rank:
        print(f"[{card}] 16a per rank, the first step of each (host ms to "
              f"synchronize, peak GiB torch.cuda.max_memory_allocated, and "
              f"utils.memory's estimate for a gaussian-sharded rank over "
              f"the step's own peak): "
              + "; ".join(f"rank {r}: " + ", ".join(
                  f"{k} {v[0]:.3f} ms {v[1]:.3f} GiB" + (
                      "" if v[2] is None else f" (estimate / own {v[2]:.3f})")
                  for k, v in p.items() if k != "later")
                  + ", later steps (median of 3): " + ", ".join(
                      f"{k} {v:.3f} ms" for k, v in p["later"].items())
                  for r, p in enumerate(peaks))
              + " (not a speed figure: the ranks share one card)",
              flush=True)

    # (b) the ring over data 1 x tile 4.
    demand = band_gauss_demand(pool, batch, rcfg, GAUSS_TILE4)
    cap = -(-int(demand * GAUSS_RING_MARGIN) // 1024) * 1024
    tcfg = tcfg_of()
    outs = {}
    b4 = local_batch(batch, mesh4)
    for tag, ring, rc in (("all-gather", False, None), ("ring", True, cap),
                          ("starved", True, GAUSS_STARVED)):
        state = shard_train_state(fresh(tcfg), mesh4)
        with torch.no_grad():
            imgs = make_gauss_sharded_render(rcfg, mesh4, ring=ring,
                                             ring_capacity=rc)(
                state.pool.params, state.pool.alive, b4)[0]
        step = make_gauss_sharded_train_step(rcfg, tcfg, mesh4, ring=ring,
                                             ring_capacity=rc)
        state, m, ms, peak = timed_step(step, state, b4)
        grads = {k: _all_gather(p.grad, mesh4.tile_group, GAUSS_TILE4, 0)
                 for k, p in state.pool.params.items()}
        whole = gather_train_state(state, mesh4)
        outs[tag] = ({k: v.detach() for k, v in whole.pool.params.items()},
                     float(m["total"]), int(m["ring_overflow"]), ms, peak,
                     grads, imgs)
        del state, whole
    if main_rank:
        (pa, la, _, msa, pka, ga, ia), (pr, lr_, ovf, msr, pkr, gr, ir) = (
            outs["all-gather"], outs["ring"])
        diffs = {k: _max_diff(pr[k], pa[k]) for k in PARAM_KEYS}
        gerr = {k: _max_diff(gr[k], ga[k]) / max(float(ga[k].abs().max()),
                                                 1e-30) for k in PARAM_KEYS}
        uerr, lr_ok = first_update(pr, pa, start, tcfg, dev, ref_grads=ga)
        same_img = bool(torch.equal(ir, ia))
        check(ovf == 0 and outs["starved"][2] > 0 and cap < pool.capacity
              and same_img and abs(lr_ - la) <= 1e-5
              and max(gerr.values()) <= GRID_GRAD_TOL
              and max(uerr.values()) <= 1e-4 and lr_ok
              and max(diffs["pos"], diffs["f_dc"]) <= RING_TOL,
              f"16b tile 4 ring: the largest band's gaussian demand "
              f"{demand}, ring_capacity {cap} (x{GAUSS_RING_MARGIN}, of "
              f"{pool.capacity} slots); ring vs all-gather step: images "
              f"bit-identical: {same_img}; loss {lr_:.6f} vs {la:.6f}; "
              f"gradients over each leaf's max (tol {GRID_GRAD_TOL}): "
              + ", ".join(f"{k} {v:.2e}" for k, v in gerr.items())
              + "; Adam's first update where the gradient is large, "
              "relative (tol 1e-4): " + ", ".join(
                  f"{k} {v:.2e}" for k, v in uerr.items())
              + f", every update within its lr: {lr_ok}; updated "
              f"parameters max abs " + ", ".join(
                  f"{k} {v:.2e}" for k, v in diffs.items())
              + f" (tol {RING_TOL} on pos and f_dc, JAX's); "
              f"ring_overflow {ovf}; starved ring_capacity "
              f"{GAUSS_STARVED}: ring_overflow {outs['starved'][2]}; rank 0 "
              f"step {msa:.3f} ms / {pka:.3f} GiB all-gather, {msr:.3f} ms "
              f"/ {pkr:.3f} GiB ring (first step of each)")
    del outs
    dist.barrier()

    # (c) fit(mesh=, gauss_sharded=True | "ring") from phase 8's perturbed
    # checkpoint with the reference ADC (fit (a) of phase 8b), then the
    # DCP pair.
    tcfg = gt.TrainConfig(iterations=GRID_FIT_ITERS, batch_size=TRAIN_BATCH,
                          capacity=pool.capacity, checkpoint_interval=10**9,
                          densification_interval=4, densify_until_iter=12,
                          opacity_reset_interval=8)
    points = pool.pos.detach()[pool.alive].cpu().numpy()
    tmp = tempfile.mkdtemp(prefix=f"gsplat_gauss{mesh.rank}_")
    fits = {}
    try:
        ckpt = os.path.join(tmp, "start.npz")
        trainer.save_checkpoint(ckpt, fresh(tcfg))

        def batches():
            while True:
                yield batch

        def fit(how, logs):
            return gt.fit(batches(), rcfg, tcfg, initial_points=points,
                          resume_from=ckpt, mesh=mesh if how else None,
                          gauss_sharded=how, log_every=4,
                          log_fn=logs.append, device=dev)

        def peak_of(fn):
            """(fn(), GiB this process held before, its peak GiB during)."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev) / 2**30
            held_by_others[0] = held * 2**30
            out = fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            return out, held, peak, rank_ratio(tcfg, peak, GRID_TILE)

        fit_mem = {}
        for how in (True, "ring"):
            logs = []
            out, *fit_mem[how] = peak_of(lambda: run(lambda: fit(how, logs)))
            fits[how] = out + (logs,)
        if main_rank:  # the single-rank reference (not counted)
            out, *fit_mem[False] = peak_of(lambda: fit(False, []))
            fits[False] = out + ([],)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    st = fits[True][0]
    if main_rank:
        shutil.rmtree(GAUSS_DCP_DIR, ignore_errors=True)
    dist.barrier()
    trainer.save_checkpoint_dcp(GAUSS_DCP_DIR, shard_train_state(st, mesh),
                                mesh)
    digest = _state_digest(st) + str(int(st.pool.num_alive()))
    fit_peaks = [None] * mesh.size
    dist.all_gather_object(fit_peaks, fit_mem)
    if main_rank:
        print(f"[{card}] 16c fit() peak memory per rank (GiB held before "
              f"the fit / torch.cuda.max_memory_allocated during it, and "
              f"utils.memory's estimate for a gaussian-sharded rank's step "
              f"over the fit's own peak; the ADC and the checkpoints gather "
              f"the whole state on every rank): " + "; ".join(
                  f"rank {r}: " + ", ".join(
                      f"{tag} {p[h][0]:.3f} / {p[h][1]:.3f} ({p[h][2]:.3f})"
                      for h, tag in ((True, "all-gather"), ("ring", "ring")))
                  for r, p in enumerate(fit_peaks))
              + f"; the single-rank fit() in rank 0's process: "
              f"{fit_mem[False][0]:.3f} / {fit_mem[False][1]:.3f}",
              flush=True)
        s1, r1, _ = fits[False]
        n1 = int(s1.pool.num_alive())
        msgs = []
        ok = True
        for how, tag in ((True, "all-gather"), ("ring", "ring")):
            s, r, logs = fits[how]
            na = int(s.pool.num_alive())
            lerr = max(abs(a - b) / b for (_, a), (_, b) in zip(r.losses,
                                                                r1.losses))
            ok = ok and abs(na - n1) <= GAUSS_FIT_TOL * n1 \
                and lerr <= GAUSS_FIT_TOL and r.nonfinite_steps == 0 \
                and [i for i, _ in r.losses] == [i for i, _ in r1.losses] \
                and not any("ring-stream" in x for x in logs)
            msgs.append(f"{tag}: losses " + ", ".join(
                f"{it}: {v:.6f}" for it, v in r.losses)
                + f", {na} alive, largest loss difference {lerr:.2e}")
        check(ok, f"16c fit(mesh=, gauss_sharded) {GRID_FIT_ITERS} "
              f"iterations, reference ADC every 4: " + "; ".join(msgs)
              + f"; single-rank fit: losses " + ", ".join(
                  f"{it}: {v:.6f}" for it, v in r1.losses)
              + f", {n1} alive (tol {GAUSS_FIT_TOL} relative)")
    del fits
    counts = [None] * mesh.size
    dist.all_gather_object(counts, tuple(n))
    return {"counts": counts, "digest": digest, "lines": lines,
            "k2_err": k2_err} if main_rank else None


def gauss_phase(card):
    """Phase 16: one spawn of 4 gloo ranks on the card running
    :func:`gauss_rank`; the DCP checkpoint its fit wrote, loaded here in
    one process, bit for bit to the gathered state; then (d) the train CLI
    with --gauss_sharded, and with --ring, over data 2 x tile 2 for
    GRID_CLI_ITERS iterations each on phase 14's prepared dataset.
    Returns (K1 launches, K2 launches, K2's largest abs error on the band
    inputs) of the spawn's ranks."""
    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.parallel import launch
    from gsplat_tpu_torch.train import trainer
    from gsplat_tpu_torch.train.__main__ import main as train_main

    t0 = time.perf_counter()
    res = launch(gauss_rank, GRID_DATA * GRID_TILE, backend="gloo",
                 args=(card,))
    k1 = sum(c[0] for c in res["counts"])
    k2 = sum(c[1] for c in res["counts"])
    print(f"[{card}] 16 launches per rank (K1, K2): {res['counts']}; the "
          f"spawn took {time.perf_counter() - t0:.1f} s", flush=True)
    if not all(c[0] > 0 and c[1] > 0 for c in res["counts"]):
        raise SystemExit("FAIL: 16 a rank launched no K1 or no K2")
    pool = gt.restore_pool(CKPT, device="cuda")
    state = trainer.load_checkpoint_dcp(
        GAUSS_DCP_DIR, gt.init_train_state(pool, gt.TrainConfig(
            capacity=pool.capacity)))
    got = _state_digest(state) + str(int(state.pool.num_alive()))
    print(f"[{card}] 16c save_checkpoint_dcp by the data 2 x tile 2 shards, "
          f"load_checkpoint_dcp in this process: bit-identical to the "
          f"gathered state: {got == res['digest']}", flush=True)
    if got != res["digest"]:
        raise SystemExit("FAIL: 16c the DCP checkpoint")
    shutil.rmtree(GAUSS_DCP_DIR, ignore_errors=True)
    for extra in ([], ["--ring"]):
        out = os.path.join(DATA_DIR, "out_gauss")
        t1 = time.perf_counter()
        _, report = train_main([
            "--data_dir", os.path.join(DATA_DIR, "prepared"), "--output_dir",
            out, "--scale_factor", "0.5", "--batch_size", str(TRAIN_BATCH),
            "--capacity", "131072", "--max_pairs", str(SCENE_PAIRS),
            "--holdout_every", "8", "--iterations", str(GRID_CLI_ITERS),
            "--log_every", "5", "--checkpoint_interval", str(10**9),
            "--mesh_data", str(GRID_DATA), "--mesh_tile", str(GRID_TILE),
            "--dist_backend", "gloo", "--gauss_sharded"] + extra)
        losses = [v for _, v in report.losses]
        done = os.path.exists(os.path.join(out, "checkpoint_final.npz"))
        print(f"[{card}] 16d python -m gsplat_tpu_torch.train --mesh_data "
              f"{GRID_DATA} --mesh_tile {GRID_TILE} --dist_backend gloo "
              f"--gauss_sharded {' '.join(extra)}, {GRID_CLI_ITERS} "
              f"iterations: losses " + ", ".join(
                  f"{it}: {v:.6f}" for it, v in report.losses)
              + f"; final checkpoint written: {done}; "
              f"{time.perf_counter() - t1:.1f} s (its ranks' launches stay "
              f"in the CLI's own processes)", flush=True)
        if not (report.iterations == GRID_CLI_ITERS
                and all(np.isfinite(losses)) and report.nonfinite_steps == 0
                and done):
            raise SystemExit("FAIL: 16d train CLI --gauss_sharded")
        shutil.rmtree(out, ignore_errors=True)
    return k1, k2, res["k2_err"]


# --------------------------------------------------------------------------
# Phase 17: the bench asset's recipe (python -m
# gsplat_tpu_torch.make_bench_asset) trained in full on the card and held
# against the JAX package's asset, bench_assets/trained_ckpt.npz.
# --------------------------------------------------------------------------

# The port's asset may score at most this many dB below the JAX asset on
# the recipe's ground-truth views.
ASSET_PSNR_SLACK = 0.5
# The port's asset scored again after the strip must give main()'s own
# PSNR: the same pool on the same views.
ASSET_RESCORE_TOL = 1e-4


def _recipe_flag(name):
    from gsplat_tpu_torch.make_bench_asset import RECIPE_FLAGS

    return int(RECIPE_FLAGS[RECIPE_FLAGS.index(f"--{name}") + 1])


def _serve_asset(pool, fx, fy, cx, cy, cfg):
    """Phase 5's serving of ``pool`` from its own bench pose: the bench pose
    plus an 8-frame orbit at orbit_scale 4.4 through make_render_fn and
    render_trajectory. Returns (stats, the bench pose's serving_path)."""
    from gsplat_tpu_torch.viewer import (create_orbit_trajectory,
                                         make_render_fn, render_trajectory)

    c2w, center, radius = bench_pose(pool)
    traj = np.concatenate([c2w[None], create_orbit_trajectory(
        center, radius * 4.4, num_frames=8, elevation_deg=15.0)])
    render_fn = make_render_fn(pool.params, cfg, fx, fy, cx, cy,
                               alive=pool.alive, report_demand=True)
    _, stats = render_trajectory(render_fn, traj, keep_frames=False,
                                 pair_capacity=cfg.max_pairs)
    sp = serving_path(pool.params, c2w, fx, fy, cx, cy, cfg, alive=pool.alive)
    return stats, sp


def _asset_k1(sp, cfg):
    """K1 at an asset's bench pose: (composited blocks, ms by CUDA events
    over 20 launches)."""
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs

    pf, b = sp["pair_feat"], sp["bin"]
    ts, tc = b.tile_start, b.tile_count
    out = composite_pairs(pf, ts, tc, cfg)
    blocks = int(torch.where(tc > 0, out[:, 5, 0], 0.0).sum())
    for _ in range(3):
        composite_pairs(pf, ts, tc, cfg)
    torch.cuda.synchronize()
    return blocks, device_ms(lambda: composite_pairs(pf, ts, tc, cfg), 20)


def asset_phase(jax_pairs, fx, fy, cx, cy, card):
    """Phase 17: ``make_bench_asset.main`` with the recipe unchanged (800
    iterations, capacity 131,072, 120,000 GT gaussians in 400 clusters,
    960x540, 16 views, max_pairs 2**21), workdir and asset in a temporary
    directory. Gates: the asset's keys, shapes and dtypes equal the JAX
    asset's, __step__ the iterations, no optimizer leaves; restore_pool
    reads it on the card equal to fit()'s final pool; K1 and K2 launched
    as the recipe's steps, GT renders and evaluation ask; a finite final
    loss; on the recipe's ground-truth views the port's asset within
    ASSET_PSNR_SLACK dB of the JAX asset's PSNR (or above it) and equal to
    main()'s own score; the memory model within MEMORY_TOL of the run's
    own peak. Printed: growth events, overflow and skipped steps, ADC ms
    per call, wall time and steps/s, the GT views' pair demand, and for
    both assets at their 1080p bench poses the pair demand (the JAX
    asset's must be phase 4's), K1's composited blocks and time and the
    served frame's median. Returns (K1 launches, K2 launches) of the
    phase's counted runs (the recipe, the evaluations and the serving)."""
    import importlib
    import tempfile

    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch import make_bench_asset, train_synthetic
    from gsplat_tpu_torch.evaluation import evaluate_views
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs
    from gsplat_tpu_torch.utils.memory import estimate_train_memory

    fit_mod = importlib.import_module("gsplat_tpu_torch.train.fit")
    iters, n_views = _recipe_flag("iterations"), _recipe_flag("views")
    got = {"max_pairs": [], "adc": [], "lines": []}
    real = (fit_mod.fit, fit_mod.make_train_step, fit_mod.adc_step,
            fit_mod.adc_step_paper, train_synthetic.gt_views)

    def tee(msg):
        got["lines"].append(msg)
        print(f"  [17 fit] {msg}", flush=True)

    def fit(dataset, cfg, tcfg, **kw):
        got["tcfg"] = tcfg
        got["state"], got["report"] = real[0](dataset, cfg, tcfg,
                                              **dict(kw, log_fn=tee))
        return got["state"], got["report"]

    def make(render_cfg, train_cfg):
        got["max_pairs"].append(render_cfg.max_pairs)
        return real[1](render_cfg, train_cfg)

    def adc(fn):
        def timed(state, *args, **kw):
            cap = state.pool.capacity
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, res = fn(state, *args, **kw)
            ev[1].record()
            got["adc"].append((int(state.step), cap, ev, res))
            return state, res
        return timed

    def views_of(gt_params, n, cfg):
        got["gt_params"], got["cfg"] = gt_params, cfg
        got["views"] = real[4](gt_params, n, cfg)
        return got["views"]

    (fit_mod.fit, fit_mod.make_train_step, fit_mod.adc_step,
     fit_mod.adc_step_paper, train_synthetic.gt_views) = (
        fit, make, adc(real[2]), adc(real[3]), views_of)
    # Removed when the phase ends, or at exit if a gate fails.
    tmpdir = tempfile.TemporaryDirectory(prefix="gsplat_asset_")
    tmp = tmpdir.name
    out = os.path.join(tmp, "trained_ckpt_torch.npz")
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    composite_pairs.launches = composite_pairs.bwd_launches = 0
    t0 = time.perf_counter()
    try:
        res = make_bench_asset.main([os.path.join(tmp, "run"), "--out", out])
    finally:
        (fit_mod.fit, fit_mod.make_train_step, fit_mod.adc_step,
         fit_mod.adc_step_paper, train_synthetic.gt_views) = real
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_k1, build_k2 = composite_pairs.launches, composite_pairs.bwd_launches
    state, report, tcfg = got["state"], got["report"], got["tcfg"]
    vcfg, views = got["cfg"], got["views"]
    final_cfg = vcfg.with_(max_pairs=got["max_pairs"][-1])
    grow_pool = sum("growing pool capacity" in m for m in got["lines"])
    grow_pairs = sum("growing max_pairs" in m for m in got["lines"])
    print(f"[{card}] 17 python -m gsplat_tpu_torch.make_bench_asset (the "
          f"recipe of scripts/make_bench_asset.sh): {report.iterations} "
          f"iterations in {build_s:.1f} s (fit() {report.wall_time_s:.1f} s, "
          f"{res['steps_per_s']:.3f} steps/s); final loss "
          f"{report.final_loss:.6f}; nonfinite steps "
          f"{report.nonfinite_steps}; overflow events "
          f"{report.overflow_events}; growth events: pool {grow_pool} "
          f"(capacity {tcfg.capacity} -> {state.pool.capacity}), max_pairs "
          f"{grow_pairs} ({got['max_pairs'][0]} -> {got['max_pairs'][-1]}); "
          f"K1 launches {build_k1}, K2 {build_k2}", flush=True)
    for it, cap, ev, r in got["adc"]:
        print(f"  [{card}] 17 densification at step {it}: pruned "
              f"{int(r.num_pruned)}, split {int(r.num_split)}, cloned "
              f"{int(r.num_cloned)}, overflowed {int(r.num_overflowed)} "
              f"(capacity {cap}); {ev[0].elapsed_time(ev[1]):.3f} ms (CUDA "
              f"events around the ADC call)", flush=True)
    memory_line(card, f"17 the recipe's fit() (its step at capacity "
                f"{state.pool.capacity}, max_pairs {final_cfg.max_pairs}; "
                f"the GT scene and the evaluation counted as the run's)",
                other, estimate_train_memory(final_cfg, dataclasses.replace(
                    tcfg, capacity=state.pool.capacity)), gate=True)
    if not (np.isfinite(report.final_loss) and report.iterations == iters
            and build_k2 == iters and build_k1 == iters + 2 * n_views):
        raise SystemExit(f"FAIL: 17 the recipe's run: final loss "
                         f"{report.final_loss}, {report.iterations} "
                         f"iterations, K1 {build_k1}, K2 {build_k2}")

    # The file: the JAX asset's layout, read on the card as fit() left it.
    with np.load(CKPT) as j, np.load(out) as f:
        want = {k: (j[k].shape, str(j[k].dtype)) for k in j.files}
        have = {k: (f[k].shape, str(f[k].dtype)) for k in f.files}
        step, n_opt = int(f["__step__"]), int(f["__num_opt_leaves__"])
        jax_alive = int(j["__alive__"].sum())
    port = gt.restore_pool(out, device="cuda")
    same = (torch.equal(port.alive, state.pool.alive)
            and all(torch.equal(port.params[k], state.pool.params[k])
                    for k in PARAM_KEYS))
    print(f"[{card}] 17 the asset: keys, shapes and dtypes equal the JAX "
          f"asset's: {want == have}; __step__ {step}, __num_opt_leaves__ "
          f"{n_opt}; restore_pool on the card equals fit()'s final pool: "
          f"{same}; alive {res['alive']} of {port.capacity} (the JAX "
          f"asset's {jax_alive})", flush=True)
    if want != have:
        print(f"  JAX asset {want}\n  port asset {have}", flush=True)
    if not (want == have and step == iters and n_opt == 0 and same):
        raise SystemExit("FAIL: 17 the asset's file")
    tmpdir.cleanup()
    gt_params = got["gt_params"]
    del got, state

    # Quality on the recipe's views: both assets, and the GT scene against
    # its own views (its demand; an overflow of the GT render at the
    # recipe's max_pairs, which does not grow, would show as a finite
    # score where the auto-sized re-render differs).
    composite_pairs.launches = composite_pairs.bwd_launches = 0
    jax_asset = gt.restore_pool(CKPT, device="cuda")
    assets = {"port": port, "jax": jax_asset}
    ev = {name: evaluate_views(p.params, views, vcfg, alive=p.alive)
          for name, p in assets.items()}
    ev["gt"] = evaluate_views(gt_params, views, vcfg)
    del gt_params
    for name, e in ev.items():
        print(f"[{card}] 17 {name} on the recipe's {e['num_views']} GT views "
              f"at {vcfg.width}x{vcfg.height}: PSNR {e['psnr']:.4f} dB, SSIM "
              f"{e['ssim']:.4f}, L1 {e['l1']:.6f}; largest pair demand "
              f"{e['max_pair_demand']} (max_pairs {vcfg.max_pairs}, "
              f"evaluated at {e['eval_max_pairs']})", flush=True)
    gap = ev["port"]["psnr"] - ev["jax"]["psnr"]
    rescore = abs(ev["port"]["psnr"] - res["psnr"])
    print(f"[{card}] 17 PSNR port - JAX asset {gap:+.4f} dB (gate >= "
          f"-{ASSET_PSNR_SLACK}); the port's asset rescored against main()'s "
          f"{res['psnr']:.4f} dB: {rescore:.2e} dB (gate "
          f"{ASSET_RESCORE_TOL}); the GT render's demand "
          f"{ev['gt']['max_pair_demand']} against its max_pairs "
          f"{vcfg.max_pairs} (it does not grow): overflow "
          f"{ev['gt']['max_pair_demand'] > vcfg.max_pairs}", flush=True)
    if gap < -ASSET_PSNR_SLACK or rescore > ASSET_RESCORE_TOL:
        raise SystemExit("FAIL: 17 the port's asset against the JAX asset")

    # Both assets at their own 1080p bench poses: the same camera rule on
    # each asset's alive positions, so the cameras differ slightly.
    cfg = gt.RenderConfig(height=H, width=W, max_pairs=MAX_PAIRS)
    served = {name: _serve_asset(p, fx, fy, cx, cy, cfg)
              for name, p in assets.items()}
    k1, k2 = composite_pairs.launches, composite_pairs.bwd_launches
    for name, (stats, sp) in served.items():
        pairs = int(sp["bin"].num_pairs)
        blocks, ms = _asset_k1(sp, cfg)
        print(f"[{card}] 17 {name} asset at its 1080p bench pose: "
              f"{pairs} pairs (max_pairs {cfg.max_pairs}), K1 {blocks} "
              f"composited blocks, {ms:.4f} ms (CUDA events, 20 launches); "
              f"served frames over the pose and the 8-frame orbit: median "
              f"{stats['median_ms']:.3f} ms, mean {stats['mean_ms']:.3f}, "
              f"pipelined {stats['pipelined_ms']:.3f} ms/frame, overflow "
              f"frames {stats['pair_overflow_frames']}", flush=True)
        if name == "jax" and pairs != jax_pairs:
            raise SystemExit(f"FAIL: 17 the JAX asset's bench-pose demand "
                             f"{pairs}, not phase 4's {jax_pairs}")
    return build_k1 + k1, build_k2 + k2


# --------------------------------------------------------------------------
# Phase 18: the bench, python -m gsplat_tpu_torch.bench, in process.
# --------------------------------------------------------------------------

BENCH_ARGV = ["--ellipse-ab"]  # full width: 1080p, 2**17 gaussians, 20 iters
BENCH_TRUNC_TOL = 2e-5  # the truncated frame against the exact one
# The TPU v5e's readings of the bench's integer keys (BENCH_r05.json), the
# counts printed beside the card's.
BENCH_TPU_COUNTS = ("pairs", "max_tile_count", "trained_ckpt_bwd_demand",
                    "train_bwd_demand", "trained_ckpt_sized_capacity",
                    "trained_ckpt_trunc_capacity")


def bench_keys(ellipse_ab: bool) -> set:
    """The keys bench.py prints on the same flags (BENCH_r05.json's), less
    the original reference's pixel_grad_* (not ported), plus the ellipse
    A/B's three with ``ellipse_ab``."""
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        keys = {k for k in json.load(f)["parsed"]
                if not k.startswith("pixel_grad_")}
    if ellipse_ab:
        keys |= {"fps_trained_ckpt_ellipse", "trained_ckpt_pairs_ellipse",
                 "trained_ckpt_ellipse_img_err"}
    return keys


def bench_phase(jax_pairs, lever, ell_pairs, card):
    """Phase 18: ``bench.main(BENCH_ARGV)`` in process with the launch
    counts set to 0 just before it (its isolated child is another process,
    whose launches are not counted). Gates: the last printed line is one
    JSON object with bench.py's metric and keys (bench_keys), no *_error
    key and no NaN; the checkpoint's pair demand equal to phase 4's and
    within its capacity; the culled demand and kept pairs equal to phase
    11b's (the same tile_rank_cap and cull_chunks; the bench sizes
    max_pairs to the culled demand where 11b keeps 2**22, and no list
    overflows in either); the ellipse demand equal to phase 15a's and its
    image error 0; the truncated image within BENCH_TRUNC_TOL of the exact
    one; K1, K2 and K2 in compact mode launched. Prints the line, each
    integer key beside the TPU's, the agreement of the two fwd+bwd
    readings and the seconds. Returns the (K1, K2, compact K2) launches."""
    import contextlib
    import io
    import math

    from gsplat_tpu_torch import bench
    from gsplat_tpu_torch.ops.raster_cuda import composite_pairs as cp

    _zero_counts()
    cp.bwd_compact_launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        bench.main(BENCH_ARGV)
    secs = time.perf_counter() - t0
    k1, k2, kc = cp.launches, cp.bwd_launches, cp.bwd_compact_launches
    out = buf.getvalue().strip().splitlines()
    print(f"[{card}] 18 python -m gsplat_tpu_torch.bench "
          f"{' '.join(BENCH_ARGV)}: {out[-1] if out else '(no line)'}",
          flush=True)
    line = json.loads(out[-1])
    if not (isinstance(line, dict)
            and line.get("metric") == "render_fps_1080p_trained"):
        raise SystemExit("FAIL: 18 the bench's last line")
    keys = bench_keys("--ellipse-ab" in BENCH_ARGV)
    errors = [k for k in line if k.endswith("_error")]
    nans = [k for k, v in line.items()
            if isinstance(v, float) and math.isnan(v)]
    if set(line) != keys or errors or nans:
        raise SystemExit(f"FAIL: 18 the bench's keys: missing "
                         f"{sorted(keys - set(line))}, extra "
                         f"{sorted(set(line) - keys)}, errors {errors}, NaN "
                         f"{nans}")
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        tpu = json.load(f)["parsed"]
    print(f"[{card}] 18 integer keys, this card (the TPU v5e's, "
          f"BENCH_r05.json): " + ", ".join(
              f"{k} {line[k]} ({tpu[k]})" for k in BENCH_TPU_COUNTS)
          + "; " + ", ".join(f"{k} {v}" for k, v in line.items()
                             if isinstance(v, int) and k not in
                             BENCH_TPU_COUNTS), flush=True)
    print(f"[{card}] 18 fwd+bwd in the bench "
          f"{line['fwd_bwd_fps_trained_ckpt_inbench']} /s, in a fresh "
          f"process {line['fwd_bwd_fps_trained_ckpt_isolated']} /s, "
          f"agreement {line['fwd_bwd_inbench_vs_isolated_agreement']}; "
          f"launches K1 {k1}, K2 {k2}, K2 compact {kc}; {secs:.1f} s",
          flush=True)
    checks = {
        "pairs equal phase 4's": line["trained_ckpt_pairs"] == jax_pairs,
        "pairs within capacity": line["trained_ckpt_pairs"]
        <= line["trained_ckpt_pair_capacity"],
        "culled demand equals 11b's":
            line["trained_ckpt_demand_culled"] == lever["demand"],
        "kept pairs equal 11b's":
            line["trained_ckpt_pairs_kept"] == lever["kept"],
        "ellipse demand equals 15a's":
            line["trained_ckpt_pairs_ellipse"] == ell_pairs,
        "ellipse image error 0": line["trained_ckpt_ellipse_img_err"] == 0,
        "truncated image error": line["trained_ckpt_trunc_img_err"]
        <= BENCH_TRUNC_TOL,
        "K1, K2 and compact K2 launched": k1 > 0 and k2 > 0 and kc > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"FAIL: 18 {failed} (phase 4 pairs {jax_pairs}, "
                         f"11b {lever}, 15a ellipse pairs {ell_pairs})")
    return k1, k2, kc


def main():
    # --- 1. card ---
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this smoke test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    card = device_label(torch.device("cuda"))
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    import gsplat_tpu_torch as gt
    from gsplat_tpu_torch.ops import _build
    from gsplat_tpu_torch.ops.raster_cuda import (_composite_fwd,
                                                  composite_pairs,
                                                  composite_pairs_bwd,
                                                  composite_pairs_bwd_plain,
                                                  composite_pairs_plain,
                                                  fwd_ctas_per_sm)
    from gsplat_tpu_torch.viewer import (create_orbit_trajectory,
                                         make_render_fn, render_trajectory)

    dev = gt.resolve_device("cuda")

    # --- 2. build from the checkout's sources ---
    shutil.rmtree(_build.BUILD_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[{card}] built {sorted(built)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, info in built.items():
        for line in info["ptxas"].splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "properties")):
                print(f"  {name} ptxas: {line.strip()}")
            spills = re.search(r"(\d+) bytes spill stores", line)
            if spills and int(spills.group(1)) > 0:
                raise SystemExit(f"FAIL: {name} spills registers: {line}")
    print("  raster_bwd dynamic shared memory: (10 + 2 warps x 10) x G x 4 B "
          "per CTA at tile 16 (15360 B at pair_block 128), (10 + 8 warps x "
          "10) x G x 4 B at tile 32 (184320 B at pair_block 512)")
    for tile, max_g in ((16, 512), (32, 512)):
        regs, smem = kernel_resources(built["raster_fwd"]["ptxas"],
                                      "raster_fwd_kernel", tile=tile,
                                      max_g=max_g)
        print(f"[{card}] raster_fwd<tile {tile}, G <= {max_g}>: {regs} "
              f"registers, {smem} B shared", flush=True)
    regs, _ = kernel_resources(built["raster_bwd"]["ptxas"],
                               "raster_bwd_kernel", tile=32)
    print(f"[{card}] raster_bwd<tile 32>: {regs} registers", flush=True)
    regs, smem = kernel_resources(built["raster_fwd"]["ptxas"],
                                  "raster_fwd_kernel")
    k1_res = (regs, smem, fwd_ctas_per_sm(dev))
    print(f"[{card}] raster_fwd (K1) design: 8x4-pixel warps, per-warp pair "
          f"cull, heavy tiles first; {regs} registers, {smem} B shared, "
          f"{k1_res[2]} CTAs of 256 threads per SM (occupancy API); since "
          f"its redesign {K1_RESOURCES[0]}, {K1_RESOURCES[1]} B, "
          f"{K1_RESOURCES[2]}", flush=True)
    if k1_res != K1_RESOURCES:
        raise SystemExit(f"FAIL: K1's resources moved: {k1_res}, not "
                         f"{K1_RESOURCES}")
    regs, smem = kernel_resources(built["raster_fwd"]["ptxas"],
                                  "raster_fwd_kernel", log=True)
    bregs = [kernel_resources(built["raster_bwd"]["ptxas"],
                              "raster_bwd_kernel", log)[0]
             for log in (False, True)]
    print(f"[{card}] the log transmittance: raster_fwd[log] {regs} "
          f"registers, {smem} B shared, {fwd_ctas_per_sm(dev, log=True)} "
          f"CTAs per SM; raster_bwd {bregs[0]} registers, raster_bwd[log] "
          f"{bregs[1]}", flush=True)
    errs, bwd_errs = [], []

    # --- 2b. the binning kernels against the plain steps ---
    bin_t, bin_err = binning_phase(dev, card)

    # --- 2c. Feature 3DGS's compositors, F1 and F2 ---
    feat = feat_phase(dev, card)

    # --- 3. kernel vs plain, synthetic scene ---
    cfg = gt.RenderConfig(height=H, width=W, max_pairs=MAX_PAIRS)
    fx = fy = 0.85 * W
    cx, cy = W / 2.0, H / 2.0
    scene, sc2w = make_scene(32768, seed=0)
    sparams = {k: torch.from_numpy(v).to(dev) for k, v in scene.items()}
    sp = serving_path(sparams, sc2w, fx, fy, cx, cy, cfg)
    pf, binning = sp["pair_feat"], sp["bin"]
    out_k = composite_pairs(pf, binning.tile_start, binning.tile_count, cfg)
    out_p, state_p = composite_pairs_plain(
        pf, binning.tile_start, binning.tile_count, cfg, tile_chunk=1024,
        with_state=True)
    torch.cuda.synchronize()
    print(f"synthetic: 32768 gaussians, {int(binning.num_pairs)} pairs")
    errs.append(compare("synthetic 1080p", out_k, out_p, binning.tile_count))
    check_cull("synthetic 1080p", pf, binning.tile_start, binning.tile_count,
               out_p, cfg)
    bwd_errs.append(check_bwd("synthetic 1080p", pf, binning, out_k, state_p,
                              cfg, seed=1))
    del state_p

    # --- 4. kernel vs plain, trained checkpoint at the bench pose ---
    pool = gt.restore_pool(CKPT, device="cuda")
    c2w, center, radius = bench_pose(pool)
    sp = serving_path(pool.params, c2w, fx, fy, cx, cy, cfg,
                      alive=pool.alive)
    pf, binning = sp["pair_feat"], sp["bin"]
    out_k = composite_pairs(pf, binning.tile_start, binning.tile_count, cfg)
    out_p, state_p = composite_pairs_plain(
        pf, binning.tile_start, binning.tile_count, cfg, tile_chunk=1024,
        with_state=True)
    torch.cuda.synchronize()
    n_pairs = int(binning.num_pairs)
    print(f"trained: {int(pool.alive.sum())} alive of {pool.capacity}, "
          f"{n_pairs} pairs of capacity {cfg.max_pairs}")
    errs.append(compare("trained 1080p bench pose", out_k, out_p,
                        binning.tile_count))
    bench_cull = check_cull("trained 1080p bench pose", pf,
                            binning.tile_start, binning.tile_count, out_p,
                            cfg)
    bench_reached = bench_cull["total"] - bench_cull["skipped"]
    bwd_errs.append(check_bwd("trained 1080p bench pose", pf, binning, out_k,
                              state_p, cfg, seed=2))
    del state_p
    plain_img = image_from_tiles(out_p, binning.tile_count, cfg)

    # --- 5. serving through the port's entry points ---
    traj = np.concatenate([
        c2w[None],
        create_orbit_trajectory(center, radius * 4.4, num_frames=8,
                                elevation_deg=15.0),
    ])
    render_fn = make_render_fn(pool.params, cfg, fx, fy, cx, cy,
                               alive=pool.alive, report_demand=True)
    calls = [0]
    served = {}

    def counted(pose):
        calls[0] += 1
        img, probe = render_fn(pose)
        served.setdefault("first", img)  # the warm-up frame: bench pose
        return img, probe

    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - tensor_bytes(pool.params,
                                                         pool.alive)
    torch.cuda.reset_peak_memory_stats()
    composite_pairs.launches = 0
    t0 = time.perf_counter()
    with BinCalls() as serve_bins:
        _, stats = render_trajectory(counted, traj, keep_frames=False,
                                     pair_capacity=cfg.max_pairs)
    serve_s = time.perf_counter() - t0
    launches = composite_pairs.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] served {len(traj)} poses (+1 warm-up, +{len(traj)} "
          f"pipelined) in {serve_s:.2f} s; render_fn calls {calls[0]}, "
          f"kernel launches {launches}; peak device memory {peak_gib:.2f} "
          f"GiB")
    from gsplat_tpu_torch.utils.memory import estimate_render_memory

    memory_line(card, "serving at 1080p (the pool counted as the run's)",
                other, estimate_render_memory(cfg, pool.capacity),
                gate=True)
    for i, (ms, npairs, mean) in enumerate(zip(
            stats["frame_ms"], stats["frame_pairs"], stats["frame_mean"])):
        print(f"  [{card}] frame {i}: {ms:.3f} ms (host clock to "
              f"synchronize), pairs {npairs} of {cfg.max_pairs}, overflow "
              f"{npairs > cfg.max_pairs}, image mean {mean:.6f}")
    print(f"  [{card}] mean {stats['mean_ms']:.3f} ms, median "
          f"{stats['median_ms']:.3f} ms, pipelined "
          f"{stats['pipelined_ms']:.3f} ms/frame, overflow frames "
          f"{stats['pair_overflow_frames']}", flush=True)
    if launches != calls[0] or launches < len(traj):
        raise SystemExit(f"FAIL: {launches} kernel launches for {calls[0]} "
                         f"rendered frames")
    serve_bin_n = serve_bins.check(card, f"served {len(traj)} poses")
    if serve_bins.calls < calls[0]:
        raise SystemExit("FAIL: a served frame was not binned")
    img = served["first"]
    if tuple(img.shape) != (H, W, 3) or not bool(torch.isfinite(img).all()):
        raise SystemExit(f"FAIL: served frame {tuple(img.shape)} not finite")
    img_err = float((img - plain_img).abs().max())
    print(f"served bench-pose frame vs plain-compositor image: max abs "
          f"{img_err:.3e}, mean {float(img.mean()):.6f}")
    if img_err > TOL or not 0.0 < float(img.mean()) < 1.0:
        raise SystemExit("FAIL: served frame disagrees with the plain image")

    # --- 6. timing at the bench pose (launches here are not counted) ---
    tc, ts = binning.tile_count, binning.tile_start
    for _ in range(3):
        composite_pairs(pf, ts, tc, cfg)
    torch.cuda.synchronize()
    kernel_ms = device_ms(lambda: composite_pairs(pf, ts, tc, cfg), 20)
    state_ms = device_ms(
        lambda: _composite_fwd(pf, ts, tc, cfg, with_state=True), 20)
    kernel_ms2 = device_ms(lambda: composite_pairs(pf, ts, tc, cfg), 20)
    composite_pairs_plain(pf, ts, tc, cfg, tile_chunk=1024)
    plain_ms = device_ms(
        lambda: composite_pairs_plain(pf, ts, tc, cfg, tile_chunk=1024), 2)
    G, P = cfg.pair_block, cfg.tile * cfg.tile
    blocks = int(torch.where(tc > 0, out_k[:, 5, 0], 0.0).sum())
    # The reached (pair, pixel) and the cull's own operations, against the
    # bytes; the TPU kernel's work (every (pair, pixel) of a composited
    # block) beside it, which the bound counted before K1 had its cull.
    k1_bound_ms, k1_bound_by = bound_ms("full", blocks, cfg, bench_reached)
    tpu_bound_ms, tpu_bound_by = bound_ms("full", blocks, cfg)
    per_frame = launches / calls[0]
    print(f"[{card}] raster_fwd at the bench pose: {kernel_ms:.4f} ms "
          f"(CUDA events, 20 launches; again after the state timing "
          f"{kernel_ms2:.4f} ms; writing the block-start state, as autograd "
          f"asks, {state_ms:.4f} ms), plain {plain_ms:.3f} ms, "
          f"{per_frame:.0f} launch/frame; {blocks} active blocks of "
          f"{cfg.num_pair_blocks}; bound {k1_bound_ms:.4f} ms by "
          f"{k1_bound_by} ({bench_reached} of {bench_cull['total']} (pair, "
          f"warp) reached; share of bound {k1_bound_ms / kernel_ms:.3f}); "
          f"TPU work (every (pair, pixel)) {tpu_bound_ms:.4f} ms by "
          f"{tpu_bound_by}", flush=True)
    stages = stage_ms(pool.params, c2w, fx, fy, cx, cy, cfg, pool.alive)
    print(f"[{card}] stages of one bench-pose frame (CUDA events, median "
          f"of 5): " + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()),
          flush=True)

    # --- 7. fwd+bwd at 1080p at the bench pose ---
    gparams, seen = fwd_bwd_phase(pool, c2w, fx, fy, cx, cy, cfg, card)
    parts = bwd_parts_ms(gparams, c2w, fx, fy, cx, cy, cfg, pool.alive, seen)
    print(f"[{card}] backward parts at the bench pose (CUDA events, median "
          f"of 5): " + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items()),
          flush=True)
    del gparams

    # --- 8. training through the port's entry points ---
    train_k1, train_k2, train_ms, trained, train_bin_n = train_phase(
        pool, c2w, center, radius, card)
    # The comm model, fed this card's step per view (no card beyond it).
    from gsplat_tpu_torch import comm_model

    print(f"[{card}] the comm model (python -m gsplat_tpu_torch.comm_model) "
          f"with this run's step, {train_ms / TRAIN_BATCH:.3f} ms a view "
          f"at {TRAIN_W}x{TRAIN_H}; NVLink 4, PCIe Gen5 and NDR rates are "
          f"NVIDIA's published figures; NCCL on several cards has not run:",
          flush=True)
    comm_model.main(["--step_ms_per_view", str(train_ms / TRAIN_BATCH),
                     "--height", str(TRAIN_H), "--width", str(TRAIN_W),
                     "--batch", str(2 * TRAIN_BATCH)])

    # --- 8b. fit(): density control, checkpoints, growth ---
    fit_k1, fit_k2 = fit_phase(pool, c2w, center, radius, card)

    # --- 9. K2 timing at the bench pose (launches here are not counted) ---
    # (pair_feat, tile_start, tile_count, out, state, gout, cfg)
    bargs = seen["args"]
    for _ in range(3):
        composite_pairs_bwd(*bargs)
    torch.cuda.synchronize()
    bwd_ms = device_ms(lambda: composite_pairs_bwd(*bargs), 20)
    ctas = composite_pairs.bwd_ctas
    composite_pairs_bwd_plain(*bargs, block_chunk=256)
    bwd_plain_ms = device_ms(
        lambda: composite_pairs_bwd_plain(*bargs, block_chunk=256), 2)
    bwd_bound_ms, bwd_bound_by, bops, bbytes, bblocks = bwd_bound(
        bargs, cfg, OPS_BWD_PER_PAIR_PIXEL)
    print(f"[{card}] raster_bwd at the bench pose: {bwd_ms:.4f} ms (CUDA "
          f"events, 20 launches), plain {bwd_plain_ms:.3f} ms, "
          f"{train_k2 // (TRAIN_BATCH * TRAIN_STEPS)} launch/view in "
          f"training (K1 {train_k1}, K2 {train_k2} over {TRAIN_STEPS} steps "
          f"of {TRAIN_BATCH} views); {bblocks} active blocks; bound "
          f"{bwd_bound_ms:.4f} ms by {bwd_bound_by} ({bops:.3e} ops, "
          f"{bbytes:.3e} bytes)", flush=True)
    n_blocks = bargs[0].shape[1] // G
    state = bargs[4]
    print(f"[{card}] raster_bwd design: 4 pixels per thread (64 threads "
          f"per CTA), {bregs[0]} registers, a "
          f"persistent grid of {ctas} CTAs over the {bblocks} composited "
          f"blocks of {n_blocks}; block-start state {state.numel() * 4} B "
          f"allocated, {bblocks * 5 * P * 4} B written by K1; share of bound "
          f"{bwd_bound_ms / bwd_ms:.3f}", flush=True)

    # --- 10. the compositor-ablation profiler (K3) ---
    abl_errs, abl_plain_ms, prof, prof_counts, prof_cull = ablation_phase(
        card, dev)
    print(f"[{card}] K1's cull skips "
          f"{bench_cull['skipped'] / bench_cull['total']:.4f} of the (pair, "
          f"warp) of the composited blocks at the bench pose, "
          f"{prof_cull:.4f} on the profiler workload", flush=True)
    errs.append(abl_errs["full"])

    # --- 11. the serving levers ---
    instr = transcendental_instructions()
    print(f"[{card}] SASS instructions with the kernels' flags (cuobjdump of "
          f"probe kernels): expf {instr['expf']}, log1pf {instr['log1pf']}",
          flush=True)
    log_entries = log_phase(pool, c2w, traj, fx, fy, cx, cy, cfg, pf,
                            binning, plain_img, card, instr)
    trunc_k1, trunc_k2, lever = trunc_phase(pool, c2w, traj, fx, fy, cx,
                                            cy, cfg, served["first"], card)
    bucket_k1, close = bucket_phase(pool, fx, fy, cx, cy, cfg, center,
                                    radius, card)

    # --- 12. the training levers ---
    train_cfg, tbatch, tstart = train_views(pool, c2w, center, radius)
    b_err, b_bwd_err = levers_batch_phase(pool, tbatch, train_cfg, card)
    errs.append(b_err)
    bwd_errs.append(b_bwd_err)
    comp = levers_compact_phase(pool, c2w, fx, fy, cx, cy, cfg, tbatch,
                                train_cfg, bargs, binning.pair_slot, card)
    lever_n = levers_train_phase(pool, tbatch, tstart, train_cfg,
                                 comp["batch_bwd_pairs"], train_ms, card)
    fit_n = levers_fit_phase(pool, tbatch, tstart, train_cfg, card)
    serve_k1 = levers_serve_phase(pool, traj, fx, fy, cx, cy, cfg,
                                  served["first"], stats, card)

    # --- 13. the XLA compositor, evaluation and the measuring tools ---
    t13 = time.perf_counter()
    xla_n = xla_phase(pool, c2w, fx, fy, cx, cy, cfg, served["first"],
                      close, card)
    eval_k1 = eval_phase(pool, trained, tbatch, train_cfg, tstart, card)
    trace_n = trace_phase(pool, c2w, fx, fy, cx, cy, cfg, card)
    tools_n = tools_phase(pool, c2w, fx, fy, cx, cy, cfg, lever, card)[0]
    print(f"[{card}] phase 13 took {time.perf_counter() - t13:.1f} s",
          flush=True)

    # --- 14. the dataset flow, and K1/K2 at tile 32 and pair_block 512 ---
    t14 = time.perf_counter()
    counts = dataset_phase(pool, center, radius, card)
    ranges = ranges_phase(sparams, sc2w, pool, c2w, fx, fy, cx, cy, card,
                          instr)
    print(f"[{card}] phase 14 took {time.perf_counter() - t14:.1f} s",
          flush=True)

    # --- 15. the ellipse cull, and the (data, tile) grid of gloo ranks ---
    t15 = time.perf_counter()
    ell = ellipse_phase(pool, c2w, traj, fx, fy, cx, cy, cfg, tbatch, tstart,
                        train_cfg, card)
    errs.append(ell["err"])
    bwd_errs.append(ell["bwd_err"])
    grid_k1, grid_k2 = grid_phase(card)
    print(f"[{card}] phase 15 took {time.perf_counter() - t15:.1f} s; its "
          f"launches: K1 {ell['k1']} (15a) + {grid_k1} (15b), K2 "
          f"{ell['k2']} + {grid_k2}", flush=True)

    # --- 16. the gaussian-sharded step over the grid ---
    t16 = time.perf_counter()
    gauss_k1, gauss_k2, gauss_err = gauss_phase(card)
    bwd_errs.append(gauss_err)
    print(f"[{card}] phase 16 took {time.perf_counter() - t16:.1f} s; its "
          f"launches: K1 {gauss_k1}, K2 {gauss_k2}", flush=True)

    # --- 17. the bench asset's recipe in full, against the JAX asset ---
    t17 = time.perf_counter()
    asset_k1, asset_k2 = asset_phase(n_pairs, fx, fy, cx, cy, card)
    print(f"[{card}] phase 17 took {time.perf_counter() - t17:.1f} s; its "
          f"launches: K1 {asset_k1}, K2 {asset_k2}", flush=True)

    # --- 18. the bench, python -m gsplat_tpu_torch.bench ---
    bench_k1, bench_k2, bench_kc = bench_phase(n_pairs, lever, ell["pairs"],
                                               card)

    # --- 19. result lines ---
    kernels = [{
        "name": "raster_fwd",
        "route": "cuda",
        "source": "gsplat_tpu_torch/ops/csrc/raster_fwd.cu",
        "replaces": "gsplat_tpu/ops/raster_pallas.py:192",
        "launches": launches + fit_k1 + trunc_k1 + bucket_k1
        + lever_n["launches"] + fit_n["launches"] + serve_k1
        + xla_n[0] + eval_k1 + trace_n[0] + tools_n[0] + counts["b"][0]
        + counts["d"][0] + ell["k1"] + grid_k1 + gauss_k1 + asset_k1
        + bench_k1,
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound_ms,
        "bound_by": k1_bound_by,
        "library_ms": None,
    }, {
        "name": "raster_bwd",
        "route": "cuda",
        "source": "gsplat_tpu_torch/ops/csrc/raster_bwd.cu",
        "replaces": "gsplat_tpu/ops/raster_pallas.py:243",
        "launches": train_k2 + fit_k2 + trunc_k2 + lever_n["bwd_launches"]
        + xla_n[1] + trace_n[1] + tools_n[1] + counts["b"][1] + ell["k2"]
        + grid_k2 + gauss_k2 + asset_k2 + bench_k2,
        "max_abs_err": max(bwd_errs),
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "library_ms": None,
    }, {
        "name": "raster_bwd[compact]",
        "route": "cuda",
        "source": "gsplat_tpu_torch/ops/csrc/raster_bwd.cu",
        "replaces": "gsplat_tpu/ops/raster_pallas.py:243 (over the "
                    "compacted block list of rasterize.py:331)",
        "launches": lever_n["bwd_compact_launches"]
        + fit_n["bwd_compact_launches"] + bench_kc,
        "max_abs_err": comp["err"],
        "ms": comp["ms"],
        "plain_ms": comp["plain_ms"],
        "bound_ms": comp["bound"],
        "bound_by": comp["by"],
        "library_ms": None,
    }] + log_entries
    kernels += [{
        "name": f"raster_ablate[{v}]",
        "route": "cuda",
        "source": "gsplat_tpu_torch/ops/csrc/raster_ablate.cu",
        "replaces": ABLATION_REPLACES[v],
        "launches": prof_counts[v],
        "max_abs_err": abl_errs[v],
        "ms": prof[v]["ms"],
        "plain_ms": abl_plain_ms[v],
        "bound_ms": prof[v]["bound_ms"],
        "bound_by": prof[v]["bound_by"],
        "library_ms": None,
    } for v in ABLATION_REPLACES]
    kernels += range_entries(ranges, counts)
    kernels += [{
        "name": f"binning_{step}",
        "route": "cuda",
        "source": BINNING_SOURCE,
        "replaces": "none (the JAX package bins with XLA operations)",
        "launches": serve_bin_n[i] + train_bin_n[i],
        "max_abs_err": bin_err,
        "ms": bin_t[step]["ms"],
        "plain_ms": bin_t[step]["plain_ms"],
        "bound_ms": bin_t[step]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    } for i, step in enumerate(("emit", "sort", "align"))]
    kernels += [{
        "name": name,
        "route": "cuda",
        "source": "gsplat_tpu_torch/ops/csrc/raster_feat.cu",
        "replaces": "none (the JAX package has no per-gaussian features)",
        **feat[k],
        "library_ms": None,
    } for k, name in (("F1", "feat_fwd"), ("F2", "feat_bwd"))]
    print(json.dumps({"kernels": kernels}))
    print(device_label(dev))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
