"""The yardstick's work counts and the H100's published peaks.

Frozen copies, so that a later change to the program cannot move them:

* peaks: NVIDIA's H100 SXM data sheet (dense, no sparsity), as
  ``gsplat_tpu_torch/profile_kernel.py`` (``PEAK_F32_FLOPS``,
  ``PEAK_BYTES``) states them. None of the renderer's arithmetic runs on
  tensor cores, so its operations are held to the float32 rate;
* per composited (pair, pixel): 26 operations in the forward
  (``profile_kernel.OPS_PER_PAIR_PIXEL["full"]``) and 79 in the backward
  (``chip_smoke.py::OPS_BWD_PER_PAIR_PIXEL``), each counted from the
  compositing formula: du, dv, the quadratic form, exp, alpha, the weight,
  four channel sums and the transmittance (and in the backward every
  partial of them);
* per gaussian in view: the covariance, projection and degree-3 SH
  colour, counted from the reference's own expressions (``reference/
  render.py``: about 90, 165 and 150 operations), twice that backward.

The counts are of the work the frame needs, worked out by the reference
at the cell's inputs (``reference.render.render(count_work=True)``): the
gaussians in view; the (gaussian, tile) pairs of the rectangle rule that
are reached while some pixel of their tile is not yet saturated
(``live_pairs``: a compositor that stops at saturation needs no others),
and those of them with a non-zero weight at some pixel
(``contrib_pairs``); and the (pair, pixel) whose weight is not zero
(alpha at or above the cutoff, transmittance in front above
``transmittance_min``). A compositor reads the geometry (u, v, conic,
opacity: 6 floats) of every live pair to find its alpha, and the colour
and depth (4 floats) of the contributing ones only; the backward writes
the 10 gradients of the contributing ones (the others are zero). They do
not depend on how the program implements the frame.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

OPS_FWD_PER_PAIR_PIXEL = 26
OPS_BWD_PER_PAIR_PIXEL = 79
OPS_FWD_PER_GAUSSIAN = 400
OPS_BWD_PER_GAUSSIAN = 800
PARAMS_PER_GAUSSIAN = 59  # pos 3, scale 3, rotation 4, opacity 1, SH 48
FEATS_PER_PAIR = 10  # u, v, conic (3), opacity, rgb (3), depth
GEOMETRY_PER_PAIR = 6  # u, v, conic (3), opacity
FWD_OUT_PER_PIXEL = 5  # rgb, depth, transmittance
SSIM_STATS = 5  # mu1, mu2, E[p^2], E[t^2], E[pt]
SSIM_TAPS = 121  # 11 x 11 window
ADAM_ACCESSES = 7  # parameter, both moments read and written, gradient read
ADAM_OPS_PER_PARAM = 12
F32 = 4


def sol(ops: float, nbytes: float):
    """(speed-of-light seconds, the bound that binds: "operations" or
    "bytes") on one H100."""
    t_ops = ops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def k1_work(c: dict):
    """The forward compositor's least work over counts ``c``: (ops,
    bytes). Its inputs are the live pairs' geometry and the contributing
    pairs' colour and depth, its output the pixels' rgb, depth and
    transmittance."""
    ops = OPS_FWD_PER_PAIR_PIXEL * c["pair_pixels"]
    nbytes = F32 * (GEOMETRY_PER_PAIR * c["live_pairs"]
                    + (FEATS_PER_PAIR - GEOMETRY_PER_PAIR)
                    * c["contrib_pairs"] + FWD_OUT_PER_PIXEL * c["pixels"])
    return ops, nbytes


def k2_work(c: dict):
    """The backward compositor's: the live pairs' geometry, the
    contributing pairs' colour and depth, the forward's planes and the
    image gradient read, the contributing pairs' gradients written."""
    ops = OPS_BWD_PER_PAIR_PIXEL * c["pair_pixels"]
    nbytes = F32 * (GEOMETRY_PER_PAIR * c["live_pairs"]
                    + (2 * FEATS_PER_PAIR - GEOMETRY_PER_PAIR)
                    * c["contrib_pairs"]
                    + (FWD_OUT_PER_PIXEL + 4) * c["pixels"])
    return ops, nbytes


def frame_work(c: dict):
    """A served frame: every parameter read once, the image written once,
    the per-gaussian stages over the gaussians in view and the forward
    compositing."""
    ops = (OPS_FWD_PER_GAUSSIAN * c["gaussians"]
           + OPS_FWD_PER_PAIR_PIXEL * c["pair_pixels"])
    nbytes = F32 * (PARAMS_PER_GAUSSIAN * c["slots"] + 3 * c["pixels"])
    return ops, nbytes


def step_work(c: dict):
    """A training step of one view: the frame, the loss (L1 and the SSIM
    statistics' filter, three times over for its backward), the backward
    compositing and per-gaussian stages, and Adam over every parameter
    (``ADAM_ACCESSES`` float32 accesses each; the gradient is written
    once by the backward)."""
    params = PARAMS_PER_GAUSSIAN * c["slots"]
    loss_ops = 3 * (2 * SSIM_TAPS * SSIM_STATS * 3 * c["pixels"])
    ops = (OPS_FWD_PER_GAUSSIAN * c["gaussians"]
           + OPS_BWD_PER_GAUSSIAN * c["gaussians"]
           + (OPS_FWD_PER_PAIR_PIXEL + OPS_BWD_PER_PAIR_PIXEL)
           * c["pair_pixels"] + loss_ops + ADAM_OPS_PER_PARAM * params)
    nbytes = F32 * (params + 3 * c["pixels"] + 3 * c["pixels"]  # fwd, gt
                    + params + ADAM_ACCESSES * params)
    return ops, nbytes


def add(counts: list) -> dict:
    """The sum of several units' counts."""
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out
