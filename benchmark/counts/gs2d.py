"""Work counts of 2D Gaussian Splatting's layers (``models/gs2d.py``), on
top of 3DGS's (``counts/__init__.py``, whose peaks, per-gaussian counts
and loss counts they keep). Every count is a least amount of work the
step needs, from the reference's own counts at the cell's inputs
(``reference/gs2d.py``'s ``render(count_work=True)``: surfels in view,
pairs, live pairs, contributing pairs, composited (pair, pixel) with a
non-zero weight, pixels), so that no share of a roofline or peak can read
over 100 %. ``surfel_units`` is 1 a unit: its presence marks a surfel
cell's counts.

Term by term, per composited (pair, pixel):

* S1, 77 operations: the intersection (k and l: 6 multiplies, 6
  subtractions; their cross product: 6 multiplies, 3 subtractions; two
  divisions), ``rho3`` (3), the low-pass ``rho2`` (the offsets 2, 4 more),
  the minimum and the depth (5), ``-rho/2``, the exponential, the opacity,
  the clamp and the cutoff and near tests (6), the weight and the
  transmittance (4), the sums of rgb and normal (12), of depth and alpha
  (3), the mapped depth ``m`` (3), the distortion term and its sum (8),
  ``M1`` and ``M2`` (4).
* S2, 163 operations: the intersection, alpha, weight and ``m`` again
  (49), ``gw`` over the nine maps' cotangents (23), the running sum and
  ``gS`` (3), ``d alpha`` with its floor and gate (7), the opacity and
  ``rho`` partials (4), the depth partial (9), the intersection's partials
  (``s``: 8; ``p``: 7; ``k`` and ``l``: 18), the 18 gradient terms (24)
  and their sum over the tile's pixels (18 adds, one a term, counted a
  (pair, pixel)).
* Bytes: each live pair's geometry read (``T`` 9, ``c`` 2, opacity: 12
  floats), each contributing pair's rgb and normal (6); S1 writes 12
  floats a pixel; S2 reads them and 9 cotangents a pixel and writes the
  contributing pairs' 18 gradients.
* The loss: 3DGS's L1 and SSIM (``counts.step_work``) and the geometric
  terms, ``GEO_OPS_PER_PIXEL`` a pixel forward and three times that
  backward (the expected depth, the unprojection, two differences, the
  cross product, the normalisation and the dot product).
* Adam over 58 floats a slot (pos 3, scale 2, rotation 4, opacity 1, SH
  48).
"""

from __future__ import annotations

from benchmark.counts import (ADAM_ACCESSES, ADAM_OPS_PER_PARAM, F32,
                              OPS_BWD_PER_GAUSSIAN, OPS_FWD_PER_GAUSSIAN,
                              SSIM_STATS, SSIM_TAPS)

OPS_S1_PER_PAIR_PIXEL = 77
OPS_S2_PER_PAIR_PIXEL = 163
GEO_OPS_PER_PIXEL = 40
PARAMS_PER_SURFEL = 58
GEOMETRY_PER_PAIR = 12  # T 9, c 2, opacity
SHADE_PER_PAIR = 6  # rgb 3, normal 3
GRADS_PER_PAIR = 18
S1_OUT_PER_PIXEL = 12
S2_COTANGENTS_PER_PIXEL = 9


def s1_work(c: dict):
    """S1's least work over counts ``c``: (ops, bytes)."""
    ops = OPS_S1_PER_PAIR_PIXEL * c["pair_pixels"]
    nbytes = F32 * (GEOMETRY_PER_PAIR * c["live_pairs"]
                    + SHADE_PER_PAIR * c["contrib_pairs"]
                    + S1_OUT_PER_PIXEL * c["pixels"])
    return ops, nbytes


def s2_work(c: dict):
    """S2's least work: (ops, bytes)."""
    ops = OPS_S2_PER_PAIR_PIXEL * c["pair_pixels"]
    nbytes = F32 * (GEOMETRY_PER_PAIR * c["live_pairs"]
                    + (SHADE_PER_PAIR + GRADS_PER_PAIR) * c["contrib_pairs"]
                    + (S1_OUT_PER_PIXEL + S2_COTANGENTS_PER_PIXEL)
                    * c["pixels"])
    return ops, nbytes


def step_work_2d(c: dict):
    """A 2DGS training step of one view: the surfel transform and SH colour
    forward and backward over the surfels in view (3DGS's per-gaussian
    counts), S1, S2, the loss (3DGS's photometric terms and the geometric
    ones) and Adam over 58 floats a slot, every parameter read, its
    gradient written and Adam's accesses, the image and ground truth read
    and written once."""
    params = PARAMS_PER_SURFEL * c["slots"]
    loss_ops = (3 * (2 * SSIM_TAPS * SSIM_STATS * 3 * c["pixels"])
                + 4 * GEO_OPS_PER_PIXEL * c["pixels"])
    ops = ((OPS_FWD_PER_GAUSSIAN + OPS_BWD_PER_GAUSSIAN) * c["gaussians"]
           + s1_work(c)[0] + s2_work(c)[0] + loss_ops
           + ADAM_OPS_PER_PARAM * params)
    nbytes = F32 * (params + 3 * c["pixels"] + 3 * c["pixels"]
                    + params + ADAM_ACCESSES * params)
    return ops, nbytes
