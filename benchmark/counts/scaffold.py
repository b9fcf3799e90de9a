"""Work counts of Scaffold-GS's layers (``models/scaffold.py``), on top of
3DGS's (``counts/__init__.py``, whose peaks, compositor and loss counts
they keep). Every count is a least amount of work the step needs, from
the reference's own counts at the cell's inputs
(``reference/scaffold.py``'s ``render(count_work=True)``: the anchors,
the visible anchors, the kept slots, and ``render.py``'s neural gaussians
in view, pairs, live and contributing pairs, composited (pair, pixel) and
pixels), so that no share of a roofline or peak can read over 100 %.
``scaffold_units`` is 1 a unit: its presence marks a Scaffold-GS cell's
counts.

Term by term, at the published widths (feature 32, 10 slots, hidden 32;
input 35; heads of 10, 70 and 30 outputs):

* D1, per visible anchor: the three MLPs' products, 2 x (3 x 35 x 32 + 110
  x 32) = 13,760 operations, and ``D1_ACT_OPS`` more: the biases (96 +
  110), ReLU (96), the viewing direction (3 differences, 3 squares, 2
  sums, a root, 3 divisions: 12), the six exponentials, and per slot the
  tanh, the position (2 x 3), the scale (a sigmoid and a product, 2 x 3),
  the normalised rotation (4 squares, 3 sums, a root, a maximum, 4
  divisions: 13) and the colour's sigmoids (3): 320 + 10 x 29 = 610.
  Bytes: the anchor's 71 floats read, each of its slots' 14 floats and
  mask written, a mask byte written for each slot of an invisible anchor,
  and the 7,086 weights read once.
* D2, per visible anchor: the input-gradient and weight-gradient
  products, 2 x 13,760 (a recomputed forward is not counted: the work is
  the reference's, whatever implements it). Bytes: 14 gradient floats
  read for each kept slot, the anchor's 71 floats read and its 68
  gradient floats written (the positions take none), and the weights read
  and their gradients written once.
* The step (``step_work_scaffold``): D1 and D2; the covariance and
  projection of the neural gaussians in view, ``SLOT_FWD_OPS`` forward
  (3DGS's per-gaussian count less the SH colour) and twice that
  backward; K1 and K2 per composited (pair, pixel); 3DGS's loss (L1 and
  the SSIM statistics, three times over for the backward) and the scaling
  term (3 operations a kept slot, three times over); Adam over every
  trained float (the anchors' 68 and the MLPs' 7,086), ``ADAM_ACCESSES``
  float32 accesses each; the anchors' floats read by D1 and D2, the image
  and ground truth read and written once.
"""

from __future__ import annotations

from benchmark.counts import (ADAM_ACCESSES, ADAM_OPS_PER_PARAM, F32,
                              OPS_BWD_PER_PAIR_PIXEL, OPS_FWD_PER_PAIR_PIXEL,
                              SSIM_STATS, SSIM_TAPS)

K = 10  # slots an anchor
MLP_OPS = 2 * (3 * 35 * 32 + 110 * 32)  # 13,760
D1_ACT_OPS = 96 + 110 + 96 + 12 + 6 + K * (1 + 6 + 6 + 13 + 3)
D2_OPS = 2 * MLP_OPS
ANCHOR_FLOATS = 71  # pos 3, offsets 30, feature 32, scales 6
ANCHOR_GRADS = 68  # every anchor float but the position
SLOT_FLOATS = 14  # mu 3, s 3, q 4, alpha, colour 3
MLP_WEIGHTS = 7086
SLOT_FWD_OPS = 90 + 165  # covariance and projection (counts/__init__.py)
SCALING_OPS = 3


def d1_work(c: dict):
    """D1's least work over counts ``c``: (ops, bytes)."""
    vis = c["visible_anchors"]
    ops = (MLP_OPS + D1_ACT_OPS) * vis
    nbytes = (F32 * (ANCHOR_FLOATS + K * SLOT_FLOATS) * vis + K * vis
              + K * (c["anchors"] - vis) + F32 * MLP_WEIGHTS
              * c["scaffold_units"])
    return ops, nbytes


def d2_work(c: dict):
    """D2's least work: (ops, bytes)."""
    vis = c["visible_anchors"]
    ops = D2_OPS * vis
    nbytes = F32 * (SLOT_FLOATS * c["kept_slots"]
                    + (ANCHOR_FLOATS + ANCHOR_GRADS) * vis
                    + 2 * MLP_WEIGHTS * c["scaffold_units"])
    return ops, nbytes


def step_work_scaffold(c: dict):
    """A Scaffold-GS training step of one view (module docstring)."""
    params = ANCHOR_GRADS * c["anchors"] + MLP_WEIGHTS * c["scaffold_units"]
    loss_ops = (3 * (2 * SSIM_TAPS * SSIM_STATS * 3 * c["pixels"])
                + 3 * SCALING_OPS * c["kept_slots"])
    ops = (d1_work(c)[0] + d2_work(c)[0]
           + 3 * SLOT_FWD_OPS * c["gaussians"]
           + (OPS_FWD_PER_PAIR_PIXEL + OPS_BWD_PER_PAIR_PIXEL)
           * c["pair_pixels"] + loss_ops + ADAM_OPS_PER_PARAM * params)
    nbytes = F32 * (2 * ANCHOR_FLOATS * c["visible_anchors"]
                    + 3 * c["pixels"] + 3 * c["pixels"]
                    + ADAM_ACCESSES * params)
    return ops, nbytes
