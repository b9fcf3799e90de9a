"""Work counts of Feature 3DGS's layers (``models/feat3dgs.py``), on top of
3DGS's (``counts/__init__.py``, whose peaks and per-pair counts they
keep). Every count is a least amount of work the step needs, counted
from the reference's own counts at the cell's inputs, so that no share of
a roofline or peak can read over 100 %.

The inputs are the reference's work counts of the traced units, summed
over them (``harness`` adds the units' counts): 3DGS's keys unchanged,
and ``channels`` (C), ``teacher_pixels`` (h w of the teacher map) and
``decoder_params`` (D C + D), each once a unit, so ``channels / units``
is C.

Term by term, with C the channels and D the decoder's width:

* F1, the feature map (per composited (pair, pixel) with a non-zero
  weight, ``pair_pixels``): one multiply and one add a channel, 2 C
  operations. Bytes: the C feature floats of each contributing pair
  (``contrib_pairs``) read once, the map's C floats a pixel written once.
  The alpha, weight and transmittance are K1's work (``k1_work``), not
  counted again: a compositor that shared them with K1 would not redo
  them.
* F2, its backward (per composited (pair, pixel)): ``gF . f``, C
  multiplies and C adds, and ``w gF`` summed over the pixels into the
  pair's d f, C multiplies and C adds: 4 C operations (the rest of the
  alpha term is O(1) a (pair, pixel), and ``gF . F`` O(C) a pixel, both
  left out). Bytes: each contributing pair's C feature floats read and C
  gradient floats written, the map's cotangent and the map itself read
  (2 C floats a pixel).
* The decoder (per teacher pixel): 2 C D operations forward; its
  backward takes the gradient of the input and of the weight, 2 C D each:
  6 C D in a step. Bytes: the resized map read and the decoded map
  written (C + D floats a teacher pixel), the teacher map read (D), and
  the decoded map's gradient written and read again by the backward's
  two products (2 D), and the resized map's gradient written (C).
* The resize and the L1 (a few operations a float) are left out.
* Adam over every parameter: 187 floats a slot (3DGS's 59, C = 128
  features) and the decoder's D C + D, ``ADAM_ACCESSES`` float32 accesses
  and ``ADAM_OPS_PER_PARAM`` operations each.
"""

from __future__ import annotations

from benchmark.counts import (ADAM_ACCESSES, ADAM_OPS_PER_PARAM, F32,
                              step_work)

FEAT_FWD_OPS_PER_CHANNEL = 2  # a multiply and an add a (pair, pixel)
FEAT_BWD_OPS_PER_CHANNEL = 4  # gF . f, and w gF into d f


def _per_unit(c: dict, units: int):
    """(C, D) of counts ``c`` summed over ``units`` units."""
    C = c["channels"] // units
    D = (c["decoder_params"] // units) // (C + 1)
    return C, D


def f1_work(c: dict, units: int):
    """F1's least work over counts ``c`` of ``units`` units: (ops,
    bytes)."""
    C, _ = _per_unit(c, units)
    ops = FEAT_FWD_OPS_PER_CHANNEL * C * c["pair_pixels"]
    nbytes = F32 * C * (c["contrib_pairs"] + c["pixels"])
    return ops, nbytes


def f2_work(c: dict, units: int):
    """F2's least work: (ops, bytes)."""
    C, _ = _per_unit(c, units)
    ops = FEAT_BWD_OPS_PER_CHANNEL * C * c["pair_pixels"]
    nbytes = F32 * C * (2 * c["contrib_pairs"] + 2 * c["pixels"])
    return ops, nbytes


def decoder_work(c: dict, units: int):
    """The decoder's forward and backward over the teacher pixels: (ops,
    bytes)."""
    C, D = _per_unit(c, units)
    ops = 6 * C * D * c["teacher_pixels"]
    nbytes = F32 * (2 * C + 4 * D) * c["teacher_pixels"]
    return ops, nbytes


def step_work_feat(c: dict, units: int):
    """A Feature 3DGS training step: 3DGS's step (``counts.step_work``,
    Adam over its 59 floats a slot), F1, F2, the decoder, and Adam over
    the features and the decoder."""
    C, _ = _per_unit(c, units)
    ops, nbytes = step_work(c)
    extra = C * c["slots"] + c["decoder_params"]
    for o, b in (f1_work(c, units), f2_work(c, units),
                 decoder_work(c, units)):
        ops += o
        nbytes += b
    ops += ADAM_OPS_PER_PARAM * extra
    # the gradient written by the backward, then Adam's accesses
    nbytes += F32 * (1 + ADAM_ACCESSES) * extra
    return ops, nbytes
