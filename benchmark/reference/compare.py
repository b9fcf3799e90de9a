"""The numbers that decide ``correct``: what the program produced against
what the plain reference works out from the same inputs.

Serving: every compared frame's largest and mean absolute difference from
the reference's frame of the same pose (rgb in [0, 1]); the worst frame
counts.

Training, over the first three steps (the steps the window's own call
took first, from the same object): each step's loss as a relative gap;
per leaf, the gap between the norms of the first gradient as the
optimizer got it (the program's worked out from Adam's first moment after
one step, ``m / (1 - beta1)``) and the gap between the norms of the
parameters' change over the three steps, each over the larger of the
reference's norm of that leaf and of the median leaf; the worst leaf
counts. A leaf whose reference gradient is under a thousandth of the
median leaf's moves under Adam by round-off alone and is left out of the
change (``EXCLUDE_BELOW``); so is each element whose first reference
gradient is under a thousandth of the median leaf's root mean square
(``moved_elements``).
"""

from __future__ import annotations

import torch

EXCLUDE_BELOW = 1e-3


def frame_numbers(pairs) -> dict:
    """``pairs``: [(program frame, reference frame)], [H, W, 3] each."""
    mx, mean = 0.0, 0.0
    for prog, ref in pairs:
        d = (prog.float() - ref.float()).abs()
        if not bool(torch.isfinite(d).all()):
            return {"frame_max_abs": float("inf"),
                    "frame_mean_abs": float("inf")}
        mx = max(mx, float(d.max()))
        mean = max(mean, float(d.mean()))
    return {"frame_max_abs": mx, "frame_mean_abs": mean}


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in
            tensors.items()}


def _median(values) -> float:
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def leaf_gap(prog: dict, ref: dict, keys=None) -> float:
    """max over leaves of |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf ‖ref‖)."""
    pn, rn = _norms(prog), _norms(ref)
    med = _median(list(rn.values()))
    keys = list(rn) if keys is None else keys
    gap = 0.0
    for k in keys:
        den = max(rn[k], med)
        g = abs(pn[k] - rn[k]) / den if den > 0 else abs(pn[k] - rn[k])
        gap = max(gap, g if g == g else float("inf"))  # NaN -> inf
    return gap


def moved_leaves(g1_ref: dict) -> list:
    """Leaves whose first reference gradient is at least ``EXCLUDE_BELOW``
    of the median leaf's: the others are left out of the change."""
    rn = _norms(g1_ref)
    med = _median(list(rn.values()))
    return [k for k, v in rn.items() if v >= EXCLUDE_BELOW * med]


def moved_elements(g1_ref: dict) -> dict:
    """{leaf: mask} of the elements whose first reference gradient is at
    least ``EXCLUDE_BELOW`` of the median leaf's root mean square: the
    gaussians that the frame depends on. The others (exactly zero in the
    reference: out of view, below the alpha cutoff or behind saturated
    pixels) are left out of the change, since Adam (eps 1e-15) turns a
    rounding-level gradient into a step of the whole learning rate."""
    rms = _median([float(torch.linalg.vector_norm(v.float()))
                   / max(v.numel(), 1) ** 0.5 for v in g1_ref.values()])
    return {k: v.abs() >= EXCLUDE_BELOW * rms for k, v in g1_ref.items()}


def train_numbers(prog_losses, ref_losses, prog_g1, ref_g1, prog_delta,
                  ref_delta) -> dict:
    loss = 0.0
    for a, b in zip(prog_losses, ref_losses):
        g = abs(a - b) / max(abs(b), 1e-12)
        loss = max(loss, g if g == g else float("inf"))
    mask = moved_elements(ref_g1)
    return {
        "loss_rel_gap": loss,
        "grad_norm_gap": leaf_gap(prog_g1, ref_g1),
        "delta_norm_gap": leaf_gap(
            {k: torch.where(mask[k], v, 0.0) for k, v in prog_delta.items()},
            {k: torch.where(mask[k], v, 0.0) for k, v in ref_delta.items()},
            moved_leaves(ref_g1)),
    }
