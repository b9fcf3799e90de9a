"""The arithmetic of the end-to-end metrics and of the traced window."""

from __future__ import annotations

import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of all ``values``, by
    ``statistics.quantiles(method="inclusive")`` (linear between order
    statistics); a single value is its own percentile."""
    vals = [float(v) for v in values]
    if not vals:
        raise ValueError("percentile of no values")
    if len(vals) == 1:
        return vals[0]
    cuts = statistics.quantiles(vals, n=100, method="inclusive")
    lo = int(q)
    if lo == q:
        return cuts[lo - 1]
    # Between two integer percentiles: interpolate.
    a, b = cuts[lo - 1], cuts[lo]
    return a + (b - a) * (q - lo)


def rate(count: int, seconds: float) -> float:
    """Units completed per second of the window."""
    if seconds <= 0:
        raise ValueError("rate over an empty window")
    return count / seconds


def merged(intervals):
    """Union of [start, end) intervals, sorted (a frozen copy of
    ``gsplat_tpu_torch/utils/profiling.py::_merged``)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_share(busy_s: float, window_s: float) -> float:
    """Share of the window in which no device operation ran, in [0, 1]."""
    if window_s <= 0:
        raise ValueError("idle share of an empty window")
    return max(0.0, 1.0 - busy_s / window_s)

