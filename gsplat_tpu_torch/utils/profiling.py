"""Profiling hooks: the port's spans, torch.profiler traces and
steady-state timing.

Counterpart of ``gsplat_tpu/utils/profiling.py``:

* :func:`span` names a stage of the program in a ``torch.profiler``
  trace; :data:`SPANS` lists every name the program records;
* :func:`trace` wraps ``torch.profiler.profile`` over the CPU and, when a
  card is present, CUDA activities, and writes a Chrome trace
  (``chrome://tracing`` / Perfetto JSON) into ``log_dir``;
  :func:`summarize_trace` reads one back: the device's busy share of the
  traced window, kernel launches, the kernels with the most time, the
  longest idle gaps, and each range's device work by :func:`owners`.
* :func:`benchmark_fn` measures the steady-state latency of a callable,
  fenced with ``torch.cuda.synchronize()`` when its output is on a card,
  with JAX's keys.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

# Chrome-trace categories of device activity: kernels, copies and fills.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Runtime and driver calls: a device record shares its launching call's
# ``correlation`` id. Calls with these words in their names start device
# work (launches, copies, fills).
CALL_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_WORDS = ("LaunchKernel", "Memcpy", "Memset")

# Every span the program records, in nesting order: the root of a served
# frame (the viewer's closures) and of a train step, the forward's stages,
# then the loss, the backward (K2 and the keyed reduction run on
# autograd's device thread inside it) and the update. A pool with
# per-gaussian features adds the feature map (F1) after K1, its decoder
# and L1 after the loss, and F2 after K2. A surfel pool composites with S1
# in place of K1, adds its geometric loss terms after the loss, and runs
# S2 in place of K2. An anchor pool (Scaffold-GS, listed last) decodes its
# neural gaussians (the anchor cull and D1) after the pose and before the
# projection, and runs D2 (into the anchors and the MLPs) in the backward
# after the keyed reduction.
SPANS = ("gs.frame", "gs.step", "gs.pose", "gs.cov_sh", "gs.project",
         "gs.bin", "gs.gather", "gs.k1", "gs.feat_k1", "gs.s1", "gs.loss",
         "gs.feat_loss", "gs.geo_loss", "gs.backward", "gs.k2",
         "gs.feat_k2", "gs.s2", "gs.pair_grads", "gs.update", "gs.decode",
         "gs.decode_bwd")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that names a stage in a ``torch.profiler`` trace.

    While a profiler session records, ``torch.profiler.record_function(
    name)``; otherwise one shared null context, so a stage costs a flag
    read and no dispatcher call when nothing traces. ``name`` is one of
    :data:`SPANS`."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Context manager: capture a ``torch.profiler`` trace into ``log_dir``.

    Yields the profiler; on exit its Chrome trace is written to
    ``log_dir/trace_<pid>_<ns>.json`` and the path stored as the
    profiler's ``chrome_trace_path``. ``create_perfetto_link`` would
    upload the trace (JAX's option); it raises here, as nothing of this
    package reaches a network."""
    if create_perfetto_link:
        raise ValueError("create_perfetto_link is not supported: traces "
                         "stay local (open the JSON in ui.perfetto.dev)")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    prof.chrome_trace_path = path


def _merged(intervals):
    """Union of [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(intervals) -> float:
    return sum(e - s for s, e in _merged(intervals))


def owners(calls: dict, ranges: list) -> dict:
    """The attribution rule: the range each device record belongs to.

    ``calls`` maps a correlation id to its runtime or driver call's
    ``(tid, start)``; ``ranges`` lists ``(name, tid, start, end)``. A
    device record belongs to the range of the call with its correlation
    id: the innermost range that holds the call's start on the call's own
    thread; failing that (work that autograd's device thread launches
    while the caller waits in ``backward()``), the innermost range on any
    thread that holds it; failing that, none. Of nested ranges the
    innermost is the one that starts last (of two that start together,
    the shorter). Returns ``{correlation: range index or None}``; a
    record whose call the trace lacks has none. ``benchmark/spans.py``
    holds a frozen copy."""
    def index(ix):
        ix = sorted(ix, key=lambda i: (ranges[i][2],
                                       ranges[i][2] - ranges[i][3], i))
        return ix, [ranges[i][2] for i in ix]

    by_tid = {}
    for i, r in enumerate(ranges):
        by_tid.setdefault(r[1], []).append(i)
    per_tid = {tid: index(ix) for tid, ix in by_tid.items()}
    every = index(range(len(ranges)))

    def innermost(ix, starts, t):
        for k in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if t <= ranges[ix[k]][3]:
                return ix[k]
        return None

    out = {}
    for c, (tid, t) in calls.items():
        own = innermost(*per_tid[tid], t) if tid in per_tid else None
        out[c] = own if own is not None else innermost(*every, t)
    return out


def nested(ranges: list) -> list:
    """For each range, the indices of the ranges inside its interval (on
    any thread), itself included; of two with the same interval the later
    is inside the earlier. A range's device time is the union of the
    records these own."""
    return [[j for j, (_, _, s, e) in enumerate(ranges)
             if s0 <= s and e <= e0 and ((s, e) != (s0, e0) or j >= i)]
            for i, (_, _, s0, e0) in enumerate(ranges)]


def summarize_trace(path: str, top: int = 10, gaps: int = 5,
                    root: str | None = None) -> dict:
    """Read a Chrome trace written by :func:`trace`.

    The window runs from the first event's start to the last event's end
    (host and device). Returns a dict: ``window_us``; ``busy_us`` and
    ``busy_share`` (the union of device intervals over the window);
    ``kernels`` (kernel launches); ``by_kernel`` ``{name: [count,
    total_us]}``; ``top`` (the ``top`` kernels by total time, as
    ``(name, count, total_us)``); ``gaps_us`` (the ``gaps`` longest idle
    intervals between device activity); ``cpu_ops`` ``{name: count}`` of
    the host-side operators; ``ranges`` ``{name: {"host_us", "launches",
    "kernels", "busy_us", "self_busy_us", "idle_us"}}`` for each
    ``record_function`` range but the profiler's own ``ProfilerStep#``,
    summed over the range's occurrences (with ``root``, only the ranges
    named ``root`` and those inside one count; the rest of the trace's
    device records belong to none): its host duration; the calls
    that start device work (kernel launches, copies, fills) and the
    device records the trace holds, both of the range and the ranges it
    holds (:func:`owners`, :func:`nested`; fewer records than calls
    where the trace lost some); the union of those records' device
    intervals; the union of the range's own records only; and the time
    inside the range with no device record running."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    t0 = min((float(e["ts"]) for e in spans), default=0.0)
    t1 = max((float(e["ts"]) + float(e["dur"]) for e in spans), default=0.0)
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
    merged = _merged((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in dev)
    busy = sum(e - s for s, e in merged)
    idle = sorted((b[0] - a[1] for a, b in zip(merged, merged[1:])),
                  reverse=True)
    by_kernel = {}
    for e in dev:
        if e["cat"] == "kernel":
            c = by_kernel.setdefault(e["name"], [0, 0.0])
            c[0] += 1
            c[1] += float(e["dur"])
    cpu_ops = {}
    for e in spans:
        if e.get("cat") == "cpu_op":
            cpu_ops[e["name"]] = cpu_ops.get(e["name"], 0) + 1

    def corr(e):
        return e.get("args", {}).get("correlation")

    ranges = [(r["name"], r.get("tid"), float(r["ts"]),
               float(r["ts"]) + float(r["dur"])) for r in spans
              if r.get("cat") == "user_annotation"
              and not r["name"].startswith("ProfilerStep#")]
    if root is not None:
        roots = [r for r in ranges if r[0] == root]
        ranges = [r for r in ranges
                  if any(s <= r[2] and r[3] <= e for _, _, s, e in roots)]
    calls = [e for e in spans if e.get("cat") in CALL_CATS]
    own = owners({corr(c): (c.get("tid"), float(c["ts"])) for c in calls},
                 ranges)
    launches = [own[corr(c)] for c in calls
                if any(w in c.get("name", "") for w in LAUNCH_WORDS)]
    recs = [(own.get(corr(e)), float(e["ts"]), float(e["ts"])
             + float(e["dur"])) for e in dev]
    out = {}
    for i, inner in enumerate(nested(ranges)):
        name, _, s0, s1 = ranges[i]
        inner = set(inner)
        mine = [(s, e) for o, s, e in recs if o in inner]
        acc = out.setdefault(name, {"host_us": 0.0, "launches": 0,
                                    "kernels": 0, "busy_us": 0.0,
                                    "self_busy_us": 0.0, "idle_us": 0.0})
        acc["host_us"] += s1 - s0
        acc["launches"] += sum(o in inner for o in launches)
        acc["kernels"] += len(mine)
        acc["busy_us"] += _length(mine)
        acc["self_busy_us"] += _length((s, e) for o, s, e in recs if o == i)
        acc["idle_us"] += (s1 - s0) - _length(
            (max(s, s0), min(e, s1)) for s, e in merged if s < s1 and e > s0)
    window = t1 - t0
    return {
        "window_us": window,
        "busy_us": busy,
        "busy_share": busy / window if window > 0 else 0.0,
        "kernels": sum(c for c, _ in by_kernel.values()),
        "by_kernel": by_kernel,
        "top": sorted(((k, c, t) for k, (c, t) in by_kernel.items()),
                      key=lambda r: -r[2])[:top],
        "gaps_us": idle[:gaps],
        "cpu_ops": cpu_ops,
        "ranges": out,
    }


def block_until_ready(out):
    """Wait for every CUDA tensor in ``out`` (nested tuples, lists, dicts)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            block_until_ready(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            block_until_ready(v)


def benchmark_fn(
    fn,
    *args,
    iters: int = 20,
    warmup: int = 2,
    pixels: int | None = None,
):
    """Steady-state latency of ``fn(*args)`` (host clock to the output's
    completion: ``torch.cuda.synchronize()`` for CUDA outputs; CPU tensors
    are complete on return).

    Returns a dict with mean/median/min/max/std milliseconds, FPS, and, when
    ``pixels`` is given, rays/s (= pixels/s) throughput."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    block_until_ready(out)

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        block_until_ready(out)
        times.append(time.perf_counter() - t0)
    ms = np.asarray(times) * 1e3
    stats = {
        "iters": iters,
        "mean_ms": float(ms.mean()),
        "median_ms": float(np.median(ms)),
        "min_ms": float(ms.min()),
        "max_ms": float(ms.max()),
        "std_ms": float(ms.std()),
        "fps": float(1e3 / ms.mean()),
    }
    if pixels is not None:
        stats["rays_per_s"] = float(pixels * 1e3 / ms.mean())
    return stats
