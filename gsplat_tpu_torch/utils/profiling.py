"""Profiling hooks: torch.profiler traces and steady-state timing.

Counterpart of ``gsplat_tpu/utils/profiling.py``:

* :func:`trace` wraps ``torch.profiler.profile`` over the CPU and, when a
  card is present, CUDA activities, and writes a Chrome trace
  (``chrome://tracing`` / Perfetto JSON) into ``log_dir``;
  :func:`summarize_trace` reads one back: the device's busy share of the
  traced window, kernel launches, the kernels with the most time, and the
  longest idle gaps.
* :func:`benchmark_fn` measures the steady-state latency of a callable,
  fenced with ``torch.cuda.synchronize()`` when its output is on a card,
  with JAX's keys.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

# Chrome-trace categories of device activity: kernels, copies and fills.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


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


def summarize_trace(path: str, top: int = 10, gaps: int = 5) -> dict:
    """Read a Chrome trace written by :func:`trace`.

    The window runs from the first event's start to the last event's end
    (host and device). Returns a dict: ``window_us``; ``busy_us`` and
    ``busy_share`` (the union of device intervals over the window);
    ``kernels`` (kernel launches); ``by_kernel`` ``{name: [count,
    total_us]}``; ``top`` (the ``top`` kernels by total time, as
    ``(name, count, total_us)``); ``gaps_us`` (the ``gaps`` longest idle
    intervals between device activity); ``cpu_ops`` ``{name: count}`` of
    the host-side operators; ``ranges`` ``{name: {"host_us", "launches",
    "kernels", "busy_us"}}`` for each ``torch.profiler.record_function``
    range: its host duration, the kernel-launch calls that start inside it,
    the kernels they launched that the trace holds (matched by the trace's
    correlation id; fewer than ``launches`` where the trace lost kernel
    records) and the union of those kernels' device intervals."""
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
    launches = [e for e in spans
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in e.get("name", "")]
    kernel_of = {e.get("args", {}).get("correlation"): e for e in dev
                 if e["cat"] == "kernel"}
    ranges = {}
    for r in spans:
        if r.get("cat") != "user_annotation":
            continue
        s0, s1 = float(r["ts"]), float(r["ts"]) + float(r["dur"])
        calls = [e for e in launches if s0 <= float(e["ts"]) <= s1]
        ids = [c.get("args", {}).get("correlation") for c in calls]
        ks = [kernel_of[i] for i in ids if i in kernel_of]
        acc = ranges.setdefault(r["name"], {"host_us": 0.0, "launches": 0,
                                            "kernels": 0, "busy_us": 0.0})
        acc["host_us"] += s1 - s0
        acc["launches"] += len(calls)
        acc["kernels"] += len(ks)
        acc["busy_us"] += sum(b - a for a, b in _merged(
            (float(k["ts"]), float(k["ts"]) + float(k["dur"])) for k in ks))
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
        "ranges": ranges,
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
