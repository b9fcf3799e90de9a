"""The traced stretch: ``torch.profiler`` over CPU and CUDA activities,
read back into kernel records, the device's busy time, the longest idle
gaps with what the host was doing in each, and the program's ``gs.*``
spans with each device record's launching call (``spans.py``).

The reading is a frozen copy of the arithmetic of
``gsplat_tpu_torch/utils/profiling.py::summarize_trace``: the window runs
from the first event's start to the last event's end, host and device;
the device is busy in the union of its kernel, copy and fill intervals.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

from . import spans
from .stats import merged

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
WARMUP = 2  # profiler steps run before the recorded ones
TOP = 10  # device operations and idle gaps kept for the breakdown
NAME_WIDTH = 120  # characters of a kernel's (templated) name kept


@dataclass
class Trace:
    """Times in seconds, relative to nothing in particular."""

    window_s: float
    busy_s: float
    kernels: list  # [(name, start_s, dur_s)] of kernel records
    device: list  # [(cat, name, start_s, dur_s)] of every device record
    gaps: list = field(default_factory=list)  # [(host activity, seconds)]
    # The program's spans (``spans.read_spans``): [(name, tid, start_s,
    # dur_s)] of its gs.* ranges, and each device record's call.
    ranges: list = field(default_factory=list)
    calls: list = field(default_factory=list)

    def kernel_time(self, match) -> float:
        """Merged device seconds of the kernels whose name ``match``es."""
        iv = [(s, s + d) for n, s, d in self.kernels if match(n)]
        return sum(e - s for s, e in merged(iv))


def capture(step, units: int) -> Trace:
    """Run ``step()`` ``WARMUP + units`` times under ``torch.profiler``,
    recording the last ``units`` (the warm-up steps start the profiler's
    machinery outside the record); ``step`` ends each unit itself."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sched = torch.profiler.schedule(wait=0, warmup=WARMUP, active=units,
                                    repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(WARMUP + units):
            step()
            prof.step()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    tr = read_events(events)
    tr.ranges, tr.calls = spans.read_spans(events)
    return tr


def read_events(events: list) -> Trace:
    """A :class:`Trace` from Chrome-trace events (times in microseconds),
    without the program's spans (:func:`capture` adds them)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    t0 = min((float(e["ts"]) for e in spans), default=0.0)
    t1 = max((float(e["ts"]) + float(e["dur"]) for e in spans), default=0.0)
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
    iv = merged((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in dev)
    busy = sum(b - a for a, b in iv)
    host = [e for e in spans if e.get("cat") in HOST_CATS]
    idle = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(iv, iv[1:])),
                  reverse=True)[:TOP]
    named = []
    for length, s, e in idle:
        mid = 0.5 * (s + e)
        over = [h for h in host
                if float(h["ts"]) <= mid <= float(h["ts"]) + float(h["dur"])]
        inner = min(over, key=lambda h: float(h["dur"]), default=None)
        named.append((inner["name"] if inner else "no host activity",
                      length * 1e-6))
    us = 1e-6
    return Trace(
        window_s=(t1 - t0) * us,
        busy_s=busy * us,
        kernels=[(e["name"], float(e["ts"]) * us, float(e["dur"]) * us)
                 for e in dev if e["cat"] == "kernel"],
        device=[(e["cat"], e["name"], float(e["ts"]) * us,
                 float(e["dur"]) * us) for e in dev],
        gaps=named,
    )


def top_device_ops(tr: Trace) -> list:
    """[[name, seconds]] of the device operations with the most time."""
    by = {}
    for _, n, _, d in tr.device:
        by[n] = by.get(n, 0.0) + d
    rows = sorted(by.items(), key=lambda r: -r[1])[:TOP]
    return [[n[:NAME_WIDTH], s] for n, s in rows]
