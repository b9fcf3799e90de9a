"""Capture a torch.profiler trace of the render (or fwd+bwd) step.

Counterpart of ``scripts/profile_trace.py``, with its flags and a
``--device``. Run on the card as

    python -m gsplat_tpu_torch.profile_trace [--backward]

It renders ``scene.make_scene(--gaussians)`` from the origin ``--iters``
times inside ``utils.profiling.trace`` and writes the Chrome trace into
``--log_dir`` (default ``traces/``, which git ignores; open it in
``ui.perfetto.dev`` or ``chrome://tracing``). It then prints the trace's
summary (``utils.profiling.summarize_trace``): the device's busy share of
the traced window, the kernel launches per iteration, the kernels with the
most time and the longest idle gaps. Then it traces one served frame
(:func:`trace_stages`: ``viewer.make_render_fn``'s closure under the
program's own spans) and prints each span's host time, launches and
device time. On the CPU the trace holds the host operators only.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .utils.profiling import SPANS


def print_summary(summary: dict, iters: int, label: str = "") -> None:
    """Print a ``summarize_trace`` dict (per-iteration launches over
    ``iters``)."""
    pre = f"{label}: " if label else ""
    if not summary["busy_us"]:
        print(f"{pre}traced window {summary['window_us'] / 1e3:.3f} ms "
              f"(host clock); no device activity in the trace; "
              f"{sum(summary['cpu_ops'].values())} host operator calls",
              flush=True)
        return
    print(f"{pre}traced window {summary['window_us'] / 1e3:.3f} ms, device "
          f"busy {summary['busy_us'] / 1e3:.3f} ms = "
          f"{summary['busy_share']:.3f} of it; {summary['kernels']} kernel "
          f"launches ({summary['kernels'] / max(iters, 1):.1f} per "
          f"iteration)", flush=True)
    for name, count, total in summary["top"]:
        print(f"  {total / 1e3:9.3f} ms  x{count:<5d} {name[:100]}")
    if summary["gaps_us"]:
        print(f"  longest idle gaps (us): "
              + ", ".join(f"{g:.1f}" for g in summary["gaps_us"]))


# The leaf spans of a served frame: SPANS from the pose's copy to K1.
STAGES = SPANS[SPANS.index("gs.pose"):SPANS.index("gs.k1") + 1]


def trace_stages(params, c2w, fx, fy, cx, cy, cfg, alive, log_dir: str):
    """One served frame (``viewer.make_render_fn``'s closure over
    ``render_from_params``) traced under the spans the program records,
    its root ``gs.frame`` and the leaves :data:`STAGES`. The trace holds a
    frame of ``render_from_params`` with no root first: a trace can lose
    device records at its start (seen on the card after earlier traces in
    the same process), and these then fall outside the served frame,
    which alone is summed. Returns the trace's ``summarize_trace`` dict
    (``root="gs.frame"``), whose ``ranges`` give each span's host time,
    launches, device records, device time and idle time."""
    from .render import render_from_params
    from .utils.profiling import block_until_ready, summarize_trace, trace
    from .viewer import make_render_fn

    fn = make_render_fn(params, cfg, fx, fy, cx, cy, alive=alive)
    block_until_ready(fn(c2w))
    with trace(log_dir) as prof:
        with torch.no_grad():
            block_until_ready(render_from_params(params, c2w, fx, fy, cx, cy,
                                                 cfg, alive=alive)[0])
        block_until_ready(fn(c2w))
    return summarize_trace(prof.chrome_trace_path, root="gs.frame")


def print_stages(summary: dict, label: str = "") -> None:
    """Print the per-stage ranges of a :func:`trace_stages` summary."""
    pre = f"{label}: " if label else ""
    print(f"{pre}stages of one traced frame (host ms inside the span / "
          f"launches / device ms of their kernels, copies and fills):",
          flush=True)
    for name in ("gs.frame",) + STAGES:
        r = summary["ranges"].get(name, {"host_us": 0.0, "launches": 0,
                                         "kernels": 0, "busy_us": 0.0})
        lost = r["launches"] - r["kernels"]
        print(f"  {name:12s} host {r['host_us'] / 1e3:8.3f} ms  launches "
              f"{r['launches']:5d}  device busy {r['busy_us'] / 1e3:8.3f} "
              f"ms" + (f"  ({lost} device records missing)" if lost else ""),
              flush=True)


def main(argv=None) -> dict:
    """Parse ``argv``, trace and summarize. Returns {"path", "summary"}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--log_dir", default="traces")
    p.add_argument("--gaussians", type=int, default=2**17)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--max_pairs", type=int, default=2**22)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--backward", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from .config import RenderConfig
    from .device import resolve_device
    from .render import render_from_params
    from .scene import make_scene
    from .utils.profiling import block_until_ready, summarize_trace, trace

    dev = resolve_device(args.device)
    cfg = RenderConfig(height=args.height, width=args.width,
                       max_pairs=args.max_pairs)
    params = make_scene(args.gaussians, device=dev)
    c2w = np.eye(4, dtype=np.float32)
    fx = fy = 0.85 * args.width
    cx, cy = args.width / 2.0, args.height / 2.0

    if args.backward:
        def fn():
            p = {k: v.detach().requires_grad_(True)
                 for k, v in params.items()}
            img, _ = render_from_params(p, c2w, fx, fy, cx, cy, cfg)
            img.sum().backward()
            return [v.grad for v in p.values()]
    else:
        def fn():
            with torch.no_grad():
                return render_from_params(params, c2w, fx, fy, cx, cy,
                                          cfg)[0]

    block_until_ready(fn())  # warm-up, outside the trace
    with trace(args.log_dir) as prof:
        for _ in range(args.iters):
            out = fn()
        block_until_ready(out)
    path = prof.chrome_trace_path
    print(f"trace written to {path}")
    summary = summarize_trace(path)
    print_summary(summary, args.iters,
                  "fwd+bwd" if args.backward else "forward")
    stages = trace_stages(params, c2w, fx, fy, cx, cy, cfg, None,
                          args.log_dir)
    print_stages(stages)
    return {"path": path, "summary": summary, "stages": stages}


if __name__ == "__main__":
    main()
