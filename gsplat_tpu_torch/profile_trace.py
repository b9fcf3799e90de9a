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
most time and the longest idle gaps. Then it traces one frame stage by
stage (:func:`trace_stages`: covariance + SH, projection, binning,
``rasterize_binned``, each in a ``record_function`` range) and prints each
stage's host time, kernel launches and device-busy time. On the CPU the
trace holds the host operators only.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch


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


STAGES = ("cov3d+sh", "project", "bin", "rasterize_binned")


def trace_stages(params, c2w, fx, fy, cx, cy, cfg, alive, log_dir: str):
    """One frame of render_from_params, stage by stage (the calls
    ``profile_stages.stage_ms`` times), each stage inside a
    ``record_function`` range of :data:`STAGES`. The trace holds an
    unannotated frame first: a trace can miss kernel records at its start
    (seen on the card after earlier traces in the same process), which
    then fall on that frame. Returns the trace's ``summarize_trace`` dict,
    whose ``ranges`` give each stage's host time, launches, kernels and
    device-busy time."""
    from .ops.binning import bin_gaussians
    from .ops.gaussian import build_cov3d_packed
    from .ops.projection import project_gaussians
    from .ops.rasterize import rasterize_binned
    from .ops.sh import evaluate_sh
    from .utils.profiling import block_until_ready, summarize_trace, trace

    pos = params["pos"]
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=pos.device)

    def frame(annotate: bool):
        def stage(name):
            return (torch.profiler.record_function(name) if annotate
                    else contextlib.nullcontext())

        with torch.no_grad():
            with stage("cov3d+sh"):
                cov = build_cov3d_packed(params["scale_raw"],
                                         params["q_raw"])
                colors = evaluate_sh(params["f_dc"], params["f_rest"], pos,
                                     c2w)
            with stage("project"):
                proj = project_gaussians(pos, cov, params["opacity_raw"],
                                         c2w, fx, fy, cx, cy, cfg,
                                         extra_valid=alive)
            with stage("bin"):
                b = bin_gaussians(proj, cfg)
            with stage("rasterize_binned"):
                return rasterize_binned(proj, colors, b, cfg)[0]

    block_until_ready(frame(False))
    with trace(log_dir) as prof:
        block_until_ready(frame(False))
        block_until_ready(frame(True))
    return summarize_trace(prof.chrome_trace_path)


def print_stages(summary: dict, label: str = "") -> None:
    """Print the per-stage ranges of a :func:`trace_stages` summary."""
    pre = f"{label}: " if label else ""
    print(f"{pre}stages of one traced frame (host ms inside the stage / "
          f"kernel launches / device-busy ms of those kernels):",
          flush=True)
    for name in STAGES:
        r = summary["ranges"].get(name, {"host_us": 0.0, "launches": 0,
                                         "kernels": 0, "busy_us": 0.0})
        lost = r["launches"] - r["kernels"]
        print(f"  {name:18s} host {r['host_us'] / 1e3:8.3f} ms  launches "
              f"{r['launches']:5d}  device busy {r['busy_us'] / 1e3:8.3f} "
              f"ms" + (f"  ({lost} kernel records missing)" if lost else ""),
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
