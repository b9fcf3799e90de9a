"""One run of one cell: set-up, warm-up, the measured window, an optional
traced stretch, the comparison with the plain reference, the result.

Everything about a cell comes from files found by name: the cell's entry
in ``BENCHMARK.json``, its configuration (``configs/<config>.json``), the
configuration's model (``models/<model>.py``, ``gs3d`` where the
configuration names none), its traffic mix (``traffic/<mix>.json``), its
limits (``limits/<cell>.json``) and one reader per per-layer metric
(``layer_metrics/<metric>.py``). A mix's ``kind`` picks the driver:
``serve`` (one viewer in a closed loop through the model's serve entry)
or ``train`` (the model's train step over seeded views), or a kind that
the model's own ``DRIVERS`` names.

The drivers keep the loops, the clocks, the failure rules, the traced
stretch and the result; every piece that depends on the model (the
scene, the program's entry and state, the reference, the numbers
compared) is the model's. The model imports the program only inside its
program-side functions; the reference (``reference/``) imports nothing
of it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from . import counts as work
from . import poses, scenes, stats, tracing
from .reference import render as ref

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DEFAULT_MODEL = "gs3d"  # a configuration that names no model: plain 3DGS


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell's entry and everything its names lead to."""

    def __init__(self, bench: dict, name: str, here: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = load_json(ROOT / conf["file"])
        self.model = load_model(self.config.get("model", DEFAULT_MODEL),
                                here)
        self.mix = load_json(here / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(here / "limits" / f"{name}.json")
        self.e2e = [m for m in bench["end_to_end"]
                    if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.e2e}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]
        self.here = here


def _load(kind: str, name: str, here: Path):
    path = here / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, here: Path = HERE):
    """The reader module of per-layer metric ``name``."""
    return _load("layer_metrics", name, here)


def load_model(name: str, here: Path = HERE):
    """The model module ``name`` (``models/<name>.py``)."""
    return _load("models", name, here)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _free(dev):
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _camera(mix: dict, c2w) -> ref.Camera:
    fx, fy, cx, cy = poses.intrinsics(mix)
    return ref.Camera(c2w, fx, fy, cx, cy, mix["height"], mix["width"])


def _center_radius(params: dict, alive):
    pos = params["pos"].detach()[alive].cpu().numpy()
    return poses.scene_center_radius(pos)


# -- serving ------------------------------------------------------------------

def run_serve(cell: Cell, seed: int, seconds: float, trace: bool, dev,
              t_start: float, hooks=None):
    mix, model, hooks = cell.mix, cell.model, hooks or {}
    parts = {"start": time.perf_counter() - t_start}
    pool = model.program_pool(cell, seed, dev)
    parts["scene"] = time.perf_counter() - t_start
    center, radius = _center_radius(pool.params, pool.alive)
    path = poses.path_poses(mix["path"], center, radius)
    off = poses.start(len(path), seed)
    cfg, demands = model.render_config(cell, pool, path)
    parts["sized"] = time.perf_counter() - t_start
    fn = model.serve_entry(cell, pool, cfg, hooks)
    for i in range(mix["warmup"]):
        fn(path[(off + i) % len(path)])
    _sync(dev)
    _settle()
    setup_s = time.perf_counter() - t_start
    setup_peak = _peak(dev)

    keep = set(poses.sample(mix["compare_frames"], len(path), seed))
    kept, times, probes, failed = {}, [], [], 0
    i = 0
    t0 = time.perf_counter()
    while True:
        pose = path[(off + i) % len(path)]
        f0 = time.perf_counter()
        try:
            img, probe = fn(pose)
        except Exception:  # a frame that raises is a failed frame
            img, probe = None, None
            failed += 1
        _sync(dev)
        f1 = time.perf_counter()
        times.append(f1 - f0)
        probes.append(probe)
        if img is not None and i in keep:
            kept[i] = img
        i += 1
        if f1 - t0 >= seconds:
            break
    window_s = f1 - t0
    frames = i
    ok = [p for p in probes if p is not None]
    if ok:
        demand = torch.stack(ok)[:, 1].cpu().numpy()
        failed += int(np.sum(demand > cfg.max_pairs))
    out = {
        "attempted": frames, "failed": failed,
        "e2e": {"frames_per_s": stats.rate(frames, window_s),
                "frame_ms_p95": stats.percentile(times, 95) * 1e3,
                "setup_s": setup_s},
        "memory_peak_bytes": max(setup_peak, _peak(dev)),
        "info": {"frames": frames, "window_s": window_s,
                 "setup_parts": parts, "max_pairs": cfg.max_pairs,
                 "max_demand": int(max(demands))},
    }
    traced = []
    if trace:
        state = {"i": frames}

        def one():
            k = state["i"]
            fn(path[(off + k) % len(path)])
            _sync(dev)
            traced.append(k)
            state["i"] = k + 1

        tr = tracing.capture(one, mix["trace_units"])
        traced = traced[-mix["trace_units"]:]  # the warm-up's are dropped
        out["trace"] = tr
        out["memory_peak_bytes"] = max(out["memory_peak_bytes"], _peak(dev))
    t_ref = time.perf_counter()
    del fn, pool
    _free(dev)
    params, alive = model.scene(cell, seed, dev)
    pairs, unit_counts = [], []
    for k in sorted(kept):
        cam = _camera(mix, path[(off + k) % len(path)])
        pairs.append((kept.pop(k), model.frame(cell, params, alive, cam)[0]))
    for k in traced:  # the work of the traced frames, by the reference
        cam = _camera(mix, path[(off + k) % len(path)])
        unit_counts.append(model.frame(cell, params, alive, cam,
                                       count_work=True)[1])
    out["numbers"] = model.frame_numbers(pairs)
    out["info"]["compare_s"] = time.perf_counter() - t_ref
    if trace:
        out["ctx"] = {"kind": "serve", "units": len(traced),
                      "unit_s": window_s / frames,
                      "counts": work.add(unit_counts)}
    return out


# -- training -----------------------------------------------------------------

def _train_inputs(cell: Cell, seed: int, dev):
    """The views, their ground truth (rendered by the reference from the
    unperturbed scene) and the seeded view order."""
    mix, model = cell.mix, cell.model
    params, alive = model.scene(cell, seed, dev)
    center, radius = _center_radius(params, alive)
    views = poses.view_poses(mix["views"], center, radius)
    gt = [model.frame(cell, params, alive, _camera(mix, v))[0]
          for v in views]
    order = poses.view_order(len(views), seed)
    return views, gt, order


def reference_steps(cell: Cell, seed: int, dev, views, gt, order,
                    dtype=torch.float32, steps: int = 3):
    """The reference's first ``steps`` steps in ``dtype`` from the cell's
    inputs: (losses, the first gradient as the optimizer got it, the
    start, the alive mask, the change over the steps)."""
    mix, model = cell.mix, cell.model
    params, alive = model.scene(cell, seed, dev)
    start = scenes.perturbed(params, mix["perturb"], seed)
    del params
    opt = model.optimizer(cell, start, dtype)
    cur, losses, g1 = start, [], None
    for k in range(steps):
        v = int(order[k % len(order)])
        loss, grads = model.loss_grad(cell, cur, alive,
                                      _camera(mix, views[v]), gt[v], dtype)
        g = opt.prepare(grads, alive)
        del grads
        if k == 0:
            g1 = {name: x.float() for name, x in g.items()}
        losses.append(loss)
        cur = opt.step(cur, g)
    delta = {name: cur[name].float() - start[name] for name in start}
    return losses, g1, start, alive, delta


def run_train(cell: Cell, seed: int, seconds: float, trace: bool, dev,
              t_start: float, hooks=None):
    mix, model, hooks = cell.mix, cell.model, hooks or {}
    parts = {"start": time.perf_counter() - t_start}
    views, gt, order = _train_inputs(cell, seed, dev)
    parts["ground_truth"] = time.perf_counter() - t_start
    _free(dev)
    _reset_peak(dev)  # the system's peak, not the ground truth's render
    pool = model.program_train_pool(cell, seed, dev)
    cfg, demands = model.render_config(cell, pool, views)
    parts["sized"] = time.perf_counter() - t_start
    state, step, batches = model.train_entry(cell, pool, cfg, views, gt,
                                             hooks)
    records, losses, g1, p3 = [], [], None, None
    n = len(order)
    for k in range(mix["warmup"]):  # the first steps, compared below
        state, m = step(state, batches[order[k % n]])
        records.append(_kept(m))
        if k == 0:
            _sync(dev)
            parts["first_step"] = time.perf_counter() - t_start
        if k < 3:
            losses.append(float(m["total"]))
        if k == 0:
            g1 = model.first_grad(state)
        if k == 2:
            p3 = model.trained_params(state)
    _sync(dev)
    _settle()
    setup_s = time.perf_counter() - t_start
    setup_peak = _peak(dev)
    failed = _train_failures(records, cfg)

    _reset_peak(dev)
    win = []
    k = mix["warmup"]
    t0 = time.perf_counter()
    while True:
        try:
            state, m = step(state, batches[order[k % n]])
            win.append(_kept(m))
        except Exception:  # a step that raises is a failed step
            win.append(None)
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    window_peak = _peak(dev)
    steps = len(win)
    failed += sum(1 for m in win if m is None)
    failed += _train_failures([m for m in win if m is not None], cfg)
    out = {
        "attempted": steps, "failed": failed,
        "e2e": {"train_views_per_s": stats.rate(steps, window_s),
                "train_peak_gib": window_peak / 2**30,
                "setup_s": setup_s},
        "memory_peak_bytes": max(setup_peak, window_peak),
        "info": {"steps": steps, "window_s": window_s,
                 "setup_parts": parts, "max_pairs": cfg.max_pairs,
                 "max_demand": int(max(demands)),
                 "losses": losses},
    }
    traced = []
    if trace:
        st = {"k": k, "state": state}

        def one():
            j = st["k"]
            st["state"], _ = step(st["state"], batches[order[j % n]])
            _sync(dev)
            traced.append(order[j % n])
            st["k"] = j + 1

        tr = tracing.capture(one, mix["trace_units"])
        traced = traced[-mix["trace_units"]:]
        out["trace"] = tr
        out["memory_peak_bytes"] = max(out["memory_peak_bytes"], _peak(dev))
        state = st["state"]
    t_ref = time.perf_counter()
    del state, step, pool, batches, records, win
    _free(dev)

    # The reference follows the first three steps from the same inputs.
    ref_losses, ref_g1, start, alive, ref_delta = reference_steps(
        cell, seed, dev, views, gt, order)
    prog_delta = {name: p3[name].to(dev) - start[name] for name in start}
    prog_g1 = {name: v.to(dev) for name, v in g1.items()}
    out["numbers"] = model.train_numbers(losses, ref_losses, prog_g1,
                                         ref_g1, prog_delta, ref_delta)
    del ref_delta, prog_delta, prog_g1, ref_g1
    if trace:
        per_view = {}
        for v in sorted(set(traced)):
            per_view[v] = model.frame(cell, start, alive,
                                      _camera(mix, views[v]),
                                      count_work=True)[1]
        out["ctx"] = {"kind": "train", "units": len(traced),
                      "unit_s": window_s / steps,
                      "counts": work.add([per_view[v] for v in traced])}
    out["info"]["compare_s"] = time.perf_counter() - t_ref
    return out


def _kept(metrics: dict) -> dict:
    """The step's counters that are checked after the window: the pair
    demand and the non-finite flag (0-d tensors, no sync). The rest, such
    as the position gradient, is let go with the step."""
    return {k: metrics[k] for k in ("pair_demand", "nonfinite_skipped")
            if k in metrics}


def _settle():
    """End of set-up: collect, then freeze what set-up left (the program,
    its modules and state), so that the collector's passes in the window
    scan only what the window makes."""
    gc.collect()
    gc.freeze()


def _train_failures(records: list, cfg) -> int:
    """Steps whose pair demand overflowed the capacity or whose update was
    skipped as non-finite (read after the fact: no sync in the loop)."""
    if not records:
        return 0
    dem = torch.stack([torch.as_tensor(m["pair_demand"]).reshape(())
                       for m in records]).cpu().numpy()
    bad = dem > cfg.max_pairs
    if "nonfinite_skipped" in records[0]:
        skip = torch.stack([torch.as_tensor(m["nonfinite_skipped"])
                            .reshape(()) for m in records]).cpu().numpy()
        bad = bad | (skip != 0)
    return int(np.sum(bad))


# -- the result -------------------------------------------------------------

DRIVERS = {"serve": run_serve, "train": run_train}


def driver(cell: Cell):
    """The driver of the cell's traffic ``kind``: the harness's, or one
    that the cell's model adds in its ``DRIVERS`` (same signature and
    result as :func:`run_serve`)."""
    kind = cell.mix["kind"]
    found = DRIVERS.get(kind) or getattr(cell.model, "DRIVERS", {}).get(kind)
    if found is None:
        raise KeyError(f"no driver for traffic kind {kind!r}")
    return found


def layer_metrics(cell: Cell, out: dict) -> dict:
    """Each per-layer metric's reader over the traced stretch; a reader
    that finds nothing to read returns None and the metric is left out."""
    ctx = dict(out["ctx"], trace=out["trace"])
    res = {}
    for m in cell.per_layer:
        got = load_reader(m["name"], cell.here).read(ctx)
        if got is None:
            continue
        got = dict(got) if isinstance(got, dict) else {"value": got}
        res[m["name"]] = {"value": got.pop("value"), "unit": m["unit"], **got}
    return res


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None,
             hooks=None) -> dict:
    """One run; returns the result line as a dict (``checks`` last)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter() if t_start is None else t_start
    out = driver(cell)(cell, seed, seconds, trace, dev, t_start, hooks)
    checks = {name: {"value": out["numbers"][name], "limit": limit}
              for name, limit in cell.limits.items()}
    correct = out["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    device = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1,
        "memory_peak_bytes": int(out["memory_peak_bytes"]),
    }
    if trace:
        tr = out["trace"]
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        metrics = layer_metrics(cell, out)
    else:
        metrics = {}
        for m in cell.e2e:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": device}
    if trace:
        line["breakdown"] = {
            "device_ops": tracing.top_device_ops(out["trace"]),
            "idle_gaps": [[n, s] for n, s in out["trace"].gaps],
        }
    line["info"] = out["info"]
    if trace:
        line["info"]["traced"] = {k: out["ctx"][k] for k in
                                  ("units", "unit_s", "counts")}
    line["checks"] = checks
    return line
