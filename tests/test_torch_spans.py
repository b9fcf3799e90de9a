"""The port's spans: every stage it names in a ``torch.profiler`` trace,
their nesting in a served frame and a train step, their cost when
nothing traces, the rule that credits each device record to a span (the
program's ``utils.profiling.owners`` and the benchmark's frozen copy in
``benchmark/spans.py``), and the benchmark's readers of the spans beside
the readers that were there before them.

All on the CPU at a tiny size: a 500-gaussian scene at 48x32. The CPU
trace holds host ranges only; the device side of the rule is held on
synthetic Chrome traces.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch import scene
from gsplat_tpu_torch.utils import profiling as tprof
from gsplat_tpu_torch.viewer import make_batch_render_fn, make_render_fn

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, spans, tracing  # noqa: E402

H, W = 32, 48
FX = FY = 40.0
CX, CY = 24.0, 16.0
SERVE = ("gs.frame", "gs.pose", "gs.cov_sh", "gs.project", "gs.bin",
         "gs.gather", "gs.k1")
OLD_READERS = ("launches_per_frame.serve", "launches_per_view.train",
               "stages_device_ms.serve", "stages_device_ms.train",
               "k1_roofline.serve", "k2_roofline.train",
               "device_idle_share.serve", "device_idle_share.train",
               "frame_mfu.serve", "step_mfu.train")
NEW_READERS = ("host_enqueue_ms.serve", "idle_in_program_ms.serve",
               "idle_in_program_ms.train", "binning_device_ms.serve",
               "gather_device_ms.serve", "pair_grads_device_ms.train",
               "update_device_ms.train")


@pytest.fixture(scope="module")
def small():
    params = scene.make_scene(500, seed=1, device="cpu")
    cfg = gt.RenderConfig(height=H, width=W, max_pairs=8192)
    return params, cfg


def _ranges(run, tmp_path):
    """The ``gs.*`` ranges a CPU trace of ``run()`` holds, as
    (name, tid, start, end)."""
    with tprof.trace(str(tmp_path)) as prof:
        run()
    with open(prof.chrome_trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["tid"], float(e["ts"]),
             float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("gs.")]


def _inside(inner, outer, rs, same_thread=True):
    """Every range named ``inner`` lies inside a range named ``outer``."""
    outs = [r for r in rs if r[0] == outer]
    return all(any(o[2] <= r[2] and r[3] <= o[3]
                   and (o[1] == r[1] or not same_thread) for o in outs)
               for r in rs if r[0] == inner)


@pytest.mark.parametrize("entry", ["make_render_fn", "make_batch_render_fn"])
def test_served_frame_holds_every_serving_span(small, tmp_path, entry):
    params, cfg = small
    pose = np.eye(4, dtype=np.float32)
    if entry == "make_render_fn":
        fn = make_render_fn(params, cfg, FX, FY, CX, CY, report_demand=True)
        arg = pose
    else:
        fn = make_batch_render_fn(params, cfg, FX, FY, CX, CY)
        arg = np.stack([pose, pose])
    fn(arg)  # warm-up, outside the trace
    rs = _ranges(lambda: fn(arg), tmp_path)
    assert {r[0] for r in rs} == set(SERVE)
    assert sum(r[0] == "gs.frame" for r in rs) == 1
    for name in SERVE[1:]:
        assert _inside(name, "gs.frame", rs), name
    # The leaves follow one another: none holds another.
    leaves = sorted((r for r in rs if r[0] != "gs.frame"),
                    key=lambda r: r[2])
    assert all(a[3] <= b[2] for a, b in zip(leaves, leaves[1:]))


def test_pair_demand_holds_the_binning_spans(small, tmp_path):
    params, cfg = small
    rs = _ranges(lambda: gt.pair_demand(params, np.eye(4), FX, FY, CX, CY,
                                        cfg), tmp_path)
    assert {r[0] for r in rs} == {"gs.pose", "gs.cov_sh", "gs.project",
                                  "gs.bin"}


def test_train_step_holds_the_step_spans(small, tmp_path):
    params, cfg = small
    n = params["pos"].shape[0]
    pool = gt.GaussianPool({k: v.clone() for k, v in params.items()},
                           torch.ones(n, dtype=torch.bool))
    tcfg = gt.TrainConfig(capacity=n, batch_size=1)
    state = gt.init_train_state(pool, tcfg)
    step = gt.make_train_step(cfg, tcfg)
    batch = {"image": torch.rand(1, H, W, 3, generator=torch.Generator()
                                 .manual_seed(0)),
             "c2w": torch.eye(4)[None],
             **{k: torch.full((1,), v) for k, v in
                (("fx", FX), ("fy", FY), ("cx", CX), ("cy", CY))}}
    state, _ = step(state, batch)  # warm-up, outside the trace
    rs = _ranges(lambda: step(state, batch), tmp_path)
    names = {r[0] for r in rs}
    assert names == set(SERVE[1:]) | {"gs.step", "gs.loss", "gs.backward",
                                      "gs.k2", "gs.pair_grads", "gs.update"}
    for name in names - {"gs.step"}:
        assert _inside(name, "gs.step", rs, same_thread=False), name
    for name in ("gs.loss", "gs.backward", "gs.update"):
        assert _inside(name, "gs.step", rs), name
    # On the CPU autograd runs the backward on the caller's thread; on a
    # card K2 and the reduction run on its device thread, inside in time.
    for name in ("gs.k2", "gs.pair_grads"):
        assert _inside(name, "gs.backward", rs, same_thread=False), name


def test_span_costs_no_dispatcher_call_when_nothing_traces(small,
                                                           monkeypatch):
    params, cfg = small
    assert tprof.span("gs.frame") is tprof.span("gs.bin")
    made = []

    def counting(name):
        made.append(name)
        return torch.autograd.profiler.record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    fn = make_render_fn(params, cfg, FX, FY, CX, CY)
    fn(np.eye(4, dtype=np.float32))
    assert made == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fn(np.eye(4, dtype=np.float32))
    assert made == list(SERVE)


def test_every_span_name_is_recorded_and_listed():
    """The names the program passes to ``span`` are :data:`SPANS`, each
    recorded somewhere; the frame's leaves are ``profile_trace.STAGES``."""
    from gsplat_tpu_torch import profile_trace

    used = set()
    pkg = ROOT / "gsplat_tpu_torch"
    for path in pkg.rglob("*.py"):
        used |= set(re.findall(r'span\("(gs\.[a-z0-9_]+)"\)',
                               path.read_text()))
    assert used == set(tprof.SPANS)
    assert len(set(tprof.SPANS)) == len(tprof.SPANS)
    assert profile_trace.STAGES == SERVE[1:]


# --- the attribution rule on a synthetic trace --------------------------------

MAIN, AUTOGRAD, STREAM = 1, 2, 7


def _x(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _step_events(with_ranges=True):
    """One train step (microseconds): the forward's gather and K1 on the
    main thread, the backward's K2 and reduction on autograd's thread,
    a plain backward kernel that thread launches outside its own ranges,
    the update; a memcpy matched by correlation, a record whose call the
    trace lacks and a launch outside every range."""
    rs = [
        _x("user_annotation", "ProfilerStep#2", 0, 1200),
        _x("user_annotation", "gs.step", 0, 1000),
        _x("user_annotation", "gs.gather", 10, 30),
        _x("user_annotation", "gs.k1", 40, 40),
        _x("user_annotation", "gs.backward", 100, 800),
        _x("user_annotation", "gs.k2", 200, 100, tid=AUTOGRAD),
        _x("user_annotation", "gs.pair_grads", 300, 100, tid=AUTOGRAD),
        _x("user_annotation", "gs.update", 900, 90),
    ]
    calls = [
        _x("cuda_runtime", "cudaLaunchKernel", 15, 2, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 45, 2, corr=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 50, 2, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 2, AUTOGRAD, 4),
        _x("cuda_runtime", "cudaLaunchKernel", 310, 2, AUTOGRAD, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 500, 2, AUTOGRAD, 6),
        _x("cuda_runtime", "cudaLaunchKernel", 950, 2, corr=7),
        _x("cuda_runtime", "cudaLaunchKernel", 1100, 2, corr=8),
        _x("cpu_op", "aten::index_select", 12, 20),
    ]
    dev = [
        _x("kernel", "gather_kernel", 20, 30, STREAM, 1),
        _x("kernel", "void raster_fwd_kernel<16, 128>", 60, 20, STREAM, 2),
        _x("gpu_memcpy", "Memcpy DtoD", 80, 10, STREAM, 3),
        _x("kernel", "void raster_bwd_kernel<16>", 220, 60, STREAM, 4),
        _x("kernel", "sort_kernel", 320, 50, STREAM, 5),
        _x("kernel", "select_backward_kernel", 520, 40, STREAM, 6),
        _x("kernel", "adam_kernel", 955, 30, STREAM, 7),
        _x("kernel", "harness_kernel", 1110, 20, STREAM, 8),
        _x("kernel", "lost_call_kernel", 600, 10, STREAM, 99),
    ]
    return (rs if with_ranges else rs[:1]) + calls + dev


# The span each device record above is credited to, in order.
OWNER = ["gs.gather", "gs.k1", "gs.k1", "gs.k2", "gs.pair_grads",
         "gs.backward", "gs.update", None, None]


@pytest.mark.parametrize("rule", ["program", "benchmark"])
def test_attribution_rule_on_a_synthetic_trace(rule):
    ev = _step_events()
    corr = [e["args"].get("correlation") for e in ev
            if e["cat"] in tprof.DEVICE_CATS]
    if rule == "program":
        ranges = [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"])
                  for e in ev if e["cat"] == "user_annotation"
                  and e["name"].startswith("gs.")]
        calls = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in ev
                 if e["cat"] in tprof.CALL_CATS}
        own = tprof.owners(calls, ranges)
        got = [own.get(c) for c in corr]
    else:
        ranges, calls = spans.read_spans(ev)
        got = spans.owners(ranges, calls)
    assert [None if i is None else ranges[i][0] for i in got] == OWNER


def test_summarize_trace_credits_nested_ranges(tmp_path):
    path = tmp_path / "step.json"
    path.write_text(json.dumps({"traceEvents": _step_events()}))
    r = tprof.summarize_trace(str(path))["ranges"]
    assert "ProfilerStep#2" not in r
    # Inside gs.k1 (40-80) the gather's kernel runs to 50, K1 from 60.
    assert r["gs.k1"] == {"host_us": 40.0, "launches": 2, "kernels": 2,
                          "busy_us": 30.0, "self_busy_us": 30.0,
                          "idle_us": 10.0}
    # The backward holds its own kernel and, by time, K2's and the
    # reduction's on autograd's thread.
    assert r["gs.backward"]["busy_us"] == 60.0 + 50.0 + 40.0
    assert r["gs.backward"]["self_busy_us"] == 40.0
    assert r["gs.backward"]["kernels"] == 3
    # The step holds every record but the harness's and the lost one.
    assert r["gs.step"]["kernels"] == 7
    assert r["gs.step"]["busy_us"] == 30 + 30 + 60 + 50 + 40 + 30
    assert r["gs.step"]["self_busy_us"] == 0.0
    assert r["gs.step"]["idle_us"] == 1000.0 - 250.0
    # With a root, the ranges outside it are left out and own nothing.
    r = tprof.summarize_trace(str(path), root="gs.backward")["ranges"]
    assert set(r) == {"gs.backward", "gs.k2", "gs.pair_grads"}
    assert r["gs.backward"]["busy_us"] == 150.0


# --- the benchmark's readers ----------------------------------------------------

def _ctx(kind, events, with_fields=True, units=1):
    tr = tracing.read_events(events)
    if with_fields:
        tr.ranges, tr.calls = spans.read_spans(events)
    c = {"gaussians": 100, "pairs": 1000, "live_pairs": 400,
         "contrib_pairs": 300, "pair_pixels": 50_000, "pixels": 64 * 48,
         "slots": 200}
    return {"kind": kind, "units": units, "unit_s": 0.01, "counts": c,
            "trace": tr}


@pytest.mark.parametrize("name", OLD_READERS)
def test_existing_readers_ignore_the_spans(name):
    read = harness.load_reader(name).read
    kind = name.rsplit(".", 1)[1]
    plain = read(_ctx(kind, _step_events(False), with_fields=False))
    spanned = read(_ctx(kind, _step_events()))
    assert plain is not None and plain == spanned


def _serve_events():
    """Two served frames (microseconds): each ``gs.frame`` holds the
    binning and the gather; between them the harness waits."""
    ev = [_x("user_annotation", "ProfilerStep#2", 0, 1000)]
    for f, t0 in enumerate((0, 500)):
        ev += [
            _x("user_annotation", "gs.frame", t0, 300),
            _x("user_annotation", "gs.bin", t0 + 10, 100),
            _x("user_annotation", "gs.gather", t0 + 110, 50),
            _x("cuda_runtime", "cudaLaunchKernel", t0 + 20, 2, corr=10 * f),
            _x("cuda_runtime", "cudaLaunchKernel", t0 + 30, 2,
               corr=10 * f + 1),
            _x("cuda_runtime", "cudaLaunchKernel", t0 + 120, 2,
               corr=10 * f + 2),
            # binning: two overlapping kernels, 100 us merged
            _x("kernel", "sort_kernel", t0 + 50, 80, STREAM, 10 * f),
            _x("kernel", "scan_kernel", t0 + 100, 50, STREAM, 10 * f + 1),
            # the gather's kernel runs on past the frame's enqueue
            _x("kernel", "gather_kernel", t0 + 250, 100, STREAM,
               10 * f + 2),
        ]
    return ev


@pytest.mark.parametrize("name,want", [
    ("host_enqueue_ms.serve", 0.300),
    # Inside each 300 us frame the device runs 50-150 and 250-300.
    ("idle_in_program_ms.serve", 0.150),
    ("binning_device_ms.serve", 0.100),
    ("gather_device_ms.serve", 0.100),
])
def test_span_readers_of_serving(name, want):
    read = harness.load_reader(name).read
    assert read(_ctx("serve", _serve_events(), units=2)) == \
        pytest.approx(want)
    assert read(_ctx("train", _serve_events(), units=2)) is None
    # The parent's trace carries no spans: the metric is left out.
    assert read(_ctx("serve", _serve_events(), with_fields=False)) is None


@pytest.mark.parametrize("name,want", [
    ("idle_in_program_ms.train", 1.0 - 0.25),
    ("pair_grads_device_ms.train", 0.050),
    ("update_device_ms.train", 0.030),
])
def test_span_readers_of_training(name, want):
    read = harness.load_reader(name).read
    assert read(_ctx("train", _step_events())) == pytest.approx(want)
    assert read(_ctx("serve", _step_events())) is None
    assert read(_ctx("train", _step_events(), with_fields=False)) is None
    # A step without the span (a program that does not record it).
    ev = [e for e in _step_events()
          if e["name"] not in ("gs.step", "gs.pair_grads", "gs.update")]
    assert read(_ctx("train", ev)) is None


def test_readers_read_spans_the_program_records():
    for name in NEW_READERS:
        mod = harness.load_reader(name)
        assert mod.SPAN in tprof.SPANS, name
    assert spans.PREFIX == "gs." and all(
        s.startswith(spans.PREFIX) for s in tprof.SPANS)
    assert spans.DEVICE_CATS == tracing.DEVICE_CATS == tprof.DEVICE_CATS
    assert spans.CALL_CATS == tprof.CALL_CATS


def test_owned_share_of_a_synthetic_step():
    tr = _ctx("train", _step_events())["trace"]
    # 240 us credited; 20 us of the harness's kernel and 10 us of the
    # record whose call is lost are not.
    assert spans.owned_share(tr) == pytest.approx(240.0 / 270.0)
    assert spans.owned_share(tracing.read_events(_step_events())) is None


# --- on a card -------------------------------------------------------------------

@pytest.mark.gpu
def test_spans_own_the_device_work_on_a_card(tmp_path):
    """A served frame and a train step at 480x270 on the card, each traced
    after a warm-up: their root span owns at least 99 % of the
    device's busy time; K1's, binning's and the gather's kernels fall in
    their spans; K2 and the reduction run on autograd's device thread,
    in their spans, and the plain autograd kernels fall to the backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = scene.make_scene(20000, seed=1, device="cuda")
    cfg = gt.RenderConfig(height=270, width=480, max_pairs=2**20)
    fx = 0.85 * 480

    def traced(run):
        run()
        torch.cuda.synchronize()
        with tprof.trace(str(tmp_path)) as prof:
            run()
            torch.cuda.synchronize()
        return prof.chrome_trace_path

    fn = make_render_fn(params, cfg, fx, fx, 240.0, 135.0)
    s = tprof.summarize_trace(traced(lambda: fn(np.eye(4))))
    r = s["ranges"]
    assert r["gs.frame"]["busy_us"] >= 0.99 * s["busy_us"] > 0
    for name in ("gs.bin", "gs.gather", "gs.k1"):
        assert r[name]["kernels"] > 0 and r[name]["busy_us"] > 0, name
    assert r["gs.k1"]["launches"] == r["gs.k1"]["kernels"]

    n = params["pos"].shape[0]
    pool = gt.GaussianPool({k: v.clone() for k, v in params.items()},
                           torch.ones(n, dtype=torch.bool, device="cuda"))
    tcfg = gt.TrainConfig(capacity=n, batch_size=1)
    box = {"state": gt.init_train_state(pool, tcfg)}
    step = gt.make_train_step(cfg, tcfg)
    batch = {"image": torch.rand(1, 270, 480, 3, device="cuda"),
             "c2w": torch.eye(4, device="cuda")[None],
             **{k: torch.full((1,), v, device="cuda") for k, v in
                (("fx", fx), ("fy", fx), ("cx", 240.0), ("cy", 135.0))}}

    def one():
        box["state"], _ = step(box["state"], batch)

    path = traced(one)
    s = tprof.summarize_trace(path)
    r = s["ranges"]
    assert r["gs.step"]["busy_us"] >= 0.99 * s["busy_us"] > 0
    for name in ("gs.loss", "gs.k2", "gs.pair_grads", "gs.update"):
        assert r[name]["kernels"] > 0, name
    assert r["gs.backward"]["self_busy_us"] > 0
    with open(path) as f:
        tid = {e["name"]: e["tid"] for e in json.load(f)["traceEvents"]
               if e.get("cat") == "user_annotation"}
    assert tid["gs.k2"] == tid["gs.pair_grads"] != tid["gs.backward"]
