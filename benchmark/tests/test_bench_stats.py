"""The arithmetic of the end-to-end metrics and of the traced window, on
synthetic records and a synthetic Chrome trace, and the per-layer
readers on it."""

from __future__ import annotations

import pytest

from conftest import ROOT  # noqa: F401  (the repository on the path)

from benchmark import counts, harness, stats, tracing


def test_percentile_rate_idle_and_merge():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == pytest.approx(95.05)
    assert stats.percentile(vals[::-1], 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1.0, 2.0], 50) == pytest.approx(1.5)
    assert stats.rate(500, 10.0) == 50.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    assert stats.idle_share(0.25, 1.0) == 0.75
    assert stats.idle_share(2.0, 1.0) == 0.0
    assert stats.merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def _events():
    """Two frames' worth of events (microseconds): host ops, launches and
    device records, with a 100 us idle gap while the host runs aten::sort."""
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": args}
    return [
        x("cpu_op", "aten::add", 0, 20),
        x("cuda_runtime", "cudaLaunchKernel", 5, 5, correlation=1),
        x("kernel", "void at::native::add_kernel", 10, 40, correlation=1),
        x("kernel", "void raster_fwd_kernel<16, 256, false, 0>", 50, 30),
        x("cpu_op", "aten::sort", 70, 150),
        x("gpu_memcpy", "Memcpy HtoD", 180, 20),
        x("kernel", "void tile_order_kernel", 200, 10),
        x("kernel", "void raster_bwd_kernel<16, false>", 210, 40),
        {"ph": "i", "name": "instant", "ts": 300},
    ]


def test_trace_reading():
    tr = tracing.read_events(_events())
    assert tr.window_s == pytest.approx(250e-6)
    assert tr.busy_s == pytest.approx(140e-6)  # 10-80, 180-250
    assert len(tr.kernels) == 4
    assert tr.gaps[0][0] == "aten::sort"
    assert tr.gaps[0][1] == pytest.approx(100e-6)
    k1 = tr.kernel_time(lambda n: "raster_fwd_kernel" in n
                        or "tile_order_kernel" in n)
    assert k1 == pytest.approx(40e-6)
    top = tracing.top_device_ops(tr)
    assert top[0][0].startswith("void at::native::add_kernel")
    assert top[0][1] == pytest.approx(40e-6)


def _ctx(kind, units=2, unit_s=0.01):
    c = {"gaussians": 100, "pairs": 1000, "live_pairs": 400,
         "contrib_pairs": 300, "pair_pixels": 50_000, "pixels": 64 * 48,
         "slots": 200}
    return {"kind": kind, "units": units, "unit_s": unit_s, "counts": c,
            "trace": tracing.read_events(_events())}


def test_layer_readers_on_a_synthetic_trace():
    serve, train = _ctx("serve"), _ctx("train")
    read = {n: harness.load_reader(n).read for n in (
        "launches_per_frame.serve", "launches_per_view.train",
        "stages_device_ms.serve", "stages_device_ms.train",
        "k1_roofline.serve", "k2_roofline.train",
        "device_idle_share.serve", "device_idle_share.train",
        "frame_mfu.serve", "step_mfu.train")}
    assert read["launches_per_frame.serve"](serve) == 2.0
    assert read["launches_per_frame.serve"](train) is None
    assert read["launches_per_view.train"](train) == 2.0
    # Every kernel but K1's: the add kernel and K2, merged, per frame.
    assert read["stages_device_ms.serve"](serve) == pytest.approx(0.04)
    # Every kernel but K1's and K2's.
    assert read["stages_device_ms.train"](train) == pytest.approx(0.02)
    k1 = read["k1_roofline.serve"](serve)
    sol, bound = counts.sol(*counts.k1_work(serve["counts"]))
    assert k1["value"] == pytest.approx(100 * sol / 40e-6)
    assert k1["bound"] == bound
    k2 = read["k2_roofline.train"](train)
    assert k2["value"] == pytest.approx(
        100 * counts.sol(*counts.k2_work(train["counts"]))[0] / 40e-6)
    assert read["device_idle_share.serve"](serve) == pytest.approx(44.0)
    mfu = read["frame_mfu.serve"](serve)
    assert mfu["value"] == pytest.approx(
        100 * counts.sol(*counts.frame_work(serve["counts"]))[0] / 0.02)
    assert read["step_mfu.train"](train)["value"] > 0


def test_a_reader_with_nothing_to_read_returns_none():
    ctx = _ctx("serve")
    ctx["trace"] = tracing.read_events(
        [e for e in _events() if "raster" not in e.get("name", "")
         and "tile_order" not in e.get("name", "")])
    assert harness.load_reader("k1_roofline.serve").read(ctx) is None
    assert harness.load_reader("k2_roofline.train").read(
        _ctx("serve")) is None


def test_a_captured_stretch_carries_the_program_spans():
    import torch

    def frame():
        with torch.profiler.record_function("gs.frame"):
            with torch.profiler.record_function("gs.bin"):
                torch.ones(64).cumsum(0)

    tr = tracing.capture(frame, 2)
    names = [r[0] for r in tr.ranges]
    assert names.count("gs.frame") == 2 and names.count("gs.bin") == 2
    assert len(tr.calls) == len(tr.device)
    ctx = dict(_ctx("serve"), trace=tr)
    host = harness.load_reader("host_enqueue_ms.serve").read(ctx)
    assert host == pytest.approx(
        sum(d for n, _, _, d in tr.ranges if n == "gs.frame") * 1e3 / 2)
    # Chrome-trace events alone: no spans, the span readers stay silent.
    assert tracing.read_events(_events()).ranges == []
    assert harness.load_reader("host_enqueue_ms.serve").read(
        _ctx("serve")) is None
