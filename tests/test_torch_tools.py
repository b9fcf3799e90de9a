"""Port parity: the viewer's export helpers, the profiling utilities, the
benchmark scene, the measuring CLIs and the small camera/covariance
helpers, on the CPU.

What is held, and how closely:

* ``colorize_depth`` and ``save_image`` equal to JAX's bit for bit;
  ``save_video`` writes the same PNG frames as JAX's and returns the same
  path (the ``.mp4``, or, where neither imageio's ffmpeg plugin nor an
  ffmpeg binary is installed, the PNG directory, in both), and writes a
  video through imageio where a backend exists (a ``.gif``, imageio's
  Pillow plugin);
* ``benchmark_fn`` returns JAX's keys; ``trace`` writes a Chrome trace
  whose host operators name the render's operations, which
  ``summarize_trace`` reads back; ``scene.make_scene`` equals
  ``bench.make_scene`` bit for bit;
* each new CLI once with ``--device cpu`` at a tiny size:
  ``profile_stages``, ``profile_trace``, ``profile_binning``,
  ``cull_sweep`` (its demand and kept integers equal to JAX's
  ``pair_demand`` and binning on the same inputs), ``trunc_error_ladder``
  (its demand integers equal to JAX's) and ``render_trained`` with
  ``--backend xla --save_depth --output_dir --fps``;
* ``Intrinsics``, ``check_frustum_camera_space``, ``project_points``,
  ``inv2x2`` and ``build_sigma_from_params`` against JAX's: masks exactly,
  floats within 1e-6 of each output's largest value.
"""

import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import gsplat_tpu as gj
import gsplat_tpu.viewer as jviewer
import gsplat_tpu_torch as gt
import gsplat_tpu_torch.viewer as tviewer
from gsplat_tpu.data import images as jimages
from gsplat_tpu.ops import camera as jcam
from gsplat_tpu.ops import gaussian as jgau
from gsplat_tpu.utils import profiling as jprof
from gsplat_tpu_torch import (cull_sweep, profile_binning, profile_stages,
                              profile_trace, render_trained, scene,
                              trunc_error_ladder)
from gsplat_tpu_torch.data import images as timages
from gsplat_tpu_torch.ops import camera as tcam
from gsplat_tpu_torch.ops import gaussian as tgau
from gsplat_tpu_torch.utils import profiling as tprof
from test_torch_render import CKPT

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jtrainer = importlib.import_module("gsplat_tpu.train.trainer")
jbin = importlib.import_module("gsplat_tpu.ops.binning")
jproj = importlib.import_module("gsplat_tpu.ops.projection")


def _frames(n=3, h=12, w=20, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(n)]


def _pngs(d):
    return [np.asarray(Image.open(os.path.join(d, f)))
            for f in sorted(os.listdir(d)) if f.endswith(".png")]


# --- export helpers -----------------------------------------------------------

@pytest.mark.parametrize("with_alpha", [True, False])
def test_colorize_depth_matches_jax(with_alpha):
    rng = np.random.default_rng(3)
    depth = rng.uniform(0, 8, (24, 32)).astype(np.float32)
    depth[:4] = 0.0
    alpha = rng.uniform(0, 1, (24, 32)).astype(np.float32) \
        if with_alpha else None
    got = tviewer.colorize_depth(depth, alpha)
    want = jviewer.colorize_depth(depth, alpha)
    assert got.dtype == want.dtype and got.shape == (24, 32, 3)
    np.testing.assert_array_equal(got, want)
    # JAX's test_colorize_depth: monotone with depth.
    img = tviewer.colorize_depth(np.linspace(2, 8, 64).reshape(8, 8),
                                 np.ones((8, 8)))
    assert img.min() >= 0.0 and img.max() <= 1.0
    assert img[0, 0, 0] < img[-1, -1, 0]


def test_save_image_matches_jax(tmp_path):
    img = np.random.default_rng(1).uniform(-0.1, 1.1, (9, 11, 3)).astype(
        np.float32)
    for ext in (".png", ".npy"):
        timages.save_image(str(tmp_path / f"t{ext}"), img)
        jimages.save_image(str(tmp_path / f"j{ext}"), img)
        load = np.load if ext == ".npy" else (
            lambda p: np.asarray(Image.open(p)))
        np.testing.assert_array_equal(load(str(tmp_path / f"t{ext}")),
                                      load(str(tmp_path / f"j{ext}")))


def test_save_video_matches_jax(tmp_path):
    frames = _frames()
    got = tviewer.save_video(frames, str(tmp_path / "t" / "orbit.mp4"),
                             fps=7)
    want = jviewer.save_video(frames, str(tmp_path / "j" / "orbit.mp4"),
                              fps=7)
    # Same outcome (the video, or the PNG directory where no writer is).
    assert os.path.relpath(got, tmp_path / "t") == os.path.relpath(
        want, tmp_path / "j")
    tp = _pngs(tmp_path / "t" / "orbit_frames")
    jp = _pngs(tmp_path / "j" / "orbit_frames")
    assert len(tp) == len(jp) == 3
    for a, b, f in zip(tp, jp, frames):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, f)


def test_save_video_writes_through_imageio(tmp_path):
    imageio = pytest.importorskip("imageio.v2")
    frames = [np.full((16, 16, 3), 40 * i, np.uint8) for i in range(4)]
    path = str(tmp_path / "orbit.gif")
    assert tviewer.save_video(frames, path, fps=5) == path
    back = imageio.mimread(path)
    assert len(back) == 4 and back[0].shape[:2] == (16, 16)
    assert len(_pngs(tmp_path / "orbit_frames")) == 4


# --- profiling utilities and the benchmark scene -----------------------------

def test_benchmark_fn_keys_match_jax():
    x = torch.ones(64)
    got = tprof.benchmark_fn(lambda a: a * 2.0, x, iters=3, warmup=1,
                             pixels=64)
    want = jprof.benchmark_fn(jax.jit(lambda a: a * 2.0), jnp.ones(64),
                              iters=3, warmup=1, pixels=64)
    assert set(got) == set(want)
    assert got["iters"] == 3 and got["fps"] > 0 and got["rays_per_s"] > 0
    assert got["min_ms"] <= got["median_ms"] <= got["max_ms"]
    assert "rays_per_s" not in tprof.benchmark_fn(lambda: x, iters=2)


def test_trace_names_the_render_operations(tmp_path):
    s = scene.make_scene(500, seed=1, device="cpu")
    cfg = gt.RenderConfig(height=32, width=48, max_pairs=8192)
    with tprof.trace(str(tmp_path)) as prof:
        with torch.no_grad():
            img, _ = gt.render_from_params(s, np.eye(4), 40.0, 40.0, 24.0,
                                           16.0, cfg)
    path = prof.chrome_trace_path
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for op in ("aten::sort", "aten::searchsorted", "aten::cumsum",
               "aten::exp"):
        assert op in names, op
    summary = tprof.summarize_trace(path)
    assert summary["kernels"] == 0 and summary["busy_us"] == 0.0
    assert summary["window_us"] > 0 and summary["cpu_ops"]["aten::sort"] >= 1
    with pytest.raises(ValueError):
        with tprof.trace(str(tmp_path), create_perfetto_link=True):
            pass


def test_summarize_trace_on_a_written_trace(tmp_path):
    """``summarize_trace`` on a small Chrome trace in the profiler's
    format: device busy as the union of kernel, copy and fill intervals,
    the idle gaps between them, counts per kernel name, and each
    ``record_function`` range's launches (kernels, copies and fills),
    the device records the trace holds for them (matched by correlation
    id; one record missing here), their busy union and the range's idle
    time."""
    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        x("user_annotation", "stage_a", 0, 100),
        x("user_annotation", "stage_b", 100, 100),
        x("cuda_runtime", "cudaLaunchKernel", 10, 5, 1),
        x("cuda_runtime", "cudaLaunchKernel", 20, 5, 2),
        x("cuda_runtime", "cudaLaunchKernel", 110, 5, 3),
        x("cuda_runtime", "cudaLaunchKernel", 120, 5, 4),  # no record
        x("cuda_runtime", "cudaMemsetAsync", 130, 5, 5),
        x("kernel", "k_sort", 50, 30, 1),
        x("kernel", "k_sort", 70, 30, 2),  # overlaps the first
        x("kernel", "k_add", 150, 20, 3),
        x("gpu_memset", "Memset", 180, 10, 5),
        x("cpu_op", "aten::sort", 5, 40),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = tprof.summarize_trace(str(path))
    assert s["window_us"] == 200.0
    assert s["busy_us"] == 50.0 + 20.0 + 10.0 and s["busy_share"] == 0.4
    assert s["kernels"] == 3 and s["by_kernel"]["k_sort"] == [2, 60.0]
    assert s["top"][0] == ("k_sort", 2, 60.0)
    assert s["gaps_us"] == [50.0, 10.0]
    assert s["cpu_ops"] == {"aten::sort": 1}
    assert s["ranges"]["stage_a"] == {"host_us": 100.0, "launches": 2,
                                      "kernels": 2, "busy_us": 50.0,
                                      "self_busy_us": 50.0, "idle_us": 50.0}
    # The fill counts as the range's: its call and record share an id.
    assert s["ranges"]["stage_b"] == {"host_us": 100.0, "launches": 3,
                                      "kernels": 2, "busy_us": 30.0,
                                      "self_busy_us": 30.0, "idle_us": 70.0}


def test_make_scene_matches_bench():
    sys.path.insert(0, ROOT)
    try:
        import bench
    finally:
        sys.path.remove(ROOT)
    want = bench.make_scene(300, seed=4)
    got = scene.make_scene(300, seed=4, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_tools_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        scene.make_scene(8)
    with pytest.raises(RuntimeError):
        profile_trace.main(["--gaussians", "8", "--height", "16",
                            "--width", "16"])


# --- the CLIs at a tiny size ---------------------------------------------------

def test_profile_stages_cli_on_cpu(tmp_path):
    r = profile_stages.main([
        "--device", "cpu", "--checkpoint", CKPT, "--height", "32",
        "--width", "48", "--tile_rank_cap", "1024", "--auto_pairs",
        "--bwd_pairs", "-1", "--reps", "1"])
    assert set(r["stages"]) == {"cov3d+sh", "project", "bin", "gather",
                                "rasterize_binned"}
    assert set(r["bwd_parts"]) == {"K2", "reduction", "proj+sh+cov_bwd"}
    cfg = r["cfg"]
    assert cfg.tile_rank_cap == 1024 and cfg.trunc_pairs >= 4096
    assert cfg.bwd_pairs >= 4096 and cfg.max_pairs >= r["num_pairs"]
    assert r["fwd"]["iters"] == 1 and r["device"] == "cpu"
    # The ellipse cull is ported: its binning is profiled (on a
    # 4,096-slot slice of the checkpoint, to keep the test short).
    small = str(tmp_path / "slice.npz")
    with np.load(CKPT) as d:
        np.savez(small, **{k: d[k][:4096] for k in d.files
                           if k.startswith("param_") or k == "__alive__"})
    e = profile_stages.main([
        "--device", "cpu", "--checkpoint", small, "--height", "32",
        "--width", "48", "--auto_pairs", "--cull_mode", "ellipse",
        "--reps", "1"])
    assert e["cfg"].cull_mode == "ellipse" and e["num_pairs"] > 0
    assert e["cfg"].max_pairs >= e["num_pairs"]


def test_profile_trace_cli_on_cpu(tmp_path, capsys):
    r = profile_trace.main(["--device", "cpu", "--log_dir", str(tmp_path),
                            "--gaussians", "400", "--height", "32",
                            "--width", "48", "--max_pairs", "8192",
                            "--iters", "2", "--backward"])
    assert os.path.isfile(r["path"])
    assert r["summary"]["cpu_ops"]["aten::sort"] >= 2
    assert "no device activity" in capsys.readouterr().out
    ranges = r["stages"]["ranges"]
    assert set(ranges) == {"gs.frame", *profile_trace.STAGES}
    assert all(v["host_us"] > 0 and v["kernels"] == 0
               for v in ranges.values())


def test_profile_binning_cli_on_cpu():
    t = profile_binning.main(["--device", "cpu", "--checkpoint", CKPT,
                              "--height", "32", "--width", "48",
                              "--max_pairs", "65536", "--iters", "1"])
    assert set(t) == {"project", "bin-full", "bin-trunc", "argsortN",
                      "drop", "emit", "sort", "runs", "align", "meta",
                      "corners", "cull", "compact", "gather"}
    assert all(v > 0 for v in t.values())


def _jax_pool():
    pool = jtrainer.restore_pool(CKPT)
    pos = np.asarray(pool.params["pos"])[np.asarray(pool.alive)]
    center, radius = jviewer.estimate_scene_center_radius(positions=pos)
    return pool, center, radius


def test_cull_sweep_cli_matches_jax_demand():
    H, W = 36, 64
    out = cull_sweep.main(["--device", "cpu", "--checkpoint", CKPT,
                           "--height", str(H), "--width", str(W),
                           "--chunks", "16", "64", "--iters", "1"])
    pool, center, radius = _jax_pool()
    poses = {
        "bench(4.4x)": jviewer.look_at(
            center + np.array([0.0, -0.6 * radius, -4.4 * radius]), center),
        "orbit(1.0x)": jviewer.look_at(
            center + np.array([0.0, -0.3 * radius, -1.0 * radius]), center),
    }
    fx = 0.85 * W
    for name, c2w in poses.items():
        for C in (16, 64):
            cfg = gj.RenderConfig(height=H, width=W, max_pairs=2**20,
                                  tile_rank_cap=1024, cull_chunks=C)

            @jax.jit
            def probe(c2w):
                cov = jgau.build_cov3d_packed(pool.params["scale_raw"],
                                              pool.params["q_raw"])
                proj = jproj.project_gaussians(
                    pool.params["pos"], cov, pool.params["opacity_raw"],
                    c2w, fx, fx, W / 2.0, H / 2.0, cfg,
                    extra_valid=pool.alive)
                b = jbin.bin_gaussians(proj, cfg)
                return b.num_pairs, b.num_pairs_kept

            demand, kept = probe(jnp.asarray(c2w))
            assert out[name]["chunks"][C]["demand"] == int(demand), (name, C)
            assert out[name]["kept"] == int(kept), name
        assert out[name]["pre"] > out[name]["chunks"][64]["demand"]


def test_trunc_error_ladder_cli_on_cpu(capsys):
    H, W = 32, 48
    r = trunc_error_ladder.main(["--device", "cpu", "--checkpoint", CKPT,
                                 "--height", str(H), "--width", str(W),
                                 "--caps", "128", "256", "--poses", "2"])
    assert len(r["rows"]) == 4 and len(r["summary"]) == 2
    assert set(r["rows"][0]) == {"pose", "K", "max_abs_err",
                                 "psnr_vs_exact", "demand_culled", "kept",
                                 "exact_demand"}
    assert r["bands"] == 2 and r["exact"][0].shape == (H, W, 3)
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1])["K"] == 256
    pool, center, radius = _jax_pool()
    traj = jviewer.create_orbit_trajectory(center, radius, num_frames=2)
    fx = 0.85 * W
    def demand(c2w, **kw):
        cfg = gj.RenderConfig(height=H, width=W, **kw)
        return jax.jit(lambda c: gj.pair_demand(
            pool.params, c, fx, fx, W / 2.0, H / 2.0, cfg,
            alive=pool.alive))(c2w)

    for row in r["rows"]:
        c2w = jnp.asarray(traj[row["pose"]])
        exact = demand(c2w)
        trunc = demand(c2w, tile_rank_cap=row["K"])
        assert row["exact_demand"] == int(exact[0])
        assert row["demand_culled"] == int(trunc[0])
        assert row["kept"] == int(trunc[2])


def test_render_trained_writes_video_and_depth(tmp_path):
    out = tmp_path / "out"
    stats = render_trained.main([
        "--checkpoint", CKPT, "--num_frames", "2", "--height", "36",
        "--width", "64", "--max_pairs", "262144", "--orbit_scale", "4.4",
        "--device", "cpu", "--backend", "xla", "--save_depth",
        "--output_dir", str(out), "--fps", "12"])
    assert stats["frames"] == 2 and stats["pair_overflow_frames"] == 0
    frames = _pngs(out / "orbit_frames")
    assert len(frames) == 2 and frames[0].shape == (36, 64, 3)
    assert frames[0].max() > 0
    assert stats["video"] in (str(out / "orbit.mp4"),
                              str(out / "orbit_frames"))
    depths = _pngs(out / "depth")
    assert len(depths) == 2 and stats["depth_dir"] == str(out / "depth")
    # The first depth map is colorize_depth of the pose's depth planes.
    pool = gt.restore_pool(CKPT, device="cpu")
    center, radius = tviewer.estimate_scene_center_radius(
        positions=pool.pos.detach().numpy()[pool.alive.numpy()])
    c2w = tviewer.create_orbit_trajectory(center, 4.4 * radius,
                                          num_frames=2)[0]
    cfg = gt.RenderConfig(height=36, width=64, max_pairs=262144,
                          backend="xla")
    _, d, a = tviewer.make_render_fn(pool.params, cfg, 0.85 * 64, 0.85 * 64,
                                     32.0, 18.0, alive=pool.alive,
                                     with_depth=True)(c2w)
    want = (np.clip(tviewer.colorize_depth(d.numpy(), a.numpy()), 0, 1)
            * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(depths[0], want)


# --- camera and covariance helpers ---------------------------------------------

def test_camera_helpers_match_jax():
    rng = np.random.default_rng(7)
    pc = np.stack([rng.uniform(-3, 3, 200), rng.uniform(-3, 3, 200),
                   rng.uniform(-1, 9, 200)], -1).astype(np.float32)
    th = 0.1
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]], np.float32)
    c2w[:3, 3] = [0.2, -0.1, 0.3]
    intr = tcam.Intrinsics(fx=50.0, fy=48.0, cx=32.0, cy=24.0)
    assert intr._fields == jcam.Intrinsics._fields
    uv_t, *xyz_t = tcam.project_points(torch.from_numpy(pc),
                                       torch.from_numpy(c2w), *intr)
    uv_j, *xyz_j = jcam.project_points(jnp.asarray(pc), jnp.asarray(c2w),
                                       *intr)
    ok = np.abs(np.asarray(xyz_j[2])) > 0.1  # away from the z = 0 pole
    np.testing.assert_allclose(uv_t.numpy()[ok], np.asarray(uv_j)[ok],
                               rtol=1e-6, atol=1e-6 * float(
                                   np.abs(np.asarray(uv_j)[ok]).max()))
    for a, b in zip(xyz_t, xyz_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    args = (50.0, 48.0, 32.0, 24.0, 48, 64, 0.01, 100.0, 32.0)
    m_t = tcam.check_frustum_camera_space(*[torch.from_numpy(np.array(b))
                                            for b in xyz_j], *args)
    m_j = jcam.check_frustum_camera_space(*xyz_j, *args)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert 0 < int(m_t.sum()) < 200
    M = rng.normal(0, 1, (50, 2, 2)).astype(np.float32)
    M[:5] = [[1.0, 2.0], [2.0, 4.0]]  # singular: the det clamp
    inv_t = tcam.inv2x2(torch.from_numpy(M)).numpy()
    inv_j = np.asarray(jcam.inv2x2(jnp.asarray(M)))
    np.testing.assert_array_equal(np.isfinite(inv_t), np.isfinite(inv_j))
    fin = np.isfinite(inv_j).all(axis=(1, 2)) & (np.abs(inv_j).max(
        axis=(1, 2)) < 1e6)
    np.testing.assert_allclose(inv_t[fin], inv_j[fin], rtol=1e-6,
                               atol=1e-6)


def test_build_sigma_from_params_matches_jax():
    rng = np.random.default_rng(9)
    scale_raw = (rng.normal(0, 0.5, (64, 3)) - 2.0).astype(np.float32)
    q_raw = rng.normal(0, 1, (64, 4)).astype(np.float32)
    got = tgau.build_sigma_from_params(torch.from_numpy(scale_raw),
                                       torch.from_numpy(q_raw)).numpy()
    want = np.asarray(jgau.build_sigma_from_params(jnp.asarray(scale_raw),
                                                   jnp.asarray(q_raw)))
    assert got.shape == (64, 3, 3)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # The packed form is the same matrix's upper triangle.
    packed = tgau.build_cov3d_packed(torch.from_numpy(scale_raw),
                                     torch.from_numpy(q_raw)).numpy()
    iu = ([0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2])
    assert np.abs(got[:, iu[0], iu[1]] - packed).max() \
        <= 1e-6 * np.abs(packed).max()
