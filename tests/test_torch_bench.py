"""Port parity: the bench (``python -m gsplat_tpu_torch.bench``) against
the JAX package's ``bench.py``, on the CPU.

The port's bench runs once, in process, with ``--device cpu`` at 48x32 on
a 4,096-slot slice of the committed checkpoint, ``--iters 1`` and
``--ellipse-ab``; its capacities and the train bench's sizes are shrunk
through the module's constants (``SHRUNK``) so that the plain compositor
walks short lists. The isolated re-measure's child command is run in this
process too (``subprocess.run`` is replaced for it), on the same
constants. The JAX side is computed by JAX's ``render_from_params`` and
``pair_demand`` (jitted, its Pallas kernels in interpret mode, as the JAX
tests run them) under ``bench.py``'s configurations with the same
capacities, on the same checkpoint slice, pose and scene.

What is held, and how closely:

* ``roofline_forward``'s bytes equal ``bench.roofline_forward``'s for the
  same configuration, its speed-of-light time over the H100's 3.35e12 B/s;
* the checkpoint's integer keys (gaussians, pair demand and capacity, the
  backward demand, the culled demand, the kept pairs, the truncated and
  sized capacities, the ellipse demand) equal JAX's, and its two image
  errors within 2e-5 of JAX's;
* ``pairs`` and ``max_tile_count`` of the synthetic scene and
  ``train_bwd_demand`` of the shrunk train bench equal JAX's;
* the line's keys are ``BENCH_r05.json``'s less the reference's three
  ``pixel_grad_*``, plus the ellipse A/B's three; no ``*_error`` key, no
  NaN; ``--only fwd_bwd_trained`` prints one key;
* without a card the default device raises, in process and as ``python -m
  gsplat_tpu_torch.bench`` (non-zero exit, no line); a part that raises
  makes ``main`` raise and print no line.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu.viewer as jviewer
from gsplat_tpu.train import trainer as jtrainer
from gsplat_tpu_torch import bench as tbench
from test_torch_render import CKPT, ROOT

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

H, W = 32, 48
GAUSSIANS = 1000
SHRUNK = dict(SYNTH_PAIRS=2**14, CKPT_PAIRS=2**14, ELLIPSE_PAIRS=2**14,
              ELLIPSE_ROWS=2**13, TRAIN_WIDTH=32, TRAIN_HEIGHT=16,
              TRAIN_PAIRS=2**13)
IMG_TOL = 2e-5
CKPT_INT_KEYS = ("gaussians", "pairs", "pair_capacity", "bwd_demand",
                 "demand_culled", "pairs_kept", "trunc_capacity",
                 "sized_capacity", "pairs_ellipse")
ELLIPSE_KEYS = {"fps_trained_ckpt_ellipse", "trained_ckpt_pairs_ellipse",
                "trained_ckpt_ellipse_img_err"}


def _jax_bench():
    sys.path.insert(0, ROOT)
    try:
        import bench
    finally:
        sys.path.remove(ROOT)
    return bench


def _sized(demand, headroom=1.2):
    # bench.py's capacity rule (:317, :379-380, :416, :490).
    return max(4096, -(-int(demand * headroom) // 4096) * 4096)


def expected_keys(ellipse_ab):
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        keys = set(json.load(f)["parsed"])
    keys = {k for k in keys if not k.startswith("pixel_grad_")}
    return keys | ELLIPSE_KEYS if ellipse_ab else keys


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench") / "slice.npz")
    with np.load(CKPT) as d:
        np.savez(path, **{k: d[k][:4096] for k in d.files
                          if k.startswith("param_") or k == "__alive__"})
    return path


@pytest.fixture(scope="module")
def shrunk():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in SHRUNK.items():
            mp.setattr(tbench, k, v)
        yield mp


@pytest.fixture(scope="module")
def run(small_ckpt, shrunk):
    """main() once: its printed last line, bench_checkpoint's arguments and
    result, and the isolated child's command and printed line."""
    rec = {}
    real_run, real_ckpt = subprocess.run, tbench.bench_checkpoint

    def child(cmd, **kw):
        assert cmd[:3] == [sys.executable, "-m", "gsplat_tpu_torch.bench"]
        rec["child_cmd"] = cmd
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tbench.main(cmd[3:])
        rec["child_out"] = buf.getvalue()
        return subprocess.CompletedProcess(cmd, 0, buf.getvalue(), "")

    def ckpt(*a, **kw):
        rec["ckpt_args"] = (a, kw)
        rec["ckpt"] = real_ckpt(*a, **kw)
        return rec["ckpt"]

    shrunk.setattr(tbench.subprocess, "run", child)
    shrunk.setattr(tbench, "bench_checkpoint", ckpt)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rec["ret"] = tbench.main([
                "--device", "cpu", "--height", str(H), "--width", str(W),
                "--gaussians", str(GAUSSIANS), "--iters", "1",
                "--checkpoint", small_ckpt, "--ellipse-ab"])
    finally:
        shrunk.setattr(tbench.subprocess, "run", real_run)
        shrunk.setattr(tbench, "bench_checkpoint", real_ckpt)
    rec["out"] = buf.getvalue()
    return rec


@pytest.fixture(scope="module")
def jax_ckpt(small_ckpt):
    """bench.py's checkpoint configurations through JAX's render_from_params
    and pair_demand at the shrunk capacities."""
    pool = jtrainer.restore_pool(small_ckpt)
    pos = np.asarray(pool.params["pos"])[np.asarray(pool.alive)]
    center, radius = jviewer.estimate_scene_center_radius(positions=pos)
    c2w = jnp.asarray(jviewer.look_at(
        center + np.array([0.0, -0.6 * radius, -4.4 * radius]), center))
    f, cx, cy = jnp.float32(0.85 * W), jnp.float32(W / 2), jnp.float32(H / 2)
    render = jax.jit(gj.render_from_params, static_argnums=(6,))
    demand = jax.jit(gj.pair_demand, static_argnums=(6,))
    cfg = gj.RenderConfig(height=H, width=W, max_pairs=SHRUNK["CKPT_PAIRS"],
                          max_per_tile=4096, backend="pallas")
    args = (pool.params, c2w, f, f, cx, cy)
    img, aux = render(*args, cfg, alive=pool.alive)
    tcfg0 = cfg.with_(tile_rank_cap=1024)
    pd, _, td = (int(x) for x in demand(*args, tcfg0, alive=pool.alive))
    tcfg = tcfg0.with_(max_pairs=_sized(pd), trunc_pairs=_sized(td))
    timg, taux = render(*args, tcfg, alive=pool.alive)
    ecfg = cfg.with_(cull_mode="ellipse", max_pairs=SHRUNK["ELLIPSE_PAIRS"],
                     max_rows=SHRUNK["ELLIPSE_ROWS"])
    eimg, eaux = render(*args, ecfg, alive=pool.alive)
    return {
        "trained_ckpt_gaussians": int(np.asarray(pool.alive).sum()),
        "trained_ckpt_pairs": int(aux.num_pairs),
        "trained_ckpt_pair_capacity": cfg.max_pairs,
        "trained_ckpt_bwd_demand": int(aux.bwd_demand),
        "trained_ckpt_demand_culled": pd,
        "trained_ckpt_pairs_kept": int(taux.num_pairs_kept),
        "trained_ckpt_trunc_capacity": tcfg.trunc_padded_pairs,
        "trained_ckpt_sized_capacity": _sized(int(aux.num_pairs)),
        "trained_ckpt_pairs_ellipse": int(eaux.num_pairs),
        "trained_ckpt_trunc_img_err": float(jnp.abs(timg - img).max()),
        "trained_ckpt_ellipse_img_err": float(jnp.abs(eimg - img).max()),
    }


def test_roofline_matches_bench():
    bench = _jax_bench()
    for h, w, pairs, n in ((1080, 1920, 5 * 2**19, 2**17),
                           (H, W, 2**14, GAUSSIANS)):
        jcfg = gj.RenderConfig(height=h, width=w, max_pairs=pairs,
                               max_per_tile=2048, tile_chunk=32)
        tcfg = tbench.RenderConfig(height=h, width=w, max_pairs=pairs,
                                   max_per_tile=2048, tile_chunk=32)
        want = bench.roofline_forward(jcfg, n, 1.0)
        got = tbench.roofline_forward(tcfg, n, 1e-3)
        assert got["roofline_fwd_gbytes"] == want["roofline_fwd_gbytes"]
        nbytes = (4 * 2 * 2 * 4 + 26 * 4) * tcfg.padded_pairs + 2 * 4 * (
            tcfg.num_tiles * 8 * 256) + 80 * 4 * n
        assert got["roofline_fwd_sol_ms"] == round(nbytes / 3.35e12 * 1e3, 3)
        assert got["roofline_fwd_fraction"] == round(nbytes / 3.35e12 / 1e-3,
                                                     3)


@pytest.mark.parametrize("key", CKPT_INT_KEYS)
def test_checkpoint_counts_match_jax(run, jax_ckpt, key):
    (path, h, w, iters), kw = run["ckpt_args"]
    assert (h, w, iters) == (H, W, 1) and kw["ellipse_ab"]
    assert run["ckpt"][f"trained_ckpt_{key}"] == jax_ckpt[
        f"trained_ckpt_{key}"]


@pytest.mark.parametrize("which", ["trunc", "ellipse"])
def test_checkpoint_image_errors_match_jax(run, jax_ckpt, which):
    key = f"trained_ckpt_{which}_img_err"
    assert abs(run["ckpt"][key] - jax_ckpt[key]) <= IMG_TOL


def test_synthetic_and_train_counts_match_jax(run, shrunk):
    bench = _jax_bench()
    line = run["ret"]
    cfg = gj.RenderConfig(height=H, width=W, max_pairs=SHRUNK["SYNTH_PAIRS"],
                          max_per_tile=2048, tile_chunk=32)
    f = jnp.float32(0.85 * W)
    _, aux = jax.jit(gj.render_from_params, static_argnums=(6,))(
        bench.make_scene(GAUSSIANS), jnp.eye(4), f, f, jnp.float32(W / 2),
        jnp.float32(H / 2), cfg)
    assert line["pairs"] == int(aux.num_pairs) > 0
    assert line["max_tile_count"] == int(aux.max_tile_count)
    # The train bench's cameras (bench.py:459-467) and its demand probe.
    tw, th = SHRUNK["TRAIN_WIDTH"], SHRUNK["TRAIN_HEIGHT"]
    c2ws = tbench.train_cameras(4)
    for i in range(4):
        c = np.eye(4, dtype=np.float32)
        c[:3, 3] = [0.1 * i, 0.0, -0.05 * i]
        c[0, 0] = c[2, 2] = np.cos(0.05 * i)
        c[0, 2], c[2, 0] = np.sin(0.05 * i), -np.sin(0.05 * i)
        np.testing.assert_array_equal(c2ws[i], c)
    tcfg = gj.RenderConfig(height=th, width=tw,
                           max_pairs=SHRUNK["TRAIN_PAIRS"], max_per_tile=2048,
                           backend="pallas")
    ft = jnp.float32(0.85 * tw)
    probe = jax.jit(lambda p, c: gj.render_from_params(
        p, c, ft, ft, jnp.float32(tw / 2), jnp.float32(th / 2),
        tcfg)[1].bwd_demand)
    params = bench.make_scene(GAUSSIANS)
    want = max(int(probe(params, jnp.asarray(c))) for c in c2ws)
    assert line["train_bwd_demand"] == want > 0


def test_line_keys_as_chip_smoke_gates_them(run):
    lines = [s for s in run["out"].splitlines() if s.strip()]
    assert len(lines) == 1
    line = json.loads(lines[-1])
    assert line == json.loads(json.dumps(run["ret"]))
    assert line["metric"] == "render_fps_1080p_trained"
    assert line["value"] == line["fps_trained_ckpt"] > 0
    assert set(line) == expected_keys(ellipse_ab=True)
    assert not [k for k in line if k.endswith("_error")]
    assert not [k for k, v in line.items()
                if isinstance(v, float) and math.isnan(v)]
    assert line["device"] == "cpu" and line["resolution"] == f"{W}x{H}"
    assert line["fwd_bwd_fps_trained_ckpt"] == max(
        line["fwd_bwd_fps_trained_ckpt_inbench"],
        line["fwd_bwd_fps_trained_ckpt_isolated"])
    assert 0 < line["fwd_bwd_inbench_vs_isolated_agreement"] <= 1


def test_only_fwd_bwd_trained_prints_one_key(run, small_ckpt):
    cmd = run["child_cmd"]
    assert cmd[3:5] == ["--only", "fwd_bwd_trained"]
    assert cmd[cmd.index("--checkpoint") + 1] == small_ckpt
    assert cmd[cmd.index("--device") + 1] == "cpu"
    out = json.loads(run["child_out"].strip().splitlines()[-1])
    assert list(out) == ["fwd_bwd_fps_trained_ckpt"]
    assert out["fwd_bwd_fps_trained_ckpt"] == run["ret"][
        "fwd_bwd_fps_trained_ckpt_isolated"] > 0


def test_main_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        tbench.main([])
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "gsplat_tpu_torch.bench"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "RuntimeError" in r.stderr


def test_a_failing_part_raises_and_prints_no_line(small_ckpt, shrunk,
                                                  monkeypatch, capsys):
    def fail(*a, **kw):
        raise ValueError("part failed")

    monkeypatch.setattr(tbench, "bench_checkpoint", fail)
    with pytest.raises(ValueError, match="part failed"):
        tbench.main(["--device", "cpu", "--height", str(H), "--width",
                     str(W), "--gaussians", "200", "--iters", "1",
                     "--no-backward", "--checkpoint", small_ckpt])
    assert capsys.readouterr().out.strip() == ""
