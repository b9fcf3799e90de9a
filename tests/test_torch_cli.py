"""Port parity: the dataset entry points (``python -m gsplat_tpu_torch.<name>``).

``prepare_dataset`` (``mipnerf``, ``colmap``), ``train``, ``evaluate``,
``eval_checkpoint``, ``inference``, ``train_photo``, ``train_synthetic``
and ``render_trained``'s dataset flags (``--data_dir``,
``--render_training_views``, ``--export_ply``, ``--export_splat``), each
on the CPU (``--device cpu``) at 64x48 or smaller, against the JAX
package's functions and scripts on the same seeded files:

* ``prepare_dataset`` writes the files the JAX package's preparation
  writes, byte for byte;
* ``python -m gsplat_tpu_torch.train --device cpu`` trains from the
  prepared point cloud with the device image cache and writes a
  checkpoint that the JAX package's ``restore_pool`` reads, equal to the
  port's; its parser has every flag of ``scripts/train.py``; over a grid
  of gloo ranks it refuses NCCL for CPU ranks and trains, replicated or
  gaussian-sharded (``--gauss_sharded``, ``--ring``);
* ``eval_checkpoint``'s PSNR equals JAX's ``evaluate_views`` on the same
  checkpoint within 1e-3 dB (the JAX gate between batched and per-view
  evaluation), ``evaluate``'s equals the port's ``evaluate_views``;
* ``inference`` reads a trajectory as ``scripts/inference.py`` does (.npy,
  .npz, .pt) and writes its frames per pose, batched and bucketed alike
  (within one 8-bit step);
* the exported PLY and ``.splat`` files equal the JAX package's exports
  of the same pool, byte for byte;
* ``train_synthetic``'s scene equals the JAX script's, and both training
  CLIs run and report finite scores (``train_photo`` its NaN-guard skips).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu.data.colmap as jcol
import gsplat_tpu.data.gsply as jply
import gsplat_tpu.data.mipnerf as jmip
import gsplat_tpu.train.trainer as jtrainer
import gsplat_tpu_torch as gt
from gsplat_tpu_torch import (eval_checkpoint, evaluate, inference,
                              prepare_dataset, render_trained, train_photo,
                              train_synthetic)
from gsplat_tpu_torch.data.images import save_image
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
from gsplat_tpu_torch.parallel import launch
from gsplat_tpu_torch.train import __main__ as train_cli
from test_data_layer import _write_colmap_model
from test_torch_data import _same_tree
from torch_sharding_ranks import run_cli_grid

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, FOCAL = 48, 64, 55.0


def _script(name):
    """A JAX script of scripts/ as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script_flags(name):
    """The --flags a JAX script's parser adds (read from its source)."""
    import re

    with open(os.path.join(ROOT, "scripts", f"{name}.py")) as f:
        return set(re.findall(r'add_argument\(\s*"(--[a-z0-9_]+)"', f.read()))


def _raw_scene(d, n_views=8, seed=0):
    """A Mip-NeRF-360-layout raw scene: views of a coloured cloud in front
    of cameras on a short arc (LLFF poses_bounds), and its points3D.bin."""
    import struct

    r = np.random.default_rng(seed)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "sparse", "0"))
    rows = []
    for i in range(n_views):
        save_image(os.path.join(d, "images", f"{i:03d}.png"),
                   r.uniform(0.2, 0.8, (H, W, 3)))
        m = np.zeros((3, 5))
        m[:, 0] = [0, 1, 0]  # LLFF columns: down, right, back
        m[:, 1] = [1, 0, 0]
        m[:, 2] = [0, 0, -1]
        m[:, 3] = [0.05 * i, 0.0, -0.5]
        m[:, 4] = [H, W, FOCAL]
        rows.append(np.concatenate([m.ravel(), [0.1, 10.0]]))
    np.save(os.path.join(d, "poses_bounds.npy"), np.asarray(rows))
    pts = np.concatenate([r.uniform(-1, 1, (300, 2)),
                          r.uniform(3, 5, (300, 1))], 1)
    with open(os.path.join(d, "sparse", "0", "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for i, p in enumerate(pts):
            f.write(struct.pack("<Q", i) + struct.pack("<3d", *p))
            f.write(struct.pack("<3B", *r.integers(0, 256, 3)))
            f.write(struct.pack("<d", 0.5) + struct.pack("<Q", 1))
            f.write(struct.pack("<ii", 0, 0))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A raw scene, prepared by ``prepare_dataset mipnerf``, then trained by
    ``python -m gsplat_tpu_torch.train --device cpu`` in a subprocess:
    (prepared dir, output dir, the train CLI's stdout)."""
    base = tmp_path_factory.mktemp("cli")
    raw, prep, out = (str(base / n) for n in ("raw", "prep", "out"))
    _raw_scene(raw)
    prepare_dataset.main(["mipnerf", "--input_dir", raw, "--output_dir",
                          prep, "--downsample", "1"])
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run(
        [sys.executable, "-m", "gsplat_tpu_torch.train", "--data_dir", prep,
         "--output_dir", out, "--scale_factor", "1.0", "--batch_size", "2",
         "--iterations", "4", "--capacity", "1024", "--max_pairs", "65536",
         "--holdout_every", "4", "--densification_interval", "2",
         "--adc_mode", "paper", "--log_every", "2", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=str(base), timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    return prep, out, run.stdout


def test_train_cli_writes_a_checkpoint_jax_reads(trained):
    prep, out, stdout = trained
    assert "init from " in stdout and "device-caching 6 views" in stdout
    assert "done: 4 iters" in stdout
    ckpt = os.path.join(out, "checkpoint_final.npz")
    jpool = jtrainer.restore_pool(ckpt)
    tpool = gt.restore_pool(ckpt, device="cpu")
    assert int(jpool.num_alive()) == int(tpool.num_alive()) > 200
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(np.asarray(jpool.params[k]),
                                      getattr(tpool, k).detach().numpy())
    with open(os.path.join(out, "train_log.json")) as f:
        log = json.load(f)
    assert log["iterations"] == 4
    assert all(np.isfinite(v) for _, v in log["losses"])


def test_train_cli_has_every_flag_of_the_jax_script():
    ours = {a for act in train_cli.build_parser()._actions
            for a in act.option_strings if a.startswith("--")}
    assert _script_flags("train") <= ours
    assert ours - _script_flags("train") == {"--help", "--device",
                                             "--dist_backend"}


@pytest.fixture(scope="module")
def gauss_trained(trained, tmp_path_factory):
    """``train --mesh_tile 2 --dist_backend gloo --gauss_sharded``, then
    with ``--ring``, in one spawn of two gloo ranks, each run through the
    CLI's rank function as its ``main`` launches it: {flag: (rank 0's
    report, output dir)}."""
    base = tmp_path_factory.mktemp("gauss_cli")
    flags = ("--gauss_sharded", "--ring")
    argss = [train_cli.build_parser().parse_args(
        ["--data_dir", trained[0], "--output_dir", str(base / f[2:]),
         "--scale_factor", "1.0", "--batch_size", "2", "--iterations", "2",
         "--capacity", "1024", "--max_pairs", "65536", "--log_every", "1",
         "--device", "cpu", "--mesh_tile", "2", "--dist_backend", "gloo",
         "--gauss_sharded"] + (["--ring"] if f == "--ring" else []))
        for f in flags]
    reports = launch(run_cli_grid, 2, backend="gloo", device="cpu",
                     args=(argss,))
    return {f: (r, base / f[2:]) for f, r in zip(flags, reports)}


@pytest.mark.parametrize("flags", [["--mesh_data", "2"], ["--mesh_tile", "2"],
                                   ["--gauss_sharded"], ["--ring"],
                                   ["--cull_mode", "ellipse"]])
def test_train_cli_refuses_unported_flags(flags, request, tmp_path):
    """Every flag is ported. A grid refuses NCCL for CPU ranks, naming
    gloo (no silent switch), and trains over two gloo ranks (one band
    each; the data axis is held in test_torch_sharding.py), replicated or
    with the pool sharded over them (``--gauss_sharded``, and with
    ``--ring`` its ring exchange: both in the one spawn of
    ``gauss_trained``); the ellipse cull trains."""
    if flags[0] in ("--gauss_sharded", "--ring"):
        report, out = request.getfixturevalue("gauss_trained")[flags[0]]
        assert report.iterations == 2 and np.isfinite(report.final_loss)
        # rank 0 wrote the gathered pool
        pool = gt.restore_pool(out / "checkpoint_final.npz", device="cpu")
        assert pool.capacity == 1024 and int(pool.num_alive()) > 0
        return
    if flags[0].startswith("--mesh"):
        with pytest.raises(ValueError, match="gloo"):
            train_cli.main(["--data_dir", str(tmp_path), "--device", "cpu"]
                           + flags)
        if flags[0] == "--mesh_data":
            return
        flags = flags + ["--dist_backend", "gloo"]  # two bands, two ranks
    prep, _, _ = request.getfixturevalue("trained")
    state, report = train_cli.main(
        ["--data_dir", prep, "--output_dir", str(tmp_path / "out"),
         "--scale_factor", "1.0", "--batch_size", "2", "--iterations", "2",
         "--capacity", "1024", "--max_pairs", "65536", "--log_every", "1",
         "--device", "cpu"] + flags)
    assert report.iterations == 2 and np.isfinite(report.final_loss)
    assert (state is None) == flags[0].startswith("--mesh")
    assert os.path.exists(tmp_path / "out" / "checkpoint_final.npz")


@pytest.mark.parametrize("cmd", ["mipnerf", "colmap"])
def test_prepare_dataset_cli_matches_jax(tmp_path, cmd):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    if cmd == "mipnerf":
        raw = str(tmp_path / "raw")
        _raw_scene(raw, n_views=3)
        info = prepare_dataset.main(["mipnerf", "--input_dir", raw,
                                     "--output_dir", a, "--downsample", "2",
                                     "--max_images", "2"])
        want = jmip.prepare_mipnerf360_dataset(raw, b, scene_name="scene",
                                               image_downsample=2,
                                               max_images=2)
        assert info["num_images"] == want["num_images"] == 2
    else:
        sparse = str(tmp_path / "sparse0")
        _write_colmap_model(sparse)
        photos = str(tmp_path / "photos")
        os.makedirs(photos)
        r = np.random.default_rng(2)
        for name in ("a.png", "b.png"):
            save_image(os.path.join(photos, name), r.uniform(0, 1, (48, 64, 3)))
        info = prepare_dataset.main(["colmap", "--image_dir", photos,
                                     "--output_dir", a, "--sparse_dir",
                                     sparse, "--downscale", "0.5"])
        want = jcol.convert_colmap_to_training_format(sparse, photos, b,
                                                      downscale=0.5)
        assert info == want
    _same_tree(a, b)


def test_eval_cli_match_evaluate_views(trained):
    """eval_checkpoint over the held-out views against JAX's evaluate_views
    on the same checkpoint; evaluate against the port's evaluate_views."""
    from gsplat_tpu.data import GaussianDataset as JDataset
    from gsplat_tpu.evaluation import evaluate_views as jevaluate

    from gsplat_tpu_torch.data import GaussianDataset
    from gsplat_tpu_torch.evaluation import evaluate_views

    prep, out, _ = trained
    ckpt = os.path.join(out, "checkpoint_final.npz")
    res = eval_checkpoint.main(["--checkpoint", ckpt, "--scene_dir", prep,
                                "--holdout_every", "4", "--max_pairs",
                                "65536", "--device", "cpu"])
    jpool = jtrainer.restore_pool(ckpt)
    jds = JDataset(prep, scale_factor=1.0, holdout_every=4, split="test")
    want = jevaluate(jpool.params, [jds[i] for i in range(len(jds))],
                     gj.RenderConfig(height=H, width=W, max_pairs=65536),
                     alive=jpool.alive)
    assert res["num_views"] == want["num_views"] == 2
    assert res["psnr"] == pytest.approx(want["psnr"], abs=1e-3)
    assert res["gaussians"] == int(jpool.num_alive())
    ev = evaluate.main(["--checkpoint", out, "--data_dir", prep,
                        "--scale_factor", "1.0", "--holdout_every", "4",
                        "--max_pairs", "65536", "--render_batch", "2",
                        "--json", "--device", "cpu"])
    pool = gt.restore_pool(ckpt, device="cpu")
    ds = GaussianDataset(prep, scale_factor=1.0, holdout_every=4,
                         split="test")
    direct = evaluate_views(pool.params, [ds[i] for i in range(len(ds))],
                            gt.RenderConfig(height=H, width=W,
                                            max_pairs=65536),
                            alive=pool.alive)
    assert ev["psnr"] == pytest.approx(direct["psnr"], abs=1e-3)
    # --spmd is ported: a band grid of two gloo ranks gives the same score.
    sp = evaluate.main(["--checkpoint", out, "--data_dir", prep,
                        "--scale_factor", "1.0", "--holdout_every", "4",
                        "--max_pairs", "65536", "--render_batch", "2",
                        "--json", "--spmd", "--spmd_ranks", "2",
                        "--spmd_bands", "2", "--dist_backend", "gloo",
                        "--device", "cpu"])
    assert sp["psnr"] == pytest.approx(ev["psnr"], abs=1e-3)


def test_inference_cli_trajectories_and_modes(trained, tmp_path):
    prep, out, _ = trained
    poses = np.load(os.path.join(prep, "poses.npy"))[:3]
    jload = _script("inference").load_trajectory
    paths = {".npy": str(tmp_path / "t.npy"), ".npz": str(tmp_path / "t.npz"),
             ".pt": str(tmp_path / "t.pt")}
    np.save(paths[".npy"], poses)
    np.savez(paths[".npz"], poses=poses)
    torch.save(torch.from_numpy(poses), paths[".pt"])
    for p in paths.values():
        np.testing.assert_array_equal(inference.load_trajectory(p), jload(p))
    frames = {}
    for mode, extra in (("per_pose", []), ("batch", ["--render_batch", "2"]),
                        ("bucket", ["--bucket_pairs", "2"])):
        d = str(tmp_path / mode)
        written = inference.main(
            ["--checkpoint", out, "--trajectory", paths[".npz"],
             "--data_dir", prep, "--scale_factor", "1.0", "--output_dir", d,
             "--max_pairs", "65536", "--device", "cpu"] + extra)
        assert len(written) == 3
        from PIL import Image

        frames[mode] = np.stack([np.asarray(Image.open(p)) for p in written])
    assert frames["per_pose"].shape == (3, H, W, 3)
    assert frames["per_pose"].max() > 0
    for mode in ("batch", "bucket"):
        diff = np.abs(frames[mode].astype(int) - frames["per_pose"])
        assert diff.max() <= 1, mode
    # --spmd is ported: poses over two gloo ranks' data axis.
    d = str(tmp_path / "spmd")
    written = inference.main(
        ["--checkpoint", out, "--trajectory", paths[".npy"], "--data_dir",
         prep, "--scale_factor", "1.0", "--output_dir", d, "--max_pairs",
         "65536", "--render_batch", "2", "--spmd", "--spmd_ranks", "2",
         "--dist_backend", "gloo", "--device", "cpu"])
    from PIL import Image

    got = np.stack([np.asarray(Image.open(p)) for p in written])
    assert np.abs(got.astype(int) - frames["per_pose"]).max() <= 1


def test_render_trained_dataset_flags_and_exports(trained, tmp_path):
    prep, out, _ = trained
    ply, splat = str(tmp_path / "s.ply"), str(tmp_path / "s.splat")
    d = str(tmp_path / "renders")
    stats = render_trained.main([
        "--checkpoint", out, "--data_dir", prep, "--output_dir", d,
        "--num_frames", "1", "--benchmark_only", "--render_training_views",
        "--export_ply", ply, "--export_splat", splat, "--max_pairs", "65536",
        "--device", "cpu"])
    assert stats["frames"] == 1
    assert sorted(os.listdir(d)) == [f"train_view_{i:03d}.png"
                                     for i in range(8)]
    jpool = jtrainer.restore_pool(os.path.join(out, "checkpoint_final.npz"))
    host = {k: np.asarray(v) for k, v in jpool.params.items()}
    alive = np.asarray(jpool.alive)
    for path, export in ((ply, jply.export_gaussians_ply),
                         (splat, jply.export_gaussians_splat)):
        want = str(tmp_path / ("j" + os.path.basename(path)))
        export(want, host, alive=alive)
        with open(path, "rb") as x, open(want, "rb") as y:
            assert x.read() == y.read(), path
    # A 3DGS PLY is a checkpoint too: every gaussian alive.
    params, alive_t = render_trained.load_params(ply, device="cpu")
    assert bool(alive_t.all()) and alive_t.shape[0] == int(alive.sum())
    np.testing.assert_array_equal(params["pos"].numpy(), host["pos"][alive])
    # And so is a directory of six .pt tensors.
    names = {"pos": "positions.pt", "scale_raw": "scales.pt",
             "q_raw": "rotations.pt", "opacity_raw": "opacities.pt",
             "f_dc": "features_dc.pt", "f_rest": "features_rest.pt"}
    for k, fn in names.items():
        torch.save(torch.from_numpy(host[k][:5].copy()), str(tmp_path / fn))
    params, alive_t = render_trained.load_params(
        str(tmp_path / "positions.pt"), device="cpu")
    assert alive_t.shape == (5,)
    np.testing.assert_array_equal(params["q_raw"].numpy(), host["q_raw"][:5])


def test_train_synthetic_cli_matches_jax_scene(monkeypatch):
    jparams, jcloud = _script("train_synthetic").make_gt_scene(300, seed=4)
    tparams, tcloud = train_synthetic.make_gt_scene(300, seed=4)
    np.testing.assert_array_equal(tcloud, jcloud)
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(tparams[k].numpy(),
                                      np.asarray(jparams[k]))
    # main renders its ground truth through gt_views and trains on it.
    seen = {}
    real_views, real_data = train_synthetic.gt_views, train_synthetic._Views

    def views(gt_params, n, cfg):
        seen["views"] = real_views(gt_params, n, cfg)
        seen["args"] = (len(gt_params["pos"]), n, cfg.height, cfg.width,
                        cfg.max_pairs)
        return seen["views"]

    def data(v):
        seen["trained_on"] = v
        return real_data(v)

    monkeypatch.setattr(train_synthetic, "gt_views", views)
    monkeypatch.setattr(train_synthetic, "_Views", data)
    res = train_synthetic.main(["--height", "32", "--width", "48",
                                "--gt_gaussians", "200", "--views", "2",
                                "--iterations", "2", "--max_pairs", "16384",
                                "--capacity", "512", "--device", "cpu"])
    assert np.isfinite(res["psnr"]) and res["gaussians"] > 100
    assert seen["args"] == (200, 2, 32, 48, 16384)
    assert seen["trained_on"] is seen["views"] and len(seen["views"]) == 2
    assert seen["views"][0]["image"].shape == (32, 48, 3)
    assert seen["views"][0]["fx"] == 0.9 * 48


@pytest.mark.parametrize("planes", [1, 2])
def test_train_photo_cli_runs(tmp_path, planes):
    photo = str(tmp_path / "photo.png")
    save_image(photo, np.random.default_rng(0).uniform(0, 1, (40, 56, 3)))
    res = train_photo.main([
        "--image", photo, "--output_dir", str(tmp_path / "o"), "--planes",
        str(planes), "--n_views", "4", "--height", "32", "--width", "48",
        "--iterations", "2", "--capacity", "8192", "--max_pairs", "16384",
        "--holdout_every", "4", "--json", "--device", "cpu"])
    assert res["holdout_views"] == 1 and res["train_views"] == 3
    assert np.isfinite(res["psnr"]) and res["nonfinite_steps"] == 0


def test_entry_points_need_a_card_by_default(trained, monkeypatch, tmp_path):
    """Without --device the CLIs ask for the card, and raise without one
    (no fallback to the CPU)."""
    prep, out, _ = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    traj = str(tmp_path / "t.npy")
    np.save(traj, np.load(os.path.join(prep, "poses.npy"))[:1])
    for main, argv in (
            (train_cli.main, ["--data_dir", prep, "--output_dir",
                              str(tmp_path / "o"), "--iterations", "1"]),
            (evaluate.main, ["--checkpoint", out, "--data_dir", prep]),
            (eval_checkpoint.main, ["--checkpoint", os.path.join(
                out, "checkpoint_final.npz"), "--scene_dir", prep]),
            (inference.main, ["--checkpoint", out, "--trajectory", traj]),
            (train_synthetic.main, ["--iterations", "1"])):
        with pytest.raises(RuntimeError, match="is_available"):
            main(argv)
