"""Port parity: the data layer (``gsplat_tpu_torch/data``).

The same files, written from seeded numpy data into ``tmp_path``, go
through the JAX package's ``gsplat_tpu.data`` and the port's copy:
PLY read and write (binary and ASCII), the outlier filter and point-cloud
loading, the COLMAP parsers and pose helpers, ``poses_bounds.npy`` and
``transforms_train.json`` parsing, the Mip-NeRF 360 and COLMAP
preparation, the dataset (its ``scale_factor``, a view of another size,
the holdout split, ``batches``, ``device_batches`` on the CPU in f32 and
uint8, ``prefetch``), the gaussian PLY and ``.splat`` export, and the
photo-plane warps. Then ``fit()`` started from a dataset's point cloud in
both packages (the twin of ``test_torch_fit.py::test_fit_matches_jax``).

Tolerances: arrays, files and view orders equal; images within 1e-6
(both decode the same 8-bit files; the uint8 device cache dequantizes by a
product where the host path divides); ``fit()``'s densification counts
exact and logged losses within 1 % of JAX's, as the fit twin holds them.
"""

import importlib
import json
import os
import struct

import numpy as np
import pytest
import torch

import gsplat_tpu as gj
import gsplat_tpu.data.colmap as jcol
import gsplat_tpu.data.dataset as jds
import gsplat_tpu.data.gsply as jply
import gsplat_tpu.data.images as jimg
import gsplat_tpu.data.mipnerf as jmip
import gsplat_tpu.data.photo_plane as jpp
import gsplat_tpu.data.pointcloud as jpc
import gsplat_tpu_torch as gt
import gsplat_tpu_torch.data.colmap as tcol
import gsplat_tpu_torch.data.dataset as tds
import gsplat_tpu_torch.data.gsply as tply
import gsplat_tpu_torch.data.images as timg
import gsplat_tpu_torch.data.mipnerf as tmip
import gsplat_tpu_torch.data.photo_plane as tpp
import gsplat_tpu_torch.data.pointcloud as tpc
from test_data_layer import _make_dataset_dir, _write_colmap_model
from test_prep_pipeline import _make_mipnerf_scene

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)


def _cloud(n=200, seed=0, rgb=True):
    r = np.random.default_rng(seed)
    pts = r.normal(0, 1.5, (n, 3))
    if rgb:
        pts = np.concatenate([pts, r.uniform(0, 1, (n, 3))], -1)
    return pts.astype(np.float32)


def _same_tree(a, b):
    """Every file under the two directories equal (names and contents)."""
    fa = sorted(os.path.relpath(os.path.join(d, f), a)
                for d, _, fs in os.walk(a) for f in fs)
    fb = sorted(os.path.relpath(os.path.join(d, f), b)
                for d, _, fs in os.walk(b) for f in fs)
    assert fa == fb
    for f in fa:
        if f.endswith("cam_meta.npy"):
            ma = np.load(os.path.join(a, f), allow_pickle=True).item()
            mb = np.load(os.path.join(b, f), allow_pickle=True).item()
            assert ma == mb, f
            continue
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


# --- images and point clouds --------------------------------------------------

@pytest.mark.parametrize("ext,scale", [(".png", 1.0), (".png", 0.5),
                                       (".npy", 1.0), (".npy", 0.6)])
def test_image_load_and_resize_match_jax(tmp_path, ext, scale):
    r = np.random.default_rng(1)
    img = r.uniform(0, 1, (21, 30, 3)).astype(np.float32)
    path = str(tmp_path / f"img{ext}")
    timg.save_image(path, img)
    with open(path, "rb") as f:
        ours = f.read()
    jimg.save_image(str(tmp_path / f"j{ext}"), img)
    with open(str(tmp_path / f"j{ext}"), "rb") as f:
        assert f.read() == ours
    got, want = timg.load_image(path, scale), jimg.load_image(path, scale)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(timg.resize_image(img, 13, 17),
                                  jimg.resize_image(img, 13, 17))
    np.testing.assert_array_equal(timg._resize_bilinear_to(img, 40, 9),
                                  jimg._resize_bilinear_to(img, 40, 9))
    np.testing.assert_array_equal(timg._to_rgb(img[..., 0]),
                                  jimg._to_rgb(img[..., 0]))
    assert timg.list_images(str(tmp_path)) == jimg.list_images(str(tmp_path))


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("rgb", [True, False])
def test_ply_roundtrip_matches_jax(tmp_path, binary, rgb):
    pts = _cloud(rgb=rgb)
    a, b = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    tpc.write_ply(a, pts, binary=binary)
    jpc.write_ply(b, pts, binary=binary)
    with open(a, "rb") as x, open(b, "rb") as y:
        assert x.read() == y.read()
    np.testing.assert_array_equal(tpc.read_ply(a), jpc.read_ply(a))
    back = tpc.read_ply(a)
    np.testing.assert_allclose(back[:, :3], pts[:, :3], rtol=1e-5, atol=1e-6)
    if rgb:
        np.testing.assert_allclose(back[:, 3:], pts[:, 3:], atol=1 / 255.0)


@pytest.mark.parametrize("fmt", [".ply", ".npy", ".npz", ".pt"])
def test_load_point_cloud_matches_jax(tmp_path, fmt):
    pts = _cloud(400, seed=2)
    pts[3] = np.nan
    pts[7, 0] = 5000.0
    pts[11, :3] = 40.0  # beyond the 99.5th radial percentile
    path = str(tmp_path / f"pc{fmt}")
    if fmt == ".ply":
        tpc.write_ply(path, pts[np.isfinite(pts).all(1)])
    elif fmt == ".npy":
        np.save(path, pts)
    elif fmt == ".npz":
        np.savez(path, points=pts)
    else:
        torch.save(torch.from_numpy(pts), path)
    for max_points in (None, 100):
        got = tpc.load_point_cloud(path, max_points=max_points)
        want = jpc.load_point_cloud(path, max_points=max_points)
        np.testing.assert_array_equal(got, want)
    assert not (got[:, :3] == 40.0).all(1).any()
    np.testing.assert_array_equal(tpc.filter_outliers(pts),
                                  jpc.filter_outliers(pts))


# --- COLMAP and Mip-NeRF 360 --------------------------------------------------

def test_colmap_parsers_and_pose_helpers_match_jax(tmp_path):
    d = str(tmp_path / "sparse")
    _write_colmap_model(d)
    for fn in ("read_cameras_binary", "read_images_binary"):
        got = getattr(tcol, fn)(os.path.join(d, fn.split("_")[1] + ".bin"))
        want = getattr(jcol, fn)(os.path.join(d, fn.split("_")[1] + ".bin"))
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].keys() == want[k].keys()
            for f in got[k]:
                np.testing.assert_array_equal(got[k][f], want[k][f])
    p3 = os.path.join(d, "points3D.bin")
    np.testing.assert_array_equal(tcol.read_points3d_binary(p3),
                                  jcol.read_points3d_binary(p3))
    r = np.random.default_rng(3)
    for _ in range(5):
        q, t = r.normal(0, 1, 4), r.normal(0, 1, 3)
        np.testing.assert_array_equal(tcol.qvec_wxyz_to_rotmat(q),
                                      jcol.qvec_wxyz_to_rotmat(q))
        np.testing.assert_array_equal(tcol.colmap_pose_to_c2w(q, t),
                                      jcol.colmap_pose_to_c2w(q, t))
    for mid, (name, n) in tcol.CAMERA_MODELS.items():
        cam = {"model": name, "params": np.arange(1.0, n + 1.0)}
        assert tcol.pinhole_intrinsics(cam) == jcol.pinhole_intrinsics(cam)
    assert tcol.CAMERA_MODELS == jcol.CAMERA_MODELS


def test_poses_bounds_and_transforms_json_match_jax(tmp_path):
    raw = _make_mipnerf_scene(tmp_path, n_views=4)
    pb = os.path.join(raw, "poses_bounds.npy")
    got, want = tmip.load_poses_bounds(pb), jmip.load_poses_bounds(pb)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    frames = [{"file_path": f"./images/{i}",
               "transform_matrix": np.eye(4).tolist()} for i in range(3)]
    tj = str(tmp_path / "transforms_train.json")
    with open(tj, "w") as f:
        json.dump({"camera_angle_x": 0.7, "fl_x": 30.0, "w": 32, "h": 24,
                   "frames": frames}, f)
    got, want = tmip.load_transforms_json(tj), jmip.load_transforms_json(tj)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("dirs,ask", [(("images",), 1), (("images_4",), 1),
                                      (("images", "images_2"), 2),
                                      (("images", "images_2"), 4)])
def test_pick_image_dir_matches_jax(tmp_path, dirs, ask):
    for d in dirs:
        os.makedirs(tmp_path / d)
    assert tmip._pick_image_dir(str(tmp_path), ask) \
        == jmip._pick_image_dir(str(tmp_path), ask)


@pytest.mark.parametrize("downsample", [1, 2])
def test_prepare_mipnerf_matches_jax(tmp_path, downsample):
    """The port's preparation writes the JAX package's files, byte for byte
    (images, poses, cam_meta, the point cloud)."""
    raw = _make_mipnerf_scene(tmp_path)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    ia = tmip.prepare_mipnerf360_dataset(raw, a, image_downsample=downsample)
    ib = jmip.prepare_mipnerf360_dataset(raw, b, image_downsample=downsample)
    assert {k: v for k, v in ia.items() if k != "output_dir"} \
        == {k: v for k, v in ib.items() if k != "output_dir"}
    _same_tree(a, b)


def test_colmap_convert_matches_jax(tmp_path):
    sparse = str(tmp_path / "sparse0")
    _write_colmap_model(sparse)
    img_dir = str(tmp_path / "photos")
    os.makedirs(img_dir)
    r = np.random.default_rng(2)
    for name in ("a.png", "b.png"):
        timg.save_image(os.path.join(img_dir, name),
                        r.uniform(0, 1, (48, 64, 3)).astype(np.float32))
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    ia = tcol.convert_colmap_to_training_format(sparse, img_dir, a,
                                                downscale=0.5)
    ib = jcol.convert_colmap_to_training_format(sparse, img_dir, b,
                                                downscale=0.5)
    assert ia == ib
    _same_tree(a, b)
    if tcol.shutil.which("colmap") is None:  # the pipeline needs the binary
        with pytest.raises(RuntimeError, match="colmap binary not found"):
            tcol.run_colmap_reconstruction(img_dir, str(tmp_path / "ws"))


# --- the dataset --------------------------------------------------------------

def _views_equal(got, want):
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_dataset_and_batches_match_jax(tmp_path, scale):
    d = _make_dataset_dir(tmp_path, n_views=5)
    t, j = tds.GaussianDataset(d, scale_factor=scale), \
        jds.GaussianDataset(d, scale_factor=scale)
    for f in ("height", "width", "fx", "fy", "cx", "cy"):
        assert getattr(t, f) == getattr(j, f), f
    assert len(t) == len(j) == 5 and t.pointcloud_path() == j.pointcloud_path()
    assert t.size_bytes() == j.size_bytes() and t.size_bytes(1) * 4 \
        == t.size_bytes()
    for i in range(5):
        _views_equal(t[i], j[i])
    bt, bj = t.batches(3, seed=4), j.batches(3, seed=4)
    for _ in range(4):  # wraps the epoch, reshuffled
        _views_equal(next(bt), next(bj))
    np.testing.assert_array_equal(
        tds.load_camera_parameters(os.path.join(d, "cam_meta.npy"))["fx"],
        35.0)


def test_mismatched_view_rescaled_like_jax(tmp_path):
    d = str(tmp_path / "scene")
    os.makedirs(os.path.join(d, "images"))
    r = np.random.default_rng(6)
    timg.save_image(os.path.join(d, "images", "000.png"),
                    r.uniform(0, 1, (24, 32, 3)))
    timg.save_image(os.path.join(d, "images", "001.png"),
                    r.uniform(0, 1, (48, 64, 3)))
    np.save(os.path.join(d, "cam_meta.npy"), {"fx": 30.0, "fy": 30.0})
    t, j = tds.GaussianDataset(d, scale_factor=1.0), jds.GaussianDataset(d, scale_factor=1.0)
    assert t[1]["image"].shape == (24, 32, 3)
    np.testing.assert_array_equal(t[1]["image"], j[1]["image"])
    np.testing.assert_array_equal(t.c2w, np.tile(np.eye(4), (2, 1, 1)))


def test_holdout_split_matches_jax(tmp_path):
    d = _make_dataset_dir(tmp_path, n_views=9)
    for split in ("train", "test"):
        t = tds.GaussianDataset(d, scale_factor=1.0, holdout_every=3, split=split)
        j = jds.GaussianDataset(d, scale_factor=1.0, holdout_every=3, split=split)
        assert t.image_paths == j.image_paths
        np.testing.assert_array_equal(t.c2w, j.c2w)
    assert len(t) == 3
    with pytest.raises(ValueError):
        tds.GaussianDataset(d, split="train")
    with pytest.raises(ValueError):
        tds.GaussianDataset(d, split="val", holdout_every=3)


@pytest.mark.parametrize("quantize", [False, True])
def test_device_batches_match_batches_and_jax(tmp_path, quantize):
    """device_batches on the CPU: the host batches' views in the same order
    (f32 exact, uint8 within 1e-6), and JAX's device_batches' views."""
    d = _make_dataset_dir(tmp_path, n_views=5)
    t = tds.GaussianDataset(d, scale_factor=1.0)
    j = jds.GaussianDataset(d, scale_factor=1.0)
    host = t.batches(2, seed=7)
    dev = t.device_batches(2, seed=7, quantize=quantize, device="cpu")
    jdev = j.device_batches(2, seed=7, quantize=quantize)
    for _ in range(5):
        a, b, c = next(host), next(dev), next(jdev)
        assert isinstance(b["image"], torch.Tensor)
        assert b["image"].dtype == torch.float32
        np.testing.assert_allclose(b["image"].numpy(), a["image"], rtol=0,
                                   atol=1e-6 if quantize else 0)
        np.testing.assert_array_equal(b["image"].numpy(),
                                      np.asarray(c["image"]))
        for k in ("c2w", "fx", "fy", "cx", "cy"):
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(c[k]))
    # With a mesh (multi-device training is ported): each data coordinate
    # takes its share of every global batch, in the same order.
    from gsplat_tpu_torch.parallel import Mesh

    shards = [t.device_batches(4, seed=7, quantize=quantize, mesh=Mesh(
        {"data": 2, "tile": 1}, d, (d, 0), torch.device("cpu"), None))
        for d in range(2)]
    whole = t.device_batches(4, seed=7, quantize=quantize, device="cpu")
    for _ in range(3):
        a, b0, b1 = next(whole), next(shards[0]), next(shards[1])
        for k in a:
            assert torch.equal(torch.cat([b0[k], b1[k]]), a[k]), k
    with pytest.raises(ValueError, match="divisible"):
        next(t.device_batches(3, mesh=Mesh({"data": 2, "tile": 1}, 0,
                                           (0, 0), torch.device("cpu"),
                                           None)))


def test_prefetch_propagates_errors_and_stops(tmp_path):
    import threading
    import time

    d = _make_dataset_dir(tmp_path)
    ds = tds.GaussianDataset(d, scale_factor=1.0)
    plain, pre = ds.batches(2, seed=3), ds.prefetched_batches(2, seed=3)
    for _ in range(3):
        _views_equal(next(pre), next(plain))

    def boom():
        yield {"x": 1}
        raise RuntimeError("decode failed")

    it = tds.prefetch(boom())
    assert next(it) == {"x": 1}
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)

    done = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            done.set()

    it = tds.prefetch(endless(), depth=1)
    assert next(it) == 0
    it.close()
    deadline = time.monotonic() + 5.0
    while not done.is_set() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert done.is_set(), "prefetch worker still parked after consumer close"


# --- gaussian PLY and .splat --------------------------------------------------

def _gauss_params(n=120, seed=9):
    r = np.random.default_rng(seed)
    return {
        "pos": np.stack([r.uniform(-1, 1, n), r.uniform(-1, 1, n),
                         r.uniform(3, 5, n)], -1).astype(np.float32),
        "scale_raw": (r.normal(0, 0.2, (n, 3)) - 2.0).astype(np.float32),
        "q_raw": (r.normal(0, 1, (n, 4)) + [0, 0, 0, 2.0]).astype(
            np.float32),
        "opacity_raw": r.normal(1.0, 0.5, n).astype(np.float32),
        "f_dc": r.normal(0, 0.8, (n, 3)).astype(np.float32),
        "f_rest": r.normal(0, 0.05, (n, 45)).astype(np.float32),
    }


@pytest.mark.parametrize("convert", [False, True])
def test_gsply_matches_jax_and_renders_equal(tmp_path, convert):
    params = _gauss_params()
    alive = np.ones(120, bool)
    alive[::7] = False
    a, b = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    n = tply.export_gaussians_ply(a, params, alive=alive,
                                  convert_colors=convert)
    assert n == jply.export_gaussians_ply(b, params, alive=alive,
                                          convert_colors=convert)
    with open(a, "rb") as x, open(b, "rb") as y:
        assert x.read() == y.read()
    back, jback = tply.import_gaussians_ply(a), jply.import_gaussians_ply(a)
    for k in back:
        np.testing.assert_array_equal(back[k], jback[k])
    if convert:
        return
    for k in ("pos", "f_dc", "f_rest", "opacity_raw", "scale_raw"):
        np.testing.assert_array_equal(back[k], params[k][alive])
    cfg = gt.RenderConfig(height=64, width=64, max_pairs=4096)
    with torch.no_grad():
        img_a, _ = gt.render_from_params(
            {k: torch.from_numpy(v) for k, v in params.items()}, np.eye(4),
            60.0, 60.0, 32.0, 32.0, cfg, alive=torch.from_numpy(alive))
        img_b, _ = gt.render_from_params(
            {k: torch.from_numpy(v) for k, v in back.items()}, np.eye(4),
            60.0, 60.0, 32.0, 32.0, cfg)
    # The exported quaternion is normalized; the covariance normalizes too.
    assert float((img_a - img_b).abs().max()) <= 1e-5


def test_splat_export_matches_jax(tmp_path):
    params = _gauss_params(40, seed=11)
    alive = np.ones(40, bool)
    alive[::5] = False
    a, b = str(tmp_path / "t.splat"), str(tmp_path / "j.splat")
    assert tply.export_gaussians_splat(a, params, alive=alive) \
        == jply.export_gaussians_splat(b, params, alive=alive) == 32
    with open(a, "rb") as x, open(b, "rb") as y:
        assert x.read() == y.read()


# --- photo-plane scenes -------------------------------------------------------

def test_photo_plane_warps_match_jax(tmp_path):
    r = np.random.default_rng(12)
    photo = r.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[0, 3] = 0.2
    np.testing.assert_array_equal(
        tpp.warp_photo_view(photo, c2w, 50.0, 50.0, 31.5, 23.5, 48, 64),
        jpp.warp_photo_view(photo, c2w, 50.0, 50.0, 31.5, 23.5, 48, 64))
    tex = tpp.plane_textures(photo, 3)
    planes = list(tpp.DEFAULT_PLANES[:3])
    np.testing.assert_array_equal(
        tpp.warp_multiplane_view(tex, planes, c2w, 50.0, 50.0, 31.5, 23.5,
                                 48, 64),
        jpp.warp_multiplane_view(tex, planes, c2w, 50.0, 50.0, 31.5, 23.5,
                                 48, 64))
    for make, kw in (("make_photo_plane_scene", {}),
                     ("make_photo_multiplane_scene", {"n_planes": 2})):
        a, b = str(tmp_path / f"t{make}"), str(tmp_path / f"j{make}")
        ma = getattr(tpp, make)(a, photo=photo, n_views=4, height=24,
                                width=32, **kw)
        mb = getattr(jpp, make)(b, photo=photo, n_views=4, height=24,
                                width=32, **kw)
        assert ma == mb
        _same_tree(a, b)


# --- fit() from a dataset's point cloud ---------------------------------------

def _record_adc(monkeypatch, module):
    seen = []
    inner = module.adc_step

    def wrapped(*args, **kw):
        state, res = inner(*args, **kw)
        seen.append(tuple(int(getattr(res, f)) for f in (
            "num_pruned", "num_split", "num_cloned", "num_overflowed")))
        return state, res

    monkeypatch.setattr(module, "adc_step", wrapped)
    return seen


def test_fit_from_dataset_point_cloud_matches_jax(monkeypatch, tmp_path):
    """Both packages' fit() on their GaussianDataset of one directory: the
    pool starts from the directory's point cloud, the views come from the
    device cache in the same order, and the clone-only ADC counts and the
    logged losses agree."""
    jfit = importlib.import_module("gsplat_tpu.train.fit")
    tfit = importlib.import_module("gsplat_tpu_torch.train.fit")
    d = _make_dataset_dir(tmp_path, n_views=4, h=32, w=48)
    train = dict(iterations=6, batch_size=2, capacity=64,
                 densification_interval=3, densify_until_iter=6,
                 max_grad=1e-9, scale_threshold=1e3,
                 opacity_reset_interval=10_000, checkpoint_interval=10_000)
    adc_j, adc_t = _record_adc(monkeypatch, jfit), _record_adc(monkeypatch,
                                                               tfit)
    logs_j, logs_t = [], []
    _, rep_j = jfit.fit(
        jds.GaussianDataset(d, scale_factor=1.0),
        gj.RenderConfig(height=32, width=48, max_pairs=4096, pair_block=32,
                        backend="pallas"),
        gj.TrainConfig(**train), log_every=2, log_fn=logs_j.append)
    state, rep = tfit.fit(
        tds.GaussianDataset(d, scale_factor=1.0),
        gt.RenderConfig(height=32, width=48, max_pairs=4096, pair_block=32),
        gt.TrainConfig(**train), log_every=2, log_fn=logs_t.append,
        device="cpu")
    init = [m for m in logs_t if m.startswith("init from")]
    assert init and init == [m for m in logs_j if m.startswith("init from")]
    assert [m for m in logs_t if m.startswith("device-caching 4 views")]
    assert adc_t == adc_j and adc_t[0][2] > 0
    assert rep.num_gaussians == rep_j.num_gaussians
    assert [it for it, _ in rep.losses] == [it for it, _ in rep_j.losses]
    for (it, got), (_, want) in zip(rep.losses, rep_j.losses):
        assert abs(got - want) <= 0.01 * want, (it, got, want)
    # The device cache's tiers: uint8 when f32 does not fit, host batches
    # when neither does.
    for budget, line in ((4 * 32 * 48 * 3 * 2, "uint8-quantized"), (16, None)):
        logs = []
        tfit.fit(tds.GaussianDataset(d, scale_factor=1.0),
                 gt.RenderConfig(height=32, width=48, max_pairs=4096,
                                 pair_block=32),
                 gt.TrainConfig(**dict(train, iterations=1)), log_every=1,
                 log_fn=logs.append, device="cpu",
                 device_cache_bytes=budget)
        cached = [m for m in logs if m.startswith("device-caching")]
        assert (line in cached[0]) if line else not cached


def test_points3d_written_by_struct_parses_like_jax(tmp_path):
    """A points3D.bin with tracks of several lengths (the records are
    variable-length)."""
    path = str(tmp_path / "points3D.bin")
    r = np.random.default_rng(13)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", 6))
        for i in range(6):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<3d", *r.normal(0, 1, 3)))
            f.write(struct.pack("<3B", *r.integers(0, 256, 3)))
            f.write(struct.pack("<d", 0.1))
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<ii", 0, 0) * i)
    got = tcol.read_points3d_binary(path)
    assert got.shape == (6, 6)
    np.testing.assert_array_equal(got, jcol.read_points3d_binary(path))


def test_checkpoint_roundtrip_dcp(tmp_path):
    """The twin of tests/test_data_layer.py::test_checkpoint_roundtrip_orbax
    on the port's ``torch.distributed.checkpoint`` pair, in one process:
    the step, every parameter, ``alive`` and Adam's moments and counts
    come back bit for bit into a fresh state of the same capacity."""
    from gsplat_tpu_torch.train import trainer

    pts = np.random.default_rng(8).normal(0, 1, (16, 3)).astype(np.float32)
    cfg = gt.TrainConfig(capacity=32)

    def fresh():
        return gt.init_train_state(
            gt.init_pool_from_points(pts, capacity=32, device="cpu"), cfg)

    state = fresh()._replace(step=torch.tensor(9, dtype=torch.int32))
    r = np.random.default_rng(9)
    with torch.no_grad():
        state.pool.alive[3] = False
        for p in state.pool.params.values():
            st = state.opt_state.state[p]
            st["step"].fill_(4.0)
            for key in ("exp_avg", "exp_avg_sq"):
                st[key].copy_(torch.from_numpy(
                    r.uniform(0, 1, tuple(p.shape)).astype(np.float32)))
    trainer.save_checkpoint_dcp(tmp_path / "dcp_ckpt", state)
    restored = trainer.load_checkpoint_dcp(tmp_path / "dcp_ckpt", fresh())
    assert int(restored.step) == 9
    assert torch.equal(restored.pool.alive, state.pool.alive)
    for k, p in state.pool.params.items():
        q = restored.pool.params[k]
        assert torch.equal(q, p), k
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(restored.opt_state.state[q][key],
                               state.opt_state.state[p][key]), (k, key)
