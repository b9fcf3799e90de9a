"""P1, the per-gaussian stages in one kernel (``ops/csrc/preprocess.cu``),
on a CUDA card against the plain chain it replaces.

Needs a card; every test here skips without one. It imports neither JAX
nor the suite's conftest (the GPU machine has no JAX), so run it with

    python -m pytest --noconftest tests/test_torch_gpu_preprocess.py -m gpu

Tolerance: none. P1 writes every expression in the plain chain's order
with the roundings of PyTorch's CUDA kernels (``-fmad=false``, expf,
logf, IEEE sqrt and division, NaN-keeping clamps, the reduction orders of
PyTorch's reduction kernels), so every field of the projection and the
colours equal the plain chain's bit for bit, the NaNs that dead slots
carry included; the integer fields (radius, tile corners, valid) decide
the pairs. Cases: SH degrees 0-3, each ``aa_mode``, with and without
``pix_guard_v``, intrinsics as numbers and as 0-d tensors on the card; a
scene with dead slots holding NaN, +-inf and 1e30, gaussians behind the
camera, at ``near`` and ``far`` and on the guard band's edges; the two
benchmark scenes (the 131,072-slot checkpoint at orbit poses, the
2,959,677-gaussian garden at its bench pose); ``pair_demand``'s
colourless variant. Through ``make_render_fn``: the frame equal to the
plain chain's, one P1 launch a frame, in ``gs.project``, and no
``gs.cov_sh``; a training step launches no P1. A CUDA input P1 cannot
take (another dtype, a view that is not contiguous or not 16-byte
aligned, an alive mask that is not bool, f_rest beyond degree 3, an intrinsic
that is neither a number nor a 0-d float32 tensor) raises through the
entry points under ``torch.no_grad()``, before any launch.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch import scene
from gsplat_tpu_torch.ops import preprocess as P
from gsplat_tpu_torch.profile_stages import bench_pose
from gsplat_tpu_torch.profile_trace import trace_stages
from gsplat_tpu_torch.train.trainer import restore_pool
from gsplat_tpu_torch.viewer import (create_orbit_trajectory,
                                     estimate_scene_center_radius,
                                     make_render_fn)

pytestmark = pytest.mark.gpu

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "benchmark" / "data" / "ckpt120k.npz"
GARDEN = 2_959_677
H, W = 540, 960
FX, FY, CX, CY = 0.85 * W, 0.83 * W, 480.5, 269.25
FIELDS = ("uv", "depth", "conic", "opacity", "radius", "tile_min",
          "tile_max", "valid")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return gt.resolve_device("cuda")


def _pose(yaw=0.3, pitch=-0.2, t=(0.3, -0.2, -0.5)):
    cy_, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    ry = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    c2w = np.eye(4)
    c2w[:3, :3] = ry @ rx
    c2w[:3, 3] = t
    return c2w.astype(np.float32)


def _hard_scene(rest_width: int, dev, c2w, cfg, n=60_000, seed=5):
    """Leaves and an alive mask that reach every branch: scales from the
    eigenvalue clamp's floor to its ceiling, opacities across the cutoff,
    gaussians behind the camera, exactly at ``near`` and ``far`` and on the
    guard band's four edges, and dead slots holding NaN, +-inf and 1e30 in
    every leaf (one alive slot with a NaN position too)."""
    r = np.random.default_rng(seed)
    cam = np.stack([r.uniform(-3, 3, n), r.uniform(-2, 2, n),
                    r.uniform(-1, 12, n)], -1)
    k = n // 12
    cam[:k, 2] = cfg.near
    cam[k:2 * k, 2] = cfg.far
    z = cam[2 * k:6 * k, 2] = r.uniform(0.5, 9, 4 * k)
    g, gv = cfg.pix_guard, cfg.pix_guard if cfg.pix_guard_v is None \
        else cfg.pix_guard_v
    cam[2 * k:3 * k, 0] = z[:k] * (-g - CX) / FX
    cam[3 * k:4 * k, 0] = z[k:2 * k] * (W + g - CX) / FX
    cam[4 * k:5 * k, 1] = z[2 * k:3 * k] * (-gv - CY) / FY
    cam[5 * k:6 * k, 1] = z[3 * k:] * (H + gv - CY) / FY
    R, t = c2w[:3, :3].astype(np.float64), c2w[:3, 3].astype(np.float64)
    p = {"pos": cam @ R.T + t,
         "scale_raw": r.normal(-3, 1.5, (n, 3)),
         "q_raw": r.normal(0, 1, (n, 4)),
         "opacity_raw": r.normal(-2, 3, n),
         "f_dc": r.normal(0, 1, (n, 3)),
         "f_rest": r.normal(0, 0.3, (n, rest_width))}
    p["scale_raw"][:200] = 8.0
    p["scale_raw"][200:400] = -20.0
    p = {k_: v.astype(np.float32) for k_, v in p.items()}
    alive = r.uniform(size=n) > 0.1
    dead = np.flatnonzero(~alive)
    bad = np.array([np.nan, np.inf, -np.inf, 1e30], np.float32)
    for j, key in enumerate(p):
        rows = dead[j::len(p)]
        p[key][rows] = bad[np.arange(rows.size) % 4].reshape(
            (-1,) + (1,) * (p[key].ndim - 1))
    p["pos"][np.flatnonzero(alive)[7]] = np.nan
    t_ = {k_: torch.from_numpy(v).to(dev) for k_, v in p.items()}
    return t_, torch.from_numpy(alive).to(dev)


def _mismatch(a: torch.Tensor, b: torch.Tensor):
    """(elements that differ in their bits, largest gap in ulps) or None."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return f"{tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}"
    if a.dtype.is_floating_point:
        ia, ib = a.view(torch.int32), b.view(torch.int32)
        bad = ia != ib
        if not bool(bad.any()):
            return None
        # ordered integers: ulps between two floats of one sign
        oa = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia).long()
        ob = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib).long()
        return int(bad.sum()), int((oa - ob).abs().max())
    bad = a != b
    return (int(bad.sum()), None) if bool(bad.any()) else None


def _compare(got, want) -> dict:
    """{field: mismatch} over the projection's fields and the colours."""
    (pg, cg), (pw, cw) = got, want
    out = {f: _mismatch(getattr(pg, f), getattr(pw, f)) for f in FIELDS}
    if cw is not None or cg is not None:
        out["rgb"] = _mismatch(cg, cw)
    return {k: v for k, v in out.items() if v is not None}


def _intrinsics(kind, dev):
    if kind == "numbers":
        return FX, FY, CX, CY
    return tuple(torch.tensor(x, dtype=torch.float32, device=dev)
                 for x in (FX, FY, CX, CY))


def _both(params, c2w, intr, cfg, alive, colour=True):
    """(P1's, the plain chain's) projection and colours, one launch of P1."""
    with torch.no_grad():
        assert P.kernel_applies(params, c2w, intr, None, colour)
        n0 = P.preprocess_cuda.launches
        got = P.preprocess(params, c2w, *intr, cfg, alive=alive,
                           colour=colour)[:2]
        assert P.preprocess_cuda.launches == n0 + 1
        want = P.preprocess_plain(params, c2w, *intr, cfg, alive=alive,
                                  colour=colour)[:2]
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("intr", ["numbers", "tensors"])
@pytest.mark.parametrize("guard_v", [None, 48.0], ids=["guard", "guard_v"])
@pytest.mark.parametrize("aa_mode", ["none", "dilate", "mip"])
@pytest.mark.parametrize("rest", [0, 9, 24, 45], ids=["sh0", "sh1", "sh2",
                                                     "sh3"])
def test_p1_equals_the_plain_chain(cuda, rest, aa_mode, guard_v, intr):
    cfg = gt.RenderConfig(height=H, width=W, aa_mode=aa_mode,
                          pix_guard_v=guard_v)
    c2w_np = _pose()
    params, alive = _hard_scene(rest, cuda, c2w_np, cfg)
    c2w = torch.from_numpy(c2w_np).to(cuda)
    got, want = _both(params, c2w, _intrinsics(intr, cuda), cfg, alive)
    assert _compare(got, want) == {}
    valid = want[0].valid
    assert 0 < int(valid.sum()) < valid.numel()
    # the cases reach what they are for: NaN carried, huge and tiny
    # splats, both clamp branches
    assert bool(torch.isnan(want[0].opacity).any())
    assert bool(torch.isnan(want[1]).any())


def test_p1_without_an_alive_mask(cuda):
    cfg = gt.RenderConfig(height=H, width=W)
    c2w_np = _pose(yaw=-0.7, pitch=0.1, t=(-0.4, 0.3, 0.2))
    params, _ = _hard_scene(45, cuda, c2w_np, cfg, seed=9)
    c2w = torch.from_numpy(c2w_np).to(cuda)
    got, want = _both(params, c2w, _intrinsics("numbers", cuda), cfg, None)
    assert _compare(got, want) == {}


def _orbit(pool, count=120, radius_mult=4.4):
    pos = pool.params["pos"].detach()[pool.alive].cpu().numpy()
    center, radius = estimate_scene_center_radius(positions=pos)
    return create_orbit_trajectory(center, radius_mult * radius,
                                   num_frames=count, elevation_deg=15.0)


@pytest.mark.parametrize("colour", [True, False], ids=["colour", "demand"])
def test_p1_on_the_checkpoint_at_orbit_poses(cuda, colour):
    """The 131,072-slot asset of ``serve-ckpt120k-orbit`` at 1920x1080 from
    four poses of a 4.4 R orbit and its bench pose."""
    pool = restore_pool(str(CKPT), device=cuda)
    cfg = gt.RenderConfig(height=1080, width=1920)
    f = 0.85 * 1920
    poses = list(_orbit(pool)[::30]) + [bench_pose(pool)[0]]
    for c2w_np in poses:
        c2w = torch.as_tensor(np.asarray(c2w_np), dtype=torch.float32,
                              device=cuda)
        got, want = _both(pool.params, c2w, (f, f, 960.0, 540.0), cfg,
                          pool.alive, colour)
        assert _compare(got, want) == {}
        assert int(want[0].valid.sum()) > 1000


@pytest.mark.parametrize("colour", [True, False], ids=["colour", "demand"])
def test_p1_on_the_garden_scene_at_its_bench_pose(cuda, colour):
    params = scene.make_scene(GARDEN, seed=3, device=cuda)
    alive = torch.ones(GARDEN, dtype=torch.bool, device=cuda)
    pool = gt.GaussianPool(params, alive)
    c2w = torch.as_tensor(bench_pose(pool)[0], dtype=torch.float32,
                          device=cuda)
    cfg = gt.RenderConfig(height=1080, width=1920)
    f = 0.85 * 1920
    got, want = _both(params, c2w, (f, f, 960.0, 540.0), cfg, alive, colour)
    assert _compare(got, want) == {}
    assert int(want[0].valid.sum()) > 100_000


def test_pair_demand_takes_the_colourless_variant(cuda, monkeypatch):
    pool = restore_pool(str(CKPT), device=cuda)
    cfg = gt.RenderConfig(height=1080, width=1920, max_pairs=2**22)
    f = 0.85 * 1920
    c2w = _orbit(pool)[17]
    with torch.no_grad():
        n0 = P.preprocess_cuda.launches
        got = gt.pair_demand(pool.params, c2w, f, f, 960.0, 540.0, cfg,
                             alive=pool.alive)
        assert P.preprocess_cuda.launches == n0 + 1
        monkeypatch.setattr(P, "kernel_applies", lambda *a, **k: False)
        want = gt.pair_demand(pool.params, c2w, f, f, 960.0, 540.0, cfg,
                              alive=pool.alive)
        assert P.preprocess_cuda.launches == n0 + 1
    assert [int(x) for x in got] == [int(x) for x in want]
    assert int(got[0]) > 0


def test_served_frames_through_make_render_fn(cuda, monkeypatch, tmp_path):
    """The checkpoint's frames from ``make_render_fn``: equal to the plain
    chain's frames bit for bit, one P1 launch a frame, in ``gs.project``
    with nothing else, and no ``gs.cov_sh``."""
    pool = restore_pool(str(CKPT), device=cuda)
    cfg = gt.RenderConfig(height=1080, width=1920, max_pairs=2**23)
    f = 0.85 * 1920
    fn = make_render_fn(pool.params, cfg, f, f, 960.0, 540.0,
                        alive=pool.alive)
    poses = _orbit(pool)[5::40]
    n0 = P.preprocess_cuda.launches
    frames = [fn(c2w) for c2w in poses]
    assert P.preprocess_cuda.launches == n0 + len(poses)
    with monkeypatch.context() as m:
        m.setattr(P, "kernel_applies", lambda *a, **k: False)
        plain = [fn(c2w) for c2w in poses]
    assert P.preprocess_cuda.launches == n0 + len(poses)
    for a, b in zip(frames, plain):
        assert torch.equal(a, b)
        assert float(a.mean()) > 0.01

    # A trace can lose device records at its start after earlier traces
    # in the process: trace_stages traces a frame before the one it sums.
    r = trace_stages(pool.params, poses[0], f, f, 960.0, 540.0, cfg,
                     pool.alive, str(tmp_path))["ranges"]
    assert "gs.cov_sh" not in r
    assert r["gs.project"]["launches"] == 1
    assert r["gs.project"]["kernels"] == 1


def test_a_training_step_launches_no_p1(cuda):
    params = scene.make_scene(20_000, seed=1, device=cuda)
    n = params["pos"].shape[0]
    pool = gt.GaussianPool({k: v.clone() for k, v in params.items()},
                           torch.ones(n, dtype=torch.bool, device=cuda))
    cfg = gt.RenderConfig(height=270, width=480, max_pairs=2**20)
    tcfg = gt.TrainConfig(capacity=n, batch_size=1)
    state = gt.init_train_state(pool, tcfg)
    step = gt.make_train_step(cfg, tcfg)
    fx = 0.85 * 480
    batch = {"image": torch.rand(1, 270, 480, 3, device=cuda),
             "c2w": torch.eye(4, device=cuda)[None],
             **{k: torch.full((1,), v, device=cuda) for k, v in
                (("fx", fx), ("fy", fx), ("cx", 240.0), ("cy", 135.0))}}
    n0 = P.preprocess_cuda.launches
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    assert P.preprocess_cuda.launches == n0


def _offset(t):
    """``t``'s values in a view 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _malformed(params, alive, dev):
    """(what, leaves, alive, (fx, fy, cx, cy)), one fault each."""
    intr = (FX, FY, CX, CY)
    yield "float64", dict(params, q_raw=params["q_raw"].double()), alive, intr
    yield "strided", dict(params, pos=params["pos"].t().contiguous().t()), \
        alive, intr
    yield "misaligned", dict(params, scale_raw=_offset(params["scale_raw"])), \
        alive, intr
    rest44 = params["f_rest"][:, :44].contiguous()
    yield "rest44", dict(params, f_rest=rest44), alive, intr
    yield "alive_int", params, alive.int(), intr
    yield "np_float32", params, alive, (FX, FY, np.float32(CX), CY)
    yield "one_element", params, alive, \
        (FX, FY, torch.tensor([CX], device=dev), CY)
    yield "float64_0d", params, alive, \
        (FX, FY, CX, torch.tensor(CY, dtype=torch.float64, device=dev))


def test_malformed_inputs_raise_through_the_entry_points(cuda):
    """Under ``torch.no_grad()`` a CUDA input P1 cannot take raises through
    ``render_from_params`` and ``pair_demand``, and neither falls back to
    the plain chain; so does P1's wrapper given a pose off the card.
    ``pair_demand``'s colourless variant reads no f_rest, so an f_rest of
    another width launches it."""
    cfg = gt.RenderConfig(height=H, width=W)
    params, alive = _hard_scene(45, cuda, _pose(), cfg, n=1000)
    c2w = torch.from_numpy(_pose()).to(cuda)
    n0 = P.preprocess_cuda.launches
    with torch.no_grad():
        for what, p, a, intr in _malformed(params, alive, cuda):
            with pytest.raises(ValueError):
                gt.render_from_params(p, c2w, *intr, cfg, alive=a)
            if what == "rest44":
                gt.pair_demand(p, c2w, *intr, cfg, alive=a)
                assert P.preprocess_cuda.launches == n0 + 1
            else:
                with pytest.raises(ValueError):
                    gt.pair_demand(p, c2w, *intr, cfg, alive=a)
        with pytest.raises(ValueError, match="c2w"):
            P.preprocess_cuda(params, c2w.cpu(), FX, FY, CX, CY, cfg, alive)
    assert P.preprocess_cuda.launches == n0 + 1
