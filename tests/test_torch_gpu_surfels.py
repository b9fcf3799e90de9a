"""The surfel compositors S1 and S2 (``ops/csrc/raster_surfel.cu``, 2D
Gaussian Splatting) on a CUDA card against their plain versions, and a
surfel training step through ``make_train_step``.

Needs a card; every test here skips without one. It imports neither JAX
nor the suite's conftest (the GPU machine has no JAX), so run it with

    python -m pytest --noconftest tests/test_torch_gpu_surfels.py -m gpu

Two scenes at the benchmark cell's 1297x840: 200k random surfels from the
origin camera, and the 3 M garden scene (``scene.make_scene``, its first
two scale columns) from its first pose.

* S1 equals ``composite_surfels_plain`` bit for bit: the same sums in the
  same order, ``-fmad=false``, ``expf`` and IEEE divisions as PyTorch's
  CUDA kernels compute them; its per-warp cull drops only (pair, warp)
  whose alpha is exactly 0 at the warp's 32 pixels, which change no bit.
* S2 sums each pair's terms over a warp by recursive halving and over the
  tile's warps in warp order, where the plain version sums a tile's 256
  pixels in one reduction: the same float32 terms in another order. Each
  of the 18 gradient rows agrees within 1e-4 of the row's largest
  magnitude (sums of up to 256 terms, several of which cancel: the
  distortion's and the transmittance's), and S2 is deterministic: two
  launches give the same bits.
* ``make_train_step`` on a surfel pool launches S1 and S2 once a view and
  neither K1 nor K2, U1 and U2 once each a step, counted from 0, with
  finite losses and no step skipped; neither kernel spills.
"""

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch.config import RenderConfig, SurfelConfig, TrainConfig
from gsplat_tpu_torch.models.gaussians import GaussianPool
from gsplat_tpu_torch.ops import raster_cuda as rc
from gsplat_tpu_torch.ops import raster_surfel as rs
from gsplat_tpu_torch.ops.binning import bin_gaussians
from gsplat_tpu_torch.ops.surfel import surfel_transform
from gsplat_tpu_torch.render import pair_demand, render_from_params
from gsplat_tpu_torch.train import trainer as ttr

pytestmark = pytest.mark.gpu

SC = SurfelConfig()
S2_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return gt.resolve_device("cuda")


def _scene(dev, scene, height=840, width=1297):
    """(params, poses, (fx, fy, cx, cy), cfg sized to the poses' demand)."""
    from gsplat_tpu_torch import profile_binning as PB

    if scene == "garden3m":
        from gsplat_tpu_torch.scene import make_scene

        params = make_scene(PB.GARDEN_GAUSSIANS, 24, dev)
        poses = [PB._origin_pose(*p) for p in PB.GARDEN_POSES[:2]]
    else:
        n = 200_000
        r = np.random.default_rng(5)
        params = {"pos": np.stack([r.uniform(-4, 4, n),
                                   r.uniform(-2.5, 2.5, n),
                                   r.uniform(3, 12, n)], -1),
                  "scale_raw": r.normal(0, 0.3, (n, 3)) - 3.0,
                  "q_raw": r.normal(0, 1, (n, 4)) + np.array([0, 0, 0, 1]),
                  "opacity_raw": r.normal(0.5, 1, n),
                  "f_dc": r.normal(0, 0.8, (n, 3)),
                  "f_rest": r.normal(0, 0.05, (n, 45))}
        params = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                  for k, v in params.items()}
        c2w = np.eye(4, dtype=np.float32)
        poses = [c2w, c2w.copy()]
        poses[1][:3, 3] = [0.2, -0.1, 0.3]
    params["scale_raw"] = params["scale_raw"][:, :2].contiguous()
    cam = (0.85 * width, 0.85 * width, width / 2.0, height / 2.0)
    cfg = RenderConfig(height=height, width=width, max_pairs=4096)
    demand = max(int(pair_demand(params, c, *cam, cfg)[0]) for c in poses)
    return params, poses, cam, cfg.with_(max_pairs=PB._sized(demand))


def _inputs(dev, scene):
    """S1's inputs at the scene's first pose: (table, binning, cfg)."""
    params, poses, cam, cfg = _scene(dev, scene)
    c2w = torch.from_numpy(poses[0]).to(dev)
    with torch.no_grad():
        proj, rows = surfel_transform(params, c2w, *cam, cfg, SC)
        bn = bin_gaussians(proj, cfg)
        tab = rs.table(rows[bn.depth_order.long()])
    assert int(bn.num_pairs) <= cfg.max_pairs
    return tab, bn, cfg


CARD_SCENES = ["200k", "garden3m"]


@pytest.mark.parametrize("scene", CARD_SCENES)
def test_s1_equals_its_plain_version_on_the_card(cuda, scene):
    tab, bn, cfg = _inputs(cuda, scene)
    args = (tab, bn.pair_slot, bn.tile_start, bn.tile_count, cfg, SC)
    with torch.no_grad():
        n0 = rs.composite_surfels.launches
        got = rs.composite_surfels(*args)
        assert rs.composite_surfels.launches == n0 + 1
        want = rs.composite_surfels_plain(*args, tile_chunk=512)
    diff = [float((got[:, r] - want[:, r]).abs().max())
            for r in range(rs.OUT_ROWS)]
    assert torch.equal(got, want), diff
    assert float(want[:, 4].max()) > 0.5  # some pixel is nearly opaque
    assert float(want[:, 8].abs().max()) > 0  # and has a distortion


@pytest.mark.parametrize("scene", CARD_SCENES)
def test_s2_matches_its_plain_version_on_the_card(cuda, scene):
    tab, bn, cfg = _inputs(cuda, scene)
    args = (tab, bn.pair_slot, bn.tile_start, bn.tile_count)
    g = torch.Generator(device=cuda).manual_seed(3)
    with torch.no_grad():
        out = rs.composite_surfels(*args, cfg, SC)
        gout = torch.randn(out.shape, generator=g, device=cuda) * 1e-6
        gout[:, 9:] = 0.0
        n0 = rs.composite_surfels.bwd_launches
        dk = rs.composite_surfels_bwd(*args, out, gout, cfg, SC)
        dk2 = rs.composite_surfels_bwd(*args, out, gout, cfg, SC)
        assert rs.composite_surfels.bwd_launches == n0 + 2
        dp = rs.composite_surfels_bwd_plain(*args, out, gout, cfg, SC,
                                            tile_chunk=256)
    assert torch.equal(dk, dk2)
    rel = [float((dk[r] - dp[r]).abs().max() / dp[r].abs().max())
           for r in range(rs.SURFEL_ROWS)]
    print("S2 against its plain version, by row:", rel)
    assert all(float(dp[r].abs().max()) > 0 for r in range(rs.SURFEL_ROWS))
    assert max(rel) <= S2_TOL, rel


@pytest.mark.parametrize("scene", ["200k", "garden3m"])
def test_a_surfel_train_step_launches_s1_and_s2_once(cuda, scene):
    """Two steps over the scene's two poses, one view a batch, through
    ``make_train_step`` on a surfel pool perturbed from the scene whose
    frames are the ground truth."""
    from gsplat_tpu_torch.ops.update import adam_update

    p, poses, cam, cfg = _scene(cuda, scene)
    g = torch.Generator(device=cuda).manual_seed(25)
    with torch.no_grad():
        batches = []
        for c2w in poses:
            img, _ = render_from_params(p, c2w, *cam, cfg)
            batches.append({
                "image": img[None], "c2w": torch.from_numpy(c2w[None]).to(cuda),
                **{k: torch.full((1,), v, device=cuda)
                   for k, v in zip(("fx", "fy", "cx", "cy"), cam)}})
        for k in ("f_dc", "opacity_raw"):
            p[k] += 0.1 * torch.randn(p[k].shape, generator=g, device=cuda)
    n = p["pos"].shape[0]
    pool = GaussianPool(p, torch.ones(n, dtype=torch.bool, device=cuda))
    tcfg = TrainConfig(capacity=n, batch_size=1)
    st = ttr.init_train_state(pool, tcfg, surfel=SC)
    step = ttr.make_train_step(cfg, tcfg)
    counters = ((rs.composite_surfels, "launches"),
                (rs.composite_surfels, "bwd_launches"),
                (rc.composite_pairs, "launches"),
                (rc.composite_pairs, "bwd_launches"),
                (adam_update, "launches"))
    for obj, name in counters:
        setattr(obj, name, 0)
    losses = []
    for batch in batches:
        st, m = step(st, batch)
        assert int(m["nonfinite_skipped"]) == 0
        losses.append(float(m["total"]))
        assert float(m["dist"]) >= 0 and 0 <= float(m["normal"]) <= 2
    torch.cuda.synchronize()
    views = len(batches)
    assert [getattr(obj, name) for obj, name in counters] \
        == [views, views, 0, 0, 2 * views]
    assert all(np.isfinite(losses))
    res = rs.surfel_resources(cuda)
    assert res["S1"]["local_bytes"] == 0 and res["S2"]["local_bytes"] == 0
