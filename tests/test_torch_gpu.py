"""The port on a CUDA card: the Hopper compositor against its plain version.

Needs a card; every test here skips without one. It imports neither JAX
nor the suite's conftest (the GPU machine has no JAX), so run it with

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu

Tolerances: kernel vs plain compositor on the same inputs, rows 0-4 within
2e-5 abs and row 5 exact (the kernel is built with -fmad=false and keeps
the plain version's order of operations). A whole render on the card vs
the same render on the CPU: 1e-4 abs with equal pair counts, because the
projection runs on each device's own math library (a float one ulp apart
can move one (pair, pixel) across the alpha cutoff).
"""

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch.ops import raster_cuda as tras
from gsplat_tpu_torch.ops.binning import bin_gaussians
from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
from gsplat_tpu_torch.ops.projection import project_gaussians
from gsplat_tpu_torch.ops.rasterize import _pair_features, gather_pair_features
from gsplat_tpu_torch.ops.sh import evaluate_sh

pytestmark = pytest.mark.gpu

CFG = dict(height=128, width=192, max_pairs=2**15)
CAM = dict(fx=160.0, fy=158.0, cx=96.5, cy=63.5)
TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return gt.resolve_device("cuda")


def _scene(n, seed, opacity_shift=0.0, scale_shift=0.0):
    r = np.random.default_rng(1234 + seed)
    p = {"pos": np.stack([r.uniform(-2, 2, n), r.uniform(-2, 2, n),
                          r.uniform(3, 8, n)], -1).astype(np.float32)}
    p["scale_raw"] = (r.normal(0, 0.3, (n, 3)) - 2.0 + scale_shift).astype(
        np.float32)
    p["q_raw"] = r.normal(0, 1.0, (n, 4)).astype(np.float32)
    p["q_raw"][:, 3] += 2.0
    p["opacity_raw"] = (r.normal(0.5, 1.0, n) + opacity_shift).astype(
        np.float32)
    p["f_dc"] = r.normal(0, 0.8, (n, 3)).astype(np.float32)
    p["f_rest"] = r.normal(0, 0.05, (n, 45)).astype(np.float32)
    return p, np.eye(4, dtype=np.float32)


def _inputs(params, c2w, cfg, dev):
    t = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
    c2w = torch.from_numpy(c2w).to(dev)
    with torch.no_grad():
        cov = build_cov3d_packed(t["scale_raw"], t["q_raw"])
        colors = evaluate_sh(t["f_dc"], t["f_rest"], t["pos"], c2w)
        proj = project_gaussians(t["pos"], cov, t["opacity_raw"], c2w,
                                 *CAM.values(), cfg)
        b = bin_gaussians(proj, cfg)
        feat = _pair_features(proj, colors, torch.float32)[b.depth_order.long()]
        return gather_pair_features(feat, b.pair_slot), b


@pytest.mark.parametrize("pair_block", [32, 128, 256])
@pytest.mark.parametrize("kind", ["plain", "saturated"])
def test_kernel_matches_plain(cuda, kind, pair_block):
    shift = dict(opacity_shift=6.0, scale_shift=1.0) if kind == "saturated" \
        else {}
    params, c2w = _scene(600, 0, **shift)
    cfg = gt.RenderConfig(**CFG, pair_block=pair_block)
    pf, b = _inputs(params, c2w, cfg, cuda)
    before = tras.composite_pairs.launches
    got = tras.composite_pairs(pf, b.tile_start, b.tile_count, cfg)
    assert tras.composite_pairs.launches == before + 1
    want = tras.composite_pairs_plain(pf, b.tile_start, b.tile_count, cfg)
    torch.cuda.synchronize()
    assert float((got[:, :5] - want[:, :5]).abs().max()) <= TOL
    assert torch.equal(got[:, 5], want[:, 5])
    assert (got[:, 6:] == 0).all()
    if kind == "saturated":
        nblk = (b.tile_count + pair_block - 1) // pair_block
        assert (got[:, 5, 0] < nblk).any(), "no tile was skipped"


def test_render_on_card_matches_cpu(cuda):
    params, c2w = _scene(600, 3)
    cfg = gt.RenderConfig(**CFG)
    out = {}
    for dev in ("cpu", cuda):
        t = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
        with torch.no_grad():
            out[str(dev)[:4]] = gt.render_from_params(t, c2w, *CAM.values(),
                                                      cfg)
    (img_c, aux_c), (img_g, aux_g) = out["cpu"], out["cuda"]
    assert int(aux_c.num_pairs) == int(aux_g.num_pairs)
    assert float((img_g.cpu() - img_c).abs().max()) <= 1e-4
    assert float((aux_g.alpha.cpu() - aux_c.alpha).abs().max()) <= 1e-4


def test_kernel_refuses_grad_and_other_tiles(cuda):
    cfg = gt.RenderConfig(**CFG)
    nt = cfg.num_tiles
    pf = torch.zeros(10, cfg.padded_pairs, device=cuda, requires_grad=True)
    ts = torch.zeros(nt, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="backward"):
        tras.composite_pairs(pf, ts, ts, cfg)
    cfg8 = cfg.with_(tile=8)
    ts8 = torch.zeros(cfg8.num_tiles, dtype=torch.int32, device=cuda)
    pf8 = torch.zeros(10, cfg8.padded_pairs, device=cuda)
    with pytest.raises(ValueError, match="tile=16"):
        tras.composite_pairs(pf8, ts8, ts8, cfg8)
    out = tras.composite_pairs(pf.detach(), ts, ts, cfg)  # nothing to draw
    torch.cuda.synchronize()
    assert (out[:, 4] == 1).all() and (out[:, [0, 1, 2, 3, 5]] == 0).all()
