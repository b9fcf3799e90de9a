"""The port on a CUDA card: the Hopper compositors against their plain
versions, and a train step on the card against the same step on the CPU.

Needs a card; every test here skips without one. It imports neither JAX
nor the suite's conftest (the GPU machine has no JAX), so run it with

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu

Tolerances: kernel vs plain compositor on the same inputs, rows 0-4 within
2e-5 abs and row 5 exact (the kernel is built with -fmad=false and keeps
the plain version's order of operations). A whole render on the card vs
the same render on the CPU: 1e-4 abs with equal pair counts, because the
projection runs on each device's own math library (a float one ulp apart
can move one (pair, pixel) across the alpha cutoff).

The backward kernel vs its plain version: rows 0-9 within 1e-5 of each
row's max abs (only the order of the pixel sums differs), exact zeros
outside the blocks the forward composited, and two runs bit-identical (no
float atomics). A train step on the card vs on the CPU: gradients within
5e-4 of each leaf's largest, the render's own gradient tolerance.
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
        return gather_pair_features(feat, b.pair_slot, b.gauss_offsets), b


def _active_slots(b, fwd_out, cfg):
    """[padded_pairs] bool: slots of the blocks the forward composited."""
    G = cfg.pair_block
    meta = b.block_meta.long()
    tile = meta >> tras.META_SHIFT
    rank = torch.arange(meta.shape[0], device=meta.device) \
        - b.tile_start.long()[tile] // G
    active = ((meta & tras.META_DEAD) == 0) & (rank >= 0) \
        & (rank < fwd_out[tile, 5, 0].long())
    return active.repeat_interleave(G)


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


@pytest.mark.parametrize("pair_block", [32, 128, 256])
@pytest.mark.parametrize("kind", ["plain", "saturated"])
def test_backward_kernel_matches_plain(cuda, kind, pair_block):
    shift = dict(opacity_shift=6.0, scale_shift=1.0) if kind == "saturated" \
        else {}
    params, c2w = _scene(600, 0, **shift)
    cfg = gt.RenderConfig(**CFG, pair_block=pair_block)
    pf, b = _inputs(params, c2w, cfg, cuda)
    args = (pf, b.tile_start, b.tile_count)
    fwd = tras.composite_pairs(*args, cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    gout = torch.randn(cfg.num_tiles, 8, cfg.tile**2, generator=gen,
                       device=cuda)
    before = tras.composite_pairs.bwd_launches
    got = tras.composite_pairs_bwd(*args, fwd, gout, cfg)
    assert tras.composite_pairs.bwd_launches == before + 1
    want = tras.composite_pairs_bwd_plain(*args, fwd, gout, cfg)
    again = tras.composite_pairs_bwd(*args, fwd, gout, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, again), "two runs differ"
    for r in range(10):
        scale = float(want[r].abs().max())
        assert float((got[r] - want[r]).abs().max()) <= 1e-5 * scale, r
    off = ~_active_slots(b, fwd, cfg)
    assert off.any() and (got[:, off] == 0).all()
    if kind == "saturated":
        nblk = (b.tile_count + pair_block - 1) // pair_block
        assert (fwd[:, 5, 0] < nblk).any(), "no tile was skipped"


def test_kernel_runs_backward_for_grad_and_refuses_other_tiles(cuda):
    params, c2w = _scene(600, 3)
    cfg = gt.RenderConfig(**CFG)
    pf, b = _inputs(params, c2w, cfg, cuda)
    pf = pf.clone().requires_grad_(True)
    k1, k2 = tras.composite_pairs.launches, tras.composite_pairs.bwd_launches
    out = tras.composite_pairs(pf, b.tile_start, b.tile_count, cfg)
    gout = torch.ones_like(out)
    out.backward(gout)
    assert tras.composite_pairs.launches == k1 + 1
    assert tras.composite_pairs.bwd_launches == k2 + 1
    want = tras.composite_pairs_bwd_plain(pf.detach(), b.tile_start,
                                          b.tile_count, out.detach(), gout,
                                          cfg)
    for r in range(10):
        scale = float(want[r].abs().max())
        assert float((pf.grad[r] - want[r]).abs().max()) <= 1e-5 * scale
    cfg8 = cfg.with_(tile=8)
    ts8 = torch.zeros(cfg8.num_tiles, dtype=torch.int32, device=cuda)
    pf8 = torch.zeros(10, cfg8.padded_pairs, device=cuda)
    with pytest.raises(ValueError, match="tile=16"):
        tras.composite_pairs(pf8, ts8, ts8, cfg8)
    fo8 = torch.zeros(cfg8.num_tiles, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="tile=16"):
        tras.composite_pairs_bwd(pf8, ts8, ts8, fo8, fo8, cfg8)
    ts = torch.zeros(cfg.num_tiles, dtype=torch.int32, device=cuda)
    empty = torch.zeros(10, cfg.padded_pairs, device=cuda)
    out = tras.composite_pairs(empty, ts, ts, cfg)  # nothing to draw
    d = tras.composite_pairs_bwd(empty, ts, ts, out, torch.ones_like(out),
                                 cfg)
    torch.cuda.synchronize()
    assert (out[:, 4] == 1).all() and (out[:, [0, 1, 2, 3, 5]] == 0).all()
    assert (d == 0).all()


def test_train_step_on_card_matches_cpu(cuda):
    params, c2w = _scene(600, 3)
    n = 640  # 40 dead slots
    params = {k: np.concatenate([v, np.zeros((n - 600,) + v.shape[1:],
                                             np.float32)])
              for k, v in params.items()}
    alive = np.arange(n) < 600
    cfg = gt.RenderConfig(**CFG)
    tcfg = gt.TrainConfig(capacity=n, batch_size=2)
    poses = np.stack([c2w, c2w])
    poses[1, 0, 3] = 0.2
    target = {k: torch.from_numpy(v) for k, v in params.items()}
    target["f_dc"] = target["f_dc"] + 0.5
    with torch.no_grad():  # one ground truth for both devices
        imgs = torch.stack([gt.render_from_params(
            target, p, *CAM.values(), cfg, alive=torch.from_numpy(alive))[0]
            for p in poses])
    grads = {}
    for dev in ("cpu", cuda):
        pool = gt.pool_from_numpy(params, alive, device=dev)
        batch = {"image": imgs.to(dev), "c2w": torch.from_numpy(poses).to(dev)}
        batch.update({k: torch.full((2,), v, device=dev)
                      for k, v in CAM.items()})
        state = gt.init_train_state(pool, tcfg)
        _, m = gt.make_train_step(cfg, tcfg)(state, batch)
        assert int(m["nonfinite_skipped"]) == 0
        grads[str(dev)[:4]] = {k: p.grad.cpu() for k, p in
                               pool.params.items()}
    for k, want in grads["cpu"].items():
        got = grads["cuda"][k]
        scale = float(want.abs().max())
        assert scale > 0 and torch.isfinite(got).all(), k
        assert float((got - want).abs().max()) <= 5e-4 * scale, k


def test_render_gradients_are_bit_identical_across_runs(cuda):
    """K2 has no float atomics and the gather backward scans in a fixed
    order, so a whole fwd+bwd repeats bit for bit."""
    params, c2w = _scene(600, 0)
    cfg = gt.RenderConfig(**CFG)
    grads = []
    for _ in range(2):
        t = {k: torch.from_numpy(v).to(cuda).requires_grad_(True)
             for k, v in params.items()}
        img, _ = gt.render_from_params(t, c2w, *CAM.values(), cfg)
        (img.mean() + (img * img).mean()).backward()
        grads.append({k: v.grad for k, v in t.items()})
    for k in params:
        assert torch.equal(grads[0][k], grads[1][k]), k
