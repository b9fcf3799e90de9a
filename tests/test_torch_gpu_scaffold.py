"""Scaffold-GS's decode kernels D1 and D2 (``ops/csrc/scaffold.cu``) on a
CUDA card against the plain decode, and an anchor pool through the
training step and the viewer.

Needs a card; every test here skips without one. It imports neither JAX
nor the suite's conftest (the GPU machine has no JAX), so run it with

    python -m pytest --noconftest tests/test_torch_gpu_scaffold.py -m gpu

The scene is ``scene.make_anchor_scene`` at the benchmark cell's 650,000
anchors with MLPs of ``models.gaussians.init_anchor_mlps``, seen at
1297x840 from the origin camera of the garden layout.

* D1 against ``decode_plain`` on the card (its products through the
  matrix library, TF32 off): the kept masks agree except where the
  opacity is within 1e-6 of 0, and each field of the kept slots within
  ``D1_TOL`` of the field's largest magnitude. D1 sums the products of
  length 35 and 32 in another order than the library, in float32 with
  fused multiply-adds; the terms are of order 1, so the sums differ in
  their last bits, and tanh, sigmoid and the normalisation carry that
  over unchanged.
* D2 against autograd through ``decode_plain`` from the same slot
  gradients (zero on masked slots, which D2 does not read): the anchors'
  gradients within ``D2_ANCHOR_TOL`` of each leaf's largest (sums of up to
  3 x 32 terms, as D1's), the three MLPs' within ``D2_WEIGHT_TOL`` of each
  MLP's largest (sums over every visible anchor, some 10^5, in another
  order), and D2's MLP gradients identical over two runs: the partial
  sums are per CTA and added in CTA order.
* An anchor whose every slot is masked, and an invisible one, take
  exactly zero gradient in every leaf; a network whose opacity head never
  keeps a slot gives zero to every weight.
* ``make_train_step`` on an anchor pool launches D1 and D2 once a view,
  K1 and K2 once, U1 and U2 once each a step, with finite losses and no
  step skipped; ``viewer.make_render_fn`` serves it through D1 and K1's
  table read; D1 and D2 report their registers and no spills in
  ``ptxas.log``.
"""

import re

import pytest
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch.config import MLP_KEYS, RenderConfig, TrainConfig
from gsplat_tpu_torch.models.gaussians import GaussianPool, init_anchor_mlps
from gsplat_tpu_torch.ops import raster_cuda as rc
from gsplat_tpu_torch.ops import scaffold as sf
from gsplat_tpu_torch.ops.update import adam_update
from gsplat_tpu_torch.render import pair_demand
from gsplat_tpu_torch.scene import make_anchor_scene
from gsplat_tpu_torch.train import trainer as ttr
from gsplat_tpu_torch.viewer import make_render_fn

pytestmark = pytest.mark.gpu

ANCHORS = 650_000
H, W = 840, 1297
F = 0.85 * W
INTR = (F, F, W / 2, H / 2)
D1_TOL = 1e-5
D2_ANCHOR_TOL = 1e-4
D2_WEIGHT_TOL = 1e-3
FIELDS = ("mu", "s", "q", "alpha", "color")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return gt.resolve_device("cuda")


def _params(dev, n=ANCHORS, seed=0):
    return {**make_anchor_scene(n, seed, dev),
            **init_anchor_mlps(seed=seed + 7, device=dev)}


def _cfg(params, dev, pairs=None):
    cfg = RenderConfig(height=H, width=W, max_pairs=4096)
    c2w = torch.eye(4, device=dev)
    with torch.no_grad():
        dem = int(pair_demand(params, c2w, *INTR, cfg)[0])
    return cfg.with_(max_pairs=pairs or max(4096, int(dem * 1.3))), c2w


def _visible(params, cfg, c2w):
    return sf.anchor_visible(params, c2w, *INTR, cfg)


def _gap(a, b):
    top = float(b.abs().max())
    d = float((a - b).abs().max())
    return d / top if top > 0 else d


def test_d1_matches_the_plain_decode(cuda):
    params = _params(cuda)
    cfg, c2w = _cfg(params, cuda)
    vis = _visible(params, cfg, c2w)
    cam = c2w[:3, 3].contiguous()
    with torch.no_grad():
        got = sf.decode_cuda(params, vis, cam)
        ref = sf.decode_plain(params, vis, cam)
    assert int(vis.sum()) > 100_000
    keep, rkeep = got[5], ref[5]
    differ = keep != rkeep
    assert bool((ref[3][differ].abs() < 1e-6).all())
    both = keep & rkeep
    assert int(both.sum()) > 500_000
    for name, a, b in zip(FIELDS, got[:5], ref[:5]):
        assert _gap(a[both], b[both]) <= D1_TOL, name
    # An invisible anchor's slots are zero and not kept.
    off = ~vis.repeat(10)
    assert not bool(keep[off].any())
    assert all(bool((t[off] == 0).all()) for t in got[:5])


def _grads(params, vis, cam, up, cuda_path):
    leaves = {k: (v.detach().clone().requires_grad_(k != "pos"))
              for k, v in params.items()}
    fn = sf.decode if cuda_path else sf.decode_plain
    out = fn(leaves, vis, cam)
    keep = out[5]
    loss = sum(torch.sum(o * torch.where(
        keep.reshape((-1,) + (1,) * (o.dim() - 1)), u, 0.0))
        for o, u in zip(out[:5], up))
    loss.backward()
    return {k: v.grad for k, v in leaves.items() if k != "pos"}, keep


def test_d2_matches_autograd_through_the_plain_decode(cuda):
    params = _params(cuda)
    cfg, c2w = _cfg(params, cuda)
    vis = _visible(params, cfg, c2w)
    cam = c2w[:3, 3].contiguous()
    S = ANCHORS * 10
    g = torch.Generator(device=cuda).manual_seed(3)
    up = [torch.randn(S, w, generator=g, device=cuda) if w else
          torch.randn(S, generator=g, device=cuda) for w in (3, 3, 4, 0, 3)]
    n0 = sf.decode_bwd_cuda.launches
    got, keep = _grads(params, vis, cam, up, True)
    assert sf.decode_bwd_cuda.launches == n0 + 1
    ref, rkeep = _grads(params, vis, cam, up, False)
    assert int((keep != rkeep).sum()) <= 10
    for k in ("offset", "anchor_feat", "scale_raw"):
        assert _gap(got[k], ref[k]) <= D2_ANCHOR_TOL, k
    for k in MLP_KEYS:
        assert _gap(got[k], ref[k]) <= D2_WEIGHT_TOL, k
    again, _ = _grads(params, vis, cam, up, True)
    for k in got:
        assert torch.equal(got[k], again[k]), k


def test_masked_anchors_take_zero_gradient(cuda):
    params = _params(cuda, n=4096, seed=2)
    cfg, c2w = _cfg(params, cuda)
    with torch.no_grad():
        params["pos"][5] = torch.tensor([0.0, 0.0, -3.0], device=cuda)
    vis = _visible(params, cfg, c2w)
    assert not bool(vis[5]) and int(vis.sum()) > 100
    cam = c2w[:3, 3].contiguous()
    S = 4096 * 10
    up = [torch.ones(S, w, device=cuda) if w else torch.ones(S, device=cuda)
          for w in (3, 3, 4, 0, 3)]
    got, keep = _grads(params, vis, cam, up, True)
    # Anchors whose every slot is masked: invisible, or tanh(.) <= 0.
    dead = ~keep.reshape(10, 4096).any(dim=0)
    assert bool(dead[5])
    for k in ("offset", "anchor_feat", "scale_raw"):
        assert bool((got[k][dead] == 0).all()), k
        assert bool((got[k][~dead] != 0).any()), k
    # An opacity head that keeps no slot: every gradient is zero.
    params = dict(params)
    w_op = params["mlp_opacity"].clone()
    w_op[-10:] = -5.0
    w_op[1120 + 32:1120 + 32 + 320] = 0.0
    params["mlp_opacity"] = w_op
    got, keep = _grads(params, vis, cam, up, True)
    assert not bool(keep.any())
    for k, v in got.items():
        assert bool((v == 0).all()), k


def test_train_step_and_serving_launch_d1_and_d2(cuda):
    params = _params(cuda, n=200_000, seed=4)
    mlps = {k: params.pop(k) for k in MLP_KEYS}
    cfg, c2w = _cfg({**params, **mlps}, cuda)
    pool = GaussianPool(params, torch.ones(200_000, dtype=torch.bool,
                                           device=cuda))
    tcfg = TrainConfig(capacity=200_000)
    state = ttr.init_train_state(pool, tcfg, decoder=mlps)
    step = ttr.make_train_step(cfg, tcfg)
    with torch.no_grad():
        img, _ = gt.render_from_params({**pool.params, **mlps}, c2w, *INTR,
                                       cfg)
    batch = {"image": (0.8 * img)[None], "c2w": c2w[None],
             **{k: torch.full((1,), x, device=cuda)
                for k, x in zip(("fx", "fy", "cx", "cy"), INTR)}}
    counts = [sf.decode_cuda, sf.decode_bwd_cuda, adam_update]
    before = [f.launches for f in counts] + [
        rc.composite_pairs.launches, rc.composite_pairs.bwd_launches]
    losses, skipped = [], []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(m["total"])
        skipped.append(m["nonfinite_skipped"])
    after = [f.launches for f in counts] + [
        rc.composite_pairs.launches, rc.composite_pairs.bwd_launches]
    assert [a - b for a, b in zip(after, before)] == [2, 2, 4, 2, 2]
    assert all(bool(torch.isfinite(x)) for x in losses)
    assert not any(int(x) for x in skipped)
    assert int(state.step) == 2
    fn = make_render_fn({**state.pool.params, **state.decoder}, cfg, *INTR)
    n1 = sf.decode_cuda.launches
    n_idx = rc.composite_pairs.indexed_launches
    frame = fn(c2w.cpu().numpy())
    assert sf.decode_cuda.launches == n1 + 1
    assert rc.composite_pairs.indexed_launches == n_idx + 1
    assert bool(torch.isfinite(frame).all())


def _entry(ptxas: str, kernel: str):
    """(registers, spill store bytes) of the kernel whose mangled name
    holds ``kernel`` in nvcc's -v report."""
    part = ptxas.split(f"Compiling entry function '")
    for p in part[1:]:
        if kernel in p.split("'")[0]:
            regs = int(re.search(r"Used (\d+) registers", p).group(1))
            spills = int(re.search(r"(\d+) bytes spill stores", p).group(1))
            return regs, spills
    raise AssertionError(f"no {kernel} in ptxas.log")


def test_d1_and_d2_report_registers_and_no_spills(cuda, capsys):
    from gsplat_tpu_torch.ops import _build

    ptxas = _build.build(("scaffold",))["scaffold"]["ptxas"]
    got = {k: _entry(ptxas, k) for k in ("scaffold_d1_kernel",
                                          "scaffold_d2_kernel")}
    with capsys.disabled():
        print(f"\nD1/D2 (registers, spill stores): {got}")
    assert all(spills == 0 for _, spills in got.values()), got
