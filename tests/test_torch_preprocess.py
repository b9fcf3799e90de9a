"""The per-gaussian stages' dispatch (``ops/preprocess.py``) on the CPU.

CPU tensors, and tensors autograd records, take the plain chain, which
gives what the three stage functions composed give (the path before P1)
bit for bit, forward and backward. P1's wrapper checks every input and
raises before any launch. Its argument pack carries every
``RenderConfig`` field ``project_gaussians`` reads, folded as the plain
chain folds it, so a field the projection comes to read cannot be left
out of the kernel unseen. P1 itself runs on the card only
(``tests/test_torch_gpu_preprocess.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch import scene
from gsplat_tpu_torch.ops import preprocess as P
from gsplat_tpu_torch.ops.gaussian import build_cov3d_packed
from gsplat_tpu_torch.ops.projection import project_gaussians
from gsplat_tpu_torch.ops.rasterize import rasterize
from gsplat_tpu_torch.ops.sh import evaluate_sh

H, W = 32, 48
FX, FY, CX, CY = 40.0, 41.0, 24.5, 16.25
FIELDS = ("uv", "depth", "conic", "opacity", "radius", "tile_min",
          "tile_max", "valid")


@pytest.fixture(scope="module")
def small():
    params = scene.make_scene(600, seed=2, device="cpu")
    alive = torch.ones(600, dtype=torch.bool)
    alive[::7] = False
    cfg = gt.RenderConfig(height=H, width=W, max_pairs=8192)
    c2w = torch.eye(4)
    c2w[:3, 3] = torch.tensor([0.2, -0.1, -0.3])
    return params, alive, cfg, c2w


def _chain(params, c2w, cfg, alive, colour=True):
    """The three stage functions composed, as the entry points called them
    before P1."""
    cov3d = build_cov3d_packed(params["scale_raw"], params["q_raw"])
    colours = (evaluate_sh(params["f_dc"], params["f_rest"], params["pos"],
                           c2w) if colour else None)
    proj = project_gaussians(params["pos"], cov3d, params["opacity_raw"], c2w,
                             FX, FY, CX, CY, cfg, extra_valid=alive)
    return proj, colours, cov3d


@pytest.mark.parametrize("colour", [True, False])
def test_cpu_tensors_take_the_plain_chain(small, colour):
    params, alive, cfg, c2w = small
    assert not P.kernel_applies(params, c2w, (FX, FY, CX, CY), None, colour)
    n0 = P.preprocess_cuda.launches
    with torch.no_grad():
        got = P.preprocess(params, c2w, FX, FY, CX, CY, cfg, alive=alive,
                           colour=colour)
        want = _chain(params, c2w, cfg, alive, colour)
    assert P.preprocess_cuda.launches == n0
    for f in FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert (got[1] is None) == (not colour)
    if colour:
        assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])  # the plain chain's covariance
    # a given covariance is used, not rebuilt
    again = P.preprocess(params, c2w, FX, FY, CX, CY, cfg, alive=alive,
                         colour=colour, cov3d=got[2])
    assert again[2] is got[2]


def test_recorded_autograd_takes_the_plain_chain(small):
    """``render_from_params`` under autograd: the image and every leaf's
    gradient equal the parent's path (the three stages composed) bit for
    bit."""
    params, alive, cfg, c2w = small
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    twin = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    img, _ = gt.render_from_params(leaves, c2w, FX, FY, CX, CY, cfg,
                                   alive=alive)
    proj, colours, _ = _chain(twin, c2w, cfg, alive)
    ref, _ = rasterize(proj, colours, cfg)
    assert torch.equal(img, ref)
    w = torch.rand(img.shape, generator=torch.Generator().manual_seed(4))
    (img * w).sum().backward()
    (ref * w).sum().backward()
    for k in params:
        assert torch.equal(leaves[k].grad, twin[k].grad), k


def test_the_rule_reads_autograd_recording():
    a = torch.zeros(3, requires_grad=True)
    b = torch.zeros(3)
    assert P._recorded([b, a])
    assert not P._recorded([b])
    with torch.no_grad():
        assert not P._recorded([b, a])


class _OnCard:
    """What the dispatch reads of a leaf on a card: its device and whether
    it requires grad; dtype, shape and layout are not there to read."""

    device = torch.device("cuda")

    def __init__(self, requires_grad=False):
        self.requires_grad = requires_grad


def test_the_rule_reads_the_device_the_tap_and_recording_only(small):
    """A leaf on a card goes to P1 whatever its dtype, shape or layout (P1's
    wrapper refuses what it cannot take), unless there is a ``uv_tap`` or
    autograd records the leaves, the pose or a tensor intrinsic."""
    params, _, _, c2w = small
    card = {k: _OnCard() for k in params}
    intr = (FX, FY, CX, CY)
    assert P.kernel_applies(card, c2w, intr, None, True)
    assert not P.kernel_applies(card, c2w, intr, torch.zeros(600, 2), True)
    grad = torch.tensor(CX, requires_grad=True)
    assert not P.kernel_applies(card, c2w, (FX, FY, grad, CY), None, True)
    assert not P.kernel_applies(dict(card, q_raw=_OnCard(True)), c2w, intr,
                                None, True)
    # the colourless variant reads no colour leaf
    assert P.kernel_applies(dict(card, f_rest=_OnCard(True)), c2w, intr,
                            None, False)
    with torch.no_grad():
        assert P.kernel_applies(dict(card, q_raw=_OnCard(True)), c2w,
                                (FX, FY, grad, CY), None, True)


def _offset(t):
    """``t``'s values in a view 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _bad_inputs(params):
    """(the leaf at fault, the leaves), one fault each."""
    yield "q_raw", dict(params, q_raw=params["q_raw"].double())
    yield "scale_raw", dict(params, scale_raw=params["scale_raw"][:, :2])
    yield "opacity_raw", dict(params, opacity_raw=params["opacity_raw"][:-1])
    yield "pos", dict(params, pos=params["pos"].t().contiguous().t())
    yield "f_rest", dict(params, f_rest=params["f_rest"][:, :44])
    for k in P._WIDE:  # 16-byte alignment
        yield k, dict(params, **{k: _offset(params[k])})


def test_the_wrapper_raises_before_any_launch(small):
    params, alive, cfg, c2w = small
    n0 = P.preprocess_cuda.launches
    for what, p in _bad_inputs(params):
        with pytest.raises(ValueError, match=what):
            P.preprocess_cuda(p, c2w, FX, FY, CX, CY, cfg, alive)
    with pytest.raises(ValueError, match="alive"):
        P.preprocess_cuda(params, c2w, FX, FY, CX, CY, cfg, alive.int())
    with pytest.raises(ValueError, match="c2w"):
        P.preprocess_cuda(params, c2w.double(), FX, FY, CX, CY, cfg, alive)
    with pytest.raises(ValueError, match="cx"):
        P.preprocess_cuda(params, c2w, FX, FY, np.float32(CX), CY, cfg,
                          alive)
    # well-formed CPU inputs: refused for the device, last
    with pytest.raises(ValueError, match="CUDA"):
        P.preprocess_cuda(params, c2w, FX, FY, CX, CY, cfg, alive)
    assert P.preprocess_cuda.launches == n0


class _Recorder:
    """A RenderConfig that notes every field read."""

    def __init__(self, cfg):
        self._cfg, self.read = cfg, set()

    def __getattr__(self, name):
        self.read.add(name)
        return getattr(self._cfg, name)


def test_the_projection_reads_only_packed_fields(small):
    params, alive, _, c2w = small
    read = set()
    for aa in ("none", "dilate", "mip"):
        for guard_v in (None, 40.0):
            rec = _Recorder(gt.RenderConfig(height=H, width=W, aa_mode=aa,
                                            pix_guard_v=guard_v))
            with torch.no_grad():
                _chain(params, c2w, rec, alive)
            read |= rec.read
    assert read == set(P.PACKED_FIELDS)


def _pack(params, c2w, cfg, intr=(FX, FY, CX, CY), colour=True):
    n = params["pos"].shape[0]
    outs = {"uv": torch.empty(n, 2), "depth": torch.empty(n),
            "conic": torch.empty(n, 3), "opacity": torch.empty(n),
            "radius": torch.empty(n, dtype=torch.int32),
            "tile_min": torch.empty(n, 2, dtype=torch.int32),
            "tile_max": torch.empty(n, 2, dtype=torch.int32),
            "valid": torch.empty(n, dtype=torch.bool),
            "rgb": torch.empty(n, 3) if colour else None}
    return P.pack_args(params, c2w, intr, cfg, None, outs), outs


CHANGED = {"height": 64, "width": 80, "tile": 32, "near": 0.2, "far": 50.0,
           "pix_guard": 20.0, "pix_guard_v": 40.0, "alpha_cutoff": 0.02,
           "chi2_clip": 9.0, "min_conic": 1e-4, "aa_mode": "mip",
           "aa_dilation": 0.5}


def test_the_argument_pack_carries_every_field(small):
    params, _, _, c2w = small
    assert set(CHANGED) == set(P.PACKED_FIELDS)
    cfg = gt.RenderConfig(height=H, width=W)
    base = bytes(_pack(params, c2w, cfg)[0])
    for name, value in CHANGED.items():
        assert getattr(cfg, name) != value
        changed = bytes(_pack(params, c2w, dataclasses.replace(
            cfg, **{name: value}))[0])
        assert changed != base, name
    with pytest.raises(ValueError, match="aa_mode"):
        _pack(params, c2w, cfg.with_(aa_mode="box"))


def test_the_argument_pack_folds_as_the_plain_chain(small):
    params, _, _, c2w = small
    cfg = gt.RenderConfig(height=H, width=W, pix_guard=32.0,
                          pix_guard_v=12.5, alpha_cutoff=0.3)
    f32 = np.float32
    a, outs = _pack(params, c2w, cfg)
    assert a.u_lo == f32(-32.0 - CX) and a.u_hi == f32(W + 32.0 - CX)
    assert a.v_lo == f32(-12.5 - CY) and a.v_hi == f32(H + 12.5 - CY)
    assert a.half_cutoff == f32(0.3 * 0.5)
    assert a.inv_cutoff == f32(1.0) / f32(0.3)
    assert list(a.intr) == [f32(x) for x in (FX, FY, CX, CY)]
    assert list(a.intr_ptr) == [None] * 4
    assert a.n == 600 and a.rgb == outs["rgb"].data_ptr()
    # intrinsics on the device: by address, the guard's cx left to the
    # kernel
    intr = tuple(torch.tensor(x) for x in (FX, FY, CX, CY))
    a, _ = _pack(params, c2w, cfg, intr=intr, colour=False)
    assert list(a.intr_ptr) == [t.data_ptr() for t in intr]
    assert a.u_lo == f32(-32.0) and a.u_hi == f32(W + 32.0)
    assert a.v_lo == f32(-12.5) and a.v_hi == f32(H + 12.5)
    assert a.rgb is None and a.f_dc is None and a.f_rest is None
