"""Port parity: log-space transmittance (``transmittance_math="log"``).

The port's plain compositors in the log form (``raster_cuda.
_block_transmittance``: ``s = log1p(-alpha)``, its running sum S within a
block, ``T_excl = exp(S - s) * T_in``, ``T_out = T_in * exp(S_total)``)
are held against the JAX package's Pallas kernels in the same mode (run in
interpret mode on the CPU, as tests/test_pallas_kernel.py runs them), on
the same pair features, layout and seeded cotangent, carried across as
numpy; then whole renders and their gradients.

Tolerances: the forward's rows 0-4 within 2e-5 abs on occupied tiles and
row 5 exact, the images within 2e-5 (the JAX kernel sums S with a
triangular matmul and the port in order, a few ulp apart); gradients
within 5e-4 of each leaf's (or row's) max abs, the JAX package's own
gradient tolerance (tests/test_pallas_kernel.py:80). The port's log image
against its own cumprod image within 2e-6, and their gradients within
1e-4 relative: the JAX package's gate between its two modes
(tests/test_pallas_kernel.py:301).

The CUDA kernels run only on a card: tests/test_torch_gpu.py holds them
against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_scene

import gsplat_tpu as gj
import gsplat_tpu.config as jconfig
import gsplat_tpu_torch as gt
import gsplat_tpu_torch.config as tconfig
from gsplat_tpu.ops import raster_pallas as jras
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
from gsplat_tpu_torch.ops import raster_cuda as tras
from test_torch_raster import CFG, TOL, _check_against_jax, _jax_pairs
from test_torch_raster import _saturated_scene

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

LOG = dict(CFG, transmittance_math="log")
CAM = dict(fx=60.0, fy=58.0, cx=32.5, cy=31.5)
KEYS = ("pos", "scale_raw", "q_raw", "opacity_raw", "f_dc", "f_rest", "c2w")
GRAD_TOL = 5e-4


def _scene(kind):
    if kind == "saturated":
        return _saturated_scene()
    return make_scene(None, n=192, seed_offset=int(kind[-1]))


@jax.jit
def _jax_fwd_bwd(pair_feat, block_meta, gout):
    cfg = jconfig.RenderConfig(**LOG)
    out = jras._fwd_pallas(pair_feat, block_meta, cfg)
    return out, jras._bwd_pallas(pair_feat, block_meta, out, gout, cfg)


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("kind", ["seed0", "saturated"])
def test_log_compositors_match_jax_kernels(kind):
    """The plain forward and backward in the log form against JAX's
    kernels in the log form, each backward from its own forward."""
    pair_feat, b = _jax_pairs(*(jnp.asarray(_scene(kind)[k]) for k in KEYS))
    cfg = tconfig.RenderConfig(**LOG)
    gout = np.random.default_rng(4).normal(
        0, 1, (cfg.num_tiles, 8, cfg.tile**2)).astype(np.float32)
    fwd_j, d_j = _jax_fwd_bwd(pair_feat, b.block_meta, jnp.asarray(gout))
    args = tuple(torch.from_numpy(np.array(a)) for a in
                 (pair_feat, b.tile_start, b.tile_count))
    fwd, state = tras.composite_pairs_plain(*args, cfg, with_state=True)
    _check_against_jax(fwd, np.asarray(fwd_j), args[2])
    d = tras.composite_pairs_bwd(*args, fwd, state, torch.from_numpy(gout),
                                 cfg).numpy()
    d_j = np.asarray(d_j)[:10]
    for r in range(10):
        assert _rel(d[r], d_j[r]) <= GRAD_TOL, r
    # The block-start state holds T at each block's start in both modes: the
    # first block of every tile starts at T = 1 with zero sums.
    first = tras.tile_block_offsets(fwd)[:-1][fwd[:, 5, 0] > 0]
    blk, _, rank = tras.active_blocks(args[1], tras.tile_block_offsets(fwd),
                                      cfg)
    s0 = state[blk[rank == 0]]
    assert first.numel() == s0.shape[0] > 0
    assert (s0[:, 4] == 1).all() and (s0[:, :4] == 0).all()
    if kind == "saturated":
        nblk = (args[2] + cfg.pair_block - 1) // cfg.pair_block
        assert (fwd[:, 5, 0] < nblk).any(), "no tile was skipped"


def _np_params(scene):
    return {k: np.array(scene[k]) for k in PARAM_KEYS}


def _jax_value_grad(params, c2w, cfg_kw, tgt):
    cfg = gj.RenderConfig(**cfg_kw, backend="pallas")

    def loss(p):
        img, _ = gj.render_from_params(p, jnp.asarray(c2w), *CAM.values(),
                                       cfg)
        return jnp.mean(jnp.abs(img - tgt)) + jnp.mean(img * img), img

    (_, img), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in params.items()})
    return np.asarray(img), {k: np.asarray(v) for k, v in g.items()}


def _torch_value_grad(params, c2w, cfg_kw, tgt):
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in params.items()}
    img, aux = gt.render_from_params(p, c2w, *CAM.values(),
                                     gt.RenderConfig(**cfg_kw))
    loss = torch.mean(torch.abs(img - torch.from_numpy(tgt))) \
        + torch.mean(img * img)
    loss.backward()
    return img.detach().numpy(), {k: v.grad.numpy() for k, v in p.items()}


@pytest.mark.parametrize("seed", [5, 3])
def test_log_render_and_gradients_match_jax(seed):
    """render_from_params in the log mode: image within 2e-5 of JAX's,
    every gradient within 5e-4 of its max; and the port's log against its
    own cumprod, the JAX package's 2e-6 / 1e-4 gate."""
    s = make_scene(None, n=160, seed_offset=seed)
    params = _np_params(s)
    tgt = np.random.default_rng(seed).uniform(
        0, 1, (CFG["height"], CFG["width"], 3)).astype(np.float32)
    img_j, g_j = _jax_value_grad(params, s["c2w"], LOG, tgt)
    img_l, g_l = _torch_value_grad(params, s["c2w"], LOG, tgt)
    img_c, g_c = _torch_value_grad(params, s["c2w"], CFG, tgt)
    assert float(np.abs(img_l - img_j).max()) <= TOL
    assert float(np.abs(img_c - img_l).max()) <= 2e-6
    for k in PARAM_KEYS:
        assert _rel(g_l[k], g_j[k]) <= GRAD_TOL, k
        assert _rel(g_c[k], g_l[k]) <= 1e-4, k
