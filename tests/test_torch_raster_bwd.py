"""Port parity: the backward compositor (ops/raster_cuda.py, K2's plain
version) and the autograd path through ``composite_pairs``.

The plain backward is held against the JAX package's ``_bwd_pallas`` (its
Pallas backward kernel, in interpret mode on the CPU as
tests/test_pallas_kernel.py runs it) on the SAME pair features, block
layout and seeded cotangent, each side given its own forward output (the
port's with its block-start state). The block map the backward runs on
is held against binning's ``block_meta`` exactly.

Tolerance: rows 0-9 within 5e-4 of each row's max abs, the JAX package's
own gradient tolerance (tests/test_pallas_kernel.py:80): the JAX kernel
builds T with a grouped product and sums with dots, the port in order.
Blocks the forward skipped, dead blocks and padding slots are exact zeros
on both sides.

The CUDA kernel itself runs only on a card: tests/test_torch_gpu.py holds
it against this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_scene

import gsplat_tpu.config as jconfig
import gsplat_tpu_torch.config as tconfig
from gsplat_tpu.ops import raster_pallas as jras
from gsplat_tpu_torch.ops import raster_cuda as tras
from test_torch_raster import CFG, _jax_pairs, _saturated_scene

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

ROW_TOL = 5e-4
KEYS = ("pos", "scale_raw", "q_raw", "opacity_raw", "f_dc", "f_rest", "c2w")


def _scene(kind):
    if kind == "saturated":
        return _saturated_scene()
    return make_scene(None, n=192, seed_offset=int(kind[-1]))


@jax.jit
def _jax_fwd_bwd(pair_feat, block_meta, gout):
    cfg = jconfig.RenderConfig(**CFG)
    out = jras._fwd_pallas(pair_feat, block_meta, cfg)
    return out, jras._bwd_pallas(pair_feat, block_meta, out, gout, cfg)


def _case(kind, seed=0):
    pair_feat, b = _jax_pairs(*(jnp.asarray(_scene(kind)[k]) for k in KEYS))
    cfg = tconfig.RenderConfig(**CFG)
    gout = np.random.default_rng(seed).normal(
        0, 1, (cfg.num_tiles, 8, cfg.tile**2)).astype(np.float32)
    _, dj = _jax_fwd_bwd(pair_feat, b.block_meta, jnp.asarray(gout))
    t = {k: torch.from_numpy(np.array(v)) for k, v in (
        ("pair_feat", pair_feat), ("tile_start", b.tile_start),
        ("tile_count", b.tile_count), ("block_meta", b.block_meta))}
    t["gout"] = torch.from_numpy(gout)
    return t, np.asarray(dj)[:10], cfg


def _active_blocks(fwd_out, t, cfg):
    """[num_blocks] bool from block_meta: the blocks the forward
    composited."""
    meta = t["block_meta"].numpy()
    tile = meta >> tras.META_SHIFT
    first = (meta & 3) == tras.META_FIRST
    dead = (meta & tras.META_DEAD) != 0
    nb = meta.shape[0]
    start = np.maximum.accumulate(np.where(first, np.arange(nb), -1))
    rank = np.arange(nb) - start
    cnt = fwd_out[:, 5, 0].numpy().astype(np.int64)
    return ~dead & (start >= 0) & (rank < cnt[np.clip(tile, 0, None)])


def _inactive_slots(fwd_out, t, cfg):
    """[padded_pairs] bool: slots of blocks the forward did not composite
    (saturation-skipped, dead, headroom) and padding slots."""
    pad = (t["pair_feat"][:10] == 0).all(dim=0).numpy()
    return np.repeat(~_active_blocks(fwd_out, t, cfg), cfg.pair_block) | pad


@pytest.mark.parametrize("kind", ["seed0", "seed3", "saturated"])
def test_plain_backward_matches_jax_kernel(kind):
    t, want, cfg = _case(kind)
    args = (t["pair_feat"], t["tile_start"], t["tile_count"])
    fwd, state = tras.composite_pairs_plain(*args, cfg, with_state=True)
    launches = tras.composite_pairs.bwd_launches
    got = tras.composite_pairs_bwd(*args, fwd, state, t["gout"], cfg)
    assert tras.composite_pairs.bwd_launches == launches  # CPU: plain
    assert got.shape == (10, t["pair_feat"].shape[1])
    got = got.numpy()
    assert np.isfinite(got).all()
    for r in range(10):
        scale = np.abs(want[r]).max()
        assert scale > 0, f"row {r} is all zero"
        err = np.abs(got[r] - want[r]).max()
        assert err <= ROW_TOL * scale, f"row {r}: {err} vs max {scale}"
    off = _inactive_slots(fwd, t, cfg)
    assert off.any()
    assert (got[:, off] == 0).all() and (want[:, off] == 0).all()
    if kind == "saturated":
        nblk = (t["tile_count"] + cfg.pair_block - 1) // cfg.pair_block
        assert (fwd[:, 5, 0] < nblk).any(), "no tile was skipped"
    # Chunking over blocks changes nothing; only rows 0-4 of gout are read,
    # and only the composited blocks' state.
    g2 = t["gout"].clone()
    g2[:, 5:] = 7.0
    s2 = state.clone()
    s2[torch.from_numpy(~_active_blocks(fwd, t, cfg))] = float("nan")
    chunked = tras.composite_pairs_bwd_plain(*args, fwd, s2, g2, cfg,
                                             block_chunk=5)
    assert torch.equal(chunked, torch.from_numpy(got))


@pytest.mark.parametrize("kind", ["seed0", "seed3", "saturated"])
def test_active_blocks_match_block_meta(kind):
    """The backward's work list, built on the device from the forward's
    row 5 (tile_block_offsets), holds exactly the composited blocks of
    block_meta, in order, with block_meta's tile and first fields and no
    dead block; its length is sum(row 5)."""
    t, _, cfg = _case(kind)
    meta = t["block_meta"]
    fwd = tras.composite_pairs_plain(t["pair_feat"], t["tile_start"],
                                     t["tile_count"], cfg)
    off = tras.tile_block_offsets(fwd)
    assert off.dtype == torch.int32 and off.shape == (cfg.num_tiles + 1,)
    assert int(off[-1]) == int(fwd[:, 5, 0].sum()) > 0
    blocks, tile, rank = tras.active_blocks(t["tile_start"], off, cfg)
    assert (blocks[1:] > blocks[:-1]).all()
    want = np.flatnonzero(_active_blocks(fwd, t, cfg))
    assert np.array_equal(blocks.numpy(), want)
    m = meta[blocks]
    assert torch.equal(tile, (m >> tras.META_SHIFT).long())
    assert torch.equal((rank == 0).int(), m & tras.META_FIRST)
    assert not (m & tras.META_DEAD).any()


@pytest.mark.parametrize("kind", ["seed0", "saturated"])
def test_plain_forward_state(kind):
    """The block-start state: T = 1 and sums 0 at each tile's first block;
    at a continuation block, what the forward holds after the blocks
    before it (the output of the same walk cut short there); zero at the
    blocks not composited. The output is the one without state."""
    t, _, cfg = _case(kind)
    args = (t["pair_feat"], t["tile_start"], t["tile_count"])
    fwd, state = tras.composite_pairs_plain(*args, cfg, with_state=True)
    assert torch.equal(fwd, tras.composite_pairs_plain(*args, cfg))
    G = cfg.pair_block
    assert state.shape == (t["pair_feat"].shape[1] // G, 5, cfg.tile**2)
    active = _active_blocks(fwd, t, cfg)
    first = (t["block_meta"].numpy() & 3) == tras.META_FIRST
    assert (state[torch.from_numpy(first & active), 4] == 1).all()
    assert (state[torch.from_numpy(first & active), 0:4] == 0).all()
    assert (state[torch.from_numpy(~active)] == 0).all()
    cont = np.flatnonzero(active & ~first)
    assert cont.size > 0
    # Cut every tile's pair list after its first block: the forward's
    # output is then the state at each tile's second block.
    tc1 = torch.clamp(t["tile_count"], max=G)
    fwd1 = tras.composite_pairs_plain(t["pair_feat"], t["tile_start"], tc1,
                                      cfg)
    tile = t["block_meta"].numpy() >> tras.META_SHIFT
    rank = np.arange(len(first)) - t["tile_start"].numpy()[tile] // G
    second = np.flatnonzero(active & (rank == 1))
    assert second.size > 0
    want = fwd1[torch.from_numpy(tile[second])]
    assert torch.equal(state[second, 0:4], want[:, 0:4])
    assert torch.equal(state[second, 4], want[:, 4])


@pytest.mark.parametrize("kind", ["seed3", "saturated"])
def test_autograd_through_composite_pairs_matches_jax_vjp(kind):
    """torch.autograd through composite_pairs (16-row features, as the JAX
    layout) vs jax.vjp of raster_pallas.composite_pairs; rows 5-7 of the
    cotangent carry nothing on either side."""
    t, _, cfg = _case(kind, seed=5)
    jcfg = jconfig.RenderConfig(**CFG)
    out_j, vjp = jax.vjp(
        lambda pf: jras.composite_pairs(pf, jnp.asarray(t["block_meta"]),
                                        jcfg),
        jnp.asarray(t["pair_feat"].numpy()))
    (want,) = vjp(jnp.asarray(t["gout"].numpy()))
    want = np.asarray(want)
    pf = t["pair_feat"].clone().requires_grad_(True)
    out = tras.composite_pairs(pf, t["tile_start"], t["tile_count"], cfg)
    occ = t["tile_count"].numpy() > 0
    assert np.abs(out.detach().numpy()[occ, :5]
                  - np.asarray(out_j)[occ, :5]).max() <= 2e-5
    out.backward(t["gout"])
    got = pf.grad.numpy()
    assert got.shape == want.shape == (16, pf.shape[1])
    assert (got[10:] == 0).all()
    for r in range(10):
        scale = np.abs(want[r]).max()
        assert np.abs(got[r] - want[r]).max() <= ROW_TOL * scale, r
    with torch.no_grad():  # serving: nothing recorded
        assert tras.composite_pairs(pf, t["tile_start"], t["tile_count"],
                                    cfg).grad_fn is None


def test_backward_wrapper_rejects_bad_inputs():
    cfg = tconfig.RenderConfig(**CFG)
    nt, npairs, P = cfg.num_tiles, cfg.padded_pairs, cfg.tile**2
    pf = torch.zeros(10, npairs)
    ts = torch.zeros(nt, dtype=torch.int32)
    fo = torch.zeros(nt, 8, P)
    st = torch.zeros(npairs // cfg.pair_block, 5, P)
    with pytest.raises(ValueError, match="fwd_out"):
        tras.composite_pairs_bwd(pf, ts, ts, fo[:, :5], st, fo, cfg)
    with pytest.raises(ValueError, match="gout"):
        tras.composite_pairs_bwd(pf, ts, ts, fo, st, fo.double(), cfg)
    with pytest.raises(ValueError, match="state"):  # nothing rebuilds it
        tras.composite_pairs_bwd(pf, ts, ts, fo, None, fo, cfg)
    with pytest.raises(ValueError, match="state"):
        tras.composite_pairs_bwd(pf, ts, ts, fo, st[1:], fo, cfg)
    with pytest.raises(NotImplementedError, match="log"):
        tras.composite_pairs_bwd(pf, ts, ts, fo, st, fo,
                                 cfg.with_(transmittance_math="log"))
    d = tras.composite_pairs_bwd(pf, ts, ts, fo, st, fo, cfg)  # empty scene
    assert d.shape == (10, npairs) and (d == 0).all()
