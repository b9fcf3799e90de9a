"""Port parity: the compositor-ablation profiler
(``gsplat_tpu_torch/profile_kernel.py``) and its ablations of K1
(``gsplat_tpu_torch/ops/raster_ablate.py``).

The JAX bodies are those of ``scripts/profile_kernel.py``, loaded from the
file as it is. Each Pallas call is built as the script's ``run_variant``
builds it (that function returns only a time) and run in interpret mode on
the CPU, on the same pair features as the port's plain version. Only the
rows the JAX body writes are compared with it (it leaves the others
unwritten, NaN in interpret mode); the port's definition of the rest is
checked on its own.

Tolerances:

* ``no-transc``, ``no-mxu``, ``no-input``, ``cumprod``, ``pg-roll``,
  ``pg-log``: rows 0-4 within 1e-5 of each row's max abs (the JAX bodies
  sum with an MXU cumsum or triangular matmul, a dot and tree reductions,
  the port in sequence or in its kernel's lane order);
* ``cumprod``, ``pg-roll``, ``pg-log`` against the port's K1 plain version
  (``composite_pairs_plain``, the same function with T as a sequential
  product): rows 0-4 within 2e-5 abs, the kernel-vs-plain tolerance, and
  row 5 exactly;
* ``no-compute``: row 4 within 1e-6 relative (one f32 sum per block of u
  values up to ~1e3, in another order);
* ``empty``: row 4 exactly;
* the two profilers' tile-0 digests, printed with 4 decimals: 1e-3 abs.

The kernels themselves run only on a card: tests/test_torch_gpu.py holds
them against these plain versions there.
"""

import functools
import importlib.util
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import gsplat_tpu.config as jconfig
import gsplat_tpu_torch.config as tconfig
from gsplat_tpu.ops import raster_pallas as jras
from gsplat_tpu_torch import profile_kernel as tprof
from gsplat_tpu_torch.ops import raster_ablate as tabl
from gsplat_tpu_torch.ops import raster_cuda as tras

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "profile_kernel.py")

# name: (height, width, pair_block, blocks per tile, opacity or None)
CASES = {
    "32x48-G128-b2": (32, 48, 128, 2, None),
    "64x64-G32-b4": (64, 64, 32, 4, None),
    "64x64-G128-b1": (64, 64, 128, 1, None),
    # Opaque splats: the skip rule bites in later blocks.
    "32x48-G128-b4-opacity0.9": (32, 48, 128, 4, 0.9),
}


@functools.cache
def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_profile_kernel",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _block_meta(cfg, bpt):
    """The script's block metadata for `bpt` blocks per tile."""
    block_tile = np.repeat(np.arange(cfg.num_tiles, dtype=np.int32), bpt)
    first = np.zeros(block_tile.shape, np.int32)
    first[::bpt] = 1
    return jras.pack_block_meta(jnp.asarray(block_tile), jnp.asarray(first))


def _jax_body(name, pair_feat, cfg, bpt):
    """The script's body `name` on pair_feat, as run_variant calls it."""
    J = _jax_script()
    P = cfg.tile * cfg.tile
    block_meta = _block_meta(cfg, bpt)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(block_meta.shape[0],),
        in_specs=[pl.BlockSpec((J.FEAT_WIDTH, cfg.pair_block),
                               lambda b, bm: (0, b),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 8, P),
                               lambda b, bm: (bm[b] >> J.META_SHIFT, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=([pltpu.VMEM((P, 8), jnp.float32)]
                        if name in J.PG_VARIANTS else []),
    )
    fn = jax.jit(lambda bm, f: pl.pallas_call(
        functools.partial(J.VARIANTS[name], cfg=cfg),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((cfg.num_tiles, 8, P), jnp.float32),
        interpret=J._use_interpret(),
    )(bm, f))
    return np.asarray(fn(block_meta, jnp.asarray(pair_feat)))


def _workload(case):
    """The profiler's workload for CASES[case]: (cfg, pair_feat, tile_start,
    tile_count)."""
    height, width, G, bpt, opacity = CASES[case]
    cfg = tconfig.RenderConfig(height=height, width=width, max_pairs=2**18,
                               pair_block=G)
    pf, ts, tc = tprof.make_workload(cfg, bpt)
    if opacity is not None:
        pf[5] = opacity
    return cfg, pf, ts, tc


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("variant", list(tabl.VARIANTS))
def test_ablation_matches_jax_body(variant, case):
    _, _, G, bpt, opacity = CASES[case]
    cfg, pf, ts, tc = _workload(case)
    launches = dict(tabl.ablate.launches)
    got = tabl.ablate(variant, pf, ts, tc, cfg).numpy()
    assert tabl.ablate.launches == launches  # CPU: the plain version
    jcfg = jconfig.RenderConfig(height=cfg.height, width=cfg.width,
                                max_pairs=cfg.max_pairs, pair_block=G)
    want = _jax_body(variant, pf.numpy(), jcfg, bpt)

    if variant not in ("empty", "no-compute"):
        for r in range(5):
            scale = np.abs(want[:, r]).max()
            err = np.abs(got[:, r] - want[:, r]).max()
            assert err <= 1e-5 * scale, (r, err, scale)
    elif variant == "no-compute":
        np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got[:, 4], want[:, 4])

    # The rows the port defines where the JAX body writes nothing.
    assert (got[:, 6:] == 0).all()
    blocks = got[:, 5, 0]
    assert (got[:, 5] == blocks[:, None]).all()
    if variant in ("empty", "no-compute"):
        assert (got[:, 0:4] == 0).all()
        assert (blocks == (0 if variant == "empty" else bpt)).all()
    elif opacity is not None and variant != "no-input":
        assert (blocks < bpt).any(), "no tile was skipped"
        assert (blocks >= 1).all()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("variant", tabl.K1_FUNCTION)
def test_k1_designs_match_k1_plain(variant, case):
    """cumprod and pg-* compute K1's function: held against K1's plain
    version, skip decisions (row 5) included."""
    cfg, pf, ts, tc = _workload(case)
    got = tabl.ablate(variant, pf, ts, tc, cfg)
    want = tras.composite_pairs_plain(pf, ts, tc, cfg)
    assert float((got[:, 0:5] - want[:, 0:5]).abs().max()) <= 2e-5
    assert torch.equal(got[:, 5], want[:, 5])
    assert (got[:, 6:] == 0).all()


def test_no_input_never_reads_pair_feat():
    cfg, pf, ts, tc = _workload("32x48-G128-b4-opacity0.9")
    got = tabl.ablate("no-input", pf, ts, tc, cfg)
    again = tabl.ablate("no-input", torch.zeros_like(pf), ts, tc, cfg)
    assert torch.equal(got, again)
    # The iota features put alpha > 0 only near pixel (0, 0): tile 0.
    assert float(got[0, 0:4].abs().max()) > 0
    assert (got[1:, 0:4] == 0).all() and (got[1:, 4] == 1).all()


def test_make_workload_matches_jax_script(monkeypatch):
    """Captures the pair features and block metadata the JAX script's main
    hands run_variant, and holds make_workload against them."""
    J = _jax_script()
    seen = {}

    def capture(name, kernel, pair_feat, block_meta, cfg, iters):
        seen.update(pair_feat=np.asarray(pair_feat),
                    block_meta=np.asarray(block_meta), cfg=cfg)

    monkeypatch.setattr(J, "run_variant", capture)
    monkeypatch.setattr(sys, "argv", [
        SCRIPT, "--height", "32", "--width", "48", "--blocks-per-tile", "3",
        "--only", "full"])
    J.main()
    cfg = tconfig.RenderConfig(height=32, width=48, max_pairs=2**18)
    assert seen["cfg"].pair_block == cfg.pair_block
    pf, ts, tc = tprof.make_workload(cfg, 3)
    np.testing.assert_array_equal(pf.numpy(), seen["pair_feat"])
    # The tile ranges are the block metadata's: tile t owns the blocks
    # tagged t, starting at its first-flagged block.
    meta = seen["block_meta"]
    tile = meta >> jras.META_SHIFT
    G = cfg.pair_block
    first_block = np.nonzero(meta & jras.META_FIRST)[0]
    np.testing.assert_array_equal(ts.numpy(), first_block * G)
    np.testing.assert_array_equal(
        tc.numpy(), np.bincount(tile, minlength=cfg.num_tiles) * G)


def test_profiler_digests_match_jax_script():
    """The whole slice, workload included: both profilers, run as a user
    runs them on the CPU, print the same tile-0 digests for every variant
    whose rows 0-4 the JAX body writes."""
    flags = ["--height", "32", "--width", "48", "--blocks-per-tile", "2",
             "--iters", "1", "--only", ",".join(tprof.VARIANTS)]
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu",
               OMP_NUM_THREADS="1")
    cmds = [[sys.executable, SCRIPT, *flags],
            [sys.executable, "-m", "gsplat_tpu_torch.profile_kernel",
             "--device", "cpu", *flags]]
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    digests = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        digests.append({m[0]: float(m[1]) for m in re.findall(
            r"^(\S+)\s.*tile0-digest (\S+)", out, re.M)})
    jax_d, port_d = digests
    assert set(jax_d) == set(port_d) == set(tprof.VARIANTS)
    # empty and no-compute leave rows 0-3 unwritten on the TPU: NaN there.
    unwritten = {"empty", "no-compute"}
    assert {n for n, d in jax_d.items() if np.isnan(d)} == unwritten
    for name, want in jax_d.items():
        if name not in unwritten:
            assert abs(port_d[name] - want) <= 1e-3, (name, port_d[name],
                                                      want)


def test_profiler_runs_every_ported_variant_on_cpu(capsys):
    res = tprof.main(["--device", "cpu", "--height", "32", "--width", "48",
                      "--blocks-per-tile", "2", "--iters", "1"])
    assert [r["name"] for r in res] == list(tprof.VARIANTS)
    by = {r["name"]: r for r in res}
    assert all(r["launches"] == 0 for r in res)  # no kernel on the CPU
    assert by["full"]["blocks"] == by["no-compute"]["blocks"] == 12
    assert by["empty"]["blocks"] == 0 and by["empty"]["digest"] == 256.0
    out = capsys.readouterr().out
    assert "bound" not in out  # no device numbers
    assert "K1 minus each variant" in out


def test_profiler_rejects_unknown_variant_and_missing_card():
    with pytest.raises(ValueError, match="unknown variant"):
        tprof.main(["--device", "cpu", "--only", "fast"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="is_available"):
        tprof.main(["--height", "32", "--width", "48"])


def test_bounds():
    """Bounds at the profiler's default shapes: 8,160 tiles, 4 blocks of
    128 pairs each, no block skipped."""
    cfg = tconfig.RenderConfig(height=1080, width=1920, max_pairs=2**18)
    blocks = cfg.num_tiles * 4
    out_bytes = cfg.num_tiles * 8 * 256 * 4
    ms, by = tprof.bound_ms("empty", 0, cfg)
    assert by == "bytes" and ms == pytest.approx(out_bytes / 3.35e12 * 1e3)
    ms, by = tprof.bound_ms("no-compute", blocks, cfg)
    assert by == "bytes" and ms == pytest.approx(
        (blocks * 10 * 128 * 4 + out_bytes + cfg.num_tiles * 8)
        / 3.35e12 * 1e3)
    # cumprod and pg-* compute K1's function: K1's count, whatever the
    # design adds on top.
    for name, ops in (("full", 26), ("no-transc", 29), ("no-mxu", 26),
                      ("no-input", 29), ("cumprod", 26), ("pg-roll", 26),
                      ("pg-log", 26)):
        ms, by = tprof.bound_ms(name, blocks, cfg)
        assert by == "operations"
        assert ms == pytest.approx(blocks * 128 * 256 * ops / 67e12 * 1e3)
    for G in (32, 96, 256):
        small = tconfig.RenderConfig(height=32, width=48, max_pairs=2**12,
                                     pair_block=G)
        full = tprof.bound_ms("full", 12, small)
        for name in tabl.K1_FUNCTION:
            assert tprof.bound_ms(name, 12, small) == full


def test_k1_bound_counts_reached_work():
    """K1's function (full, cumprod, pg-*) and the bodies that walk only
    what their cull reaches (no-transc, no-mxu) given those (pair, warp):
    their operations per reached (pair, pixel) (26; no-transc 29) plus the
    cull's own (58 per (pair, warp), 14 per pair), against the bytes;
    without them, every (pair, pixel), the TPU kernel's work. no-input
    (which walks every pair), no-compute and empty ignore it."""
    cfg = tconfig.RenderConfig(height=1080, width=1920, max_pairs=2**18)
    blocks = cfg.num_tiles * 4
    pw = blocks * 128 * 8
    cull = blocks * 128 * (8 * 58 + 14)
    nbytes = blocks * 10 * 128 * 4 + cfg.num_tiles * (8 * 256 * 4 + 8)
    culled = {"full": 26, "no-transc": 29, "no-mxu": 26}
    culled.update((name, 26) for name in tabl.K1_FUNCTION)
    assert set(culled) == set(tprof.CULLED)
    for reached, by in ((pw, "operations"), (pw // 2, "operations"),
                        (0, "bytes")):
        for name, ops in culled.items():
            ms = max((reached * 32 * ops + cull) / 67e12,
                     nbytes / 3.35e12) * 1e3
            got, got_by = tprof.bound_ms(name, blocks, cfg, reached)
            assert got_by == by and got == pytest.approx(ms), name
    assert tprof.bound_ms("full", blocks, cfg, pw)[0] \
        > tprof.bound_ms("full", blocks, cfg)[0]
    for name in ("no-input", "no-compute", "empty"):
        assert tprof.bound_ms(name, blocks, cfg, 0) == \
            tprof.bound_ms(name, blocks, cfg)


@pytest.mark.parametrize("rational", [False, True])
def test_reached_pair_warps_on_cpu(rational):
    """The reached (pair, warp) of the profiler's workload are those
    pair_warp_reach keeps (``rational``: no-transc's cull, which reaches
    more), over every block the compositor composited."""
    cfg = tconfig.RenderConfig(height=32, width=48, max_pairs=2**12,
                               pair_block=32)
    pf, ts, tc = tprof.make_workload(cfg, 2)
    out = tras.composite_pairs_plain(pf, ts, tc, cfg)
    reached, total = tprof.reached_pair_warps(out, pf, ts, cfg, rational)
    blocks = cfg.num_tiles * 2
    assert total == blocks * 32 * 8
    f = pf[:10].reshape(10, blocks, 32)
    tiles = torch.arange(blocks) // 2
    assert reached == int(tras.pair_warp_reach(f, tiles, cfg,
                                               rational).sum())
    assert 0 < reached < total
    if rational:
        assert reached > tprof.reached_pair_warps(out, pf, ts, cfg)[0]


def test_attribution_table():
    """K1's time minus each variant's, one line each, naming the class the
    difference isolates; nothing without ``full``."""
    res = [{"name": n, "ms": 1.0 + i} for i, n in enumerate(tprof.VARIANTS)]
    lines = tprof.attribution(res)
    assert len(lines) == len(tprof.VARIANTS) - 1
    for i, (name, line) in enumerate(zip(list(tprof.VARIANTS)[1:], lines)):
        assert name in line and tprof.ISOLATES[name] in line
        assert f"{-(i + 1):+9.4f} ms" in line
    assert tprof.attribution(res[1:]) == []


def _tf32_inputs(kind):
    """f32 test values for the TF32 split: colours' range, a wide spread of
    exponents, exact ties (low 13 bits 0x1000), and specials."""
    r = np.random.default_rng(7)
    if kind == "unit":
        return r.uniform(0, 1, 4096).astype(np.float32)
    if kind == "wide":
        x = r.normal(0, 1, 4096) * np.exp(r.uniform(-80, 80, 4096))
        return x.astype(np.float32)
    if kind == "ties":
        b = r.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
        b = (b & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
        return b[((b >> 23) & 0xFF) != 0xFF].view(np.float32)
    return np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -2.5,
                     1e-40, -1e-40], np.float32)


@pytest.mark.parametrize("kind", ["unit", "wide", "ties", "special"])
def test_tf32_split(kind):
    """tf32_round is cvt.rna.tf32.f32 on the CPU: the low 13 mantissa
    bits of hi are zero, hi is the nearest TF32 with ties away from zero
    (subnormals rounded on their bits alike), hi + lo is x within 2^-22 of
    |x| above 2^-100, and NaN, Inf and +-0 pass through
    (zeros with their sign). The card's own split is held to it bit for
    bit in tests/test_torch_gpu.py."""
    x = _tf32_inputs(kind)
    hi, lo = (t.numpy() for t in tabl.tf32_split_plain(torch.from_numpy(x)))
    fin = np.isfinite(x)
    bits, hbits = x.view(np.uint32), hi.view(np.uint32)
    assert (hbits[fin] & 0x1FFF == 0).all()
    assert (lo.view(np.uint32)[np.isfinite(lo)] & 0x1FFF == 0).all()
    down = bits & np.uint32(0xFFFFE000)  # toward zero: the other candidate
    up = down + np.uint32(0x2000)  # away from zero
    low = bits & np.uint32(0x1FFF)
    want = np.where(low >= 0x1000, up, down)
    np.testing.assert_array_equal(hbits[fin], want[fin])
    if kind == "ties":
        assert (low == 0x1000).all() and (np.abs(hi) > np.abs(x)).all()
    # Where lo is a normal float (|x| >= 2^-100): below, lo keeps fewer
    # bits, as on the card.
    ok = fin & (np.abs(x) >= 2.0**-100)
    x64 = x[ok].astype(np.float64)
    err = np.abs(hi[ok].astype(np.float64) + lo[ok] - x64)
    assert (err <= 2.0**-22 * np.abs(x64)).all()
    np.testing.assert_array_equal(np.isnan(hi), np.isnan(x))
    inf = np.isinf(x)
    np.testing.assert_array_equal(hi[inf], x[inf])
    zero = x == 0
    np.testing.assert_array_equal(hbits[zero], bits[zero])
    assert (lo[zero] == 0).all()


def test_ablate_wrapper_on_cpu():
    cfg = tconfig.RenderConfig(height=32, width=48, max_pairs=2**12,
                               pair_block=32)
    nt = cfg.num_tiles
    pf = torch.zeros(10, cfg.padded_pairs)
    ts = torch.zeros(nt, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown ablation"):
        tabl.ablate("full", pf, ts, ts, cfg)
    with pytest.raises(ValueError, match="float32"):
        tabl.ablate("empty", pf.double(), ts, ts, cfg)
    with pytest.raises(ValueError, match="tile_count"):
        tabl.ablate("no-mxu", pf, ts, ts[:-1], cfg)
    for variant in tabl.VARIANTS:  # no pairs: T = 1, everything else 0
        out = tabl.ablate(variant, pf, ts, ts, cfg)
        assert (out[:, 4] == 1).all()
        assert (out[:, [0, 1, 2, 3, 5, 6, 7]] == 0).all()
    cfg48 = cfg.with_(pair_block=48)
    pf48, ts48, tc48 = tprof.make_workload(cfg48, 1)
    for variant in ("no-compute", "pg-roll", "pg-log"):
        with pytest.raises(ValueError, match="multiple of 32"):
            tabl.ablate(variant, pf48, ts48, tc48, cfg48)
