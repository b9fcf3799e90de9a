"""Port parity: config, gaussian, camera, SH and projection.

Each case feeds the same numpy inputs (made from seeds) to the JAX
function and to its gsplat_tpu_torch counterpart on the CPU.

Tolerance for float outputs: 1e-5 of the field's largest magnitude. Both
sides compute in f32 but not in the same order (the port writes every 3x3
product elementwise; XLA contracts with its own dot), so results differ by
a few ulp of the field's scale. Integer outputs (radius, tile bounds,
valid) must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_scene

import gsplat_tpu.config as jconfig
import gsplat_tpu_torch.config as tconfig
from gsplat_tpu.ops import camera as jcam
from gsplat_tpu.ops import gaussian as jgau
from gsplat_tpu.ops import projection as jproj
from gsplat_tpu.ops import sh as jsh
from gsplat_tpu_torch.ops import camera as tcam
from gsplat_tpu_torch.ops import gaussian as tgau
from gsplat_tpu_torch.ops import projection as tproj
from gsplat_tpu_torch.ops import sh as tsh

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

REL = 1e-5


def close(t, j, rel=REL):
    """|t - j| <= rel * max|j|, with NaNs required in the same places."""
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    nan_t, nan_j = np.isnan(t), np.isnan(j)
    np.testing.assert_array_equal(nan_t, nan_j)
    t, j = t[~nan_j], j[~nan_j]
    if j.size == 0:
        return
    scale = max(float(np.max(np.abs(j))), 1e-30)
    err = float(np.max(np.abs(t - j)))
    assert err <= rel * scale, f"max abs {err} > {rel} * {scale}"


def T(a):
    return torch.from_numpy(np.array(a))


# --- config ---------------------------------------------------------------

def test_render_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.RenderConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.RenderConfig)]
    assert tf == jf


@pytest.mark.parametrize("kw", [
    dict(height=1080, width=1920, max_pairs=2**22),
    dict(height=64, width=64, max_pairs=4096, pair_block=32),
    dict(height=96, width=160, tile_rank_cap=200, max_rows=4096),
    dict(height=100, width=70, tile=8, tile_rank_cap=64, trunc_pairs=1000),
])
def test_render_config_derived_properties_match(kw):
    j = jconfig.RenderConfig(**kw)
    t = tconfig.RenderConfig(**kw)
    for prop in ("row_capacity", "padded_pairs", "num_pair_blocks",
                 "rank_cap_blocks", "trunc_padded_pairs", "num_trunc_blocks",
                 "tiles_x", "tiles_y", "num_tiles", "padded_width",
                 "padded_height"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.with_(max_pairs=7).max_pairs == 7


def test_render_config_tile_grid_guard_and_helpers():
    for mod in (jconfig, tconfig):
        with pytest.raises(ValueError, match="1023-tile"):
            mod.RenderConfig(height=64, width=16 * 1024)
    for a, b in ((7, 2), (8, 2), (0, 5), (1, 128)):
        assert tconfig.cdiv(a, b) == jconfig.cdiv(a, b)
    for s in ("black", "white", "0.1,0.2,0.3"):
        assert tconfig.parse_background(s) == jconfig.parse_background(s)
    with pytest.raises(ValueError):
        tconfig.parse_background("1,2")


# --- gaussian / camera ------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_gaussian_covariance_matches(seed):
    s = make_scene(None, n=300, seed_offset=seed)
    q, sc = s["q_raw"], s["scale_raw"]
    close(tgau.normalize_quat(T(q)), jgau.normalize_quat(jnp.asarray(q)))
    close(tgau.exp_scale(T(sc)), jgau.exp_scale(jnp.asarray(sc)))
    qn = np.asarray(jgau.normalize_quat(jnp.asarray(q)))
    close(tgau.quat_to_rotmat(T(qn)), jgau.quat_to_rotmat(jnp.asarray(qn)))
    packed_t = tgau.build_cov3d_packed(T(sc), T(q))
    close(packed_t, jgau.build_cov3d_packed(jnp.asarray(sc), jnp.asarray(q)))
    sigma = jgau.build_sigma_from_params(jnp.asarray(sc), jnp.asarray(q))
    close(tgau.pack_cov3d(T(np.asarray(sigma))), jgau.pack_cov3d(sigma))
    close(tgau.unpack_cov3d(packed_t), jgau.unpack_cov3d(
        jnp.asarray(packed_t.numpy())))


def test_camera_helpers_match():
    r = np.random.default_rng(3)
    a = r.normal(1.0, 1.0, 200).astype(np.float32)
    b = r.normal(0.0, 1.0, 200).astype(np.float32)
    c = r.normal(1.0, 1.0, 200).astype(np.float32)  # some det < 0: clamped
    got = tcam.inv2x2_packed(T(a), T(b), T(c))
    want = jcam.inv2x2_packed(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    for g, w in zip(got, want):
        close(g, w)
    assert tcam.scale_intrinsics(540, 960, 1080, 1920, 1632.0, 1632.0,
                                 960.0, 540.0) == jcam.scale_intrinsics(
        540, 960, 1080, 1920, 1632.0, 1632.0, 960.0, 540.0)
    s = make_scene(None, n=200, seed_offset=2)
    c2w = s["c2w"]
    close(tcam.w2c_from_c2w(T(c2w)), jcam.w2c_from_c2w(jnp.asarray(c2w)))
    for g, w in zip(
        tcam.transform_to_camera_space(T(s["pos"]), T(c2w)),
        jcam.transform_to_camera_space(jnp.asarray(s["pos"]),
                                       jnp.asarray(c2w)),
    ):
        close(g, w)


# --- spherical harmonics ------------------------------------------------------

@pytest.mark.parametrize("n_rest", [0, 9, 45])
def test_sh_colors_match(n_rest):
    s = make_scene(None, n=256, seed_offset=4)
    f_rest = s["f_rest"][:, :n_rest]
    pos = s["pos"].copy()
    pos[0] = s["c2w"][:3, 3]  # a slot exactly at the camera: norm guard
    args = (s["f_dc"], f_rest, pos, s["c2w"])
    got = tsh.evaluate_sh(*(T(a) for a in args))
    want = jsh.evaluate_sh(*(jnp.asarray(a) for a in args))
    assert torch.isfinite(got).all()
    close(got, want)
    dirs = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    close(tsh.sh_basis(T(dirs)), jsh.sh_basis(jnp.asarray(dirs)))
    close(tsh.pack_sh_coeffs(T(s["f_dc"]), T(f_rest)),
          jsh.pack_sh_coeffs(jnp.asarray(s["f_dc"]), jnp.asarray(f_rest)))


# --- projection ------------------------------------------------------------

def test_clamp_eigvals_matches():
    r = np.random.default_rng(5)
    a = np.abs(r.normal(0, 1e2, 500)).astype(np.float32) * r.choice(
        [1e-9, 1.0, 1e3], 500).astype(np.float32)
    c = np.abs(r.normal(0, 1e2, 500)).astype(np.float32)
    b = (r.normal(0, 1, 500) * np.sqrt(a * c) * 0.9).astype(np.float32)
    got = tproj.clamp_eigvals_2x2(T(a), T(b), T(c))
    want = jproj.clamp_eigvals_2x2(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(c))
    for g, w in zip(got, want):
        close(g, w)


def _projection_case(seed, n=300, **cfg_kw):
    s = make_scene(None, n=n, seed_offset=seed)
    cov = np.array(jgau.build_cov3d_packed(
        jnp.asarray(s["scale_raw"]), jnp.asarray(s["q_raw"])))
    kw = dict(height=64, width=80, max_pairs=4096, pair_block=32)
    kw.update(cfg_kw)
    return s, cov, kw


def _check_projection(s, cov, kw, cam, extra_valid=None):
    jcfg = jconfig.RenderConfig(**kw)
    tcfg = tconfig.RenderConfig(**kw)
    ev_j = None if extra_valid is None else jnp.asarray(extra_valid)
    ev_t = None if extra_valid is None else T(extra_valid)
    want = jproj.project_gaussians(
        jnp.asarray(s["pos"]), jnp.asarray(cov), jnp.asarray(s["opacity_raw"]),
        jnp.asarray(s["c2w"]), *cam, jcfg, extra_valid=ev_j)
    got = tproj.project_gaussians(
        T(s["pos"]), T(cov), T(s["opacity_raw"]), T(s["c2w"]), *cam, tcfg,
        extra_valid=ev_t)
    for field in ("uv", "depth", "conic", "opacity"):
        close(getattr(got, field), getattr(want, field))
    for field in ("radius", "tile_min", "tile_max", "valid"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            err_msg=field)
    assert got.radius.dtype == torch.int32
    assert got.tile_min.dtype == torch.int32
    return got


@pytest.mark.parametrize("aa_mode", ["none", "dilate", "mip"])
def test_projection_matches(aa_mode):
    s, cov, kw = _projection_case(0, aa_mode=aa_mode)
    _check_projection(s, cov, kw, (60.0, 58.0, 40.5, 31.5))


def test_projection_masks_dead_slots_and_band_guard():
    """extra_valid, pix_guard_v, behind-camera and NaN/garbage slots:
    masked, never filtered, and sanitized before any divide."""
    s, cov, kw = _projection_case(3, pix_guard_v=4.0)
    s["pos"][:10, 2] = -3.0  # behind the camera
    s["pos"][10:15] = np.nan  # garbage in dead pool slots
    cov[15:20] = np.inf
    s["opacity_raw"][20:25] = np.nan
    alive = np.ones(s["pos"].shape[0], bool)
    alive[25:60] = False
    got = _check_projection(s, cov, kw, (60.0, 58.0, 40.5, 31.5),
                            extra_valid=alive)
    assert not got.valid[:60].any() and got.valid[60:].any()
