"""The binning kernels (``ops/csrc/binning.cu``) on a CUDA card against the
plain steps they replace.

Needs a card; every test here skips without one. It imports neither JAX
nor the suite's conftest (the GPU machine has no JAX), so run it with

    python -m pytest --noconftest tests/test_torch_gpu_binning.py -m gpu

``bin_gaussians`` on CUDA tensors runs the emission, the tile sort and
the aligned scatter as kernels; the same call with the three steps
swapped for their plain versions (PyTorch on the card) is the reference.
Every ``TileBinning`` field must be equal bit for bit (they are
integers), and each kernel's launch counter must have risen. The scenes
and cases are ``profile_binning.kernel_cases``'.
"""

import pytest
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch.ops import binning as B
from gsplat_tpu_torch.profile_binning import (CHECK_CASES, compare_kernels,
                                              kernel_cases)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return gt.resolve_device("cuda")


@pytest.mark.parametrize("seed", [2718281829, 2718281830])
@pytest.mark.parametrize("case", CHECK_CASES)
def test_binning_kernels_match_plain(cuda, case, seed):
    """The 120k checkpoint at four orbit poses; the 3 M garden scene at
    three poses near the origin camera (~52 M pairs); the garden at a
    third of its demand (whole gaussians dropped); three orbit views
    stacked (``view_tile_rows``, 15-bit keys); the ellipse cull's pairs
    through the sort and scatter; the rank truncation with the cull. Two
    draws of the garden scene."""
    seen = 0
    with torch.no_grad():
        for label, proj, cfg, emits in kernel_cases(case, cuda, seed=seed):
            r = compare_kernels(proj, cfg)
            assert r["bad"] == [], label
            assert r["launches"] == [emits, 1, 1], label
            if case == "overflow":
                assert r["num_pairs"] > cfg.max_pairs
            else:
                assert 0 < r["num_pairs"] <= cfg.max_pairs, label
            if case == "garden3m-drift":
                assert r["num_pairs"] > 40_000_000, label
            if case == "batched":
                assert B._end_bit(cfg.num_tiles) == 15
            seen += 1
    assert seen == (4 if case == "ckpt120k-orbit" else
                    3 if case == "garden3m-drift" else 1)


def test_binning_kernels_refuse_cpu_and_mixed_inputs(cuda):
    """The wrappers launch the kernels or raise: a CPU tensor beside a
    CUDA one, or an int64 key, is refused, never sent to the plain path."""
    cfg = gt.RenderConfig(height=64, width=64, max_pairs=256)
    tile_id = torch.zeros(256, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="slot"):
        B.sort_pairs(tile_id, torch.zeros(256, dtype=torch.int32),
                     cfg.num_tiles)
    with pytest.raises(ValueError, match="tile_id"):
        B.sort_pairs(tile_id.long(), tile_id.clone(), cfg.num_tiles)
    offsets = torch.zeros(5, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="n_u"):
        B.emit_pairs(offsets, torch.zeros(4, 2, dtype=torch.int64,
                                          device=cuda),
                     torch.zeros(4, dtype=torch.int32, device=cuda), cfg)
