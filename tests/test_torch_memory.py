"""The port's memory model (``gsplat_tpu_torch/utils/memory.py``).

``torch.autograd.graph.saved_tensors_hooks`` sees every tensor autograd
saves for the backward. Summed over their unique storages, for a small
train-step forward (``render_from_params`` and ``compute_loss`` per view,
or ``render_batch_from_params`` with one loss), they are what the step
holds to its backward; the model's ``held_to_backward_mb``, built from the
shapes of the tensors the port allocates, must lie within 15 % of that
sum (a few hundred gaussians, 64x48 pixels, ``max_pairs`` 4,096, 1 and 2
views). The card's peaks are held to the whole estimate in
``tests/test_torch_gpu_flows.py``. The JAX package's keys keep the JAX values
(tests/test_torch_fit.py, tests/test_torch_batched.py).
"""

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch.ops.losses import compute_loss
from gsplat_tpu_torch.utils.memory import (estimate_render_memory,
                                           estimate_train_memory)

torch.set_num_threads(1)

N, H, W = 300, 48, 64
CAM = (60.0, 60.0, 32.0, 24.0)


def _params(seed=0):
    r = np.random.default_rng(seed)
    p = {"pos": np.stack([r.uniform(-1.5, 1.5, N), r.uniform(-1.5, 1.5, N),
                          r.uniform(3, 6, N)], -1),
         "scale_raw": r.normal(0, 0.3, (N, 3)) - 2.5,
         "q_raw": r.normal(0, 1, (N, 4)) + [0, 0, 0, 2],
         "opacity_raw": r.normal(0.5, 1, N),
         "f_dc": r.normal(0, 0.8, (N, 3)),
         "f_rest": r.normal(0, 0.05, (N, 45))}
    return {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
            for k, v in p.items()}


def _poses(views):
    out = np.stack([np.eye(4, dtype=np.float32)] * views)
    out[:, 0, 3] = 0.1 * np.arange(views)
    return out


def _saved_bytes(fn):
    """Bytes of the unique storages autograd saves while ``fn`` runs."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("views", [1, 2])
def test_held_to_backward_matches_saved_tensors(views, batched):
    params = _params()
    alive = torch.ones(N, dtype=torch.bool)
    cfg = gt.RenderConfig(height=H, width=W, max_pairs=4096)
    target = torch.rand(views, H, W, 3, generator=torch.Generator()
                        .manual_seed(1))
    poses = _poses(views)

    def step():
        if batched:
            imgs, _ = gt.render_batch_from_params(params, poses, *CAM, cfg,
                                                  alive=alive)
            return compute_loss(imgs, target)[0]
        total = 0.0
        for v in range(views):
            img, _ = gt.render_from_params(params, poses[v], *CAM, cfg,
                                           alive=alive)
            total = total + compute_loss(img, target[v])[0]
        return total

    got = _saved_bytes(step) / 1e6
    est = estimate_train_memory(cfg, gt.TrainConfig(
        capacity=N, batch_size=views, batched_render=batched))
    assert est["views_live"] == views
    want = est["held_to_backward_mb"]
    assert abs(want - got) <= 0.15 * got, (want, got)
    parts = ("saved_pair_features_mb", "block_state_mb", "pair_slot_mb",
             "tile_out_mb", "autograd_per_gaussian_mb", "loss_saved_mb")
    assert sum(est[k] for k in parts) == pytest.approx(want)


def test_train_estimate_phases():
    """The total is the largest phase; the per-view step holds every view
    to the backward; bwd_pairs shrinks only the backward's working set;
    one gaussian-sharded rank holds C/T rows of the state."""
    cfg = gt.RenderConfig(height=540, width=960, max_pairs=2**21)
    tcfg = gt.TrainConfig(capacity=131072, batch_size=4)
    est = estimate_train_memory(cfg, tcfg)
    phases = {k: v for k, v in est.items() if k.endswith("_phase_mb")}
    assert set(phases) == {f"{p}_phase_mb" for p in (
        "binning", "gather", "loss", "backward", "update")}
    assert est["total_mb"] == max(phases.values())
    assert est["total_mb"] == est[est["peak_phase"] + "_phase_mb"]
    # Four views of [10, slots] features and [slots / G, 5, 256] states.
    slots = cfg.padded_pairs
    assert est["saved_pair_features_mb"] == pytest.approx(
        4 * 10 * slots * 4 / 1e6)
    assert est["block_state_mb"] == pytest.approx(
        4 * slots // 128 * 5 * 256 * 4 / 1e6)
    one = estimate_train_memory(cfg, gt.TrainConfig(capacity=131072,
                                                    batch_size=1))
    assert est["held_to_backward_mb"] == pytest.approx(
        4 * one["held_to_backward_mb"])
    batched = gt.TrainConfig(capacity=131072, batch_size=4,
                             batched_render=True)
    whole = estimate_train_memory(cfg, batched)
    compact = estimate_train_memory(cfg.with_(bwd_pairs=663552), batched)
    assert compact["backward_working_mb"] < whole["backward_working_mb"]
    assert compact["held_to_backward_mb"] == whole["held_to_backward_mb"]
    rank = estimate_train_memory(cfg, tcfg, gauss_sharded_tile=2)
    assert rank["params_mb"] == pytest.approx(est["params_mb"] / 2)
    assert rank["block_state_mb"] < est["block_state_mb"]


def test_render_estimate():
    """A served frame: parameters, projections and the larger of binning's
    and K1's working sets (K1 reads the depth-ordered table: no pair list
    is gathered); the JAX keys beside."""
    from gsplat_tpu_torch.utils import memory

    cfg = gt.RenderConfig(height=1080, width=1920, max_pairs=2**22)
    est = estimate_render_memory(cfg, 131072)
    assert est["total_mb"] == pytest.approx(
        est["params_mb"] + est["projected_mb"] + est["forward_working_mb"])
    assert est["forward_working_mb"] == pytest.approx(
        memory.BINNING_BYTES_PER_PAIR * 2**22 / 1e6)  # binning binds here
    slots = cfg.padded_pairs
    small = gt.RenderConfig(height=64, width=64, max_pairs=2**12)
    few = estimate_render_memory(small, 131072)
    assert few["forward_working_mb"] == pytest.approx(  # K1, few pairs
        (4 * small.padded_pairs + 48 * 131072 + 16 * 8 * 256 * 4) / 1e6)
    assert est["pair_features_mb"] == pytest.approx(16 * slots * 4 / 1e6)
