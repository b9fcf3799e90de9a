"""CPU rehearsals of the card tests' shared cases (``torch_card_cases``).

The density control's two forms called directly on a small train state
and held to their rules as the card's ``fit()`` runs hold them
(``check_adc_identities`` with ``reference_spawns`` / ``paper_spawns``);
and ``fit()`` runs (b) and (d) of ``check_fit_runs`` on a 1,024-slot
slice of the bench checkpoint at 64x36, one view a step, eight
iterations, recorded by ``FitRecord`` and held by ``check_fit_run``: the
pool grown past its capacity, max_pairs grown from 128. On the CPU the
launch counters and the memory model are not read.
"""

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as gt
import torch_card_cases as C
from gsplat_tpu_torch.train import trainer

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)


def _state(cap=400, seed=5):
    """A random pool with scattered alive slots, opacities and scales
    across the thresholds, and Adam moments as after a few steps."""
    r = np.random.default_rng(seed)
    params = {
        "pos": r.normal(0, 2, (cap, 3)),
        "opacity_raw": r.normal(-3.0, 2.0, cap),
        "f_dc": r.normal(0, 1, (cap, 3)),
        "f_rest": r.normal(0, 0.1, (cap, 45)),
        "scale_raw": r.normal(-4.5, 1.0, (cap, 3)),
        "q_raw": r.normal(0, 1, (cap, 4)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    pool = gt.pool_from_numpy(params, r.uniform(0, 1, cap) < 0.7,
                              device="cpu")
    state = gt.init_train_state(pool, gt.TrainConfig(capacity=cap))
    g = torch.Generator().manual_seed(seed)
    for p in pool.params.values():
        st = state.opt_state.state[p]
        st["exp_avg"].normal_(0.0, 1e-3, generator=g)
        st["exp_avg_sq"].copy_(torch.rand(st["exp_avg_sq"].shape,
                                          generator=g) * 1e-6)
    return state, r


@pytest.mark.parametrize("form", ["reference", "paper"])
def test_adc_calls_follow_their_rules(form):
    state, r = _state()
    cap = state.pool.capacity
    if form == "reference":
        tcfg = gt.TrainConfig(capacity=cap)
        grad = torch.from_numpy(r.normal(0, 0.01, (cap, 3)).astype(
            np.float32))
        noise = torch.from_numpy(r.normal(0, 1, (cap, 3)).astype(np.float32))
        C.check_adc_identities(
            state, lambda: trainer.adc_step(
                state, grad, None, (tcfg.prune_opacity_threshold,
                                    tcfg.max_grad, tcfg.scale_threshold),
                noise=noise),
            lambda b: C.reference_spawns(b, grad, noise, tcfg))
    else:
        tcfg = gt.TrainConfig(capacity=cap, adc_mode="paper",
                              scene_extent=2.5, max_screen_size=30)
        uv = torch.from_numpy(np.abs(r.normal(0, 3e-4, cap)).astype(
            np.float32))
        rad = torch.from_numpy(r.integers(0, 40, cap).astype(np.int32))
        eps = tuple(torch.from_numpy(r.normal(0, 1, (cap, 3)).astype(
            np.float32)) for _ in range(2))
        C.check_adc_identities(
            state, lambda: trainer.adc_step_paper(state, uv, rad, None, tcfg,
                                                  noise=eps),
            lambda b: C.paper_spawns(b, uv, rad, eps, tcfg))


@pytest.mark.parametrize("name", ["b", "d"])
def test_fit_grows_the_pool_and_max_pairs(name, tmp_path):
    pool, c2w, center, radius = C.checkpoint("cpu", slots=1024)
    cfg, batch, start = C.train_views(pool, c2w, center, radius, height=36,
                                      width=64, max_pairs=2**14, views=1)
    tcfg = C.fit_configs(pool.capacity, radius, iters=8, batch=1)[name]
    ckpt = str(tmp_path / "start.npz")
    trainer.save_checkpoint(ckpt, gt.init_train_state(gt.pool_from_numpy(
        start, pool.alive.numpy(), device="cpu"), tcfg))
    rcfg = cfg.with_(max_pairs=128) if name == "d" else cfg
    res = C.fit_run(name, tcfg, rcfg, batch,
                    pool.pos.detach()[pool.alive].numpy(), ckpt,
                    str(tmp_path / name))
    C.check_fit_run(name, res, rcfg, pool.capacity)
