"""The training update (``ops/update.py``) on the CPU, where it runs its
plain version, against PyTorch's own Adam.

The oracle is ``torch.optim.Adam(capturable=False)`` stepped on clones of
the state, behind the position clip and the dead-slot mask written out
here as the step applied them before the update had kernels. The plain
version follows the capturable single-tensor Adam's operations (and sums
the clip's squares in float64), so the two differ by rounding only:
every parameter and moment must lie within 1e-6 of that tensor's largest
absolute value, and the step counts must be equal. A non-finite step
must leave every tensor the optimizer holds bit for bit as it was.
"""

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.config import FeatureConfig, TrainConfig
from gsplat_tpu_torch.models.gaussians import (GaussianPool, PARAM_KEYS,
                                               init_decoder)
from gsplat_tpu_torch.ops.update import adam_update
from gsplat_tpu_torch.train import trainer as ttr

N, DEAD = 96, 17  # slots, and how many of them are dead
TOL = 1e-6


def _state(seed, features=False, **tcfg):
    r = np.random.default_rng(seed)
    widths = {"pos": 3, "scale_raw": 3, "q_raw": 4, "opacity_raw": None,
              "f_dc": 3, "f_rest": 45}
    if features:
        widths["f_sem"] = 32
    params = {k: torch.from_numpy(r.normal(0, 1, (N,) if w is None else
                                           (N, w)).astype(np.float32))
              for k, w in widths.items()}
    alive = torch.from_numpy(r.permutation(N) >= DEAD)
    cfg = TrainConfig(capacity=N, **tcfg)
    dec = init_decoder(32, 16, seed, device="cpu") if features else None
    return ttr.init_train_state(GaussianPool(params, alive), cfg,
                                FeatureConfig() if features else None,
                                dec), cfg


def _grads(state, seed, pos_scale=1.0):
    r = np.random.default_rng(1000 + seed)
    out = {}
    for g in state.opt_state.param_groups:
        p = g["params"][0]
        out[g["name"]] = torch.from_numpy(
            r.normal(0, 1, tuple(p.shape)).astype(np.float32))
    out["pos"] = out["pos"] * pos_scale
    return out


class Oracle:
    """PyTorch's non-capturable Adam on clones of ``state``'s leaves, fed
    the clipped, masked gradients as the step fed them."""

    def __init__(self, state):
        self.names = [g["name"] for g in state.opt_state.param_groups]
        self.alive = state.pool.alive.clone()
        src = state.opt_state
        self.params = {g["name"]: g["params"][0].detach().clone()
                       for g in src.param_groups}
        self.opt = torch.optim.Adam(
            [{"params": [self.params[g["name"]]], "lr": float(g["lr"]),
              "name": g["name"]} for g in src.param_groups],
            betas=(0.9, 0.999), eps=src.defaults["eps"], foreach=False,
            fused=False, capturable=False)
        for g in src.param_groups:
            st = src.state[g["params"][0]]
            self.opt.state[self.params[g["name"]]] = {
                k: st[k].clone() for k in ("step", "exp_avg", "exp_avg_sq")}

    def step(self, grads, clip, lrs):
        g = dict(grads)
        norm = torch.linalg.vector_norm(g["pos"])
        g["pos"] = g["pos"] * torch.clamp(clip / (norm + 1e-6), max=1.0)
        for k in g:
            if k not in ("dec_w", "dec_b"):
                g[k] = torch.where(self.alive.reshape(
                    (-1,) + (1,) * (g[k].dim() - 1)), g[k], 0.0)
        for group in self.opt.param_groups:
            group["lr"] = lrs[group["name"]]
            self.params[group["name"]].grad = g[group["name"]].clone()
        self.opt.step()
        return g["pos"]

    def check(self, state):
        opt = state.opt_state
        for group in opt.param_groups:
            name = group["name"]
            p = group["params"][0]
            mine = opt.state[p]
            ref = self.opt.state[self.params[name]]
            for label, a, b in (("param", p.detach(), self.params[name]),
                                ("exp_avg", mine["exp_avg"], ref["exp_avg"]),
                                ("exp_avg_sq", mine["exp_avg_sq"],
                                 ref["exp_avg_sq"])):
                scale = float(b.abs().max())
                assert float((a - b).abs().max()) <= TOL * scale, \
                    (name, label)
            assert torch.equal(mine["step"], ref["step"]), name


def _lrs(state):
    return {g["name"]: float(g["lr"]) for g in state.opt_state.param_groups}


@pytest.mark.parametrize("pos_scale, engaged", [(1.0, True), (1e-3, False)])
def test_one_step_with_dead_slots_matches_adam(pos_scale, engaged):
    """A finite step over a pool with dead slots, the clip engaged (the
    position gradient's norm ~17) and idle (~0.017 < 1): moments and
    parameters as PyTorch's Adam gives them, dead slots unmoved, and the
    clipped, masked position gradient returned."""
    state, cfg = _state(1)
    grads = _grads(state, 1, pos_scale)
    assert (float(torch.linalg.vector_norm(grads["pos"]))
            > cfg.grad_clip_pos) == engaged
    before = {k: p.detach().clone() for k, p in state.pool.params.items()}
    oracle = Oracle(state)
    want_pos = oracle.step(grads, cfg.grad_clip_pos, _lrs(state))
    skipped, pos_grad = adam_update(state.opt_state, dict(grads),
                                    state.pool.alive, torch.tensor(0.5),
                                    cfg.grad_clip_pos)
    assert int(skipped) == 0 and skipped.dtype == torch.int32
    oracle.check(state)
    torch.testing.assert_close(pos_grad, want_pos, rtol=0, atol=TOL)
    dead = ~state.pool.alive
    for k, p in state.pool.params.items():
        assert torch.equal(p.detach()[dead], before[k][dead]), k
        assert not torch.equal(p.detach(), before[k]), k


def test_three_steps_read_the_position_lr_before_the_count_advances():
    """Three ``apply_update`` calls on a schedule that decays every step:
    the position LR of each is ``position_lr`` of the count before that
    update (0, 1, 2), and every leaf follows PyTorch's Adam."""
    state, cfg = _state(2, position_lr_max_steps=3,
                        position_lr_delay_mult=0.0)
    oracle = Oracle(state)
    lrs = []
    for i in range(3):
        grads = _grads(state, 10 + i)
        want = dict(_lrs(state), pos=float(ttr.position_lr(i, cfg)))
        lrs.append(want["pos"])
        oracle.step(grads, cfg.grad_clip_pos, want)
        state, m = ttr.apply_update(state, torch.tensor(0.25), dict(grads),
                                    cfg)
        assert int(m["nonfinite_skipped"]) == 0
    assert len(set(lrs)) == 3
    assert int(state.step) == 3
    oracle.check(state)


def test_features_and_an_unmasked_decoder_match_adam():
    """A pool with ``f_sem`` and the decoder: ``f_sem`` is masked by slot,
    the decoder's leaves (no slots) are not, and all nine follow Adam."""
    state, cfg = _state(3, features=True)
    names = [g["name"] for g in state.opt_state.param_groups]
    assert names == list(PARAM_KEYS) + ["f_sem", "dec_w", "dec_b"]
    oracle = Oracle(state)
    grads = _grads(state, 3)
    oracle.step(grads, cfg.grad_clip_pos, _lrs(state))
    dec_before = state.decoder["dec_w"].detach().clone()
    adam_update(state.opt_state, dict(grads), state.pool.alive,
                torch.tensor(1.0), cfg.grad_clip_pos)
    oracle.check(state)
    # Every element of the decoder moved: no slot of the mask is read.
    assert bool((state.decoder["dec_w"].detach() != dec_before).all())


def _poison(kind, grads, alive):
    loss = torch.tensor(0.5)
    row = int(torch.nonzero(alive)[3])
    dead = int(torch.nonzero(~alive)[0])
    if kind == "loss_nan":
        loss = torch.tensor(float("nan"))
    elif kind == "alive_inf":
        grads["f_rest"][row, 7] = float("inf")
    elif kind == "pos_nan_dead_row":
        grads["pos"][dead, 1] = float("nan")  # NaN norm: every row NaN
    elif kind == "decoder_nan":
        grads["dec_w"][0, 0] = float("nan")
    return loss


@pytest.mark.parametrize("kind", ["loss_nan", "alive_inf",
                                  "pos_nan_dead_row", "decoder_nan"])
def test_non_finite_step_changes_nothing(kind):
    """A non-finite loss, an infinite gradient in an alive row, a NaN in
    a dead row of the position gradient (it makes the clip's norm NaN)
    and a NaN in the decoder's gradient: every tensor of
    ``_optimizer_tensors`` is bit for bit as it was and the step reports
    1."""
    state, cfg = _state(4, features=kind == "decoder_nan")
    grads = _grads(state, 4)
    loss = _poison(kind, grads, state.pool.alive)
    before = [t.clone() for t in ttr._optimizer_tensors(state.opt_state)]
    state, m = ttr.apply_update(state, loss, grads, cfg)
    assert int(m["nonfinite_skipped"]) == 1
    after = ttr._optimizer_tensors(state.opt_state)
    assert len(after) == len(before)
    for b, a in zip(before, after):
        assert torch.equal(b, a)


def test_non_finite_in_a_dead_row_is_masked_and_applied():
    """A NaN in a dead slot's row of a leaf other than the position is
    zeroed by the mask before Adam, as it was: the step is applied."""
    state, cfg = _state(5)
    grads = _grads(state, 5)
    dead = int(torch.nonzero(~state.pool.alive)[0])
    oracle = Oracle(state)
    oracle.step({k: v.clone() for k, v in grads.items()}, cfg.grad_clip_pos,
                _lrs(state))
    grads["scale_raw"][dead, 2] = float("nan")
    skipped, _ = adam_update(state.opt_state, grads, state.pool.alive,
                             torch.tensor(0.5), cfg.grad_clip_pos)
    assert int(skipped) == 0
    oracle.check(state)


def test_without_the_guard_a_non_finite_step_is_applied():
    """``nan_guard=False``: nothing is decided; the update runs on the
    non-finite gradient as Adam would, and the counts advance."""
    state, cfg = _state(6, nan_guard=False)
    grads = _grads(state, 6)
    row = int(torch.nonzero(state.pool.alive)[0])
    grads["opacity_raw"][row] = float("nan")
    state, m = ttr.apply_update(state, torch.tensor(0.5), grads, cfg)
    assert "nonfinite_skipped" not in m
    assert bool(torch.isnan(state.pool.opacity_raw.detach()[row]))
    for g in state.opt_state.param_groups:
        assert float(state.opt_state.state[g["params"][0]]["step"]) == 1.0


@pytest.mark.parametrize("option, value", [("amsgrad", True),
                                           ("weight_decay", 0.01),
                                           ("maximize", True)])
def test_the_update_refuses_adam_options_it_does_not_implement(option,
                                                                value):
    state, cfg = _state(7)
    state.opt_state.param_groups[2][option] = value
    before = [t.clone() for t in ttr._optimizer_tensors(state.opt_state)]
    with pytest.raises(ValueError, match=option):
        adam_update(state.opt_state, _grads(state, 7), state.pool.alive,
                    torch.tensor(0.5), cfg.grad_clip_pos)
    for b, a in zip(before, ttr._optimizer_tensors(state.opt_state)):
        assert torch.equal(b, a)
