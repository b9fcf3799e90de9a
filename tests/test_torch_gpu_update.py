"""The training update's kernels (``ops/csrc/update.cu``) on a CUDA card
against their plain version.

Needs a card; every test here skips without one. It imports neither JAX
nor the suite's conftest (the GPU machine has no JAX), so run it with

    python -m pytest --noconftest tests/test_torch_gpu_update.py -m gpu

U1 and U2 against ``adam_update_plain`` on the card, at the training
cells' leaf shapes: 2,959,677 slots of the six RGB leaves (59 floats a
slot), and of those with 128 feature channels and the 512 x 128 decoder
(187 floats a slot and 66,048 more), with dead slots, the clip engaged
and moments from earlier steps. Bit for bit: the kernels repeat the plain
version's operations with the roundings of PyTorch's CUDA kernels
(``-fmad=false``, explicit fused multiply-adds where PyTorch's lerp and
addcmul have them), and the clip's sum of squares is accumulated in
float64 by both, which rounds to the same float32. A skipped step leaves
every tensor bit for bit. Through ``make_train_step``: two launches a
step, no ``Adam.step``, and no copy of a parameter or moment.
"""

import pytest
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch.config import FeatureConfig, TrainConfig
from gsplat_tpu_torch.ops import update as U
from gsplat_tpu_torch.train import trainer as ttr

pytestmark = pytest.mark.gpu

SLOTS = 2_959_677
WIDTHS = {"pos": 3, "scale_raw": 3, "q_raw": 4, "opacity_raw": None,
          "f_dc": 3, "f_rest": 45}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return gt.resolve_device("cuda")


def _optimizer(cuda, features, seed):
    """An optimizer over the cell's leaves as ``init_train_state`` builds
    it (capturable: counts and the position LR on the card), its moments
    and counts as after a few steps, and the pool's alive mask (5 % dead)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * s

    widths = dict(WIDTHS, **({"f_sem": 128} if features else {}))
    params = {k: randn(*((SLOTS,) if w is None else (SLOTS, w)))
              for k, w in widths.items()}
    if features:
        params.update(dec_w=randn(512, 128, s=0.09), dec_b=randn(512, s=0.09))
    alive = torch.rand(SLOTS, generator=gen, device=cuda) >= 0.05
    params = {k: torch.nn.Parameter(v) for k, v in params.items()}
    opt = ttr.make_optimizer(params, TrainConfig(capacity=SLOTS),
                             FeatureConfig() if features else None)
    for g in opt.param_groups:
        st = opt.state[g["params"][0]]
        st["exp_avg"].copy_(randn(*st["exp_avg"].shape, s=1e-3))
        st["exp_avg_sq"].copy_(randn(*st["exp_avg_sq"].shape, s=1e-3) ** 2)
        st["step"].fill_(4.0)
    return opt, alive


def _twin(opt, features):
    """A second optimizer over clones of ``opt``'s leaves and state."""
    params = {g["name"]: torch.nn.Parameter(g["params"][0].detach().clone())
              for g in opt.param_groups}
    twin = ttr.make_optimizer(params, TrainConfig(capacity=SLOTS),
                              FeatureConfig() if features else None)
    for a, b in zip(opt.param_groups, twin.param_groups):
        sa, sb = opt.state[a["params"][0]], twin.state[b["params"][0]]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            sb[k].copy_(sa[k])
    return twin


def _set_position_lr(opt):
    """As ``apply_update`` sets it: the schedule at the count, a tensor."""
    for g in opt.param_groups:
        if g["name"] == "pos":
            g["lr"] = ttr.position_lr(opt.state[g["params"][0]]["step"],
                                      TrainConfig(capacity=SLOTS))


def _grads(opt, cuda, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return {g["name"]: torch.randn(g["params"][0].shape, generator=gen,
                                   device=cuda)
            for g in opt.param_groups}


def _diff(a, b) -> list:
    return [i for i, (x, y) in enumerate(zip(ttr._optimizer_tensors(a),
                                             ttr._optimizer_tensors(b)))
            if not torch.equal(x, y)]


@pytest.mark.parametrize("features", [False, True], ids=["rgb59", "feat187"])
def test_kernels_equal_the_plain_update_at_the_cells_shapes(cuda, features):
    """Two steps of U1 + U2 and of ``adam_update_plain`` from the same
    state and gradients: every parameter, moment and count, the clipped
    position gradient and the skip flag bit for bit; the clip engaged; no
    copy of the state made (the peak rises by less than a MiB)."""
    opt, alive = _optimizer(cuda, features, seed=31 + features)
    ref = _twin(opt, features)
    loss = torch.tensor(0.3, device=cuda)
    for step in range(2):
        g = _grads(opt, cuda, seed=100 + step)
        assert float(torch.linalg.vector_norm(g["pos"])) > 1.0  # clipped
        g_ref = {k: v.clone() for k, v in g.items()}
        _set_position_lr(opt)
        _set_position_lr(ref)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        n0 = U.adam_update.launches
        skipped, pos = U.adam_update(opt, g, alive, loss, 1.0)
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base < 2**20
        assert U.adam_update.launches - n0 == 2
        skipped_ref, pos_ref = U.adam_update_plain(ref, g_ref, alive, loss,
                                                   1.0)
        assert int(skipped) == int(skipped_ref) == 0
        assert torch.equal(pos, pos_ref)
        assert _diff(opt, ref) == []
    for g in opt.param_groups:
        assert float(opt.state[g["params"][0]]["step"]) == 6.0


def test_a_non_finite_step_writes_nothing_on_the_card(cuda):
    """An infinite gradient in one alive row of ``f_rest``: the kernels
    leave every parameter, moment and count bit for bit, report 1, and
    write the clipped position gradient as the plain version does."""
    opt, alive = _optimizer(cuda, False, seed=41)
    ref = _twin(opt, False)
    before = [t.clone() for t in ttr._optimizer_tensors(opt)]
    g = _grads(opt, cuda, seed=7)
    row = int(torch.nonzero(alive)[1000])
    g["f_rest"][row, 5] = float("inf")
    g_ref = {k: v.clone() for k, v in g.items()}
    loss = torch.tensor(0.3, device=cuda)
    _set_position_lr(opt)
    _set_position_lr(ref)
    skipped, pos = U.adam_update(opt, g, alive, loss, 1.0)
    skipped_ref, pos_ref = U.adam_update_plain(ref, g_ref, alive, loss, 1.0)
    assert int(skipped) == int(skipped_ref) == 1
    assert torch.equal(pos, pos_ref)
    for b, a in zip(before, ttr._optimizer_tensors(opt)):
        assert torch.equal(b, a)


def test_a_train_step_launches_the_update_twice(cuda, monkeypatch):
    """``make_train_step`` on the card: U1 and U2 once each a step, no
    ``torch.optim.Adam.step`` and no clone of a parameter or moment."""
    n = 640
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = {"pos": torch.stack([
        torch.rand(n, generator=gen, device=cuda) * 4 - 2,
        torch.rand(n, generator=gen, device=cuda) * 4 - 2,
        torch.rand(n, generator=gen, device=cuda) * 5 + 3], -1)}
    params["scale_raw"] = torch.randn(n, 3, generator=gen, device=cuda) \
        * 0.3 - 2.0
    params["q_raw"] = torch.randn(n, 4, generator=gen, device=cuda)
    params["q_raw"][:, 3] += 2.0
    params["opacity_raw"] = torch.randn(n, generator=gen, device=cuda) + 0.5
    params["f_dc"] = torch.randn(n, 3, generator=gen, device=cuda) * 0.8
    params["f_rest"] = torch.randn(n, 45, generator=gen, device=cuda) * 0.05
    alive = torch.arange(n, device=cuda) < 600
    cfg = gt.RenderConfig(height=64, width=96, max_pairs=2**15)
    cam = {"fx": 80.0, "fy": 80.0, "cx": 48.0, "cy": 32.0}
    c2w = torch.eye(4, device=cuda)
    with torch.no_grad():
        img = gt.render_from_params(params, c2w, *cam.values(), cfg,
                                    alive=alive)[0]
    batch = {"image": (img + 0.05)[None], "c2w": c2w[None]}
    batch.update({k: torch.full((1,), v, device=cuda)
                  for k, v in cam.items()})
    pool = gt.GaussianPool({k: v.clone() for k, v in params.items()}, alive)
    tcfg = TrainConfig(capacity=n, batch_size=1)
    state = gt.init_train_state(pool, tcfg)
    step = gt.make_train_step(cfg, tcfg)

    def banned(*a, **k):
        raise AssertionError("Adam.step ran")
    monkeypatch.setattr(torch.optim.Adam, "step", banned)
    state_ptrs = {t.data_ptr() for t in ttr._optimizer_tensors(
        state.opt_state)}
    cloned = []
    real_clone = torch.Tensor.clone

    def clone(self, *a, **k):
        cloned.append(self.data_ptr())
        return real_clone(self, *a, **k)
    real_update = ttr.apply_update

    def update(*a, **k):
        monkeypatch.setattr(torch.Tensor, "clone", clone)
        try:
            return real_update(*a, **k)
        finally:
            monkeypatch.setattr(torch.Tensor, "clone", real_clone)
    monkeypatch.setattr(ttr, "apply_update", update)
    n0 = U.adam_update.launches
    for _ in range(3):
        state, m = step(state, batch)
        assert int(m["nonfinite_skipped"]) == 0
    torch.cuda.synchronize()
    assert U.adam_update.launches - n0 == 6
    assert not state_ptrs & set(cloned)
    assert int(state.step) == 3
    for g in state.opt_state.param_groups:
        assert float(state.opt_state.state[g["params"][0]]["step"]) == 3.0
