"""The training update over every leaf of the optimizer at once: the
position gradient's L2 clip, dead slots' gradients zeroed, the NaN guard
and Adam.

``torch.optim.Adam`` stays the state's container: its groups (one leaf
each, named by ``group["name"]``), ``exp_avg``, ``exp_avg_sq`` and
``step`` count tensors are read and written in place, so checkpoints,
growth and the ADC's moment resets see the same objects. Its ``step()``
is not called. :func:`adam_update` on CUDA tensors launches the two
kernels of ``csrc/update.cu`` (U1 checks the gradients, U2 applies the
step), counted in ``adam_update.launches``, or raises; on CPU tensors it
runs :func:`adam_update_plain`, which repeats their arithmetic with
PyTorch operations (PyTorch's capturable single-tensor Adam, operation by
operation) and equals them bit for bit on the card.

The step, for the leaves' gradients ``g`` and the pool's ``alive`` mask:

* the position gradient's norm over every slot (its sum of squares in
  float64), ``scale = min(grad_clip_pos / (norm + 1e-6), 1)``, and the
  position gradient times ``scale``;
* each pool leaf's gradient zeroed where its slot is dead (a slot is a
  row of ``numel / capacity`` floats); the decoder's leaves have no slots;
* with the guard, the step is skipped, nothing written but the position
  gradient, when the loss or one of those clipped, masked gradients is
  non-finite (an alive row's element, any decoder element, or a NaN in
  the position gradient while some slot is alive);
* Adam from the leaf's count plus one, which it then becomes.

The position gradient is left clipped and masked in place (the step's
``pos_grad``); the other gradients are left as they came.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import DECODER_KEYS

_MAX_LEAVES = 9  # csrc/update.cu's kMaxLeaves


class _Leaf(ctypes.Structure):
    _fields_ = [("param", ctypes.c_void_p), ("grad", ctypes.c_void_p),
                ("exp_avg", ctypes.c_void_p), ("exp_avg_sq", ctypes.c_void_p),
                ("count", ctypes.c_void_p), ("lr_ptr", ctypes.c_void_p),
                ("numel", ctypes.c_longlong), ("lr", ctypes.c_double),
                ("beta1", ctypes.c_double), ("beta2", ctypes.c_double),
                ("eps", ctypes.c_double), ("per_slot", ctypes.c_int),
                ("vec", ctypes.c_int)]


class _Table(ctypes.Structure):
    _fields_ = [("leaf", _Leaf * _MAX_LEAVES), ("alive", ctypes.c_void_p),
                ("loss", ctypes.c_void_p), ("n", ctypes.c_int),
                ("pos", ctypes.c_int), ("max_norm", ctypes.c_float),
                ("guard", ctypes.c_int), ("slots", ctypes.c_int)]


def _groups(opt: torch.optim.Adam, grads: dict):
    """[(name, param, grad, state, group)] in the optimizer's order; raises
    for what the update does not implement."""
    out = []
    for group in opt.param_groups:
        for flag in ("amsgrad", "maximize", "differentiable"):
            if group.get(flag):
                raise ValueError(f"the update does not implement Adam's "
                                 f"{flag}")
        if group.get("weight_decay", 0) != 0:
            raise ValueError("the update does not implement Adam's "
                             "weight_decay")
        if not group["betas"][0] > 0.5:
            raise ValueError("the update takes beta1 above 0.5 (lerp's "
                             "small-weight branch)")
        if len(group["params"]) != 1:
            raise ValueError("the update takes one leaf a group")
        p = group["params"][0]
        out.append((group["name"], p, grads[group["name"]], opt.state[p],
                    group))
    if "pos" not in [name for name, *_ in out]:
        raise ValueError("the update needs the position leaf ('pos')")
    return out


def _f64(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a float or a [] tensor) as a float64 tensor beside ``like``:
    a true division by it (a float over a tensor would multiply by the
    tensor's reciprocal)."""
    return torch.as_tensor(x, dtype=torch.float64, device=like.device)


def _rows(t: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """``alive`` shaped to broadcast over ``t``'s rows (its slots)."""
    return alive.reshape((-1,) + (1,) * (t.dim() - 1))


@torch.no_grad()
def adam_update_plain(opt, grads, alive, loss, grad_clip_pos,
                      shard_sum=None, grid_max=None, nan_guard=True):
    """The update with PyTorch operations, as U1 and U2 compute it: the flag
    and the norm first, then each leaf's new values written through
    ``torch.where(finite, new, old)`` (no clone). Arguments and return as
    :func:`adam_update`'s."""
    leaves = _groups(opt, grads)
    g = grads["pos"]
    sq = torch.sum(torch.square(g.to(torch.float64))).to(torch.float32)
    bad = ~torch.isfinite(loss) | (torch.isnan(sq) & torch.any(alive))
    for name, _, grad, _, _ in leaves:
        nonfinite = ~torch.isfinite(grad)
        if name not in DECODER_KEYS:
            nonfinite = nonfinite & _rows(grad, alive)
        bad = bad | torch.any(nonfinite)
    flag = bad.to(torch.float32).reshape(1)
    sq = sq.reshape(1)
    if shard_sum is not None:
        sq = shard_sum(sq)
    if nan_guard and grid_max is not None:
        flag = grid_max(flag)
    finite = flag[0] == 0
    keep = finite if nan_guard else torch.ones_like(finite)
    scale = torch.clamp(grad_clip_pos / (torch.sqrt(sq[0]) + 1e-6), max=1.0)
    for name, p, grad, st, group in leaves:
        x = grad * scale if name == "pos" else grad
        if name not in DECODER_KEYS:
            x = torch.where(_rows(x, alive), x, 0.0)
        if name == "pos":
            grad.copy_(x)
        beta1, beta2 = group["betas"]
        count = st["step"] + 1
        # The bias corrections in float64, as Adam works them out on the
        # host, then the two scalars of the denominator in float32.
        c = count.to(torch.float64)
        bc1 = 1 - beta1 ** c
        bc2 = 1 - beta2 ** c
        ssn = -(_f64(group["lr"], c) / bc1)
        d1 = (bc2.sqrt() * ssn).to(torch.float32)
        e = (_f64(group["eps"], c) / ssn).to(torch.float32)
        m = st["exp_avg"].lerp(x, 1 - beta1)
        v = st["exp_avg_sq"].mul(beta2).addcmul_(x, x, value=1 - beta2)
        new = p.addcdiv(m, (v.sqrt() / d1).add_(e))
        for old, val in ((p, new), (st["exp_avg"], m),
                         (st["exp_avg_sq"], v), (st["step"], count)):
            old.copy_(torch.where(keep.to(old.device), val, old))
    return torch.where(keep, 0, 1).to(torch.int32), grads["pos"]


def adam_update(opt, grads, alive, loss, grad_clip_pos, shard_sum=None,
                grid_max=None, nan_guard=True):
    """One update of ``opt``'s leaves from ``grads`` ({group name:
    gradient}), in place. ``alive`` [capacity] bool marks the pool's live
    slots; ``loss`` is the step's [] f32 loss. On a gaussian-sharded pool
    ``shard_sum`` (an in-place SUM over the shards) makes the clip's sum
    of squares the whole pool's and ``grid_max`` (an in-place MAX over
    every rank that applies the update) decides the guard over all of
    them, between U1 and U2. With ``nan_guard`` off a non-finite step is
    applied. Returns (skipped: [] int32, 1 where the guard skipped the
    step; the clipped, masked position gradient, ``grads["pos"]``).

    CPU tensors take :func:`adam_update_plain`; CUDA tensors launch U1 and
    U2 (``csrc/update.cu``), counted in ``adam_update.launches``, or
    raise."""
    dev = opt.param_groups[0]["params"][0].device
    if dev.type == "cpu":
        return adam_update_plain(opt, grads, alive, loss, grad_clip_pos,
                                 shard_sum, grid_max, nan_guard)
    leaves = _groups(opt, grads)
    if len(leaves) > _MAX_LEAVES:
        raise ValueError(f"{len(leaves)} leaves: the update takes at most "
                         f"{_MAX_LEAVES}")
    _check(alive, "alive", dev, torch.bool, alive.shape)
    _check(loss, "loss", dev, torch.float32, ())
    capacity = alive.numel()
    if capacity >= 2**31:
        raise ValueError(f"{capacity} slots: the update indexes with int32")
    table = _Table(alive=alive.data_ptr(), loss=loss.data_ptr(),
                   n=len(leaves), max_norm=grad_clip_pos,
                   guard=int(bool(nan_guard)), slots=capacity)
    for i, (name, p, grad, st, group) in enumerate(leaves):
        for label, t in (("param", p), ("grad", grad),
                         ("exp_avg", st["exp_avg"]),
                         ("exp_avg_sq", st["exp_avg_sq"])):
            _check(t, f"{name}'s {label}", dev, torch.float32, p.shape)
        _check(st["step"], f"{name}'s step count", dev, torch.float32, ())
        if p.numel() >= 2**31:
            raise ValueError(f"{name} has {p.numel()} floats: the update "
                             f"indexes a leaf with int32")
        per_slot = 0
        if name not in DECODER_KEYS:
            if p.shape[0] != capacity:
                raise ValueError(f"{name} has {p.shape[0]} rows for "
                                 f"{capacity} slots")
            per_slot = p.numel() // max(capacity, 1)
        lr = group["lr"]
        if isinstance(lr, torch.Tensor):
            _check(lr, f"{name}'s lr", dev, torch.float32, ())
        beta1, beta2 = group["betas"]
        ptrs = [t.data_ptr() for t in (p, grad, st["exp_avg"],
                                       st["exp_avg_sq"])]
        table.leaf[i] = _Leaf(
            *ptrs, count=st["step"].data_ptr(),
            lr_ptr=lr.data_ptr() if isinstance(lr, torch.Tensor) else None,
            numel=p.numel(),
            lr=0.0 if isinstance(lr, torch.Tensor) else lr, beta1=beta1,
            beta2=beta2, eps=group["eps"], per_slot=per_slot,
            vec=int(all(a % 16 == 0 for a in ptrs)))
        if name == "pos":
            table.pos = i
    lib = _library()
    work = _work(dev, lib)
    skipped = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.update_check(ctypes.byref(table), work.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"update_check launch failed: CUDA error "
                               f"{err}")
        adam_update.launches += 1
        if shard_sum is not None:
            shard_sum(work[1:2])
        if nan_guard and grid_max is not None:
            grid_max(work[0:1])
        err = lib.update_apply(ctypes.byref(table), work.data_ptr(),
                               skipped.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"update_apply launch failed: CUDA error {err}")
    adam_update.launches += 1
    return skipped, grads["pos"]


adam_update.launches = 0  # update_check and update_apply launches


def _check(t: torch.Tensor, name: str, dev, dtype, shape):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {list(shape)} {dtype} on "
                         f"{dev}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")


_works: dict = {}


def _work(dev: torch.device, lib) -> torch.Tensor:
    """The device's work buffer (U1's flag, sum, per-leaf scalars, block
    partials and completion counter), made zeroed once and kept: U1 leaves
    its counter at 0, so no launch clears it. The flag and the sum are its
    floats 0 and 1."""
    w = _works.get(dev)
    if w is None:
        w = torch.zeros(lib.update_work_bytes() // 4, dtype=torch.float32,
                        device=dev)
        _works[dev] = w
    return w


def _library():
    from ._build import load_library

    lib = load_library("update")
    if lib.update_table_bytes() != ctypes.sizeof(_Table):
        raise RuntimeError("csrc/update.cu's leaf table does not match "
                           "ops/update.py's")
    return lib
