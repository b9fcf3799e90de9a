"""Scaffold-GS (Lu et al., CVPR 2024, arXiv:2312.00109): anchors, each
decoded every view into ``n_offsets`` neural gaussians by three
view-conditioned MLPs, rendered by the 3DGS rasterizer with precomputed
colours; the gradient flows back through the MLPs into the anchors and
the MLP weights.

The scene is the configuration's anchors on mip360avg3m's garden layout,
drawn from the seed: the positions and first log-scale column of
``scenes.garden`` (all six scale columns equal to it), offsets and
features N(0, 1); the three MLPs drawn as ``torch.nn.Linear`` draws its
default (``reference/scaffold.py::init_mlps``) from the configuration's
own ``scene.mlp_seed``, as a trained network is fixed; all as leaves of
one dict (the MLPs flat). A "frame" is the rgb image [H, W, 3]: the ground
truth of training is the reference's frame of the unperturbed anchors.
Training perturbs the leaves the traffic names and trains every leaf but
the positions; the rates and the scaling term's weight are the traffic's
``train`` block's. The reference is ``reference/scaffold.py``.

Beside gs3d's three training numbers (over the trained leaves),
``train_numbers`` gives ``decode_max_gap`` (the first step's decoded
fields ``mu``, ``s``, ``q``, ``alpha``, colour of the slots both sides
keep, each field's largest difference over its largest magnitude in the
reference; infinite where the kept masks differ at a slot whose opacity
is 1e-6 or more from 0: the program's fields are decoded from the state
the first step starts from, at its view, by the program's own decode, the
reference's are its first step's) and ``mlp_grad_max_gap`` (each MLP
tensor's first gradient, ``W1``, ``b1``, ``W2``, ``b2`` of the three,
elementwise over the reference's largest).

Program side (they import ``gsplat_tpu_torch`` inside themselves, or read
what it made): ``_pool``, ``_scaffold_config``, ``program_pool``,
``program_train_pool``, ``render_config``, ``serve_entry``,
``train_entry``, ``first_grad``, ``trained_params``.

Reference side (the benchmark's own modules and torch; nothing of the
program): ``scene``, ``frame``, ``loss_grad``, ``optimizer``,
``frame_numbers``, ``train_numbers``.
"""

from __future__ import annotations

import torch

from benchmark import harness, poses, scenes
from benchmark.reference import compare
from benchmark.reference import render as ref
from benchmark.reference import scaffold as refsc

gs3d = harness.load_model("gs3d")
ANCHOR_KEYS = refsc.ANCHOR_KEYS
MLP_KEYS = refsc.MLP_KEYS
KEEP_TOL = 1e-6  # a slot whose opacity is this close to 0 may flip

# The first step's decoded fields for decode_max_gap: the program's
# ("program", from train_entry's step) and the reference's in each dtype
# (("reference", dtype), from loss_grad's first call after optimizer()).
_DECODED = {}


# -- the program ----------------------------------------------------------

def _split(params: dict):
    """(the pool's leaves, the MLPs)."""
    return ({k: params[k] for k in ANCHOR_KEYS},
            {k: params[k] for k in MLP_KEYS})


def _pool(params: dict, alive):
    # An anchor pool exists only where the program has anchors: a
    # program without them fails here, at once.
    from gsplat_tpu_torch.config import ScaffoldConfig  # noqa: F401
    from gsplat_tpu_torch.models.gaussians import GaussianPool

    leaves, mlps = _split(params)
    pool = GaussianPool({k: v.contiguous() for k, v in leaves.items()},
                        alive)
    pool.mlps = {k: v.contiguous() for k, v in mlps.items()}
    return pool


def program_pool(cell, seed: int, dev):
    """The program's anchor pool, as drawn; its MLPs in ``pool.mlps``."""
    return _pool(*scene(cell, seed, dev))


def program_train_pool(cell, seed: int, dev):
    """The pool training starts from: the leaves the mix names perturbed
    by the draws ``scenes.perturbed`` gives the reference."""
    params, alive = scene(cell, seed, dev)
    return _pool(scenes.perturbed(params, cell.mix["perturb"], seed), alive)


def render_config(cell, pool, cams):
    """(the program's ``RenderConfig``, the pair demand of each camera):
    gs3d's, the demand counted over the kept neural gaussians."""
    from gsplat_tpu_torch.config import RenderConfig
    from gsplat_tpu_torch.render import pair_demand

    mix = cell.mix
    cfg = RenderConfig(height=mix["height"], width=mix["width"],
                       **cell.config["render"])
    fx, fy, cx, cy = poses.intrinsics(mix)
    probe = cfg.with_(max_pairs=4096)
    params = {**pool.params, **pool.mlps}
    with torch.no_grad():
        dem = [int(pair_demand(params, c, fx, fy, cx, cy, probe,
                               alive=pool.alive)[0]) for c in cams]
    return cfg.with_(max_pairs=gs3d._rup(max(dem),
                                         mix["capacity_headroom"])), dem


def serve_entry(cell, pool, cfg, hooks: dict):
    """pose -> (rgb [H, W, 3], probe): ``viewer.make_render_fn`` over the
    anchors and their MLPs."""
    from gsplat_tpu_torch.viewer import make_render_fn

    fx, fy, cx, cy = poses.intrinsics(cell.mix)
    return hooks.get("make_render_fn", make_render_fn)(
        {**pool.params, **pool.mlps}, cfg, fx, fy, cx, cy, alive=pool.alive,
        report_demand=True)


def _scaffold_config(cell):
    import dataclasses

    from gsplat_tpu_torch.config import ScaffoldConfig

    names = {f.name for f in dataclasses.fields(ScaffoldConfig)}
    return ScaffoldConfig(**{k: v for k, v in cell.mix["train"].items()
                             if k in names})


def train_entry(cell, pool, cfg, views, gt, hooks: dict):
    """(state, step, batches): ``train.trainer.make_train_step`` at batch
    1, its state over the anchor pool with its MLPs and the mix's rates
    (``ScaffoldConfig``; the loss weights and Adam's eps in
    ``TrainConfig``), and one batch a view. The step's first call first
    decodes the state it starts from at its view (no autograd, the
    program's ``ops.scaffold.decode_view``) and keeps the fields on the
    host for ``decode_max_gap``."""
    import dataclasses

    from gsplat_tpu_torch.config import TrainConfig
    from gsplat_tpu_torch.ops.scaffold import decode_view
    from gsplat_tpu_torch.train.trainer import (init_train_state,
                                                make_train_step)

    mix = cell.mix
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    tcfg = TrainConfig(capacity=pool.capacity, batch_size=1,
                       **{k: v for k, v in mix["train"].items()
                          if k in names})
    state = init_train_state(pool, tcfg, decoder=pool.mlps,
                             scaffold=_scaffold_config(cell))
    inner = hooks.get("make_train_step", make_train_step)(cfg, tcfg)
    _DECODED.pop("program", None)

    def step(st, batch):
        if "program" not in _DECODED:
            with torch.no_grad():
                out = decode_view(
                    {**st.pool.params, **st.decoder}, batch["c2w"][0],
                    batch["fx"][0], batch["fy"][0], batch["cx"][0],
                    batch["cy"][0], cfg, st.pool.alive)
                _DECODED["program"] = dict(zip(
                    refsc.FIELDS + ("keep",), (x.cpu() for x in out)))
        return inner(st, batch)

    fx, fy, cx, cy = poses.intrinsics(mix)

    def batch(v):
        dev = gt[v].device
        return {"image": gt[v][None],
                "c2w": torch.from_numpy(views[v][None]).to(dev),
                **{k: torch.full((1,), x, dtype=torch.float32, device=dev)
                   for k, x in (("fx", fx), ("fy", fy), ("cx", cx),
                                ("cy", cy))}}

    return state, step, [batch(v) for v in range(len(views))]


def first_grad(state) -> dict:
    """The first gradient as Adam got it of every trained leaf (the pool's
    but the positions, and the MLPs): ``exp_avg / (1 - beta1)``, on the
    host."""
    opt = state.opt_state
    leaves = {**{k: p for k, p in state.pool.params.items() if k != "pos"},
              **state.decoder}
    return {name: (opt.state[p]["exp_avg"] / 0.1).detach().cpu()
            for name, p in leaves.items()}


def trained_params(state) -> dict:
    """A host copy of the anchors' leaves and the MLPs."""
    return {name: p.detach().to("cpu", copy=True)
            for name, p in {**state.pool.params, **state.decoder}.items()}


# -- the reference --------------------------------------------------------

def _sc(cell) -> refsc.Scaffold:
    return refsc.Scaffold.from_config(cell.config["published"],
                                      cell.mix.get("train"))


def scene(cell, seed: int, dev):
    """(params {leaf: float32 tensor}, alive) on ``dev``: the anchors and
    their MLPs (module docstring), drawn without the program."""
    n = int(cell.config["anchors"])
    sc = _sc(cell)
    g = scenes.garden(n, seed, dev)
    gen = scenes.generator(seed, "anchors", dev)
    params = {
        "pos": g["pos"],
        "offset": torch.randn(n, 3 * sc.n_offsets, generator=gen,
                              device=dev),
        "anchor_feat": torch.randn(n, sc.feat_dim, generator=gen,
                                   device=dev),
        "scale_raw": g["scale_raw"][:, :1].repeat(1, 6).contiguous(),
    }
    del g
    # The network is the configuration's, as a trained model's would be:
    # drawn from its own seed, so it does not move from run to run.
    net = scenes.generator(cell.config["scene"]["mlp_seed"], "anchors/mlp",
                           dev)
    params.update(refsc.init_mlps(sc, net, dev))
    return params, torch.ones(n, dtype=torch.bool, device=dev)


def _renderer(cell) -> ref.Renderer:
    return ref.Renderer.from_config(cell.config["render"])


def frame(cell, params, alive, cam, dtype=torch.float32,
          count_work: bool = False):
    """(the reference's rgb frame [H, W, 3], with ``count_work`` the work
    counts that ``counts/`` reads, ``scaffold_units`` (1) and the MLPs'
    widths included; else None)."""
    img, c = refsc.render(params, alive, cam, _renderer(cell), _sc(cell),
                          dtype, count_work)
    return img, (None if c is None else dict(c, scaffold_units=1))


def loss_grad(cell, params, alive, cam, target, dtype=torch.float32):
    """(loss, {leaf: gradient} of every leaf but the positions) of the
    frame against ``target``: L1 + D-SSIM with the mix's weights plus the
    scaling term. The first call after ``optimizer`` keeps its decoded
    fields."""
    loss, grads, fields = refsc.render_grad(
        params, alive, cam, _renderer(cell), _sc(cell), target,
        cell.mix["train"], dtype)
    key = ("reference", str(dtype))
    if key not in _DECODED:
        _DECODED[key] = {k: v.float().cpu() if v.is_floating_point()
                         else v.cpu() for k, v in fields.items()}
    return loss, grads


def optimizer(cell, start: dict, dtype=torch.float32) -> refsc.ScaffoldAdam:
    """Adam with the authors' rates (the mix's ``train`` block). The
    reference's steps in ``dtype`` start here: its fields kept before are
    let go."""
    _DECODED.pop(("reference", str(dtype)), None)
    return refsc.ScaffoldAdam(start, cell.mix["train"], dtype=dtype)


def frame_numbers(pairs) -> dict:
    """``pairs``: [(program frame, reference frame)], rgb [H, W, 3] each."""
    return compare.frame_numbers(pairs)


def _decode_gap() -> float:
    """The gap of the decoded fields in the program's place (the
    program's, or in the control the reference's in a lower precision) to
    the float32 reference's (module docstring)."""
    refd = _DECODED.pop(("reference", str(torch.float32)), None)
    prog = _DECODED.pop("program", None)
    low = [k for k in _DECODED if k[0] == "reference"]
    if prog is None and low:
        prog = _DECODED.pop(low[0])
    if prog is None or refd is None:
        return float("inf")
    differ = prog["keep"] != refd["keep"]
    if bool((differ & (refd["alpha"].abs() >= KEEP_TOL)).any()):
        return float("inf")
    both = prog["keep"] & refd["keep"]
    gap = 0.0
    for k in refsc.FIELDS:
        r, p = refd[k][both], prog[k][both].float()
        top = float(r.abs().max()) if r.numel() else 0.0
        d = float((p - r).abs().max()) if r.numel() else 0.0
        g = d / top if top > 0 else d
        gap = max(gap, g if g == g else float("inf"))
    return gap


def _mlp_gap(prog_g1, ref_g1, sc: refsc.Scaffold) -> float:
    gap = 0.0
    for k, shape in refsc.mlp_shapes(sc).items():
        for p, r in zip(refsc.split(prog_g1[k].float(), shape),
                        refsc.split(ref_g1[k].float(), shape)):
            top = float(r.abs().max())
            d = float((p - r).abs().max())
            g = d / top if top > 0 else d
            gap = max(gap, g if g == g else float("inf"))
    return gap


def train_numbers(prog_losses, ref_losses, prog_g1, ref_g1, prog_delta,
                  ref_delta) -> dict:
    """gs3d's three numbers over the trained leaves, ``decode_max_gap``
    and ``mlp_grad_max_gap`` (module docstring)."""
    trained = list(ref_g1)
    out = compare.train_numbers(
        prog_losses, ref_losses, {k: prog_g1[k] for k in trained}, ref_g1,
        {k: prog_delta[k] for k in trained},
        {k: ref_delta[k] for k in trained})
    out["decode_max_gap"] = _decode_gap()
    out["mlp_grad_max_gap"] = _mlp_gap(prog_g1, ref_g1,
                                       refsc.Scaffold(
                                           **_widths(ref_g1, prog_g1)))
    return out


def _widths(ref_g1, prog_g1) -> dict:
    """The widths of the MLPs the gradients belong to."""
    k = ref_g1["offset"].shape[1] // 3
    F = ref_g1["anchor_feat"].shape[1]
    m = k  # the opacity head's outputs
    n = ref_g1["mlp_opacity"].numel()
    h = (n - m) // (F + 4 + m)
    return {"feat_dim": F, "n_offsets": k, "hidden": h}
