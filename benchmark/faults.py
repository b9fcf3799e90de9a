"""Faults planted in the timed path, to show that the comparison turns
``correct`` false (``tests/test_bench_correct.py``, and
``readings.py --fault`` for a fault's reading at a cell's own size).

* ``unchanged``: a training step that computes the loss and returns its
  state unchanged (no update);
* ``altered``: every served frame altered where it is produced (one
  tile's pixels raised by 0.05).

Each replaces one of the program's factories, passed to
``harness.run_cell`` as ``hooks``."""

from __future__ import annotations


def unchanged_step(render_cfg, train_cfg):
    from gsplat_tpu_torch.train.trainer import value_and_grads

    def step(state, batch):
        loss, metrics, _ = value_and_grads(state, batch, render_cfg,
                                           train_cfg)
        metrics["total"] = loss
        return state, metrics
    return step


def altered_frames(*args, **kw):
    from gsplat_tpu_torch.viewer import make_render_fn

    fn = make_render_fn(*args, **kw)

    def altered(c2w):
        img, probe = fn(c2w)
        img = img.clone()
        img[:16, :16] += 0.05
        return img, probe
    return altered


FAULTS = {"unchanged": {"make_train_step": unchanged_step},
          "altered": {"make_render_fn": altered_frames}}


def hooks(name: str) -> dict:
    """The hooks of fault ``name``."""
    return FAULTS[name]
