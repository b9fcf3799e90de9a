"""Make the trained-distribution checkpoint the serving benchmark renders:
train the synthetic recipe in full, then strip the optimizer state.

Counterpart of ``scripts/make_bench_asset.sh`` (the recipe that made
``bench_assets/trained_ckpt.npz``). Run as

    python -m gsplat_tpu_torch.make_bench_asset [workdir] [--out PATH]

The training run writes its checkpoints into ``workdir`` (default
``bench_asset_run_torch`` in the temporary directory, ``$TMPDIR`` or
``/tmp``) and the stripped asset goes to ``--out``
(default ``<workdir>/trained_ckpt_torch.npz``). It never writes into the
repository's ``bench_assets/``: the JAX package's asset there stays as
it is. Like the shell script it takes no size flags.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from . import train_synthetic
from .device import resolve_device

# The train_synthetic flags of scripts/make_bench_asset.sh, verbatim.
RECIPE_FLAGS = (
    "--iterations", "800", "--capacity", "131072",
    "--gt_gaussians", "120000", "--gt_clusters", "400", "--gt_scale", "-3.5",
    "--height", "540", "--width", "960", "--max_pairs", "2097152",
    "--views", "16",
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_ASSETS = os.path.join(REPO_ROOT, "bench_assets")


def strip_checkpoint(src, dst):
    """Write ``src``'s pool without its optimizer state to ``dst``, as the
    shell script's strip does: the ``param_*`` arrays and ``__alive__`` in
    the file's order, ``__step__``, and ``__num_opt_leaves__`` 0
    (``np.savez_compressed``). Returns the written arrays."""
    with np.load(src) as d:
        keep = {k: d[k] for k in d.files
                if k.startswith("param_") or k == "__alive__"}
        keep["__step__"] = d["__step__"]
    keep["__num_opt_leaves__"] = np.int32(0)
    np.savez_compressed(dst, **keep)
    return keep


def _inside(path, root):
    path, root = os.path.realpath(path), os.path.realpath(root)
    return os.path.commonpath([path, root]) == root


def _argv(workdir, overrides):
    """RECIPE_FLAGS with each ``name=value`` of ``overrides`` replacing the
    value of the recipe's ``--name``, then ``--output_dir workdir``."""
    argv = list(RECIPE_FLAGS)
    for name, value in overrides.items():
        argv[argv.index(f"--{name}") + 1] = str(value)
    return argv + ["--output_dir", os.fspath(workdir)]


def build(workdir, out, device="cuda", **overrides):
    """Train the recipe into ``workdir`` and strip its final checkpoint into
    ``out``. ``overrides`` (``iterations=2``, ...) change the recipe's flags
    for tests at a small size. Raises, before anything is trained, when
    ``out`` or ``workdir`` lies in the repository's ``bench_assets/``, and
    without a card unless ``device="cpu"``. Returns
    ``train_synthetic.main``'s result with ``alive`` (the asset's alive
    count) and ``out``."""
    for what, path in (("out", out), ("workdir", workdir)):
        if _inside(path, BENCH_ASSETS):
            raise ValueError(
                f"{what} {os.fspath(path)!r} lies in {BENCH_ASSETS}, the JAX "
                f"package's benchmark assets; write the port's asset "
                f"elsewhere")
    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    result = train_synthetic.main(
        _argv(workdir, overrides) + ["--device", str(dev)])
    keep = strip_checkpoint(os.path.join(workdir, "checkpoint_final.npz"),
                            out)
    alive = int(keep["__alive__"].sum())
    print(f"wrote {os.fspath(out)} ({alive} alive gaussians)")
    return dict(result, alive=alive, out=os.fspath(out))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workdir", nargs="?", default=os.path.join(
        tempfile.gettempdir(), "bench_asset_run_torch"))
    p.add_argument("--out", default=None,
                   help="the stripped asset (default "
                        "<workdir>/trained_ckpt_torch.npz)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    out = args.out or os.path.join(args.workdir, "trained_ckpt_torch.npz")
    return build(args.workdir, out, device=args.device)


if __name__ == "__main__":
    main()
