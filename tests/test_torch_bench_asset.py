"""Port parity: the bench asset's recipe (``python -m
gsplat_tpu_torch.make_bench_asset``) against ``scripts/make_bench_asset.sh``.

* ``RECIPE_FLAGS`` are the shell script's ``train_synthetic`` flags, so
  the two recipes cannot drift apart;
* at a tiny size on the CPU (2 iterations, 200 GT gaussians, 2 views at
  32x48), the shell script's own strip step (its ``python -`` heredoc, run
  in a temporary directory, where it writes ``bench_assets/``) and
  ``strip_checkpoint`` write the same members from one
  ``checkpoint_final.npz``, bit for bit, and the JAX package's and the
  port's ``restore_pool`` read the port's asset alike (exact);
* ``build`` refuses the repository's ``bench_assets/`` before it trains.

The full recipe needs the card (``tests/test_torch_gpu_flows.py``); ``fit()``'s
parity with JAX, its ADC counts included, is ``tests/test_torch_fit.py``'s.
"""

import os
import shlex
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import gsplat_tpu.train.trainer as jtrainer
from gsplat_tpu_torch import make_bench_asset, train_synthetic
from gsplat_tpu_torch.models.gaussians import PARAM_KEYS
from gsplat_tpu_torch.train.trainer import restore_pool

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "make_bench_asset.sh")
JAX_ASSET = os.path.join(ROOT, "bench_assets", "trained_ckpt.npz")
TINY = dict(iterations=2, capacity=1024, gt_gaussians=200, views=2,
            height=32, width=48, max_pairs=16384)


def _shell_flags():
    """The flags the shell script passes to train_synthetic.py, up to its
    ``--output_dir``."""
    with open(SCRIPT) as f:
        text = f.read().replace("\\\n", " ")
    line = next(s for s in text.splitlines()
                if "scripts/train_synthetic.py" in s)
    tokens = shlex.split(line)
    flags = tokens[tokens.index("scripts/train_synthetic.py") + 1:]
    return tuple(flags[:flags.index("--output_dir")])


def _shell_strip():
    """The shell script's strip step: its heredoc between <<'PY' and PY."""
    with open(SCRIPT) as f:
        text = f.read()
    return text.split("<<'PY'\n", 1)[1].split("\nPY\n", 1)[0] + "\n"


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    d = tmp_path_factory.mktemp("asset")
    res = make_bench_asset.build(d / "run", d / "asset.npz", device="cpu",
                                 **TINY)
    return d, res


def test_recipe_flags_are_the_shell_scripts():
    assert make_bench_asset.RECIPE_FLAGS == _shell_flags()
    assert "--iterations" in make_bench_asset.RECIPE_FLAGS


def test_strip_matches_the_shell_scripts_strip(built, tmp_path):
    d, res = built
    run = subprocess.run([sys.executable, "-", str(d / "run")],
                         input=_shell_strip(), text=True, cwd=tmp_path,
                         capture_output=True, check=True)
    theirs = tmp_path / "bench_assets" / "trained_ckpt.npz"
    assert f"({res['alive']} alive gaussians)" in run.stdout
    # Each member's .npy bytes (header: dtype and shape; data), in order.
    with zipfile.ZipFile(theirs) as a, zipfile.ZipFile(d / "asset.npz") as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    with np.load(theirs) as a, np.load(d / "asset.npz") as b:
        assert sorted(b.files) == sorted(
            ["__alive__", "__step__", "__num_opt_leaves__"]
            + [f"param_{k}" for k in PARAM_KEYS])
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
        assert int(b["__step__"]) == TINY["iterations"]
        assert b["__num_opt_leaves__"] == np.int32(0)
        assert b["__alive__"].shape == (TINY["capacity"],)


def test_both_packages_restore_the_ports_asset(built):
    d, res = built
    path = str(d / "asset.npz")
    jpool = jtrainer.restore_pool(path)
    tpool = restore_pool(path, device="cpu")
    np.testing.assert_array_equal(tpool.alive.numpy(),
                                  np.asarray(jpool.alive))
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(tpool.params[k].detach().numpy(),
                                      np.asarray(jpool.params[k]))
    assert int(tpool.alive.sum()) == res["alive"] == res["gaussians"]
    assert np.isfinite(res["psnr"]) and res["out"] == path


def test_cli_writes_the_asset_in_its_workdir(monkeypatch, tmp_path):
    tiny = make_bench_asset._argv("", TINY)[:-2]
    monkeypatch.setattr(make_bench_asset, "RECIPE_FLAGS", tuple(tiny))
    res = make_bench_asset.main([str(tmp_path / "w"), "--device", "cpu"])
    out = tmp_path / "w" / "trained_ckpt_torch.npz"
    assert res["out"] == str(out) and out.exists()
    assert (tmp_path / "w" / "checkpoint_final.npz").exists()


@pytest.mark.parametrize("out", [
    JAX_ASSET,
    os.path.join(ROOT, "bench_assets", "..", "bench_assets",
                 "trained_ckpt.npz"),
    os.path.join(ROOT, "bench_assets", "trained_ckpt_torch.npz"),
])
def test_build_refuses_the_jax_assets_folder(monkeypatch, tmp_path, out):
    """Before any training, and the JAX asset's file is left as it was."""
    before = os.stat(JAX_ASSET).st_mtime_ns
    with open(JAX_ASSET, "rb") as f:
        data = f.read()

    def trained(argv=None):
        raise AssertionError("build trained before it refused")

    monkeypatch.setattr(train_synthetic, "main", trained)
    with pytest.raises(ValueError, match="bench_assets"):
        make_bench_asset.build(tmp_path / "run", out, device="cpu", **TINY)
    with pytest.raises(ValueError, match="bench_assets"):
        make_bench_asset.main([str(tmp_path / "run"), "--out", out,
                               "--device", "cpu"])
    assert not (tmp_path / "run").exists()
    assert not os.path.exists(
        os.path.join(ROOT, "bench_assets", "trained_ckpt_torch.npz"))
    assert os.stat(JAX_ASSET).st_mtime_ns == before
    with open(JAX_ASSET, "rb") as f:
        assert f.read() == data
