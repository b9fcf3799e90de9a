"""Port parity: the package's public names, the kernel build cache and the
comm model's command line.

* Every name the JAX package's top level exports (its imports from its
  submodules, ``__version__``, and the submodules its ``__getattr__``
  gives lazily) resolves in the port, and ``HARMONICS`` equals JAX's.
* ``utils.enable_compilation_cache`` moves the kernel builds: an argument,
  else ``GSPLAT_CACHE_DIR``, else the package's ``_build/``;
  ``GSPLAT_NO_CACHE=1`` a temporary directory of this process. The CLIs
  the JAX scripts give a cache call call it at startup.
* ``python -m gsplat_tpu_torch.comm_model`` runs without a card.
"""

import ast
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import gsplat_tpu
import gsplat_tpu_torch as gt
from gsplat_tpu_torch.ops import _build
from gsplat_tpu_torch.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]


def _jax_top_level_names():
    tree = ast.parse((ROOT / "gsplat_tpu" / "__init__.py").read_text())
    names = {"__version__"}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names.update(a.asname or a.name for a in node.names)
        if isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Tuple):
                    names.update(e.value for e in sub.elts
                                 if isinstance(e, ast.Constant))
    return names


def test_every_jax_top_level_name_resolves_in_the_port():
    names = _jax_top_level_names()
    assert {"HARMONICS", "evaluate_sh", "l1_loss", "ssim_loss",
            "quat_to_rotmat", "scale_intrinsics", "data", "viewer"} <= names
    missing = [n for n in sorted(names) if not hasattr(gt, n)]
    assert not missing, missing
    assert gt.HARMONICS == gsplat_tpu.HARMONICS
    assert gt.viewer is importlib.import_module("gsplat_tpu_torch.viewer")
    with pytest.raises(AttributeError):
        gt.not_a_submodule  # noqa: B018


def test_build_directory_follows_the_cache_variables(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    monkeypatch.delenv("GSPLAT_NO_CACHE", raising=False)
    monkeypatch.delenv("GSPLAT_CACHE_DIR", raising=False)
    default = Path(gt.__file__).resolve().parent / "_build"
    assert compile_cache.enable_compilation_cache() == str(default)
    assert _build.BUILD_ROOT == default
    monkeypatch.setenv("GSPLAT_CACHE_DIR", str(tmp_path / "env"))
    from gsplat_tpu_torch.utils import enable_compilation_cache

    assert enable_compilation_cache() == str(tmp_path / "env")
    assert _build._target_dir("raster_fwd").parent == tmp_path / "env"
    # An argument wins over the variable.
    compile_cache.enable_compilation_cache(str(tmp_path / "arg"))
    assert _build._target_dir("raster_bwd").parent == tmp_path / "arg"
    # No cache: one temporary directory for this process.
    monkeypatch.setenv("GSPLAT_NO_CACHE", "1")
    a = compile_cache.enable_compilation_cache()
    assert a == compile_cache.enable_compilation_cache(str(tmp_path / "x"))
    assert Path(a).is_dir() and Path(a) != default
    assert not Path(a).is_relative_to(tmp_path)
    assert _build.BUILD_ROOT == Path(a)


@pytest.mark.parametrize("cli", ["train.__main__", "evaluate",
                                 "eval_checkpoint", "inference",
                                 "render_trained", "bench"])
def test_clis_enable_the_cache_at_startup(cli, monkeypatch):
    calls = []
    monkeypatch.setattr(compile_cache, "enable_compilation_cache",
                        lambda *a: calls.append(a))
    main = importlib.import_module(f"gsplat_tpu_torch.{cli}").main
    with pytest.raises(SystemExit):
        main(["--help"])
    assert calls == [()]


def test_comm_model_runs_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "gsplat_tpu_torch.comm_model",
                          "--json"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    rows = json.loads(out.strip().splitlines()[-1])
    assert {r["family"] for r in rows} == {"band", "gauss", "ring", "serve"}
    assert all(r["step_ms"] is None and r["comm_ms"] > 0 for r in rows)
    comm_model = importlib.import_module("gsplat_tpu_torch.comm_model")
    with_step = comm_model.main(["--step_ms_per_view", "20", "--json"])
    effs = [r["eff"] for r in with_step if r["eff"] is not None]
    assert effs and all(0 < e <= 1 for e in effs)
