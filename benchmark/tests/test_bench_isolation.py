"""Nothing the benchmark runs loads JAX or the JAX package: the check on
``sys.modules`` compares top-level names whole, no file of the benchmark
imports them, the reference imports nothing of the program, and a run in
a directory without the program exits non-zero with no result."""

from __future__ import annotations

import ast
import shutil
import subprocess
import sys

from conftest import ROOT

from benchmark.isolation import FORBIDDEN, forbidden_modules

BENCH = ROOT / "benchmark"


def test_top_level_names_are_compared_whole():
    assert forbidden_modules({"jax": 0, "jax.numpy": 0}) == ["jax"]
    assert forbidden_modules({"jaxlib.xla_client": 0}) == ["jaxlib"]
    assert forbidden_modules({"flax.linen": 0}) == ["flax"]
    assert forbidden_modules({"gsplat_tpu": 0,
                              "gsplat_tpu.render": 0}) == ["gsplat_tpu"]
    assert forbidden_modules({"gsplat_tpu_torch": 0,
                              "gsplat_tpu_torch.render": 0,
                              "jaxtyping": 0, "numpy": 0}) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not tops & set(FORBIDDEN), path
        if "reference" in path.parts:
            assert "gsplat_tpu_torch" not in tops, path


def test_a_directory_without_the_program_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "data"))
    r = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "serve-ckpt120k-orbit", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode == 4, r.stderr
    assert r.stdout.strip() == ""
    assert "not in the checkout" in r.stderr
