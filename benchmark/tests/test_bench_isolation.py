"""Nothing the benchmark runs loads JAX or the JAX package: the check on
``sys.modules`` compares top-level names whole, no file of the benchmark
imports them, the reference imports nothing of the program, each model
imports the program only inside the functions its docstring lists as
program-side, and a run in a directory without the program exits
non-zero with no result."""

from __future__ import annotations

import ast
import re
import shutil
import subprocess
import sys

from conftest import ROOT

from benchmark.isolation import FORBIDDEN, forbidden_modules

BENCH = ROOT / "benchmark"
PROGRAM = "gsplat_tpu_torch"
MODELS = [*sorted((BENCH / "models").glob("*.py")),
          BENCH / "tests" / "gs3d_mip.py"]


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


def _module_file(name: str):
    """The file of module ``name`` in the repository, or None."""
    base = ROOT.joinpath(*name.split("."))
    for path in (base.with_suffix(".py"), base / "__init__.py"):
        if path.is_file():
            return path
    return None


def _imported(path, node) -> list:
    """The modules an import statement of ``path`` loads, by full name
    (each ``from m import n`` also as ``m.n``, in case ``n`` is one)."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if node.level:
        pkg = path.relative_to(ROOT).parent.parts
        pkg = pkg[:len(pkg) - node.level + 1]
        base = ".".join(pkg + tuple(filter(None, [node.module])))
    else:
        base = node.module
    return [base] + [f"{base}.{a.name}" for a in node.names]


def _top_level_imports(path) -> list:
    """Modules imported outside every function of ``path``."""
    out = []

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                out.extend(_imported(path, child))
            visit(child)

    visit(ast.parse(path.read_text()))
    return out


def _loads_the_program(modules, seen=None) -> bool:
    """Whether importing ``modules`` loads the program: directly, or
    through a module of the repository (its packages included) that
    does so outside its functions."""
    seen = set() if seen is None else seen
    for name in modules:
        parts = name.split(".")
        if parts[0] == PROGRAM:
            return True
        for k in range(1, len(parts) + 1):
            path = _module_file(".".join(parts[:k]))
            if path is None or path in seen:
                continue
            seen.add(path)
            if _loads_the_program(_top_level_imports(path), seen):
                return True
    return False


def test_the_reference_imports_nothing_of_the_program():
    """Nothing but the standard library, torch, numpy and the reference
    itself, anywhere in a file of ``reference/``."""
    for path in (BENCH / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            for m in _imported(path, node):
                top = m.split(".", 1)[0]
                assert (top in sys.stdlib_module_names
                        or top in ("torch", "numpy")
                        or m.startswith("benchmark.reference")), (path, m)


def _sides(doc: str) -> dict:
    """{"Program", "Reference"}: the names a model's docstring lists
    after "Program side" and "Reference side", to the next blank line."""
    out = {}
    for side in ("Program", "Reference"):
        m = re.search(side + r" side[^:]*:(.*?)(?:\n\s*\n|\Z)", doc, re.S)
        assert m, f"no {side.lower()} side listed"
        out[side] = set(re.findall(r"``(\w+)``", m.group(1)))
    return out


def test_models_import_the_program_only_on_their_program_side():
    assert BENCH / "models" / "gs3d.py" in MODELS
    for path in MODELS:
        tree = ast.parse(path.read_text())
        sides = _sides(ast.get_docstring(tree))
        assert sides["Program"] and sides["Reference"], path
        assert not sides["Program"] & sides["Reference"], path
        assert not _loads_the_program(_top_level_imports(path)), path
        defined = {t.id for n in tree.body if isinstance(n, ast.Assign)
                   for t in n.targets if isinstance(t, ast.Name)}
        defined |= {a.asname or a.name for n in tree.body
                    if isinstance(n, ast.ImportFrom) for a in n.names}
        for fn in tree.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            defined.add(fn.name)
            inside = [m for node in ast.walk(fn)
                      if isinstance(node, (ast.Import, ast.ImportFrom))
                      for m in _imported(path, node)]
            if _loads_the_program(inside):
                assert fn.name in sides["Program"], (path, fn.name)
            if not fn.name.startswith("_"):
                assert fn.name in sides["Program"] | sides["Reference"], (
                    path, fn.name)
        assert sides["Program"] | sides["Reference"] <= defined, path


def test_the_import_check_sees_the_program():
    assert _loads_the_program(["gsplat_tpu_torch.viewer"])
    assert _loads_the_program(["benchmark.tests.gs3d_mip.nothing",
                               "gsplat_tpu_torch"])
    assert not _loads_the_program(["benchmark.harness", "torch"])
    assert not _loads_the_program(["benchmark.reference.render"])
