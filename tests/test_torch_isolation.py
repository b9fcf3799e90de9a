"""The port stands alone: no module of gsplat_tpu_torch, nor the card
tests (the machine with the card has no JAX), imports JAX (jax, jaxlib,
optax, orbax) or the JAX package gsplat_tpu."""

import ast
import os

import pytest
import torch

# One intra-op thread: the suite's xdist workers run side by side, and
# torch's default of one thread per core each oversubscribes the CPU.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "optax", "orbax", "gsplat_tpu"}


def _sources():
    tests = os.path.join(ROOT, "tests")
    out = [os.path.join(tests, f) for f in os.listdir(tests)
           if f.endswith(".py") and (f.startswith("test_torch_gpu")
                                     or f == "torch_card_cases.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "gsplat_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_found():
    srcs = _sources()
    assert len(srcs) > 10
    assert any(p.endswith("raster_cuda.py") for p in srcs)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_gsplat_tpu_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_bench_imports_neither_jax_nor_the_root_bench():
    """The port's bench stands alone: it imports neither JAX nor the JAX
    package, nor the root ``bench.py`` it is the counterpart of (which
    imports JAX inside its functions)."""
    path = os.path.join(ROOT, "gsplat_tpu_torch", "bench.py")
    mods = list(_imports(path))
    assert "torch" in mods
    bad = [m for m in mods if m.split(".")[0] in FORBIDDEN | {"bench"}]
    assert not bad, f"gsplat_tpu_torch/bench.py imports {bad}"
