"""The check that nothing the benchmark runs has loaded JAX or the JAX
package. Module names are compared by their top-level name whole (the part
before the first dot): ``gsplat_tpu_torch`` begins with ``gsplat_tpu``
and is the program, not the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "gsplat_tpu")


def forbidden_modules(modules=None) -> list:
    """Sorted top-level names of loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops & set(FORBIDDEN))
