"""The benchmark's one command, run from the root of a checkout:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process, one run of one cell of ``BENCHMARK.json``: set-up (timed as
``setup_s``), a warm-up of the cell's own shapes, the window of
``--seconds``, with ``--trace 1`` a traced stretch after it, then the
comparison with the plain reference that decides ``correct``. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each compared number with its limit, which also end
standard error).

It exits non-zero and prints no result where there is no CUDA card, or
fewer than the cell asks for; where the program is not in the checkout;
and where JAX, jaxlib, flax or the JAX package is loaded once the window
has closed. Kernel builds and caches stay in ``.bench_cache/`` inside the
checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import torch  # noqa: E402

from .isolation import forbidden_modules  # noqa: E402

PROGRAM = "gsplat_tpu_torch"


def fail(code: int, msg: str):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def card_label() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
        return out.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench_path = ROOT / "BENCHMARK.json"
    if not bench_path.exists():
        fail(2, f"no BENCHMARK.json at {ROOT}")
    bench = json.loads(bench_path.read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        fail(2, f"no workload {args.workload!r}")
    if not (ROOT / PROGRAM / "__init__.py").exists():
        fail(4, f"the program ({PROGRAM}/) is not in the checkout {ROOT}")
    if not torch.cuda.is_available():
        fail(3, "no CUDA card: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips[args.workload]:
        fail(3, f"{args.workload} needs {chips[args.workload]} cards, "
                f"{torch.cuda.device_count()} found")
    sys.path.insert(0, str(ROOT))
    from gsplat_tpu_torch.utils.compile_cache import \
        enable_compilation_cache

    enable_compilation_cache(str(CACHE / "kernels"))

    from . import harness

    cell = harness.Cell(bench, args.workload)
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", t_start=T_START)
    line["device"]["nvidia_smi"] = card_label()
    bad = forbidden_modules()
    if bad:
        fail(5, "loaded in the measured process: " + ", ".join(bad))
    print(f"correct: {line['correct']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
