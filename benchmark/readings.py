"""The readings that the limits of ``correct`` are set from, on the card
at a cell's own size (not run by the benchmark's own runs):

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds 2] [--detail 1]

For each seed of ``--seeds`` a whole run of the cell (short window) gives
the program's numbers; for each of ``--control-seeds`` the control gives
them: the reference computed in bfloat16, the precision below the
configuration's float32, put in the program's place and compared with
the float32 reference as the program is. One JSON line per reading.
``--fault <name>`` plants a fault of ``faults.py`` in the program's runs.
``--detail 1`` adds, for a training cell, each leaf's norms, the
elements whose first gradient is zero on one side only, and the change's
gap over every element (``delta_norm_gap_all_elements``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import faults, harness, poses
from .reference import compare


def control_serve(cell, seed, dev) -> dict:
    mix, model = cell.mix, cell.model
    params, alive = model.scene(cell, seed, dev)
    center, radius = harness._center_radius(params, alive)
    path = poses.path_poses(mix["path"], center, radius)
    off = poses.start(len(path), seed)
    pairs = []
    for k in poses.sample(mix["compare_frames"], len(path), seed):
        cam = harness._camera(mix, path[(off + k) % len(path)])
        low = model.frame(cell, params, alive, cam, dtype=torch.bfloat16)[0]
        pairs.append((low, model.frame(cell, params, alive, cam)[0]))
    return model.frame_numbers(pairs)


def reference_steps(cell, seed, dev, dtype, steps=3):
    """(losses, first gradient, change over the steps) of the reference in
    ``dtype`` from the cell's inputs."""
    views, gt, order = harness._train_inputs(cell, seed, dev)
    losses, g1, _, _, delta = harness.reference_steps(
        cell, seed, dev, views, gt, order, dtype, steps)
    return losses, g1, delta


def control_train(cell, seed, dev) -> dict:
    lo = reference_steps(cell, seed, dev, torch.bfloat16)
    hi = reference_steps(cell, seed, dev, torch.float32)
    return cell.model.train_numbers(lo[0], hi[0], lo[1], hi[1], lo[2],
                                    hi[2])


def _detail(prog_g1, ref_g1, prog_delta, ref_delta) -> dict:
    """Per leaf: the norms, the elements whose first gradient is zero on
    one side only, and those whose signs differ where both are not."""
    out = {}
    for k in ref_g1:
        gp, gr = prog_g1[k], ref_g1[k]
        both = (gp != 0) & (gr != 0)
        out[k] = {
            "g1_prog": float(gp.norm()), "g1_ref": float(gr.norm()),
            "delta_prog": float(prog_delta[k].norm()),
            "delta_ref": float(ref_delta[k].norm()),
            "nonzero_ref": int((gr != 0).sum()),
            "zero_ref_only": int(((gr == 0) & (gp != 0)).sum()),
            "zero_prog_only": int(((gp == 0) & (gr != 0)).sum()),
            "sign_differs": int((both & (torch.sign(gp) != torch.sign(gr)))
                                .sum()),
            "max_abs_prog_where_ref_zero": float(
                torch.where(gr == 0, gp.abs(), 0.0).max()),
            "delta_gap_elems": float((prog_delta[k] - ref_delta[k]).norm()),
        }
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--detail", type=int, default=0)
    p.add_argument("--fault", default="",
                   help="plant a fault of faults.py in the program's runs")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("benchmark.readings: no CUDA card")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(bench, args.workload)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gsplat_tpu_torch.utils.compile_cache import \
        enable_compilation_cache

    enable_compilation_cache(str(harness.ROOT / ".bench_cache" / "kernels"))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    detail = {}
    if args.detail and cell.mix["kind"] == "train":
        plain = cell.model.train_numbers

        def spy(*a):
            detail.update(_detail(*a[2:]))
            detail["delta_norm_gap_all_elements"] = compare.leaf_gap(
                a[4], a[5], compare.moved_leaves(a[3]))
            return plain(*a)

        cell.model.train_numbers = spy
    for s in seeds:
        t0 = time.perf_counter()
        line = harness.run_cell(
            cell, s, args.seconds, False, "cuda",
            hooks=faults.hooks(args.fault) if args.fault else None)
        rec = {"cell": cell.name, "side": args.fault or "program", "seed": s,
               "correct": line["correct"],
               "numbers": {k: c["value"] for k, c in line["checks"].items()},
               "info": line["info"], "e2e": line["metrics"],
               "seconds": time.perf_counter() - t0}
        if detail:
            rec["detail"] = dict(detail)
        print(json.dumps(rec), flush=True)
        harness._free(dev)
    for s in (int(s) for s in args.control_seeds.split(",") if s):
        t0 = time.perf_counter()
        fn = control_serve if cell.mix["kind"] == "serve" else control_train
        print(json.dumps({"cell": cell.name, "side": "control", "seed": s,
                          "numbers": fn(cell, s, dev),
                          "seconds": time.perf_counter() - t0}), flush=True)
        harness._free(dev)


if __name__ == "__main__":
    main()
