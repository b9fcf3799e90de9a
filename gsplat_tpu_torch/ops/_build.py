"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and is
compiled at first use into ``gsplat_tpu_torch/_build/<name>-<hash>/``
(listed in ``.gitignore``), keyed by a hash of the sources and flags, so
an edit rebuilds and an unchanged tree loads what is there. No PyTorch
header is compiled: a build takes seconds (``binning.cu``, which
instantiates CUB's radix sort, longer). :data:`FUNCTIONS` lists each
library's exports and their ctypes signatures.

``-fmad=false`` keeps each kernel's rounding equal to its plain PyTorch
version's (see the note in each source). ``-Xptxas -v`` reports registers,
shared memory and spills into ``ptxas.log`` beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

# Every library and the functions it exports: {library: {function:
# (argtypes, restype)}}. Each library is csrc/<library>.cu.
FUNCTIONS = {
    "raster_fwd": {
        # raster_fwd(feat, pair_slot, n_pairs, stride, tile_start,
        #            tile_count, order, out, state, skipped, log_t,
        #            num_tiles, tiles_x, rows_mod, tile, G, chi2_clip,
        #            alpha_max, alpha_cutoff, t_min, margin_rel, margin_eps,
        #            margin_abs, kappa_min, stream) -> cudaError_t
        #            (pair_slot: null for the feature-major pair list in
        #            feat, else feat is the [N, 12] table read by slot;
        #            order: scratch; state, skipped: may be null; log_t: 1
        #            for transmittance_math="log", 0 for "cumprod";
        #            rows_mod: a view's tile rows for batched views, else 0)
        "raster_fwd": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p],
            ctypes.c_int,
        ),
        # pair_table(order, valid, uv, conic, opacity, rgb, depth, n,
        #            table, stream) -> cudaError_t   (K1's depth-ordered
        #            [n, 12] f32 table; order int32 [n])
        "pair_table": (
            [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p],
            ctypes.c_int,
        ),
        # raster_fwd_ctas_per_sm(int tile, int G, int log_t, int indexed,
        # int* n) -> cudaError_t: K1's resident CTAs per SM on the current
        # device (the occupancy API)
        "raster_fwd_ctas_per_sm": ([ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int)],
                                   ctypes.c_int),
    },
    "raster_bwd": {
        # raster_bwd(feat, n_blocks, stride, tile_start, tile_off,
        #            num_tiles, fwd, gout, state, dfeat, dstride, log_t,
        #            tiles_x, rows_mod, kb, tile, G, chi2_clip, alpha_max,
        #            alpha_cutoff, one_minus_max, t_min, ctas, stream) ->
        #            cudaError_t   (ctas: CTAs launched, may be null; log_t
        #            and rows_mod as raster_fwd's; kb > 0: compact mode,
        #            dfeat [10, kb * G])
        "raster_bwd": (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_int),
             ctypes.c_void_p],
            ctypes.c_int,
        ),
    },
    "raster_ablate": {
        # raster_ablate(variant, feat, n_pairs, stride, tile_start,
        #               tile_count, order, out, skipped, num_tiles, tiles_x,
        #               tile, G, chi2_clip, alpha_max, alpha_cutoff, t_min,
        #               margin_rel, margin_eps, margin_abs, kappa_min,
        #               stream) -> cudaError_t   (order: scratch; skipped:
        #               may be null)
        "raster_ablate": (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
            ctypes.c_int,
        ),
        # raster_ablate_pg_resources(int variant, int out[4]) ->
        # cudaError_t: a pg kernel's registers, static shared bytes, local
        # bytes and CTAs per SM; raster_ablate_tf32_split(x, hi, lo, n,
        # stream) -> cudaError_t: the pg kernels' TF32 split of n floats
        "raster_ablate_pg_resources": ([ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)],
                                       ctypes.c_int),
        "raster_ablate_tf32_split": ([ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p], ctypes.c_int),
    },
    "raster_feat": {
        # feat_fwd(feat, stride, pair_slot, depth_order, fsem, C,
        #          tile_start, fwd, fmap, num_tiles, tiles_x, H, W, tile, G,
        #          chi2_clip, alpha_max, alpha_cutoff, t_min, margin_rel,
        #          margin_eps, margin_abs, kappa_min, stream) -> cudaError_t
        "feat_fwd": (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p],
            ctypes.c_int,
        ),
        # feat_bwd(feat, stride, pair_slot, depth_order, fsem, C,
        #          tile_start, fwd, fmap, gfmap, dgeo, dstride, dfsem,
        #          num_tiles, tiles_x, H, W, tile, G, chi2_clip, alpha_max,
        #          alpha_cutoff, one_minus_max, t_min, margin_rel,
        #          margin_eps, margin_abs, kappa_min, stream) -> cudaError_t
        "feat_bwd": (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p],
            ctypes.c_int,
        ),
        # feat_resources(int G, int out[6]) -> cudaError_t: F1's then F2's
        # registers, local bytes and CTAs per SM
        "feat_resources": ([ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                           ctypes.c_int),
    },
    "raster_surfel": {
        # surfel_fwd(tab, pair_slot, n_pairs, tile_start, tile_count, out,
        #            num_tiles, tiles_x, consts, stream) -> cudaError_t (S1;
        #            consts: raster_surfel.py's _Consts, by reference)
        "surfel_fwd": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p], ctypes.c_int),
        # surfel_bwd(tab, pair_slot, n_pairs, tile_start, tile_count, fwd,
        #            gout, d, num_tiles, tiles_x, consts, stream) ->
        #            cudaError_t (S2)
        "surfel_bwd": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
                       ctypes.c_int),
        # surfel_resources(int out[6]) -> cudaError_t: S1's then S2's
        # registers, local bytes and CTAs per SM
        "surfel_resources": ([ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    },
    "binning": {
        # binning_emit(offsets, n, tile_min, n_u, max_pairs, tiles_x,
        #              num_tiles, tile_id, slot, stream) -> cudaError_t
        "binning_emit": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p], ctypes.c_int),
        # binning_sort(temp, temp_bytes, keys, keys_alt, vals, vals_alt,
        #              num_items, end_bit, selector, stream) -> cudaError_t
        #              (temp null: only the scratch size into *temp_bytes)
        "binning_sort": ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int), ctypes.c_void_p],
                         ctypes.c_int),
        # binning_align(tile, slot, num_items, padded_start, real_start,
        #               num_tiles, padded_pairs, pair_slot, stream) ->
        #               cudaError_t
        "binning_align": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_void_p,
                           ctypes.c_void_p], ctypes.c_int),
    },
    "update": {
        # update_check(table, work, stream) -> cudaError_t (U1);
        # update_apply(table, work, skipped, stream) -> cudaError_t (U2).
        # table: ops/update.py's _Table, by reference; work:
        # update_work_bytes() bytes, zeroed once; skipped: [] int32, may
        # be null
        "update_check": ([ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p], ctypes.c_int),
        "update_apply": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p], ctypes.c_int),
        "update_work_bytes": ([], ctypes.c_longlong),
        "update_table_bytes": ([], ctypes.c_longlong),
    },
    "preprocess": {
        # preprocess(args, sh_bases, stream) -> cudaError_t (P1). args:
        # ops/preprocess.py's _Args, by reference; sh_bases 1, 4, 9 or 16
        # writes the colour, 0 does not
        "preprocess": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
                       ctypes.c_int),
        "preprocess_args_bytes": ([], ctypes.c_longlong),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (on PATH or /usr/local/cuda/bin): the CUDA "
            "kernels cannot be built")
    return nvcc


def _target_dir(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"


def build(names=tuple(FUNCTIONS)) -> dict:
    """Build every named kernel that is not built yet, all nvcc processes
    started together. Returns {name: {"lib": path, "ptxas": nvcc's -v
    report}}; raises if nvcc is missing or any build fails."""
    todo = {}
    info = {}
    for name in names:
        d = _target_dir(name)
        lib = d / f"lib{name}.so"
        if lib.exists():
            log = d / "ptxas.log"
            info[name] = {"lib": lib,
                          "ptxas": log.read_text() if log.exists() else ""}
        else:
            todo[name] = d
    if not todo:
        return info
    nvcc = find_nvcc()
    procs = {}
    for name, d in todo.items():
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, d)
    failed = []
    for name, (proc, tmp, d) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        (d / "ptxas.log").write_text(log)
        os.replace(tmp, d / f"lib{name}.so")
        info[name] = {"lib": d / f"lib{name}.so", "ptxas": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return info


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build((name,))[name]["lib"]
        lib = ctypes.CDLL(str(path))
        for fname, sig in FUNCTIONS[name].items():
            fn = getattr(lib, fname)
            fn.argtypes, fn.restype = sig
        _loaded[name] = lib
    return lib
