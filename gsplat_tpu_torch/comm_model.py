"""Closed-form communication of the port's sharded steps over a (data,
tile) grid of cards, and the step time and scaling it predicts on an
NVIDIA H100 interconnect.

Counterpart of ``scripts/comm_model.py``, counted for the port's own
exchanges (``gsplat_tpu_torch/parallel/sharding.py``), which differ from
JAX's:

* band-sharded step (``make_sharded_train_step``; family A): per local
  view the band image is all-gathered over ``tile`` (``gather_bands``);
  its backward keeps this band's rows of the cotangent, with no collective
  (JAX transposes the gather into a reduce-scatter). The gradients of
  every leaf go through one all-reduce over the whole grid (``_reduce``
  with no group), the three losses one over ``data`` and the band demand
  (two int32) one over the grid;
* gaussian-sharded step (``make_gauss_sharded_train_step``; family B):
  per local view the shard's 10 float features are all-gathered over
  ``tile`` (``_GatherShards``), whose backward is a reduce-scatter of the
  gathered rows' cotangent, and its 6 int32 fields are all-gathered with
  no backward; the band image is gathered as in A. The gradients, already
  this shard's rows (no ``n_tile`` division), are all-reduced over
  ``data``; the losses over ``data``; the worst demand and ring overflow
  (three int32) over the grid; the position clip's sum of squares (one
  float) over ``tile`` and the NaN guard's flag (one float) over the grid;
* the ring (``ring=True``): in place of the all-gather, ``tile - 1``
  permutes of the shard's float features forward and as many of their
  cotangent backward, and ``tile - 1`` of its int32 fields, each an
  ``all_to_all_single`` whose only non-empty split is the shard (C/T rows)
  and goes to the next tile rank;
* serving (``make_sharded_render``; family C): one band all-gather over
  ``tile`` a frame.

``paper=True`` adds the paper ADC's statistics: in A the tap gradient
``[B/D, C, 2]`` f32 and the radii ``[B/D, C]`` int32 over ``tile``, then
``uv_grad_sum`` (f32), ``visible`` and ``max_radius`` (int32), each
``[C]``, over ``data``; in B the last three at ``[C/T]``.

Bytes a rank sends, ring algorithms over k ranks: an all-gather of a shard
of s bytes sends (k - 1) s; a reduce-scatter of S bytes (k - 1) S / k; an
all-reduce of S bytes 2 (k - 1) S / k; a permute its whole tensor. A link
moves them at its one-direction rate. The grid-wide collectives are
charged to the slower of the two axes' links.

Link rates, NVIDIA's published specifications for the H100 SXM5, not
measurements (:data:`LINKS`): NVLink 4 at 900 GB/s a card both ways
together, 450 GB/s each way; PCIe Gen5 x16 at 64 GB/s each way; one
ConnectX-7 NDR InfiniBand port, 400 Gb/s = 50 GB/s each way, a card. The
port's grid has not run NCCL across several cards, so no rate below is
measured.

Compute (the ``--step_ms_per_view`` flag): the port's single-card train
step per view on the H100 (1000 / a training cell's ``train_views_per_s``
in ``PERF_LEDGER.jsonl``); without it only the volumes and the link times
are printed.
The band step repeats the per-gaussian stages (covariance, SH,
projection) on every tile rank, a share ``--band_nonscaling`` of the step
that does not shrink with ``tile``; its default, 0.217, is that share of
the device time of a traced 1080p frame on the H100 (projection 0.487 and
covariance + SH 0.410 of 4.13 ms; ``PERF.md`` §5). The gaussian-sharded
step projects each shard once: its share that does not shrink is taken
as 0 (:data:`GAUSS_NONSCALING`, an assumption, not a measurement; the
loss on the gathered image is computed on every tile rank and is not
counted).

    python -m gsplat_tpu_torch.comm_model [--n 131072] [--height 540]
        [--width 960] [--batch 8] [--step_ms_per_view MS]
        [--link nvlink4|pcie5|ndr400] [--band_nonscaling 0.217] [--json]
"""

from __future__ import annotations

import argparse
import json

GB = 1e9
# One-direction link rate a card, bytes/s: NVIDIA's published H100 SXM5
# specifications (not measured).
LINKS = {
    "nvlink4": 450e9,  # NVLink 4: 900 GB/s a card, both directions
    "pcie5": 64e9,  # PCIe Gen5 x16
    "ndr400": 50e9,  # ConnectX-7 NDR InfiniBand, 400 Gb/s a card
}
PARAM_FLOATS = 59  # pos 3, scale 3, quaternion 4, opacity 1, f_dc 3, f_rest 45
FEAT_FLOATS = 10  # exchanged floats a gaussian (sharding.py: _pack)
FEAT_INTS = 6  # exchanged int32 a gaussian: radius, tile_min/max, valid
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
AXES = ("tile", "data", "grid")
BAND_NONSCALING = 0.217
GAUSS_NONSCALING = 0.0


def all_gather_bytes(shard_bytes: float, k: int) -> float:
    """Bytes a rank sends in an all-gather of ``shard_bytes`` a rank."""
    return (k - 1) * shard_bytes if k > 1 else 0.0


def reduce_scatter_bytes(total_bytes: float, k: int) -> float:
    """Bytes a rank sends in a reduce-scatter of ``total_bytes``."""
    return (k - 1) / k * total_bytes if k > 1 else 0.0


def all_reduce_bytes(total_bytes: float, k: int) -> float:
    """Bytes a rank sends in an all-reduce of ``total_bytes``."""
    return 2 * (k - 1) / k * total_bytes if k > 1 else 0.0


def band_px(height: int, tile: int, n_tile: int) -> int:
    """Pixel rows of one band (``parallel.sharding.band_config``)."""
    tiles_y = -(-height // tile)
    return -(-tiles_y // n_tile) * tile


class _Volumes:
    """Per-kind and per-axis byte tallies of one step."""

    def __init__(self):
        self.kind = dict.fromkeys(KINDS, 0.0)
        self.axis = dict.fromkeys(AXES, 0.0)

    def add(self, kind: str, axis: str, nbytes: float):
        self.kind[kind] += nbytes
        self.axis[axis] += nbytes

    def as_dict(self) -> dict:
        return {"kinds": dict(self.kind), "axes": dict(self.axis),
                "total": sum(self.kind.values())}


def step_volumes(family: str, batch: int, height: int, width: int, n: int,
                 n_data: int, n_tile: int, tile: int = 16,
                 paper: bool = False, nan_guard: bool = True) -> dict:
    """Bytes one rank sends in one train step of ``family`` ("band",
    "gauss" or "ring") for a global ``batch`` of views at ``height`` x
    ``width``, a pool of ``n`` slots, on a grid of ``n_data`` x ``n_tile``
    ranks: ``{"kinds": {collective: bytes}, "axes": {"tile" | "data" |
    "grid": bytes}, "total": bytes}`` (see the module docstring)."""
    if family not in ("band", "gauss", "ring"):
        raise ValueError(f"unknown family {family!r}")
    if batch % n_data or n % n_tile:
        raise ValueError("the batch must divide by data and the pool by "
                         "tile")
    D, T = n_data, n_tile
    views = batch // D
    v = _Volumes()
    img = band_px(height, tile, T) * width * 3 * 4
    for _ in range(views):
        v.add("all_gather", "tile", all_gather_bytes(img, T))
    rows = n if family == "band" else n // T  # the rows a rank updates
    if family == "band":
        v.add("all_reduce", "grid", all_reduce_bytes(n * PARAM_FLOATS * 4,
                                                     D * T))
        v.add("all_reduce", "grid", all_reduce_bytes(2 * 4, D * T))
    else:
        shard = n // T
        for _ in range(views):
            if family == "gauss":
                v.add("all_gather", "tile",
                      all_gather_bytes(shard * FEAT_FLOATS * 4, T))
                v.add("reduce_scatter", "tile",
                      reduce_scatter_bytes(n * FEAT_FLOATS * 4, T))
                v.add("all_gather", "tile",
                      all_gather_bytes(shard * FEAT_INTS * 4, T))
            else:
                for _ in range(T - 1):  # forward, backward, the int fields
                    v.add("all_to_all", "tile", 2 * shard * FEAT_FLOATS * 4)
                    v.add("all_to_all", "tile", shard * FEAT_INTS * 4)
        v.add("all_reduce", "data", all_reduce_bytes(shard * PARAM_FLOATS
                                                     * 4, D))
        v.add("all_reduce", "grid", all_reduce_bytes(3 * 4, D * T))
        v.add("all_reduce", "tile", all_reduce_bytes(4, T))  # the clip
        if nan_guard:
            v.add("all_reduce", "grid", all_reduce_bytes(4, D * T))
    v.add("all_reduce", "data", all_reduce_bytes(3 * 4, D))  # the losses
    if paper:
        if family == "band":
            v.add("all_reduce", "tile", all_reduce_bytes(views * n * 2 * 4,
                                                         T))
            v.add("all_reduce", "tile", all_reduce_bytes(views * n * 4, T))
        for _ in range(3):  # uv_grad_sum, visible, max_radius
            v.add("all_reduce", "data", all_reduce_bytes(rows * 4, D))
    return v.as_dict()


def serve_volumes(height: int, width: int, n_tile: int,
                  tile: int = 16) -> dict:
    """Bytes one rank sends for one frame of the band-parallel render
    (family C): the band all-gather over ``tile``."""
    v = _Volumes()
    v.add("all_gather", "tile",
          all_gather_bytes(band_px(height, tile, n_tile) * width * 3 * 4,
                           n_tile))
    return v.as_dict()


def comm_seconds(vol: dict, tile_link: str, data_link: str) -> float:
    """Link time of a step's volumes: each axis's bytes at its link's
    rate, the grid-wide ones at the slower of the two."""
    ax = vol["axes"]
    rt, rd = LINKS[tile_link], LINKS[data_link]
    return ax["tile"] / rt + ax["data"] / rd + ax["grid"] / min(rt, rd)


def band_compute(views: int, step_s: float, n_tile: int,
                 nonscaling: float) -> float:
    """A rank's compute for ``views`` views with the frame cut into
    ``n_tile`` bands: the share ``nonscaling`` of the single-card step
    stays whole on every band; the rest shrinks 1/``n_tile``."""
    return views * step_s * (nonscaling + (1.0 - nonscaling) / n_tile)


def model_rows(n: int, height: int, width: int, batch: int,
               step_ms_per_view: float | None, link: str = "nvlink4",
               band_nonscaling: float = BAND_NONSCALING) -> list:
    """The table: for 2, 4 and 8 cards on one host (every axis on
    ``link``) and 2 hosts of 4 (``data`` over the NDR NIC), each (data,
    tile) grid that divides the batch, the three families' volumes, link
    time and, with ``step_ms_per_view``, the predicted step and its
    scaling efficiency; then serving at 2, 4 and 8 bands."""
    step_s = None if step_ms_per_view is None else step_ms_per_view / 1e3
    rows = []

    def add(where, fam, D, T, vol, compute_s, tile_link, data_link,
            ideal_s):
        t_comm = comm_seconds(vol, tile_link, data_link)
        step = None if compute_s is None else compute_s + t_comm
        rows.append({
            "where": where, "family": fam, "mesh": f"d{D}xt{T}",
            "bytes": vol["kinds"], "GB": round(vol["total"] / GB, 6),
            "comm_ms": t_comm * 1e3,
            "step_ms": None if step is None else step * 1e3,
            "eff": None if step is None else ideal_s / step,
        })

    meshes = []
    for cards in (2, 4, 8):
        for D in (cards, cards // 2, 2, 1):
            T = cards // D
            if D >= 1 and D * T == cards and not batch % D and \
                    (f"{cards} cards, one host", D, T) not in meshes:
                meshes.append((f"{cards} cards, one host", D, T))
    meshes.append(("2 hosts x 4 cards", 2, 4))
    for where, D, T in meshes:
        data_link = "ndr400" if where.startswith("2 hosts") else link
        views = batch // D
        ideal = None if step_s is None else batch * step_s / (D * T)
        for fam, nonscaling in (("band", band_nonscaling),
                                ("gauss", GAUSS_NONSCALING),
                                ("ring", GAUSS_NONSCALING)):
            if fam != "band" and (T == 1 or n % T):
                continue  # no pool to shard over one tile rank
            vol = step_volumes(fam, batch, height, width, n, D, T)
            compute = None if step_s is None else band_compute(
                views, step_s, T, nonscaling)
            add(where, fam, D, T, vol, compute, link, data_link, ideal)
    for T in (2, 4, 8):
        vol = serve_volumes(height, width, T)
        add(f"{T} cards, one host", "serve", 1, T, vol, None, link, link,
            None)
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--step_ms_per_view", type=float, default=None,
                    help="the port's single-card train step per view on the "
                         "H100, ms (measured; no default)")
    ap.add_argument("--link", choices=sorted(LINKS), default="nvlink4",
                    help="the cards' interconnect within a host")
    ap.add_argument("--band_nonscaling", type=float,
                    default=BAND_NONSCALING,
                    help="share of the band step that does not shrink with "
                         "tile (default: the per-gaussian stages' share of a "
                         "traced 1080p frame on the H100)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rows = model_rows(args.n, args.height, args.width, args.batch,
                      args.step_ms_per_view, args.link, args.band_nonscaling)
    if args.json:
        print(json.dumps(rows))
        return rows
    print(f"{'where':>18} {'family':>6} {'mesh':>6} {'GB/step':>9} "
          f"{'comm ms':>9} {'step ms':>9} {'eff':>6}")
    for r in rows:
        step = "-" if r["step_ms"] is None else f"{r['step_ms']:.2f}"
        eff = "-" if r["eff"] is None else f"{r['eff']:.3f}"
        print(f"{r['where']:>18} {r['family']:>6} {r['mesh']:>6} "
              f"{r['GB']:>9.4f} {r['comm_ms']:>9.3f} {step:>9} {eff:>6}")
    print(f"links ({args.link} within a host; 2 hosts: data over ndr400) "
          f"are NVIDIA's published H100 SXM5 rates, not measured; step and "
          f"efficiency "
          + ("from --step_ms_per_view "
             f"{args.step_ms_per_view}" if args.step_ms_per_view is not None
             else "not computed (no --step_ms_per_view)"))
    return rows


if __name__ == "__main__":
    main()
