"""Process-grid construction on ``torch.distributed``.

Counterpart of ``gsplat_tpu/parallel/mesh.py``: ``make_mesh`` (``:27-54``)
and ``initialize_multihost`` (``:57-104``). JAX lays its devices out as a
``('data', 'tile')`` ``jax.sharding.Mesh`` inside one program; the port
runs one process per rank, and a :class:`Mesh` is that rank's view of the
grid:

* ``data``: views (cameras) per step; gradients are averaged over it;
* ``tile``: horizontal bands of image tiles within a view; each rank
  composites its band, and the bands are gathered for the loss.

Rank r sits at ``(r // tile, r % tile)``, as JAX's ``reshape(data, tile)``
places devices. The backend is explicit: ``"nccl"`` (the default; one card
per rank) or ``"gloo"`` (collectives through host memory; it also takes
several ranks on one card, which NCCL refuses). A rank's device is
``cuda:(local_rank % device_count)`` unless the caller passes ``device``.
"""

from __future__ import annotations

import contextlib
import io
import logging
import os
import queue
import shutil
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device

DATA_AXIS = "data"
TILE_AXIS = "tile"
BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class Mesh:
    """One rank's place in a ``(data, tile)`` process grid.

    ``shape`` maps each axis name to its size; ``coord`` is this rank's
    ``(data, tile)`` coordinate; ``data_group`` holds the ranks that share
    its tile coordinate (the ``data`` axis through it), ``tile_group``
    those that share its data coordinate. Groups are None on a one-rank
    grid, where every collective is the identity.
    """

    shape: dict
    rank: int
    coord: tuple
    device: torch.device
    backend: str | None
    data_group: object = None
    tile_group: object = None

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[TILE_AXIS]


def _check_backend(backend: str, local_ranks: int, device) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend == "nccl":
        if device is not None and torch.device(device).type == "cpu":
            raise ValueError("backend='nccl' needs CUDA devices; pass "
                             "backend='gloo' for ranks on the CPU")
        cards = torch.cuda.device_count()
        if local_ranks > cards:
            raise ValueError(
                f"backend='nccl' needs one card per rank: {local_ranks} "
                f"ranks on this host, {cards} card(s); pass "
                f"backend='gloo' to share cards")


def _local_ranks() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              dist.get_world_size()
                              if dist.is_initialized() else 1))


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given, else
    ``cuda:(local_rank % device_count)`` (raises without a card)."""
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return resolve_device(f"cuda:{local % torch.cuda.device_count()}")


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str = "nccl",
                         device=None) -> dict:
    """Bring up the ``torch.distributed`` process group. Idempotent.

    ``coordinator_address`` is the rendezvous (``tcp://host:port`` or
    ``file:///path``). With ``num_processes`` > 1 a failed start or a
    world of another size is fatal (a degraded run would train on 1/N of
    the views). With no arguments the launcher's environment
    (``torchrun``'s ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) is read;
    where it is missing, the process goes on alone and logs it, as JAX's
    auto-detection does. Returns the topology summary JAX returns.
    """
    if not dist.is_initialized():
        if num_processes is not None and num_processes > 1:
            _check_backend(backend, int(os.environ.get(
                "LOCAL_WORLD_SIZE", num_processes)), device)
            dist.init_process_group(backend, init_method=coordinator_address,
                                    world_size=num_processes,
                                    rank=process_id)
            got = dist.get_world_size()
            if got != num_processes:
                raise RuntimeError(
                    f"requested {num_processes} processes but the process "
                    f"group reports {got}")
        elif coordinator_address is None and num_processes is None:
            if "WORLD_SIZE" in os.environ:
                _check_backend(backend, int(os.environ.get(
                    "LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"])), device)
            try:
                dist.init_process_group(backend, init_method="env://")
            except ValueError as e:
                logging.getLogger(__name__).warning(
                    "torch.distributed env:// initialization failed (%s); "
                    "continuing SINGLE-PROCESS. Pass coordinator_address/"
                    "num_processes/process_id, or launch with torchrun.", e)
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }


def make_mesh(n_devices: int | None = None, data: int | None = None,
              tile: int | None = None, device=None) -> Mesh:
    """This rank's ``(data, tile)`` grid over the process group (every
    rank must call it: it creates every row's and column's group).

    With no split, all ranks go on ``data`` and ``tile`` = 1; pass
    ``tile=K`` for band parallelism. Without an initialized process group
    the grid is this one process (``n_devices`` 1).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a grid of {n_devices} ranks needs a process "
                         f"group of that size; this one has {world}")
    if data is None and tile is None:
        data, tile = n_devices, 1
    elif data is None:
        if n_devices % tile:
            raise ValueError(f"{n_devices} ranks do not split into tile "
                             f"{tile}")
        data = n_devices // tile
    elif tile is None:
        if n_devices % data:
            raise ValueError(f"{n_devices} ranks do not split into data "
                             f"{data}")
        tile = n_devices // data
    if data * tile != n_devices:
        raise ValueError(f"data*tile = {data}*{tile} != {n_devices} ranks")
    shape = {DATA_AXIS: data, TILE_AXIS: tile}
    if world == 1:
        return Mesh(shape, 0, (0, 0), rank_device(device), None)
    backend = dist.get_backend()
    _check_backend(backend, _local_ranks(), device)
    rank = dist.get_rank()
    d, t = divmod(rank, tile)
    data_group = tile_group = None
    # Every rank creates every group, in the same order.
    for tt in range(tile):
        g = dist.new_group([dd * tile + tt for dd in range(data)])
        if tt == t:
            data_group = g
    for dd in range(data):
        g = dist.new_group([dd * tile + tt for tt in range(tile)])
        if dd == d:
            tile_group = g
    return Mesh(shape, rank, (d, t), rank_device(device), backend,
                data_group, tile_group)


def _grid_worker(rank, n_ranks, init_method, backend, device, fn, args,
                 results):
    initialize_multihost(init_method, n_ranks, rank, backend=backend,
                         device=device)
    try:
        out = fn(*args)
        if rank == 0:
            results.put(out)
    finally:
        dist.destroy_process_group()


def launch(fn, n_ranks: int, backend: str = "nccl", device=None,
           args: tuple = ()):
    """Run ``fn(*args)`` on every rank of an ``n_ranks`` process group and
    return rank 0's result (``fn`` builds its grid with :func:`make_mesh`).

    Under a launcher (``torchrun``: ``WORLD_SIZE`` is set) this process is
    one of the ranks: it joins the launched group, whose size must be
    ``n_ranks``. Otherwise ``n_ranks`` > 1 starts that many local worker
    processes (``spawn``), which meet through a file store in a fresh
    temporary directory; rank 0's result comes back pickled. A rank that
    fails fails the call: the other workers are stopped and
    ``RuntimeError`` names the exit codes. ``n_ranks`` 1 runs ``fn`` here.
    """
    if "WORLD_SIZE" in os.environ or dist.is_initialized():
        initialize_multihost(backend=backend, device=device)
        world = dist.get_world_size()
        if world != n_ranks:
            raise ValueError(f"the launched process group has {world} "
                             f"ranks; the grid needs {n_ranks}")
        return fn(*args)
    if n_ranks == 1:
        return fn(*args)
    _check_backend(backend, n_ranks, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="gsplat_grid_")
    procs = [ctx.Process(target=_grid_worker,
                         args=(r, n_ranks, f"file://{store}/store", backend,
                               device, fn, args, results))
             for r in range(n_ranks)]
    try:
        for p in procs:
            p.start()
        while True:  # drain before join: a full pipe blocks the writer
            try:
                out = results.get(timeout=1.0)
                break
            except queue.Empty:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes) or all(
                        c == 0 for c in codes):
                    raise RuntimeError(f"grid ranks exited with codes "
                                       f"{codes} before rank 0's result")
        for p in procs:
            p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"grid ranks exited with codes {codes}")
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(store, ignore_errors=True)


def grid_ranks(requested: int | None = None) -> int:
    """The rank count of a CLI's grid: ``requested`` when given, else the
    launcher's ``WORLD_SIZE``, else one rank per card (JAX's "all
    devices")."""
    if requested:
        return requested
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return max(torch.cuda.device_count(), 1)


def grid_device(device):
    """A CLI's ``--device`` as :func:`make_mesh` takes it: ``"cpu"``, or
    None for each rank's own card."""
    return "cpu" if torch.device(device).type == "cpu" else None


def cli_rank(run, args, data: int | None = None, tile: int | None = None):
    """One rank of a CLI's grid: its :func:`make_mesh` (``data`` x
    ``tile``, on ``args.device``), then ``run(args, mesh)``. Ranks other
    than 0 print nothing."""
    mesh = make_mesh(data=data, tile=tile, device=grid_device(args.device))
    if mesh.rank:
        with contextlib.redirect_stdout(io.StringIO()):
            return run(args, mesh)
    return run(args, mesh)
