"""Ranks, their group, and the collectives the distributed layer uses.

Port of ``tpu_slam.distributed.mesh``. The reference runs its distributed
paths as SPMD in one process: ``jax.shard_map`` over a ``Mesh`` of devices,
arrays stacked on a leading device axis. The port is SPMD by process: one
rank per device in a ``torch.distributed`` process group, each rank holding
only its own shard, and the body of each ``shard_map`` is what a rank runs.
The collectives carry over one to one, and this module is the only one of
the layer that calls ``torch.distributed``:

    jax.lax.psum                          all_reduce (sum)
    jax.lax.psum_scatter(tiled, dim 0)    reduce_scatter
    jax.lax.all_gather(tiled)             all_gather
    jax.lax.ppermute by +-1, no wrap      shift (zeros at the ends, as
                                          ppermute leaves there);
                                          halo_exchange: both in one batch
    jax.lax.axis_index, mesh.shape[ax]    Mesh.rank, Mesh.size

The reference's ``batch_sharding`` and ``replicated`` have no counterpart:
inside a rank each tensor already is its own shard or a replica.

Backends: NCCL is the one a multi-GPU deployment runs, one rank per card;
gloo runs the CPU tests, and several ranks that share one card. Gloo's
collectives take host tensors, so for a rank whose tensors are on the card
each collective copies its buffer to the host and back here, explicitly,
and counts the copies and their bytes in ``Mesh.stats``. That is the
backend's transport; the compute and the kernels stay on the card.

A program of the layer that the reference compiles (the Schur solve, the
sharded dense step) is one CUDA graph on NCCL, its collectives captured
with the rest; gloo's staging through host memory cannot be captured, so
on a gloo mesh it runs its eager form. ``captured_form`` decides, and
``program_key`` names the mesh in a graph's cache key.

``run_ranks`` runs a function on N spawned ranks (a ``FileStore`` in a
fresh temporary directory, so concurrent runs never contend for a port)
and returns every rank's result.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_slam_torch import default_device

COLLECTIVE_TIMEOUT_S = 600
# the tensor forms of reduce-scatter and all-gather; newer torch renames
# them (*_single) and deprecates the old names
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


@dataclasses.dataclass
class CollectiveStats:
    """Counts of one mesh's collectives and of the host staging they took."""

    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    staged_copies: int = 0      # device<->host copies (gloo, card tensors)
    staged_bytes: int = 0

    def reset(self) -> None:
        self.calls.clear()
        self.staged_copies = 0
        self.staged_bytes = 0

    def as_dict(self) -> Dict[str, Any]:
        return dict(calls=dict(self.calls), staged_copies=self.staged_copies,
                    staged_bytes=self.staged_bytes)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis of ranks as seen from one of them."""

    group: Any                  # the process group (None: the default one)
    rank: int
    size: int
    axis_name: str
    backend: str
    device: torch.device
    stats: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats, compare=False)


def device_count() -> int:
    return torch.cuda.device_count()


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device=None) -> Mesh:
    """The mesh of every rank of the initialised default group.

    ``n_devices``, when given, must be the world size. ``device`` is where
    this rank's tensors live (CUDA unless the caller asks for the CPU).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(multihost.initialize or run_ranks)")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"mesh of {n_devices} asked for, world size {size}")
    return Mesh(group=None, rank=dist.get_rank(), size=size,
                axis_name=axis_name, backend=dist.get_backend(),
                device=default_device(device))


def make_mesh_2d(data: int, graph: int, device=None) -> Dict[str, Mesh]:
    """(data, graph) layout: rank = i * graph + j. Returns this rank's two
    axes, {"data": ranks of its column, "graph": ranks of its row}; every
    rank creates every subgroup, in one order, as ``new_group`` needs."""
    size = dist.get_world_size()
    if data * graph != size:
        raise ValueError(f"{data} x {graph} != world size {size}")
    rank = dist.get_rank()
    dev = default_device(device)
    backend = dist.get_backend()
    out = {}
    for i in range(data):
        ranks = [i * graph + j for j in range(graph)]
        grp = dist.new_group(ranks)
        if rank in ranks:
            out["graph"] = Mesh(grp, ranks.index(rank), graph, "graph",
                                backend, dev)
    for j in range(graph):
        ranks = [i * graph + j for i in range(data)]
        grp = dist.new_group(ranks)
        if rank in ranks:
            out["data"] = Mesh(grp, ranks.index(rank), data, "data",
                               backend, dev)
    return out


def captured_form(mesh: Optional[Mesh], compiled: Optional[bool]) -> bool:
    """Whether a compiled program of the layer runs captured on ``mesh``
    (None: one process alone). ``compiled=None`` captures where the
    backend allows it (NCCL, or no mesh) and runs the eager form on gloo;
    ``compiled=True`` on gloo raises rather than run another form than
    the one asked for."""
    staged = mesh is not None and mesh.backend != "nccl"
    if compiled is None:
        return not staged
    if compiled and staged:
        raise ValueError(
            f"compiled=True needs NCCL: a CUDA graph cannot hold the "
            f"{mesh.backend} backend's collectives (compiled=None runs the "
            "eager form there)")
    return compiled


def program_key(mesh: Optional[Mesh]) -> Any:
    """The part of a captured program's cache key that names its mesh: a
    graph holds its communicator, so another group is another graph."""
    if mesh is None:
        return None
    group = dist.group.WORLD if mesh.group is None else mesh.group
    return (mesh.rank, mesh.size, mesh.axis_name, mesh.backend,
            mesh.device, id(group))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _staged(mesh: Mesh) -> bool:
    return mesh.backend == "gloo" and mesh.device.type == "cuda"


def _to_wire(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    if _staged(mesh):
        mesh.stats.staged_copies += 1
        mesh.stats.staged_bytes += x.numel() * x.element_size()
        return x.cpu()
    return x.clone()


def _from_wire(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    if _staged(mesh):
        mesh.stats.staged_copies += 1
        mesh.stats.staged_bytes += x.numel() * x.element_size()
        return x.to(mesh.device)
    return x


def _count(mesh: Mesh, name: str) -> None:
    mesh.stats.calls[name] = mesh.stats.calls.get(name, 0) + 1


def _group_rank(mesh: Mesh, r: int) -> int:
    """Global rank of the mesh's rank ``r``."""
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def all_reduce(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks (``psum``); every rank gets the same bits."""
    _count(mesh, "all_reduce")
    if mesh.size == 1 and mesh.backend != "nccl":
        return x.clone()
    w = _to_wire(mesh, x)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=mesh.group)
    return _from_wire(mesh, w)


def reduce_scatter(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks, rank r keeping rows [r k, (r + 1) k) of the
    leading axis (``psum_scatter(scatter_dimension=0, tiled=True)``)."""
    _count(mesh, "reduce_scatter")
    if x.shape[0] % mesh.size:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by "
                         f"{mesh.size} ranks")
    k = x.shape[0] // mesh.size
    if mesh.size == 1 and mesh.backend != "nccl":
        return x.clone()
    w = _to_wire(mesh, x)
    out = torch.empty((k,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=w.device)
    _REDUCE_SCATTER(out, w, op=dist.ReduceOp.SUM, group=mesh.group)
    return _from_wire(mesh, out)


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Rank shards concatenated on the leading axis in rank order
    (``all_gather(tiled=True)``)."""
    _count(mesh, "all_gather")
    if mesh.size == 1 and mesh.backend != "nccl":
        return x.clone()
    w = _to_wire(mesh, x)
    out = torch.empty((x.shape[0] * mesh.size,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=w.device)
    _ALL_GATHER(out, w, group=mesh.group)
    return _from_wire(mesh, out)


def _exchange(mesh: Mesh, sends, recvs) -> None:
    """One batch of point-to-point ops: sends [(tensor, peer)], recvs
    [(tensor, peer)], peers given as mesh ranks."""
    ops = [dist.P2POp(dist.isend, t, _group_rank(mesh, p), group=mesh.group)
           for t, p in sends]
    ops += [dist.P2POp(dist.irecv, t, _group_rank(mesh, p), group=mesh.group)
            for t, p in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def shift(mesh: Mesh, x: torch.Tensor, step: int) -> torch.Tensor:
    """Rank r receives rank r - step's ``x``; ranks with no such peer get
    zeros (``ppermute`` by ``step`` without wrap-around, step +1 or -1)."""
    if step not in (1, -1):
        raise ValueError("shift moves one rank, step +1 or -1")
    _count(mesh, "shift")
    src, dst = mesh.rank - step, mesh.rank + step
    w = _to_wire(mesh, x)
    out = torch.zeros_like(w)
    _exchange(mesh, [(w, dst)] if 0 <= dst < mesh.size else [],
              [(out, src)] if 0 <= src < mesh.size else [])
    return _from_wire(mesh, out)


def halo_exchange(mesh: Mesh, first: torch.Tensor, last: torch.Tensor):
    """Both shifts of a 1-D domain decomposition in one batch: this rank's
    ``last`` goes to rank r + 1 and its ``first`` to rank r - 1. Returns
    (from r - 1, from r + 1), zeros at the two ends."""
    _count(mesh, "halo_exchange")
    wf, wl = _to_wire(mesh, first), _to_wire(mesh, last)
    left, right = torch.zeros_like(wl), torch.zeros_like(wf)
    sends, recvs = [], []
    if mesh.rank + 1 < mesh.size:
        sends.append((wl, mesh.rank + 1))
        recvs.append((right, mesh.rank + 1))
    if mesh.rank > 0:
        sends.append((wf, mesh.rank - 1))
        recvs.append((left, mesh.rank - 1))
    _exchange(mesh, sends, recvs)
    return _from_wire(mesh, left), _from_wire(mesh, right)


# ---------------------------------------------------------------------------
# Spawning ranks
# ---------------------------------------------------------------------------

def to_host(obj):
    """Tensors (also inside dicts, lists, tuples) as numpy arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, n: int, backend: str, store_path: str,
               device: torch.device, threads: int, fn: Callable,
               args: tuple, out_q) -> None:
    try:
        torch.set_num_threads(threads)
        if device.type == "cuda" and device.index is None:
            # one rank a card, round robin (all on one card when there is
            # one)
            device = torch.device("cuda", rank % torch.cuda.device_count())
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n), rank=rank,
            world_size=n,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            result = fn(make_mesh(device=device), *args)
        finally:
            dist.destroy_process_group()
        out_q.put((rank, True, to_host(result)))
    except BaseException:
        out_q.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, n: int, *args, backend: Optional[str] = None,
              device=None, threads: int = 1, timeout_s: float = 900.0
              ) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``n`` spawned ranks; returns their
    results in rank order (tensors as numpy arrays).

    ``fn`` must be importable by module path (spawned ranks import it).
    Each rank sets ``threads`` torch threads, puts its tensors on
    ``device`` (default CUDA, raising without it; "cuda" without an index
    is card r modulo the cards there are) and joins a ``backend`` group
    (default nccl on CUDA, else gloo) through a FileStore. A rank that
    raises fails the run with its traceback; the others are stopped.
    """
    import torch.multiprocessing as tmp

    device = default_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    ctx = tmp.get_context("spawn")
    tmpdir = tempfile.mkdtemp(prefix="tpu_slam_ranks_")
    store = os.path.join(tmpdir, "store")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, backend, store, device, threads, fn,
                               args, out_q),
                         daemon=True)
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        results: List[Any] = [None] * n
        for _ in range(n):
            try:
                rank, ok, payload = out_q.get(timeout=timeout_s)
            except queue_mod.Empty:
                raise TimeoutError(f"ranks silent for {timeout_s} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(timeout=60)
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out_q.close()
        shutil.rmtree(tmpdir, ignore_errors=True)


def rank_results_equal(results: List[Any]) -> bool:
    """Whether every rank returned bit-identical numpy arrays."""
    def flat(obj):
        if isinstance(obj, dict):
            return [x for k in sorted(obj) for x in flat(obj[k])]
        if isinstance(obj, (list, tuple)):
            return [x for v in obj for x in flat(v)]
        return [np.asarray(obj)]

    first = flat(results[0])
    for other in results[1:]:
        for a, b in zip(first, flat(other)):
            if a.shape != b.shape or a.tobytes() != b.tobytes():
                return False
    return True
