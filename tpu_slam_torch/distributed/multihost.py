"""Multi-host bring-up and failure detection on torch.distributed.

Port of ``tpu_slam.distributed.multihost``: process-group initialisation
from the environment, the process index and count, and a collective
heartbeat with a bounded wait (failure detection; recovery is the
checkpoint resume of ``pipeline.checkpoint``). Without a configured
cluster every helper answers for a single process.

``initialize`` reads, where its arguments are omitted, the reference's
variables first and then torch's:

    JAX_COORDINATOR_ADDRESS  or  MASTER_ADDR + MASTER_PORT
                             ("host:port" -> tcp://host:port; an address
                             with a scheme, such as file:///path, is used
                             as the init method as it is)
    JAX_NUM_PROCESSES        or  WORLD_SIZE
    JAX_PROCESS_ID           or  RANK

``backend`` defaults to nccl with CUDA, else gloo.
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Optional

import torch
import torch.distributed as dist

from tpu_slam_torch.distributed import mesh as mesh_mod


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the process group a cluster is configured for.

    Returns True when multi-process mode is active (False, and nothing
    done, without an address or with one process).
    """
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not addr and os.environ.get("MASTER_ADDR"):
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    if not addr:
        return False
    nproc = num_processes or _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE") or 1
    pid = process_id if process_id is not None else (
        _env_int("JAX_PROCESS_ID", "RANK") or 0)
    if nproc <= 1:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    init_method = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(
        backend, init_method=init_method, world_size=nproc, rank=pid,
        timeout=datetime.timedelta(seconds=mesh_mod.COLLECTIVE_TIMEOUT_S))
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0


def heartbeat(mesh: mesh_mod.Mesh, axis_name: str = "data",
              timeout_s: float = 30.0, _probe_fn=None) -> bool:
    """All-reduce heartbeat: True when every rank responds in time.

    A hung or dead peer stalls the all-reduce past ``timeout_s``; the
    caller then recovers from a checkpoint. A collective cannot be
    interrupted mid-call, so the probe runs on a daemon thread and the wait
    is a bounded ``join``: a dead peer leaves the thread blocked in the
    collective, the join times out, and the caller gets False instead of
    hanging with it. ``_probe_fn`` is the fault-injection seam (tests pass
    a probe that hangs or raises in place of a dead peer). ``axis_name``
    names the mesh's one axis, as the reference's signature has it.
    """
    if axis_name != mesh.axis_name:
        raise ValueError(f"mesh axis is {mesh.axis_name!r}, not "
                         f"{axis_name!r}")
    if _probe_fn is None:
        def _probe_fn(x):
            got = mesh_mod.all_reduce(mesh, x)
            if float(got.sum()) != float(mesh.size * mesh.size):
                raise RuntimeError("heartbeat all-reduce returned "
                                   f"{got.tolist()}")

    result = {"ok": False}

    def _run():
        try:
            _probe_fn(torch.ones(mesh.size, dtype=torch.float32,
                                 device=mesh.device))
            result["ok"] = True
        except Exception:
            result["ok"] = False

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    return result["ok"] and not t.is_alive()
