"""Sharded dense-window odometry step: the production engine over ranks.

Port of ``tpu_slam.distributed.dense_shard``. The moment window's rows are
x-major, so a contiguous block of rows is an x-chunk: rank d owns the
(Wx / D, Wy, Wz) cells of planes [d Wx / D, (d + 1) Wx / D) of the same
global lattice.

  * the NDT field is ``grid_ndt_field``'s, with the x moment pass fed by
    one halo exchange (``map_shard.chunk_field_rows``: the rank's rows are
    bit-identical to those planes of the single-device field);
  * the registration splits the scan by point ownership and runs the
    ``ndt_terms`` kernel (csrc/ndt_terms.cu) on each rank's share, one
    all-reduce an evaluation, in the single-device engine's LM schedule
    (``map_shard.kernel_tier_fns``): the matched count is exact at the
    chunk seams;
  * the insert adds to each rank's chunk the scan points binned in it, each
    point's cell and moments computed in the whole window's frame
    (``dense_map.insert_rows``).

The step is the reference's compiled program. On NCCL (``compiled=None``,
the default, or True) it is one CUDA graph for each signature of its
inputs and its static arguments, its collectives captured with the rest:
the sync-free LM (``lm_schedule(sync_free=True)``, fixed trips frozen by
the reference's condition) and metrics that stay on the card. On gloo,
whose collectives go through host memory, it runs the eager form: the
host-exit LM and the iteration count read back (``compiled=False``
everywhere; the same bits). ``compiled=True`` on gloo raises
(``mesh.captured_form``).

The step mirrors ``DenseLidarOdometry.step`` at ``pyramid_factor=1`` with
the window inside its deadband (no scroll): the clamped constant-velocity
prediction, the staged re-binned LM, the acceptance gate, the polar-Newton
orthonormalisation, and the insert, gated as the single-device engine
gates it on ``min_insert_fraction`` as well as on acceptance (the reference
gates its sharded insert on acceptance only, and so inserts scans the
single-device engine skips). Scrolling the sharded window is not
implemented, as in the reference.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.distributed import mesh as mesh_mod
from tpu_slam_torch.distributed.map_shard import (chunk_field_rows,
                                                  kernel_tier_fns)
from tpu_slam_torch.kernels.ndt_terms import ndt_terms
from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
from tpu_slam_torch.mapping.dense_map import insert_rows
from tpu_slam_torch.registration.ndt import NDTParams, lm_schedule
from tpu_slam_torch.utils.capture import compiled_call

# the captured steps, one for each (inputs' signature, mesh, static
# arguments)
_steps: Dict = {}


def dense_step_sharded(mesh: mesh_mod.Mesh, rows: torch.Tensor,
                       origin_cell: torch.Tensor, pose: torch.Tensor,
                       last_delta: torch.Tensor, scan: PointCloud,
                       spec: VoxelGridSpec, dims: Tuple[int, int, int],
                       params: NDTParams = NDTParams(),
                       axis_name: Optional[str] = None,
                       min_accept_fraction: float = 0.3,
                       min_insert_fraction: float = 0.4,
                       max_pred_translation: float = 0.7,
                       max_pred_rotation: float = 0.3,
                       compiled: Optional[bool] = None):
    """One sharded dense-window odometry step.

    Args:
      rows: (Wx/D * Wy * Wz, 10) this rank's x-chunk of the window moments.
      origin_cell: (3,) the window's corner cell (replicated).
      pose, last_delta: (4, 4), replicated.
      scan: the DOWNSAMPLED body-frame scan, replicated.
      min_accept_fraction, min_insert_fraction, max_pred_translation,
      max_pred_rotation: ``OdometryConfig``'s fields of the same names
      (their defaults).
      compiled: the captured step or the eager one (module docstring).

    Returns (rows', pose', delta', metrics (5,) [iterations, matched
    fraction, accepted, inserted, 1]), every rank the same pose.
    """
    if axis_name is not None and axis_name != mesh.axis_name:
        raise ValueError(f"mesh axis is {mesh.axis_name!r}")
    wx, wy, wz = dims
    n = mesh.size
    if wx % n or (wx // n) % 8 or wz % 8:
        raise ValueError(f"dims {dims} not shardable over {n} ranks "
                         "(x-chunk and Wz must be multiples of 8)")
    gates = dict(min_accept_fraction=min_accept_fraction,
                 min_insert_fraction=min_insert_fraction,
                 max_pred_translation=max_pred_translation,
                 max_pred_rotation=max_pred_rotation)
    args = (rows, origin_cell, pose, last_delta, scan)
    if not mesh_mod.captured_form(mesh, compiled):
        return _step_body(mesh, *args, spec=spec, dims=dims, params=params,
                          sync_free=False, **gates)
    body = functools.partial(_step_body, mesh, spec=spec, dims=dims,
                             params=params, sync_free=True, **gates)
    return compiled_call(_steps, body, args, static=(
        mesh_mod.program_key(mesh), spec, dims, params,
        tuple(gates.items())), counters=(ndt_terms,))


def _step_body(mesh: mesh_mod.Mesh, rows: torch.Tensor,
               origin_cell: torch.Tensor, pose: torch.Tensor,
               last_delta: torch.Tensor, scan: PointCloud,
               spec: VoxelGridSpec, dims: Tuple[int, int, int],
               params: NDTParams, sync_free: bool,
               min_accept_fraction: float, min_insert_fraction: float,
               max_pred_translation: float, max_pred_rotation: float):
    """The step; with ``sync_free`` it reads nothing back (the captured
    step's body), else its LM exits on host reads (the eager form)."""
    wx, wy, wz = dims
    s = wx // mesh.size
    dev = rows.device
    f32 = torch.float32

    # the field: grid_ndt_field's (occupied where the cell's count > 0)
    chunk = torch.cat([rows, (rows[:, :1] > 0.0).to(f32)], dim=1)
    rows16 = chunk_field_rows(mesh, chunk.reshape(s, wy, wz, 11),
                              origin_cell, dims, spec,
                              params.min_voxel_count,
                              params.evec_floor_ratio, count_floor=1e-6)

    # the clamped constant-velocity prediction (DenseLidarOdometry's)
    xi = se3.log(last_delta)
    t_n = torch.linalg.vector_norm(xi[:3])
    r_n = torch.linalg.vector_norm(xi[3:])
    scale = torch.minimum(
        torch.clamp(max_pred_translation / torch.clamp(t_n, min=1e-9),
                    max=1.0),
        torch.clamp(max_pred_rotation / torch.clamp(r_n, min=1e-9),
                    max=1.0))
    init_T = pose @ se3.exp(xi * scale)

    src = scan.sanitize()
    raw_terms, bin_raster, yaw_cost = kernel_tier_fns(
        mesh, src, rows16, origin_cell, dims, spec, params)
    T, iters, frac, _, _ = lm_schedule(init_T, params, True, raw_terms,
                                       bin_raster, yaw_cost,
                                       sync_free=sync_free)
    del rows16

    accepted = frac >= min_accept_fraction
    T = se3.orthonormalize(torch.where(accepted, T, init_T))
    delta = se3.inverse(pose) @ T
    weight = (accepted & (frac >= min_insert_fraction)).to(f32)
    rows_new = insert_rows(rows.clone(), origin_cell, dims,
                           scan.transform(T), spec, weight,
                           x_range=(mesh.rank * s, (mesh.rank + 1) * s))
    iterations = (iters.to(f32) if sync_free
                  else torch.full((), float(iters), device=dev))
    metrics = torch.stack([
        iterations, frac, accepted.to(f32), weight,
        torch.ones((), dtype=f32, device=dev)])
    return rows_new, T, delta, metrics
