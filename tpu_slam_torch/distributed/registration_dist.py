"""Data-parallel registration across ranks.

Port of ``tpu_slam.distributed.registration_dist``. Independent scan-pair
registrations (loop-closure candidate verification, multi-session
alignment, calibration sweeps) are the DP axis: the batch is padded to a
multiple of the ranks (padding pairs are all-invalid clouds with identity
inits), each rank runs the batched ``registration.icp`` on its contiguous
shard of pairs (on the card that is the ``nn_search`` kernel,
csrc/nn_search.cu), and one all-gather a result field returns the whole
batch to every rank, padding stripped. No traffic during the solves.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_slam_torch.core.pointcloud import PAD_COORD, PointCloud
from tpu_slam_torch.distributed import mesh as mesh_mod
from tpu_slam_torch.registration.icp import ICPParams, ICPResult, icp


def pad_batch(x: torch.Tensor, multiple: int, fill) -> torch.Tensor:
    """``x`` with rows of ``fill`` appended to a multiple of ``multiple``."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad = torch.full((rem,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=0)


def sharded_pairwise_icp(mesh: mesh_mod.Mesh,
                         src_points: torch.Tensor,   # (B, P, 3)
                         src_mask: torch.Tensor,     # (B, P)
                         tgt_points: torch.Tensor,   # (B, P, 3)
                         tgt_mask: torch.Tensor,     # (B, P)
                         init_T: torch.Tensor,       # (B, 4, 4)
                         params: ICPParams = ICPParams(),
                         axis_name: Optional[str] = None) -> ICPResult:
    """Register B independent pairs, sharded over the mesh's ranks.

    Every rank passes the whole batch (replicated) and gets the whole
    batched ICPResult (leading axis B, padding stripped).
    """
    if axis_name is not None and axis_name != mesh.axis_name:
        raise ValueError(f"mesh axis is {mesh.axis_name!r}")
    b = src_points.shape[0]
    n = mesh.size
    sp = pad_batch(src_points, n, PAD_COORD)
    sm = pad_batch(src_mask, n, False)
    tp = pad_batch(tgt_points, n, PAD_COORD)
    tm = pad_batch(tgt_mask, n, False)
    t0 = pad_batch(init_T, n, 0.0)
    if t0.shape[0] != b:
        # padding inits must stay invertible
        t0 = t0.clone()
        t0[b:] = torch.eye(4, dtype=t0.dtype, device=t0.device)
    k = sp.shape[0] // n
    lo, hi = mesh.rank * k, (mesh.rank + 1) * k
    # the sharded programs run eagerly: a rank's share takes icp's
    # host-exit form
    res = icp(PointCloud(points=sp[lo:hi], mask=sm[lo:hi]),
              PointCloud(points=tp[lo:hi], mask=tm[lo:hi]),
              init_T=t0[lo:hi], params=params, compiled=False)
    f32 = torch.float32

    def gather(x):
        return mesh_mod.all_gather(mesh, x)[:b]

    return ICPResult(
        T=gather(res.T), iterations=gather(res.iterations),
        error=gather(res.error), matched_fraction=gather(res.matched_fraction),
        converged=gather(res.converged.to(f32)) > 0.5)
