"""Scan-Context appearance descriptors for loop-closure candidates.

Port of ``tpu_slam.graph.scan_context``: a polar ring x sector max-height
descriptor per keyframe (Kim & Kim's Scan Context), matched
rotation-invariantly by scoring every sector shift in one contraction.
The descriptor's segment max is ``scatter_reduce_(..., "amax")`` over a
-inf buffer; a maximum does not depend on the order of the writes, so the
descriptor is the same run to run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from tpu_slam_torch.core.pointcloud import PointCloud


@dataclasses.dataclass(frozen=True)
class ScanContextParams:
    """Static descriptor configuration (the reference's fields)."""

    n_rings: int = 16                # radial bins
    n_sectors: int = 60              # azimuthal bins
    max_range: float = 40.0          # radial extent of the descriptor
    min_z: float = -2.0              # height offset so empty != low
    intensity_weight: float = 0.0    # > 0 adds w * per-bin max intensity
                                     # (attrs channel 0) to each bin


def _segment_max(values: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    out = torch.full((num_segments,), -math.inf, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, seg, values, "amax")


def scan_context(cloud: PointCloud,
                 params: ScanContextParams = ScanContextParams()
                 ) -> torch.Tensor:
    """(R, S) max-height descriptor of a body-frame cloud.

    Empty bins read 0; occupied bins read (max z - min_z), strictly
    positive.
    """
    R, S = params.n_rings, params.n_sectors
    pts = cloud.points
    rng = torch.linalg.vector_norm(pts[:, :2], dim=1)
    az = torch.atan2(pts[:, 1], pts[:, 0])            # [-pi, pi)
    # one multiply by the folded constant (R / max_range, S / 2 pi): the
    # rounding the reference's compiled x / c * d has, so points on a bin
    # boundary land in the same bin
    ring = torch.clamp((rng * (R / params.max_range)).to(torch.int32),
                       0, R - 1)
    sect = torch.clamp(((az + math.pi) * (S / (2 * math.pi)))
                       .to(torch.int32), 0, S - 1)
    ok = cloud.mask & (rng <= params.max_range)
    bin_id = torch.where(ok, ring * S + sect, R * S).long()  # invalid: dropped
    z = torch.where(ok, pts[:, 2] - params.min_z, -math.inf)
    desc = torch.clamp(_segment_max(z, bin_id, R * S + 1)[:R * S], min=0.0)
    if params.intensity_weight > 0.0 and cloud.attrs is not None:
        inten = torch.where(ok, cloud.attrs[:, 0], -math.inf)
        di = _segment_max(inten, bin_id, R * S + 1)[:R * S]
        desc = desc + params.intensity_weight * torch.clamp(di, min=0.0)
    return desc.reshape(R, S)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """(R,) rotation-invariant occupancy-mean key (cheap prefilter)."""
    return torch.mean((desc > 0.0).to(torch.float32), dim=-1)


def sc_distance(query: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Min-over-rotation Scan-Context distance of ``query`` to each db row.

    query: (R, S); db: (N, R, S). Returns (N,) distances in [0, 1]:
    1 - max_shift mean_col cos(query_col, db_col), the S shifts stacked
    once and contracted against the database.
    """
    S = query.shape[1]
    shifts = torch.stack([torch.roll(query, k, dims=1) for k in range(S)])
    qn = shifts / torch.clamp(torch.linalg.vector_norm(shifts, dim=1,
                                                       keepdim=True),
                              min=1e-9)                          # (S, R, S)
    dn = db / torch.clamp(torch.linalg.vector_norm(db, dim=1, keepdim=True),
                          min=1e-9)
    cos = torch.einsum("krs,nrs->nks", qn, dn)                   # (N, S, S)
    nonzero = ((shifts > 0).any(dim=1)[None, :, :]
               & (db > 0).any(dim=1)[:, None, :])
    n_cols = torch.clamp(nonzero.sum(dim=-1), min=1)
    sim = torch.where(nonzero, cos, 0.0).sum(dim=-1) / n_cols    # (N, S)
    return 1.0 - sim.max(dim=-1).values


def propose_sc_candidates(query_desc: torch.Tensor, db_desc: torch.Tensor,
                          query_idx: int, n_nodes: int,
                          max_distance: float, min_index_gap: int,
                          top_k: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """Scan-context candidates (i, query_idx) for the newest keyframe.

    One device call scores the whole database; the top-k under
    ``max_distance`` (respecting the index gap) come back as numpy index
    arrays for the ICP verification batch.
    """
    if query_idx < min_index_gap + 1:
        return (np.zeros((0,), np.int32), np.zeros((0,), np.int32))
    d = sc_distance(query_desc, db_desc).cpu().numpy().copy()
    d[n_nodes:] = np.inf                               # empty slots
    d[max(0, query_idx - min_index_gap):] = np.inf     # too recent + self
    order = np.argsort(d, kind="stable")[:top_k]
    keep = order[d[order] <= max_distance]
    ci = keep.astype(np.int32)
    cj = np.full_like(ci, query_idx)
    return ci, cj
