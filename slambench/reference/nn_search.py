"""Frozen copy of ``tpu_slam_torch.kernels.nn_search``' plain path.

Brute-force nearest neighbours, the correspondence pass of ICP: for each
query point, the index and distance of its nearest target point. The
squared distance is an explicit difference,
``((qx-tx)^2 + (qy-ty)^2) + (qz-tz)^2``, and the lowest index wins a tie.
Padding rows sit at PAD_COORD (1e8): a padding target never beats a valid
one, and padding queries get whatever comes out (callers mask them). One
pair, query (N, 3) and target (M, 3), or a batch, (B, N, 3) and (B, M, 3).
``nearest_neighbors`` is the plain version on every device.
"""

from __future__ import annotations

from typing import Tuple

import torch


QUERY_CHUNK = 512         # plain version: queries per distance block


def _check_inputs(query: torch.Tensor, target: torch.Tensor) -> None:
    if query.dim() not in (2, 3) or target.dim() != query.dim():
        raise ValueError("nearest_neighbors: expected (N, 3) and (M, 3), or "
                         f"(B, N, 3) and (B, M, 3); got {tuple(query.shape)} "
                         f"and {tuple(target.shape)}")
    if query.shape[-1] != 3 or target.shape[-1] != 3 or \
            query.shape[:-2] != target.shape[:-2]:
        raise ValueError("nearest_neighbors: shapes do not pair up: "
                         f"{tuple(query.shape)} and {tuple(target.shape)}")
    if query.dtype != torch.float32 or target.dtype != torch.float32:
        raise ValueError("nearest_neighbors: inputs must be float32")
    if target.shape[-2] == 0:
        raise ValueError("nearest_neighbors: empty target")
    if query.device != target.device:
        raise ValueError("nearest_neighbors: inputs on different devices "
                         f"({query.device} vs {target.device})")


def nearest_neighbors_plain(query: torch.Tensor, target: torch.Tensor,
                            squared: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (idx int32, dist) of each query's nearest target.

    Chunked over queries (QUERY_CHUNK at a time, as the reference's XLA
    twin); the squared distance is summed over x, y, z in that order, each
    product and sum a separate rounded op, exactly as the CUDA kernel
    forms it. ``squared`` returns d^2 instead of the distance.
    """
    _check_inputs(query, target)
    idx_parts, d2_parts = [], []
    for s in range(0, query.shape[-2], QUERY_CHUNK):
        qc = query[..., s:s + QUERY_CHUNK, :]
        d = None
        for c in range(3):
            diff = qc[..., :, c:c + 1] - target[..., None, :, c]
            sq = diff * diff
            d = sq if d is None else d + sq
        i = torch.argmin(d, dim=-1)          # first minimum: lowest index
        idx_parts.append(i.to(torch.int32))
        d2_parts.append(torch.gather(d, -1, i[..., None])[..., 0])
    idx = torch.cat(idx_parts, dim=-1)
    d2 = torch.cat(d2_parts, dim=-1)
    return idx, (d2 if squared else torch.sqrt(torch.clamp(d2, min=0.0)))


nearest_neighbors = nearest_neighbors_plain
