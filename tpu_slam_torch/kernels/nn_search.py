"""Brute-force nearest neighbours — the correspondence pass of pair ICP.

Port of the brute-force tier of ``tpu_slam.kernels.nn_search``: for each
query point, the index and distance of its nearest target point. The
squared distance is formed as an explicit difference,
``((qx-tx)^2 + (qy-ty)^2) + (qz-tz)^2`` (precise at cm scale, unlike the
|q|^2 + |t|^2 - 2 q.t form), and the lowest index wins a tie. Padding rows
sit at PAD_COORD (1e8): a padding target never beats a valid one, and
padding queries get whatever comes out (callers mask them).

Both functions take one pair, query (N, 3) and target (M, 3), or a batch
of pairs, (B, N, 3) and (B, M, 3). ``nearest_neighbors`` launches the
hand-written CUDA kernels of ``csrc/nn_search.cu`` for CUDA tensors (one
call for all B pairs) and calls ``nearest_neighbors_plain`` for CPU
tensors; there is no fallback between the two.

On the card the target range may be cut into splits (``split_plan``), each
scanned by its own blocks, and the splits' results merged in ascending
order with a strict '<': the minimum of d^2 with the lowest index on ties
does not depend on the cut, so the result is the one-pass result bit for
bit. Each split keeps
the minimum and the 32-target group that holds it; a second launch merges
the splits and finds each query's index in its group
(``split_scan_plain`` and ``merge_splits_plain`` are the two kernels'
plain versions).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tpu_slam_torch.kernels import _build

BLOCK_QUERIES = 512       # must equal kThreads * kR in csrc/nn_search.cu
FILL_BLOCKS = 8192        # split the targets until the grid has this many
MIN_SPLIT_TARGETS = 512   # blocks, no split shorter than this, and no
MAX_SPLITS = 256          # more splits than this (the merge walks them)
QUERY_CHUNK = 512         # plain version: queries per distance block
GROUP = 32                # must equal kGroup in csrc/nn_search.cu


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
    nearest_neighbors_plain.launches += 1
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


nearest_neighbors_plain.launches = 0


def plan_for_splits(m: int, splits: int) -> Tuple[int, int]:
    """(splits, chunk) that cut m targets into at most ``splits`` ranges of
    ``chunk`` (the last one ragged): none is empty, so the count may come
    out below the one asked for."""
    chunk = max(1, -(-m // max(1, splits)))
    return -(-m // chunk), chunk


def split_plan(b: int, n: int, m: int) -> Tuple[int, int]:
    """(splits, chunk) of the kernel's target range for b pairs of n
    queries and m targets: enough splits that the grid reaches FILL_BLOCKS
    blocks, none shorter than MIN_SPLIT_TARGETS targets, at most
    MAX_SPLITS; one split when the query blocks fill the card alone."""
    query_blocks = max(1, -(-n // BLOCK_QUERIES) * b)
    want = -(-FILL_BLOCKS // query_blocks)
    want = min(want, max(1, m // MIN_SPLIT_TARGETS), MAX_SPLITS)
    return plan_for_splits(m, want)


def _d2_plain(query: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """d^2 of each query to its own point (both (..., 3)), op by op in the
    order of ``nearest_neighbors_plain``."""
    d = None
    for c in range(3):
        diff = query[..., c] - points[..., c]
        sq = diff * diff
        d = sq if d is None else d + sq
    return d


def split_scan_plain(query: torch.Tensor, target: torch.Tensor, splits: int,
                     chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the main kernel under a plan: for each split of
    ``chunk`` targets, each query's minimum d^2 and the first target of the
    GROUP-target group (counted from the split's start) that holds its
    first occurrence; -1 and 3.0e38 where no d^2 falls below 3.0e38.
    Returns (d2, group), each (splits, ..., n)."""
    d2s, groups = [], []
    for s in range(splits):
        lo = s * chunk
        i, d2 = nearest_neighbors_plain(query, target[..., lo:lo + chunk, :],
                                        squared=True)
        found = d2 < 3.0e38
        d2s.append(torch.where(found, d2, 3.0e38))
        groups.append(torch.where(found, lo + i // GROUP * GROUP, -1))
    return torch.stack(d2s), torch.stack(groups)


def merge_splits_plain(d2: torch.Tensor, group: torch.Tensor,
                       query: torch.Tensor, target: torch.Tensor, chunk: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the merge kernel: (idx, d2) from the splits' (d2,
    group) of ``split_scan_plain``. The earliest split at the minimum (a
    strict '<' in ascending order), then the lowest index of its group
    whose recomputed d^2 equals the minimum."""
    best, split = d2[0], torch.zeros_like(group[0])
    for s in range(1, d2.shape[0]):
        better = d2[s] < best
        best = torch.where(better, d2[s], best)
        split = torch.where(better, s, split)
    g0 = torch.gather(group, 0, split[None])[0]
    end = torch.clamp((split + 1) * chunk, max=target.shape[-2])
    idx = torch.full_like(g0, -1)
    for k in reversed(range(GROUP)):
        cand = g0 + k
        ok = (g0 >= 0) & (cand < end)
        safe = torch.where(ok, cand, 0).long()
        pts = torch.gather(target, -2, safe[..., None].expand(
            safe.shape + (3,)))
        hit = ok & (_d2_plain(query, pts) == best)
        idx = torch.where(hit, cand, idx)
    return idx, best


_launch_fn = None


def _bound():
    global _launch_fn
    if _launch_fn is None:
        lib = _build.load("nn_search")
        lib.nn_search_block_queries.restype = ctypes.c_int
        if lib.nn_search_block_queries() != BLOCK_QUERIES:
            raise RuntimeError("csrc/nn_search.cu's queries a block do not "
                               "match BLOCK_QUERIES")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        _launch_fn = _build.bind("nn_search", "nn_search_launch",
                                 [vp, vp, ci, ci, ci, ci, ci, vp, vp, vp, vp])
    return _launch_fn


def nearest_neighbors(query: torch.Tensor, target: torch.Tensor,
                      squared: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx int32, dist) of each query's nearest target; see the module doc.

    CUDA tensors run the kernels of ``csrc/nn_search.cu`` (built with nvcc
    at first use; the split plan of ``split_plan``) and count one call in
    ``nearest_neighbors.launches``; CPU tensors run
    ``nearest_neighbors_plain``. Anything else raises.
    """
    _check_inputs(query, target)
    if not query.is_cuda:
        if query.device.type != "cpu":
            raise ValueError("nearest_neighbors: unsupported device "
                             f"{query.device}")
        return nearest_neighbors_plain(query, target, squared=squared)
    single = query.dim() == 2
    q = (query[None] if single else query).contiguous()
    t = (target[None] if single else target).contiguous()
    b, n, m = q.shape[0], q.shape[1], t.shape[1]
    if b * max(n * 32, m * 3) >= 2 ** 31:
        raise ValueError("nearest_neighbors: batch too large for int32 "
                         "offsets")
    dev = q.device
    idx = torch.empty((b, n), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b and n:
        splits, chunk = split_plan(b, n, m)
        # each split's (d^2, group) of every query
        scratch = torch.empty(2 * splits * b * n, dtype=torch.float32,
                              device=dev)
        _build.launch("nn_search", _bound(), q.get_device(), q.data_ptr(),
                      t.data_ptr(), b, n, m, splits, chunk, idx.data_ptr(),
                      d2.data_ptr(), scratch.data_ptr())
        nearest_neighbors.launches += 1
    if single:
        idx, d2 = idx[0], d2[0]
    return idx, (d2 if squared else torch.sqrt(torch.clamp(d2, min=0.0)))


nearest_neighbors.launches = 0
