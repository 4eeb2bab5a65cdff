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
hand-written CUDA kernel ``csrc/nn_search.cu`` for CUDA tensors (one launch
for all B pairs) and calls ``nearest_neighbors_plain`` for CPU tensors;
there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

BLOCK_THREADS = 256       # must equal kThreads in csrc/nn_search.cu
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


def _library():
    from tpu_slam_torch.kernels import _build

    lib = _build.load("nn_search")
    fn = lib.nn_search_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp]
        fn.restype = ci
        lib.nn_search_block_threads.argtypes = []
        lib.nn_search_block_threads.restype = ci
        if lib.nn_search_block_threads() != BLOCK_THREADS:
            raise RuntimeError("csrc/nn_search.cu block size does not match "
                               "BLOCK_THREADS")
    return fn


def nearest_neighbors(query: torch.Tensor, target: torch.Tensor,
                      squared: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx int32, dist) of each query's nearest target; see the module doc.

    CUDA tensors run the kernel of ``csrc/nn_search.cu`` (built with nvcc
    at first use) and count one launch in ``nearest_neighbors.launches``;
    CPU tensors run ``nearest_neighbors_plain``. Anything else raises.
    """
    _check_inputs(query, target)
    dev = query.device
    if dev.type == "cpu":
        return nearest_neighbors_plain(query, target, squared=squared)
    if dev.type != "cuda":
        raise ValueError(f"nearest_neighbors: unsupported device {dev}")
    single = query.dim() == 2
    q = (query[None] if single else query).contiguous()
    t = (target[None] if single else target).contiguous()
    b, n, m = q.shape[0], q.shape[1], t.shape[1]
    if b * max(n, m) * 3 >= 2 ** 31:
        raise ValueError("nearest_neighbors: batch too large for int32 "
                         "offsets")
    idx = torch.empty((b, n), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b and n:
        launch = _library()
        with torch.cuda.device(dev):
            rc = launch(q.data_ptr(), t.data_ptr(), b, n, m, idx.data_ptr(),
                        d2.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"nn_search kernel launch failed: CUDA error "
                               f"{rc}")
        nearest_neighbors.launches += 1
    if single:
        idx, d2 = idx[0], d2[0]
    return idx, (d2 if squared else torch.sqrt(torch.clamp(d2, min=0.0)))


nearest_neighbors.launches = 0
