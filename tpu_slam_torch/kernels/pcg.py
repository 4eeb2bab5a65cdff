"""The pose-graph PCG's chunk of CG iterations (``csrc/pcg_chunk.cu``).

``pcg_chunk`` runs ``iters`` masked CG iterations of
``graph/pose_graph.py``'s solve in place on (x, r, p, rz), in one launch of
one thread block, and adds the count of iterations that did work to a
device counter. H·p is node-major: each node sums its incident live edges
in the fixed order of ``pose_graph.node_incidence``'s lists, so there is
no scatter and the result repeats run to run. It takes CUDA tensors only;
its plain version is ``pose_graph._pcg_iterations``, the path the CPU
runs, which sums the same terms in another order.

The kernel runs a thread a node, which keeps its node's CG state and
block of the preconditioner in registers, and keeps p, the per-edge
products and the incidence in shared memory, with a copy of J_j and W_e
of as many edge slots as fit in the rest of the 227 KB a Hopper block may
use (``smem_plan``). So it takes at most 512 node slots, and edge slots
only as many as leave the fixed part of its shared memory within the
limit: c4's 288 nodes and 1,024 edges take 90,900 bytes and copy the
matrices of their first 491 edge slots; the default ``SLAMConfig``'s 512
nodes and 2,048 edges take 170,388 and copy 215. It raises ValueError
for capacities beyond that.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_slam_torch.kernels import _build

# a thread a node slot at most, and the shared memory a Hopper block may
# use (227 KB); csrc/pcg_chunk.cu checks both
THREADS = 512
SMEM_LIMIT = 232_448


def smem_plan(n: int, m: int):
    """(count, stride, bytes) of the kernel's shared memory for ``n``
    node and ``m`` edge slots: the first ``count`` edge slots whose J_j and
    W_e it copies (the live edges are a prefix), the copy's odd stride (0
    and 0 where none fits), and the bytes of the launch. The fixed part
    holds the reductions' partials, p (n, 6), the edge products (6, m),
    Minv (36, n | 1), and the incidence and the edge ends as int32; each
    copied slot takes 72 floats. Raises ValueError if the fixed part or
    the node slots do not fit one block."""
    fixed = (2 * (THREADS // 32) * 8 + (6 * n + 6 * m + 36 * (n | 1)) * 4
             + (n + 1 + 4 * m) * 4)
    if n > THREADS or fixed > SMEM_LIMIT:
        raise ValueError(f"pcg_chunk: {n} node and {m} edge slots do not "
                         f"fit one block (at most {THREADS} nodes, "
                         f"{fixed} of {SMEM_LIMIT} bytes)")
    fit = (SMEM_LIMIT - fixed) // 288
    count = min(m, fit)
    if (count | 1) > fit:
        count -= 1
    stride = count | 1 if count > 0 else 0
    return max(count, 0), stride, fixed + 288 * stride


_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = ([_CI] * 4 + [ctypes.c_size_t] + [_VP] * 5
             + ([_VP] + [_CI] * 3) * 3 + [_VP] * 5 + [_CF, _CF, _CF, _CI, _VP])
_fn = None


def _check(edge_i, edge_j, edge_mask, inc_ptr, inc, Jj, info, Minv, x, r,
           p, rz, used) -> None:
    n, m = x.shape[0], edge_i.shape[0]
    want = (
        (edge_i, (m,), torch.int64), (edge_j, (m,), torch.int64),
        (edge_mask, (m,), torch.bool), (inc_ptr, (n + 1,), torch.int32),
        (inc, (2 * m,), torch.int32), (Jj, (m, 6, 6), torch.float32),
        (info, (m, 6, 6), torch.float32), (Minv, (n, 6, 6), torch.float32),
        (x, (n, 6), torch.float32), (r, (n, 6), torch.float32),
        (p, (n, 6), torch.float32), (rz, (), torch.float32),
        (used, (), torch.int64))
    for k, (t, shape, dtype) in enumerate(want):
        if tuple(t.shape) != shape or t.dtype is not dtype:
            raise ValueError(f"pcg_chunk: argument {k} is {t.dtype} "
                             f"{tuple(t.shape)}, not {dtype} {shape}")
    for k, (t, _, _) in enumerate(want):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"pcg_chunk: argument {k} on {t.device}; all "
                             "must be on one CUDA device")
    # every tensor but the three batches of 6 x 6 matrices is read or
    # written as a flat array
    for k, t in enumerate((edge_i, edge_j, edge_mask, inc_ptr, inc, x, r,
                           p)):
        if not t.is_contiguous():
            raise ValueError(f"pcg_chunk: vector argument {k} must be "
                             "contiguous")


def pcg_chunk(edge_i, edge_j, edge_mask, inc_ptr, inc, Jj, info, Minv, x,
              r, p, rz, used, prior: float, damping: float, tol: float,
              iters: int) -> None:
    """``iters`` masked CG iterations on (x, r, p, rz) in place; the count
    of those whose condition r·r > tol held is added to ``used`` (a ()
    int64 tensor).

    edge_i, edge_j (E,) int64 and edge_mask (E,) bool: the edge table;
    inc_ptr (N + 1,) and inc (2E,) int32: ``pose_graph.node_incidence``;
    Jj, info (E, 6, 6) and Minv (N, 6, 6) float32, any strides: each edge's
    J_j and weighted information, each node's preconditioner block; x, r,
    p (N, 6) contiguous and rz () float32: the CG state. All on one CUDA
    device; capacities as ``smem_plan`` allows. Counts one launch in
    ``pcg_chunk.launches``."""
    _check(edge_i, edge_j, edge_mask, inc_ptr, inc, Jj, info, Minv, x, r, p,
           rz, used)
    n, m = x.shape[0], edge_i.shape[0]
    count, stride, nbytes = smem_plan(n, m)
    global _fn
    if _fn is None:
        _fn = _build.bind("pcg_chunk", "pcg_chunk_launch", _ARGTYPES)
    _build.launch(
        "pcg_chunk", _fn, x.get_device(), n, m, count, stride, nbytes,
        edge_i.data_ptr(), edge_j.data_ptr(), edge_mask.data_ptr(),
        inc_ptr.data_ptr(), inc.data_ptr(), Jj.data_ptr(), *Jj.stride(),
        info.data_ptr(), *info.stride(), Minv.data_ptr(), *Minv.stride(),
        x.data_ptr(), r.data_ptr(), p.data_ptr(), rz.data_ptr(),
        used.data_ptr(), prior, damping, tol, iters)
    pcg_chunk.launches += 1


pcg_chunk.launches = 0
