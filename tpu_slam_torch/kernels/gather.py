"""Row gathers — the kernels of the gather probes (``benchmarks/``).

Ports of the TPU probes' kernel bodies, which were lowerings of three
functions (see ``csrc/gather.cu``):

    gather_rows(table, idx)      take_along_axis(table, idx, axis=0); idx
                                 (M,) is one index per row, broadcast over
                                 the columns, or (M, C) one per element
    gather_row_sum(table, idx)   the gathered rows summed left to right
    onehot_gather(table, idx)    the one-hot product's gather: table[idx],
                                 a zero row for an index outside the table,
                                 values rounded to bfloat16 first if asked

table is (R, C) float32, idx int32. In ``gather_rows`` and
``gather_row_sum`` an index outside [0, R) gives NaN. Each wrapper launches
its CUDA kernel for CUDA tensors and calls its plain PyTorch version for
CPU tensors; there is no fallback between the two. All three launch
through ``_build``'s lean path (bound once, the raw current stream read at
each call).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_slam_torch.kernels import _build


_F32, _I32 = torch.float32, torch.int32


def _check(name: str, table: torch.Tensor, idx: torch.Tensor,
           per_element_ok: bool) -> None:
    shape = table.shape
    if table.dtype is not _F32 or len(shape) != 2:
        raise ValueError(f"{name}: table must be (R, C) float32, got "
                         f"{table.dtype} {tuple(shape)}")
    if idx.dtype is not _I32:
        raise ValueError(f"{name}: idx must be int32, got {idx.dtype}")
    ishape = idx.shape
    d = len(ishape)
    rows, cols = shape
    if not (d == 1 or (d == 2 and per_element_ok and ishape[1] == cols)):
        raise ValueError(f"{name}: idx of shape {tuple(ishape)} does not "
                         f"fit a table of shape {tuple(shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if (table.get_device() != idx.get_device() if table.is_cuda
            else table.device != idx.device):
        raise ValueError(f"{name}: inputs on different devices "
                         f"({table.device} vs {idx.device})")
    if rows == 0 or cols == 0:
        raise ValueError(f"{name}: empty table")
    if ishape[0] * cols >= 2 ** 31:
        raise ValueError(f"{name}: output too large for int32 sizes")


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "gather_rows_launch": [_VP, _CI, _CI, _VP, _CI, _CI, _VP, _VP],
    "gather_row_sum_launch": [_VP, _CI, _CI, _VP, _CI, _VP, _VP],
    "onehot_gather_launch": [_VP, _CI, _CI, _VP, _CI, _CI, _VP, _VP]}
_fns = {}


def _fn(symbol: str):
    """The bound launch function ``symbol`` of ``csrc/gather.cu``."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = _fns[symbol] = _build.bind("gather", symbol, _ARGTYPES[symbol])
    return fn


def _in_table(table: torch.Tensor, idx: torch.Tensor):
    ok = (idx >= 0) & (idx < table.shape[0])
    return ok, torch.where(ok, idx, 0).long()


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``gather_rows`` (``torch.gather``)."""
    _check("gather_rows", table, idx, per_element_ok=True)
    gather_rows_plain.launches += 1
    if idx.dim() == 1:
        idx = idx[:, None].expand(-1, table.shape[1])
    ok, safe = _in_table(table, idx)
    return torch.where(ok, torch.gather(table, 0, safe), float("nan"))


gather_rows_plain.launches = 0


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(M, C) float32: out[i, j] = table[idx[i, j], j] (idx (M, C)) or
    table[idx[i], j] (idx (M,)). CUDA tensors run the kernel of
    ``csrc/gather.cu`` and count one launch in ``gather_rows.launches``."""
    _check("gather_rows", table, idx, per_element_ok=True)
    if not _on_cuda("gather_rows", table):
        return gather_rows_plain(table, idx)
    rows, cols = table.shape
    m = idx.shape[0]
    out = table.new_empty((m, cols))
    if m:
        _build.launch("gather_rows", _fn("gather_rows_launch"),
                      table.get_device(), table.data_ptr(), rows, cols,
                      idx.data_ptr(), int(idx.dim() == 2), m, out.data_ptr())
        gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_row_sum_plain(table: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``gather_row_sum``: the gathered rows summed
    column by column, left to right, as the kernel sums them."""
    _check("gather_row_sum", table, idx, per_element_ok=False)
    gather_row_sum_plain.launches += 1
    ok, safe = _in_table(table, idx)
    rows = table[safe]
    acc = rows[:, 0]
    for j in range(1, table.shape[1]):
        acc = acc + rows[:, j]
    return torch.where(ok, acc, float("nan"))


gather_row_sum_plain.launches = 0


def gather_row_sum(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(M,) float32: sum_j table[idx[i], j], left to right. CUDA tensors run
    the kernel of ``csrc/gather.cu`` and count one launch in
    ``gather_row_sum.launches``."""
    _check("gather_row_sum", table, idx, per_element_ok=False)
    if not _on_cuda("gather_row_sum", table):
        return gather_row_sum_plain(table, idx)
    rows, cols = table.shape
    m = idx.shape[0]
    out = table.new_empty((m,))
    if m:
        _build.launch("gather_row_sum", _fn("gather_row_sum_launch"),
                      table.get_device(), table.data_ptr(), rows, cols,
                      idx.data_ptr(), m, out.data_ptr())
        gather_row_sum.launches += 1
    return out


gather_row_sum.launches = 0


def onehot_gather_plain(table: torch.Tensor, idx: torch.Tensor,
                        bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``onehot_gather``: the literal product of
    the (M, R) one-hot matrix and the table (rounded to bfloat16 first when
    ``bf16``), in float32. Exact for a finite table: each output is one
    product 1 * t plus zeros."""
    _check("onehot_gather", table, idx, per_element_ok=False)
    onehot_gather_plain.launches += 1
    rows = torch.arange(table.shape[0], device=table.device)
    onehot = (idx.long()[:, None] == rows[None, :]).to(torch.float32)
    tab = table.to(torch.bfloat16).to(torch.float32) if bf16 else table
    return onehot @ tab


onehot_gather_plain.launches = 0


def onehot_gather(table: torch.Tensor, idx: torch.Tensor,
                  bf16: bool = False) -> torch.Tensor:
    """(M, C) float32: table[idx[i]] (bfloat16-rounded when ``bf16``), a
    zero row for an index outside the table. CUDA tensors run the kernel of
    ``csrc/gather.cu`` and count one launch in ``onehot_gather.launches``."""
    _check("onehot_gather", table, idx, per_element_ok=False)
    if not _on_cuda("onehot_gather", table):
        return onehot_gather_plain(table, idx, bf16=bf16)
    rows, cols = table.shape
    m = idx.shape[0]
    out = table.new_empty((m, cols))
    if m:
        _build.launch("onehot_gather", _fn("onehot_gather_launch"),
                      table.get_device(), table.data_ptr(), rows, cols,
                      idx.data_ptr(), int(bf16), m, out.data_ptr())
        onehot_gather.launches += 1
    return out


onehot_gather.launches = 0
