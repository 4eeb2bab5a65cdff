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
CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch


def _check(name: str, table: torch.Tensor, idx: torch.Tensor,
           per_element_ok: bool) -> None:
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError(f"{name}: table must be (R, C) float32, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be int32, got {idx.dtype}")
    shapes = [(idx.shape[0],)] if idx.dim() >= 1 else []
    if per_element_ok and idx.dim() == 2:
        shapes.append((idx.shape[0], table.shape[1]))
    if tuple(idx.shape) not in shapes:
        raise ValueError(f"{name}: idx of shape {tuple(idx.shape)} does not "
                         f"fit a table of shape {tuple(table.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if table.device != idx.device:
        raise ValueError(f"{name}: inputs on different devices "
                         f"({table.device} vs {idx.device})")
    if table.shape[0] == 0 or table.shape[1] == 0:
        raise ValueError(f"{name}: empty table")
    if idx.shape[0] * table.shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: output too large for int32 sizes")


def _device(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def _library():
    from tpu_slam_torch.kernels import _build

    lib = _build.load("gather")
    if lib.gather_rows_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gather_rows_launch.argtypes = [vp, ci, ci, vp, ci, ci, vp, vp]
        lib.gather_row_sum_launch.argtypes = [vp, ci, ci, vp, ci, vp, vp]
        lib.onehot_gather_launch.argtypes = [vp, ci, ci, vp, ci, ci, vp, vp]
        for fn in (lib.gather_rows_launch, lib.gather_row_sum_launch,
                   lib.onehot_gather_launch):
            fn.restype = ci
    return lib


def _launch(name: str, fn, *args) -> None:
    dev = args[0].device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        rc = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


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
    if _device("gather_rows", table) == "cpu":
        return gather_rows_plain(table, idx)
    m, cols = idx.shape[0], table.shape[1]
    out = torch.empty((m, cols), dtype=torch.float32, device=table.device)
    if m:
        _launch("gather_rows", _library().gather_rows_launch, table,
                table.shape[0], cols, idx, int(idx.dim() == 2), m, out)
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
    if _device("gather_row_sum", table) == "cpu":
        return gather_row_sum_plain(table, idx)
    m = idx.shape[0]
    out = torch.empty((m,), dtype=torch.float32, device=table.device)
    if m:
        _launch("gather_row_sum", _library().gather_row_sum_launch, table,
                table.shape[0], table.shape[1], idx, m, out)
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
    if _device("onehot_gather", table) == "cpu":
        return onehot_gather_plain(table, idx, bf16=bf16)
    m, cols = idx.shape[0], table.shape[1]
    out = torch.empty((m, cols), dtype=torch.float32, device=table.device)
    if m:
        _launch("onehot_gather", _library().onehot_gather_launch, table,
                table.shape[0], cols, idx, int(bf16), m, out)
        onehot_gather.launches += 1
    return out


onehot_gather.launches = 0
