"""Fused pair-ICP terms pass — correspondence and GN reduction in one pass.

Port of ``tpu_slam.kernels.icp_terms``. Both clouds are binned into one
window once per solve stage: the target at the identity into the dense
(G*Qt, 4) slot table of ``raster_to_slots`` (rows [x, y, z, valid], world
frame), the source at the stage-entry pose into the cell-sorted slot list
of ``build_terms_raster`` (source frame). Each pass scores the live pose T:

    per kept source slot p: among the 27 neighbour cells x Qt target slots
    of p's frozen bin, the valid target q nearest to T p (d2 = |T p - q|^2,
    visited in the order dx, dy, dz, slot, each -1, 0, +1, a strict '<', so
    the first candidate wins a tie);
    matched when d2 < float32(max_corr_dist)^2; then with d = |T p - q|,
    w = 1 for d <= delta and delta / d outside (Huber),
    H += w J^T J, b += w J^T (T p - q), err += w d2, nmatch, wsum += w,
    J = [I | -hat(T p)].

``icp_terms_raster`` launches the hand-written CUDA kernel
``csrc/icp_terms.cu`` for CUDA tensors and calls its plain PyTorch version
``icp_terms_plain`` for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from tpu_slam_torch.kernels.ndt_terms import TermsSlots, _sym_index

OUT_CHANNELS = 30         # H upper triangle (21), b (6), err, nmatch, wsum
BLOCK_THREADS = 256       # must equal kThreads in csrc/icp_terms.cu
BIG = 3.0e38              # the running best's start, as the reference's


def _check_inputs(slots: TermsSlots, tgt_table: torch.Tensor,
                  T: torch.Tensor, dims: Tuple[int, int, int],
                  qt: int) -> None:
    n = slots.cell.shape[0]
    g = dims[0] * dims[1] * dims[2]
    want = ((slots.points, (n, 3), torch.float32),
            (slots.cell, (n,), torch.int32),
            (slots.valid, (n,), torch.bool),
            (tgt_table, (g * qt, 4), torch.float32),
            (T, (4, 4), torch.float32))
    for t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"icp_terms: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("icp_terms: inputs must be contiguous")
        if t.device != tgt_table.device:
            raise ValueError("icp_terms: inputs on different devices "
                             f"({t.device} vs {tgt_table.device})")


def _gate_constants(max_corr_dist: float,
                    huber_delta: float) -> Tuple[float, float]:
    if isinstance(max_corr_dist, torch.Tensor) or isinstance(huber_delta,
                                                             torch.Tensor):
        raise TypeError("icp_terms: max_corr_dist and huber_delta are host "
                        "floats")
    # the reference squares the float32 distance (icp_terms.py:206)
    c = np.float32(max_corr_dist)
    return float(c * c), float(np.float32(huber_delta))


def _totals(tot: torch.Tensor):
    H = tot[:21][_sym_index(tot.device)]
    return H, tot[21:27], tot[27], tot[28], tot[29]


def icp_terms_plain(src_slots: TermsSlots, tgt_table: torch.Tensor,
                    T: torch.Tensor, max_corr_dist: float, huber_delta: float,
                    dims: Tuple[int, int, int], qs: int, qt: int):
    """Plain PyTorch version of the pass (27 gathers of Qt target slots).

    Returns (H (6, 6), b (6,), err (), nmatch (), wsum ()). The transform
    and d2 are evaluated op by op in the CUDA kernel's order, and within a
    neighbour cell ``argmin`` takes the first minimum, so both pick the
    same target for every slot. ``qs`` is the source binning's capacity,
    kept for the reference's signature; the slot list carries its cells.
    """
    _check_inputs(src_slots, tgt_table, T, dims, qt)
    icp_terms_plain.launches += 1
    maxd2, delta = _gate_constants(max_corr_dist, huber_delta)
    wx, wy, wz = dims
    g = wx * wy * wz
    x, y, z = src_slots.points.unbind(1)
    p = [T[r, 0] * x + T[r, 1] * y + T[r, 2] * z + T[r, 3] for r in range(3)]
    c = src_slots.cell.long()
    cx, cy, cz = c // (wy * wz), (c // wz) % wy, c % wz
    tcell = tgt_table.view(g, qt, 4)

    best = torch.full_like(x, BIG)
    bq = [torch.zeros_like(x)] * 3
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nx, ny, nz = cx + dx, cy + dy, cz + dz
                ok = (src_slots.valid & (nx >= 0) & (nx < wx) & (ny >= 0)
                      & (ny < wy) & (nz >= 0) & (nz < wz))
                cand = tcell[torch.clamp((nx * wy + ny) * wz + nz, 0, g - 1)]
                r = [p[k][:, None] - cand[..., k] for k in range(3)]
                d2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]     # (N, Qt)
                d2 = torch.where(ok[:, None] & (cand[..., 3] > 0.5), d2, BIG)
                t_best = torch.argmin(d2, dim=1)     # first minimum
                t_d2 = torch.gather(d2, 1, t_best[:, None])[:, 0]
                better = t_d2 < best
                best = torch.where(better, t_d2, best)
                pick = torch.gather(cand[..., :3], 1,
                                    t_best[:, None, None].expand(-1, 1, 3))
                bq = [torch.where(better, pick[:, 0, k], bq[k])
                      for k in range(3)]

    matched = src_slots.valid & (best < maxd2)
    d = torch.sqrt(torch.clamp(best, min=1e-18))
    delta_t = torch.tensor(delta, dtype=torch.float32, device=x.device)
    w = torch.where(matched, torch.where(d <= delta_t, 1.0, delta_t / d), 0.0)
    px, py, pz = p
    y0, y1, y2 = w * (px - bq[0]), w * (py - bq[1]), w * (pz - bq[2])
    zero = torch.zeros_like(w)
    pp = px * px + py * py + pz * pz
    # H = w J^T J with J = [I | -hat(p)], upper triangle row-major:
    # H_tt = w I, H_tr = -w hat(p), H_rr = w (|p|^2 I - p p^T)
    vals = [w, zero, zero, zero, w * pz, -w * py,
            w, zero, -w * pz, zero, w * px,
            w, w * py, -w * px, zero,
            w * (pp - px * px), -w * px * py, -w * px * pz,
            w * (pp - py * py), -w * py * pz,
            w * (pp - pz * pz),
            y0, y1, y2, py * y2 - pz * y1, pz * y0 - px * y2,
            px * y1 - py * y0,
            w * best, matched.to(torch.float32), w]
    # w * best is 0 * BIG = 0 on unmatched slots
    return _totals(torch.stack(vals, dim=1).sum(dim=0))


icp_terms_plain.launches = 0


def _library():
    from tpu_slam_torch.kernels import _build

    lib = _build.load("icp_terms")
    fn = lib.icp_terms_launch
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, ci, vp, vp, ci, ci, ci, ci, cf, cf, vp,
                       ci, vp]
        fn.restype = ci
        lib.icp_terms_block_threads.argtypes = []
        lib.icp_terms_block_threads.restype = ci
        if lib.icp_terms_block_threads() != BLOCK_THREADS:
            raise RuntimeError("csrc/icp_terms.cu block size does not match "
                               "BLOCK_THREADS")
    return fn


def icp_terms_raster(src_slots: TermsSlots, tgt_table: torch.Tensor,
                     T: torch.Tensor, max_corr_dist: float,
                     huber_delta: float, dims: Tuple[int, int, int],
                     qs: int, qt: int):
    """Fused pair-ICP terms pass: (H (6, 6), b (6,), err, nmatch, wsum).

    CUDA tensors run the kernel of ``csrc/icp_terms.cu`` (built with nvcc
    at first use) and count one launch in ``icp_terms_raster.launches``;
    CPU tensors run ``icp_terms_plain``. Anything else raises.
    """
    _check_inputs(src_slots, tgt_table, T, dims, qt)
    dev = tgt_table.device
    if dev.type == "cpu":
        return icp_terms_plain(src_slots, tgt_table, T, max_corr_dist,
                               huber_delta, dims, qs, qt)
    if dev.type != "cuda":
        raise ValueError(f"icp_terms: unsupported device {dev}")
    if tgt_table.data_ptr() % 16:
        raise ValueError("icp_terms: tgt_table must be 16-byte aligned (the "
                         "kernel reads each slot as a float4)")
    maxd2, delta = _gate_constants(max_corr_dist, huber_delta)
    n = src_slots.cell.shape[0]
    num_blocks = max(1, -(-n // BLOCK_THREADS))
    partials = torch.empty((num_blocks, OUT_CHANNELS), dtype=torch.float32,
                           device=dev)
    launch = _library()
    with torch.cuda.device(dev):
        rc = launch(src_slots.points.data_ptr(), src_slots.cell.data_ptr(),
                    src_slots.valid.data_ptr(), n, tgt_table.data_ptr(),
                    T.data_ptr(), dims[0], dims[1], dims[2], qt, maxd2, delta,
                    partials.data_ptr(), num_blocks,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"icp_terms kernel launch failed: CUDA error {rc}")
    icp_terms_raster.launches += 1
    return _totals(partials.sum(dim=0))          # fixed-order reduction


icp_terms_raster.launches = 0
