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

``icp_terms_raster`` launches the hand-written CUDA kernels of
``csrc/icp_terms.cu`` for CUDA tensors and calls its plain PyTorch version
``icp_terms_plain`` for CPU tensors; there is no fallback between the two.

On the card a group of ``lanes_for(qt)`` lanes owns a source slot: at
Qt = 2, 4 or 8, Qt lanes, lane t reading slot t of each cell; at any other
Qt, 8 lanes dealing out its 27 x Qt candidates (lane j takes k = j, j + 8,
...). Each lane keeps its own best with a strict '<', and the group merges
on (d2, k), which picks the first minimum in (dx, dy, dz, slot) order
exactly as the sequential scan does. A grid of at most ``MAX_BLOCKS``
blocks walks the slots, and a one-block finalizer writes the finished
result into one tensor. ``lane_scan_plain`` is the plain model of the lane
split and the merge, for any lane count; ``icp_terms_model`` chains it
with the grid and finalizer models of ``kernels.ndt_terms``.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch.kernels import _build
from tpu_slam_torch.kernels.ndt_terms import (BLOCK_THREADS, MAX_BLOCKS,
                                              TermsSlots, _sym_index,
                                              _transform, finalize_plain,
                                              grid_blocks,
                                              grid_partials_plain)


OUT_CHANNELS = 30         # H upper triangle (21), b (6), err, nmatch, wsum
RESULT = 45               # H (36), b (6), err, nmatch, wsum
# the device work of a call: the terms kernel and its finalizer
KERNEL_NAMES = ("icp_terms_kernel", "icp_terms_finalize")
SLOT_LANES = (2, 4, 8)    # Qt that get one lane a target slot
LANES = 8                 # lanes a source slot for any other Qt
BIG = 3.0e38              # the running best's start, as the reference's


def lanes_for(qt: int) -> int:
    """The kernel's lanes a source slot (``icp_terms_launch``): Qt when it
    is 2, 4 or 8 (lane t reads slot t of each cell), else LANES dealing out
    candidates."""
    return qt if qt in SLOT_LANES else LANES


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
    dev = tgt_table.get_device()                 # -1 on the CPU
    for t, shape, dtype in want:
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"icp_terms: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("icp_terms: inputs must be contiguous")
        if t.get_device() != dev:
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


def _candidates(src_slots: TermsSlots, tgt_table: torch.Tensor,
                p: List[torch.Tensor], dims: Tuple[int, int, int], qt: int
                ) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]]:
    """For each of the 27 neighbour cells in (dx, dy, dz) order: (d2 (N,
    Qt), BIG where the candidate is out of the window, invalid or the slot
    dropped; the candidates (N, Qt, 4); their table rows (N, Qt)). d2 is
    rounded op by op in the CUDA kernel's order."""
    wx, wy, wz = dims
    g = wx * wy * wz
    c = src_slots.cell.long()
    cx, cy, cz = c // (wy * wz), (c // wz) % wy, c % wz
    tcell = tgt_table.view(g, qt, 4)
    slot = torch.arange(qt, device=c.device)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nx, ny, nz = cx + dx, cy + dy, cz + dz
                ok = (src_slots.valid & (nx >= 0) & (nx < wx) & (ny >= 0)
                      & (ny < wy) & (nz >= 0) & (nz < wz))
                ncell = torch.clamp((nx * wy + ny) * wz + nz, 0, g - 1)
                cand = tcell[ncell]
                r = [p[k][:, None] - cand[..., k] for k in range(3)]
                d2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]     # (N, Qt)
                d2 = torch.where(ok[:, None] & (cand[..., 3] > 0.5), d2, BIG)
                yield d2, cand, ncell[:, None] * qt + slot


def icp_match_plain(src_slots: TermsSlots, tgt_table: torch.Tensor,
                    T: torch.Tensor, dims: Tuple[int, int, int], qt: int):
    """Each source slot's nearest target by the sequential scan: (p (3 x
    (N,)), best d2 (N,), the target point (3 x (N,)), its table row (N,),
    -1 where no candidate is below BIG). Within a cell ``argmin`` takes the
    first minimum, across cells a strict '<': the first minimum in
    (dx, dy, dz, slot) order."""
    p = _transform(src_slots, T)
    x = p[0]
    best = torch.full_like(x, BIG)
    bq = [torch.zeros_like(x)] * 3
    row = torch.full(x.shape, -1, dtype=torch.long, device=x.device)
    for d2, cand, rows in _candidates(src_slots, tgt_table, p, dims, qt):
        t_best = torch.argmin(d2, dim=1)     # first minimum
        t_d2 = torch.gather(d2, 1, t_best[:, None])[:, 0]
        better = t_d2 < best
        best = torch.where(better, t_d2, best)
        pick = torch.gather(cand[..., :3], 1,
                            t_best[:, None, None].expand(-1, 1, 3))
        bq = [torch.where(better, pick[:, 0, k], bq[k]) for k in range(3)]
        row = torch.where(better, torch.gather(rows, 1, t_best[:, None])[:, 0],
                          row)
    return p, best, bq, row


def _channels(valid: torch.Tensor, p: List[torch.Tensor],
              best: torch.Tensor, bq: List[torch.Tensor], maxd2: float,
              delta: float) -> torch.Tensor:
    """(N, 30) per-slot channels [H upper triangle (21), b (6), err,
    nmatch, wsum] of the chosen targets: the gate, the Huber weight and
    w J^T J, w J^T r at the transformed point, zero on an unmatched slot."""
    matched = valid & (best < maxd2)
    d = torch.sqrt(torch.clamp(best, min=1e-18))
    delta_t = torch.tensor(delta, dtype=torch.float32, device=best.device)
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
    return torch.stack(vals, dim=1)


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
    p, best, bq, _ = icp_match_plain(src_slots, tgt_table, T, dims, qt)
    return _totals(_channels(src_slots.valid, p, best, bq, maxd2,
                             delta).sum(dim=0))


icp_terms_plain.launches = 0


def lane_scan_plain(src_slots: TermsSlots, tgt_table: torch.Tensor,
                    T: torch.Tensor, dims: Tuple[int, int, int], qt: int,
                    lanes: int):
    """Plain model of the kernel's lane split and merge; returns what
    ``icp_match_plain`` returns.

    Candidate k = cell * Qt + slot (cells in (dx, dy, dz) order). Lane j of
    a slot's group of ``lanes`` visits the candidates k = j mod lanes in
    ascending k (with lanes = Qt: slot j of each cell) and keeps its best
    with a strict '<' from BIG; the group then merges by a butterfly (at
    level s lane j meets lane j ^ s) on the key (d2, k): the lower d2 wins,
    on equal d2 the lower k."""
    p = _transform(src_slots, T)
    n = p[0].shape[0]
    d2s, cands, rows = [], [], []
    for d2, cand, row in _candidates(src_slots, tgt_table, p, dims, qt):
        d2s.append(d2)
        cands.append(cand[..., :3])
        rows.append(row)
    d2 = torch.cat(d2s, dim=1)                        # (N, 27 Qt), k order
    cand = torch.cat(cands, dim=1)
    row = torch.cat(rows, dim=1)
    k = torch.arange(27 * qt, device=d2.device)
    owner = k % lanes
    none = 27 * qt                                    # no candidate yet
    best = torch.full((n, lanes), BIG, dtype=torch.float32, device=d2.device)
    bk = torch.full((n, lanes), none, dtype=torch.long, device=d2.device)
    for kk in range(27 * qt):                         # each lane in k order
        j = int(owner[kk])
        better = d2[:, kk] < best[:, j]
        best[:, j] = torch.where(better, d2[:, kk], best[:, j])
        bk[:, j] = torch.where(better, kk, bk[:, j])
    idx = torch.arange(lanes, device=d2.device)
    off = 1
    while off < lanes:
        ob, ok = best[:, idx ^ off], bk[:, idx ^ off]
        take = (ob < best) | ((ob == best) & (ok < bk))
        best, bk = torch.where(take, ob, best), torch.where(take, ok, bk)
        off *= 2
    best, bk = best[:, 0], bk[:, 0]
    found = bk < none
    safe = torch.where(found, bk, 0)
    pick = torch.gather(cand, 1, safe[:, None, None].expand(-1, 1, 3))[:, 0]
    bq = [torch.where(found, pick[:, c], 0.0) for c in range(3)]
    chosen = torch.where(found, torch.gather(row, 1, safe[:, None])[:, 0], -1)
    return p, best, bq, chosen


def icp_terms_model(src_slots: TermsSlots, tgt_table: torch.Tensor,
                    T: torch.Tensor, max_corr_dist: float, huber_delta: float,
                    dims: Tuple[int, int, int], qs: int, qt: int,
                    lanes: Optional[int] = None,
                    max_blocks: int = MAX_BLOCKS):
    """The kernel's decomposition in plain PyTorch: what
    ``icp_terms_raster`` returns, the choice by ``lane_scan_plain`` and
    every sum in the kernel's order (the kernel may contract products and
    sums into FMAs)."""
    _check_inputs(src_slots, tgt_table, T, dims, qt)
    maxd2, delta = _gate_constants(max_corr_dist, huber_delta)
    lanes = lanes_for(qt) if lanes is None else lanes
    p, best, bq, _ = lane_scan_plain(src_slots, tgt_table, T, dims, qt,
                                     lanes)
    per_slot = _channels(src_slots.valid, p, best, bq, maxd2, delta)
    nb = grid_blocks(src_slots.cell.shape[0], lanes, max_blocks)
    return _totals(finalize_plain(grid_partials_plain(per_slot, lanes, nb)))


_launch_fn = None


def _bound():
    global _launch_fn
    if _launch_fn is None:
        lib = _build.load("icp_terms")
        layout = (ctypes.c_int * 2)()
        lib.icp_terms_layout.restype = None
        lib.icp_terms_layout(layout)
        if tuple(layout) != (BLOCK_THREADS, MAX_BLOCKS):
            raise RuntimeError(f"csrc/icp_terms.cu's layout {tuple(layout)} "
                               "does not match (BLOCK_THREADS, MAX_BLOCKS)")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _launch_fn = _build.bind("icp_terms", "icp_terms_launch",
                                 [vp, vp, vp, ci, vp, vp, ci, ci, ci, ci, cf,
                                  cf, vp, vp, vp])
    return _launch_fn


def run_kernels(src_slots: TermsSlots, tgt_table: torch.Tensor,
                T: torch.Tensor, maxd2: float, delta: float,
                dims: Tuple[int, int, int], qt: int,
                choice: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Both kernels on the current stream, on checked CUDA inputs: the
    (RESULT + 30 * MAX_BLOCKS,) tensor whose head is [H (36), b, err,
    nmatch, wsum] and whose tail is the blocks' rows. ``choice`` (int32,
    one a slot) receives each slot's chosen target row, -1 for none."""
    n = src_slots.cell.shape[0]
    if choice is not None and (choice.shape != (n,) or choice.dtype !=
                               torch.int32 or choice.device != T.device):
        raise ValueError("icp_terms: choice must be int32 (n,) on the "
                         "inputs' device")
    out = torch.empty(RESULT + OUT_CHANNELS * MAX_BLOCKS,
                      dtype=torch.float32, device=tgt_table.device)
    _build.launch("icp_terms", _bound(), tgt_table.get_device(),
                  src_slots.points.data_ptr(), src_slots.cell.data_ptr(),
                  src_slots.valid.data_ptr(), n, tgt_table.data_ptr(),
                  T.data_ptr(), dims[0], dims[1], dims[2], qt, maxd2, delta,
                  out.data_ptr(),
                  None if choice is None else choice.data_ptr())
    return out


def icp_terms_raster(src_slots: TermsSlots, tgt_table: torch.Tensor,
                     T: torch.Tensor, max_corr_dist: float,
                     huber_delta: float, dims: Tuple[int, int, int],
                     qs: int, qt: int):
    """Fused pair-ICP terms pass: (H (6, 6), b (6,), err, nmatch, wsum).

    CUDA tensors run the kernel and finalizer of ``csrc/icp_terms.cu``
    (built with nvcc at first use), which write the five results into one
    tensor (these are views of it), and count one call in
    ``icp_terms_raster.launches``; CPU tensors run ``icp_terms_plain``.
    Anything else raises.
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
    out = run_kernels(src_slots, tgt_table, T, maxd2, delta, dims, qt)
    icp_terms_raster.launches += 1
    return out[:36].view(6, 6), out[36:42], out[42], out[43], out[44]


icp_terms_raster.launches = 0
