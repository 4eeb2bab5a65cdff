"""NDT terms pass — the hot loop of scan-to-map registration.

Port of ``tpu_slam.kernels.ndt_terms``. The objective is the reference's
frozen-bin NDT objective: the scan is binned once per solve stage at the
stage-entry pose T0 (first ``q_cap`` points per window cell in input order,
the rest dropped), and every LM evaluation of the stage then scores the
live pose T:

    cost(T) = -sum_{p, k in nbr27(bin(p))} s_pk,
    s_pk = exp(-min(d2_pk / (2 gamma), 30)), gated by |T p - mu_k| < max_corr
    H = sum s J^T Lambda J,  b = sum s J^T Lambda r   (J = [I | -hat(Tp)])
    matched = number of slots with at least one gated neighbour.

Layout (the port's own; the TPU raster's (8, 128) tiling existed only for
TPU vregs): the binned scan is a compact, cell-sorted slot list
(:class:`TermsSlots`) and the field is ``grid_ndt_field``'s x-major (G, 16)
rows. ``ndt_terms`` launches the hand-written CUDA kernels of
``csrc/ndt_terms.cu`` for CUDA tensors and calls its plain PyTorch version
``ndt_terms_plain`` for CPU tensors; there is no fallback between the two.

On the card a group of ``LANES`` lanes owns a slot (lane j visits the
neighbours j, j + LANES, ... of the 27), a grid of at most ``MAX_BLOCKS``
blocks walks the slots, and a one-block finalizer sums the blocks' rows in
index order into the finished result: two launches in one call, one
tensor, no device work after it. ``lane_split_plain``,
``grid_partials_plain`` and ``finalize_plain`` are the plain models of
those three steps (``ndt_terms_model`` chains them); they fix which lane,
group and block see each term, and the order of every sum, for any lane
count and grid, the kernel's among them.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.consts import const
from tpu_slam_torch.kernels import _build

OUT_CHANNELS = 29         # H upper triangle (21), b (6), sum s, matched
RESULT = 44               # H (36), b (6), cost, matched
# the library's shape (checked against it when it is loaded): threads a
# block and blocks at most (csrc/terms_common.cuh), lanes a slot
# (csrc/ndt_terms.cu)
BLOCK_THREADS = 256
MAX_BLOCKS = 264          # one wave of an H100: 132 SMs x 2 blocks
LANES = 8
# the device work of a call: the terms kernel and its finalizer
KERNEL_NAMES = ("ndt_terms_kernel", "ndt_terms_finalize")

# (6, 6) -> index into the 21 upper-triangle totals, row-major triangle
_SYM_IDX = torch.tensor([[min(i, j) * 6 - min(i, j) * (min(i, j) + 1) // 2
                          + max(i, j) for j in range(6)] for i in range(6)],
                        dtype=torch.long)
_sym_idx_on: Dict[torch.device, torch.Tensor] = {}


@dataclasses.dataclass(frozen=True)
class TermsSlots:
    """A scan binned into a dense window at a stage-entry pose.

    Rows are sorted by window cell (x-major ``(x*Wy + y)*Wz + z``), points
    of one cell in input order, so kept row k of cell c is that cell's
    rank-k point — the nonzero slots of the reference raster, in order.
    """

    points: torch.Tensor   # (N, 3) f32 source frame; 0 where not kept
    cell: torch.Tensor     # (N,) int32 window cell; G where not kept
    valid: torch.Tensor    # (N,) bool, kept slot
    inside: torch.Tensor   # (N,) bool, INPUT order: in the window at T0


def build_terms_raster(points: torch.Tensor, mask: torch.Tensor,
                       T0: torch.Tensor, origin_world: torch.Tensor,
                       leaf: float, dims: Tuple[int, int, int], q_cap: int,
                       own_x: Optional[Tuple[int, int]] = None
                       ) -> Tuple[TermsSlots, torch.Tensor]:
    """Bin the scan at pose T0 into the window's slot list.

    points (N, 3) source frame, mask (N,), origin_world (3,) = world corner
    of window cell (0, 0, 0). Returns (slots, n_dropped) where n_dropped
    counts the valid points outside the window at T0 plus those beyond the
    first ``q_cap`` of their cell; neither enters the objective.

    ``own_x`` = (x0, x1) keeps only the points whose cell lies in the
    window's x-planes x0 .. x1-1, and numbers the cells in the local
    window of dims (x1 - x0 + 2, Wy, Wz) whose plane 0 is plane x0 - 1 (one
    halo plane a side): a rank's share of the slot list, which the ranks'
    shares partition (the per-cell cap counts within a cell, and a cell
    lies in one share). ``inside`` is then "in the owned planes".
    """
    wx, wy, wz = dims
    x0, x1 = (0, wx) if own_x is None else own_x
    g = wx * wy * wz if own_x is None else (x1 - x0 + 2) * wy * wz
    n = points.shape[0]
    dev = points.device
    hi = const((wx, wy, wz), torch.float32, dev)
    # clamp BEFORE the int conversion (padding sits at 1e8); the clamp keeps
    # every out-of-window point out of the window
    rel = torch.clamp((se3.apply(T0, points) - origin_world) / leaf, min=-1.0)
    cc = torch.floor(torch.minimum(rel, hi)).to(torch.int32)
    inside = mask & ((cc >= 0) & (cc < hi.to(torch.int32))).all(dim=1)
    lx = cc[:, 0]
    if own_x is not None:
        inside = inside & (lx >= x0) & (lx < x1)
        lx = lx - (x0 - 1)
    cell = torch.where(inside, (lx * wy + cc[:, 1]) * wz + cc[:, 2], g)

    order = torch.argsort(cell, stable=True)
    sc = cell[order]
    sp = points[order]
    # rank within the cell from q_cap shifted compares (exact below q_cap,
    # saturating at it), as the reference does
    rank = torch.zeros(n, dtype=torch.int32, device=dev)
    for j in range(1, min(q_cap, n - 1) + 1):
        rank[j:] += (sc[j:] == sc[:-j]).to(torch.int32)
    keep = (sc < g) & (rank < q_cap)
    n_dropped = mask.sum(dtype=torch.int32) - keep.sum(dtype=torch.int32)
    slots = TermsSlots(
        points=torch.where(keep[:, None], sp, 0.0).contiguous(),
        cell=torch.where(keep, sc, g).to(torch.int32).contiguous(),
        valid=keep.contiguous(), inside=inside)
    return slots, n_dropped


def raster_to_slots(slots: TermsSlots, dims: Tuple[int, int, int],
                    q_cap: int) -> torch.Tensor:
    """The reference's dense (G*Q, 4) slot rows [x, y, z, valid].

    Row c*Q + k holds cell c's rank-k kept point (source frame) with valid
    1; every other row is 0. Cells are x-major as in ``slots.cell``.
    """
    wx, wy, wz = dims
    g = wx * wy * wz
    n = slots.cell.shape[0]
    c, v = slots.cell, slots.valid
    # the kept slots of a cell are adjacent, in rank order, at most q_cap
    # of them: the rank is the number of equal cells among the q_cap - 1
    # slots before
    rank = torch.zeros(n, dtype=torch.int32, device=c.device)
    for j in range(1, min(q_cap, n)):
        rank[j:] += ((c[j:] == c[:-j]) & v[j:] & v[:-j]).to(torch.int32)
    # dropped slots all write zeros into one spare row, cut off below
    row = torch.where(v, c * q_cap + rank, g * q_cap).long()
    vals = torch.cat([slots.points, v[:, None].to(torch.float32)], dim=1)
    table = torch.zeros((g * q_cap + 1, 4), dtype=torch.float32,
                        device=c.device)
    table[row] = vals
    return table[:g * q_cap]


def _check_inputs(slots: TermsSlots, rows16: torch.Tensor, T: torch.Tensor,
                  dims: Tuple[int, int, int]) -> None:
    n = slots.cell.shape[0]
    g = dims[0] * dims[1] * dims[2]
    want = ((slots.points, (n, 3), torch.float32),
            (slots.cell, (n,), torch.int32),
            (slots.valid, (n,), torch.bool),
            (rows16, (g, 16), torch.float32),
            (T, (4, 4), torch.float32))
    dev = rows16.get_device()                 # -1 on the CPU
    for t, shape, dtype in want:
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"ndt_terms: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("ndt_terms: inputs must be contiguous")
        if t.get_device() != dev:
            raise ValueError("ndt_terms: inputs on different devices "
                             f"({t.device} vs {rows16.device})")


def _gate_constants(gamma: float, max_corr_dist: float) -> Tuple[float, float]:
    if isinstance(gamma, torch.Tensor) or isinstance(max_corr_dist,
                                                     torch.Tensor):
        raise TypeError("ndt_terms: gamma and max_corr_dist are host floats")
    return 0.5 / float(gamma), float(max_corr_dist) ** 2


def _sym_index(device: torch.device) -> torch.Tensor:
    idx = _sym_idx_on.get(device)
    if idx is None:
        idx = _SYM_IDX.to(device)
        _sym_idx_on[device] = idx
    return idx


def _transform(slots: TermsSlots, T: torch.Tensor):
    """T p of every slot, (3 x (N,)), each product and sum rounded on its
    own in the CUDA kernel's order."""
    x, y, z = slots.points[:, 0], slots.points[:, 1], slots.points[:, 2]
    return [T[r, 0] * x + T[r, 1] * y + T[r, 2] * z + T[r, 3]
            for r in range(3)]


def _neighbours(slots: TermsSlots, rows16: torch.Tensor, T: torch.Tensor,
                inv_2g: float, maxd2: float, dims: Tuple[int, int, int]
                ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """For each of the 27 neighbours in (dx, dy, dz) order: (gate (N,),
    s (N,), q (3 x (N,)), Lambda (6 x (N,)), the upper triangle), s = 0
    where the pair is not gated. The point transform and the gate distance
    are evaluated op by op in the CUDA kernel's order."""
    wx, wy, wz = dims
    g = wx * wy * wz
    p = _transform(slots, T)
    c = slots.cell.long()
    cx, cy, cz = c // (wy * wz), (c // wz) % wy, c % wz
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nx, ny, nz = cx + dx, cy + dy, cz + dz
                ok = (slots.valid & (nx >= 0) & (nx < wx) & (ny >= 0)
                      & (ny < wy) & (nz >= 0) & (nz < wz))
                ncell = torch.clamp((nx * wy + ny) * wz + nz, 0, g - 1)
                R = rows16[ncell]
                ok = ok & (R[:, 9] > 0.5)
                r0, r1, r2 = p[0] - R[:, 0], p[1] - R[:, 1], p[2] - R[:, 2]
                de2 = r0 * r0 + r1 * r1 + r2 * r2
                gate = ok & (de2 < maxd2)
                l00, l01, l02 = R[:, 3], R[:, 4], R[:, 5]
                l11, l12, l22 = R[:, 6], R[:, 7], R[:, 8]
                q0 = l00 * r0 + l01 * r1 + l02 * r2
                q1 = l01 * r0 + l11 * r1 + l12 * r2
                q2 = l02 * r0 + l12 * r1 + l22 * r2
                d2 = q0 * r0 + q1 * r1 + q2 * r2
                s = torch.where(
                    gate, torch.exp(-torch.clamp(d2 * inv_2g, max=30.0)), 0.0)
                yield gate, s, (q0, q1, q2), (l00, l01, l02, l11, l12, l22)


def ndt_terms_plain(slots: TermsSlots, rows16: torch.Tensor, T: torch.Tensor,
                    gamma: float, max_corr_dist: float,
                    dims: Tuple[int, int, int]):
    """Plain PyTorch version of the terms pass (27 gathers, then einsums).

    Returns (H (6, 6), b (6,), cost (), matched_count ()). The point
    transform and the gate distance are evaluated op by op in the same
    order as the CUDA kernel, so the matched count agrees exactly.
    """
    _check_inputs(slots, rows16, T, dims)
    ndt_terms_plain.launches += 1
    inv_2g, maxd2 = _gate_constants(gamma, max_corr_dist)
    x = slots.points[:, 0]
    zero = torch.zeros_like(x)
    yacc = [zero] * 3                       # sum s * Lambda r
    lacc = [zero] * 6                       # sum s * Lambda (upper tri)
    ssum = zero
    matched = torch.zeros_like(slots.valid)
    for gate, s, q, lam in _neighbours(slots, rows16, T, inv_2g, maxd2,
                                       dims):
        yacc = [a + s * v for a, v in zip(yacc, q)]
        lacc = [a + s * v for a, v in zip(lacc, lam)]
        ssum = ssum + s
        matched = matched | gate

    a00, a01, a02, a11, a12, a22 = lacc
    L = torch.stack([torch.stack([a00, a01, a02], -1),
                     torch.stack([a01, a11, a12], -1),
                     torch.stack([a02, a12, a22], -1)], -2)       # (N, 3, 3)
    yv = torch.stack(yacc, -1)                                    # (N, 3)
    px, py, pz = _transform(slots, T)
    phat = torch.stack([torch.stack([zero, -pz, py], -1),
                        torch.stack([pz, zero, -px], -1),
                        torch.stack([-py, px, zero], -1)], -2)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand_as(phat)
    J = torch.cat([eye, -phat], dim=2)                            # (N, 3, 6)
    H = torch.einsum("nia,nij,njb->ab", J, L, J)
    b = torch.einsum("nia,ni->a", J, yv)
    return H, b, -ssum.sum(), matched.sum().to(torch.float32)


ndt_terms_plain.launches = 0


def grid_blocks(n: int, lanes: int = LANES,
                max_blocks: int = MAX_BLOCKS) -> int:
    """The grid for n slots (``terms::grid_blocks``): enough blocks for one
    slot a group, at most ``max_blocks``, at least one (an empty list writes
    zeros)."""
    groups = BLOCK_THREADS // lanes
    return max(1, min(max_blocks, -(-n // groups)))


def lane_split_plain(slots: TermsSlots, rows16: torch.Tensor,
                     T: torch.Tensor, gamma: float, max_corr_dist: float,
                     dims: Tuple[int, int, int], lanes: int) -> torch.Tensor:
    """Plain model of the kernel's lane split and its per-slot expansion.

    Lane j of a slot's group sums the 11 accumulators [s Lambda r (3),
    s Lambda (6, upper triangle), s] and the hit flag of its neighbours
    j, j + lanes, ... (of the 27, in (dx, dy, dz) order), each from 0; the
    group combines its lanes by a butterfly (at level s, lane j adds lane
    j ^ s) and expands the sums once at the transformed point. Returns the
    (N, 29) channels [H upper triangle (21), b (6), sum s, matched], zero
    on a dropped slot."""
    _check_inputs(slots, rows16, T, dims)
    inv_2g, maxd2 = _gate_constants(gamma, max_corr_dist)
    n = slots.cell.shape[0]
    per_nb = []                                   # 27 x (N, 11)
    for gate, s, q, lam in _neighbours(slots, rows16, T, inv_2g, maxd2,
                                       dims):
        per_nb.append(torch.stack([s * v for v in q + lam] + [
            s, gate.to(torch.float32)], dim=1))
    per_nb = torch.stack(per_nb, dim=1)           # (N, 27, 11)
    lane_acc = torch.zeros((n, lanes, 11), dtype=torch.float32,
                           device=rows16.device)
    for k in range(27):
        j = k % lanes
        v = per_nb[:, k]
        lane_acc[:, j, :10] = lane_acc[:, j, :10] + v[:, :10]
        lane_acc[:, j, 10] = torch.maximum(lane_acc[:, j, 10], v[:, 10])
    idx = torch.arange(lanes, device=rows16.device)
    off = 1
    while off < lanes:
        other = lane_acc[:, idx ^ off]
        lane_acc = torch.cat([lane_acc[..., :10] + other[..., :10],
                              torch.maximum(lane_acc[..., 10:],
                                            other[..., 10:])], dim=-1)
        off *= 2
    a = lane_acc[:, 0]
    px, py, pz = _transform(slots, T)
    y0, y1, y2, c00, c01, c02, c11, c12, c22, ssum, hit = a.unbind(1)
    m00, m01, m02 = c01 * pz - c02 * py, -c00 * pz + c02 * px, \
        c00 * py - c01 * px
    m10, m11, m12 = c11 * pz - c12 * py, -c01 * pz + c12 * px, \
        c01 * py - c11 * px
    m20, m21, m22 = c12 * pz - c22 * py, -c02 * pz + c22 * px, \
        c02 * py - c12 * px
    out = torch.stack([
        c00, c01, c02, -m00, -m01, -m02,
        c11, c12, -m10, -m11, -m12,
        c22, -m20, -m21, -m22,
        -(-pz * m10 + py * m20), -(-pz * m11 + py * m21),
        -(-pz * m12 + py * m22),
        -(pz * m01 - px * m21), -(pz * m02 - px * m22),
        -(-py * m02 + px * m12),
        y0, y1, y2, py * y2 - pz * y1, pz * y0 - px * y2, px * y1 - py * y0,
        ssum, hit], dim=1)
    return torch.where(slots.valid[:, None], out, 0.0)


def grid_partials_plain(per_slot: torch.Tensor, lanes: int,
                        num_blocks: int) -> torch.Tensor:
    """Plain model of the kernel's grid: (num_blocks, C) block rows from
    the (N, C) per-slot channels. Group g of the grid (BLOCK_THREADS //
    lanes a block) sums the slots g, g + groups, ... in order, from 0; a
    block adds the groups of each warp by a shuffle tree (lane l adds lane
    l + off, off from 16 down to ``lanes``), then its warps in order."""
    n, ch = per_slot.shape
    per_block = BLOCK_THREADS // lanes
    groups = num_blocks * per_block
    acc = torch.zeros((groups, ch), dtype=per_slot.dtype,
                      device=per_slot.device)
    for start in range(0, n, groups):
        part = per_slot[start:start + groups]
        acc[:part.shape[0]] = acc[:part.shape[0]] + part
    warps = BLOCK_THREADS // 32
    v = acc.view(num_blocks, warps, max(1, 32 // lanes), ch)
    while v.shape[2] > 1:
        half = v.shape[2] // 2
        v = v[:, :, :half] + v[:, :, half:]
    v = v[:, :, 0]
    row = torch.zeros((num_blocks, ch), dtype=per_slot.dtype,
                      device=per_slot.device)
    for w in range(warps):
        row = row + v[:, w]
    return row


def finalize_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain model of the one-block finalizer: the (C,) totals of the
    (num_blocks, C) block rows. Lane l of channel c's warp sums the rows
    l, l + 32, ... in order, from 0, then a shuffle tree (16, 8, ..., 1)."""
    nb, ch = rows.shape
    lanes = torch.zeros((32, ch), dtype=rows.dtype, device=rows.device)
    for start in range(0, nb, 32):
        part = rows[start:start + 32]
        lanes[:part.shape[0]] = lanes[:part.shape[0]] + part
    while lanes.shape[0] > 1:
        half = lanes.shape[0] // 2
        lanes = lanes[:half] + lanes[half:]
    return lanes[0]


def ndt_terms_model(slots: TermsSlots, rows16: torch.Tensor, T: torch.Tensor,
                    gamma: float, max_corr_dist: float,
                    dims: Tuple[int, int, int], lanes: int = LANES,
                    max_blocks: int = MAX_BLOCKS):
    """The kernel's decomposition in plain PyTorch: (H, b, cost, matched)
    as ``ndt_terms`` returns them, every sum in the kernel's order (the
    kernel may contract a product and a sum into one FMA, and its exp
    rounds differently)."""
    per_slot = lane_split_plain(slots, rows16, T, gamma, max_corr_dist,
                                dims, lanes)
    nb = grid_blocks(slots.cell.shape[0], lanes, max_blocks)
    tot = finalize_plain(grid_partials_plain(per_slot, lanes, nb))
    return tot[:21][_sym_index(tot.device)], tot[21:27], -tot[27], tot[28]


_launch_fn = None


def _bound():
    global _launch_fn
    if _launch_fn is None:
        lib = _build.load("ndt_terms")
        layout = (ctypes.c_int * 3)()
        lib.ndt_terms_layout.restype = None
        lib.ndt_terms_layout(layout)
        if tuple(layout) != (BLOCK_THREADS, LANES, MAX_BLOCKS):
            raise RuntimeError(f"csrc/ndt_terms.cu's layout {tuple(layout)} "
                               "does not match (BLOCK_THREADS, LANES, "
                               "MAX_BLOCKS)")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _launch_fn = _build.bind("ndt_terms", "ndt_terms_launch",
                                 [vp, vp, vp, ci, vp, vp, ci, ci, ci, cf, cf,
                                  vp, vp])
    return _launch_fn


def ndt_terms(slots: TermsSlots, rows16: torch.Tensor, T: torch.Tensor,
              gamma: float, max_corr_dist: float,
              dims: Tuple[int, int, int]):
    """Frozen-bin NDT terms pass: (H (6, 6), b (6,), cost (), matched ()).

    CUDA tensors run the kernel and finalizer of ``csrc/ndt_terms.cu``
    (built with nvcc at first use), which write the four results into one
    tensor (these are views of it), and count one call in
    ``ndt_terms.launches``; CPU tensors run ``ndt_terms_plain``. Anything
    else raises.
    """
    _check_inputs(slots, rows16, T, dims)
    dev = rows16.device
    if dev.type == "cpu":
        return ndt_terms_plain(slots, rows16, T, gamma, max_corr_dist, dims)
    if dev.type != "cuda":
        raise ValueError(f"ndt_terms: unsupported device {dev}")
    if rows16.data_ptr() % 16:
        raise ValueError("ndt_terms: rows16 must be 16-byte aligned (the "
                         "kernel reads each row as float4s)")
    inv_2g, maxd2 = _gate_constants(gamma, max_corr_dist)
    # the result [H (36), b, cost, matched], then the blocks' rows
    out = torch.empty(RESULT + OUT_CHANNELS * MAX_BLOCKS,
                      dtype=torch.float32, device=dev)
    _build.launch("ndt_terms", _bound(), rows16.get_device(),
                  slots.points.data_ptr(), slots.cell.data_ptr(),
                  slots.valid.data_ptr(), slots.cell.shape[0],
                  rows16.data_ptr(), T.data_ptr(), dims[0], dims[1], dims[2],
                  inv_2g, maxd2, out.data_ptr())
    ndt_terms.launches += 1
    return out[:36].view(6, 6), out[36:42], out[42], out[43]


ndt_terms.launches = 0
