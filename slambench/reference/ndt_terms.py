"""Frozen copy of ``tpu_slam_torch.kernels.ndt_terms``' plain path.

The frozen-bin NDT objective: the scan is binned once per solve stage at
the stage-entry pose T0 (first ``q_cap`` points per window cell in input
order, the rest dropped), and every LM evaluation of the stage scores the
live pose T:

    cost(T) = -sum_{p, k in nbr27(bin(p))} s_pk,
    s_pk = exp(-min(d2_pk / (2 gamma), 30)), gated by |T p - mu_k| < max_corr
    H = sum s J^T Lambda J,  b = sum s J^T Lambda r   (J = [I | -hat(Tp)])
    matched = number of slots with at least one gated neighbour.

``ndt_terms`` is the plain PyTorch pass (27 gathers, then einsums) on
every device: the benchmark's reference runs no kernel of the program.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import torch

from slambench.reference import se3
from slambench.reference.consts import const


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




ndt_terms = ndt_terms_plain
