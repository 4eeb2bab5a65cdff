"""Closed-form spectral utilities for batched symmetric 3x3 matrices.

Frozen copy of ``tpu_slam_torch.core.sym3``: eigenvalues by the
trigonometric (Cardano) solution and the NDT information matrix as the
Newton divided-difference evaluation of g(A) = 1 / max(lambda, ratio *
lambda_max) — element-wise math on the six upper-triangle components, no
eigenvectors, no batched eigh."""

from __future__ import annotations

import torch

_TWO_PI_3 = 2.0943951023931953  # 2*pi/3


def eigvals_sym3_tri(a00, a01, a02, a11, a12, a22) -> torch.Tensor:
    """Eigenvalues (ascending, stacked on the last axis) from upper-tri lanes."""
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    # floor p2 so p^3 stays a float32 normal (isotropic matrices would
    # otherwise underflow to 0 and poison acos with nan)
    p2 = torch.clamp(p2, min=1e-20)
    p = torch.sqrt(p2)
    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detb / (2.0 * p * p2), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lmax = q + 2.0 * p * torch.cos(phi)
    lmin = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)
    lmid = 3.0 * q - lmax - lmin
    return torch.stack([lmin, lmid, lmax], dim=-1)


def floored_info_sym3_tri(tri, floor_ratio: float):
    """NDT information lanes: eigenvalues floored at ratio * lambda_max,
    then inverted, without eigenvectors. Returns the 6 upper-tri lanes."""
    a00, a01, a02, a11, a12, a22 = tri
    lam = eigvals_sym3_tri(a00, a01, a02, a11, a12, a22)
    scale = torch.clamp(lam[..., 2], min=1e-9)
    eps = 1e-3 * scale
    l0 = lam[..., 0]
    l1 = torch.maximum(lam[..., 1], l0 + eps)
    l2 = torch.maximum(lam[..., 2], l1 + eps)
    f = floor_ratio * scale
    g0 = 1.0 / torch.maximum(l0, f)
    g1 = 1.0 / torch.maximum(l1, f)
    g2 = 1.0 / torch.maximum(l2, f)
    dd1 = (g1 - g0) / (l1 - l0)
    dd2 = ((g2 - g1) / (l2 - l1) - dd1) / (l2 - l0)

    # p(A) = g0 I + dd1 (A - l0 I) + dd2 (A - l0 I)(A - l1 I), the product
    # of the two commuting shifted matrices written out lane-wise
    b00, b11, b22 = a00 - l0, a11 - l0, a22 - l0
    c00, c11, c22 = a00 - l1, a11 - l1, a22 - l1
    p00 = b00 * c00 + a01 * a01 + a02 * a02
    p11 = a01 * a01 + b11 * c11 + a12 * a12
    p22 = a02 * a02 + a12 * a12 + b22 * c22
    p01 = b00 * a01 + a01 * c11 + a02 * a12
    p02 = b00 * a02 + a01 * a12 + a02 * c22
    p12 = a01 * a02 + b11 * a12 + a12 * c22
    i00 = g0 + dd1 * b00 + dd2 * p00
    i11 = g0 + dd1 * b11 + dd2 * p11
    i22 = g0 + dd1 * b22 + dd2 * p22
    i01 = dd1 * a01 + dd2 * p01
    i02 = dd1 * a02 + dd2 * p02
    i12 = dd1 * a12 + dd2 * p12
    return i00, i01, i02, i11, i12, i22
